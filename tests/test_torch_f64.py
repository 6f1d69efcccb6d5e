"""The f64 parity mode of the port: every ported engine at float64 against
scipy's float64 product and against the JAX package's x64 results for the
same inputs (a mirror of tests/test_f64.py).

The reference computes in double (ValueType=double).  The port runs
float64 on the element engine (the merge engine: dispatch sends every dtype
other than float32 there), on DIA bands, on Macro128 tiles and on the
Tile16 engines (fused and masks: float64 products and accumulation); on the
CPU these are the plain versions of the kernels' float64 entries.  Held: the
values' dtype float64, c_nnz exact, the sorted COO structure equal to
scipy's and to the JAX package's, a relative error under 1e-12.

x64 is process-global, so the JAX references come from ONE subprocess for
this file (a module-scoped fixture) with JAX_ENABLE_X64=1 and
JAX_PLATFORMS=cpu in its environment, as tests/test_f64.py does; it also
runs the JAX Tile16 ring on float64 tiles (acc_dtype float64) on four of
the virtual CPU devices, for the port's float64 ring."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from test_torch_util import one_torch_thread, xla_unoptimized
from pem_spgemm_tpu_torch import (SpGEMM, SpGEMMConfig, coo_to_dia,
                                  coo_to_macro, coo_to_tiled, interop)
from pem_spgemm_tpu_torch.bench.harness import run_benchmark
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops.element import compact_stream
from pem_spgemm_tpu_torch.ops.fixed import ElementPlan, MacroPlan, make_plan
from pem_spgemm_tpu_torch.utils.csv_report import CSV_HEADER

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
ENGINES = ("element", "dia", "macro", "fused", "masks")


def _matrices():
    """(random square, banded) scipy matrices, float64, seeded."""
    rs = np.random.default_rng(3)
    n, nnz = 400, 3000
    m = sp.coo_matrix((rs.standard_normal(nnz),
                       (rs.integers(0, n, nnz), rs.integers(0, n, nnz))),
                      shape=(n, n))
    m.sum_duplicates()
    bd = sp.diags([rs.standard_normal(n - 1), rs.standard_normal(n),
                   rs.standard_normal(n - 40)], [-1, 0, 40], format="coo")
    return m, bd


_SCRIPT = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
from pem_spgemm_tpu.config import SpGEMMConfig
from pem_spgemm_tpu.formats.coo import COOMatrix
from pem_spgemm_tpu.ops.convert import coo_to_tiled, coo_to_macro
from pem_spgemm_tpu.ops.dia import coo_to_dia
from pem_spgemm_tpu.ops.fixed import make_plan
from pem_spgemm_tpu.ops.spgemm import SpGEMM
d = dict(np.load(sys.argv[1]))
out = {}
for engine in ("element", "dia", "macro", "fused", "masks"):
    key = "b" if engine == "dia" else "m"
    coo = COOMatrix(d[key + "_rows"], d[key + "_cols"], d[key + "_vals"],
                    tuple(d[key + "_shape"]))
    if engine == "dia":
        op = coo_to_dia(coo, dtype=jnp.float64)
    elif engine == "macro":
        op = coo_to_macro(coo, dtype=jnp.float64)
    else:
        op = coo_to_tiled(coo, dtype=jnp.float64, with_tmasks=True)
    cfg = SpGEMMConfig(engine=engine, dtype=jnp.float64,
                       numeric_chunk=1 << 10, macro_chunk=16)
    res = SpGEMM(cfg)(op, op)
    got = res.to_coo()
    out[engine + "_rows"] = np.asarray(got.rows)
    out[engine + "_cols"] = np.asarray(got.cols)
    out[engine + "_vals"] = np.asarray(got.vals)
    if engine == "element":
        plan = make_plan(res, cfg, op, op)
        for f in ("p_cap", "c_cap", "fill_rounds", "merge_rounds",
                  "sum_rounds", "wide"):
            out["plan_" + f] = np.asarray(-1 if getattr(plan, f) is None
                                          else getattr(plan, f))
        fixed = plan.run(op, op)
        for i, f in enumerate(("rows", "cols", "vals", "first", "c_nnz",
                               "overflow")):
            out["fixed_" + f] = np.asarray(fixed[i])
# the Tile16 ring on 4 devices, float64 tiles accumulated in float64
import dataclasses
from pem_spgemm_tpu.parallel.sharded import (make_mesh, plan_sharded_spgemm,
                                             sharded_numeric)
coo = COOMatrix(d["m_rows"], d["m_cols"], d["m_vals"], tuple(d["m_shape"]))
a = coo_to_tiled(coo, dtype=jnp.float64)
b = coo_to_tiled(coo, dtype=jnp.float64, with_tmasks=True)
plan = plan_sharded_spgemm(a, b, 4)
out["ring_vals"] = sharded_numeric(plan, make_mesh(4), acc_dtype=jnp.float64)
for f in dataclasses.fields(plan):
    out["ring_plan_" + f.name] = np.asarray(getattr(plan, f.name))
np.savez(sys.argv[2], **out)
print("ok")
"""


def _port_coo(m):
    return COOMatrix(m.row.astype(np.int32), m.col.astype(np.int32),
                     m.data.astype(np.float64), m.shape)


@pytest.fixture(scope="module")
def x64(tmp_path_factory):
    m, bd = _matrices()
    tmp = tmp_path_factory.mktemp("f64")
    arrays = {}
    for key, x in (("m", m), ("b", bd)):
        c = _port_coo(x)
        arrays.update({f"{key}_rows": c.rows, f"{key}_cols": c.cols,
                       f"{key}_vals": c.vals,
                       f"{key}_shape": np.asarray(c.shape)})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, REPO=ROOT, JAX_ENABLE_X64="1",
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp / "in.npz"),
                        str(tmp / "out.npz")], env=env, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _operand(engine, dtype=torch.float64):
    m, bd = _matrices()
    coo = _port_coo(bd if engine == "dia" else m)
    if engine == "dia":
        op = coo_to_dia(coo, dtype=dtype, device=CPU)
    elif engine == "macro":
        op = coo_to_macro(coo, dtype=dtype, device=CPU)
    else:
        op = coo_to_tiled(coo, dtype=dtype, with_tmasks=True, device=CPU)
    return (bd if engine == "dia" else m), op


def _scipy(m):
    want = (m.tocsr() @ m.tocsr()).tocoo()
    want.sum_duplicates()
    o = np.lexsort((want.col, want.row))
    return want.row[o], want.col[o], want.data[o]


def _port_result(engine):
    m, op = _operand(engine)
    cfg = SpGEMMConfig(engine=engine, dtype=torch.float64,
                       numeric_chunk=1 << 10, macro_chunk=16)
    return m, op, cfg, SpGEMM(cfg)(op, op)


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), 1e-300)))


@pytest.mark.parametrize("engine", ENGINES)
def test_f64_all_engines_structure_and_values(engine):
    m, _op, _cfg, res = _port_result(engine)
    wr, wc, wv = _scipy(m)
    assert res.c_nnz == len(wv), (engine, res.c_nnz, len(wv))
    if engine == "element":
        assert res.binned is None, "f64 must route to the merge engine"
    got = res.to_coo()
    assert got.vals.dtype == np.float64, (engine, got.vals.dtype)
    np.testing.assert_array_equal(got.rows, wr)
    np.testing.assert_array_equal(got.cols, wc)
    assert _rel_err(got.vals, wv) < 1e-12, engine


@pytest.mark.parametrize("engine", ENGINES)
def test_f64_matches_the_jax_package_in_x64(engine, x64):
    _m, _op, _cfg, res = _port_result(engine)
    got = res.to_coo()
    np.testing.assert_array_equal(got.rows, x64[engine + "_rows"])
    np.testing.assert_array_equal(got.cols, x64[engine + "_cols"])
    assert x64[engine + "_vals"].dtype == np.float64
    np.testing.assert_allclose(got.vals, x64[engine + "_vals"], rtol=1e-12,
                               atol=1e-300)


def test_f64_tile16_ring_matches_the_jax_ring_in_x64(x64):
    """The Tile16 ring on float64 tiles with acc_dtype float64: the port's
    rank plans are the rows of the JAX 4-device plan (x64), and each rank
    of that plan, carried across and replayed through the port's stage
    loop (the float64 fresh form, then the accumulate form), gives that
    device's float64 values of the JAX ring within 1e-12 * sum|a*b| (from
    the same ring on |A| and |B|); the union is scipy's product."""
    from pem_spgemm_tpu_torch.parallel import sharded
    fields = {k[len("ring_plan_"):]: x64[k] for k in x64
              if k.startswith("ring_plan_")}
    n = int(fields["n_devices"])
    jplans = [interop.sharded_plan_from_numpy(fields, d, CPU)
              for d in range(n)]
    m, _op = _operand("fused")
    a = coo_to_tiled(_port_coo(m), dtype=torch.float64, device=CPU)
    b = coo_to_tiled(_port_coo(m), dtype=torch.float64, with_tmasks=True,
                     device=CPU)
    for d, jp in enumerate(jplans):
        own = sharded.plan_sharded_spgemm(a, b, n, d)
        assert own.a_dense.dtype == jp.a_dense.dtype == torch.float64
        assert (own.c_cap, own.c_nnz, own.stage_pairs) == (
            jp.c_cap, jp.c_nnz, jp.stage_pairs)
        for k in ("pairs_a", "pairs_b", "seg", "rowcol", "elem_tile",
                  "c_tile_row", "c_tile_col", "a_dense", "b_dense"):
            assert torch.equal(getattr(own, k), getattr(jp, k)), (k, d)
    mags = [dataclasses.replace(p, a_dense=p.a_dense.abs(),
                                b_dense=p.b_dense.abs()) for p in jplans]
    f64 = torch.float64
    parts = []
    for d, p in enumerate(jplans):
        got = sharded.replay_numeric(jplans, d, acc_dtype=f64)
        mag = sharded.replay_numeric(mags, d, acc_dtype=f64).numpy()
        want = x64["ring_vals"][d]
        assert got.dtype == f64 and want.dtype == np.float64
        assert np.all(np.abs(got.numpy() - want) <= 1e-12 * mag + 1e-300), d
        parts.append(sharded.local_coo(p, got))
    assert sum(sum(1 for x in p.stage_pairs if x) > 1 for p in jplans)
    rows, cols, vals = (torch.cat(x) for x in zip(*parts))
    order = torch.sort((rows << 32) | cols).indices
    wr, wc, wv = _scipy(m)
    np.testing.assert_array_equal(rows[order].numpy(), wr)
    np.testing.assert_array_equal(cols[order].numpy(), wc)
    assert _rel_err(vals[order].numpy(), wv) < 1e-12


def test_f64_error_bound_table():
    """Record the measured bounds (shown with -rA)."""
    errs = {}
    for engine in ENGINES:
        m, _op, _cfg, res = _port_result(engine)
        errs[engine] = _rel_err(res.to_coo().vals, _scipy(m)[2])
    assert all(e < 1e-12 for e in errs.values()), errs
    print("port F64 max rel error vs scipy float64:",
          {k: f"{v:.2e}" for k, v in sorted(errs.items())})


def test_f64_element_plan_carries_across_and_keeps_f64(x64):
    """The JAX package's f64 ElementPlan, carried across, drives the port's
    fixed step to the JAX fixed step's result; the port's own plan equals
    it."""
    _m, op, cfg, res = _port_result("element")
    fields = {f: x64["plan_" + f].item() for f in (
        "p_cap", "c_cap", "fill_rounds", "merge_rounds", "sum_rounds",
        "wide")}
    fields = {k: (None if v == -1 else v) for k, v in fields.items()}
    plan = interop.element_plan_from_numpy(fields)
    assert plan == make_plan(res, cfg, op, op) and plan.wide
    out = plan.run(op, op)
    n = int(out[4])
    assert n == res.c_nnz == int(x64["fixed_c_nnz"])
    assert not bool(out[5]) and out[2].dtype == torch.float64
    np.testing.assert_array_equal(out[0].numpy(), x64["fixed_rows"])
    np.testing.assert_array_equal(out[1].numpy(), x64["fixed_cols"])
    np.testing.assert_array_equal(out[3].numpy(), x64["fixed_first"])
    np.testing.assert_allclose(out[2].numpy(), x64["fixed_vals"],
                               rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("engine", ENGINES)
def test_f64_run_benchmark_reports_the_csv(engine, tmp_path):
    m, _bd = _matrices()
    if engine == "dia":
        m = _bd
    coo = _port_coo(m)
    path = tmp_path / "r.csv"
    rec, res = run_benchmark(coo, f"f64-{engine}", SpGEMMConfig(
        engine=engine, dtype=torch.float64, repeat=1, numeric_chunk=1 << 10,
        macro_chunk=16), csv_path=str(path), verbose=False, device=CPU)
    assert rec.c_nnz == len(_scipy(m)[2]) == res.c_nnz
    lines = path.read_text().splitlines()
    assert lines[0] == CSV_HEADER and len(lines[1].split(",")) == 14
    assert rec.steady_state_time > 0 and rec.pipelined_time > 0
    assert res.vals.dtype == torch.float64


def test_f64_plans_keep_their_dtype():
    """The steady plans carry float64 end to end: the merge engine's wide
    step, and the macro engine's generic pair stream (the class plans are
    float32 only, in both packages)."""
    _m, op, cfg, res = _port_result("element")
    plan = make_plan(res, cfg, op, op)
    assert isinstance(plan, ElementPlan) and plan.wide
    rows, cols, vals, first, c_nnz, overflow = plan.run(op, op)
    r, c, v = compact_stream(rows, cols, vals, first)
    assert v.dtype == torch.float64 and int(c_nnz) == res.c_nnz
    _m, op, cfg, res = _port_result("macro")
    plan = make_plan(res, cfg, op, op)
    assert isinstance(plan, MacroPlan) and plan.acc_dtype == torch.float64
    out = plan.run(op, op)
    assert out[2].dtype == torch.float64 and int(out[5]) == res.c_nnz


def test_interop_keeps_float64():
    m, bd = _matrices()
    t = coo_to_tiled(_port_coo(m), dtype=torch.float64, device=CPU)
    d = {f: getattr(t, f).numpy() for f in (
        "tile_row", "tile_col", "ptr", "masks", "vals", "rowcol",
        "elem_tile", "tile_rowptr")}
    got = interop.tiled_from_numpy({**d, "shape": t.shape,
                                    "ntiles": t.ntiles}, device=CPU)
    assert got.vals.dtype == torch.float64
    assert torch.equal(got.vals, t.vals)
    dm = coo_to_dia(_port_coo(bd), dtype=torch.float64, device=CPU)
    got = interop.dia_from_numpy(dict(bands=dm.bands.numpy(), shape=dm.shape,
                                      offsets=dm.offsets, nnz=dm.nnz),
                                 device=CPU)
    assert got.bands.dtype == torch.float64
    mm = coo_to_macro(_port_coo(m), dtype=torch.float64, device=CPU)
    got = interop.macro_from_numpy(
        {f: getattr(mm, f).numpy() for f in ("tile_row", "tile_col",
                                             "tile_rowptr", "dense")}
        | dict(shape=mm.shape, ntiles=mm.ntiles, nnz=mm.nnz), device=CPU)
    assert got.dense.dtype == torch.float64
    assert torch.equal(got.dense, mm.dense)
