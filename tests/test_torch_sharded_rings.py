"""The port's multi-GPU layer, the two rings (Macro128 and Tile16) and
scaling efficiency, on gloo ranks (mirrors tests/test_sharded_macro.py,
tests/test_sharded.py and tests/test_scaling.py).

A module-scoped fixture spawns the ranks once per world size (2 and 4,
``parallel.launch.spawn``) and runs every case of this file there
(``parallel.dryrun.rank_cases``).  Rank d's plan arrays are held against
row d of the JAX package's plan at the same world size, array for array.
The one sentinel that differs: the macro ring's ``seg`` pads with
INT32_MAX (the pair-stream kernel skips only that) where the JAX plan pads
with ``c_cap``; everything else pads as the JAX plan does.  C_nnz and the
sorted COO are exact; values are held within the float32 dot-product
bound, |err| <= 1e-5 * sum|a*b| + 1e-6 against scipy's float64 product.
The rings also run on bfloat16 operands (C float32: against scipy's
product of the bfloat16-rounded values, and each rank against the JAX
ring's device on the same bfloat16 plan) and the Tile16 ring on float64
ones accumulated in float64 (within 1e-12 * sum|a*b|; against the JAX
ring in x64 in tests/test_torch_f64.py).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_sparse
from test_torch_util import (bf16_rounded, one_torch_thread,
                             structural_product, xla_unoptimized)
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import banded as j_banded
from pem_spgemm_tpu.models.synthetic import power_law as j_power_law
from pem_spgemm_tpu.ops.convert import coo_to_macro as j_coo_to_macro
from pem_spgemm_tpu.ops.convert import coo_to_tiled as j_coo_to_tiled
from pem_spgemm_tpu.parallel.distributed import \
    plan_nnz_macro as j_plan_nnz_macro
from pem_spgemm_tpu.parallel.sharded import make_mesh as j_make_mesh
from pem_spgemm_tpu.parallel.sharded import (
    assemble_sharded as j_assemble, plan_sharded_spgemm as j_plan,
    sharded_numeric as j_numeric)
from pem_spgemm_tpu.parallel.sharded_macro import (
    assemble_sharded_macro as j_assemble_macro,
    plan_sharded_macro as j_plan_macro,
    sharded_macro_numeric as j_macro_numeric)
from pem_spgemm_tpu_torch import interop
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, coo_to_tiled
from pem_spgemm_tpu_torch.parallel import dryrun, launch, sharded
from pem_spgemm_tpu_torch.parallel import sharded_macro as sm

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
F64_RTOL, F64_ATOL = 1e-12, 1e-300
INT32_MAX = 0x7FFFFFFF


def _triplets(m):
    m = m.tocoo()
    return (m.row.astype(np.int32), m.col.astype(np.int32),
            m.data.astype(np.float64), m.shape)


def _scipy(jcoo):
    return JCOO(np.asarray(jcoo.rows), np.asarray(jcoo.cols),
                np.asarray(jcoo.vals), tuple(jcoo.shape)).to_scipy()


MACRO = _scipy(j_banded(n=1500, bands=(0, 2, -2, 64, -64, 140, -140),
                        seed=6))
RANDOM = random_sparse(600, 600, 0.01, seed=13)
BANDED = _scipy(j_banded(2000, bands=(0, 1, -1, 33, -120)))
RECT = random_sparse(350, 600, 0.01, seed=17)
SCALE_T16 = _scipy(j_banded(1500, bands=(0, 1, -1, 40, -40)))
SCALE_EL = _scipy(j_power_law(n=2500, nnz=8000, seed=4, hub_correlation=0.1))


def _cases(n):
    return {
        "macro": dict(kind="macro", coo=_triplets(MACRO)),
        "tile16_random": dict(kind="tile16", coo=_triplets(RANDOM)),
        "tile16_banded": dict(kind="tile16", coo=_triplets(BANDED)),
        "tile16_aat": dict(kind="tile16", coo=_triplets(RECT),
                           b_coo=_triplets(RECT.T)),
        "scaling_tile16": dict(kind="scaling", coo=_triplets(SCALE_T16),
                               engine="tile16", max_devices=n),
        "scaling_element": dict(kind="scaling", coo=_triplets(SCALE_EL),
                                engine="element", max_devices=n),
        "macro_bf16": dict(kind="macro", coo=_triplets(MACRO),
                           dtype=torch.bfloat16),
        "tile16_random_bf16": dict(kind="tile16", coo=_triplets(RANDOM),
                                   dtype=torch.bfloat16),
        "tile16_banded_f64": dict(kind="tile16", coo=_triplets(BANDED),
                                  dtype=torch.float64,
                                  acc_dtype=torch.float64),
    }


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def ranks(request):
    """(world size, {case: [rank 0's result, ...]}) from one spawn."""
    n = request.param
    cases = _cases(n)
    per_rank = launch.spawn(dryrun.rank_cases, n, list(cases.values()),
                            "cpu")
    return n, {k: [r[i] for r in per_rank] for i, k in enumerate(cases)}


def _want(a, b):
    """scipy's A@B sorted, with sum|a*b| of each entry."""
    a, b = a.tocsr().astype(np.float64), b.tocsr().astype(np.float64)
    want = (a @ b).tocoo()
    mag = (abs(a) @ abs(b)).tocoo()
    want.sum_duplicates()
    mag.sum_duplicates()
    o, mo = np.lexsort((want.col, want.row)), np.lexsort((mag.col, mag.row))
    assert np.array_equal(want.row[o], mag.row[mo])
    return want.row[o], want.col[o], want.data[o], mag.data[mo]


def _hold(out, want, what, rtol=RTOL, atol=ATOL):
    r, c, v, mag = want
    assert out["c_nnz"] == len(r), what
    np.testing.assert_array_equal(out["rows"], r, err_msg=what)
    np.testing.assert_array_equal(out["cols"], c, err_msg=what)
    assert np.all(np.abs(out["vals"] - v) <= rtol * mag + atol), what


def _fields(plan):
    """A JAX plan as the dict ``interop`` takes."""
    return {f.name: getattr(plan, f.name)
            for f in dataclasses.fields(plan)}


def _same_on_every_rank(outs):
    for o in outs[1:]:
        for k in ("c_nnz", "rows", "cols", "vals"):
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_macro(n):
    """The JAX plan, its C_nnz, its assembled COO and each device's C
    (c_dense, c_counts), (n, c_cap, 128, 128) numpy each."""
    m = j_coo_to_macro(JCOO.from_scipy(MACRO), dtype=jnp.float32)
    plan = j_plan_macro(m, m, n)
    out = j_macro_numeric(plan, j_make_mesh(n))
    return (plan, j_plan_nnz_macro(plan, out), j_assemble_macro(plan, *out),
            out)


def _abs_plans(plans):
    """The plans with |A| and |B| tiles: their ring gives sum|a*b|."""
    return [dataclasses.replace(p, a_dense=p.a_dense.abs(),
                                b_dense=p.b_dense.abs()) for p in plans]


def test_sharded_macro_matches_scipy_and_jax(ranks):
    n, res = ranks
    outs = res["macro"]
    _same_on_every_rank(outs)
    _hold(outs[0], _want(MACRO, MACRO), "macro ring")
    plan, c_nnz, (jr, jc, jv), (j_dense, j_cnt) = _jax_macro(n)
    assert outs[0]["c_nnz"] == c_nnz
    np.testing.assert_array_equal(outs[0]["rows"], jr)
    np.testing.assert_array_equal(outs[0]["cols"], jc)
    # rank d's plan against row d of the JAX plan (interop maps the seg
    # sentinel: c_cap there, INT32_MAX here)
    jplans = [interop.sharded_macro_plan_from_numpy(_fields(plan), d, CPU)
              for d in range(n)]
    for d, (o, jp) in enumerate(zip(outs, jplans)):
        assert o["c_cap"] == jp.c_cap and o["n_pairs"] == jp.n_pairs
        np.testing.assert_array_equal(o["c_counts_dev"], jp.c_counts_dev)
        np.testing.assert_array_equal(o["stage_pairs"], jp.stage_pairs)
        for k in ("pairs_a", "pairs_b", "seg", "c_tile_row", "c_tile_col",
                  "a_dense", "b_dense"):
            np.testing.assert_array_equal(o[k], getattr(jp, k).numpy(),
                                          err_msg=f"{k}[{d}]")
    # the JAX plan's rank slices through the port's stage loop (K4's plain
    # version here: the first stage with pairs fresh, the later ones added
    # into the same C), the ranks replayed in turn: each rank's C tiles are
    # JAX _local_macro's (flags exact, values within the float32 bound) and
    # the union is scipy's product
    mags = _abs_plans(jplans)
    parts = []
    for d, p in enumerate(jplans):
        num, flag = sm.local_macro(p, sm.replay_chunks(jplans, d))
        mag = sm.local_macro(mags[d], sm.replay_chunks(mags, d))[0].numpy()
        np.testing.assert_array_equal(flag.numpy() > 0, j_cnt[d] > 0,
                                      err_msg=f"flags[{d}]")
        assert np.all(np.abs(num.numpy() - j_dense[d]) <= RTOL * mag + ATOL)
        parts.append(sm.local_macro_coo(p, num, flag))
    assert sum(sum(1 for x in p.stage_pairs if x) > 1 for p in jplans)
    rows, cols, vals = (torch.cat(x) for x in zip(*parts))
    order = torch.sort((rows << 32) | cols).indices
    _hold(dict(rows=rows[order].numpy(), cols=cols[order].numpy(),
               vals=vals[order].numpy(), c_nnz=len(rows)),
          _want(MACRO, MACRO), "JAX plan through the port's ring")


def test_macro_stages_ascend_in_c_tile(ranks):
    """The stable key sort keeps each stage's pairs ascending in C tile,
    padding last: what the pair-stream kernel K4 needs; every pair is
    scheduled once."""
    n, res = ranks
    outs = res["macro"]
    total = 0
    for o in outs:
        seg = o["seg"].astype(np.int64)
        assert np.all(np.diff(seg, axis=1) >= 0)
        live = (seg != INT32_MAX).sum(axis=1)
        np.testing.assert_array_equal(live, o["stage_pairs"])
        total += int(live.sum())
    assert total == outs[0]["n_pairs"]


@functools.lru_cache(maxsize=None)
def _jax_tile16(n):
    """The JAX plan, its assembled COO and each device's values
    ((n, nnz_cap): the JAX ring's ``_local_numeric``)."""
    coo = JCOO.from_scipy(RANDOM)
    a = j_coo_to_tiled(coo, dtype=jnp.float32)
    b = j_coo_to_tiled(coo, dtype=jnp.float32, with_tmasks=True)
    plan = j_plan(a, b, n)
    vals = j_numeric(plan, j_make_mesh(n))
    return plan, j_assemble(plan, vals), vals


def test_sharded_matches_scipy_and_jax(ranks):
    n, res = ranks
    outs = res["tile16_random"]
    _same_on_every_rank(outs)
    _hold(outs[0], _want(RANDOM, RANDOM), "tile16 ring")
    plan, (jr, jc, jv), _vals = _jax_tile16(n)
    assert outs[0]["c_nnz"] == plan.c_nnz
    o_j = np.lexsort((jc, jr))
    np.testing.assert_array_equal(outs[0]["rows"], jr[o_j])
    np.testing.assert_array_equal(outs[0]["cols"], jc[o_j])
    jplans = [interop.sharded_plan_from_numpy(_fields(plan), d, CPU)
              for d in range(n)]
    for d, (o, jp) in enumerate(zip(outs, jplans)):
        assert o["c_cap"] == jp.c_cap and o["n_pairs"] == jp.n_pairs
        np.testing.assert_array_equal(o["c_nnz_per_dev"], jp.c_nnz_per_dev)
        for k in ("pairs_a", "pairs_b", "seg", "rowcol", "elem_tile",
                  "c_tile_row", "c_tile_col", "a_dense", "b_dense"):
            np.testing.assert_array_equal(o[k], getattr(jp, k).numpy(),
                                          err_msg=f"{k}[{d}]")
    # the JAX plan's rank slices through the port's stage loop
    parts = [sharded.local_coo(p, sharded.replay_numeric(jplans, d))
             for d, p in enumerate(jplans)]
    rows, cols, vals = (torch.cat(x) for x in zip(*parts))
    order = torch.sort((rows << 32) | cols).indices
    _hold(dict(rows=rows[order].numpy(), cols=cols[order].numpy(),
               vals=vals[order].numpy(), c_nnz=len(rows)),
          _want(RANDOM, RANDOM), "JAX plan through the port's ring")


def test_local_numeric_matches_jax_local_numeric():
    """Each rank of the JAX 4-rank plan through the port's stage loop
    (``replay_numeric``: the first stage with pairs fresh, every later one
    added into the same C) against that device's values of the JAX ring's
    ``_local_numeric``, within the float32 dot-product bound (sum|a*b| from
    the same ring on |A| and |B|); padding values too."""
    n = 4
    plan, _coo, vals = _jax_tile16(n)
    jplans = [interop.sharded_plan_from_numpy(_fields(plan), d, CPU)
              for d in range(n)]
    mags = _abs_plans(jplans)
    several = 0
    for d, p in enumerate(jplans):
        got = sharded.replay_numeric(jplans, d).numpy()
        mag = sharded.replay_numeric(mags, d).numpy()
        assert got.shape == vals[d].shape
        assert np.all(np.abs(got - vals[d]) <= RTOL * mag + ATOL), d
        several += sum(1 for x in p.stage_pairs if x) > 1
    assert several


@functools.lru_cache(maxsize=None)
def _jax_bf16(ring, n):
    """The JAX ring on bfloat16 operands: its plan and each device's
    output (the macro ring's (c_dense, c_counts), float32; the Tile16
    ring's values (n, nnz_cap), float32)."""
    if ring == "macro":
        m = j_coo_to_macro(JCOO.from_scipy(MACRO), dtype=jnp.bfloat16)
        plan = j_plan_macro(m, m, n)
        return plan, j_macro_numeric(plan, j_make_mesh(n))
    coo = JCOO.from_scipy(RANDOM)
    a = j_coo_to_tiled(coo, dtype=jnp.bfloat16)
    b = j_coo_to_tiled(coo, dtype=jnp.bfloat16, with_tmasks=True)
    plan = j_plan(a, b, n)
    return plan, j_numeric(plan, j_make_mesh(n))


@pytest.mark.parametrize("ring", ["macro", "tile16"])
def test_bf16_rings_match_the_jax_rings(ring):
    """The JAX 4-rank plan on bfloat16 operands carried into the port
    (interop: bfloat16 tables as their bits), each rank replayed through
    the port's stage loop against that device of the JAX ring: the macro
    ring's C float32 and its flags exact, the Tile16 ring's values
    float32; values within the float32 bound (both sides multiply the
    same bfloat16 values, exact in float32: only the order of the sums
    differs).  The union is scipy's product of the rounded values."""
    n = 4
    plan, jout = _jax_bf16(ring, n)
    if ring == "macro":
        jplans = [interop.sharded_macro_plan_from_numpy(_fields(plan), d,
                                                         CPU)
                  for d in range(n)]
    else:
        jplans = [interop.sharded_plan_from_numpy(_fields(plan), d, CPU)
                  for d in range(n)]
    assert all(p.a_dense.dtype == torch.bfloat16 for p in jplans)
    mags = _abs_plans(jplans)
    parts = []
    for d, p in enumerate(jplans):
        if ring == "macro":
            num, flag = sm.local_macro(p, sm.replay_chunks(jplans, d))
            mag = sm.local_macro(mags[d], sm.replay_chunks(mags, d))[0]
            assert num.dtype == torch.float32
            np.testing.assert_array_equal(flag.numpy() > 0, jout[1][d] > 0,
                                          err_msg=f"flags[{d}]")
            got, want = num.numpy(), jout[0][d]
            parts.append(sm.local_macro_coo(p, num, flag))
        else:
            vals = sharded.replay_numeric(jplans, d)
            mag = sharded.replay_numeric(mags, d)
            assert vals.dtype == torch.float32
            got, want = vals.numpy(), jout[d]
            parts.append(sharded.local_coo(p, vals))
        assert got.shape == want.shape
        assert np.all(np.abs(got - want) <= RTOL * mag.numpy() + ATOL), d
    assert sum(sum(1 for x in p.stage_pairs if x) > 1 for p in jplans)
    rows, cols, vals = (torch.cat(x) for x in zip(*parts))
    order = torch.sort((rows << 32) | cols).indices
    m = MACRO if ring == "macro" else RANDOM
    _hold(dict(rows=rows[order].numpy(), cols=cols[order].numpy(),
               vals=vals[order].numpy(), c_nnz=len(rows)),
          structural_product(bf16_rounded(m), bf16_rounded(m)),
          f"bf16 {ring} replay")


@functools.lru_cache(maxsize=None)
def _bf16_plans(ring, n):
    """The port's own n-rank plans of the ring on bfloat16 operands."""
    coo = COOMatrix.from_scipy(MACRO if ring == "macro" else RANDOM)
    if ring == "macro":
        m = coo_to_macro(coo, dtype=torch.bfloat16, device=CPU)
        return [sm.plan_sharded_macro(m, m, n, d) for d in range(n)]
    a = coo_to_tiled(coo, dtype=torch.bfloat16, device=CPU)
    b = coo_to_tiled(coo, dtype=torch.bfloat16, with_tmasks=True, device=CPU)
    return [sharded.plan_sharded_spgemm(a, b, n, d) for d in range(n)]


@functools.lru_cache(maxsize=None)
def _bf16_highest(ring, d):
    """Rank d's output of the 4-rank bfloat16 ring at "highest"."""
    plans = _bf16_plans(ring, 4)
    if ring == "macro":
        return sm.local_macro(plans[d], sm.replay_chunks(plans, d))
    return sharded.replay_numeric(plans, d)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("ring", ["macro", "tile16"])
def test_bf16_rings_at_lower_precisions_equal_highest(ring, precision):
    """Rounding a bfloat16 value to TF32 or to bfloat16 keeps it, so each
    rank of a bfloat16 ring at "high" and "default" gives values bit for
    bit those at "highest" (and the macro ring's flags)."""
    plans = _bf16_plans(ring, 4)
    for d, p in enumerate(plans):
        want = _bf16_highest(ring, d)
        if ring == "macro":
            got = sm.local_macro(p, sm.replay_chunks(plans, d), precision)
            assert torch.equal(got[1], want[1]), d
            got, want = got[0], want[0]
        else:
            got = sharded.replay_numeric(plans, d, precision)
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), d


def test_bf16_macro_ring_widens_each_chunk(monkeypatch):
    """The bfloat16 macro ring: the plan keeps its tables in bfloat16 (the
    chunk goes round in bfloat16), its A slice is widened once a plan
    (acc_slice), and K4 gets float32 tables at every stage: the A slice's
    copy and one float32 buffer each chunk is widened into, with the
    masks the chunk was handed, which equal the masks of the widened
    buffer (a bfloat16 value is zero exactly where its float32 copy is)."""
    from pem_spgemm_tpu_torch.ops import macro_kernels as mk
    plans = _bf16_plans("macro", 4)
    assert all(p.b_dense.dtype == torch.bfloat16 for p in plans)
    for p in plans:
        assert sm.acc_slice(p) is sm.acc_slice(p)
        assert torch.equal(sm.acc_slice(p), p.a_dense.float())
    seen = []
    real = mk.accumulate_macro_pairs

    def spy(a, b, *args, tile_masks=None, **kw):
        seen.append((a.data_ptr(), b.data_ptr(), a.dtype, b.dtype,
                     None if tile_masks is None else
                     (tile_masks.b.matches(b),
                      torch.equal(tile_masks.b.words,
                                  mk.tile_masks_plain(b)))))
        return real(a, b, *args, tile_masks=tile_masks, **kw)

    monkeypatch.setattr(mk, "accumulate_macro_pairs", spy)
    monkeypatch.setattr(mk, "reads_masks", lambda *a: True)
    for d, p in enumerate(plans):
        seen.clear()
        num, _flag = sm.local_macro(p, sm.replay_chunks(plans, d,
                                                        masks=True))
        assert num.dtype == torch.float32
        assert seen and {x[:4] for x in seen} == {
            (sm.acc_slice(p).data_ptr(), seen[0][1], torch.float32,
             torch.float32)}
        assert all(x[4] == (True, True) for x in seen), d


def test_sharded_banded(ranks):
    _n, res = ranks
    outs = res["tile16_banded"]
    _same_on_every_rank(outs)
    _hold(outs[0], _want(BANDED, BANDED), "tile16 ring, banded")


def test_sharded_aat_rectangular(ranks):
    _n, res = ranks
    outs = res["tile16_aat"]
    _same_on_every_rank(outs)
    _hold(outs[0], _want(RECT, RECT.T), "tile16 ring, A@A.T")


@pytest.mark.parametrize("case", ["macro_bf16", "tile16_random_bf16",
                                  "tile16_banded_f64"])
def test_rings_on_bf16_and_f64_values(ranks, case):
    """The bfloat16 rings (float32 C) and the float64 Tile16 ring
    (float64 accumulation) over gloo: the same sorted COO on every rank,
    C_nnz and structure those of scipy's |A|@|A| (C's structure; no entry
    cancels in the float64 case), values within the float32 bound against
    scipy's float64 product of the bfloat16-rounded values, or within
    1e-12 * sum|a*b| + 1e-300 against the float64 product."""
    _n, res = ranks
    outs = res[case]
    _same_on_every_rank(outs)
    if case.endswith("f64"):
        assert outs[0]["vals"].dtype == np.float64
        _hold(outs[0], structural_product(BANDED, BANDED), case,
              rtol=F64_RTOL, atol=F64_ATOL)
    else:
        m = MACRO if case.startswith("macro") else RANDOM
        assert outs[0]["vals"].dtype == np.float32
        _hold(outs[0], structural_product(bf16_rounded(m),
                                          bf16_rounded(m)), case)


@pytest.mark.parametrize("case", ["scaling_tile16", "scaling_element"])
def test_scaling_points(ranks, case):
    n, res = ranks
    pts = [tuple(p) for p in res[case][0]["points"]]
    for o in res[case][1:]:
        assert [tuple(p) for p in o["points"]] == pts   # broadcast
    ns = [p[0] for p in pts]
    assert ns[0] == 1 and ns[-1] == n
    assert all(p[1] == pts[0][1] for p in pts)
    assert all(p[2] > 0 and p[3] > 0 for p in pts)
    coo = SCALE_T16 if case == "scaling_tile16" else SCALE_EL
    assert pts[0][1] == _want(coo, coo)[0].size


def test_replayed_rings_union_is_the_product():
    """Each rank's stages replayed in one process with its B chunks read
    from the other ranks' plans (what chip_smoke.py does on one card): the
    union of the ranks' C equals scipy's."""
    m = coo_to_macro(COOMatrix.from_scipy(MACRO), device=CPU)
    plans = [sm.plan_sharded_macro(m, m, 4, d) for d in range(4)]
    parts = [sm.local_macro_coo(p, *sm.local_macro(
        p, sm.replay_chunks(plans, d))) for d, p in enumerate(plans)]
    rows, cols, vals = (torch.cat(x) for x in zip(*parts))
    order = torch.sort((rows << 32) | cols).indices
    _hold(dict(rows=rows[order].numpy(), cols=cols[order].numpy(),
               vals=vals[order].numpy(), c_nnz=len(rows)),
          _want(MACRO, MACRO), "macro replay")
    coo = COOMatrix.from_scipy(RANDOM)
    a = coo_to_tiled(coo, device=CPU)
    b = coo_to_tiled(coo, with_tmasks=True, device=CPU)
    plans = [sharded.plan_sharded_spgemm(a, b, 4, d) for d in range(4)]
    parts = [sharded.local_coo(p, sharded.replay_numeric(plans, d))
             for d, p in enumerate(plans)]
    rows, cols, vals = (torch.cat(x) for x in zip(*parts))
    order = torch.sort((rows << 32) | cols).indices
    _hold(dict(rows=rows[order].numpy(), cols=cols[order].numpy(),
               vals=vals[order].numpy(), c_nnz=len(rows)),
          _want(RANDOM, RANDOM), "tile16 replay")


def test_replayed_ring_carries_each_chunks_masks(monkeypatch):
    """replay_chunks(..., masks=True) hands each stage the chunk the ring
    would and the tile masks of that chunk (its plan's, made once a plan:
    plan_masks), equal to the masks made from the chunk."""
    from pem_spgemm_tpu_torch.ops import macro_kernels as mk
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # beside the other test workers
    try:
        m = coo_to_macro(COOMatrix.from_scipy(MACRO), device=CPU)
        plans = [sm.plan_sharded_macro(m, m, 4, d) for d in range(4)]
        made = []
        real = mk.TableMasks.make
        monkeypatch.setattr(mk.TableMasks, "make",
                            lambda self: made.append(self) or real(self))
        for d in range(4):
            held = list(sm.replay_chunks(plans, d, masks=True))
            assert [b.data_ptr() for b, _m in held] == \
                [b.data_ptr() for b in sm.replay_chunks(plans, d)]
            for b, bm in held:
                assert bm.ready and bm.matches(b)
                assert torch.equal(bm.words, mk.tile_masks_plain(b))
        # each plan's A slice and B chunk, once
        assert len(made) == 2 * len(plans)
        assert all(sm.plan_masks(p) is p.masks for p in plans)
        assert len(made) == 2 * len(plans)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n", [2, 4])
def test_local_macro_adds_each_stage_into_one_c(n, dtype, monkeypatch):
    """local_macro on ``n`` ranks replayed in turn: one pair-stream call a
    stage with pairs, the first in the fresh form and every later one in
    the accumulate form (``out=`` the C the first returned: no partial C,
    no torch add), and each rank's C equal under == to the composition it
    replaces, computed here (a zero C, each stage's fresh product added,
    its flags ORed in), flags bit for bit."""
    from pem_spgemm_tpu_torch.ops import macro_kernels as mk
    m = coo_to_macro(COOMatrix.from_scipy(MACRO), dtype=dtype, device=CPU)
    plans = [sm.plan_sharded_macro(m, m, n, d) for d in range(n)]
    calls = []
    real = mk.accumulate_macro_pairs

    def spy(*args, out=None, **kw):
        calls.append(None if out is None else tuple(x.data_ptr()
                                                    for x in out))
        return real(*args, out=out, **kw)

    for d, p in enumerate(plans):
        live = [s for s, x in enumerate(p.stage_pairs) if x]
        calls.clear()
        monkeypatch.setattr(mk, "accumulate_macro_pairs", spy)
        num, flag = sm.local_macro(p, sm.replay_chunks(plans, d))
        monkeypatch.setattr(mk, "accumulate_macro_pairs", real)
        assert num.dtype == dtype and len(calls) == len(live)
        assert calls[:1] == [None] * min(1, len(live))
        assert all(c == (num.data_ptr(), flag.data_ptr())
                   for c in calls[1:])
        want_n = torch.zeros_like(num)
        want_f = torch.zeros_like(flag)
        chunks = list(sm.replay_chunks(plans, d))
        for s in live:
            part, part_f = real(p.a_dense, chunks[s], p.pairs_a[s],
                                p.pairs_b[s], p.seg[s], p.c_cap,
                                chunk=min(256, p.pairs_a.shape[1]))
            want_n += part
            want_f |= part_f
        same = (num == want_n) | (torch.isnan(num) & torch.isnan(want_n))
        assert bool(same.all()) and torch.equal(flag, want_f), d
    assert any(sum(1 for x in p.stage_pairs if x) > 1 for p in plans)


def test_rings_refuse_other_dtypes():
    """What the rings still refuse: integer tiles, operands of two dtypes,
    and the Tile16 ring's two cross pairings of table and accumulation
    dtype (float32 tables into float64, float64 tables into float32: the
    JAX ring casts the gathered tiles; the port's kernel entries take
    float32 or bfloat16 tables into float32 and float64 into float64),
    each naming both dtypes."""
    coo = COOMatrix.from_scipy(RECT)
    m = coo_to_macro(coo, device=CPU)
    m16 = coo_to_macro(coo, dtype=torch.bfloat16, device=CPU)
    mi = dataclasses.replace(m, dense=m.dense.to(torch.int32))
    for a, b in ((mi, mi), (m, m16), (m16, m)):
        with pytest.raises(NotImplementedError, match="both of one dtype"):
            sm.plan_sharded_macro(a, b, 2, 0)
    t = coo_to_tiled(coo, device=CPU)
    t64 = coo_to_tiled(coo, dtype=torch.float64, device=CPU)
    ti = dataclasses.replace(t, vals=t.vals.to(torch.int32))
    for a, b in ((ti, ti), (t, t64), (t64, t)):
        with pytest.raises(NotImplementedError, match="both of one dtype"):
            sharded.plan_sharded_spgemm(a, b, 2, 0)
    small = COOMatrix.from_scipy(random_sparse(64, 64, 0.05, seed=2))
    for dtype, acc in ((torch.float32, torch.float64),
                       (torch.float64, torch.float32),
                       (torch.bfloat16, torch.float64)):
        table = coo_to_tiled(small, dtype=dtype, device=CPU)
        plans = [sharded.plan_sharded_spgemm(table, table, 1, 0)]
        with pytest.raises(NotImplementedError,
                           match=f"{dtype} tiles accumulated in {acc}"):
            sharded.replay_numeric(plans, 0, acc_dtype=acc)
