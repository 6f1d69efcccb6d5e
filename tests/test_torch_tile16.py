"""The Tile16 tier of the port (the fused and masks engines) against the
JAX package on the same numpy inputs: every phase function (dense tiles,
accumulation, masks, intra-tile coordinates, assembly, the fixed step) with
structure equal array for array and float32 values within rtol=1e-5, and the
engines end to end against scipy (a mirror of tests/test_spgemm.py, of
tests/test_fixed.py's Tile16 plan cases and of
tests/test_convert.py::test_intra_rowptr).  The JAX side runs on XLA:CPU;
its results are shared through one module-scoped fixture."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conftest import random_sparse
from test_torch_util import (both_tiled, one_torch_thread, scipy_product,
                             xla_unoptimized)
from pem_spgemm_tpu import SpGEMM as JSpGEMM, SpGEMMConfig as JConfig
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.ops import assemble as j_assemble
from pem_spgemm_tpu.ops import cstruct as j_cstruct
from pem_spgemm_tpu.ops import fixed as j_fixed
from pem_spgemm_tpu.ops import numeric as j_numeric
from pem_spgemm_tpu.ops import symbolic as j_symbolic
from pem_spgemm_tpu.ops.scanops import can_pack
from pem_spgemm_tpu_torch import SpGEMM, SpGEMMConfig
from pem_spgemm_tpu_torch.config import round_up_bucket, round_up_pow2
from pem_spgemm_tpu_torch.formats.coo import COOMatrix as TCOO
from pem_spgemm_tpu_torch.ops import assemble as t_assemble
from pem_spgemm_tpu_torch.ops import cstruct as t_cstruct
from pem_spgemm_tpu_torch.ops import fixed as t_fixed
from pem_spgemm_tpu_torch.ops import numeric as t_numeric
from pem_spgemm_tpu_torch.ops import symbolic as t_symbolic
from pem_spgemm_tpu_torch.ops.macro_kernels import segment_offsets
from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

CHUNK = 1 << 10
CFG = SpGEMMConfig(numeric_chunk=CHUNK)
JCFG = JConfig(numeric_chunk=CHUNK)
ENGINES = ("fused", "masks")


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want, what):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6, err_msg=what)


@pytest.fixture(scope="module")
def case():
    """One matrix (A^2, B with tmasks) in both packages, the JAX pair stream
    at the interactive capacities, and every JAX phase result on it."""
    coo = JCOO.from_scipy(random_sparse(400, 400, 0.01, seed=4))
    ja, ta = both_tiled(coo)
    jb, tb = both_tiled(coo, with_tmasks=True)
    offsets = j_symbolic.pair_counts(ja.tile_col, jb.tile_rowptr,
                                     jnp.int32(ja.ntiles))
    n_pairs = int(offsets[-1])
    p_cap = max(CHUNK, round_up_pow2(n_pairs))
    packed = can_pack(ja.n_tile_rows, jb.n_tile_cols)
    pairs = j_symbolic.expand_pairs(
        offsets, ja.tile_row, ja.tile_col, jb.tile_rowptr, jb.tile_col,
        jnp.int32(n_pairs), p_cap, packed)
    c_row, c_col, a_idx, b_idx, c_tile_id, cnt = pairs
    c_cap = round_up_bucket(int(cnt))
    c_dense, c_counts = j_numeric.accumulate_fused_flat(
        ja.dense_flat(), jb.dense_flat(), a_idx, b_idx, c_tile_id, c_cap,
        CHUNK, jnp.float32)
    cmask, cptr = j_numeric.counts_to_masks(c_counts.reshape(c_cap, 16, 16))
    c_nnz = int(cptr[-1])
    c_nnz_cap = round_up_bucket(c_nnz)
    rowcol, elem_tile = j_cstruct.c_rowcol(cmask, cptr, c_nnz_cap)
    coords = j_cstruct.c_tile_coords(c_tile_id, c_row, c_col, c_cap, packed)
    vals = j_numeric.extract_values(c_dense, rowcol, elem_tile)
    a_dense = j_numeric.densify_tiles(ja.vals, ja.rowcol, ja.elem_tile,
                                      ja.tile_cap)
    b_dense = j_numeric.densify_tiles(jb.vals, jb.rowcol, jb.elem_tile,
                                      jb.tile_cap)
    j = dict(
        offsets=offsets, pairs=pairs, c_dense=c_dense, c_counts=c_counts,
        cmask=cmask, cptr=cptr, rowcol=rowcol, elem_tile=elem_tile,
        rowcol_scatter=j_cstruct.c_rowcol_scatter(cmask, c_nnz_cap),
        coords=coords, coords_unpacked=j_cstruct.c_tile_coords(
            c_tile_id, c_row, c_col, c_cap, False),
        vals=vals, a_dense=a_dense,
        acc_dense=j_numeric.accumulate_dense(
            a_dense, b_dense, a_idx, b_idx, c_tile_id, c_cap, CHUNK,
            jnp.float32),
        c_masks=j_cstruct.c_masks(ja.masks, jb.tmasks, a_idx, b_idx,
                                  c_tile_id, c_row, c_col, c_cap),
        coo=j_assemble.assemble_coo(coords[0], coords[1], rowcol, elem_tile,
                                    vals, jnp.int32(c_nnz)))
    j = {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
             else np.asarray(v)) for k, v in j.items()}
    return dict(coo=coo, ja=ja, ta=ta, jb=jb, tb=tb, j=j, n_pairs=n_pairs,
                p_cap=p_cap, packed=packed, c_cap=c_cap, c_nnz=c_nnz,
                c_nnz_cap=c_nnz_cap)


def test_dense_flat_and_densify_equal(case):
    ja, ta = case["ja"], case["ta"]
    flat = ta.dense_flat()
    assert flat is ta.dense_flat()                        # cached
    assert flat.shape == (ta.tile_cap + 1, 256)
    _eq(flat.reshape(-1, 2, 128), ja.dense_flat(), "dense_flat")
    assert not flat[ta.tile_cap].any()                    # the zero tile
    _eq(t_numeric.densify_tiles(ta.vals, ta.rowcol, ta.elem_tile,
                                ta.tile_cap), case["j"]["a_dense"],
        "densify_tiles")
    _eq(t_numeric.densify_tiles_flat(ta.vals, ta.rowcol, ta.elem_tile,
                                     ta.tile_cap).reshape(-1, 2, 128),
        j_numeric.densify_tiles_flat(ja.vals, ja.rowcol, ja.elem_tile,
                                     ja.tile_cap), "densify_tiles_flat")


def test_intra_rowptr_equal_and_popcount(case):
    """A mirror of tests/test_convert.py::test_intra_rowptr, the port
    against the JAX package, and the SWAR popcount over every 16-bit
    value."""
    ja, ta = case["ja"], case["ta"]
    rp = ta.intra_rowptr()
    _eq(rp, ja.intra_rowptr(), "intra_rowptr")
    masks = ta.masks.numpy()[:ta.ntiles]
    pc = np.array([[bin(int(x)).count("1") for x in row] for row in masks])
    want = np.concatenate(
        [np.zeros((len(pc), 1), int), np.cumsum(pc, axis=1)], axis=1)
    assert (rp.numpy()[:ta.ntiles] == want).all()
    every = torch.arange(1 << 16, dtype=torch.int32)
    assert t_cstruct.popcount16(every).tolist() == \
        [bin(v).count("1") for v in range(1 << 16)]


@pytest.mark.parametrize("n_kind", ["int", "device_scalar"])
def test_expand_pairs_equal(case, n_kind):
    ta, tb, j = case["ta"], case["tb"], case["j"]
    offsets = t_symbolic.pair_counts(ta.tile_col, tb.tile_rowptr, ta.ntiles)
    _eq(offsets, j["offsets"], "offsets")
    n = case["n_pairs"] if n_kind == "int" else offsets[-1]
    got = t_symbolic.expand_pairs(offsets, ta.tile_row, ta.tile_col,
                                  tb.tile_rowptr, tb.tile_col, n,
                                  case["p_cap"], case["packed"])
    for i, name in enumerate(("c_row", "c_col", "a_idx", "b_idx",
                              "c_tile_id", "cnt_c")):
        _eq(got[i], j["pairs"][i], name)


def _port_pairs(case):
    return [_t(x) for x in case["j"]["pairs"]]


def test_accumulate_fused_flat_equal(case):
    c_row, c_col, a_idx, b_idx, c_tile_id, _ = _port_pairs(case)
    c_dense, c_counts = t_numeric.accumulate_fused_flat(
        case["ta"].dense_flat(), case["tb"].dense_flat(), a_idx, b_idx,
        c_tile_id, case["c_cap"], CHUNK)
    _close(c_dense, case["j"]["c_dense"], "c_dense")
    _eq(c_counts, case["j"]["c_counts"], "c_counts")
    with pytest.raises(ValueError, match="precision"):
        t_numeric.accumulate_fused_flat(
            case["ta"].dense_flat(), case["tb"].dense_flat(), a_idx, b_idx,
            c_tile_id, case["c_cap"], CHUNK, precision="medium")


def test_accumulate_dense_equal(case):
    _, _, a_idx, b_idx, c_tile_id, _ = _port_pairs(case)
    ta, tb = case["ta"], case["tb"]
    a_dense = t_numeric.densify_tiles(ta.vals, ta.rowcol, ta.elem_tile,
                                      ta.tile_cap)
    b_dense = t_numeric.densify_tiles(tb.vals, tb.rowcol, tb.elem_tile,
                                      tb.tile_cap)
    got = t_numeric.accumulate_dense(a_dense, b_dense, a_idx, b_idx,
                                     c_tile_id, case["c_cap"], CHUNK)
    _close(got, case["j"]["acc_dense"], "accumulate_dense")


def test_counts_to_masks_and_extract_values_equal(case):
    j = case["j"]
    cmask, cptr = t_numeric.counts_to_masks(_t(j["c_counts"]))
    _eq(cmask, j["cmask"], "cmask")
    _eq(cptr, j["cptr"], "cptr")
    assert int(cptr[-1]) == case["c_nnz"]
    vals = t_numeric.extract_values(_t(j["c_dense"]), _t(j["rowcol"]),
                                    _t(j["elem_tile"]))
    _eq(vals, j["vals"], "extract_values")


def test_accumulate_fused_masks_equal(case):
    """The fused engine's step on the card (the kernel's masks form) has
    ``fused_masks_plain`` as its plain version: the JAX package's
    accumulate_fused_flat then counts_to_masks, masks and cptr bit for
    bit, values within the float32 bound."""
    _, _, a_idx, b_idx, c_tile_id, _ = _port_pairs(case)
    c_dense, cmask, cptr = t_numeric.accumulate_fused_masks(
        case["ta"].dense_flat(), case["tb"].dense_flat(), a_idx, b_idx,
        c_tile_id, case["c_cap"], CHUNK)
    _eq(cmask, case["j"]["cmask"], "cmask")
    _eq(cptr, case["j"]["cptr"], "cptr")
    _close(c_dense, case["j"]["c_dense"], "c_dense")


def test_c_rowcol_values_equal(case):
    """c_rowcol_values: the JAX package's c_rowcol then extract_values,
    padding slots included (c_nnz_cap > C_nnz here)."""
    j = case["j"]
    assert case["c_nnz_cap"] > case["c_nnz"]
    rowcol, elem_tile, vals = t_cstruct.c_rowcol_values(
        _t(j["cmask"]), _t(j["cptr"]), case["c_nnz_cap"], _t(j["c_dense"]))
    _eq(rowcol, j["rowcol"], "rowcol")
    _eq(elem_tile, j["elem_tile"], "elem_tile")
    _eq(vals, j["vals"], "c_vals")


@pytest.mark.parametrize("stream", ["one_card", "ring"])
def test_segment_offsets_is_the_jax_pair_ptr(case, stream):
    """The structure kernel's pair offsets (``segment_offsets`` of the
    sorted stream) equal the JAX package's pair_ptr (the scan of
    segment_sum(valid)) on the one-card stream (padding INT32_MAX) and on
    the same stream padded as the Tile16 ring pads it (c_cap); the port's
    c_masks on the ring-padded stream equals the JAX package's."""
    c_row, c_col, a_idx, b_idx, c_tile_id, _ = case["j"]["pairs"]
    c_cap = case["c_cap"]
    if stream == "ring":
        c_tile_id = np.where(c_tile_id < c_cap, c_tile_id,
                             c_cap).astype(np.int32)
        want = [np.asarray(x) for x in j_cstruct.c_masks(
            case["ja"].masks, case["jb"].tmasks, a_idx, b_idx, c_tile_id,
            c_row, c_col, c_cap)]
        got = t_cstruct.c_masks(case["ta"].masks, case["tb"].tmasks,
                                _t(a_idx), _t(b_idx), _t(c_tile_id),
                                _t(c_row), _t(c_col), c_cap)
        for i, name in enumerate(("c_tile_row", "c_tile_col", "cmask",
                                  "cptr", "pair_ptr")):
            _eq(got[i], want[i], f"ring {name}")
        pair_ptr = want[4]
    else:
        pair_ptr = case["j"]["c_masks"][4]
    _eq(segment_offsets(_t(c_tile_id), c_cap), pair_ptr, "pair_ptr")


def test_c_masks_equal(case):
    c_row, c_col, a_idx, b_idx, c_tile_id, _ = _port_pairs(case)
    got = t_cstruct.c_masks(case["ta"].masks, case["tb"].tmasks, a_idx,
                            b_idx, c_tile_id, c_row, c_col, case["c_cap"])
    for i, name in enumerate(("c_tile_row", "c_tile_col", "cmask", "cptr",
                              "pair_ptr")):
        _eq(got[i], case["j"]["c_masks"][i], name)
    _eq(got[2], case["j"]["cmask"], "c_masks against the fused pattern")


def test_c_rowcol_equal_and_scatter_agrees(case):
    j = case["j"]
    rowcol, elem_tile = t_cstruct.c_rowcol(_t(j["cmask"]), _t(j["cptr"]),
                                           case["c_nnz_cap"])
    _eq(rowcol, j["rowcol"], "rowcol")
    _eq(elem_tile, j["elem_tile"], "elem_tile")
    rs, es = t_cstruct.c_rowcol_scatter(_t(j["cmask"]), case["c_nnz_cap"])
    _eq(rs, j["rowcol_scatter"][0], "rowcol_scatter")
    _eq(es, j["rowcol_scatter"][1], "elem_tile_scatter")
    n = case["c_nnz"]
    assert torch.equal(rs[:n], rowcol[:n]) and torch.equal(es[:n],
                                                           elem_tile[:n])


@pytest.mark.parametrize("packed", [True, False])
def test_c_tile_coords_equal(case, packed):
    c_row, c_col, _, _, c_tile_id, _ = _port_pairs(case)
    got = t_cstruct.c_tile_coords(c_tile_id, c_row, c_col, case["c_cap"],
                                  packed)
    want = case["j"]["coords" if packed else "coords_unpacked"]
    _eq(got[0], want[0], "c_tile_row")
    _eq(got[1], want[1], "c_tile_col")


def test_assemble_coo_equal(case):
    j, n = case["j"], case["c_nnz"]
    rows, cols, vals = t_assemble.assemble_coo(
        _t(j["coords"][0]), _t(j["coords"][1]), _t(j["rowcol"]),
        _t(j["elem_tile"]), _t(j["vals"]), n)
    _eq(rows[:n], j["coo"][0][:n], "rows")
    _eq(cols[:n], j["coo"][1][:n], "cols")
    _eq(vals[:n], j["coo"][2][:n], "vals")
    assert (rows[n:] == 0x7FFFFFFF).all() and (cols[n:] == 0x7FFFFFFF).all()
    wr, wc, wv, wnnz = scipy_product(case["coo"])
    assert wnnz == n
    np.testing.assert_array_equal(rows[:n].numpy(), wr)
    np.testing.assert_array_equal(cols[:n].numpy(), wc)


def test_spgemm_fixed_equal(case):
    ja, jb, ta, tb = case["ja"], case["jb"], case["ta"], case["tb"]
    kw = dict(p_cap=case["p_cap"], c_cap=case["c_cap"],
              c_nnz_cap=case["c_nnz_cap"], chunk=CHUNK,
              packed=case["packed"], packed_coords=case["packed"])
    want = j_fixed.spgemm_fixed(
        ja.tile_row, ja.tile_col, ja.dense_flat(), jb.tile_rowptr,
        jb.tile_col, jb.dense_flat(), jnp.int32(ja.ntiles),
        acc_dtype=jnp.float32, **kw)
    got = t_fixed.spgemm_fixed(
        ta.tile_row, ta.tile_col, ta.dense_flat(), tb.tile_rowptr,
        tb.tile_col, tb.dense_flat(), ta.ntiles, **kw)
    names = ("c_tile_row", "c_tile_col", "cmask", "cptr", "c_rowcol",
             "c_elem_tile", "c_vals", "c_nnz", "overflow")
    for name, g, w in zip(names, got, want):
        (_close if name == "c_vals" else _eq)(g, w, name)
    assert int(got[7]) == case["c_nnz"] and not bool(got[8])


# --------------------------------------------------------------------------
# end to end: a mirror of tests/test_spgemm.py on the Tile16 engines


def run_square(m, engine, **kw):
    coo = TCOO.from_scipy(m)
    a = coo_to_tiled(coo, device="cpu")
    b = coo_to_tiled(coo, with_tmasks=True, device="cpu")
    cfg = CFG.with_(engine=engine, **kw)
    return SpGEMM(cfg)(a, b), cfg, a, b


def check_against_scipy(result, want, cfg=None, a=None, b=None):
    """Exact structure, tolerant values; with the operands, the steady
    plan too (C_nnz and the values it emits)."""
    want = want.tocsr()
    want.sum_duplicates()
    got = result.to_coo().to_scipy().tocsr()
    assert result.c_nnz == want.nnz, (result.c_nnz, want.nnz)
    assert (got.indptr == want.indptr).all()
    assert (got.indices == want.indices).all()
    np.testing.assert_allclose(got.data, want.data, rtol=1e-4, atol=1e-4)
    if cfg is not None:
        plan = t_fixed.make_plan(result, cfg, a, b)
        out = plan.run(a, b)
        assert int(plan.fence(out).numel()) == plan.c_nnz_cap
        assert int(out[7]) == want.nnz and not bool(out[8])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n,density,seed", [
    (64, 0.05, 0), (256, 0.02, 1), (600, 0.005, 2), (333, 0.01, 3),
])
def test_a_squared(n, density, seed, engine):
    m = random_sparse(n, n, density, seed)
    res, cfg, a, b = run_square(m, engine)
    assert res.engine == engine
    check_against_scipy(res, m @ m, cfg, a, b)


@pytest.mark.parametrize("engine", ENGINES)
def test_a_at(engine):
    m = random_sparse(300, 120, 0.02, seed=5)   # rectangular: A@A.T mode
    coo = TCOO.from_scipy(m)
    a = coo_to_tiled(coo, device="cpu")
    b = coo_to_tiled(coo.transpose(), with_tmasks=True, device="cpu")
    cfg = CFG.with_(engine=engine)
    check_against_scipy(SpGEMM(cfg)(a, b), m @ m.T, cfg, a, b)


@pytest.mark.parametrize("engine", ENGINES)
def test_banded_matrix(engine):
    n = 500
    diags = sp.diags([np.arange(1, n + 1), np.ones(n - 2),
                      2 * np.ones(n - 7)], [0, 2, 7], shape=(n, n),
                     format="coo")
    res, cfg, a, b = run_square(diags, engine)
    check_against_scipy(res, diags @ diags, cfg, a, b)


@pytest.mark.parametrize("engine", ENGINES)
def test_dense_block(engine):
    rs = np.random.default_rng(8)
    dense = np.zeros((100, 100))
    dense[:32, :32] = rs.standard_normal((32, 32))
    dense[60, 90] = 3.0
    m = sp.coo_matrix(dense)
    res, cfg, a, b = run_square(m, engine)
    check_against_scipy(res, m @ m, cfg, a, b)


@pytest.mark.parametrize("engine", ENGINES)
def test_structural_vs_numeric_zeros(engine):
    """Numeric cancellation does not shrink the structural C_nnz, on the
    interactive multiply and on the steady plan."""
    m = np.array([[1.0, -1.0], [1.0, 0.0]])
    res, cfg, a, b = run_square(sp.coo_matrix(m), engine)
    bool_nnz = int(((m != 0).astype(int) @ (m != 0).astype(int) != 0).sum())
    assert res.c_nnz == bool_nnz
    np.testing.assert_allclose(res.to_coo().to_scipy().toarray(), m @ m,
                               atol=1e-6)
    out = t_fixed.make_plan(res, cfg, a, b).run(a, b)
    assert int(out[7]) == bool_nnz


def test_engines_agree():
    """fused (0/1-product structure) and masks (bit planes) give the same
    masks, nnz and values, and each the JAX package's arrays of the same
    engine (the masks engine's tile coordinates keep the unpacked
    sentinel, as in the JAX package)."""
    m = random_sparse(400, 400, 0.01, seed=21)
    coo = JCOO.from_scipy(m)
    ja, ta = both_tiled(coo)
    jb, tb = both_tiled(coo, with_tmasks=True)
    results = []
    for engine in ENGINES:
        jr = JSpGEMM(JCFG.with_(engine=engine))(ja, jb)
        r = SpGEMM(CFG.with_(engine=engine))(ta, tb)
        assert (r.engine, r.c_nnz, r.n_pairs, r.c_ntiles) == (
            jr.engine, jr.c_nnz, jr.n_pairs, jr.c_ntiles)
        for f in ("c_tile_row", "c_tile_col", "cmask", "cptr", "rowcol",
                  "elem_tile"):
            _eq(getattr(r, f), getattr(jr, f), f"{engine} {f}")
        _close(r.vals, jr.vals, f"{engine} vals")
        results.append(r)
    fused, masks = results
    assert fused.c_nnz == masks.c_nnz
    assert torch.equal(fused.cmask, masks.cmask)
    a = fused.to_coo().to_scipy().tocsr()
    b = masks.to_coo().to_scipy().tocsr()
    assert (a.indices == b.indices).all()
    np.testing.assert_allclose(a.data, b.data, rtol=1e-5, atol=1e-6)
    check_against_scipy(fused, m @ m)


def test_empty_product_is_fused_for_both_engines():
    a = TCOO(np.array([0, 1], np.int32), np.array([40, 41], np.int32),
             np.array([1.0, 2.0], np.float32), (64, 64))
    b = TCOO(np.array([0, 1], np.int32), np.array([3, 4], np.int32),
             np.array([1.0, 2.0], np.float32), (64, 64))
    ta = coo_to_tiled(a, device="cpu")
    tb = coo_to_tiled(b, device="cpu")
    for engine in ENGINES:
        r = SpGEMM(CFG.with_(engine=engine))(ta, tb)
        assert (r.engine, r.c_nnz, r.n_pairs) == ("fused", 0, 0)
        got = r.to_coo()
        assert got.nnz == 0 and got.shape == (64, 64)


# --------------------------------------------------------------------------
# the steady plan: a mirror of tests/test_fixed.py's Tile16 cases


def test_planned_matches_interactive():
    m = random_sparse(500, 500, 0.01, seed=4)
    coo = JCOO.from_scipy(m)
    ja, ta = both_tiled(coo)
    cfg = CFG.with_(engine="fused")
    res = SpGEMM(cfg)(ta, ta)
    plan = t_fixed.make_plan(res, cfg, ta, ta)
    assert isinstance(plan, t_fixed.SpGEMMPlan)
    jres = JSpGEMM(JCFG.with_(engine="fused"))(ja, ja)
    jplan = j_fixed.make_plan(jres, JCFG.with_(engine="fused"), ja, ja)
    assert (plan.p_cap, plan.c_cap, plan.c_nnz_cap, plan.chunk,
            plan.packed, plan.precision) == (
        jplan.p_cap, jplan.c_cap, jplan.c_nnz_cap, jplan.chunk,
        jplan.packed, jplan.precision)
    (c_tile_row, c_tile_col, cmask, cptr, c_rowcol, c_elem_tile, c_vals,
     c_nnz, overflow) = plan.run(ta, ta)
    assert int(c_nnz) == res.c_nnz and not bool(overflow)
    n = res.c_nnz
    assert torch.equal(cmask[:res.cmask.shape[0]], res.cmask)
    assert torch.equal(c_rowcol[:n], res.rowcol[:n])
    np.testing.assert_allclose(c_vals[:n].numpy(), res.vals[:n].numpy(),
                               rtol=1e-6)
    assert plan.fence(plan.run(ta, ta)) is not c_vals   # eager on the CPU


def test_plan_overflow_flag_and_regrow():
    """An undersized plan trips the overflow flag, and grown() plans
    converge to a correct run."""
    m = random_sparse(400, 400, 0.01, seed=11)
    _, ta = both_tiled(JCOO.from_scipy(m))
    cfg = CFG.with_(engine="fused")
    res = SpGEMM(cfg)(ta, ta)
    plan = t_fixed.make_plan(res, cfg, ta, ta)
    small = dataclasses.replace(plan, p_cap=1 << 10,
                                c_cap=max(256, plan.c_cap // 4),
                                c_nnz_cap=max(1024, plan.c_nnz_cap // 4))
    assert bool(small.run(ta, ta)[-1]), "undersized plan must overflow"
    grown = small
    for _ in range(8):
        out = grown.run(ta, ta)
        if not bool(out[-1]):
            break
        grown = grown.grown()
        assert grown._graph == {} and grown._graph is not small._graph
    assert not bool(out[-1])
    assert int(out[-2]) == res.c_nnz


def test_select16_is_the_bit_rank_loop():
    """The table select against the JAX package's 16-step loop over the
    bits, on every mask that has bits at each rank, and ranks out of
    range (0, as the loop leaves them)."""
    rs = np.random.default_rng(3)
    m = np.concatenate([np.arange(1 << 16), rs.integers(0, 1 << 16, 4000)])
    k = np.concatenate([rs.integers(0, 16, 1 << 16),
                        rs.integers(-3, 20, 4000)])
    col = np.zeros_like(m)
    cnt = np.zeros_like(m)
    for c in range(16):
        bit = (m >> c) & 1
        col = np.where((bit == 1) & (cnt == k), c, col)
        cnt = cnt + bit
    got = t_cstruct.select16(torch.from_numpy(m.astype(np.int32)),
                             torch.from_numpy(k.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), col)
