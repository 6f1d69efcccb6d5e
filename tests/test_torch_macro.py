"""The Macro128 engine of the port against the JAX package's on the same
numpy inputs (CPU tensors: the plain PyTorch versions run; the JAX package's
Pallas kernel runs in interpret mode).

Structure must be equal array by array: conversions, pair streams, tile
coordinates, C_nnz, sorted COO.  Values: rtol=1e-5, atol=1e-5 against the
JAX accumulations (as tests/test_pallas.py and tests/test_stencil.py state;
the order of additions differs), rtol=1e-4, atol=1e-4 against scipy (as
tests/test_macro.py states)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import random_sparse
from test_torch_util import assert_same, both_coo, both_tiled, to_np
from pem_spgemm_tpu import SpGEMM as JSpGEMM, SpGEMMConfig as JConfig
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import (
    banded, wandering_device as j_wandering_device)
from pem_spgemm_tpu.ops import cstruct as j_cstruct, macro as j_macro, \
    scanops as j_scanops, symbolic as j_symbolic
from pem_spgemm_tpu.ops.convert import coo_to_macro as j_coo_to_macro
from pem_spgemm_tpu_torch import SpGEMM, SpGEMMConfig, interop
from pem_spgemm_tpu_torch.bench import cli
from pem_spgemm_tpu_torch.bench.harness import run_benchmark
from pem_spgemm_tpu_torch.formats.coo import COOMatrix as TCOO
from pem_spgemm_tpu_torch.formats.macro import MacroMatrix
from pem_spgemm_tpu_torch.models import synthetic as t_synthetic
from pem_spgemm_tpu_torch.ops import cstruct, macro, macro_kernels as mk, \
    scanops, symbolic
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, tiled_to_macro
from pem_spgemm_tpu_torch.ops.fixed import MacroPlan, make_plan


def _blocks():
    rs = np.random.default_rng(0)
    rows_l, cols_l, vals_l = [], [], []
    for (br, bc) in [(0, 0), (0, 1), (1, 1), (2, 0), (2, 2)]:
        r, c = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
        rows_l.append((br * 128 + r).ravel())
        cols_l.append((bc * 128 + c).ravel())
        vals_l.append(rs.standard_normal(128 * 128))
    return JCOO(np.concatenate(rows_l).astype(np.int32),
                np.concatenate(cols_l).astype(np.int32),
                np.concatenate(vals_l), (384, 384)).sum_duplicates()


def _wandering():
    c = j_wandering_device(n=2048, width=32, block=128, seed=11)
    return JCOO(np.array(c.rows), np.array(c.cols), np.array(c.vals),
                c.shape)


MATRICES = {
    "banded": lambda: banded(n=1500, bands=(0, 1, -1, 2, -2, 40, -40),
                             seed=1),
    "gapped": lambda: banded(n=2000, bands=(0, 3, -3, 64, -64), seed=4),
    "blocks": _blocks,
    "wandering": _wandering,
    "rect": lambda: JCOO.from_scipy(random_sparse(300, 500, 0.02, seed=7)),
}


@pytest.fixture(scope="module")
def mats():
    """kind -> (numpy COO, JAX MacroMatrix, port MacroMatrix), built once."""
    cache = {}

    def get(kind):
        if kind not in cache:
            coo = MATRICES[kind]()
            jc, tc = both_coo(coo)
            cache[kind] = (coo, j_coo_to_macro(jc, dtype=jnp.float32),
                           coo_to_macro(tc, device="cpu"))
        return cache[kind]
    return get


def _j_pairs(ja, jb, gran, packed=True):
    offsets = j_symbolic.pair_counts(ja.tile_col, jb.tile_rowptr,
                                     jnp.int32(ja.ntiles))
    n_pairs = int(offsets[-1])
    p_cap = max(gran, -(-n_pairs // gran) * gran)
    return offsets, n_pairs, p_cap, j_symbolic.expand_pairs(
        offsets, ja.tile_row, ja.tile_col, jb.tile_rowptr, jb.tile_col,
        jnp.int32(n_pairs), p_cap, packed)


def _t_pairs(ta, tb, gran, packed=True):
    offsets = symbolic.pair_counts(ta.tile_col, tb.tile_rowptr, ta.ntiles)
    n_pairs = int(offsets[-1])
    p_cap = max(gran, -(-n_pairs // gran) * gran)
    return offsets, n_pairs, p_cap, symbolic.expand_pairs(
        offsets, ta.tile_row, ta.tile_col, tb.tile_rowptr, tb.tile_col,
        n_pairs, p_cap, packed)


def _scipy_sorted(coo, b_coo=None):
    s = coo.to_scipy().tocsr()
    sb = s if b_coo is None else b_coo.to_scipy().tocsr()
    want = (s @ sb).tocoo()
    want.sum_duplicates()
    o = np.lexsort((want.col, want.row))
    return want.row[o], want.col[o], want.data[o]


# --------------------------------------------------------------------------
# helpers, format, conversion

@pytest.mark.parametrize("n_hi,n_lo", [(10, 10), (65535, 65535),
                                       (65536, 3), (3, 65536)])
def test_can_pack_equal(n_hi, n_lo):
    assert scanops.can_pack(n_hi, n_lo) == j_scanops.can_pack(n_hi, n_lo)
    assert scanops.PACK_LIMIT == j_scanops.PACK_LIMIT


def test_pack_key_roundtrip_and_order_equal():
    rs = np.random.default_rng(3)
    hi = rs.integers(0, 1 << 16, 500).astype(np.int32)
    lo = rs.integers(0, 1 << 16, 500).astype(np.int32)
    want = np.asarray(j_scanops.pack_key(jnp.asarray(hi), jnp.asarray(lo)))
    got = scanops.pack_key(torch.from_numpy(hi), torch.from_numpy(lo))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    h2, l2 = scanops.unpack_key(got)
    np.testing.assert_array_equal(h2.numpy(), hi)
    np.testing.assert_array_equal(l2.numpy(), lo)
    # signed order of the key == lexicographic order of the fields
    np.testing.assert_array_equal(np.argsort(got.numpy(), kind="stable"),
                                  np.lexsort((lo, hi)))


@pytest.mark.parametrize("kind", sorted(MATRICES))
def test_coo_to_macro_equal(mats, kind):
    coo, jm, tm = mats(kind)
    assert isinstance(tm, MacroMatrix)
    assert_same(jm, tm, "macro")
    assert (tm.tile_cap, tm.n_macro_rows, tm.n_macro_cols) == \
        (jm.tile_cap, jm.n_macro_rows, jm.n_macro_cols)
    assert tm.fill_ratio() == jm.fill_ratio()
    assert tm.device == torch.device("cpu")
    assert not tm.dense[tm.tile_cap].any()      # the reserved zero tile


@pytest.mark.parametrize("kind", ["banded", "rect"])
def test_tiled_to_macro_equal(mats, kind):
    coo, jm, _tm = mats(kind)
    ja, ta = both_tiled(coo)
    assert_same(ja.macro(), ta.macro(), "tiled.macro")
    assert_same(jm, tiled_to_macro(ta), "tiled_to_macro")
    assert ta.macro() is ta.macro()             # cached on the instance


def test_macro_from_numpy_hands_the_jax_matrix_over(mats):
    _coo, jm, tm = mats("gapped")
    assert_same(jm, interop.macro_from_numpy(to_np(jm), device="cpu"),
                "interop")


def test_coo_to_macro_refuses_duplicates_empty_and_small_caps():
    rows = np.array([0, 0, 5], np.int32)
    cols = np.array([1, 1, 2], np.int32)
    vals = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="duplicate"):
        coo_to_macro(TCOO(rows, cols, vals, (8, 8)), device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        j_coo_to_macro(JCOO(rows, cols, vals, (8, 8)))
    z = np.zeros(0, np.int32)
    with pytest.raises(ValueError, match="empty"):
        coo_to_macro(TCOO(z, z, np.zeros(0, np.float32), (4, 4)),
                     device="cpu")
    with pytest.raises(ValueError, match="packed-key"):
        coo_to_macro(TCOO(np.array([0], np.int32), np.array([0], np.int32),
                          np.ones(1, np.float32), (128 << 16, 4)),
                     device="cpu")
    with pytest.raises(ValueError, match="tile_cap"):
        coo_to_macro(TCOO(np.array([0, 300], np.int32),
                          np.array([0, 300], np.int32),
                          np.ones(2, np.float32), (512, 512)),
                     tile_cap=1, device="cpu")


def test_macro_conversion_roundtrip():
    coo = banded(n=700, bands=(0, 5, -9), seed=5)
    m = coo_to_macro(both_coo(coo)[1], device="cpu")
    dense = np.zeros(coo.shape, np.float32)
    d = m.dense.numpy()
    tr = m.tile_row.numpy()[:m.ntiles]
    tc = m.tile_col.numpy()[:m.ntiles]
    for t in range(m.ntiles):
        r0, c0 = tr[t] * 128, tc[t] * 128
        h = min(128, coo.shape[0] - r0)
        w = min(128, coo.shape[1] - c0)
        dense[r0:r0 + h, c0:c0 + w] = d[t][:h, :w]
    np.testing.assert_allclose(dense, coo.to_scipy().toarray(), rtol=1e-6)


# --------------------------------------------------------------------------
# symbolic phase

def _operands(mats, kind):
    coo, jm, tm = mats(kind)
    if kind != "rect":
        return jm, jm, tm, tm
    jt, tt = both_coo(coo.transpose())
    return (jm, j_coo_to_macro(jt, dtype=jnp.float32), tm,
            coo_to_macro(tt, device="cpu"))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("kind", ["banded", "gapped", "wandering", "rect"])
def test_pair_counts_and_expand_pairs_equal(mats, kind, packed):
    ja, jb, ta, tb = _operands(mats, kind)
    j_off, jn, j_cap, j_out = _j_pairs(ja, jb, 32, packed)
    t_off, tn, t_cap, t_out = _t_pairs(ta, tb, 32, packed)
    assert (jn, j_cap) == (tn, t_cap) and jn < j_cap    # padding pairs exist
    assert_same(j_off, t_off, "offsets")
    for name, jx, tx in zip(("c_row", "c_col", "a_idx", "b_idx",
                             "c_tile_id", "cnt_c"), j_out, t_out):
        assert_same(jx, tx, name)
    # a device scalar as n_pairs gives the same stream (no host copy)
    again = symbolic.expand_pairs(t_off, ta.tile_row, ta.tile_col,
                                  tb.tile_rowptr, tb.tile_col, t_off[-1],
                                  t_cap, packed)
    for x, y in zip(t_out, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("packed", [True, False])
def test_c_tile_coords_equal(mats, packed):
    ja, jb, ta, tb = _operands(mats, "gapped")
    _o, _n, _c, (jr, jc, _ja, _jb, jid, jcnt) = _j_pairs(ja, jb, 32)
    _o, _n, _c, (tr, tc, _ta, _tb, tid, tcnt) = _t_pairs(ta, tb, 32)
    for c_cap in (256, int(jcnt) - 3):          # roomy, and truncating
        want = j_cstruct.c_tile_coords(jid, jr, jc, c_cap, packed)
        got = cstruct.c_tile_coords(tid, tr, tc, c_cap, packed)
        assert_same(tuple(want), tuple(got), f"c_tile_coords {c_cap}")


def test_expand_pairs_of_an_empty_join():
    a = TCOO(np.array([0], np.int32), np.array([200], np.int32),
             np.ones(1, np.float32), (256, 256))
    ta = coo_to_macro(a, device="cpu")
    off = symbolic.pair_counts(ta.tile_col, ta.tile_rowptr, ta.ntiles)
    assert int(off[-1]) == 0
    out = symbolic.expand_pairs(off, ta.tile_row, ta.tile_col,
                                ta.tile_rowptr, ta.tile_col, 0, 32, True)
    assert int(out[5]) == 0 and bool((out[4] == symbolic.INT32_MAX).all())
    res = SpGEMM(SpGEMMConfig(engine="macro"))(ta, ta)
    assert (res.engine, res.c_nnz, res.to_coo().nnz) == ("macro", 0, 0)


# --------------------------------------------------------------------------
# accumulation: the plain versions against the JAX package

@pytest.fixture(scope="module")
def gapped_stream(mats):
    """The pair stream of the gapped-band matrix in both packages and the
    JAX accumulations of it: the XLA path and the Pallas kernel in interpret
    mode (several chained windows)."""
    import pem_spgemm_tpu.ops.pallas_macro2 as pm2
    _coo, jm, tm = mats("gapped")
    _o, jn, _c, (jr, jc, ja, jb, jid, jcnt) = _j_pairs(jm, jm, 32)
    _o, tn, _c, t_out = _t_pairs(tm, tm, 32)
    c_cap = max(4, -(-int(jcnt) // 4) * 4)
    ref_n, ref_c = j_macro.accumulate_macro(
        jm.dense, jm.dense, ja, jb, jid, c_cap, 32, jnp.float32)
    pal_n, pal_c = pm2.accumulate_macro_pipelined(
        jm.dense, jm.dense, ja, jb, jid, jcnt, c_cap, interpret=True,
        window=64)
    return dict(jm=jm, tm=tm, t_out=t_out, c_cap=c_cap, n_c=int(jcnt),
                xla=(np.asarray(ref_n), np.asarray(ref_c, np.float32)),
                pallas=(np.asarray(pal_n), np.asarray(pal_c, np.float32)))


@pytest.mark.parametrize("against", ["xla", "pallas"])
@pytest.mark.parametrize("entry", ["accumulate_macro",
                                   "accumulate_macro_pairs"])
def test_pair_accumulation_matches_jax(gapped_stream, entry, against):
    g = gapped_stream
    tm, (_r, _c, a_idx, b_idx, seg, _cnt) = g["tm"], g["t_out"]
    mk.reset_launch_counts()
    if entry == "accumulate_macro":
        num, flags = macro.accumulate_macro(tm.dense, tm.dense, a_idx, b_idx,
                                            seg, g["c_cap"], 32)
    else:           # the kernel's wrapper: a CPU tensor takes the plain path
        num, flags = mk.accumulate_macro_pairs(tm.dense, tm.dense, a_idx,
                                               b_idx, seg, g["c_cap"],
                                               chunk=32)
    assert mk.LAUNCHES["macro_accumulate_pairs"] == 0
    assert flags.dtype == torch.uint8 and num.dtype == torch.float32
    want_n, want_c = g[against]
    n_c = g["n_c"]
    np.testing.assert_allclose(num.numpy()[:n_c], want_n[:n_c], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(flags.numpy()[:n_c] > 0, want_c[:n_c] > 0)
    assert not num[n_c:].any() and not flags[n_c:].any()
    want_ptr = np.asarray(j_macro.macro_structure(jnp.asarray(want_c)))
    np.testing.assert_array_equal(macro.macro_structure(flags).numpy(),
                                  want_ptr[:g["c_cap"] + 1])


def _replay_tile_product(a_tiles, b_tiles):
    """numpy replay of the kernel's tile product for one C tile: the 8x8
    register tile of thread (ty, tx), the k-slabs of 16, the per-slab
    non-zero masks (one bit a byte for A rows, one bit a column for B), the
    integer-multiply outer product and the flag bytes of the epilogue."""
    num = np.zeros((128, 128), np.float32)
    flag = np.zeros((128, 128), np.uint8)
    ty, tx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    rows = np.concatenate([4 * ty[..., None] + np.arange(4),
                           64 + 4 * ty[..., None] + np.arange(4)], -1)
    cols = np.concatenate([4 * tx[..., None] + np.arange(4),
                           64 + 4 * tx[..., None] + np.arange(4)], -1)
    plo = np.zeros((16, 16), np.uint32)
    phi = np.zeros((16, 16), np.uint32)
    for a, b in zip(a_tiles, b_tiles):
        num += a @ b                    # the order of additions is not held
        for k in range(128):
            nza = (a[:, k] != 0).astype(np.uint32)
            nzb = (b[k, :] != 0).astype(np.uint32)
            g = np.arange(16)
            am_lo = sum(nza[4 * g + i] << (8 * i) for i in range(4))
            am_hi = sum(nza[64 + 4 * g + i] << (8 * i) for i in range(4))
            bm = sum(nzb[4 * g + j] << j for j in range(4)) \
                + sum(nzb[64 + 4 * g + j] << (4 + j) for j in range(4))
            assert bm.max(initial=0) < 256
            plo |= am_lo[ty] * bm[tx]           # no carry between bytes
            phi |= am_hi[ty] * bm[tx]
    for i in range(8):
        bits = ((plo if i < 4 else phi) >> (8 * (i & 3))) & 0xFF
        for h in range(2):
            x = (bits >> (4 * h)) & 0xF
            word = (x & 1) | (x & 2) << 7 | (x & 4) << 14 | (x & 8) << 21
            for j in range(4):
                flag[rows[..., i], cols[..., 4 * h + j]] = \
                    (word >> (8 * j)) & 0xFF
    return num, flag


def test_pair_kernel_index_arithmetic_replayed_in_numpy(gapped_stream):
    """What the pair-stream kernel does with the tables its wrapper uploads:
    block c walks the pairs [seg_ptr[c], seg_ptr[c+1]), never a padding
    pair, and writes tile c once."""
    g = gapped_stream
    tm, (_r, _c, a_idx, b_idx, seg, _cnt) = g["tm"], g["t_out"]
    c_cap = g["c_cap"] + 5                      # tiles past the stream's
    seg_ptr = mk.segment_offsets(seg, c_cap).numpy()
    assert seg_ptr.dtype == np.int32 and seg_ptr[0] == 0
    n_pairs = int((seg != symbolic.INT32_MAX).sum())
    assert seg_ptr[-1] == n_pairs < seg.numel()
    assert (np.diff(seg_ptr)[g["n_c"]:] == 0).all()
    want_n, want_f = macro.accumulate_macro(tm.dense, tm.dense, a_idx, b_idx,
                                            seg, c_cap, 32)
    d = tm.dense.numpy()
    pa, pb = a_idx.numpy(), b_idx.numpy()
    for c in list(range(0, g["n_c"], 7)) + [g["n_c"], c_cap - 1]:
        lo, hi = seg_ptr[c], seg_ptr[c + 1]
        num, flag = _replay_tile_product(d[pa[lo:hi]], d[pb[lo:hi]])
        np.testing.assert_allclose(num, want_n[c].numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(flag, want_f[c].numpy())


def test_macro_structure_counts_flags_exactly():
    g = torch.Generator().manual_seed(0)
    flags = (torch.rand((7, 128, 128), generator=g) < 0.4).to(torch.uint8)
    flags[2] = 1                                # a full tile: 16,384
    flags[5] = 0
    want = np.concatenate([[0], np.cumsum(flags.numpy().reshape(7, -1)
                                          .sum(1, dtype=np.int64))])
    got = macro.macro_structure(flags)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_macro.macro_structure(
            jnp.asarray(flags.numpy(), jnp.bfloat16))))
    with pytest.raises(TypeError, match="uint8"):
        macro.macro_structure(flags.float())


def test_accumulate_keeps_a_cancelled_entry():
    coo = TCOO(np.array([0, 0, 1, 2], np.int32),
               np.array([1, 2, 3, 3], np.int32),
               np.array([1.0, 1.0, 1.0, -1.0], np.float32), (200, 200))
    res = SpGEMM(SpGEMMConfig(engine="macro"))(
        *(coo_to_macro(coo, device="cpu"),) * 2)
    got = res.to_coo()
    assert res.c_nnz == 1 and got.rows.tolist() == [0]
    assert got.cols.tolist() == [3] and got.vals.tolist() == [0.0]


def test_wrappers_refuse_what_the_kernels_do_not_take(gapped_stream):
    g = gapped_stream
    tm, (_r, _c, a_idx, b_idx, seg, _cnt) = g["tm"], g["t_out"]
    with pytest.raises(ValueError, match="128"):
        mk.accumulate_macro_pairs(tm.dense[:, :64], tm.dense, a_idx, b_idx,
                                  seg, 8)
    with pytest.raises(ValueError, match="int32"):
        mk.accumulate_macro_pairs(tm.dense, tm.dense, a_idx.long(), b_idx,
                                  seg, 8)
    with pytest.raises(ValueError, match="entries"):
        mk.accumulate_macro_pairs(tm.dense, tm.dense, a_idx[:-1], b_idx,
                                  seg, 8)
    with pytest.raises(ValueError, match="contiguous"):
        mk.accumulate_macro_pairs(tm.dense.transpose(1, 2), tm.dense, a_idx,
                                  b_idx, seg, 8)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            macro.accumulate_macro(tm.dense, tm.dense, a_idx, b_idx, seg, 8,
                                   32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# --------------------------------------------------------------------------
# the engine end to end

def _check_macro(coo, cfg, b_coo=None):
    """The port's SpGEMM(engine="macro") against the JAX package's and
    scipy: structure exact, values rtol=1e-4, atol=1e-4."""
    ja, ta = both_tiled(coo)
    jb, tb = (ja, ta) if b_coo is None else both_tiled(b_coo)
    res = SpGEMM(cfg)(ta, tb)
    jres = JSpGEMM(JConfig(engine="macro", macro_chunk=cfg.macro_chunk))(
        ja, jb)
    assert res.engine == jres.engine == "macro"
    assert (res.c_nnz, res.n_pairs, res.c_ntiles, tuple(res.shape)) == \
        (jres.c_nnz, jres.n_pairs, jres.c_ntiles, tuple(jres.shape))
    assert_same(jres.c_tile_row, res.c_tile_row, "c_tile_row")
    assert_same(jres.c_tile_col, res.c_tile_col, "c_tile_col")
    assert_same(jres.cptr, res.cptr, "cptr")
    wr, wc, wv = _scipy_sorted(coo, b_coo)
    assert res.c_nnz == len(wr)
    got, jgot = res.to_coo(), jres.to_coo()
    for c in (got, jgot):
        np.testing.assert_array_equal(c.rows, wr)
        np.testing.assert_array_equal(c.cols, wc)
    np.testing.assert_allclose(got.vals, wv, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.vals, jgot.vals, rtol=1e-4, atol=1e-4)
    return ta, res


def test_macro_banded_matches_scipy():
    _check_macro(MATRICES["banded"](),
                 SpGEMMConfig(engine="macro", macro_chunk=32))


def test_macro_dense_blocks():
    _check_macro(_blocks(), SpGEMMConfig(engine="macro", macro_chunk=32))


def test_macro_rectangular_a_at():
    coo = MATRICES["rect"]()
    _check_macro(coo, SpGEMMConfig(engine="macro", macro_chunk=32),
                 coo.transpose())


def test_macro_auto_dispatch():
    dense_band = banded(n=1024, bands=tuple(range(-12, 13)), seed=2)
    ja, ta = both_tiled(dense_band)
    cfg = SpGEMMConfig(macro_threshold=512)
    assert SpGEMM(cfg).pick_engine(ta, ta) == "macro" == \
        JSpGEMM(JConfig(macro_threshold=512)).pick_engine(ja, ja)
    res = SpGEMM(cfg)(ta, ta)                   # auto runs what it picked
    assert res.engine == "macro"
    assert res.c_nnz == len(_scipy_sorted(dense_band)[0])
    sparse = JCOO.from_scipy(random_sparse(2000, 2000, 0.001, seed=3))
    _, tb = both_tiled(sparse)
    assert SpGEMM(SpGEMMConfig()).pick_engine(tb, tb) == "element"


def test_macro_plan_matches_interactive():
    coo = banded(n=1200, bands=(0, 3, -3, 64, -64), seed=4)
    cfg = SpGEMMConfig(engine="macro", macro_chunk=32)
    a, res = _check_macro(coo, cfg)
    mk.reset_launch_counts()
    plan = make_plan(res, cfg, a, a)
    assert isinstance(plan, MacroPlan)          # CPU operands: no class plan
    (c_tile_row, c_tile_col, c_dense, c_flags, cptr, c_nnz,
     overflow) = plan.run(a, a)
    assert int(c_nnz) == res.c_nnz and not bool(overflow)
    assert plan.fence((0, 0, 0, 0, cptr)) is cptr
    assert sum(mk.LAUNCHES.values()) == 0       # CPU tensors: plain version
    rows, cols, vals = macro.assemble_macro_coo(c_tile_row, c_tile_col,
                                                c_dense, c_flags, c_nnz)
    ref = res.to_coo()
    np.testing.assert_array_equal(rows, ref.rows)
    np.testing.assert_array_equal(cols, ref.cols)
    np.testing.assert_allclose(vals, ref.vals, rtol=1e-5, atol=1e-5)
    # an undersized plan reports overflow, and growing it repairs it
    small = MacroPlan(p_cap=32, c_cap=256, chunk=32,
                      acc_dtype=torch.float32)
    assert bool(small.run(a, a)[-1])
    grown = small.grown().grown().grown().grown()
    assert (grown.p_cap, grown.c_cap) == (512, 4096)
    out = grown.run(a, a)
    assert not bool(out[-1]) and int(out[5]) == res.c_nnz


def test_macro_refuses_lower_precision():
    _, ta = both_tiled(MATRICES["banded"]())
    with pytest.raises(NotImplementedError, match="float32 only"):
        SpGEMM(SpGEMMConfig(engine="macro", precision="default"))(ta, ta)


@pytest.mark.parametrize("kind", ["gapped", "wandering"])
def test_run_benchmark_engine_macro_on_the_cpu(kind, tmp_path):
    coo = MATRICES[kind]()
    tcoo = both_coo(coo)[1]
    path = tmp_path / "bench.csv"
    mk.reset_launch_counts()
    rec, res = run_benchmark(tcoo, f"dir/{kind}.mtx",
                             SpGEMMConfig(engine="macro", repeat=2),
                             csv_path=str(path), verbose=False, device="cpu")
    wr, wc, wv = _scipy_sorted(coo)
    assert res.engine == "macro" and rec.matrix == kind
    assert rec.c_nnz == res.c_nnz == len(wr) == int(res.cptr[-1])
    got = res.to_coo()                  # the refreshed steady output
    np.testing.assert_array_equal(got.rows, wr)
    np.testing.assert_array_equal(got.cols, wc)
    np.testing.assert_allclose(got.vals, wv, rtol=1e-4, atol=1e-4)
    assert rec.pem_spgemm_time > 0 and rec.steady_state_time > 0
    assert rec.pipelined_time > 0 and rec.step3_time > 0
    assert len(path.read_text().splitlines()) == 2
    assert sum(mk.LAUNCHES.values()) == 0


def test_cli_engine_macro_on_the_cpu(tmp_path):
    out = tmp_path / "out"
    record = cli.main(["wandering:n=1024,width=32,seed=3", "1", "--repeat",
                       "1", "--warmup", "0", "--no-csv", "--outdir",
                       str(out), "--engine", "macro", "--device", "cpu"])
    coo = t_synthetic.wandering_device(n=1024, width=32, seed=3,
                                       device="cpu")
    wr, wc, wv = _scipy_sorted(coo)
    assert record.c_nnz == len(wr)
    np.testing.assert_array_equal(
        np.loadtxt(out / "SPGEMM_RESULT_ROWS.txt", dtype=np.int64), wr)
    np.testing.assert_array_equal(
        np.loadtxt(out / "SPGEMM_RESULT_COLS.txt", dtype=np.int64), wc)
    np.testing.assert_allclose(np.loadtxt(out / "SPGEMM_RESULT_VALS.txt"),
                               wv, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(n=2048, width=32, seed=11), dict(n=4096, seed=4),
    dict(n=4096, width=64, step_max=16, seed=4),
    dict(n=1024, width=16, block=64, step_max=1, seed=0)])
def test_wandering_device_structure_equals_the_jax_generator(kw):
    want = j_wandering_device(**kw)
    got = t_synthetic.wandering_device(device="cpu", **kw)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.nnz == want.nnz == kw["n"] * kw.get("width", 64)
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    assert got.vals.dtype == torch.float32 and bool((got.vals != 0).all())
    by = t_synthetic.by_name(
        "wandering:" + ",".join(f"{k}={v}" for k, v in kw.items()),
        device="cpu")
    assert torch.equal(by.cols, got.cols) and torch.equal(by.vals, got.vals)
