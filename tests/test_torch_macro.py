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
from test_torch_util import (assert_same, both_coo, both_tiled,
                             one_torch_thread, to_np, xla_unoptimized)
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
    scanops, stencil as st, symbolic
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, tiled_to_macro
from pem_spgemm_tpu_torch.ops.fixed import MacroPlan, make_plan

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)


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


def _cu_constant(name):
    """An int constexpr of csrc/macro_accumulate.cu, read from the source."""
    import re
    with open(mk.SOURCE) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    return int(m.group(1))


def _replay_tc_kernel(dense, w, n_rows, grid, seed, prior=None):
    """Python replay of macro_tc_kernel (every float32 launch at
    "highest") over the walk ``w`` (test_torch_onepass's StreamTiles,
    ClassTiles or ListTiles of the .cu; A = B = ``dense``): ``grid`` blocks
    (at most the tiles the launch is sized for), each a generator from one
    barrier to the next, advanced in a seeded random order around one
    ticket counter; per block warp 0's Issuer (test_torch_onepass's replay
    of the .cu's: the claim pipeline, the tiles' k-masks, the slabs that
    run, a store-only stage a tile, DONE) publishing stage n + 3 into a
    ring of TC_INFO slots while stage n computes, every thread issuing
    stage n + 2's copies into raw slot n % 2 and splitting stage n + 1 into
    split slot (n + 1) % 2.  At a tile's store-only stage the fresh form
    (``prior`` None) writes the tile whole: its sums, which start at +0.0,
    and flags; the accumulate form (``prior`` (values, flags)) reads and
    writes a tile of which a slab ran once (old + partial, flags ORed) and
    leaves one none of whose slabs ran.  Returns (values, flags, owner,
    events, reads, counter): the n_rows C rows as the replay forms them
    (the fresh form's start NaN and 7, so a row never written shows), the
    block that wrote each row (-2: none), per row its (A tile, B tile,
    slab) in the order run, how often each row was read, and the ticket
    counter at the end."""
    from test_torch_onepass import Issuer
    L = _cu_constant("TC_INFO")
    KS = 32
    counter = [0]
    if prior is None:
        values = np.full((n_rows, 128, 128), np.nan)
        flags = np.full((n_rows, 128, 128), 7, np.uint8)
    else:
        values = prior[0].astype(np.float64)
        flags = prior[1].copy()
    owner = np.full(n_rows, -2)
    reads = np.zeros(n_rows, np.int64)
    events = {}

    def block(b):
        info = [None] * L               # (stage, its StageInfo) a slot
        computed = [-1]                 # the last stage computed

        def publish(iss, n):
            old = info[n % L]
            assert old is None or old[0] <= computed[0], \
                "a stage slot overwritten before its stage ran"
            info[n % L] = (n, iss.publish())

        def read(n):
            e = info[n % L]
            assert e is not None and e[0] == n, "a stage read unpublished"
            return e[1]

        iss = Issuer(w, counter)        # warp 0: start, tickets taken
        for n in range(L - 1):
            publish(iss, n)
        yield                           # __syncthreads
        raw, split = [None, None], set()

        def issue(n):
            if read(n)[4] & 1:
                raw[n % 2] = n

        issue(0)
        issue(1)
        if read(0)[4] & 1:
            assert raw[0] == 0
            split.add(0)
        yield
        n, live = 0, False
        v, f = np.zeros((128, 128)), np.zeros((128, 128), bool)
        while True:
            ta, tb, row, k0, fl = read(n)
            if fl & 4:                  # DONE
                return
            nxt = read(n + 1)[4] & 1
            if read(n + 2)[4] & 1:      # raw slot n % 2: what it holds
                assert raw[n % 2] is None or raw[n % 2] in split  # is split
            issue(n + 2)
            publish(iss, n + 3)         # the slot of stage n - 1
            if fl & 1:
                assert n in split       # split in the iteration before
                live = True
                events.setdefault(row, []).append((ta, tb, k0 // KS))
                ks = slice(k0, k0 + KS)
                a = dense[ta][:, ks].astype(np.float64)
                bb = dense[tb][ks, :].astype(np.float64)
                with np.errstate(invalid="ignore"):
                    v += a @ bb
                f |= ((a != 0).astype(np.int64)
                      @ (bb != 0).astype(np.int64)) > 0
            if nxt:
                assert raw[(n + 1) % 2] == n + 1
                split.add(n + 1)
            if fl & 2:                  # the tile's store-only stage
                events.setdefault(row, [])
                if prior is None or live:
                    assert owner[row] == -2, f"tile {row} written twice"
                    owner[row] = b
                if prior is None:
                    values[row], flags[row] = v, f
                elif live:
                    reads[row] += 1
                    with np.errstate(invalid="ignore"):
                        values[row] += v
                    flags[row] |= f.astype(np.uint8)
                v, f = np.zeros((128, 128)), np.zeros((128, 128), bool)
                live = False
            computed[0] = n
            n += 1
            yield

    _run_blocks(block, min(grid, getattr(w, "launched", w.n_tiles)), seed)
    return values, flags, owner, events, reads, counter[0]


def _run_blocks(block, n_blocks, seed):
    """Advance the blocks' generators in a seeded random order; ()."""
    rng = np.random.default_rng(seed)
    live = {b: block(b) for b in range(n_blocks)}
    while live:
        b = list(live)[rng.integers(len(live))]
        try:
            next(live[b])
        except StopIteration:
            del live[b]
    return ()


def _replayed_stream(g, stream):
    """(seg, c_cap, seg_ptr) of a replay case: the gapped stream with 5
    tiles past its count, or the engineered 1/70/0/3/2 stream (a tile of
    70 pairs, an empty one) in a c_cap of 9."""
    seg = g["t_out"][4]
    if stream == "1/70/0/3/2":
        per_tile = [1, 70, 0, 3, 2]
        n = sum(per_tile)
        seg = torch.cat([
            torch.repeat_interleave(torch.arange(5),
                                    torch.tensor(per_tile)).int(),
            torch.full((seg.numel() - n,), symbolic.INT32_MAX,
                       dtype=torch.int32)])
        c_cap = 9
    else:
        c_cap = g["c_cap"] + 5          # tiles past the stream's
    seg_ptr = mk.segment_offsets(seg, c_cap).numpy()
    assert seg_ptr.dtype == np.int32 and seg_ptr[0] == 0
    n_pairs = int((seg != symbolic.INT32_MAX).sum())
    assert seg_ptr[-1] == n_pairs < seg.numel()
    return seg, c_cap, seg_ptr


@pytest.mark.parametrize("grid,stream", [(3, "gapped"), (64, "gapped"),
                                         (2, "1/70/0/3/2")])
def test_pair_kernel_index_arithmetic_replayed_in_numpy(gapped_stream, grid,
                                                        stream):
    """What the pair-stream entry's fresh form at "highest" does with the
    tables its wrapper uploads (macro_tc_kernel over StreamTiles), replayed
    block by block in every interleaving of a seeded schedule: tiles are
    taken in stream order from one counter, every c_cap tile is written
    once, by the block that took it (a tile without pairs, among them every
    tile from the stream's count up to c_cap, and a tile none of whose
    slabs runs as +0.0 with flags 0), a tile's stages are exactly the slabs
    its tiles' masks call non-zero, in stream order, the stage ring and the
    raw ring are never read before they are filled, and the result is the
    plain version's."""
    g = gapped_stream
    tm, (_r, _c, a_idx, b_idx, _seg, _cnt) = g["tm"], g["t_out"]
    seg, c_cap, seg_ptr = _replayed_stream(g, stream)
    with_pairs, idle, skipped = _hold_tc_replay(
        tm.dense.numpy(), a_idx, b_idx, seg, c_cap, grid)
    assert len(with_pairs) < c_cap and skipped > 0
    assert (np.diff(seg_ptr) == 0)[-5:].all() if stream == "gapped" \
        else (np.diff(seg_ptr) == 0)[2]


def _prior_c(c_cap, dtype, seed):
    """A C that a ring stage adds into: normal values with -0.0, +-Inf and
    NaN in every tile (with pairs or not), flags 0 and 1."""
    g = torch.Generator().manual_seed(seed)
    num = torch.randn((c_cap, 128, 128), generator=g,
                      dtype=torch.float64).to(dtype)
    u = torch.rand(num.shape, generator=g, dtype=torch.float64)
    num[u < 0.1] = -0.0
    num[(u >= 0.1) & (u < 0.11)] = float("inf")
    num[(u >= 0.11) & (u < 0.12)] = float("-inf")
    num[(u >= 0.12) & (u < 0.13)] = float("nan")
    flag = (torch.rand(num.shape, generator=g) < 0.3).to(torch.uint8)
    return num, flag


def _bits(x):
    return x.view(torch.int64 if x.element_size() == 8 else torch.int32)


def _needed(masks, a_idx, b_idx, q):
    """The slabs of pair q that run (the .cu's slabs_needed)."""
    from test_torch_onepass import slabs_needed
    return slabs_needed(masks[a_idx[q]], masks[b_idx[q]])


def _hold_tc_replay(d, a_idx, b_idx, seg, c_cap, grid, prior=None):
    """macro_tc_kernel's replay on the stream ``seg`` (A = B = ``d``),
    fresh (StreamTiles over the stream's c_cap tiles) or, with ``prior``,
    accumulating into it (ListTiles over its walk list), held to the plain
    version (``out=prior`` for the latter): each block takes one ticket
    past the walk's count; every visited tile is stored once, by one block,
    its stages the slabs its tiles' masks call non-zero, in stream order.
    The fresh form visits every c_cap tile and stores a tile none of whose
    slabs runs (or without pairs) as +0.0 with flags 0, bit for bit the
    plain version's; the accumulate form visits the tiles with pairs alone
    and leaves a tile none of whose slabs runs bit for bit, as it leaves
    every tile without pairs.  Returns (the tiles with pairs, those none
    of whose slabs runs, the skipped slabs)."""
    from test_torch_onepass import ListTiles, StreamTiles
    c_cap_ = int(c_cap)
    seg_ptr = mk.segment_offsets(seg, c_cap_).numpy()
    pa, pb = a_idx.numpy(), b_idx.numpy()
    masks = mk.tile_masks_plain(torch.from_numpy(d)).numpy().view(np.uint32)
    if prior is None:
        w = StreamTiles(seg_ptr, pa, pb, c_cap_, masks)
    else:
        walk = mk.stream_walk(seg, c_cap_, min(c_cap_, seg.numel())).numpy()
        w = ListTiles(walk, pa, pb, c_cap_, masks)
    num, flag, owner, events, reads, tickets = _replay_tc_kernel(
        d, w, c_cap_, grid, seed=grid, prior=None if prior is None else
        (prior[0].numpy(), prior[1].numpy()))
    with_pairs = np.flatnonzero(np.diff(seg_ptr) > 0)
    visited = list(range(c_cap_)) if prior is None else with_pairs.tolist()
    assert sorted(events) == visited
    assert tickets == len(visited) + min(grid, c_cap_)
    idle, skipped = [], 0
    for c in with_pairs:
        lo, hi = seg_ptr[c], seg_ptr[c + 1]
        want = [(int(pa[q]), int(pb[q]), s_) for q in range(lo, hi)
                for s_ in range(4) if _needed(masks, pa, pb, q) >> s_ & 1]
        assert events[c] == want, c
        skipped += 4 * (hi - lo) - len(want)
        if not want:
            idle.append(int(c))
    if prior is None:
        assert (owner >= 0).all()
        assert np.bincount(owner).max() > 1     # a block's stream crosses
        want_n, want_f = mk.accumulate_macro_pairs(     # tiles
            torch.from_numpy(d), torch.from_numpy(d), a_idx, b_idx, seg,
            c_cap_, chunk=32)
        zero = np.ones(c_cap_, bool)
        zero[with_pairs] = False
        zero[idle] = True
        assert not num[zero].any() and not flag[zero].any()
        assert not np.signbit(num[zero]).any()          # +0.0
        np.testing.assert_array_equal(
            _bits(want_n[torch.from_numpy(zero)]).numpy(), 0)
    else:
        for c in with_pairs:
            assert (owner[c] == -2 and reads[c] == 0) if c in idle \
                else (owner[c] >= 0 and reads[c] == 1)
        untouched = owner == -2
        assert (reads[untouched] == 0).all()
        want_n, want_f = mk.accumulate_macro_pairs(
            torch.from_numpy(d), torch.from_numpy(d), a_idx, b_idx, seg,
            c_cap_, chunk=32, out=(prior[0].clone(), prior[1].clone()))
        np.testing.assert_array_equal(
            num[untouched].astype(np.float32).view(np.int32),
            _bits(prior[0][torch.from_numpy(untouched)]).numpy())
        np.testing.assert_array_equal(flag[untouched],
                                      prior[1].numpy()[untouched])
    np.testing.assert_allclose(num, want_n.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(flag, want_f.numpy())
    return with_pairs, idle, skipped


@pytest.mark.parametrize("grid,stream", [(3, "gapped"), (2, "1/70/0/3/2")])
def test_pair_kernel_accumulate_form_replayed_in_numpy(gapped_stream, grid,
                                                       stream):
    """The accumulate form (the ring's stages after the first) at
    "highest": macro_tc_kernel replayed block by block over the stream's
    walk list (no zero pass; the tiles past the stream's count never take
    a ticket), each tile with pairs read once and written once, by the
    block that took it, where a slab of it runs, its stages only the slabs
    its tiles' masks call non-zero; the result is the plain version's
    ``out=``: old + partial, flags ORed."""
    g = gapped_stream
    tm, (_r, _c, a_idx, b_idx, _seg, _cnt) = g["tm"], g["t_out"]
    seg, c_cap, _seg_ptr = _replayed_stream(g, stream)
    prior = _prior_c(c_cap, torch.float32, seed=grid)
    with_pairs, _idle, skipped = _hold_tc_replay(
        tm.dense.numpy(), a_idx, b_idx, seg, c_cap, grid, prior)
    assert len(with_pairs) < c_cap and skipped > 0


def _engineered_list_stream():
    """(dense, a_idx, b_idx, seg, c_cap): tiles whose non-zeros fill one
    block of rows and columns (so a pair's slabs run or not), C tile 5
    whose pairs' tiles share no k (none of its slabs runs), a pair of tile
    17 that runs no slab beside two that do, an Inf in tile 3 and a value
    of 2^63 in tile 4 (their slabs run whatever the other side holds,
    giving NaN where an Inf meets zeros), 36 pairs in C tile 40 (more than
    a lane window); c_cap far above the tiles."""
    rs = np.random.default_rng(21)
    d = np.zeros((8, 128, 128), np.float32)
    for t, (rows, cols) in {0: ((0, 32), (0, 32)), 1: ((96, 128), (64, 72)),
                            2: ((64, 96), (96, 128)),
                            7: ((0, 32), (64, 96))}.items():
        (r0, r1), (c0, c1) = rows, cols             # A: k = cols, B: rows
        d[t, r0:r1, c0:c1] = rs.standard_normal((r1 - r0, c1 - c0))
    d[3, 5, 40] = np.inf                                # a marked slab
    d[4, 7, 77] = 2.0 ** 63
    d[6] = rs.standard_normal((128, 128))
    d[6][rs.random((128, 128)) < 0.9] = 0.0
    per = {2: [(0, 0), (1, 2)], 5: [(2, 2), (7, 7)], 9: [(3, 0), (0, 3)],
           17: [(4, 6), (6, 6), (1, 1)],
           40: [(int(a), int(b)) for a, b in rs.integers(0, 8, (36, 2))],
           41: [(0, 0)]}
    pairs = [(c, a, b) for c in sorted(per) for a, b in per[c]]
    n = len(pairs)
    p_cap = -(-(n + 3) // 32) * 32
    seg = np.full(p_cap, symbolic.INT32_MAX, np.int64)
    a_idx = np.zeros(p_cap, np.int32)
    b_idx = np.zeros(p_cap, np.int32)
    for q, (c, a, b) in enumerate(pairs):
        seg[q], a_idx[q], b_idx[q] = c, a, b
    return (d, torch.from_numpy(a_idx), torch.from_numpy(b_idx),
            torch.from_numpy(seg.astype(np.int32)), 300)


@pytest.mark.parametrize("grid", [1, 4])
def test_list_kernel_walks_the_listed_tiles_and_runs_the_needed_slabs(grid):
    """macro_tc_kernel's accumulate replay on an engineered stage whose
    c_cap lies far above its tiles: only the listed tiles are visited, once
    each, in stream order; exactly the slabs the masks call zero are skipped, and
    the marked ones (an Inf, a value of 2^63) run, so an Inf meeting only
    zeros gives the plain version's NaN; the tile whose pairs run no slab
    is neither read nor written (its -0.0 stays), and so is every tile
    past the list."""
    d, a_idx, b_idx, seg, c_cap = _engineered_list_stream()
    prior = _prior_c(c_cap, torch.float32, seed=grid)
    prior[0][5] = -0.0
    with_pairs, idle, skipped = _hold_tc_replay(d, a_idx, b_idx, seg,
                                                c_cap, grid, prior)
    assert with_pairs.tolist() == [2, 5, 9, 17, 40, 41] and idle == [5]
    assert skipped > 0
    masks = mk.tile_masks_plain(torch.from_numpy(d)).numpy().view(np.uint32)
    need = [_needed(masks, a_idx.numpy(), b_idx.numpy(), q) for q in range(9)]
    assert need[:2] == [0b0001, 0b0100] and need[2:4] == [0, 0]  # tile 5
    assert need[4:6] == [0b0010, 0b0001]        # marked: (3, 0), (0, 3)
    assert need[8] == 0                         # tile 17's pair (1, 1)
    want_n, _f = mk.accumulate_macro_pairs(
        torch.from_numpy(d), torch.from_numpy(d), a_idx, b_idx, seg, c_cap,
        chunk=32, out=(prior[0].clone(), prior[1].clone()))
    assert bool(torch.isnan(want_n[9]).any())           # Inf times zeros


@pytest.mark.parametrize("grid", [1, 4])
def test_fresh_form_stores_the_tile_none_of_whose_slabs_runs_as_zero(grid):
    """macro_tc_kernel's fresh replay (StreamTiles) on the engineered stream
    whose c_cap lies far above its tiles: every c_cap tile is stored once;
    C tile 5, whose pairs' tiles share no k, runs no slab and is stored as
    +0.0 with flags 0, as is every tile without pairs; the marked slabs (an
    Inf, a value of 2^63) run whatever the other side holds, so the Inf
    tile gives the plain version's NaN where the Inf meets only zeros."""
    d, a_idx, b_idx, seg, c_cap = _engineered_list_stream()
    with_pairs, idle, skipped = _hold_tc_replay(d, a_idx, b_idx, seg, c_cap,
                                                grid)
    assert with_pairs.tolist() == [2, 5, 9, 17, 40, 41] and idle == [5]
    assert skipped > 0
    want_n, _f = mk.accumulate_macro_pairs(
        torch.from_numpy(d), torch.from_numpy(d), a_idx, b_idx, seg, c_cap,
        chunk=32)
    assert bool(torch.isnan(want_n[9]).any())           # Inf times zeros
    assert _bits(want_n[5]).eq(0).all()                 # +0.0 in the plain


@pytest.fixture(scope="module")
def class_plans():
    """{"ragged": (A, run plan), "uniform": (A, stencil plan)}: the classes
    of a small wandering matrix's run plan (per-tile pair counts ragged)
    and of a small banded one's stencil plan (uniform), A @ A."""
    out = {}
    for kind, coo, planner in (
            ("ragged", t_synthetic.wandering_device(n=4096, seed=4,
                                                    device="cpu"),
             st.plan_runs),
            ("uniform", t_synthetic.banded_device(
                n=4096, seed=1, bands=tuple(range(-32, 32)), device="cpu"),
             st.plan_stencil)):
        a = coo_to_macro(coo, device="cpu")
        offsets = symbolic.pair_counts(a.tile_col, a.tile_rowptr, a.ntiles)
        n_pairs = int(offsets[-1])
        p_cap = max(256, -(-n_pairs // 256) * 256)
        c_row, c_col, a_idx, b_idx, seg, n_tiles = symbolic.expand_pairs(
            offsets, a.tile_row, a.tile_col, a.tile_rowptr, a.tile_col,
            n_pairs, p_cap, True)
        out[kind] = (a, planner(seg, a_idx, b_idx, c_row, c_col, n_pairs,
                                int(n_tiles), a.dense.shape[0],
                                a.dense.shape[0]))
    return out


@pytest.mark.parametrize("kind", ["ragged", "uniform"])
def test_class_launch_at_highest_replayed_against_the_plain_class_call(
        class_plans, kind):
    """K5 (ragged) and K6 (uniform) at "highest": macro_tc_kernel over each
    class's ClassTiles (ticket tk = step tk / t, tile tk % t, at the
    step's bases), replayed block by block with 3 blocks: every row of the
    class is stored once, its stages exactly the slabs its pairs' masks
    call non-zero, pair by pair, a row none of whose slabs runs as +0.0
    with flags 0, and values and flags are the plain class call's
    (class_call_plain)."""
    from test_torch_onepass import ClassTiles, slabs_needed
    a, plan = class_plans[kind]
    assert plan.classes and all(isinstance(c[1], int) == (kind == "uniform")
                                for c in plan.classes)
    dense = a.dense.numpy()
    masks = mk.tile_masks_plain(a.dense).numpy().view(np.uint32)
    skipped = 0
    for i, (cls, bases) in enumerate(zip(plan.classes, plan.class_bases)):
        t, p, _ar, _br, a_offs, b_offs, _base = cls
        rows = bases.numel() // 2 * t
        p_list = st.p_list_of(t, p)
        w = ClassTiles(bases.numpy(), p_list, np.asarray(a_offs),
                       np.asarray(b_offs), t, 0, rows, masks)
        num, flag, owner, events, _reads, tickets = _replay_tc_kernel(
            dense, w, rows, 3, seed=i)
        assert (owner >= 0).all() and tickets == rows + min(3, rows)
        p_ptr = np.concatenate([[0], np.cumsum(p_list)])
        b2 = bases.numpy().reshape(-1, 2)
        for row in range(rows):
            step, tt = divmod(row, t)
            tiles = [(int(b2[step, 0] + a_offs[q]), int(b2[step, 1]
                                                       + b_offs[q]))
                     for q in range(p_ptr[tt], p_ptr[tt + 1])]
            want = [(ta, tb, s_) for ta, tb in tiles for s_ in range(4)
                    if slabs_needed(masks[ta], masks[tb]) >> s_ & 1]
            assert events[row] == want, (i, row)
            skipped += 4 * len(tiles) - len(want)
            if not want:
                assert not num[row].any() and not flag[row].any()
                assert not np.signbit(num[row]).any()
        want_n = torch.full((rows, 128, 128), float("nan"))
        want_f = torch.full((rows, 128, 128), 7, dtype=torch.uint8)
        st.class_call_plain(want_n, want_f, a.dense, a.dense, bases, t, p,
                            a_offs, b_offs, 0)
        np.testing.assert_array_equal(flag, want_f.numpy())
        np.testing.assert_allclose(num, want_n.double().numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert skipped > 0


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "highest"), (torch.float32, "high"),
    (torch.float32, "default"), (torch.float64, "highest")],
    ids=["f32-highest", "f32-high", "f32-default", "f64"])
def test_accumulate_form_adds_the_stream_into_c(gapped_stream, dtype,
                                                precision):
    """The pair-stream wrapper's accumulate form (``out=``) on CPU tiles:
    the plain version adds the stream into C in place, equal under == to
    the fresh form plus a torch add and OR, NaN where it gives NaN, flags
    bit for bit; the
    tiles without pairs, and those past the stream's count up to c_cap,
    come back bit for bit (their -0.0, Inf and NaN)."""
    g = gapped_stream
    tm, (_r, _c, a_idx, b_idx, seg, _cnt) = g["tm"], g["t_out"]
    c_cap = g["c_cap"] + 5
    d = tm.dense.to(dtype)
    mk.reset_launch_counts()
    part, part_f = mk.accumulate_macro_pairs(d, d, a_idx, b_idx, seg, c_cap,
                                             chunk=32, precision=precision)
    num, flag = _prior_c(c_cap, dtype, seed=7)
    old_n, old_f = num.clone(), flag.clone()
    got = mk.accumulate_macro_pairs(d, d, a_idx, b_idx, seg, c_cap, chunk=32,
                                    precision=precision, out=(num, flag))
    assert got[0] is num and got[1] is flag and num.dtype == dtype
    assert sum(mk.LAUNCHES.values()) == 0      # CPU tiles: the plain version
    live = torch.zeros(c_cap, dtype=torch.bool)
    live[seg[seg < c_cap].long()] = True
    assert live.any() and not live[g["n_c"]:].any() and not live.all()
    want_n, want_f = old_n + part, old_f | part_f
    same = (num == want_n) | (torch.isnan(num) & torch.isnan(want_n))
    assert bool(same[live].all())
    assert bool(torch.isnan(num[live]).any())          # the prior NaNs
    assert torch.equal(flag[live], want_f[live])
    assert torch.equal(_bits(num[~live]), _bits(old_n[~live]))
    assert torch.equal(flag[~live], old_f[~live])
    assert bool((torch.signbit(num[~live]) & (num[~live] == 0)).any())


@pytest.mark.parametrize("what", ["not a pair", "tiles", "shape", "dtype",
                                  "flag dtype", "device", "contiguity",
                                  "alignment"])
def test_accumulate_form_refuses_a_wrong_out(gapped_stream, what):
    g = gapped_stream
    tm, (_r, _c, a_idx, b_idx, seg, _cnt) = g["tm"], g["t_out"]
    c_cap = g["c_cap"]
    num = torch.zeros((c_cap, 128, 128))
    flag = torch.zeros((c_cap, 128, 128), dtype=torch.uint8)
    out, err = {
        "not a pair": ((num,), TypeError),
        "tiles": ((num[:-1], flag[:-1]), ValueError),
        "shape": ((num, flag[:, :64]), ValueError),
        "dtype": ((num.double(), flag), TypeError),
        "flag dtype": ((num, flag.int()), TypeError),
        "device": ((num.to("meta"), flag), ValueError),
        "contiguity": ((num.transpose(1, 2), flag), ValueError),
        # contiguous, 4 bytes past a 16-byte boundary
        "alignment": ((torch.zeros(num.numel() + 1)[1:].view(num.shape),
                       flag), ValueError),
    }[what]
    with pytest.raises(err):
        mk.accumulate_macro_pairs(tm.dense, tm.dense, a_idx, b_idx, seg,
                                  c_cap, chunk=32, out=out)
    assert not num.any() and not flag.any()


def test_reads_masks_names_the_launches_that_read_tile_masks(monkeypatch):
    """mk.reads_masks: every launch on a CUDA table reads tile masks (the
    float64 entry, and the float32 entries at every precision, fresh or
    accumulating, the class entries too: each runs only the slabs the
    masks call non-zero); no CPU table does.  The ring asks the same
    predicate of its B table, so every ring on the card carries masks, a
    ring of one rank too, and no ring on the CPU does."""
    import types
    from pem_spgemm_tpu_torch.parallel import sharded_macro as sm
    f32, f64 = (types.SimpleNamespace(is_cuda=True, dtype=d)
                for d in (torch.float32, torch.float64))
    assert mk.reads_masks(f32) and mk.reads_masks(f64)
    assert not mk.reads_masks(torch.zeros((1, 128, 128)))
    carried = []
    monkeypatch.setattr(sm, "plan_masks", lambda plan: (None, "masks"))
    monkeypatch.setattr(sm, "ring_chunks",
                        lambda b, n, mesh, masks: carried.append(masks))
    monkeypatch.setattr(sm, "local_macro", lambda *a: None)
    for n in (1, 4):
        for table, want in ((f32, "masks"), (torch.zeros((1, 128, 128)),
                                             None)):
            carried.clear()
            sm.sharded_macro_numeric(
                types.SimpleNamespace(b_dense=table, n_devices=n),
                mesh=object())
            assert carried == [want], (n, table)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slab_share_counts_the_slabs_a_direct_count_finds(dtype):
    # bench/k4_split.needed_slabs / slab_share (the slab counts of the
    # kernel rows' bounds) against a direct count over the tiles: a slab
    # runs where some k of it has a non-zero in A's column and in B's row,
    # or where A's columns or B's rows of it hold a marked value; and a
    # densified table runs every slab
    from pem_spgemm_tpu_torch.bench import k4_split
    f64 = dtype == torch.float64
    width = 16 if f64 else 32
    rng = np.random.default_rng(41)
    t = 8
    keep = rng.random((t, 1, 128)) < rng.choice([0.0, 0.05, 0.3, 1.0],
                                                 (t, 1, 1))
    x = rng.standard_normal((t, 128, 128)) \
        * (rng.random((t, 128, 128)) < 0.02) * keep
    x[1, 5, 70] = np.inf
    x[2, 100, 3] = np.nan
    x[3, 40, 127] = -0.0
    x[4, 9, 33] = 2.0 ** 64
    a = torch.from_numpy(x).to(dtype)
    b = torch.from_numpy(np.ascontiguousarray(x[::-1].transpose(0, 2, 1))) \
        .to(dtype)
    pa = torch.from_numpy(rng.integers(0, t, 200).astype(np.int32))
    pb = torch.from_numpy(rng.integers(0, t, 200).astype(np.int32))
    xa, xb = a.double().numpy(), b.double().numpy()

    def marked(v):
        bad = ~np.isfinite(v)
        return bad if f64 else bad | (np.abs(v) >= 2.0 ** 63)

    want = np.zeros(200, dtype=np.int64)
    for p, (i, j) in enumerate(zip(pa.tolist(), pb.tolist())):
        for s_ in range(128 // width):
            ks = slice(s_ * width, (s_ + 1) * width)
            both = (xa[i][:, ks] != 0).any(0) & (xb[j][ks, :] != 0).any(1)
            if both.any() or marked(xa[i][:, ks]).any() \
                    or marked(xb[j][ks, :]).any():
                want[p] |= 1 << s_
    got = k4_split.needed_slabs(a, b, pa, pb)
    assert got.tolist() == want.tolist()
    run, slabs = k4_split.slab_share(a, b, pa, pb)
    assert slabs == 200 * (128 // width)
    assert run == sum(bin(w).count("1") for w in want.tolist())
    assert 0 < run < slabs
    dense = k4_split.densify(a.clone())
    assert bool((dense != 0).all()) and bool(dense.abs().max() < 1.5)
    assert k4_split.slab_share(dense, dense, pa, pb) == (slabs, slabs)


def test_k4_split_cuts_cut_one_place_each():
    # bench/k4_split.py times the tile product with one piece of a stage cut
    # out (of the "highest" stage and of the one-pass pipeline), with every
    # slab of a pair published and the accumulate form's other stores, each
    # a text substitution
    from pem_spgemm_tpu_torch.bench import k4_split
    with open(mk.SOURCE) as f:
        text = f.read()
    for name, cuts in [*k4_split.CUTS.items(), *k4_split.WS_CUTS.items(),
                       *k4_split.ACC_CUTS.items(),
                       ("no slab skip", k4_split.NO_SLAB_SKIP)]:
        for old, new in cuts:
            assert text.count(old) == 1 and new != old, name


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


def test_interactive_macro_goes_through_the_pair_stream_entry(monkeypatch):
    """SpGEMM(engine="macro")'s accumulation is
    macro_kernels.accumulate_macro_pairs, the wrapper that launches the
    pair-stream kernel for CUDA tiles and takes the plain version for CPU
    tiles (so no launch is counted here): called once, with the stream's
    c_cap and the config's chunk, and the result is the JAX package's.  It
    is handed the operands' kept masks (ops.macro_kernels.operand_masks):
    none on CPU tiles, where no plain version reads them."""
    calls = []
    real = mk.accumulate_macro_pairs

    def counted(*args, **kw):
        calls.append((args[5], kw))
        return real(*args, **kw)

    monkeypatch.setattr(mk, "accumulate_macro_pairs", counted)
    mk.reset_launch_counts()
    _ta, res = _check_macro(MATRICES["gapped"](),
                            SpGEMMConfig(engine="macro", macro_chunk=32))
    assert len(calls) == 1
    c_cap, kw = calls[0]
    assert c_cap == max(256, -(-res.c_ntiles // 256) * 256)
    assert kw == {"chunk": 32, "acc_dtype": torch.float32,
                  "precision": "highest", "tile_masks": None}
    assert sum(mk.LAUNCHES.values()) == 0


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


# --------------------------------------------------------------------------
# the masks a Macro128 operand keeps (MacroMatrix.tile_masks)

def _own_macro(kind, dtype=torch.float32):
    """A fresh port MacroMatrix of MATRICES[kind] (its values changed in
    place by the tests below, so not the shared fixture's)."""
    _, tc = both_coo(MATRICES[kind]())
    return coo_to_macro(tc, dtype=dtype, device="cpu")


def test_operand_masks_are_made_once_and_kept():
    """A second call returns the same TableMasks, ready, its words
    tile_masks_plain's of the table; A's and B's are one object where B is
    A (TileMasks as operand_masks builds it)."""
    m = _own_macro("gapped")
    first = m.tile_masks()
    assert first.ready and first.table is m.acc_dense()
    assert torch.equal(first.words, mk.tile_masks_plain(m.dense))
    ptr = first.words.data_ptr()
    again = m.tile_masks()
    assert again is first and again.words.data_ptr() == ptr
    both = mk.TileMasks(m.dense, m.dense, a=m.tile_masks(),
                        b=m.tile_masks())
    assert both.a is both.b is first
    assert both.args(m.dense, m.dense)[4:] == (1, 1)
    # on CPU tables no plain version reads masks: operand_masks makes none
    assert mk.operand_masks(m, m) is None


@pytest.mark.parametrize("change", ["zero_slab", "nan", "new_column"])
def test_operand_masks_are_remade_after_an_in_place_change(change):
    """An in-place change of the values moves the table's version counter:
    the next call makes the masks again, into the same words (same
    address), equal to tile_masks_plain of the new values."""
    m = _own_macro("gapped")
    masks = m.tile_masks()
    ptr, old = masks.words.data_ptr(), masks.words.clone()
    t = int(torch.nonzero(m.dense.flatten(1).any(1))[0])
    if change == "zero_slab":
        m.dense[t, :, :32] = 0.0
    elif change == "nan":
        m.dense[t, 5, 77] = float("nan")
    else:                               # a k with no non-zero before
        t, k = (int(x) for x in torch.nonzero(
            ~m.dense[:-1].any(1) & m.dense[:-1].flatten(1).any(1)[:, None])[0])
        m.dense[t, :, k] = 1.5
    again = m.tile_masks()
    assert again is masks and again.ready
    assert again.words.data_ptr() == ptr
    assert torch.equal(again.words, mk.tile_masks_plain(m.dense))
    assert not torch.equal(again.words, old)
    assert m.tile_masks() is masks and torch.equal(masks.words,
                                                   again.words)


def test_bfloat16_operands_keep_their_float32_copys_masks():
    """A bfloat16 operand's masks are those of its float32 copy (the table
    the kernels read), in the float32 layout; an in-place change of the
    bfloat16 values refreshes the copy, then the masks, at the same
    addresses."""
    m = _own_macro("gapped", torch.bfloat16)
    masks = m.tile_masks()
    wide = m.acc_dense()
    assert wide.dtype == torch.float32 and masks.table is wide
    assert masks.words.shape == (wide.shape[0], mk.TM_WORDS)
    assert torch.equal(masks.words, mk.tile_masks_plain(wide))
    ptr = masks.words.data_ptr()
    t = int(torch.nonzero(m.dense.flatten(1).any(1))[0])
    m.dense[t] = 0
    again = m.tile_masks()
    assert again is masks and m.acc_dense() is wide
    assert again.words.data_ptr() == ptr
    assert torch.equal(again.words, mk.tile_masks_plain(wide))
    assert not bool(again.words[t].any())


@pytest.mark.parametrize("plan_kind", ["macro", "stencil"])
def test_steady_plans_read_the_kept_masks_and_see_changes(monkeypatch,
                                                          plan_kind):
    """MacroPlan.run and StencilMacroPlan.run on CPU operands, with the
    masks path taken as on the card (reads_masks forced): each equals the
    interactive result, the operands' masks are made once and kept over
    runs, and after an in-place change of A the next run equals the new
    interactive result with the masks made again."""
    from pem_spgemm_tpu_torch.ops.fixed import _try_stencil_plan
    monkeypatch.setattr(mk, "reads_masks", lambda table: True)
    kind = "gapped" if plan_kind == "macro" else "wandering"
    m = _own_macro(kind)
    cfg = SpGEMMConfig(engine="macro", macro_chunk=32)
    made = []
    real = mk.TableMasks.make

    def counted(self):
        made.append(self)
        return real(self)

    monkeypatch.setattr(mk.TableMasks, "make", counted)

    def steady_equals_interactive(plan):
        res = SpGEMM(cfg)(m, m)
        out = plan.run(m, m)
        assert int(out[5]) == res.c_nnz and not bool(out[6])
        want = res.to_coo()
        (res.c_tile_row, res.c_tile_col, res.vals, res.c_counts,
         res.cptr) = out[:5]
        got = res.to_coo()
        np.testing.assert_array_equal(got.rows, want.rows)
        np.testing.assert_array_equal(got.cols, want.cols)
        np.testing.assert_allclose(got.vals, want.vals, rtol=1e-5,
                                   atol=1e-5)

    res = SpGEMM(cfg)(m, m)
    plan = make_plan(res, cfg, m, m) if plan_kind == "macro" \
        else _try_stencil_plan(cfg, m, m)
    assert type(plan).__name__ == ("MacroPlan" if plan_kind == "macro"
                                   else "StencilMacroPlan")
    assert len(made) == 1                   # the interactive step's
    masks = m.tile_masks()
    steady_equals_interactive(plan)
    steady_equals_interactive(plan)
    assert made == [masks]                  # kept over three multiplies
    t = int(torch.nonzero(m.dense.flatten(1).any(1))[-1])
    m.dense[t] *= -2.0
    m.dense[t, 3, 3] = 0.25
    steady_equals_interactive(plan)
    assert made == [masks, masks]           # made again, once
    assert torch.equal(masks.words, mk.tile_masks_plain(m.dense))


def test_macro_refuses_lower_precision():
    # "high" and "default" run (tests/test_torch_precision.py); a mode that
    # is none of the three is refused by the config and by the kernel
    # wrapper
    _, ta = both_tiled(MATRICES["banded"]())
    with pytest.raises(ValueError, match="precision"):
        SpGEMM(SpGEMMConfig(engine="macro", precision="bf16"))(ta, ta)
    tm = ta.macro()
    z = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="precision"):
        mk.accumulate_macro_pairs(tm.dense, tm.dense, z, z, z, 1,
                                  precision="tf32")


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
