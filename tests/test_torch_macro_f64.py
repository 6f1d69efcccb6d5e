"""The float64 pair-stream kernel (csrc/macro_accumulate.cu,
``macro_accumulate_pairs_f64``) mirrored in numpy.

The kernel runs its 128x128x128 tile products on the FP64 tensor cores
(mma.sync m16n8k{4,8} on f64 operands), which do not exist here.  What the
kernel decides itself is mirrored: which C element each lane's accumulator
holds (a map that must cover the tile once over the eight warps), which
A and B words each lane loads as its fragments of a k-step, the order of
the k-slabs through the ring, and the flags each lane ORs from the slabs'
k-masks, which k-slabs of a pair it never copies (from every tile's
k-masks, computed first) and which 16 x 8 DMMA blocks of a slab it skips:
those whose products are all exact zeros, unless an Inf or a NaN is among
their operands.  The replay below walks a pair stream slab by slab and fragment
by fragment, forms each DMMA product from the 32 lanes' fragments (as the
PTX layout places them) and holds the result against the plain version
(``ops.macro.accumulate_macro``): values within 1e-12 * sum|a*b|, flags
exactly, and the plain version's NaN positions and Inf signs on tiles with
Inf, -Inf, NaN, subnormal and empty slabs; in the accumulate form over the
grid the walk list gives (one block a tile with pairs, min(c_cap, p_cap)
blocks, those past the list's count returning at once).  The constants are
read from the source.
"""

import re

import numpy as np
import pytest
import torch

from pem_spgemm_tpu_torch.ops import macro as M
from pem_spgemm_tpu_torch.ops import macro_kernels as mk
from pem_spgemm_tpu_torch.ops import symbolic

TILE = 128


def _source_constants():
    with open(mk.SOURCE) as f:
        src = f.read()
    out = {}
    for name in ("F64_KS", "F64_STAGES", "F64_MMA_K", "F64_THREADS",
                 "F64_NEED_CAP", "F64_MASK_WORDS"):
        out[name] = int(re.search(r"constexpr int %s = (\d+);" % name,
                                  src).group(1))
    for name, base in (("F64_AS", "F64_KS"), ("F64_BS", "TILE")):
        pad = re.search(r"constexpr int %s = %s \+ (\d+);" % (name, base),
                        src).group(1)
        out[name] = (out["F64_KS"] if base == "F64_KS" else TILE) + int(pad)
    return out


C = _source_constants()
KS, MK, WARPS = C["F64_KS"], C["F64_MMA_K"], C["F64_THREADS"] // 32


def lane_elements(w, l):
    """{(mi, ni, q): (row, col)}: the C elements of warp w, lane l (the
    .cu's F64Frag: acc[mi][ni][q] at row r0 + 16 mi + 8 (q / 2), column
    c0 + 8 ni + q % 2; r0 = 32 (w % 4) + l / 4, c0 = 64 (w / 4) + 2 (l % 4))."""
    g, t = l >> 2, l & 3
    r0, c0 = 32 * (w & 3) + g, 64 * (w >> 2) + 2 * t
    return {(mi, ni, q): (r0 + 16 * mi + 8 * (q // 2), c0 + 8 * ni + q % 2)
            for mi in range(2) for ni in range(8) for q in range(4)}


def a_fragment(w, l, mi, i, kk):
    """(row, k) of the slab's A word that lane l of warp w loads as a[mi][i]
    at k-step kk."""
    g, t = l >> 2, l & 3
    return 32 * (w & 3) + g + 16 * mi + 8 * (i % 2), kk + t + 4 * (i // 2)


def b_fragment(w, l, ni, i, kk):
    """(k, col) of the slab's B word that lane l loads as b[ni][i]."""
    g, t = l >> 2, l & 3
    return kk + t + 4 * i, 64 * (w >> 2) + 8 * ni + g


L = np.arange(32)
G, T = L >> 2, L & 3
IA, IB = np.arange(MK // 2), np.arange(MK // 4)
# the PTX layout of one m16n8kMK f64 tile, lane by lane
A_ROW, A_K = G[:, None] + 8 * (IA % 2), T[:, None] + 4 * (IA // 2)
B_K, B_COL = T[:, None] + 4 * IB, np.broadcast_to(G[:, None], (32, MK // 4))
Q = np.arange(4)
D_ROW, D_COL = G[:, None] + 8 * (Q // 2), 2 * T[:, None] + Q % 2


def dmma_tile(a_regs, b_regs, d_regs):
    """One mma.sync m16n8kMK on f64: the 32 lanes' fragments placed as the
    PTX layout places them (a[i] at A[g + 8 (i % 2)][t + 4 (i / 2)], b[i]
    at B[t + 4 i][g], d[q] at D[g + 8 (q / 2)][2 t + q % 2]), D += A @ B,
    handed back in the lanes' d registers.  a_regs (32, MK/2), b_regs
    (32, MK/4), d_regs (32, 4)."""
    A = np.full((16, MK), np.nan)
    B = np.full((MK, 8), np.nan)
    D = np.full((16, 8), np.nan)
    A[A_ROW, A_K] = a_regs
    B[B_K, B_COL] = b_regs
    D[D_ROW, D_COL] = d_regs
    assert not (np.isnan(A).any() and not np.isnan(a_regs).any())
    with np.errstate(invalid="ignore", over="ignore"):
        D = D + A @ B
    return D[D_ROW, D_COL]


BAD = 1 << KS                   # the .cu's F64_BAD
KBITS = (1 << KS) - 1


def slab_masks(st_a, st_b):
    """(am, bm, ag, bg): the .cu's f64_masks: k bits of each A row and B
    column (x != 0), BAD where it holds an Inf or a NaN, ORed over the
    16-row and 8-column groups."""
    a, b = st_a[:, :KS], st_b[:, :TILE].T
    with np.errstate(invalid="ignore"):
        am = ((a != 0) * (1 << np.arange(KS))).sum(1) | \
            np.where((~np.isfinite(a)).any(1), BAD, 0)
        bm = ((b != 0) * (1 << np.arange(KS))).sum(1) | \
            np.where((~np.isfinite(b)).any(1), BAD, 0)
    ag = np.bitwise_or.reduce(am.reshape(8, 16), axis=1)
    bg = np.bitwise_or.reduce(bm.reshape(16, 8), axis=1)
    return am, bm, ag, bg


def tile_masks(x):
    """The .cu's f64_tile_masks of one tile: 128 bits of non-zero columns
    (4 words, A's k), 8 bits of slabs whose columns hold an Inf or a NaN,
    then the same of the rows (B's k)."""
    words = []
    for nz, bad in (((x != 0).any(0), (~np.isfinite(x)).any(0)),
                    ((x != 0).any(1), (~np.isfinite(x)).any(1))):
        bits = nz.reshape(4, 32) * (1 << np.arange(32, dtype=np.int64))
        words += [int(w) for w in bits.sum(1)]
        words.append(int((bad.reshape(8, 16).any(1)
                          * (1 << np.arange(8))).sum()))
    return words


def test_tile_masks_plain_is_the_kernels_rule():
    """ops.macro_kernels.tile_masks_plain on float64 tiles (the plain
    version of macro_tile_masks_f64) equals the replay of f64_tile_masks
    word for word on tiles with NaN, +-Inf, finite values above 2^63 (not
    marked in float64), -0.0 and subnormals."""
    x = _tiles(8, 4)
    x[0, 3, 99] = np.nan
    x[0, 70, 5] = np.inf
    x[1, 40, 33] = -np.inf
    x[1, 100, 64] = 2.0 ** 70
    x[2, :, 10:20] = -0.0
    x[2, 17, 90] = 5e-324
    with np.errstate(invalid="ignore"):
        want = np.array([tile_masks(t) for t in x], np.int64) \
            .astype(np.uint32).view(np.int32)
    got = mk.tile_masks_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0, 4] == (1 << 6 | 1 << 0) and want[0, 9] == (1 << 0 | 1 << 4)
    assert want[1, 4] == 1 << 2 and want[1, 9] == 1 << 2
    assert want[2, 0] & (0x3FF << 10) == 0 and not want[4].any()


def pair_need(ma, mb):
    """The .cu's f64_pair_need: bit s where slab s of the pair runs."""
    n = (ma[4] | mb[9]) & 0xff
    for h in range(4):
        k = ma[h] & mb[5 + h]
        n |= (1 if k & 0xffff else 0) << (2 * h)
        n |= (1 if k >> 16 else 0) << (2 * h + 1)
    return n


def replay_tile(a_dense, b_dense, pairs, skipped=None):
    """The kernel's block for one C tile: its pairs' k-slabs in stream order
    (ring stage s % F64_STAGES), each staged into padded rows, its masks,
    each warp's k-steps fragment by fragment over the DMMA blocks it does
    not skip, and each lane's flags ORed from the masks of the blocks with
    a non-zero product.  Returns (values, flags) (128, 128); ``skipped``
    (a list) gets the count of skipped and of all DMMA blocks, those of the
    slabs never copied included."""
    acc = np.zeros((WARPS, 32, 2, 8, 4))
    n_skip = n_all = 0
    flags = np.zeros((WARPS, 32, 2), np.int64)
    slabs = []
    for ai, bi in pairs:
        with np.errstate(invalid="ignore"):
            need = pair_need(tile_masks(a_dense[ai]), tile_masks(b_dense[bi]))
        slabs += [(ai, bi, KS * j) for j in range(TILE // KS)
                  if need >> j & 1]
        n_skip += 16 * WARPS * (TILE // KS - bin(need).count("1"))
        n_all += 16 * WARPS * (TILE // KS - bin(need).count("1"))
    ring = [None] * C["F64_STAGES"]
    # each lane's fragment addresses and C elements, warp by warp
    frag_a = {(w, kk): np.array([[[a_fragment(w, l, mi, i, kk)
                                   for i in range(MK // 2)]
                                  for mi in range(2)] for l in range(32)])
              for w in range(WARPS) for kk in range(0, KS, MK)}
    frag_b = {(w, kk): np.array([[[b_fragment(w, l, ni, i, kk)
                                   for i in range(MK // 4)]
                                  for ni in range(8)] for l in range(32)])
              for w in range(WARPS) for kk in range(0, KS, MK)}
    els = {w: [lane_elements(w, l) for l in range(32)] for w in range(WARPS)}
    for s, (ai, bi, k0) in enumerate(slabs):
        st_a = np.full((TILE, C["F64_AS"]), np.nan)     # padding: never read
        st_b = np.full((KS, C["F64_BS"]), np.nan)
        st_a[:, :KS] = a_dense[ai][:, k0:k0 + KS]
        st_b[:, :TILE] = b_dense[bi][k0:k0 + KS, :]
        ring[s % C["F64_STAGES"]] = (st_a, st_b)
        st_a, st_b = ring[s % C["F64_STAGES"]]
        am, bm, ag, bg = slab_masks(st_a, st_b)
        for w in range(WARPS):
            # the warp's blocks: needed (run) and live (a non-zero product)
            need, live = np.zeros((2, 8), bool), np.zeros((2, 8), bool)
            for mi in range(2):
                for ni in range(8):
                    gr, gc = ag[2 * (w & 3) + mi], bg[8 * (w >> 2) + ni]
                    live[mi, ni] = (gr & gc & KBITS) != 0
                    need[mi, ni] = live[mi, ni] or ((gr | gc) & BAD) != 0
            n_skip += int((~need).sum())
            n_all += need.size
            for kk in range(0, KS, MK):
                fa, fb = frag_a[w, kk], frag_b[w, kk]
                a = st_a[fa[..., 0], fa[..., 1]]        # (32, 2, MK/2)
                b = st_b[fb[..., 0], fb[..., 1]]        # (32, 8, MK/4)
                for mi in range(2):
                    for ni in range(8):
                        if need[mi, ni]:
                            acc[w, :, mi, ni] = dmma_tile(
                                a[:, mi], b[:, ni], acc[w, :, mi, ni])
            for l in range(32):
                for (mi, ni, q), (r, c) in els[w][l].items():
                    if live[mi, ni] and am[r] & bm[c] & KBITS:
                        flags[w, l, mi] |= 1 << (4 * ni + q)
    vals = np.full((TILE, TILE), np.nan)
    fl = np.full((TILE, TILE), 7, np.uint8)
    for w in range(WARPS):
        for l in range(32):
            for (mi, ni, q), (r, c) in els[w][l].items():
                vals[r, c] = acc[w, l, mi, ni, q]
                fl[r, c] = (int(flags[w, l, mi]) >> (4 * ni + q)) & 1
    if skipped is not None:
        skipped += [n_skip, n_all]
    return vals, fl


def test_lane_map_is_a_bijection_onto_the_tile():
    seen = np.zeros((TILE, TILE), np.int64)
    for w in range(WARPS):
        for l in range(32):
            els = lane_elements(w, l)
            assert len(els) == 64 == 2 * 8 * 4
            for r, c in els.values():
                seen[r, c] += 1
    assert WARPS == 8 and (seen == 1).all()
    # a lane's two columns of one DMMA tile are neighbours: one 16-byte
    # store of values, one 2-byte store of flags
    els = lane_elements(5, 13)
    for mi in range(2):
        for ni in range(8):
            for h in range(2):
                (r0, c0), (r1, c1) = els[mi, ni, 2 * h], els[mi, ni, 2 * h + 1]
                assert r0 == r1 and c1 == c0 + 1 and c0 % 2 == 0


def test_fragments_cover_each_k_step_once_and_meet_no_bank_twice():
    # over a warp's k-step, every A word of its 32 rows and every B word of
    # its 64 columns is loaded, by as many lanes as the DMMA tiles need it
    for w in (0, 3, 4, 7):
        for kk in range(0, KS, MK):
            a_seen = {}
            for l in range(32):
                for mi in range(2):
                    for i in range(MK // 2):
                        rk = a_fragment(w, l, mi, i, kk)
                        a_seen[rk] = a_seen.get(rk, 0) + 1
            rows = range(32 * (w & 3), 32 * (w & 3) + 32)
            assert set(a_seen) == {(r, k) for r in rows
                                   for k in range(kk, kk + MK)}
            b_seen = {}
            for l in range(32):
                for ni in range(8):
                    for i in range(MK // 4):
                        kc = b_fragment(w, l, ni, i, kk)
                        b_seen[kc] = b_seen.get(kc, 0) + 1
            cols = range(64 * (w >> 2), 64 * (w >> 2) + 64)
            assert set(b_seen) == {(k, c) for k in range(kk, kk + MK)
                                   for c in cols}
    # 8-byte loads: a half warp's 16 words must fall in 16 distinct 8-byte
    # bank pairs (word index mod 16) for one fragment register
    for w in range(WARPS):
        for half in (range(16), range(16, 32)):
            for mi in range(2):
                for i in range(MK // 2):
                    words = {(r * C["F64_AS"] + k) % 16 for r, k in
                             (a_fragment(w, l, mi, i, 0) for l in half)}
                    assert len(words) == 16
            for ni in range(8):
                for i in range(MK // 4):
                    words = {(k * C["F64_BS"] + c) % 16 for k, c in
                             (b_fragment(w, l, ni, i, 0) for l in half)}
                    assert len(words) == 16


def test_ring_fits_shared_memory():
    # the .cu's F64Shared: the ring, two slabs' row / column masks and
    # their group masks, the staged need bytes and their count
    stage = 8 * (TILE * C["F64_AS"] + KS * C["F64_BS"])
    masks = 4 * 2 * (2 * TILE + TILE // 16 + TILE // 8)
    total = C["F64_STAGES"] * stage + masks + C["F64_NEED_CAP"] + 4
    assert total <= 227 * 1024
    # 16-byte cp.async pieces: every staged row starts on one
    assert (8 * C["F64_AS"]) % 16 == 0 and (8 * C["F64_BS"]) % 16 == 0
    assert C["F64_AS"] % 16 == 4 and C["F64_BS"] % 16 == 4
    assert TILE % KS == 0 and KS % MK == 0 and MK in (4, 8)
    assert C["F64_THREADS"] == 256 and KS == 16 and TILE // KS == 8
    # each thread's cp.async pieces cover both slabs once
    n = C["F64_THREADS"] * 4
    assert n * 2 == TILE * KS == KS * TILE
    # the k-masks a tile: 4 words of k bits and a word of 8 slab bits, for
    # each of the two operand roles (the wrapper's buffer)
    assert C["F64_MASK_WORDS"] == mk.F64_MASK_WORDS == 2 * (TILE // 32 + 1)


def test_tile_masks_and_pair_need_are_the_slab_rule():
    # a slab of a pair runs iff a k of it has a non-zero in A's column and
    # in B's row, or either holds an Inf or a NaN: what the two pre-passes
    # compute word by word
    a, b = _tiles(5, 3), _tiles(6, 3)
    a[0, :, 16:48] = 0.0                # slabs 1 and 2 of A[0] are empty
    b[1, 60:64] = 0.0
    b[1, 48:60] = 0.0                   # slab 3 of B[1] is empty
    a[2, 7, 100] = np.nan               # slab 6 of A[2] holds a NaN
    a[2, :, 96:112] = np.where(np.isnan(a[2, :, 96:112]), np.nan, 0.0)
    for ai in range(4):
        for bi in range(4):
            with np.errstate(invalid="ignore"):
                got = pair_need(tile_masks(a[ai]), tile_masks(b[bi]))
            for j in range(8):
                sl = slice(KS * j, KS * j + KS)
                meet = ((a[ai][:, sl] != 0).any(0)
                        & (b[bi][sl, :] != 0).any(1)).any()
                bad = not (np.isfinite(a[ai][:, sl]).all()
                           and np.isfinite(b[bi][sl, :]).all())
                assert bool(got >> j & 1) == (meet or bad), (ai, bi, j)
    with np.errstate(invalid="ignore"):
        assert pair_need(tile_masks(a[0]), tile_masks(b[0])) & 0b110 == 0
        assert pair_need(tile_masks(a[0]), tile_masks(b[1])) & 0b1000 == 0
        # the zero tile: only the NaN's slab runs (NaN x 0 is NaN)
        assert pair_need(tile_masks(a[2]), tile_masks(b[3])) == 1 << 6
        assert pair_need(tile_masks(a[0]), tile_masks(b[3])) == 0
        assert pair_need(tile_masks(a[2]), tile_masks(b[0])) & 1 << 6


def _tiles(seed, n_tiles):
    """(n_tiles + 1, 128, 128) float64: about 1/4 stored, a k-slab of A
    rows empty in tile 0 and one of B all zero in tile 1, subnormals, -0.0
    entries; the last tile is the zero padding tile."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((n_tiles + 1, TILE, TILE))
    u = g.random(x.shape)
    x[u < 0.75] = 0.0
    x[(u >= 0.75) & (u < 0.76)] = 5e-320          # subnormal
    x[(u >= 0.76) & (u < 0.77)] = -0.0
    x[0, :, 16:32] = 0.0
    x[1, 48:64, :] = 0.0
    x[-1] = 0.0
    return x


def _stream(pairs_per_tile, n_a, n_b, seed):
    g = np.random.default_rng(seed)
    seg, a_idx, b_idx = [], [], []
    for c, p in enumerate(pairs_per_tile):
        seg += [c] * p
        a_idx += list(g.integers(0, n_a, p))
        b_idx += list(g.integers(0, n_b, p))
    return np.array(seg), np.array(a_idx), np.array(b_idx)


def grid_tiles(seg, c_cap, p_cap, accumulate):
    """The float64 entry's grid, block by block: {block: (C tile, first
    pair, end)} of the blocks that run a tile (the fresh form: c_cap blocks,
    block c tile c; the accumulate form: min(c_cap, p_cap) blocks over
    stream_walk's list, a block past its count returning at once)."""
    seg_t = torch.from_numpy(np.asarray(seg, np.int32))
    seg_ptr = mk.segment_offsets(seg_t, c_cap).numpy()
    if not accumulate:
        return {c: (c, int(seg_ptr[c]), int(seg_ptr[c + 1]))
                for c in range(c_cap)}
    cap = min(c_cap, p_cap)
    walk = mk.stream_walk(seg_t, c_cap, cap).numpy()
    return {i: (int(walk[1 + 2 * i]), int(walk[2 + 2 * i]),
                int(walk[4 + 2 * i])) for i in range(cap) if i < walk[0]}


def _plain(a, b, seg, a_idx, b_idx, c_cap):
    pad = 256 - len(seg)
    t = lambda x, f: torch.from_numpy(np.concatenate(
        [x, np.full(pad, f)]).astype(np.int32))
    args = (t(a_idx, a.shape[0] - 1), t(b_idx, b.shape[0] - 1),
            t(seg, symbolic.INT32_MAX), c_cap, 256, torch.float64)
    return M.accumulate_macro(torch.from_numpy(a), torch.from_numpy(b),
                              *args)


@pytest.mark.parametrize("case", ["finite", "nonfinite"])
def test_slab_walk_replay_equals_plain_version(case):
    slab_walk_case(case, "fresh")


@pytest.mark.parametrize("case", ["finite", "nonfinite"])
def test_list_grid_runs_each_tile_with_pairs_once(case):
    """The accumulate form's grid over the walk list: blocks 0 .. T - 1 run
    the T tiles with pairs, each once, in a c_cap far above them; the
    others return at once; each tile's replay equals the plain version."""
    slab_walk_case(case, "accumulate")


def slab_walk_case(case, form):
    a, b = _tiles(1, 5), _tiles(2, 5)
    # a band in tiles 1 and 2 (most 16 x 8 blocks of their product multiply
    # only zeros, as in a banded matrix's tiles)
    for x in (a, b):
        x[1:3] *= np.abs(np.subtract.outer(np.arange(TILE),
                                           np.arange(TILE))) < 12
    if case == "nonfinite":
        a[0, 3, 5] = np.inf                 # a row of C: +-Inf, NaN at zeros
        b[2, 7, 33] = -np.inf
        a[3, 10, 40] = -np.inf              # meets an all-zero B slab
        b[3, 32:48] = 0.0
        b[4, 20, 9] = np.nan                # a column of C all NaN
        a[1, 100, 3] = np.nan               # in a block no product reaches
        b[2, 90, 5] = -np.inf
    # C tiles of 2, 0, 3 and 1 pairs (an empty tile, a ring that wraps
    # across pairs), pairs (0, 0) and (3, 3) among them; the accumulate
    # form's c_cap far past them
    c_cap = 4 if form == "fresh" else 40
    seg, a_idx, b_idx = _stream([2, 0, 3, 1], 5, 5, seed=3)
    a_idx[:2], b_idx[:2] = (0, 3), (0, 3)
    a_idx[2:5], b_idx[2:5] = (1, 2, 4), (1, 2, 4)
    want_v, want_f = (x.numpy() for x in _plain(a, b, seg, a_idx, b_idx,
                                                 c_cap))
    mag = _plain(np.abs(a), np.abs(b), seg, a_idx, b_idx, c_cap)[0].numpy()
    pad = np.full(256 - len(seg), symbolic.INT32_MAX)
    blocks = grid_tiles(np.concatenate([seg, pad]), c_cap, 256,
                        form == "accumulate")
    run = sorted(t for t, _lo, _hi in blocks.values())
    # every tile with pairs is run by one block (the fresh form: every
    # tile), and no block runs a tile twice
    assert run == (list(range(c_cap)) if form == "fresh" else [0, 2, 3])
    # blocks 0 .. T - 1 run the T tiles with pairs; the other min(c_cap,
    # p_cap) - T blocks return at once
    assert sorted(blocks) == list(range(len(run)))
    skipped = []
    for c, lo, hi in blocks.values():
        pairs = [(int(a_idx[q]), int(b_idx[q])) for q in range(lo, hi)]
        assert pairs == [(int(x), int(y)) for x, y in
                         zip(a_idx[seg == c], b_idx[seg == c])]
        got_v, got_f = replay_tile(a, b, pairs, skipped)
        np.testing.assert_array_equal(got_f, want_f[c])
        w = want_v[c]
        assert np.array_equal(np.isnan(got_v), np.isnan(w))
        inf = np.isinf(w)
        assert np.array_equal(np.isinf(got_v), inf)
        assert np.array_equal(got_v[inf] > 0, w[inf] > 0)
        fin = np.isfinite(w)
        assert (np.abs(got_v[fin] - w[fin]) <= 1e-12 * mag[c][fin]).all()
        if not pairs:
            assert not got_v.any() and not got_f.any()
    # tile 2's pairs (1, 1) and (2, 2) are banded: slabs and blocks were
    # skipped
    n_skip, n_all = np.sum(skipped[0::2]), np.sum(skipped[1::2])
    assert 0 < n_skip < n_all
    if case == "nonfinite":
        assert np.isnan(want_v).any() and np.isinf(want_v).any()


def test_k4_split_f64_builds_cut_one_place_each():
    # bench/k4_split.py builds the float64 entries with a constant or a line
    # of the source changed: each text must occur once
    from pem_spgemm_tpu_torch.bench import k4_split
    from pem_spgemm_tpu_torch.ops import dia_kernels as dk
    with open(mk.SOURCE) as f:
        macro = f.read()
    with open(dk.SOURCE) as f:
        dia = f.read()
    for name, cuts in k4_split.F64_CUTS.items():
        for old, new in cuts:
            assert macro.count(old) == 1 and new != old, name
    for name, geo in k4_split.DENSE64.items():
        for old, new in k4_split.dense64_cut(*geo):
            assert dia.count(old) == 1 and new != old, name
    # the cut that leaves the geometry as it is names DENSE_GEOMETRY[8]
    g = dk.DENSE_GEOMETRY[8]
    assert k4_split.dense64_cut(g["rows"], g["cols"], g["threads"], 2) \
        [0][1] == k4_split._DENSE64


def test_chip_smoke_skipped_share_is_the_kernels_rule():
    # chip_smoke.py reports the share of DMMA blocks the kernel skips,
    # computed from the tiles with torch; it must count what the replay
    # (the kernel's rule) skips, Inf / NaN blocks included
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    a, b = _tiles(1, 5), _tiles(2, 5)
    for x in (a, b):
        x[1:3] *= np.abs(np.subtract.outer(np.arange(TILE),
                                           np.arange(TILE))) < 12
    a[1, 100, 3] = np.nan
    b[2, 90, 5] = -np.inf
    pairs = [(0, 3), (1, 1), (2, 2), (1, 2), (4, 4), (2, 1)]
    skipped = []
    for p in pairs:
        replay_tile(a, b, [p], skipped)
    got = chip_smoke.f64_skipped_share(
        torch.from_numpy(a), torch.from_numpy(b),
        torch.tensor([p[0] for p in pairs]),
        torch.tensor([p[1] for p in pairs]))
    assert got["blocks"] == np.sum(skipped[1::2]) == 1024 * len(pairs)
    assert got["blocks"] - got["blocks_run"] == np.sum(skipped[0::2]) > 0
