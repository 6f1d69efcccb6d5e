"""The DIA kernels' launch shapes, the dense entry's staged B window and the
pairs entry's block walk.

csrc/dia_multiply.cu's dense entry cannot run here.  What surrounds it is
host-side Python and index arithmetic: ``dia_kernels.dense_launch`` picks
the block shape, the chunk depth and the shared-memory layout, and
``dense_chunks`` is the kernel's chunk rule.  These tests hold that shape
against every kind of offset set ``dense_qualifies`` admits (stencils of 1
to 128 bands, narrow and wide, gapped A offsets, rectangular operands), and
replay the kernel block by block in numpy: the staged window (zero-filled
outside B), the register block named by anti-diagonal and slot, the reload
at a gap or where a thread's rows leave B's range.  Both word sizes: the
float32 entry (4-byte words, 8 x 4 C elements a thread) and the float64 one
(the same kernel on 8-byte words, 4 x 4 a thread).  The replay must give the
plain version's values to float32 rounding (bit for bit in float64, where
the kernel rounds each product and sum as the plain version does) and its
counts exactly; the float32 launch shapes stay as they were.

The pairs entry (any offset sets) is replayed the same way from
``dia_kernels.pairs_launch``'s grid: a block's column range, its staged A
words, its rows and each row's pairs; every product of a C element is
added once, in ascending A band, a block taken as interior (no bounds
test) needs none, and the pairbands offsets blown out 1000x launch with no
interior block.
"""

import numpy as np
import pytest
import torch

from pem_spgemm_tpu_torch.ops import dia_kernels as dk
from pem_spgemm_tpu_torch.ops.dia import _dia_multiply_torch, _plan_maps


# (A offsets, B offsets): every kind of set dense_qualifies admits
QUALIFYING = {
    "single": ((0,), (0,)),
    "tridiagonal": ((-1, 0, 1), (-1, 0, 1)),
    "stencil 16": (tuple(range(-8, 8)), tuple(range(-8, 8))),
    "stencil 64": (tuple(range(-32, 32)), tuple(range(-32, 32))),
    "stencil 128": (tuple(range(-64, 64)), tuple(range(-64, 64))),
    "gapped a": ((0, 2, 4), (-3, -2, -1, 0)),
    "gapped wide": ((0, 3, 40, 41, 42), tuple(range(-20, 20))),
    "one a band": ((5,), (-2, -1, 0, 1, 2)),
    "rect": ((-1, 0, 1, 2), (-2, -1, 0)),
    "wide b": (tuple(range(0, 3)), tuple(range(-500, 500))),
}


def _shape(offs_a, offs_b, word=4):
    dc_list, _ = _plan_maps(offs_a, offs_b)
    assert dk.dense_qualifies(offs_a, offs_b, dc_list)
    return dk.dense_launch(offs_a, len(offs_b), len(dc_list), word)


@pytest.mark.parametrize("word", [4, 8])
@pytest.mark.parametrize("name", sorted(QUALIFYING))
def test_launch_shape_holds_every_chunk(name, word):
    offs_a, offs_b = QUALIFYING[name]
    d2n = len(offs_b)
    dcn = len(_plan_maps(offs_a, offs_b)[0])
    sh = _shape(offs_a, offs_b, word)
    geo = dk.DENSE_GEOMETRY[word]
    R = geo["rows"]
    tr = 1 << sh["tr_log2"]
    assert (sh["rows"], sh["cols"]) == (R, geo["cols"]) and sh["word"] == word
    assert tr * sh["tc_n"] == sh["threads"] <= geo["threads"] <= 256
    assert sh["L"] == sh["tc_n"] * sh["cols"]
    # a block's rows cover every C row, or the most row blocks whose
    # warps still share their rows, and the lanes of a warp share their rows
    cap = R * min(dk.MAX_ROW_BLOCKS, geo["threads"] // 32)
    assert sh["rows_per_block"] == R * tr >= min(dcn, cap)
    assert sh["tc_n"] >= 32
    assert sh["grid_y"] * sh["rows_per_block"] >= dcn
    # one block's shared memory, small enough for two blocks an SM
    assert sh["smem_bytes"] == word * sh["stage_words"] <= dk.SMEM_BUDGET
    assert 2 * sh["smem_bytes"] <= 227 * 1024
    # 16-byte pieces: every row of the window and of the A chunk starts on
    # one, and a thread's first word is one
    assert sh["s"] % 32 == 0 and (word * sh["stage_words"]) % 16 == 0
    assert (word * sh["b_off"]) % 16 == 0 and (word * sh["L"]) % 16 == 0
    assert (word * sh["cols"]) % 16 == 0 and sh["rows"] % (16 // word) == 0
    # a row's ring holds the window's columns, and a rotated position
    # (column + row + a shift below 4) stays below 2 s
    assert sh["cols_cap"] <= sh["s"] and sh["rows_cap"] + 3 <= sh["s"]
    assert sh["b_off"] + sh["rows_cap"] * sh["s"] <= sh["stage_words"]
    assert (1 << sh["cw_log2"]) <= min(sh["threads"], dk.COPY_WIDTH)
    chunks = dk.dense_chunks(offs_a, sh["kc"])
    assert len(chunks) == sh["chunks"]
    # the chunks tile the A bands in order; a window is L plus the chunk's
    # offset span wide (a gapped chunk is wider than L + its band count)
    assert chunks[0][0] == 0 and chunks[-1][1] == len(offs_a)
    for (kb, ke), (kb2, _) in zip(chunks, chunks[1:] + [(len(offs_a), 0)]):
        span = offs_a[ke - 1] - offs_a[kb]
        assert ke == kb2 and 0 < ke - kb <= min(sh["kc"], sh["a_rows"])
        assert span < sh["kc"] and sh["L"] + span <= sh["cols_cap"]
        rows = min(d2n, sh["rows_per_block"] + span) + 2 * (R - 1)
        assert rows <= sh["rows_cap"]
    if name == "gapped wide":
        assert any(offs_a[ke - 1] - offs_a[kb] > ke - kb - 1
                   for kb, ke in chunks)


# the float32 entry's launch shapes, as they were before the dense kernel
# took its word type as a template parameter
FLOAT32_SHAPES = {
    "stencil 16": (2, 64, 128, 288, 5, 4096, 12736, 1, 1),
    "stencil 64": (3, 32, 128, 192, 5, 8192, 23168, 2, 1),
    "stencil 128": (3, 32, 32, 160, 5, 4096, 21536, 4, 4),
    "gapped wide": (3, 32, 128, 192, 5, 640, 11008, 2, 1),
    "wide b": (3, 32, 128, 160, 5, 384, 13184, 16, 1),
    "single": (0, 64, 128, 256, 5, 256, 4096, 1, 1),
}


@pytest.mark.parametrize("name", sorted(FLOAT32_SHAPES))
def test_float32_launch_shapes_are_unchanged(name):
    sh = _shape(*QUALIFYING[name])
    assert tuple(sh[k] for k in ("tr_log2", "tc_n", "kc", "s", "cw_log2",
                                 "b_off", "stage_words", "grid_y",
                                 "chunks")) == FLOAT32_SHAPES[name]
    assert (dk.ROWS, dk.COLS) == (8, 4) and sh["smem_bytes"] == \
        4 * sh["stage_words"]


def test_dense_geometry_is_the_sources():
    # DENSE_GEOMETRY mirrors the .cu's Dense<float> / Dense<double>, and
    # the float64 window chunks fewer bands than the float32 one at the
    # wide stencils (the same budget holds half the words)
    import re
    with open(dk.SOURCE) as f:
        src = f.read()
    for word, t in ((4, "float"), (8, "double")):
        body = re.search(r"struct Dense<%s> \{(.*?)\};" % t, src,
                         re.S).group(1)
        got = {k: int(re.search(r"constexpr int %s = (\d+);" % k,
                                body).group(1))
               for k in ("ROWS", "I", "THREADS", "MIN_BLOCKS")}
        geo = dk.DENSE_GEOMETRY[word]
        assert (got["ROWS"], got["I"], got["THREADS"]) == (
            geo["rows"], geo["cols"], geo["threads"])
        assert got["MIN_BLOCKS"] == 2
    for d in (64, 128):
        offs = tuple(range(-(d // 2), d - d // 2))
        assert _shape(offs, offs, 8)["kc"] < _shape(offs, offs, 4)["kc"]
    with pytest.raises(ValueError, match="4 or 8"):
        dk.dense_launch((0,), 1, 1, 2)


def test_chunk_rule_cuts_at_count_and_at_span():
    assert dk.dense_chunks(tuple(range(-64, 64)), 128) == [(0, 128)]
    assert dk.dense_chunks(tuple(range(70)), 32) == [(0, 32), (32, 64),
                                                     (64, 70)]
    assert dk.dense_chunks((0, 3, 40, 41, 42), 32) == [(0, 2), (2, 5)]
    assert dk.dense_chunks((0, 31, 32), 32) == [(0, 2), (2, 3)]
    assert dk.dense_chunks((7,), 1) == [(0, 1)]


def test_launch_shape_bounds_the_window_by_the_block_not_by_b():
    # 200,000 B bands: a block stages only the rows its C rows reach
    sh = dk.dense_launch((0,), 200_000, 200_000)
    assert sh["rows_cap"] == dk.ROWS * dk.MAX_ROW_BLOCKS + 2 * (dk.ROWS - 1)
    assert sh["kc"] == 128
    # a count is kept in 16 bits
    with pytest.raises(ValueError, match="16-bit"):
        dk.dense_launch(tuple(range(1 << 16)), 1, 1 << 16)


def _replay_block_kernel(a, b, offs, dcn, n_out, values_only):
    """csrc/dia_multiply.cu's dense kernel, block by block and thread by
    thread: stage each chunk's A rows and B window into a flat array laid
    out as the kernel's shared memory (NaN where nothing is staged; window
    row w, column cc at w * s + (cc + w + sh) mod s), then walk the bands in
    groups of up to 8, each thread loading whole window rows at its fixed
    positions into registers named by anti-diagonal and slot, all R rows
    where a group starts afresh.  The words' dtype picks the entry: float32
    products are fused into the sum (fmaf), float64 ones rounded, then
    added (madd).  Returns (c, cnt, reloads)."""
    d1n, n_i = a.shape
    d2n, n_k = b.shape
    dt = a.dtype
    word = dt.itemsize
    vw = 16 // word                     # words a 16-byte piece
    sh = dk.dense_launch(offs, d2n, dcn, word)
    R = sh["rows"]
    PADR = R - 1
    cols, s, L = sh["cols"], sh["s"], sh["L"]
    tc_n, rb = sh["tc_n"], sh["rows_per_block"]
    nth = sh["threads"]
    a0 = offs[0]
    c = np.full((dcn, n_out), np.nan, dt)
    cnt = np.full((dcn, n_out), np.nan, np.float32)
    ir, ii = np.arange(R)[:, None], np.arange(cols)[None, :]
    n_t = R + cols - 1                  # anti-diagonals of a register block
    reloads = 0

    for by in range(sh["grid_y"]):
        for bx in range(-(-n_out // L)):
            i0, rc0 = bx * L, by * rb
            stages = []
            for kb, ke in dk.dense_chunks(offs, sh["kc"]):
                dlo, dhi = offs[kb] - a0, offs[ke - 1] - a0
                wr0 = max(0, rc0 - dhi)
                wr1 = min(d2n, rc0 + rb - dlo)
                if wr1 <= wr0:
                    continue
                nrows, ncols = wr1 - wr0 + 2 * PADR, L + dhi - dlo
                assert nrows <= sh["rows_cap"] and ncols <= sh["cols_cap"]
                shift = (dlo + wr0 - rc0 - PADR) & (vw - 1)
                smem = np.full(sh["stage_words"], np.nan, dt)
                i = i0 + np.arange(L)
                for kk in range(ke - kb):
                    smem[kk * L:(kk + 1) * L] = np.where(
                        i < n_i, a[kb + kk, np.minimum(i, n_i - 1)], 0)
                w, cc = np.meshgrid(np.arange(nrows), np.arange(ncols),
                                    indexing="ij")
                k2, j = wr0 - PADR + w, i0 + a0 + dlo + cc
                ok = (k2 >= 0) & (k2 < d2n) & (j >= 0) & (j < n_k)
                rot = cc + w + shift
                assert rot.max() < 2 * s
                at = sh["b_off"] + w * s + np.where(rot < s, rot, rot - s)
                assert len(np.unique(at)) == at.size
                assert at.max() < sh["stage_words"]
                smem[at] = np.where(
                    ok, b[np.clip(k2, 0, d2n - 1), np.clip(j, 0, n_k - 1)], 0)
                stages.append((kb, ke, wr0, nrows, dlo, shift, smem))
            for th in range(nth):
                tc, tr = th % tc_n, th // tc_n
                acc = np.zeros((R, cols), dt)
                num = np.zeros((R, cols), np.float32)
                bv = np.full((n_t, R), np.nan, dt)
                for kb, ke, wr0, nrows, dlo, shift, smem in stages:
                    p0 = cols * tc + rc0 + R * tr - dlo - wr0 + PADR + shift
                    assert p0 % vw == 0
                    # the thread's words of any window row: whole 16-byte
                    # pieces at the same positions in every row
                    pos = np.concatenate([(p0 + vw * v) % s + np.arange(vw)
                                          for v in range(-(-n_t // vw))])

                    def load_row(w, slot):
                        bv[:, slot] = smem[sh["b_off"] + w * s + pos][:n_t]

                    have, dprev, k = False, 0, kb
                    while k < ke:
                        whole = True
                        for u in range(R):
                            if k >= ke:
                                whole = False
                                break
                            dl = offs[k] - a0
                            k2lo = rc0 + R * tr - dl
                            inside = k2lo + R > 0 and k2lo < d2n
                            if u == 0 and not inside:
                                have, whole = False, None
                                k += 1
                                break
                            if u > 0 and (not inside or dl != dprev + 1):
                                whole = False
                                break
                            wb = k2lo - wr0 + PADR
                            assert 0 <= wb and wb + R <= nrows
                            if u == 0 and not (have and dl == dprev + 1):
                                for r in range(R):
                                    load_row(wb + r, (r - u) % R)
                                reloads += 1
                            else:
                                load_row(wb, (0 - u) % R)
                            av = smem[(k - kb) * L + tc * cols
                                      + np.arange(cols)]
                            x = bv[ir + ii, (ir - u) % R]
                            assert not np.isnan(x).any()
                            assert not np.isnan(av).any()
                            if dt == np.float64:
                                acc = acc + av[None, :] * x
                            else:
                                acc = (acc.astype(np.float64)
                                       + av[None, :].astype(np.float64) * x
                                       ).astype(np.float32)
                            num += (av[None, :] != 0) & (x != 0)
                            dprev = dl
                            k += 1
                        if whole is not None:
                            have = whole
                rows = rc0 + R * tr + np.arange(R)
                cls_ = i0 + tc * cols + np.arange(cols)
                rk, ck = rows < dcn, cls_ < n_out
                c[np.ix_(rows[rk], cls_[ck])] = acc[np.ix_(rk, ck)]
                cnt[np.ix_(rows[rk], cls_[ck])] = num[np.ix_(rk, ck)]
    return c, cnt, reloads


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("values_only", [False, True])
@pytest.mark.parametrize("name,n_i,n_k", [
    ("tridiagonal", 300, 300),
    ("stencil 16", 517, 517),           # 512 + 5: a ragged last block
    ("gapped a", 157, 157),
    ("gapped wide", 130, 130),
    ("one a band", 203, 203),
    ("rect", 120, 170),
    ("stencil 64", 129, 129),           # 128 + 1: one column in the last
])
def test_block_replay_equals_plain_version(name, n_i, n_k, values_only,
                                           dtype):
    offs_a, offs_b = QUALIFYING[name]
    rng = np.random.default_rng(n_i * 7 + n_k)
    a = rng.standard_normal((len(offs_a), n_i)).astype(dtype)
    b = rng.standard_normal((len(offs_b), n_k)).astype(dtype)
    a[rng.random(a.shape) < 0.2] = 0
    b[rng.random(b.shape) < 0.2] = 0
    dc_list, idx_map = _plan_maps(offs_a, offs_b)
    want_c, want_n = _dia_multiply_torch(
        torch.from_numpy(a), torch.from_numpy(b), offs_a=offs_a,
        idx_map=idx_map, dc_count=len(dc_list), n_out=n_i)
    got_c, got_n, reloads = _replay_block_kernel(a, b, offs_a, len(dc_list),
                                                 n_i, values_only)
    assert reloads > 0
    if dtype == np.float64:
        # each product and sum rounded as the plain version rounds them, in
        # its order: bit for bit (-0.0 and +0.0 told apart)
        assert got_c.dtype == np.float64
        assert np.array_equal(got_c.view(np.int64),
                              want_c.numpy().view(np.int64))
    else:
        # fmaf: one rounding a product, where the plain version has two
        np.testing.assert_allclose(got_c, want_c.numpy(), rtol=1e-5,
                                   atol=1e-5)
    if not values_only:
        np.testing.assert_array_equal(got_n, want_n.numpy())


def test_split_builds_cut_one_place_each():
    # bench/k2_split.py times the dense kernel with its band loop or its
    # staging copies cut out, by replacing one line of the source each
    from pem_spgemm_tpu_torch.bench import k2_split
    with open(dk.SOURCE) as f:
        text = f.read()
    for name, (old, new) in k2_split.CUTS.items():
        assert text.count(old) == 1 and new != old, name


# --------------------------------------------------------------------------
# the pairs entry (any offset sets)

PAIRBANDS = (-1201, -1200, -601, -600, 0, 1, 600, 601, 1200, 1201)


def _replay_pairs_kernel(a, b, offs_a, offs_b, n_out, blocks=None):
    """csrc/dia_multiply.cu's pairs entry, block by block: pairs_launch's
    grid, a block's staged A words (zero past n_i), thread t's columns
    i0 + t + PAIR_THREADS * e, the block's rows r = by, by + grid_y, ...,
    each row's pairs in table order (two a step in the kernel, added in
    order).  An interior block (pair_rows without tests) is asserted to
    need no test.  Returns (c, cnt, visits, last_k1, interior) over the
    replayed blocks' columns (NaN / -1 elsewhere): visits counts the
    products added to each element, last_k1 asserts that they come in
    ascending A band."""
    d1n, n_i = a.shape
    _d2n, n_k = b.shape
    dc_list, _ = _plan_maps(offs_a, offs_b)
    row_ptr, trip = dk.pair_table(offs_a, offs_b, dc_list)
    dcn = len(dc_list)
    sh = dk.pairs_launch(d1n, dcn, len(trip), n_out)
    L, T, E, gy = sh["L"], sh["threads"], sh["cols"], sh["grid_y"]
    assert L == T * E
    with open(dk.SOURCE) as f:              # the .cu's constants
        src = f.read()
    assert f"constexpr int PAIR_THREADS = {T};" in src
    assert f"constexpr int PAIR_COLS = {E};" in src
    c = np.full((dcn, n_out), np.nan, np.float32)
    cnt = np.full((dcn, n_out), np.nan, np.float32)
    visits = np.zeros((dcn, n_out), np.int64)
    written = np.zeros((dcn, n_out), np.int64)
    interior = []
    for bx in (range(sh["grid_x"]) if blocks is None else blocks):
        i0 = bx * L
        inner = (i0 + L <= n_out and i0 + offs_a[0] >= 0
                 and i0 + L - 1 + offs_a[-1] < n_k)
        interior.append(inner)
        cols = i0 + np.arange(T)[:, None] + T * np.arange(E)[None, :]
        col_ok = cols < n_out
        staged = np.zeros((d1n, L), np.float32)
        w = max(0, min(L, n_i - i0))
        staged[:, :w] = a[:, i0:i0 + w]
        for by in range(gy):
            for r in range(by, dcn, gy):
                acc = np.zeros((T, E), np.float32)
                num = np.zeros((T, E), np.float32)
                last = np.full((T, E), -1)
                for p in range(row_ptr[r], row_ptr[r + 1]):
                    k1, k2, d1 = (int(x) for x in trip[p])
                    j = cols + d1
                    ok = col_ok & (j >= 0) & (j < n_k)
                    if inner:
                        assert ok.all()
                    av = staged[k1, cols - i0]
                    bv = b[k2, np.clip(j, 0, n_k - 1)]
                    acc = np.where(ok, (acc + av * bv).astype(np.float32),
                                   acc)
                    num += ok & (av != 0) & (bv != 0)
                    assert (last[ok] < k1).all()
                    last[ok] = k1
                    visits[r, cols[ok]] += 1
                c[r, cols[col_ok]] = acc[col_ok]
                cnt[r, cols[col_ok]] = num[col_ok]
                written[r, cols[col_ok]] += 1
    return c, cnt, visits, written, interior


@pytest.mark.parametrize("name,offs_a,offs_b,n_i,n_k", [
    ("pairbands", PAIRBANDS, PAIRBANDS, 5_003, 5_003),
    ("gapped", (0, 2, 4), (-3, -2, -1, 0), 2_100, 2_100),
    ("rect", (-1, 0, 1, 2), (-2, -1, 0), 3_001, 2_500),
    ("near +-n", (-1200, 0, 1197), (-1200, 0, 1197), 1_201, 1_201),
])
def test_pairs_replay_visits_each_product_once_in_band_order(
        name, offs_a, offs_b, n_i, n_k):
    rng = np.random.default_rng(n_i + n_k)
    a = rng.standard_normal((len(offs_a), n_i)).astype(np.float32)
    b = rng.standard_normal((len(offs_b), n_k)).astype(np.float32)
    a[rng.random(a.shape) < 0.2] = 0
    b[rng.random(b.shape) < 0.2] = 0
    dc_list, idx_map = _plan_maps(offs_a, offs_b)
    c, cnt, visits, written, interior = _replay_pairs_kernel(
        a, b, offs_a, offs_b, n_i)
    assert (written == 1).all()             # every C element stored once
    # every product of the element's band pairs with its B column inside
    want_visits = np.zeros_like(visits)
    i = np.arange(n_i)
    for k1, d1 in enumerate(offs_a):
        for k2 in range(len(offs_b)):
            j = i + d1
            want_visits[dc_list.index(d1 + offs_b[k2])] += (j >= 0) & \
                (j < n_k)
    np.testing.assert_array_equal(visits, want_visits)
    want_c, want_n = _dia_multiply_torch(
        torch.from_numpy(a), torch.from_numpy(b), offs_a=offs_a,
        idx_map=idx_map, dc_count=len(dc_list), n_out=n_i)
    np.testing.assert_allclose(c, want_c.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt, want_n.numpy())
    if name == "pairbands":
        assert interior == [False, False, True, False, False]


def test_pairs_launch_shape_at_pairbands_x1000():
    # the pairbands offsets blown out 1000x: a span of 2.4 M columns, more
    # than n; no block is interior, every block tests its columns
    wide = tuple(o * 1000 for o in PAIRBANDS)
    n = 1_500_007
    dc_list, _ = _plan_maps(wide, wide)
    assert dk.dia_mode(wide, wide, dc_list) == "pairs"
    sh = dk.pairs_launch(len(wide), len(dc_list), len(wide) ** 2, n)
    assert sh["grid_x"] == -(-n // dk.PAIR_L) and sh["grid_y"] == 1
    assert sh["stage_a"] and sh["stage_tables"]
    assert sh["smem_bytes"] == 4 * (len(wide) * dk.PAIR_L + len(dc_list) + 1
                                    + 3 * len(wide) ** 2)
    assert sh["smem_bytes"] <= dk.SMEM_BUDGET
    rng = np.random.default_rng(5)
    a = rng.standard_normal((len(wide), n)).astype(np.float32)
    blocks = [0, 1, sh["grid_x"] // 2, sh["grid_x"] - 1]
    c, cnt, _v, written, interior = _replay_pairs_kernel(
        a, a, wide, wide, n, blocks)
    assert not any(interior)
    want_c, want_n = _dia_multiply_torch(
        torch.from_numpy(a), torch.from_numpy(a), offs_a=wide,
        idx_map=_plan_maps(wide, wide)[1], dc_count=len(dc_list), n_out=n)
    cols = written[0] == 1
    assert cols.sum() == 3 * dk.PAIR_L + (n - (sh["grid_x"] - 1) * dk.PAIR_L)
    np.testing.assert_allclose(c[:, cols], want_c.numpy()[:, cols],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt[:, cols], want_n.numpy()[:, cols])


@pytest.mark.parametrize("d1n,dcn,n_pairs,n_out,stage_a,stage_tables", [
    (10, 30, 100, 500_000, True, True),     # pairbands-500k
    (40, 80, 80, 3_001, False, True),       # A past the budget
    (300, 937, 12_000, 3_001, False, False),  # the tables too
    (1, 1, 1, 1, True, True),
])
def test_pairs_launch_stages_what_fits(d1n, dcn, n_pairs, n_out, stage_a,
                                       stage_tables):
    sh = dk.pairs_launch(d1n, dcn, n_pairs, n_out)
    assert (sh["stage_a"], sh["stage_tables"]) == (stage_a, stage_tables)
    assert sh["smem_bytes"] <= dk.SMEM_BUDGET
    assert sh["grid_x"] * sh["L"] >= n_out > (sh["grid_x"] - 1) * sh["L"]
    assert 1 <= sh["grid_y"] <= dcn
    assert sh["grid_x"] * sh["grid_y"] >= min(dk.PAIRS_MIN_BLOCKS,
                                              sh["grid_x"] * dcn)
    with pytest.raises(ValueError):
        dk.pairs_launch(0, dcn, n_pairs, n_out)
