"""The DIA kernels' launch shapes, the dense entry's ring of B's window and
the pairs entry's block walk.

csrc/dia_multiply.cu's dense entry cannot run here.  What surrounds it is
host-side Python and index arithmetic: ``dia_kernels.dense_launch`` picks
the block shape, the row groups, the strips of column ranges, the chunk
depth and the shared-memory layout, ``dense_chunks`` is the kernel's chunk
rule and ``dense_staging`` counts the words a launch stages.  These tests
hold that shape against every kind of offset set ``dense_qualifies`` admits
(stencils of 1 to 128 bands, narrow and wide, gapped A offsets, rectangular
operands), and replay the kernel block by block in numpy: each block's
strip of column ranges, the ring (window row w, column j at (j + w + q) mod
s, zero pad rows), the next range's copies made before this range's
products (so a copy that overwrote what a range still reads would show),
the passes of row blocks, the register block named by anti-diagonal and
slot, the reload at a gap or where a thread's rows leave B's range, the
chunks that store their sums and read them back.  Both word sizes: the
float32 entry (4-byte words, 8 x 4 C elements a thread) and the float64 one
(the same kernel on 8-byte words, 4 x 4 a thread).  The replay must give
the plain version's values to float32 rounding (bit for bit in float64,
where the kernel rounds each product and sum as the plain version does) and
its counts exactly, and stage the words ``dense_staging`` counts: about one
a useful A or B word at banded128-1M (float32) and banded64-1M (float64).

The pairs entries (any offset sets) are replayed the same way from
``dia_kernels.pairs_launch``'s grid at either word size: a block's column
range, its row group's rows and each row's pairs; every product of a C
element is added once, in ascending A band, a block taken as interior (no
bounds test) needs none, and the pairbands offsets blown out 1000x launch
with no interior block.  The float64 entry (the float32 kernel on 8-byte
words, with its geometry) is held bit for bit to the plain version,
also with edge blocks at both ends, with row groups of uneven size, and on
zero-heavy bands full of -0.0.
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


def _shape(offs_a, offs_b, word=4, n_out=None, **kw):
    dc_list, _ = _plan_maps(offs_a, offs_b)
    assert dk.dense_qualifies(offs_a, offs_b, dc_list)
    return dk.dense_launch(offs_a, len(offs_b), len(dc_list), word, n_out,
                           **kw)


@pytest.mark.parametrize("word", [4, 8])
@pytest.mark.parametrize("name", sorted(QUALIFYING))
def test_launch_shape_holds_every_chunk(name, word):
    offs_a, offs_b = QUALIFYING[name]
    d2n = len(offs_b)
    dcn = len(_plan_maps(offs_a, offs_b)[0])
    sh = _shape(offs_a, offs_b, word, n_out=10_007)
    geo = dk.DENSE_GEOMETRY[word]
    R = geo["rows"]
    tr = 1 << sh["tr_log2"]
    assert (sh["rows"], sh["cols"]) == (R, geo["cols"]) and sh["word"] == word
    assert tr * sh["tc_n"] == sh["threads"] <= geo["threads"] <= 512
    assert sh["L"] == sh["tc_n"] * sh["cols"]
    # the lanes of a warp span one row block, or two at 16 column blocks;
    # a pass holds every C row, or the most row blocks a block may have
    assert dk.MIN_COL_BLOCKS <= sh["tc_n"] <= dk.MAX_COL_BLOCKS
    assert tr <= dk.MAX_ROW_BLOCKS and sh["rows_per_pass"] == R * tr
    assert sh["group_rows"] == R * tr * sh["passes"]
    assert sh["grid_y"] * sh["group_rows"] >= dcn > (sh["grid_y"] - 1) * \
        sh["group_rows"]
    # one block's shared memory: two A buffers, then the ring
    assert sh["smem_bytes"] == word * sh["stage_words"] <= dk.SMEM_BLOCK
    assert sh["stage_words"] == 2 * sh["a_words"] + sh["rows_cap"] * sh["s"]
    assert sh["b_off"] == 2 * sh["a_words"] == 2 * sh["a_rows"] * sh["L"]
    # 16-byte pieces: every row of the ring and of the A buffers starts on
    # one, and a thread's first word is one
    assert sh["s"] % 32 == 0 and (word * sh["stage_words"]) % 16 == 0
    assert (word * sh["b_off"]) % 16 == 0 and (word * sh["L"]) % 16 == 0
    assert (word * sh["cols"]) % 16 == 0 and sh["rows"] % (16 // word) == 0
    # the ring holds a range's window and the next range's new columns
    assert 2 * sh["L"] + sh["span"] <= sh["s"]
    assert sh["threads"] % dk.COPY_COLS == 0
    # the strips cover the column ranges, about blocks_per_sm blocks an SM
    n_ranges = -(-10_007 // sh["L"])
    assert sh["n_ranges"] == n_ranges
    assert sh["grid_x"] * sh["strip"] >= n_ranges > (sh["grid_x"] - 1) * \
        sh["strip"]
    assert sh["grid_x"] * sh["grid_y"] <= max(
        sh["grid_y"], dk.H100_SMS * sh["blocks_per_sm"])
    assert 1 <= sh["blocks_per_sm"] * (sh["smem_bytes"] + 1024) <= dk.SMEM_SM
    chunks = dk.dense_chunks(offs_a, sh["kc"])
    assert len(chunks) == sh["chunks"]
    # the chunks tile the A bands in order; a window is L plus the chunk's
    # offset span wide (a gapped chunk is wider than L + its band count)
    assert chunks[0][0] == 0 and chunks[-1][1] == len(offs_a)
    for (kb, ke), (kb2, _) in zip(chunks, chunks[1:] + [(len(offs_a), 0)]):
        span = offs_a[ke - 1] - offs_a[kb]
        assert ke == kb2 and 0 < ke - kb <= min(sh["kc"], sh["a_rows"])
        assert span < sh["kc"] and span <= sh["span"]
        for g in range(sh["grid_y"]):       # the group's window rows
            rc0 = g * sh["group_rows"]
            real = min(d2n, rc0 + sh["group_rows"] - (offs_a[kb] - offs_a[0])) \
                - max(0, rc0 - (offs_a[ke - 1] - offs_a[0]))
            assert real + 2 * (R - 1) <= sh["rows_cap"]
    if name == "gapped wide":
        assert any(offs_a[ke - 1] - offs_a[kb] > ke - kb - 1
                   for kb, ke in chunks)


# the float32 entry's launch shapes, pinned: (tr_log2, tc_n, passes,
# grid_y, kc, s, a_words, stage_words, chunks)
FLOAT32_SHAPES = {
    "stencil 16": (2, 64, 1, 1, 16, 544, 4096, 24512, 1),
    "stencil 64": (3, 32, 2, 1, 64, 320, 8192, 41344, 1),
    "stencil 128": (4, 16, 2, 1, 128, 256, 8192, 52736, 1),
    "gapped wide": (2, 64, 3, 1, 43, 576, 1280, 33664, 1),
    "wide b": (2, 64, 2, 16, 3, 544, 768, 45056, 1),
    "single": (0, 64, 1, 1, 1, 512, 256, 8192, 1),
}


@pytest.mark.parametrize("name", sorted(FLOAT32_SHAPES))
def test_float32_launch_shapes_are_unchanged(name):
    sh = _shape(*QUALIFYING[name])
    assert tuple(sh[k] for k in ("tr_log2", "tc_n", "passes", "grid_y",
                                 "kc", "s", "a_words", "stage_words",
                                 "chunks")) == FLOAT32_SHAPES[name]
    assert (dk.ROWS, dk.COLS) == (8, 4) and sh["smem_bytes"] == \
        4 * sh["stage_words"]


def test_dense_geometry_is_the_sources():
    # DENSE_GEOMETRY mirrors the .cu's Dense<float> / Dense<double>; the
    # float64 ring holds banded64's bands in one chunk, as the float32 one
    # does, and banded128's only in chunks (the same shared memory holds
    # half the words)
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
        assert got["MIN_BLOCKS"] == geo["blocks"] == 1
    assert f"constexpr int COPY_COLS = {dk.COPY_COLS};" in src
    for d in (64, 128):
        offs = tuple(range(-(d // 2), d - d // 2))
        assert _shape(offs, offs, 4)["chunks"] == 1
        assert _shape(offs, offs, 8)["chunks"] == (1 if d == 64 else 2)
        assert _shape(offs, offs, 8)["kc"] <= _shape(offs, offs, 4)["kc"]
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
    # 200,000 B bands: a row group stages only the rows its C rows reach
    sh = dk.dense_launch((0,), 200_000, 200_000)
    assert sh["group_rows"] == dk.ROWS * 4 * 3 == 96    # 3 passes of 4
    assert sh["rows_cap"] == sh["group_rows"] + 2 * (dk.ROWS - 1)
    assert sh["kc"] == 1 and sh["grid_y"] == -(-200_000 // 96)
    # a count is kept in 16 bits
    with pytest.raises(ValueError, match="16-bit"):
        dk.dense_launch(tuple(range(1 << 16)), 1, 1 << 16)


# the stencils of chip_smoke.py's DIA matrices at n = 1,000,000, each word
# staged about once: (word, half-width)
STAGING_CASES = {"banded128-1M float32": (4, 64),
                 "banded64-1M float64": (8, 32),
                 "banded64-1M float32": (4, 32),
                 "banded16-1M float32": (4, 8)}


@pytest.mark.parametrize("case", sorted(STAGING_CASES))
def test_each_word_is_staged_about_once(case):
    word, half = STAGING_CASES[case]
    offs = tuple(range(-half, half))
    n = 1_000_000
    sh = _shape(offs, offs, word, n_out=n)
    st = dk.dense_staging(offs, len(offs), 2 * len(offs) - 1, sh)
    # the useful words of a column range: its A and B words, each once
    assert st["useful_per_range"] == 2 * len(offs) * sh["L"]
    assert st["factor"] == st["per_range"] / st["useful_per_range"]
    assert st["staged_bytes"] == word * st["staged_words"]
    assert 1.0 <= st["factor"] <= 1.25, st
    # the A words once each; B once, but a strip's first window
    assert st["a_words"] == sh["n_ranges"] * len(offs) * sh["L"]
    assert st["b_words"] == (sh["n_ranges"] * sh["L"]
                             + sh["grid_x"] * (len(offs) - 1)) * len(offs)
    if case in ("banded128-1M float32", "banded64-1M float64"):
        # one group and one chunk: every C row of a range over one window
        assert (sh["grid_y"], sh["chunks"]) == (1, 1)
        assert sh["grid_x"] == dk.H100_SMS and sh["blocks_per_sm"] == 1


def _replay_block_kernel(a, b, offs, dcn, n_out, values_only=False, sms=1):
    """csrc/dia_multiply.cu's dense kernel, block by block and thread by
    thread (a row block's threads side by side: they share their control
    flow), on the launch shape of ``dense_launch(..., n_out, sms)``:
    each block's strip of column ranges, chunk by chunk; the ring and the
    A buffers as the kernel's shared memory (NaN where nothing was staged),
    the first range of a chunk staging its whole window and zeroing its
    pad rows, every later one its new columns, the next range's copies
    made BEFORE this range's products; passes of row blocks; the bands in
    groups of up to R, each thread loading whole window rows at its fixed
    positions into registers named by anti-diagonal and slot, all R rows
    where a group starts afresh; a later chunk reading back the sums the
    earlier one stored.  The words' dtype picks the entry: float32
    products are fused into the sum (fmaf), float64 ones rounded, then
    added (madd).  Returns (c, cnt, reloads, staged words, shape)."""
    d1n, n_i = a.shape
    d2n, n_k = b.shape
    dt = a.dtype
    word = dt.itemsize
    vw = 16 // word                     # words a 16-byte piece
    sh = dk.dense_launch(offs, d2n, dcn, word, n_out, sms)
    R = sh["rows"]
    PADR = R - 1
    I, s, L = sh["cols"], sh["s"], sh["L"]
    tc_n, TR = sh["tc_n"], 1 << sh["tr_log2"]
    aw, b_off = sh["a_words"], sh["b_off"]
    a0 = offs[0]
    c = np.full((dcn, n_out), np.nan, dt)
    cnt = np.full((dcn, n_out), np.nan, np.float32)
    ir, ii = np.arange(R)[:, None], np.arange(I)[None, :]
    n_t = R + I - 1                     # anti-diagonals of a register block
    n_v = -(-n_t // vw)                 # 16-byte pieces a window row
    tcs = np.arange(tc_n)
    reloads = staged = 0

    for blk in range(sh["grid_x"] * sh["grid_y"]):
        g, x = blk % sh["grid_y"], blk // sh["grid_y"]
        first = x * sh["strip"]
        if first >= sh["n_ranges"]:
            continue
        nr = min(sh["strip"], sh["n_ranges"] - first)
        rc0 = g * sh["group_rows"]
        rc1 = rc0 + sh["group_rows"]
        smem_ = np.full(sh["stage_words"], np.nan, dt)
        buf = 0
        for kb, ke in dk.dense_chunks(offs, sh["kc"]):
            dlo, dhi = offs[kb] - a0, offs[ke - 1] - a0
            wr0 = max(0, rc0 - dhi)
            wr1 = min(d2n, rc1 - dlo)
            nrows = wr1 - wr0 + 2 * PADR if wr1 > wr0 else 0
            assert nrows <= sh["rows_cap"]
            q = (wr0 - a0 - PADR) % vw

            def stage(n, buf, whole):
                nonlocal staged
                if nrows == 0:
                    return
                i0 = n * L
                i = i0 + np.arange(L)
                for kk in range(ke - kb):
                    smem_[buf * aw + kk * L:buf * aw + (kk + 1) * L] = \
                        np.where(i < n_i, a[kb + kk, np.minimum(i, n_i - 1)],
                                 0)
                staged += (ke - kb) * L
                if whole:               # the pad rows, every position
                    smem_[b_off:b_off + PADR * s] = 0
                    bot = b_off + (nrows - PADR) * s
                    smem_[bot:bot + PADR * s] = 0
                    staged += 2 * PADR * s
                jlo = i0 + a0 + (dlo if whole else dhi)
                ncols = L + dhi - dlo if whole else L
                w, cc = np.meshgrid(np.arange(PADR, nrows - PADR),
                                    np.arange(ncols), indexing="ij")
                k2, j = wr0 - PADR + w, jlo + cc
                assert ((k2 >= 0) & (k2 < d2n)).all()
                ok = (j >= 0) & (j < n_k)
                at = b_off + w * s + (j + w + q) % s
                assert len(np.unique(at)) == at.size
                smem_[at] = np.where(ok, b[k2, np.clip(j, 0, n_k - 1)], 0)
                staged += at.size

            stage(first, buf, True)
            for rng in range(nr):
                if rng + 1 < nr:        # the next range's copies first
                    stage(first + rng + 1, buf ^ 1, False)
                i0 = (first + rng) * L
                consecutive = dhi - dlo == ke - 1 - kb
                for p in range(sh["passes"]):
                    for tr in range(TR):
                        r0 = rc0 + (tr + p * TR) * R
                        if r0 >= dcn:
                            continue
                        col0 = i0 + tcs * I
                        rows = r0 + np.arange(R)
                        cls_ = col0[:, None] + np.arange(I)[None, :]
                        rk, ck = rows < dcn, cls_ < n_out
                        acc = np.zeros((tc_n, R, I), dt)
                        num = np.zeros((tc_n, R, I), np.float32)
                        if kb > 0:      # the sums the earlier chunks stored
                            m = rk[None, :, None] & ck[:, None, :]
                            got_c = c[np.minimum(rows, dcn - 1)[None, :, None],
                                      np.minimum(cls_, n_out - 1)[:, None, :]]
                            got_n = cnt[np.minimum(rows, dcn - 1)[None, :, None],
                                        np.minimum(cls_, n_out - 1)[:, None, :]]
                            acc = np.where(m, got_c, 0).astype(dt)
                            num = np.where(m, got_n, 0).astype(np.float32)
                        if nrows > 0:
                            p0 = col0 + r0 + a0 - wr0 + PADR + q
                            assert (p0 % vw == 0).all()
                            # whole 16-byte pieces at the same positions in
                            # every window row
                            pos = np.concatenate(
                                [((p0 + vw * v) % s)[:, None]
                                 + np.arange(vw)[None, :]
                                 for v in range(n_v)], axis=1)[:, :n_t]
                            bv = np.full((tc_n, n_t, R), np.nan, dt)

                            def load_row(w, slot):
                                bv[:, :, slot] = smem_[b_off + w * s + pos]

                            # the bands that reach the rows: an interval
                            # in a chunk of consecutive offsets
                            k, k_end = kb, ke
                            if consecutive:
                                k = max(kb, kb + r0 - d2n - dlo + 1)
                                k_end = min(ke, kb + r0 + R - dlo)
                                assert all(
                                    (0 < r0 - (offs[j] - a0) + R
                                     and r0 - (offs[j] - a0) < d2n)
                                    == (k <= j < k_end)
                                    for j in range(kb, ke))
                            have, dprev = False, 0
                            while k < k_end:
                                whole = True
                                for u in range(R):
                                    if k >= k_end:
                                        whole = False
                                        break
                                    dl = offs[k] - a0
                                    assert not consecutive or \
                                        dl == dlo + k - kb
                                    k2lo = r0 - dl
                                    inside = k2lo + R > 0 and k2lo < d2n
                                    if u == 0 and not inside:
                                        have, whole = False, None
                                        k += 1
                                        break
                                    assert inside or not consecutive
                                    if u > 0 and (not inside
                                                  or dl != dprev + 1):
                                        whole = False
                                        break
                                    wb = k2lo - wr0 + PADR
                                    assert 0 <= wb and wb + R <= nrows
                                    if u == 0 and not (have
                                                       and dl == dprev + 1):
                                        for r in range(R):
                                            load_row(wb + r, (r - u) % R)
                                        reloads += 1
                                    else:
                                        load_row(wb, (0 - u) % R)
                                    av = smem_[buf * aw + (k - kb) * L
                                               + cls_ - i0]
                                    xv = bv[:, ir + ii, (ir - u) % R]
                                    assert not np.isnan(xv).any()
                                    assert not np.isnan(av).any()
                                    if dt == np.float64:
                                        acc = acc + av[:, None, :] * xv
                                    else:
                                        acc = (acc.astype(np.float64)
                                               + av[:, None, :].astype(
                                                   np.float64) * xv
                                               ).astype(np.float32)
                                    num += (av[:, None, :] != 0) & (xv != 0)
                                    dprev = dl
                                    k += 1
                                if whole is not None:
                                    have = whole
                        m = rk[None, :, None] & ck[:, None, :]
                        tt, rr, iii = np.nonzero(m)
                        c[rows[rr], cls_[tt, iii]] = acc[tt, rr, iii]
                        cnt[rows[rr], cls_[tt, iii]] = num[tt, rr, iii]
                buf ^= 1
    return c, cnt, reloads, staged, sh


def _bands(offs_a, offs_b, n_i, n_k, dtype, zeros=0.2, seed=None):
    rng = np.random.default_rng(n_i * 7 + n_k if seed is None else seed)
    a = rng.standard_normal((len(offs_a), n_i)).astype(dtype)
    b = rng.standard_normal((len(offs_b), n_k)).astype(dtype)
    for x in (a, b):
        z = rng.random(x.shape)
        x[z < zeros] = 0
        if zeros > 0.5:                 # zero-heavy: -0.0 among the zeros
            x[(z >= zeros) & (z < zeros + 0.1)] = -0.0
    return a, b


def _hold_replay(a, b, offs_a, offs_b, n_i, values_only, got_c, got_n):
    dc_list, idx_map = _plan_maps(offs_a, offs_b)
    want_c, want_n = _dia_multiply_torch(
        torch.from_numpy(a), torch.from_numpy(b), offs_a=offs_a,
        idx_map=idx_map, dc_count=len(dc_list), n_out=n_i)
    if a.dtype == np.float64:
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


# SMs the replay's launch shape is made for: 1 puts every column range of
# a row group in one strip (the ring walks them all), 2 cuts them in two
REPLAY_SMS = {"tridiagonal": 1, "stencil 16": 2, "gapped a": 1,
              "gapped wide": 1, "one a band": 2, "rect": 1, "stencil 64": 1}


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
    a, b = _bands(offs_a, offs_b, n_i, n_k, dtype)
    dc_list, _ = _plan_maps(offs_a, offs_b)
    got_c, got_n, reloads, staged, sh = _replay_block_kernel(
        a, b, offs_a, len(dc_list), n_i, values_only, sms=REPLAY_SMS[name])
    assert reloads > 0
    assert staged == dk.dense_staging(offs_a, len(offs_b), len(dc_list),
                                      sh)["staged_words"]
    _hold_replay(a, b, offs_a, offs_b, n_i, values_only, got_c, got_n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,n,sms,smem,zeros,want", [
    # 4 chunks in float64 (sums stored and read back), 2 passes
    ("stencil 128", 131, 1, dk.SMEM_BLOCK, 0.2, None),
    # row groups: 1,000 B bands do not fit one ring
    ("wide b", 600, 2, dk.SMEM_BLOCK, 0.2, "groups"),
    # chunks and groups forced by a small budget, zero-heavy bands of -0.0
    ("stencil 64", 200, 1, 32 * 1024, 0.7, "chunks"),
    ("gapped wide", 300, 2, 20 * 1024, 0.7, "chunks"),
    # every range its own strip: the whole window each time
    ("stencil 16", 700, 132, dk.SMEM_BLOCK, 0.7, None),
    # one band each side: one row block, 64 threads
    ("single", 2_600, 1, dk.SMEM_BLOCK, 0.2, None),
])
def test_block_replay_strips_groups_and_chunks(name, n, sms, smem, zeros,
                                               want, dtype, monkeypatch):
    # a smaller shared-memory budget forces chunks and row groups
    monkeypatch.setattr(dk, "SMEM_BLOCK", smem)
    offs_a, offs_b = QUALIFYING[name]
    a, b = _bands(offs_a, offs_b, n, n, dtype, zeros=zeros)
    dc_list, _ = _plan_maps(offs_a, offs_b)
    for values_only in (False, True):
        got_c, got_n, _r, staged, sh = _replay_block_kernel(
            a, b, offs_a, len(dc_list), n, values_only, sms=sms)
        assert staged == dk.dense_staging(offs_a, len(offs_b), len(dc_list),
                                          sh)["staged_words"]
        _hold_replay(a, b, offs_a, offs_b, n, values_only, got_c, got_n)
    # a strip walks several ranges, or (132 SMs) every range is a strip
    assert (sh["strip"] >= 2) == (sms < 132) and sh["n_ranges"] >= 3
    if want == "groups":
        assert sh["grid_y"] > 1
    if want == "chunks" or (name == "stencil 128" and dtype == np.float64):
        assert sh["chunks"] > 1
    if zeros > 0.5:                     # the products do hit -0.0
        assert (np.signbit(a) & (a == 0)).any()


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
    """csrc/dia_multiply.cu's pairs entry for the bands' word (float32 or
    float64), block by block: pairs_launch's grid at that word, thread t's
    columns i0 + t + PAIR_THREADS * e, the block's row group's consecutive
    rows (A and B read where they lie, zero outside B), each row's
    pairs in table order (two a step in the kernel, added in order: in
    float64 the product rounded, then the sum, as madd does).  An interior
    block (pair_rows without tests) is asserted to need no test.  Returns
    (c, cnt, visits, last_k1, interior) over the replayed blocks' columns
    (NaN / -1 elsewhere): visits counts the products added to each
    element, last_k1 asserts that they come in ascending A band."""
    d1n, n_i = a.shape
    _d2n, n_k = b.shape
    word = a.dtype.itemsize
    dc_list, _ = _plan_maps(offs_a, offs_b)
    row_ptr, trip = dk.pair_table(offs_a, offs_b, dc_list)
    dcn = len(dc_list)
    sh = dk.pairs_launch(d1n, dcn, len(trip), n_out, word)
    L, T, E, gy = sh["L"], sh["threads"], sh["cols"], sh["grid_y"]
    assert L == T * E and sh["word"] == word
    with open(dk.SOURCE) as f:              # the .cu's constants
        src = f.read()
    assert f"constexpr int PAIR_THREADS = {T};" in src
    assert f"constexpr int PAIR_COLS = {E};" in src
    c = np.full((dcn, n_out), np.nan, a.dtype)
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
        for by in range(gy):                # consecutive rows a group
            for r in range(by * dcn // gy, (by + 1) * dcn // gy):
                acc = np.zeros((T, E), a.dtype)
                num = np.zeros((T, E), np.float32)
                last = np.full((T, E), -1)
                for p in range(row_ptr[r], row_ptr[r + 1]):
                    k1, k2, d1 = (int(x) for x in trip[p])
                    j = cols + d1
                    ok = col_ok & (j >= 0) & (j < n_k)
                    if inner:
                        assert ok.all()
                    av = a[k1, np.clip(cols, 0, n_i - 1)]
                    bv = b[k2, np.clip(j, 0, n_k - 1)]
                    acc = np.where(ok, (acc + av * bv).astype(a.dtype),
                                   acc)
                    num += ok & (av != 0) & (bv != 0)
                    assert (last[ok] < k1).all()
                    last[ok] = k1
                    visits[r, cols[ok]] += 1
                c[r, cols[col_ok]] = acc[col_ok]
                cnt[r, cols[col_ok]] = num[col_ok]
                written[r, cols[col_ok]] += 1
    return c, cnt, visits, written, interior


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,offs_a,offs_b,n_i,n_k", [
    ("pairbands", PAIRBANDS, PAIRBANDS, 5_003, 5_003),
    ("gapped", (0, 2, 4), (-3, -2, -1, 0), 2_100, 2_100),
    ("rect", (-1, 0, 1, 2), (-2, -1, 0), 3_001, 2_500),
    ("near +-n", (-1200, 0, 1197), (-1200, 0, 1197), 1_201, 1_201),
])
def test_pairs_replay_visits_each_product_once_in_band_order(
        name, offs_a, offs_b, n_i, n_k, dtype):
    rng = np.random.default_rng(n_i + n_k)
    a = rng.standard_normal((len(offs_a), n_i)).astype(dtype)
    b = rng.standard_normal((len(offs_b), n_k)).astype(dtype)
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
    if dtype == np.float64:
        # madd rounds as the plain version does, in its order: bit for bit
        assert np.array_equal(c.view(np.int64), want_c.numpy().view(np.int64))
    else:
        np.testing.assert_allclose(c, want_c.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt, want_n.numpy())
    if name == "pairbands":
        # the column ranges 1,201 in from either end run untested
        sh = dk.pairs_launch(len(offs_a), len(dc_list), len(offs_a) ** 2,
                             n_i, a.dtype.itemsize)
        assert sh["L"] == 1024
        assert interior == [False, False, True, False, False]


def test_pairs_launch_shape_at_pairbands_x1000():
    # the pairbands offsets blown out 1000x: a span of 2.4 M columns, more
    # than n; no block is interior, every block tests its columns
    wide = tuple(o * 1000 for o in PAIRBANDS)
    n = 1_500_007
    dc_list, _ = _plan_maps(wide, wide)
    assert dk.dia_mode(wide, wide, dc_list) == "pairs"
    sh = dk.pairs_launch(len(wide), len(dc_list), len(wide) ** 2, n)
    L = dk.PAIR_THREADS * dk.PAIR_COLS
    assert sh["grid_x"] == -(-n // L) and sh["grid_y"] == 10
    assert sh["stage_tables"]
    assert sh["smem_bytes"] == 4 * (len(dc_list) + 1 + 3 * len(wide) ** 2)
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
    assert cols.sum() == 3 * L + (n - (sh["grid_x"] - 1) * L)
    np.testing.assert_allclose(c[:, cols], want_c.numpy()[:, cols],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt[:, cols], want_n.numpy()[:, cols])


@pytest.mark.parametrize("word", [4, 8])
@pytest.mark.parametrize("d1n,dcn,n_pairs,n_out,stage_tables", [
    (10, 30, 100, 500_000, True),           # pairbands-500k
    (20, 40, 40, 200_003, True),
    (40, 80, 80, 3_001, True),
    (300, 937, 12_000, 3_001, False),       # the tables past the budget
    (1, 1, 1, 1, True),
])
def test_pairs_launch_stages_what_fits(d1n, dcn, n_pairs, n_out,
                                       stage_tables, word):
    # the tables where they fit in 48 KB; A and B are read where they lie
    sh = dk.pairs_launch(d1n, dcn, n_pairs, n_out, word)
    assert sh["stage_tables"] == stage_tables
    assert sh["smem_bytes"] == (4 * (dcn + 1 + 3 * n_pairs)
                                if stage_tables else 0)
    assert sh["smem_bytes"] <= dk.PAIR_TABLE_BUDGET <= 48 * 1024
    assert sh["word"] == word
    assert sh["L"] == sh["threads"] * sh["cols"] == (
        dk.PAIR_THREADS * dk.PAIR_COLS)
    assert sh["grid_x"] * sh["L"] >= n_out > (sh["grid_x"] - 1) * sh["L"]
    assert 1 <= sh["grid_y"] <= dcn
    assert sh["grid_x"] * sh["grid_y"] >= min(dk.PAIRS_MIN_BLOCKS,
                                              sh["grid_x"] * dcn)
    # groups of at most group_rows rows; fewer only for the block count
    assert sh["grid_y"] >= -(-dcn // dk.PAIR_GROUP_ROWS)
    if sh["grid_x"] >= dk.PAIRS_MIN_BLOCKS:
        assert sh["grid_y"] == -(-dcn // dk.PAIR_GROUP_ROWS)
    with pytest.raises(ValueError):
        dk.pairs_launch(0, dcn, n_pairs, n_out)
    with pytest.raises(ValueError):
        dk.pairs_launch(d1n, dcn, n_pairs, n_out, 2)


def test_pairs_launch_at_pairbands_500k_float64():
    # pairbands-500k at 8 bytes a word: 1,024 columns a block, ten groups
    # of three C rows each, the tables staged
    offs = PAIRBANDS
    dc_list, _ = _plan_maps(offs, offs)
    n = 500_000
    L = dk.PAIR_THREADS * dk.PAIR_COLS
    sh = dk.pairs_launch(len(offs), len(dc_list), len(offs) ** 2, n, 8)
    assert (L, sh["L"]) == (1024, 1024)
    assert sh["grid_x"] == -(-n // L) and sh["grid_y"] == 10
    assert -(-len(dc_list) // sh["grid_y"]) == dk.PAIR_GROUP_ROWS == 3
    assert sh["stage_tables"]
    assert sh["smem_bytes"] == 4 * (len(dc_list) + 1 + 3 * len(offs) ** 2)


def _f64_case(kind):
    """(a, b, offs_a, offs_b, n) float64 bands for the bit-equality cases."""
    rng = np.random.default_rng(len(kind))
    if kind == "edges":
        offs_a, offs_b, n = (-700, -3, 0, 5, 900), (-2, 0, 2), 5 * 1_024 + 77
    elif kind == "uneven row groups":
        offs_a, offs_b, n = tuple(range(0, 60, 3)), (0, 1), 20_011
    else:                                   # -0.0 and zero-heavy
        offs_a, offs_b, n = PAIRBANDS, (-600, -1, 0, 1, 601), 4_099
    a = rng.standard_normal((len(offs_a), n))
    b = rng.standard_normal((len(offs_b), n))
    if kind == "zeros":
        for x in (a, b):
            z = rng.random(x.shape)
            x[z < 0.7] = 0.0
            x[(z >= 0.7) & (z < 0.8)] = -0.0
        a[:, : n // 3] = -0.0               # whole runs of -0.0 products
    return a, b, offs_a, offs_b, n


@pytest.mark.parametrize("values_only", [False, True])
@pytest.mark.parametrize("kind", ["edges", "uneven row groups", "zeros"])
def test_pairs_replay_float64_bit_equal(kind, values_only):
    a, b, offs_a, offs_b, n = _f64_case(kind)
    dc_list, idx_map = _plan_maps(offs_a, offs_b)
    sh = dk.pairs_launch(len(offs_a), len(dc_list),
                         len(offs_a) * len(offs_b), n, 8)
    c, cnt, _v, written, interior = _replay_pairs_kernel(a, b, offs_a,
                                                         offs_b, n)
    assert (written == 1).all()
    if kind == "edges":                     # both ends test, the rest not
        assert not interior[0] and not interior[-1] and any(interior)
    if kind == "uneven row groups":         # 40 C rows in 14 groups
        assert (len(dc_list), sh["grid_y"]) == (40, 14)
    want_c, want_n = _dia_multiply_torch(
        torch.from_numpy(a), torch.from_numpy(b), offs_a=offs_a,
        idx_map=idx_map, dc_count=len(dc_list), n_out=n,
        values_only=values_only)
    assert want_c.dtype == torch.float64
    assert np.array_equal(c.view(np.int64), want_c.numpy().view(np.int64))
    if kind == "zeros":                     # the products do hit -0.0
        assert (np.signbit(a) & (a == 0)).any()
        assert (c == 0).any()
    if not values_only:
        np.testing.assert_array_equal(cnt, want_n.numpy())


@pytest.mark.parametrize("word", [4, 8])
def test_k4_split_pair_cols_builds_cut_one_place_each(word):
    # bench/k4_split.py builds the pairs entries with PAIR_COLS changed (one
    # line for both words): the line must occur once and name the columns
    # pairs_launch reads, and each build's launch shape follows its columns
    from pem_spgemm_tpu_torch.bench import k4_split
    with open(dk.SOURCE) as f:
        text = f.read()
    assert dk.PAIR_COLS in k4_split.PAIR_COLS[word]
    line = k4_split.PAIR_COLS_LINE
    assert line.split()[2] == "PAIR_COLS"
    assert text.count(line.format(dk.PAIR_COLS)) == 1
    shape = dk.pairs_launch(10, 30, 100, 500_000, word)
    for cols in k4_split.PAIR_COLS[word]:
        sh = k4_split.pairs_variant(shape, cols, 500_000)
        assert sh["L"] == dk.PAIR_THREADS * cols and sh["cols"] == cols
        assert sh["grid_x"] * sh["L"] >= 500_000 > (sh["grid_x"] - 1) * \
            sh["L"]
        assert sh["grid_y"] == shape["grid_y"] == 10
