"""The Tile16 structure kernels (csrc/tile16_structure.cu: ``tile16_c_masks``,
``tile16_c_rowcol``) and the Tile16 kernel's masks form
(csrc/tile16_accumulate.cu, ``MASKS``), on the CPU.

The kernels run only on the card (the test marked ``cuda`` holds them
against their plain versions there and skips here).  What the CPU can hold:

  * each kernel's warp algorithm replayed in numpy, lane by lane, against
    the plain version the CPU runs: ``tile16_c_masks``'s per-row OR over a
    tile's pairs (indices passed by shuffles in batches of 16, B's column
    masks by shuffles) and its popc reduction; ``tile16_c_rowcol``'s
    span of tiles a block, their slots given to the threads in order (tile
    and row by binary searches over staged counts, column by a
    rank-select) and its grid-stride padding; the masks form's four-lane OR of the count bits
    of rows g, g + 8 and its popc sum over the eight quads.  Streams with empty
    tiles, a tile of one pair, a tile with all 256 bits, more than 16
    pairs a tile, padding at c_cap and at INT32_MAX, real pairs past c_cap
    (a plan's overflow), c_nnz_cap above, at and below C_nnz;
  * the dispatch: CPU tensors take the plain versions (no launch counted),
    and ``c_rowcol_values`` is ``c_rowcol`` plus ``extract_values``;
  * the source against the ctypes declarations and the wrapper's checks.

Against the JAX package: tests/test_torch_tile16.py (the plain versions of
``accumulate_fused_masks``, ``c_rowcol_values`` and ``segment_offsets``).
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from pem_spgemm_tpu_torch.ops import cstruct, numeric
from pem_spgemm_tpu_torch.ops import tile16_kernels as tk
from pem_spgemm_tpu_torch.ops.macro_kernels import segment_offsets

CPU = torch.device("cpu")
INT32_MAX = 0x7FFFFFFF
CHUNK = 8


def _source():
    with open(tk.STRUCT_SOURCE) as f:
        return f.read()


def _cu_int(name):
    """An int constexpr of csrc/tile16_structure.cu, read from the source."""
    m = re.search(rf"constexpr int {name} = (\d+);", _source())
    return int(m.group(1))


def _popc(x):
    return bin(int(x) & 0xFFFFFFFF).count("1")


def _half_sum(vals):
    """The butterfly sum of 16 lanes (__shfl_xor_sync at 8, 4, 2, 1, width
    16): every lane ends with the sum."""
    v = list(vals)
    for off in (8, 4, 2, 1):
        v = [v[r] + v[r ^ off] for r in range(16)]
    assert len(set(v)) == 1
    return v[0]


def _masks_table(rs, n):
    """(n, 16) int32 bitmaps: sparse rows, a full row, an empty tile."""
    m = rs.integers(0, 1 << 16, (n, 16)) & rs.integers(0, 1 << 16, (n, 16))
    m[rs.random((n, 16)) < 0.4] = 0
    m[0, 3] = 0xFFFF
    m[n - 1] = 0
    return m.astype(np.int32)


def _stream(rs, n_a, n_b, tiles, pad, overflow=0):
    """A pair stream sorted by C tile over ``tiles`` C tiles: tile 1 has no
    pairs, tile 2 one pair (A tile 0, B tile 0: A's full row meets every
    column B has), tile 4 has 37 pairs (three batches of indices), the
    others 1-4; then ``overflow`` more tiles of real pairs (ids past the
    caller's c_cap); padded with ``pad`` to a multiple of CHUNK (A and B
    index one past their tables, as the pair expansion's padding)."""
    counts = {1: 0, 2: 1, 4: 37}
    seg = [c for c in range(tiles + overflow)
           for _ in range(counts.get(c, int(rs.integers(1, 5))))]
    n = len(seg)
    p_cap = -(-(n + 5) // CHUNK) * CHUNK
    a_idx = np.full(p_cap, n_a, np.int32)
    b_idx = np.full(p_cap, n_b, np.int32)
    s = np.full(p_cap, pad, np.int64)
    a_idx[:n] = rs.integers(0, n_a, n)
    b_idx[:n] = rs.integers(0, n_b, n)
    first = seg.index(2)
    a_idx[first], b_idx[first] = 0, 0
    s[:n] = seg
    return a_idx, b_idx, s.astype(np.int32)


# --------------------------------------------------------------------------
# tile16_c_masks, replayed

def replay_c_masks(a_masks, b_tmasks, a_idx, b_idx, seg_ptr, c_cap):
    """tile16_c_masks as the kernel runs it: a half-warp a C tile, lane r
    its row; pair indices loaded 16 at a time, one a lane, and shuffled
    from lane k; lane r loads A's row mask r and B's column mask r, and
    takes column j's mask from lane j; row words stored once, the tile's
    popc by a butterfly over the half-warp."""
    n_a, n_b = a_masks.shape[0], b_tmasks.shape[0]
    cmask = np.zeros((c_cap, 16), np.int64)
    nnz = np.zeros(c_cap, np.int64)
    for c in range(c_cap):
        lo, hi = int(seg_ptr[c]), int(seg_ptr[c + 1])
        row = [0] * 16
        for base in range(lo, hi, 16):
            bat_a = [int(a_idx[base + r]) if base + r < hi else 0
                     for r in range(16)]
            bat_b = [int(b_idx[base + r]) if base + r < hi else 0
                     for r in range(16)]
            for k in range(min(16, hi - base)):
                ai = min(max(bat_a[k], 0), n_a - 1)
                bi = min(max(bat_b[k], 0), n_b - 1)
                am = [int(a_masks[ai, r]) for r in range(16)]
                bt = [int(b_tmasks[bi, r]) for r in range(16)]
                for r in range(16):
                    for j in range(16):
                        row[r] |= int((am[r] & bt[j]) != 0) << j
        cmask[c] = row
        nnz[c] = _half_sum([_popc(w) for w in row])
    return cmask, nnz


@pytest.mark.parametrize("pad", ["int32_max", "c_cap", "overflow"])
def test_c_masks_replay_equals_the_plain_version(pad):
    """The replay against ``c_masks_plain`` (the JAX package's algorithm):
    masks, the nnz scan and the tiles' pair offsets, on a stream padded
    as the one-card expansion pads it (INT32_MAX), as the ring pads it
    (c_cap), and with real pairs past c_cap; c_cap above the stream's
    tiles leaves zero tiles with the sentinel coordinates."""
    rs = np.random.default_rng({"int32_max": 0, "c_cap": 1,
                                "overflow": 2}[pad])
    n_a, n_b, tiles = 9, 7, 11
    c_cap = tiles + (0 if pad == "overflow" else 5)
    a_m, b_t = _masks_table(rs, n_a), _masks_table(rs, n_b)
    a_idx, b_idx, seg = _stream(rs, n_a, n_b, tiles,
                                c_cap if pad == "c_cap" else INT32_MAX,
                                overflow=3 if pad == "overflow" else 0)
    # the pair expansion gives every pair C tile coordinates; padding
    # pairs carry the sentinel
    c_row = np.where(seg < INT32_MAX, seg // 3, INT32_MAX).astype(np.int32)
    c_col = np.where(seg < INT32_MAX, seg % 3, INT32_MAX).astype(np.int32)
    t = [torch.from_numpy(x) for x in (a_m, b_t, a_idx, b_idx, seg, c_row,
                                       c_col)]
    tk.reset_launch_counts()
    got = cstruct.c_masks(*t, c_cap)
    want = cstruct.c_masks_plain(*t, c_cap)
    assert all(v == 0 for v in tk.LAUNCHES.values())   # the plain version
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ctr, ctc, cmask, cptr, pair_ptr = want
    seg_ptr = segment_offsets(t[4], c_cap)
    assert torch.equal(seg_ptr, pair_ptr)               # pair_ptr is it
    r_mask, r_nnz = replay_c_masks(a_m, b_t, a_idx, b_idx, seg_ptr.numpy(),
                                   c_cap)
    np.testing.assert_array_equal(r_mask, cmask.numpy())
    np.testing.assert_array_equal(
        np.concatenate([[0], np.cumsum(r_nnz)]), cptr.numpy())
    assert not cmask[1].any()
    assert int(cmask[2, 3]) == sum(1 << j for j in range(16) if b_t[0, j])
    if pad != "overflow":
        assert not cmask[tiles:].any()
        assert (ctr[tiles:] == INT32_MAX).all()
        assert (ctc[tiles:] == INT32_MAX).all()


# --------------------------------------------------------------------------
# tile16_c_rowcol, replayed

def replay_c_rowcol(cmask, cptr, c_nnz_cap, c_dense=None, writes=None):
    """tile16_c_rowcol as the kernel runs it: block b (256 threads) takes
    the SPAN tiles from b * SPAN; it stages their row words, each tile's
    bits above each row (a quad of threads a tile, 4 rows a thread, an
    exclusive shuffle scan over the quad) and their first slots (cptr);
    thread t writes the span's slots first + t + 256 (AHEAD i + a), below
    the span's end and c_nnz_cap: the slot's tile (the last whose first
    slot is <= it, a binary search of SPAN / 2, ..., 1 steps), row (the
    last whose bits above are <= its rank k, steps 8, 4, 2, 1) and column
    (the rank's set bit of the row word, a 4-step popc rank-select); then
    every thread of the grid writes padding slots from cptr[c_cap],
    grid-stride: the last row of the last tile, column 0, and that entry's
    value.  ``writes``: a list that gets (slot, tile, (block, thread),
    its slot count in the thread) of every tile slot written."""
    span, ahead = _cu_int("SPAN"), _cu_int("AHEAD")
    c_cap = cmask.shape[0]
    rowcol = np.full(c_nnz_cap, -1, np.int64)
    elem = np.full(c_nnz_cap, -1, np.int64)
    vals = None if c_dense is None else np.zeros(c_nnz_cap, c_dense.dtype)
    flat = None if c_dense is None else c_dense.reshape(-1)
    blocks = -(-c_cap // span)

    def select_bit(w, j):
        col = 0
        for step in (8, 4, 2, 1):
            low = _popc(w & ((1 << step) - 1))
            if low <= j:
                j -= low
                w >>= step
                col += step
        return col

    for b in range(blocks):
        c0 = b * span
        n_t = min(span, c_cap - c0)
        rows = [[int(cmask[c0 + tt, r]) & 0xFFFF if tt < n_t else 0
                 for r in range(16)] for tt in range(span)]
        first = [int(cptr[c0 + min(t, n_t)]) for t in range(span + 1)]
        before = [[0] * 16 for _ in range(span)]
        for q in range(span * 4):               # quads: a tile's 4 threads
            tt, r0 = q >> 2, 4 * (q & 3)
            sums = [sum(_popc(rows[tt][4 * x + j]) for j in range(4))
                    for x in range(4)]
            run = sum(sums[:q & 3])             # the quad's exclusive scan
            for j in range(4):
                before[tt][r0 + j] = run
                run += _popc(rows[tt][r0 + j])
        s0, s_end = first[0], min(first[n_t], c_nnz_cap)
        for t in range(256):
            for i, base in enumerate(range(s0 + t, s_end, 256 * ahead)):
                for a in range(ahead):
                    slot = base + 256 * a
                    if slot >= s_end:
                        continue
                    tt = 0
                    step = span // 2
                    while step:
                        if tt + step < n_t and first[tt + step] <= slot:
                            tt += step
                        step >>= 1
                    k = slot - first[tt]
                    r = 0
                    for step in (8, 4, 2, 1):
                        if before[tt][r + step] <= k:
                            r += step
                    rc = (r << 4) | select_bit(rows[tt][r], k - before[tt][r])
                    rowcol[slot] = rc
                    elem[slot] = c0 + tt
                    if vals is not None:
                        vals[slot] = flat[(c0 + tt) * 256 + rc]
                    if writes is not None:
                        writes.append((slot, c0 + tt, (b, t), ahead * i + a))
    threads = blocks * 256
    for tid in range(threads):
        s = int(cptr[c_cap]) + tid
        while s < c_nnz_cap:
            rowcol[s], elem[s] = (15 << 4) | 0, c_cap - 1
            if vals is not None:
                vals[s] = flat[(c_cap - 1) * 256 + 240]
            s += threads
    return rowcol, elem, vals


def _rowcol_case(rs, c_cap):
    """Row masks with empty rows and tiles, one tile of all 256 bits, rows
    and a tile of one bit, the last tile's last row set, and values with
    -0.0, NaN and +-Inf."""
    m = _masks_table(rs, c_cap)
    m[2] = 0xFFFF
    m[5, :] = 0
    m[5, 7] = 0x0100                        # a tile of one bit
    m[6, :] = 0
    m[6, 0], m[6, 15] = 0x8000, 0x0001      # rows of one bit, a tile of two
    m[c_cap - 1, 15] = 0x8001
    vals = rs.standard_normal((c_cap, 256))
    vals[0, :4] = [-0.0, np.nan, np.inf, -np.inf]
    vals[c_cap - 1, 240] = -0.0
    cptr = np.concatenate([[0], np.cumsum(
        [sum(_popc(x) for x in row) for row in m])]).astype(np.int32)
    return m, cptr, vals


@pytest.mark.parametrize("room", ["padding", "exact", "overflow"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_c_rowcol_replay_equals_the_plain_version(room, dtype):
    """The replay against ``c_rowcol_plain`` and ``extract_values`` (the
    JAX package's algorithms), bit for bit, padding slots included, with
    c_nnz_cap above, at and below C_nnz (a plan's overflow: the slots
    there are C's first entries)."""
    rs = np.random.default_rng(5)
    c_cap = 13
    m, cptr, vals = _rowcol_case(rs, c_cap)
    c_nnz = int(cptr[-1])
    cap = {"padding": c_nnz + 300, "exact": c_nnz,
           "overflow": c_nnz - 40}[room]
    vals = vals.astype(dtype)
    tm, tp = torch.from_numpy(m), torch.from_numpy(cptr)
    tv = torch.from_numpy(vals)
    tk.reset_launch_counts()
    rc, et = cstruct.c_rowcol(tm, tp, cap)
    rc2, et2, cv = cstruct.c_rowcol_values(tm, tp, cap, tv)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    want_rc, want_et = cstruct.c_rowcol_plain(tm, tp, cap)
    want_v = numeric.extract_values(tv, want_rc, want_et)
    for g, w in ((rc, want_rc), (et, want_et), (rc2, want_rc),
                 (et2, want_et)):
        assert torch.equal(g, w)
    assert torch.equal(cv.view(torch.int64 if dtype == np.float64
                               else torch.int32),
                       want_v.view(torch.int64 if dtype == np.float64
                                   else torch.int32))
    r_rc, r_et, r_v = replay_c_rowcol(m, cptr, cap, vals)
    np.testing.assert_array_equal(r_rc, want_rc.numpy())
    np.testing.assert_array_equal(r_et, want_et.numpy())
    np.testing.assert_array_equal(r_v.view(np.uint8),
                                  want_v.numpy().view(np.uint8))
    if room == "padding":
        assert (r_rc[c_nnz:] == 240).all() and (r_et[c_nnz:] == c_cap - 1).all()
        assert np.signbit(r_v[c_nnz:]).all()            # entry (last, 15, 0)


@pytest.mark.parametrize("room", ["padding", "overflow"])
def test_c_rowcol_lanes_write_their_slots_in_order(room):
    """The slot-to-thread map of tile16_c_rowcol: every slot below C_nnz
    and c_nnz_cap is written once, by one thread of the block whose span
    holds its tile; thread t's n-th slot is its span's first + t + 256 n,
    so the 32 lanes of a warp write 32 consecutive slots (every lane busy
    but at a span's end), across tile boundaries; a slot's row and column
    are its rank among its tile's bits; the padding is as before: the last
    row of the last tile, column 0.  With 300 tiles the spans cut tiles of
    0, 1, 2 and 256 bits and more than one block."""
    rs = np.random.default_rng(9)
    c_cap = 300
    m, cptr, vals = _rowcol_case(rs, c_cap)
    c_nnz = int(cptr[-1])
    cap = c_nnz + 50 if room == "padding" else c_nnz - 40
    writes = []
    rc, et, _v = replay_c_rowcol(m, cptr, cap, vals, writes=writes)
    span = _cu_int("SPAN")
    slots = [w[0] for w in writes]
    assert sorted(slots) == list(range(min(c_nnz, cap)))    # each once
    firsts = {}
    for slot, c, (b, t), n in writes:
        assert c // span == b                   # the span holding its tile
        s0 = int(cptr[b * span])
        assert slot == s0 + t + 256 * n
        firsts.setdefault((b, n, t // 32), []).append((t % 32, slot))
    whole = 0
    for ls in firsts.values():                  # a warp's store: one run
        ls.sort()
        assert [s_ for _, s_ in ls] == list(range(ls[0][1],
                                                  ls[0][1] + len(ls)))
        assert [lane for lane, _ in ls] == list(range(len(ls)))
        whole += len(ls) == 32
    assert whole > 0.8 * len(firsts)
    assert len({b for _s, _c, (b, _t), _n in writes}) > 1
    assert cptr[3] - cptr[2] == 256
    assert cptr[6] - cptr[5] == 1 and rc[cptr[5]] == (7 << 4) | 8
    assert cptr[7] - cptr[6] == 2
    assert rc[cptr[6]] == 15 and rc[cptr[6] + 1] == 15 << 4
    for c in range(c_cap):                                  # rank order
        bits = [(r << 4) | col for r in range(16) for col in range(16)
                if int(m[c, r]) >> col & 1]
        lo, hi = int(cptr[c]), min(int(cptr[c + 1]), cap)
        if lo < hi:
            assert rc[lo:hi].tolist() == bits[:hi - lo]
            assert (et[lo:hi] == c).all()
    if room == "padding":
        assert (rc[c_nnz:] == 240).all() and (et[c_nnz:] == c_cap - 1).all()


# --------------------------------------------------------------------------
# the Tile16 kernel's masks form, replayed

def _lane_counts(a, b):
    """(16, 16) structural counts of one pair as the kernel forms them: the
    product of the 0/1 words of the raw values (x != 0), exact small
    integers (its tensor-core pass is replayed lane by lane in
    tests/test_torch_tile16_kernel.py)."""
    return (a != 0).astype(np.int64) @ (b != 0).astype(np.int64)


def replay_masks_form(cnt):
    """The masks form's store from a tile's counts: lane L = 4g + t owns
    rows g, g + 8 and columns 4t .. 4t + 3; it sets bit 4t + j of its row
    words where its count is > 0, ORs in lanes L ^ 1 and L ^ 2 (the quad
    of a row pair), lane 4g stores row g and lane 4g + 1 row g + 8; the
    quad's first lane's popc, summed over the eight quads by
    __shfl_xor_sync at 4, 8, 16, is the tile's nnz."""
    w = np.zeros((32, 2), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(2):
            for j in range(4):
                w[lane, i] |= int(cnt[g + 8 * i, 4 * t + j] > 0) \
                    << (4 * t + j)
    for off in (1, 2):
        w = w | w[[lane ^ off for lane in range(32)]]
    rows = np.zeros(16, np.int64)
    pc = np.zeros(32, np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        if t < 2:
            rows[g + 8 * t] = w[lane, t]
        if t == 0:
            pc[lane] = _popc(w[lane, 0]) + _popc(w[lane, 1])
    for off in (4, 8, 16):
        pc = pc + pc[[lane ^ off for lane in range(32)]]
    # the quads' first lanes hold the sum (lane 0 stores it), the others 0
    assert len(set(pc[0::4].tolist())) == 1 and not pc[1::4].any()
    return rows, int(pc[0])


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_masks_form_replay_equals_counts_to_masks(precision):
    """The masks form's replay, from the counts the kernel's lanes form on
    the raw tables (with -0.0, NaN, +-Inf and subnormals), against
    ``fused_masks_plain`` (``fused_flat_plain`` then ``counts_to_masks``)
    on a stream with empty tiles and padding; at "default" the values are
    rounded but the pattern is the raw tables', as the kernel takes it from
    the raw values it holds in registers."""
    rs = np.random.default_rng(7)
    n_a, n_b, tiles, c_cap = 6, 5, 7, 9
    a = rs.standard_normal((n_a + 1, 16, 16)).astype(np.float32)
    b = rs.standard_normal((n_b + 1, 16, 16)).astype(np.float32)
    for x in (a, b):
        u = rs.random(x.shape)
        x[u < 0.5] = 0.0
        x[(u >= 0.5) & (u < 0.55)] = -0.0
    a[1, 2, 3], a[2, 5, 0], b[3, 4, 4] = np.nan, np.inf, -np.inf
    a[3, 1, 1] = 1e-40                                  # subnormal
    a[n_a], b[n_b] = 0.0, 0.0                           # the zero tiles
    a_idx, b_idx, seg = _stream(rs, n_a, n_b, tiles, INT32_MAX)
    ta, tb = torch.from_numpy(a.reshape(-1, 256)), torch.from_numpy(
        b.reshape(-1, 256))
    args = (torch.from_numpy(a_idx), torch.from_numpy(b_idx),
            torch.from_numpy(seg), c_cap, CHUNK)
    tk.reset_launch_counts()
    c_dense, cmask, cptr = numeric.accumulate_fused_masks(
        ta, tb, *args, precision=precision)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    want_d, want_c = numeric.fused_flat_plain(ta, tb, *args,
                                              precision=precision)
    want_m, want_p = numeric.counts_to_masks(want_c)
    assert torch.equal(cmask, want_m) and torch.equal(cptr, want_p)
    assert torch.equal(c_dense.view(torch.int32), want_d.view(torch.int32))
    seg_ptr = segment_offsets(args[2], c_cap).numpy()
    nnz = []
    for c in range(c_cap):
        cnt = np.zeros((16, 16), np.int64)
        for p in range(seg_ptr[c], seg_ptr[c + 1]):
            cnt += _lane_counts(a[a_idx[p]], b[b_idx[p]])
        rows, n = replay_masks_form(cnt)
        np.testing.assert_array_equal(rows, cmask[c].numpy())
        nnz.append(n)
    np.testing.assert_array_equal(np.concatenate([[0], np.cumsum(nnz)]),
                                  cptr.numpy())


# --------------------------------------------------------------------------
# the source, the loader and the wrappers

def test_structure_source_and_loader_agree():
    src = _source()
    for banned in ("torch/extension.h", "cub/", "thrust"):
        assert banned not in src.lower()
    assert re.search(r"\batomic[A-Z]\w*\(", src) is None     # no atomics
    assert "constexpr int TILES = 16;" in src
    assert "__shfl_up_sync" in src
    assert "__ffs(" not in src                # slots in order, not by row
    assert "const int low = __popc(w & ((1u << step) - 1u));" in src
    for line in (
            "const long long c0 = (long long)blockIdx.x * SPAN;",
            "if (t <= SPAN) first[t] = cptr[c0 + min(t, n_t)];",
            "const int x = __shfl_up_sync(0xffffffffu, incl, off, 4);",
            "for (int base = s0 + t; base < s_end; base += THREADS * AHEAD)",
            "if (tt + step < n_t && first[tt + step] <= slot) tt += step;",
            "if (before[tt][r + step] <= k) r += step;",
            "rc[a] = (r << 4) | select_bit(rows[tt][r], k - before[tt][r]);"):
        assert src.count(line) == 1, line
    assert src.count("blocks_of(c_cap, SPAN)") == 2
    assert src.count("const int slot = base + a * THREADS;") == 2

    class Lib:
        pass

    lib = Lib()
    entries = ("tile16_c_masks", "tile16_c_rowcol")
    for e in entries:
        setattr(lib, e, Lib())
    tk._declare_structure(lib)
    for e in entries:
        assert f'extern "C" int {e}(' in src
        params = src.split(f'extern "C" int {e}(')[1].split(")")[0]
        fn = getattr(lib, e)
        assert len(fn.argtypes) == params.count(",") + 1, e
        assert fn.restype is ctypes.c_int
    acc = open(tk.SOURCE).read()
    assert "F == Form::MASKS" in acc \
        and "__shfl_xor_sync(FULL, w[i], 1)" in acc \
        and "__shfl_xor_sync(FULL, w[i], 2)" in acc
    assert "c_mask + c * 16 + g + 8 * t" in acc
    assert "for (int off = 4; off < 32; off <<= 1)" in acc


def test_rowcol_cut_builds_cut_one_place_each():
    # bench/k4_split.py times tile16_c_rowcol at other ROUNDS, each a text
    # substitution of the source
    from pem_spgemm_tpu_torch.bench import k4_split
    src = _source()
    for name, cuts in k4_split.ROWCOL_CUTS.items():
        for old, new in cuts:
            assert src.count(old) == 1 and new != old, name


def test_structure_wrappers_refuse_cpu_tensors_and_bad_arguments():
    m = torch.zeros((4, 16), dtype=torch.int32)
    cptr = torch.zeros(5, dtype=torch.int32)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="c_masks_plain"):
        tk.c_masks(m, m, idx, idx, idx, 4)
    with pytest.raises(ValueError, match="c_rowcol_plain"):
        tk.c_rowcol(m, cptr, 16)
    tk._check_int32(m, "cmask", CPU, 16)
    tk._check_int32(cptr, "cptr", CPU)
    for bad in (m.long(), m[:, :8].contiguous(), m.t().contiguous().t(),
                m[:0]):
        with pytest.raises(ValueError, match="int32"):
            tk._check_int32(bad, "cmask", CPU, 16)
    with pytest.raises(ValueError, match="int32"):
        tk._check_int32(m, "cptr", CPU)
    with pytest.raises(ValueError, match="int32"):
        tk._check_int32([0, 1], "cptr", CPU)


# --------------------------------------------------------------------------
# on the card

@pytest.mark.cuda
def test_structure_kernels_match_the_plain_versions_on_the_card():
    """The three entries against their plain versions on the card, bit for
    bit, and each launch counted: c_masks (masks, cptr, pair_ptr, tile
    coordinates) on streams padded at INT32_MAX and at c_cap; c_rowcol
    without and with float32 / float64 values (padding slots included);
    the masks form in float32 at "highest" and "default", float64 and
    bfloat16 against the counts form and ``counts_to_masks``, its values
    bit-equal to the counts form's; two launches of each bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the structure kernels have no CPU "
                    "form (python3 chip_smoke.py --only tile16_path holds "
                    "them at full size)")
    dev = torch.device("cuda")
    rs = np.random.default_rng(11)
    n_a, n_b, tiles = 9, 7, 11
    a_m, b_t = _masks_table(rs, n_a), _masks_table(rs, n_b)
    for pad in ("int32_max", "c_cap"):
        c_cap = tiles + 5
        a_idx, b_idx, seg = _stream(
            rs, n_a, n_b, tiles, INT32_MAX if pad == "int32_max" else c_cap)
        c_row = np.where(seg < c_cap, seg // 3, INT32_MAX).astype(np.int32)
        c_col = np.where(seg < c_cap, seg % 3, INT32_MAX).astype(np.int32)
        t = [torch.from_numpy(x).to(dev) for x in (a_m, b_t, a_idx, b_idx,
                                                   seg, c_row, c_col)]
        tk.reset_launch_counts()
        got = cstruct.c_masks(*t, c_cap)
        again = cstruct.c_masks(*t, c_cap)
        assert tk.LAUNCHES["tile16_c_masks"] == 2
        want = cstruct.c_masks_plain(*t, c_cap)
        for g, h, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(h, w)
    m, cptr, vals = _rowcol_case(rs, 13)
    tm, tp = torch.from_numpy(m).to(dev), torch.from_numpy(cptr).to(dev)
    for cap in (int(cptr[-1]) + 300, int(cptr[-1]) - 40):
        want = cstruct.c_rowcol_plain(tm, tp, cap)
        assert all(torch.equal(g, w) for g, w in zip(
            cstruct.c_rowcol(tm, tp, cap), want))
        for dtype, iv in ((torch.float32, torch.int32),
                          (torch.float64, torch.int64)):
            tv = torch.from_numpy(vals).to(dtype).to(dev)
            rc, et, cv = cstruct.c_rowcol_values(tm, tp, cap, tv)
            wv = numeric.extract_values(tv, *want)
            assert torch.equal(rc, want[0]) and torch.equal(et, want[1])
            assert torch.equal(cv.view(iv), wv.view(iv))
    a = torch.from_numpy(rs.standard_normal((7, 256))).float()
    b = torch.from_numpy(rs.standard_normal((6, 256))).float()
    a[rs.random(a.shape) < 0.5] = 0.0
    b[rs.random(b.shape) < 0.5] = -0.0
    a[1, 7], b[2, 9], a[3, 3] = float("nan"), float("inf"), float("-inf")
    a_idx, b_idx, seg = _stream(rs, 6, 5, 9, INT32_MAX)
    idx = [torch.from_numpy(x).to(dev) for x in (a_idx, b_idx, seg)]
    for dtype, q in ((torch.float32, "highest"), (torch.float32, "default"),
                     (torch.float64, "highest"), (torch.bfloat16, "highest")):
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        ca, cb = a.to(dtype).to(dev), b.to(dtype).to(dev)
        args = (*idx, 12, CHUNK, acc, q)
        d, cm, cp = numeric.accumulate_fused_masks(ca, cb, *args)
        d2, cm2, cp2 = numeric.accumulate_fused_masks(ca, cb, *args)
        vd, vc = numeric.accumulate_fused_flat(ca, cb, *args)
        wm, wp = numeric.counts_to_masks(vc)
        iv = torch.int64 if acc == torch.float64 else torch.int32
        assert torch.equal(cm, wm) and torch.equal(cp, wp)
        assert torch.equal(cm2, wm) and torch.equal(cp2, wp)
        assert torch.equal(d.view(iv), vd.view(iv))
        assert torch.equal(d2.view(iv), vd.view(iv))
        pm, pp = numeric.counts_to_masks(numeric.fused_flat_plain(
            ca, cb, *args)[1])
        assert torch.equal(cm, pm) and torch.equal(cp, pp)
    torch.cuda.synchronize()
