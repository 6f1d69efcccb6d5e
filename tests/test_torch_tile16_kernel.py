"""The Tile16 accumulation kernel (ops/tile16_kernels.py,
csrc/tile16_accumulate.cu) and what surrounds it, on the CPU.

The kernel runs only on the card (the test marked ``cuda`` holds its
forms against the plain versions there and skips here; the masks form and
the structure kernels: tests/test_torch_tile16_struct.py).  What the CPU can
hold:

  * the plain accumulate form (``numeric.accumulate_dense(..., out=c)``):
    old + partial under == on the tiles with pairs, every other tile bit
    for bit, with -0.0, +-Inf and NaN planted in every tile of the old C;
  * the streams the kernel is handed are sorted by C tile (the one-card
    stream of ``symbolic.expand_pairs``, packed and not; each stage of the
    Tile16 ring at 2 and 4 ranks), and ``segment_offsets`` puts every
    padding pair (c_cap or INT32_MAX) past its last tile;
  * ``local_numeric`` runs a rank's first stage with pairs in the fresh
    form and every later one in the accumulate form into the same C (no
    partial C), equal under == to the fresh-plus-add composition;
  * the kernel's design replayed in numpy: its fragment maps (the k and n
    permutations: each operand element loaded once, each C element owned
    by one lane, the pieces aligned, one pass through the PTX m16n8k8
    layout equal to A @ B), the 3xTF32 pass within the float32 bound, the
    roundings it does in registers against ``round_operands`` bit for
    bit, the pattern pass against (a != 0) @ (b != 0), the marked-pair
    rule against the plain version's NaN and Inf positions, and the span
    walk on random streams (every tile stored once; empty tiles only in
    the fresh forms); the wrapper's argument checks, and the source
    against the ctypes declarations.

The values against the JAX package: tests/test_torch_tile16.py (the plain
versions, every phase) and tests/test_torch_sharded_rings.py (each rank's
``local_numeric`` against the JAX ring's ``_local_numeric``).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops import macro_kernels as mk
from pem_spgemm_tpu_torch.ops import numeric, symbolic
from pem_spgemm_tpu_torch.ops import tile16_kernels as tk
from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled
from pem_spgemm_tpu_torch.parallel import sharded

CPU = torch.device("cpu")
INT32_MAX = 0x7FFFFFFF
CHUNK = 8
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                                 ids=["f32", "f64"])


def _tables(rs, n, dtype):
    """(n, 16, 16) tiles: normal values, a third of them 0.0, some -0.0."""
    x = rs.standard_normal((n, 16, 16))
    u = rs.random((n, 16, 16))
    x[u < 0.3] = 0.0
    x[(u >= 0.3) & (u < 0.35)] = -0.0
    return torch.from_numpy(x).to(dtype)


def _stream(rs, n_a, n_b, c_cap, empty, pad):
    """A pair stream sorted by C tile: 1-4 pairs a tile, none for the tiles
    in ``empty``; padded to a multiple of CHUNK with a_idx 0, b_idx 0, seg
    ``pad``."""
    seg = [c for c in range(c_cap) if c not in empty
           for _ in range(rs.integers(1, 5))]
    n = len(seg)
    p_cap = -(-(n + 3) // CHUNK) * CHUNK
    a_idx = np.zeros(p_cap, np.int32)
    b_idx = np.zeros(p_cap, np.int32)
    s = np.full(p_cap, pad, np.int64)
    a_idx[:n] = rs.integers(0, n_a, n)
    b_idx[:n] = rs.integers(0, n_b, n)
    s[:n] = seg
    return (torch.from_numpy(a_idx), torch.from_numpy(b_idx),
            torch.from_numpy(s.astype(np.int32)))


def _prior(rs, c_cap, dtype):
    """An old C with -0.0, +Inf, -Inf and NaN in every tile."""
    x = torch.from_numpy(rs.standard_normal((c_cap, 16, 16))).to(dtype)
    for t in range(c_cap):
        pos = rs.choice(256, 4, replace=False)
        flat = x[t].view(-1)
        for p, v in zip(pos, (-0.0, float("inf"), float("-inf"),
                              float("nan"))):
            flat[p] = v
    return x


def _case(dtype, seed=0, pad=None):
    rs = np.random.default_rng(seed)
    c_cap, empty = 9, (2, 6, 8)
    a, b = _tables(rs, 7, dtype), _tables(rs, 5, dtype)
    a_idx, b_idx, seg = _stream(rs, 7, 5, c_cap, empty,
                                c_cap if pad is None else pad)
    return a, b, a_idx, b_idx, seg, c_cap, empty, _prior(rs, c_cap, dtype)


def _bits(x):
    return x.view(torch.int64 if x.element_size() == 8 else torch.int32)


@DTYPES
def test_out_form_adds_old_plus_partial_on_tiles_with_pairs(dtype):
    a, b, a_idx, b_idx, seg, c_cap, empty, prior = _case(dtype)
    tk.reset_launch_counts()
    partial = numeric.accumulate_dense(a, b, a_idx, b_idx, seg, c_cap,
                                       CHUNK, dtype)
    got = numeric.accumulate_dense(a, b, a_idx, b_idx, seg, c_cap, CHUNK,
                                   dtype, out=prior.clone())
    assert all(v == 0 for v in tk.LAUNCHES.values())   # plain version
    live = [c for c in range(c_cap) if c not in empty]
    want = prior[live] + partial[live]
    g = got[live]
    assert bool(((g == want) | (torch.isnan(g) & torch.isnan(want))).all())
    # the partial is the fresh form's: within the dot-product bound of a
    # float64 replay of the sums
    ref = np.zeros((c_cap, 16, 16))
    for ai, bi, s in zip(a_idx.tolist(), b_idx.tolist(), seg.tolist()):
        if s < c_cap:
            ref[s] += a[ai].double().numpy() @ b[bi].double().numpy()
    np.testing.assert_allclose(partial.double().numpy(), ref, rtol=1e-5,
                               atol=1e-5)


@DTYPES
def test_out_form_leaves_tiles_without_pairs_bit_for_bit(dtype):
    a, b, a_idx, b_idx, seg, c_cap, empty, prior = _case(dtype, seed=1)
    got = numeric.accumulate_dense(a, b, a_idx, b_idx, seg, c_cap, CHUNK,
                                   dtype, out=prior.clone())
    dead = list(empty)
    assert torch.equal(_bits(got[dead]), _bits(prior[dead]))
    # the planted -0.0 of a tile without pairs keeps its sign
    assert bool(torch.signbit(got[dead][prior[dead] == 0]).any())


@pytest.mark.parametrize("pad", ["c_cap", "int32_max", "overflow"])
def test_segment_offsets_put_padding_past_the_last_tile(pad):
    """The Tile16 ring pads seg with c_cap, the one-card stream with
    INT32_MAX; a stream whose tiles outrun c_cap (a plan's overflow) has
    real pairs at c_cap and above: none of them lies below seg_ptr[c_cap],
    and tile c owns exactly its pairs."""
    rs = np.random.default_rng(2)
    c_cap = 9
    fill = {"c_cap": c_cap, "int32_max": INT32_MAX, "overflow": INT32_MAX}
    a_idx, b_idx, seg = _stream(rs, 7, 5, c_cap + 3, (2, 6), fill[pad])
    if pad != "overflow":
        seg = torch.where(seg >= c_cap, torch.tensor(fill[pad],
                                                     dtype=torch.int32), seg)
    ptr = mk.segment_offsets(seg, c_cap)
    s = seg.numpy()
    assert ptr.dtype == torch.int32 and ptr.numel() == c_cap + 1
    assert int(ptr[-1]) == int((s < c_cap).sum())
    assert np.all(s[int(ptr[-1]):] >= c_cap)
    for c in range(c_cap):
        lo, hi = int(ptr[c]), int(ptr[c + 1])
        assert np.all(s[lo:hi] == c) and hi - lo == int((s == c).sum())


def _tiled(m):
    coo = COOMatrix.from_scipy(m)
    return (coo_to_tiled(coo, device=CPU),
            coo_to_tiled(coo, with_tmasks=True, device=CPU))


RANDOM = sp.random(700, 700, density=0.01, random_state=5, format="coo",
                   dtype=np.float64)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "wide"])
def test_one_card_stream_is_sorted_by_c_tile(packed):
    a, b = _tiled(RANDOM)
    offsets = symbolic.pair_counts(a.tile_col, b.tile_rowptr, a.ntiles)
    n_pairs = int(offsets[-1])
    p_cap = 1 << max(10, (n_pairs - 1).bit_length())
    _r, _c, a_idx, b_idx, c_tile_id, cnt_c = symbolic.expand_pairs(
        offsets, a.tile_row, a.tile_col, b.tile_rowptr, b.tile_col,
        n_pairs, p_cap, packed)
    s = c_tile_id.numpy().astype(np.int64)
    assert np.all(np.diff(s) >= 0)
    assert np.all(s[n_pairs:] == INT32_MAX)
    assert s[n_pairs - 1] == int(cnt_c) - 1
    ptr = mk.segment_offsets(c_tile_id, int(cnt_c))
    assert int(ptr[-1]) == n_pairs


@pytest.fixture(scope="module")
def ring_plans():
    """{ranks: [plan of each rank]}: the Tile16 ring's plans of RANDOM at 2
    and 4 ranks, built once for the tests below (the planner is their
    cost)."""
    a, b = _tiled(RANDOM)
    return {n: [sharded.plan_sharded_spgemm(a, b, n, d) for d in range(n)]
            for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_ring_stages_are_sorted_by_c_tile(n, ring_plans):
    total = 0
    for d, p in enumerate(ring_plans[n]):
        seg = p.seg.numpy().astype(np.int64)
        assert np.all(np.diff(seg, axis=1) >= 0), d
        live = (seg < p.c_cap).sum(axis=1)
        np.testing.assert_array_equal(live, p.stage_pairs)
        assert np.all((seg < p.c_cap) | (seg == p.c_cap))
        total += int(live.sum())
    assert total == p.n_pairs


def test_local_numeric_fresh_then_accumulate_into_one_c(monkeypatch,
                                                        ring_plans):
    """One accumulation a stage with pairs: the first fresh (out=None),
    every later one into the C the first returned; the values equal under
    == the composition of fresh partials added by torch into a zero C."""
    plans = ring_plans[4]
    real = numeric.accumulate_dense
    calls = []

    def spy(*args, out=None, **kw):
        calls.append(None if out is None else out.data_ptr())
        c = real(*args, out=out, **kw)
        calls.append(c.data_ptr())
        return c

    monkeypatch.setattr(numeric, "accumulate_dense", spy)
    several = 0
    for d, p in enumerate(plans):
        calls.clear()
        vals = sharded.replay_numeric(plans, d)
        live = [s for s, x in enumerate(p.stage_pairs) if x]
        several += len(live) > 1
        assert len(calls) == 2 * len(live)
        if live:
            first = calls[1]
            assert calls[0] is None
            assert calls[2::2] == [first] * (len(live) - 1)
        chunks = list(sharded.replay_chunks(plans, d))
        c = torch.zeros((p.c_cap, 16, 16))
        for s in live:
            c += real(p.a_dense, chunks[s], p.pairs_a[s], p.pairs_b[s],
                      p.seg[s], p.c_cap, p.pairs_a.shape[1])
        want = numeric.extract_values(c, p.rowcol, p.elem_tile)
        assert torch.equal(vals, want), d
    assert several


# --------------------------------------------------------------------------
# the kernel's design, replayed

BIG = 2.0 ** 63                 # the kernel's BIG: a pair holding |x| >=
                                # BIG, an Inf or a NaN is marked
RTOL, ATOL = 1e-5, 1e-6         # the float32 dot-product bound


def _source():
    with open(tk.SOURCE) as f:
        return f.read()


def _constant(name):
    """An int constant of the source (``constexpr int NAME = v;``)."""
    return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);",
                         _source())[1])


def _span(p_cap, acc_form=False):
    """The launcher's span for a stream of p_cap pairs: SPAN_MAX (SPAN_MIN
    in the accumulate form), halved down to SPAN_MIN while the grid would
    have fewer than MIN_WARPS warps."""
    span = _constant("SPAN_MIN") if acc_form else _constant("SPAN_MAX")
    while span > _constant("SPAN_MIN") and p_cap < span * _constant(
            "MIN_WARPS"):
        span //= 2
    return span


def _lane_map(lane):
    """Lane (g, t)'s loads and outputs: its A pieces (row g + 8i, k
    4t..4t+3), its B pieces (row 4t + i, columns 2g, 2g + 1) and its C
    elements (rows g, g + 8, columns 4t..4t+3), as (row, column) lists."""
    g, t = lane >> 2, lane & 3
    a = [[(g + 8 * i, 4 * t + j) for j in range(4)] for i in range(2)]
    b = [[(4 * t + i, 2 * g + n) for n in range(2)] for i in range(4)]
    c = [(g + 8 * i, 4 * t + j) for i in range(2) for j in range(4)]
    return a, b, c


def _fragments(a, b):
    """The lanes' operands (32, 2, 4) and (32, 4, 2) of tiles ``a``, ``b``
    as the kernel holds them: aw[L, i, j] = A[g + 8i, 4t + j], bw[L, i, n] =
    B[4t + i, 2g + n]."""
    aw = np.empty((32, 2, 4), a.dtype)
    bw = np.empty((32, 4, 2), b.dtype)
    for lane in range(32):
        la, lb, _c = _lane_map(lane)
        for i in range(2):
            for j in range(4):
                aw[lane, i, j] = a[la[i][j]]
        for i in range(4):
            for n in range(2):
                bw[lane, i, n] = b[lb[i][n]]
    return aw, bw


def _tile(acc):
    """The (16, 16) tile the lanes' accumulators (32, 2, 4) hold."""
    out = np.empty((16, 16), acc.dtype)
    for lane in range(32):
        for (r, c), v in zip(_lane_map(lane)[2], acc[lane].reshape(-1)):
            out[r, c] = v
    return out


def _lanes(c):
    """The lanes' accumulators (32, 2, 4) of a (16, 16) tile (_tile's
    inverse)."""
    out = np.empty((32, 2, 4), c.dtype)
    for lane in range(32):
        for k, (r, col) in enumerate(_lane_map(lane)[2]):
            out[lane, k // 4, k % 4] = c[r, col]
    return out


def _exact(a_blk, b_blk, c_blk):
    return a_blk @ b_blk + c_blk


def _tc32(a_blk, b_blk, c_blk):
    """A tensor-core block in float32: the products summed exactly with C,
    one rounding."""
    return (a_blk.astype(np.float64) @ b_blk.astype(np.float64)
            + c_blk.astype(np.float64)).astype(np.float32)


def _pass(acc, aw, bw, block=_exact):
    """The kernel's pass(): for k-step s and column block nb one mma
    m16n8k8, its fragments taken from the lanes' registers as the source
    takes them and laid out as PTX defines them (a[i] = A[g + 8 (i % 2)]
    [t + 4 (i / 2)], b[i] = B[t + 4i][g], d[q] = C[g + 8 (q / 2)]
    [2t + q % 2]); ``block`` computes D = A B + C of the 16 x 8 x 8 block."""
    acc = acc.copy()
    for s in range(2):
        for nb in range(2):
            a_blk = np.zeros((16, 8), aw.dtype)
            b_blk = np.zeros((8, 8), bw.dtype)
            c_blk = np.zeros((16, 8), acc.dtype)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                a = (aw[lane, 0, 2 * s], aw[lane, 1, 2 * s],
                     aw[lane, 0, 2 * s + 1], aw[lane, 1, 2 * s + 1])
                b = (bw[lane, 2 * s, nb], bw[lane, 2 * s + 1, nb])
                d = (acc[lane, 0, nb], acc[lane, 0, 2 + nb],
                     acc[lane, 1, nb], acc[lane, 1, 2 + nb])
                for i in range(4):
                    a_blk[g + 8 * (i % 2), t + 4 * (i // 2)] = a[i]
                for i in range(2):
                    b_blk[t + 4 * i, g] = b[i]
                for q in range(4):
                    c_blk[g + 8 * (q // 2), 2 * t + q % 2] = d[q]
            d_blk = block(a_blk, b_blk, c_blk)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for q, (i, j) in enumerate(((0, nb), (0, 2 + nb), (1, nb),
                                            (1, 2 + nb))):
                    acc[lane, i, j] = d_blk[g + 8 * (q // 2), 2 * t + q % 2]
    return acc


# the pieces each lane loads, by table dtype: (A piece elements, B piece
# elements); the kernel's fetch() overloads
PIECES = {"f32": (4, 4, 2), "bf16": (2, 4, 2), "f64": (8, 2, 2)}


@pytest.mark.parametrize("dtype", list(PIECES))
def test_fragment_maps_load_each_element_once(dtype):
    """The k and n permutations: every element of A and B is loaded by one
    lane once a pair, as pieces of consecutive elements aligned to their
    size (16 bytes of an A row in float32 and float64, 8 in bfloat16; B
    pieces of two elements), every C element is owned by one lane, and
    one pass of the lanes' fragments through the PTX m16n8k8 layout is
    A @ B."""
    word, a_len, b_len = PIECES[dtype]
    seen_a, seen_b, seen_c = (np.zeros((16, 16), int) for _ in range(3))
    for lane in range(32):
        la, lb, lc = _lane_map(lane)
        for row in la:
            for lo in range(0, 4, a_len):
                piece = row[lo:lo + a_len]
                offs = [r * 16 + k for r, k in piece]
                assert offs == list(range(offs[0], offs[0] + a_len))
                assert (offs[0] * word) % (a_len * word) == 0
                assert a_len * word <= 16
        for piece in lb:
            offs = [k * 16 + n for k, n in piece]
            assert offs == list(range(offs[0], offs[0] + b_len))
            assert (offs[0] * word) % (b_len * word) == 0
        for r, k in (x for row in la for x in row):
            seen_a[r, k] += 1
        for k, n in (x for piece in lb for x in piece):
            seen_b[k, n] += 1
        for r, c in lc:
            seen_c[r, c] += 1
    assert (seen_a == 1).all() and (seen_b == 1).all()
    assert (seen_c == 1).all()
    rs = np.random.default_rng(11)
    a, b = rs.standard_normal((2, 16, 16))
    got = _tile(_pass(np.zeros((32, 2, 4)), *_fragments(a, b)))
    np.testing.assert_allclose(got, a @ b, rtol=1e-13, atol=1e-13)
    # the source loads what the map says
    src = _source()
    for text in ("A + (g + 8 * i) * 16", "B + (4 * t + i) * 16",
                 "+ 2 * g", "c * 256 + (g + 8 * i) * 16 + 4 * t",
                 "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                 "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64"):
        assert text in src, text


def _tf32_split():
    """tests/test_torch_tf32_split.py's tf32 replay (imported here: that
    module imports JAX, which the card-only test below must not)."""
    from test_torch_tf32_split import split, tf32_rna
    return split, tf32_rna


def _split_words(x):
    split, _rna = _tf32_split()
    hi, lo = split(torch.from_numpy(np.ascontiguousarray(x)))
    return hi.numpy(), lo.numpy()


def _kernel_pair(acc, a, b, precision="highest"):
    """One float32 pair into a tile's lane sums as the kernel runs it: the
    values as the mode multiplies them (round_operands), the pair marked if
    they hold |x| >= BIG, an Inf or a NaN (the warp's vote covers both
    tiles) and then formed by FP32 FMA in ascending k, the partial added to
    the sum; else the tensor-core passes (3xTF32 at "highest": lo*hi,
    hi*lo, hi*hi a block)."""
    from pem_spgemm_tpu_torch.ops.macro import round_operands
    va = round_operands(torch.from_numpy(a), precision).numpy()
    vb = round_operands(torch.from_numpy(b), precision).numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        marked = not (np.abs(va) < BIG).all() or not (np.abs(vb) < BIG).all()
        if marked:
            part = np.zeros((16, 16), np.float32)
            for k in range(16):
                part = (va[:, k:k + 1].astype(np.float64)
                        * vb[k:k + 1, :].astype(np.float64)
                        + part).astype(np.float32)
            return _lanes(_tile(acc) + part)
        if precision != "highest":
            return _pass(acc, *_fragments(va, vb), _tc32)
        ah, al = _split_words(va)
        bh, bl = _split_words(vb)
        fh, fl = _fragments(ah, bh), _fragments(al, bl)
        out = acc
        for s_a, s_b in ((fl[0], fh[1]), (fh[0], fl[1]), (fh[0], fh[1])):
            out = _pass(out, s_a, s_b, _tc32)
        return out


def _split_block_order():
    """The source's products of a block in pass(), in order."""
    src = _source()
    body = src.split("if constexpr (TERMS == 3) {")[1]
    body = body[:body.index("acc[0][nb] = d[0];")]
    return re.findall(r"mma\(d, (\w+), (\w+)\);", body)


def test_split_pass_holds_the_float32_bound():
    """The 3xTF32 pass replayed on a C tile of 12 pairs (tf32 words from
    tests/test_torch_tf32_split.py's replay, each block's products summed
    with C and rounded once to float32): within 1e-5 * sum|a*b| + 1e-6 of
    the float64 product; one tf32 pass alone is not."""
    assert _split_block_order() == [("a_lo", "b"), ("a", "b_lo"),
                                    ("a", "b")]
    rs = np.random.default_rng(12)
    a = rs.standard_normal((12, 16, 16)).astype(np.float32)
    b = rs.standard_normal((12, 16, 16)).astype(np.float32)
    a[rs.random(a.shape) < 0.3] = 0.0
    acc = np.zeros((32, 2, 4), np.float32)
    one = np.zeros((32, 2, 4), np.float32)
    _s, rna = _tf32_split()
    for x, y in zip(a, b):
        acc = _kernel_pair(acc, x, y)
        fx = rna(torch.from_numpy(x)).numpy()
        fy = rna(torch.from_numpy(y)).numpy()
        one = _pass(one, *_fragments(fx, fy), _tc32)
    want = np.einsum("pik,pkj->ij", a.astype(np.float64),
                     b.astype(np.float64))
    mag = np.einsum("pik,pkj->ij", np.abs(a).astype(np.float64),
                    np.abs(b).astype(np.float64))
    assert (np.abs(_tile(acc) - want) <= RTOL * mag + ATOL).all()
    assert not (np.abs(_tile(one) - want) <= RTOL * mag + ATOL).all()


def _cvt_rna_tf32(x):
    """PTX cvt.rna.tf32.f32 replayed on the bits: to nearest, ties away
    from zero (half of the 13 dropped bits added to the magnitude), an
    overflow to Inf; a NaN stays a NaN."""
    bits = x.view(np.uint32)
    out = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)
    return np.where(np.isnan(x), x, out)


def _bf16_rn(x):
    """__float2bfloat16_rn widened back (the kernel's "default"): to
    nearest even on the bits, an overflow to Inf; a NaN stays a NaN."""
    bits = x.view(np.uint32)
    lsb = (bits >> np.uint32(16)) & np.uint32(1)
    out = ((bits + np.uint32(0x7FFF) + lsb) & np.uint32(0xFFFF0000)) \
        .view(np.float32)
    return np.where(np.isnan(x), x, out)


def _rounded_high(x):
    """The kernel's rounded<HIGH> (the marked path's rounding)."""
    bits = x.view(np.uint32)
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    return np.where(nan, bits, (bits + np.uint32(0x1000))
                    & np.uint32(0xFFFFE000)).astype(np.uint32) \
        .view(np.float32)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_register_roundings_equal_round_operands(precision):
    """The roundings the kernel does in registers (the tensor-core words:
    cvt.rna.tf32 at "high", bfloat16 to nearest even at "default"; the
    marked path's rounded<>) against ops.macro.round_operands, the
    modes' plain version, bit for bit: ties both ways, NaN kept, +-Inf,
    the overflow of FLT_MAX to Inf, subnormals, -0.0."""
    from pem_spgemm_tpu_torch.ops.macro import round_operands
    rs = np.random.default_rng(13)
    x = rs.standard_normal(4096).astype(np.float32) \
        * np.float32(2.0) ** rs.integers(-60, 60, 4096).astype(np.float32)
    ties = rs.integers(0x00800000, 0x7F000000, 256).astype(np.uint32)
    drop = 0x1000 if precision == "high" else 0x8000
    keep = ~np.uint32(2 * drop - 1)
    ties = (ties & keep) | np.uint32(drop)          # exactly half way
    ties[::2] |= np.uint32(2 * drop)                # an odd kept bit
    special = np.array([np.nan, np.inf, -np.inf, 3.4028235e38, -3.4028235e38,
                        1e-40, -1e-45, 0.0, -0.0, 1.0, -1.0], np.float32)
    x = np.concatenate([x, ties.view(np.float32), -ties.view(np.float32),
                        special])
    want = round_operands(torch.from_numpy(x), precision).numpy()
    kernel = (_cvt_rna_tf32, _rounded_high) if precision == "high" \
        else (_bf16_rn,)
    for fn in kernel:
        got = fn(x.copy())
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan)
        assert np.array_equal(got[~nan].view(np.uint32),
                              want[~nan].view(np.uint32))
    assert np.isinf(want[-11 + 3]) and np.isinf(want[-11 + 4])
    src = _source()
    assert "cvt.rna.tf32.f32" in src and "__float2bfloat16_rn(x)" in src
    assert "(b + 0x1000u) & 0xFFFFE000u" in src


def _raw_tiles(rs, n):
    x = rs.standard_normal((n, 16, 16)).astype(np.float32)
    u = rs.random(x.shape)
    x[u < 0.4] = 0.0
    x[(u >= 0.4) & (u < 0.45)] = -0.0
    x[(u >= 0.45) & (u < 0.48)] = 1e-40                 # subnormal
    return x


def test_pattern_pass_counts_the_raw_nonzeros():
    """The structural counts: one tensor-core pass on the 0/1 words of the
    raw values (x != 0: NaN counts, -0.0 does not, a subnormal counts),
    summed over a tile's pairs in float32, equal (a != 0) @ (b != 0)
    exactly; and the masks form's store of them (bit 4t + j of rows g,
    g + 8, a row's four lanes ORed) gives counts_to_masks' row masks."""
    rs = np.random.default_rng(14)
    a, b = _raw_tiles(rs, 9), _raw_tiles(rs, 9)
    a[2, 3, 4], b[5, 6, 7], a[7, 0, 0] = np.nan, np.inf, -np.inf
    a[4] = 1.0                                          # all 256 counts
    cnt = np.zeros((32, 2, 4), np.float32)
    for x, y in zip(a, b):
        one = np.float32(1.0)
        cnt = _pass(cnt, *_fragments(np.where(x != 0, one, 0),
                                     np.where(y != 0, one, 0)), _tc32)
    want = np.einsum("pik,pkj->ij", (a != 0).astype(np.int64),
                     (b != 0).astype(np.int64))
    assert np.array_equal(_tile(cnt), want.astype(np.float32))
    words = np.zeros(16, np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(2):
            for j in range(4):
                words[g + 8 * i] |= int(cnt[lane, i, j] > 0) << (4 * t + j)
    want_m, _p = numeric.counts_to_masks(torch.from_numpy(
        want.astype(np.float32).reshape(1, 256)))
    assert np.array_equal(words, want_m[0].numpy())


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_marked_pairs_give_the_plain_nan_and_inf(precision):
    """The marked-pair rule on a stream whose tiles hold NaN, +-Inf, an
    Inf that meets only zeros, FLT_MAX (whose tf32 rounding is Inf) and
    2^63: marked pairs by FP32 FMA, the rest by the tensor-core passes,
    C's NaN positions and Inf signs are the plain version's
    (fused_flat_plain), and its finite values within the float32 bound of
    the plain version at the precision."""
    rs = np.random.default_rng(15)
    n = 8
    a, b = _raw_tiles(rs, n + 1), _raw_tiles(rs, n + 1)
    a[1, 2, 3], b[2, 4, 5], a[3, 6, 6] = np.nan, np.inf, -np.inf
    a[4, 5, :] = 0.0
    b[4, 9, 0] = np.inf                 # meets A tile 4's row 5 of zeros
    a[5, 0, 1], b[6, 1, 2] = 3.4028235e38, 2.0 ** 63
    a[n], b[n] = 0.0, 0.0
    pairs = [(0, 0, 0), (1, 1, 0), (2, 2, 1), (3, 3, 1), (4, 4, 2),
             (5, 0, 3), (6, 6, 3), (7, 7, 4), (0, 2, 4)]
    c_cap = 5
    p_cap = 2 * CHUNK
    ai = np.full(p_cap, n, np.int32)
    bi = np.full(p_cap, n, np.int32)
    seg = np.full(p_cap, INT32_MAX, np.int32)
    ai[:len(pairs)], bi[:len(pairs)], seg[:len(pairs)] = zip(*pairs)
    want, _cnt = numeric.fused_flat_plain(
        torch.from_numpy(a.reshape(-1, 256)),
        torch.from_numpy(b.reshape(-1, 256)), torch.from_numpy(ai),
        torch.from_numpy(bi), torch.from_numpy(seg), c_cap, CHUNK,
        precision=precision)
    want = want.numpy().reshape(c_cap, 16, 16)
    from pem_spgemm_tpu_torch.ops.macro import round_operands
    ra = round_operands(torch.from_numpy(a), precision).numpy()
    rb = round_operands(torch.from_numpy(b), precision).numpy()
    marks = 0
    for c in range(c_cap):
        acc = np.zeros((32, 2, 4), np.float32)
        mag = np.zeros((16, 16))
        for x, y, s in pairs:
            if s == c:
                acc = _kernel_pair(acc, a[x], b[y], precision)
                with np.errstate(invalid="ignore"):
                    mag += np.abs(ra[x].astype(np.float64)) \
                        @ np.abs(rb[y].astype(np.float64))
                    marks += not ((np.abs(ra[x]) < BIG).all()
                                  and (np.abs(rb[y]) < BIG).all())
        got = _tile(acc)
        w = want[c]
        assert np.array_equal(np.isnan(got), np.isnan(w)), c
        assert np.array_equal(np.isposinf(got), np.isposinf(w)), c
        assert np.array_equal(np.isneginf(got), np.isneginf(w)), c
        fin = np.isfinite(w)
        with np.errstate(invalid="ignore"):
            assert (np.abs(got[fin] - w[fin])
                    <= RTOL * mag[fin] + ATOL).all(), c
    assert marks == 7 and np.isnan(want[2]).any()


def _walk(c_tile, p_cap, c_cap, acc_form, span, zt, n_warps):
    """The kernel's walk replayed warp by warp: [(tile, [pairs])] in the
    order the warps store them (an empty tile with no pairs).  The
    ``n_warps`` warps of the grid take the ranges of c_cap and the spans
    w, w + n_warps, ..., each warp until a span starts in the padding."""
    def tile_at(q):
        return int(c_tile[q]) if q < p_cap else INT32_MAX

    def span_writes(p0):
        """The span's stores, or None where it starts in the padding."""
        if tile_at(p0) >= c_cap:
            return None
        end = p0 + span
        prev = tile_at(p0 - 1) if p0 > 0 else -1
        base, p = p0, None
        while True:
            batch = [tile_at(base + lane) for lane in range(32)]
            ups = [prev] + batch[:31]
            starts = [lane for lane in range(32)
                      if batch[lane] < c_cap and batch[lane] != ups[lane]
                      and base + lane < end]
            if starts:
                p = base + starts[0]
                break
            prev, base = batch[31], base + 32
            if base >= end:
                return []
            if prev >= c_cap or base >= p_cap:
                return None
        out, tile, pairs = [], tile_at(p), []
        while True:
            q = p + 1
            q_tile = tile_at(q)
            same = q_tile == tile
            more = same or (q < end and q_tile < c_cap)
            pairs.append(p)
            if not same:
                out.append((tile, pairs))
                pairs = []
                if not more:
                    return out
                tile = q_tile
            p = q

    seg_ptr = np.searchsorted(c_tile[:p_cap], np.arange(c_cap + 1))
    writes = []
    for w in range(n_warps):
        if not acc_form:
            for r in range(w, -(-c_cap // zt), n_warps):
                for lane in range(32):
                    c = r * zt + lane
                    if c < c_cap and seg_ptr[c] == seg_ptr[c + 1]:
                        writes.append((c, []))
        for sp in range(w, -(-p_cap // span), n_warps):
            got = span_writes(sp * span)
            if got is None:
                break
            writes += got
    return writes


@pytest.mark.parametrize("pad", ["int32_max", "c_cap", "overflow"])
def test_span_walk_writes_every_tile_once(pad):
    """The walk on random streams (tiles of 0-40 pairs, long runs of empty
    tiles, padding at INT32_MAX or at c_cap, or real pairs past c_cap, a
    plan's overflow), in the launcher's spans for such streams (8 pairs)
    and in 16- and 64-pair spans (a long stream's), the spans strided over
    grids of 1 to 1,000 warps, each warp stopping at the first span that
    starts in the padding: every tile with pairs
    is stored once, by one warp, with exactly its pairs in stream order;
    in the fresh forms every empty tile of c_cap once too, in the
    accumulate form never."""
    zt = _constant("ZT")
    assert zt == 32 and _span(4_194_304) == 64 and _span(4096) == 8
    assert _span(4_194_304, acc_form=True) == 8
    src = _source()
    assert "while (span > SPAN_MIN && (long long)p_cap < span * MIN_WARPS)" \
        in src and "int span = F == Form::ACC ? SPAN_MIN : SPAN_MAX;" in src
    rs = np.random.default_rng({"int32_max": 16, "c_cap": 17,
                                "overflow": 18}[pad])
    for trial in range(4):
        c_cap = int(rs.integers(40, 400))
        counts = rs.integers(0, 41, c_cap)
        counts[rs.random(c_cap) < 0.4] = 0
        counts[c_cap // 3:c_cap // 3 + 70] = 0          # a long gap
        if trial == 3:
            counts[:] = 0
            counts[5] = 3                               # one short tile
        seg = np.repeat(np.arange(c_cap), counts)
        if pad == "overflow":
            seg = np.concatenate([seg, np.repeat(c_cap + np.arange(3), 5)])
        n = seg.size
        p_cap = n + int(rs.integers(0, 100))
        fill = c_cap if pad == "c_cap" else INT32_MAX
        c_tile = np.concatenate([seg, np.full(p_cap - n, fill)])
        for acc_form, span, n_warps in (
                (False, _span(p_cap), 3), (True, _span(p_cap, True), 5),
                (False, 16, 1), (True, 64, 2), (False, 64, 1000)):
            writes = _walk(c_tile, p_cap, c_cap, acc_form, span, zt,
                           n_warps)
            tiles = [t for t, _p in writes]
            assert len(tiles) == len(set(tiles))
            for t, pairs in writes:
                assert pairs == np.flatnonzero(c_tile[:p_cap] == t).tolist()
            live = set(np.flatnonzero(counts).tolist())
            want = set(range(c_cap)) if not acc_form else live
            assert set(tiles) == want, (trial, acc_form)
            assert all(bool(p) == (t in live) for t, p in writes)


def test_kernel_source_and_loader_agree():
    src = _source()
    entries = ("tile16_accumulate_pairs_f32", "tile16_accumulate_pairs_f64")
    for symbol in entries:
        assert f'extern "C" int {symbol}(' in src
    # hand-written products: no library GEMM, no PyTorch headers
    for banned in ("torch/extension.h", "cublas", "cutlass", "wmma"):
        assert banned not in src.lower()
    # the products on the tensor cores: tf32 (float32 and bfloat16 tables)
    # and DMMA (float64); FP32 FMA only on marked pairs
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64" in src
    assert src.count("fmaf(") == 2 and "fma(" not in src.replace(
        "fmaf(", "")
    assert "__shared__" not in src
    # bench/k4_split.py's other builds of the source: each text once
    from pem_spgemm_tpu_torch.bench import k4_split
    for name, cuts in [*k4_split.TILE16_CUTS.items(),
                       *k4_split.TILE16_SPLIT_CUTS.items()]:
        for old, new in cuts:
            assert src.count(old) == 1 and new != old, name
    assert re.search(r"\batomic[A-Z]\w*\(", src) is None     # no atomics
    assert set(tk.LAUNCHES) == {
        "tile16_accumulate_pairs", "tile16_accumulate_pairs_acc",
        "tile16_accumulate_pairs_masks", "tile16_accumulate_pairs_f64",
        "tile16_accumulate_pairs_f64_acc",
        "tile16_accumulate_pairs_f64_masks", "tile16_c_masks",
        "tile16_c_rowcol"}

    class Lib:
        pass

    lib = Lib()
    for e in entries:
        setattr(lib, e, Lib())
    tk._declare(lib)
    for e in entries:
        params = src.split(f'extern "C" int {e}(')[1].split(")")[0]
        fn = getattr(lib, e)
        assert len(fn.argtypes) == params.count(",") + 1, e
        assert fn.restype is ctypes.c_int
    assert os.path.relpath(tk.SOURCE, os.path.dirname(os.path.dirname(
        tk.__file__))) == os.path.join("csrc", "tile16_accumulate.cu")


def test_wrapper_argument_checks_raise(monkeypatch):
    a, b, a_idx, b_idx, seg, c_cap, _e, prior = _case(torch.float32)
    with pytest.raises(ValueError, match="out must be"):
        numeric.accumulate_dense(a, b, a_idx, b_idx, seg, c_cap, CHUNK,
                                 out=prior[:, :, :8].contiguous())
    with pytest.raises(TypeError, match="float64"):
        numeric.accumulate_dense(a, b, a_idx, b_idx, seg, c_cap, CHUNK,
                                 out=prior.double())
    with pytest.raises(ValueError, match="contiguous"):
        numeric.accumulate_dense(a, b, a_idx, b_idx, seg, c_cap, CHUNK,
                                 out=prior.transpose(1, 2))
    with pytest.raises(ValueError, match="precision"):
        numeric.accumulate_dense(a, b, a_idx, b_idx, seg, c_cap, CHUNK,
                                 precision="tf32")
    with pytest.raises(ValueError, match="precision"):
        numeric.accumulate_fused_flat(a.view(-1, 256), b.view(-1, 256),
                                      a_idx, b_idx, seg, c_cap, CHUNK,
                                      precision="fast")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        numeric.accumulate_dense(a, b, a_idx, b_idx, seg, c_cap, CHUNK)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    # the checks every CUDA launch makes, on CPU tensors
    tk._check_table(a, "a", CPU)
    tk._check_table(a.view(-1, 256), "a", CPU)
    with pytest.raises(ValueError, match="256"):
        tk._check_table(a[:, :, :8], "a", CPU)
    with pytest.raises(ValueError, match="at least one tile"):
        tk._check_table(a[:0], "a", CPU)
    with pytest.raises(ValueError, match="contiguous"):
        tk._check_table(a.transpose(1, 2), "a", CPU)
    with pytest.raises(ValueError, match="expected"):
        tk._check_table(a, "a", torch.device("meta"))
    tk._check_stream(a_idx, b_idx, seg, CPU)
    with pytest.raises(ValueError, match="int32"):
        tk._check_stream(a_idx.long(), b_idx, seg, CPU)
    with pytest.raises(ValueError, match="int32"):
        tk._check_stream(a_idx, b_idx[1:], seg, CPU)
    assert tk._entry_dtypes(torch.float32, torch.float32) == (
        torch.float32, False)
    assert tk._entry_dtypes(torch.bfloat16, torch.float32) == (
        torch.float32, True)
    assert tk._entry_dtypes(torch.float64, torch.float64) == (
        torch.float64, False)
    for t, acc in ((torch.float32, torch.float64),
                   (torch.bfloat16, torch.bfloat16),
                   (torch.float16, torch.float32),
                   (torch.float64, torch.float32)):
        with pytest.raises(NotImplementedError, match="Tile16 kernel"):
            tk._entry_dtypes(t, acc)


# --------------------------------------------------------------------------
# on the card

@pytest.mark.cuda
def test_kernel_forms_match_the_plain_versions_on_the_card():
    """Every form of both entries against its plain version on the card:
    values within the dot-product bound, counts bit for bit, two launches
    bit-equal, the accumulate form old + partial under == and the tiles
    without pairs untouched; at "high" / "default" the entry equals itself
    at "highest" on tables rounded beforehand."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Tile16 kernel has no CPU "
                    "form (python3 chip_smoke.py --only tile16_path holds "
                    "it at full size)")
    from pem_spgemm_tpu_torch.ops.macro import round_operands
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        a, b, a_idx, b_idx, seg, c_cap, empty, prior = _case(
            torch.float64 if dtype == torch.float64 else torch.float32,
            seed=4)
        a, b = a.to(dtype), b.to(dtype)
        args = (a_idx, b_idx, seg, c_cap, CHUNK, acc)
        cuda = [x.to(dev) for x in (a, b, a_idx, b_idx, seg)]
        cargs = (*cuda[2:], c_cap, CHUNK, acc)
        af, bf = a.reshape(-1, 256), b.reshape(-1, 256)
        caf, cbf = cuda[0].reshape(-1, 256), cuda[1].reshape(-1, 256)
        want_v, want_c = numeric.accumulate_fused_flat(af, bf, *args)
        mag = numeric.accumulate_fused_flat(af.abs(), bf.abs(), *args)[0]
        got_v, got_c = numeric.accumulate_fused_flat(caf, cbf, *cargs)
        again_v, again_c = numeric.accumulate_fused_flat(caf, cbf, *cargs)
        assert torch.equal(_bits(got_v), _bits(again_v))
        assert torch.equal(got_c.cpu(), want_c)
        tol = (1e-12 if acc == torch.float64 else 1e-5) * mag.double() + 1e-6
        assert bool(((got_v.cpu().double() - want_v.double()).abs()
                     <= tol).all())
        dense = numeric.accumulate_dense(*cuda[:2], *cargs)
        assert torch.equal(_bits(dense.reshape(-1, 256)), _bits(got_v))
        old = prior.to(acc).to(dev)
        into = numeric.accumulate_dense(*cuda[:2], *cargs, out=old.clone())
        live = [c for c in range(c_cap) if c not in empty]
        want = old[live] + dense[live]
        assert bool(((into[live] == want)
                     | (torch.isnan(into[live]) & torch.isnan(want))).all())
        assert torch.equal(_bits(into[list(empty)]),
                           _bits(old[list(empty)]))
    for q in ("high", "default"):
        a, b, a_idx, b_idx, seg, c_cap, _e, _p = _case(torch.float32, seed=5)
        ca, cb = a.reshape(-1, 256).to(dev), b.reshape(-1, 256).to(dev)
        cargs = (a_idx.to(dev), b_idx.to(dev), seg.to(dev), c_cap, CHUNK)
        got_v, got_c = numeric.accumulate_fused_flat(ca, cb, *cargs,
                                                     precision=q)
        pre_v, _c = numeric.accumulate_fused_flat(
            round_operands(ca, q), round_operands(cb, q), *cargs)
        raw_v, raw_c = numeric.accumulate_fused_flat(ca, cb, *cargs)
        assert torch.equal(got_v, pre_v) and torch.equal(got_c, raw_c)
    torch.cuda.synchronize()
