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
  * the kernel's lane map and pattern masks replayed in numpy against the
    0/1 product, its shared-memory rows against the bank claims of the
    source, the wrapper's argument checks, and the source against the
    ctypes declarations.

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


@pytest.mark.parametrize("n", [2, 4])
def test_ring_stages_are_sorted_by_c_tile(n):
    a, b = _tiled(RANDOM)
    total = 0
    for d in range(n):
        p = sharded.plan_sharded_spgemm(a, b, n, d)
        seg = p.seg.numpy().astype(np.int64)
        assert np.all(np.diff(seg, axis=1) >= 0), d
        live = (seg < p.c_cap).sum(axis=1)
        np.testing.assert_array_equal(live, p.stage_pairs)
        assert np.all((seg < p.c_cap) | (seg == p.c_cap))
        total += int(live.sum())
    assert total == p.n_pairs


def test_local_numeric_fresh_then_accumulate_into_one_c(monkeypatch):
    """One accumulation a stage with pairs: the first fresh (out=None),
    every later one into the C the first returned; the values equal under
    == the composition of fresh partials added by torch into a zero C."""
    a, b = _tiled(RANDOM)
    n = 4
    plans = [sharded.plan_sharded_spgemm(a, b, n, d) for d in range(n)]
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

def _source():
    with open(tk.SOURCE) as f:
        return f.read()


def _kernel_counts(a, b):
    """The structural counts of one pair as the kernel forms them: lane L
    makes one 16-bit k-mask (A row L for L < 16, its k started at L / 8;
    B column L - 16 otherwise); the lane owning (r0 + i, c0 + j) adds
    popc(mask[r0 + i] & mask[16 + c0 + j])."""
    masks = []
    for lane in range(32):
        rot = lane >> 3 if lane < 16 else 0
        m = 0
        for k in range(16):
            kk = (k + rot) & 15
            v = a[lane, kk] if lane < 16 else b[kk, lane - 16]
            m |= int(v != 0) << kk
        masks.append(m)
    out = np.zeros((16, 16), np.int64)
    owned = np.zeros((16, 16), np.int64)
    for lane in range(32):
        r0, c0 = 2 * (lane >> 2), 4 * (lane & 3)
        for i in range(2):
            for j in range(4):
                out[r0 + i, c0 + j] = bin(masks[r0 + i]
                                          & masks[16 + c0 + j]).count("1")
                owned[r0 + i, c0 + j] += 1
    assert np.all(owned == 1)
    return out


def test_lane_masks_give_the_pattern_product():
    rs = np.random.default_rng(3)
    for t in range(6):
        a = rs.standard_normal((16, 16)).astype(np.float32)
        b = rs.standard_normal((16, 16)).astype(np.float32)
        a[rs.random((16, 16)) < 0.4] = 0.0
        b[rs.random((16, 16)) < 0.4] = -0.0
        a[rs.integers(16), rs.integers(16)] = np.nan
        b[rs.integers(16), rs.integers(16)] = np.inf
        a[rs.integers(16), rs.integers(16)] = 1e-45      # subnormal
        want = (a != 0).astype(np.int64) @ (b != 0).astype(np.int64)
        np.testing.assert_array_equal(_kernel_counts(a, b), want)


@pytest.mark.parametrize("word", [4, 8], ids=["f32", "f64"])
def test_padded_rows_meet_no_bank_twice(word):
    """Shared-memory words (4 bytes, 32 banks) of the kernel's reads of its
    padded slot: a 16-byte row read of 8 lanes (a phase) touches distinct
    bank groups for distinct addresses; the mask reads of the 16 A lanes,
    and of the 16 B lanes, touch distinct banks (8-byte words: the 16
    lanes of a half warp, two banks each)."""
    src = _source()
    assert "static constexpr int RS = 16 + EPC;" in src
    epc = 16 // word
    rs = 16 + epc
    w = word // 4                                   # banks an element
    slot = 16 * rs * w                              # words a tile
    for q in range(4):                              # the four phases
        for half in range(2):                       # rows r0, r0 + 1
            for e in range(0, 16, epc):             # each 16-byte read
                groups = {}
                for lane in range(8 * q, 8 * q + 8):
                    addr = ((2 * (lane >> 2) + half) * rs + e) * w
                    groups[addr] = {(addr + i) % 32 for i in range(4)}
                banks = [x for g in groups.values() for x in g]
                assert len(banks) == len(set(banks)), (q, half, e)
    for k in range(16):
        a_banks, b_banks = [], []
        for lane in range(16):
            kk = (k + (lane >> 3)) & 15
            a_banks += [((lane * rs + kk) * w + i) % 32 for i in range(w)]
            b_banks += [(slot + (k * rs + lane) * w + i) % 32
                        for i in range(w)]
        assert len(a_banks) == len(set(a_banks)), k
        assert len(b_banks) == len(set(b_banks)), k


def test_kernel_source_and_loader_agree():
    src = _source()
    entries = ("tile16_accumulate_pairs_f32", "tile16_accumulate_pairs_f64")
    for symbol in entries:
        assert f'extern "C" int {symbol}(' in src
    # hand-written products: no library GEMM, no PyTorch headers
    for banned in ("torch/extension.h", "cublas", "cutlass", "wmma"):
        assert banned not in src.lower()
    assert "fmaf(a, b, c)" in src and "fma(a, b, c)" in src
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
