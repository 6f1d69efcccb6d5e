"""The one-pass pipeline of csrc/macro_accumulate.cu, replayed on the CPU.

At precision "high" and "default" the three float32 Macro128 entries (K4,
K5, K6) run a warp-specialised, persistent kernel (macro_ws_kernel): a
producer warpgroup copies each 32-deep stage's raw slabs into a ring,
rounds them into a ring of swizzled operand stages with their k-masks, and
two consumer warpgroups multiply them with wgmma.  No nvcc and no card
here, so this file replays, in numpy, what the source says:

* the producer's layouts (ws_convert): every thread's loads and stores,
  with the lane map of the raw B rows, the 4 x 4 quad transpose by
  shuffles, the k-mask bit order (a bit is the lane of its k), then the
  operand stage read back the way wgmma reads it (the canonical K-major
  and MN-major layouts of the descriptors ws_mma builds): the products of
  each consumer warpgroup equal the rounded operands' product, the masks
  give the raw values' pattern, and no shared-memory phase meets a bank
  group twice;
* the ring protocol (ws_producer, Issuer, ws_consumer): producer warps,
  consumer warps and the copy engine of several blocks as generators
  around modelled mbarriers (arrival counts, phase parity), advanced in seeded random orders with one ticket counter:
  nothing deadlocks, no slot is written while it is read, every tile is
  stored once, with its pairs' slabs in order, for the pair stream and for
  the class launches of a run plan, whose values are then held to the
  plain version; the accumulate form's walk over the list of the tiles with
  pairs (ListTiles over ``stream_walk``) visits exactly those, once each,
  in stream order, and takes no ticket past the list's count;
* the tables' k-masks (f32_tile_masks) and the walk list against numpy.

Change the .cu, this replay and the source lines it checks together.
"""

import re

import numpy as np
import pytest
import torch

from pem_spgemm_tpu_torch.models.synthetic import wandering_device
from pem_spgemm_tpu_torch.ops import macro, symbolic
from pem_spgemm_tpu_torch.ops import macro_kernels as mk
from pem_spgemm_tpu_torch.ops import stencil as st
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro
from test_torch_util import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)
TILE, KS = 128, 32


def _source():
    with open(mk.SOURCE) as f:
        return f.read()


def _ring_depths(text, prec):
    body = text.split(f"template <> struct Ws<Prec::{prec}> {{")[1]
    m = re.search(r"static constexpr int RAW = (\d+), OPS = (\d+);", body)
    return int(m.group(1)), int(m.group(2))


def test_source_has_the_replayed_lines():
    text = _source()
    for line in (
            "constexpr int RAW_A_STRIDE = KS * 4 + 16;",
            "constexpr int RAW_B_STRIDE = TILE * 4 + 16;",
            "    return (q >> 1) ^ (5 * (q & 1));",
            "    return c < 4 ? 2 * c : 2 * (c ^ 5) + 1;",
            "*reinterpret_cast<uint4*>(op.a + t * 128 + ((c ^ (t & 7)) << 4))",
            "+ ((c ^ ((t >> 1) & 3)) << 4)) =",
            "op.b + j * 128 + (((kq ^ j) & 7) << 4)",
            "op.b + (cc >> 3) * (KS * 128) + k * 128",
            "+ (((cc & 7) ^ (k & 7)) << 4)) =",
            "op_desc(op.a + 64 * g * 128, 16, 1024, 1);",
            "op_desc(op.b, 16, 1024, 1);",
            "wgmma_tf32(d, da + 2 * kk, db + 2 * kk, kk);",
            "op_desc(op.a + 64 * g * 64, 16, 512, 2);",
            "op_desc(op.b, KS * 128, 1024, 1);",
            "wgmma_bf16(d, da + 2 * kk, db + 128 * kk, kk);",
            "\"%64, %65, p, 1, 1, 0, 1;",
            "mbar_init(&sh.info_full[i], 1);",
            "mbar_init(&sh.raw_full[i], 128);",
            "mbar_init(&sh.raw_empty[i], 4);",
            "mbar_init(&sh.op_full[i], 4);",
            "mbar_init(&sh.op_empty[i], 8);",
            "constexpr int WS_PRODUCER_REGS = 120;",
            "constexpr int WS_CONSUMER_REGS = 192;",
            # the accumulate form's walk (ListTiles, the Issuer's rows)
            "            lo = walk[2 + 2 * tk];",
            "            hi = walk[4 + 2 * tk];",
            "        return tk < n_tiles ? walk[1 + 2 * tk] : 0;",
            "        w.n_tiles = walk[0];",
            "        if constexpr (Tiles::LISTED) row0 = w.row(tk0);",
            "        if constexpr (Tiles::LISTED) row = row0;",
            "            info.row = Tiles::LISTED ? row : w.row(tk);",
            "        const ListTiles w{walk, a_idx, b_idx, masks_a, masks_b, "
            "next, c_cap};",
            # the 256-thread kernel at "highest" (tests/test_torch_macro.py
            # replays it): warp 0's Issuer a stage ring ahead of the block
            "constexpr int TC_INFO = 4;",
            "            is.template publish<false>(w, a_dense, b_dense, "
            "info[n],\n                                       nullptr);",
            "                is.template publish<false>(w, a_dense, b_dense,\n"
            "                                           info[(n + 3) % "
            "TC_INFO], nullptr);",
            "    during();\n    if (next) {\n        cp_async_wait1();",
            "            tc_issue(sh.raw_a[n & 1], sh.raw_b[n & 1], in.ap, "
            "in.bp, in.k0);",
            "        issue(n + 2);                       // into raw slot n % 2",
            "            if (!ACC || live) fr.store_cs<ACC>(c_num, c_flag, "
            "in.row);",
            "            if constexpr (ARRIVE) mbar_arrive(ready);",
            # the next tile's masks (mw, the replay's need0) are written by
            # advance() alone; a tile of more than 32 pairs reloads its
            # window's masks into words of its own
            "        load_masks(w, lo0, hi0, a00 + ia0, b00 + ib0, mw);",
            "                    load_masks(w, q, hi, a0 + ia, b0 + ib, m);\n"
            "                    nd = slabs_needed(m);"):
        assert text.count(line) == 1, line
    assert text.count(", mw);") == 1
    assert _ring_depths(text, "HIGH") == (3, 3)
    assert _ring_depths(text, "DEFAULT") == (4, 4)


# --------------------------------------------------------------------------
# the producer's layouts

def kq_of_quad(q):
    return (q >> 1) ^ (5 * (q & 1))


def quad_of_kq(c):
    return 2 * c if c < 4 else 2 * (c ^ 5) + 1


LANE_K = np.array([4 * kq_of_quad(l >> 2) + (l & 3) for l in range(32)])


def _bits_high(x):
    return macro.round_operands(torch.from_numpy(x), "high").numpy().view(
        np.uint32)


def _bits_bf16(x):
    r = macro.round_operands(torch.from_numpy(x), "default").numpy()
    return (r.view(np.uint32) >> 16).astype(np.uint16)


def _quad_transpose(v):
    """quad_transpose over a warp: v (32, 4), row of lane l."""
    v = v.copy()
    lanes = np.arange(32)
    o1, o2 = (lanes & 1) != 0, (lanes & 2) != 0
    for h in range(2):
        send = np.where(o1, v[:, 2 * h], v[:, 2 * h + 1])
        got = send[lanes ^ 1]
        v[o1, 2 * h] = got[o1]
        v[~o1, 2 * h + 1] = got[~o1]
    for h in range(2):
        send = np.where(o2, v[:, h], v[:, 2 + h])
        got = send[lanes ^ 2]
        v[o2, h] = got[o2]
        v[~o2, 2 + h] = got[~o2]
    return v


class Smem:
    """A byte array that records each warp's 16-byte accesses, so that a
    shared-memory phase (8 lanes) can be checked for bank groups."""

    def __init__(self, n):
        self.buf = np.zeros(n, np.uint8)
        self.phases = []

    def access(self, addrs):
        """addrs: the 32 lanes' 16-byte accesses of one warp instruction."""
        addrs = np.asarray(addrs)
        assert (addrs % 16 == 0).all()
        for p in range(4):
            group = (addrs[8 * p:8 * p + 8] // 16) % 8
            self.phases.append(len(set(group.tolist())) == 8)


def replay_convert(a, b, prec):
    """ws_convert on raw slabs a (128, 32) and b (32, 128): (op_a, op_b,
    am, bm, checks), op_* the operand stage's bytes.  Raw rows at
    RAW_A_STRIDE / RAW_B_STRIDE bytes (their reads are checked too)."""
    op_bytes = TILE * KS * (4 if prec == "high" else 2)
    op_a, op_b = Smem(op_bytes), Smem(op_bytes)
    raw = Smem(1)
    am = np.zeros(TILE, np.uint32)
    bm = np.zeros(TILE, np.uint32)
    nz = lambda x: (x != 0).astype(np.uint32)   # noqa: E731
    for w in range(4):
        rows = np.arange(32 * w, 32 * w + 32)
        if prec == "high":
            for c in range(8):
                raw.access(rows * (KS * 4 + 16) + 16 * c)
                offs = rows * 128 + ((c ^ (rows & 7)) << 4)
                op_a.access(offs)
                for i, t in enumerate(rows):
                    x = a[t, 4 * c:4 * c + 4]
                    op_a.buf[offs[i]:offs[i] + 16] = _bits_high(x).view(
                        np.uint8)
                    am[t] |= sum(int(v) << e for e, v in
                                 enumerate(nz(x))) << (4 * quad_of_kq(c))
        else:
            for c in range(4):
                raw.access(rows * (KS * 4 + 16) + 32 * c)
                raw.access(rows * (KS * 4 + 16) + 32 * c + 16)
                offs = rows * 64 + ((c ^ ((rows >> 1) & 3)) << 4)
                op_a.access(offs)
                for i, t in enumerate(rows):
                    x = a[t, 8 * c:8 * c + 8]
                    op_a.buf[offs[i]:offs[i] + 16] = _bits_bf16(x).view(
                        np.uint8)
                    for h in range(2):
                        am[t] |= sum(int(v) << e for e, v in enumerate(
                            nz(x[4 * h:4 * h + 4]))) << (
                                4 * quad_of_kq(2 * c + h))
        lanes = np.arange(32)
        k = LANE_K
        if prec == "high":
            kq = np.array([kq_of_quad(l >> 2) for l in lanes])
            e = lanes & 3
            for r in range(8):
                c = 8 * w + r
                raw.access(k * (TILE * 4 + 16) + 16 * c)
                x = b[k, 4 * c:4 * c + 4]               # (32 lanes, 4)
                for i in range(4):
                    bm[4 * c + i] = int(sum(int(v) << l for l, v in
                                            enumerate(nz(x[:, i]))))
                v = _quad_transpose(_bits_high(np.ascontiguousarray(x)))
                j = 4 * c + e
                offs = j * 128 + (((kq ^ j) & 7) << 4)
                op_b.access(offs)
                for l in lanes:
                    op_b.buf[offs[l]:offs[l] + 16] = v[l].view(np.uint8)
        else:
            for i in range(4):
                cc = 4 * w + i
                raw.access(k * (TILE * 4 + 16) + 32 * cc)
                raw.access(k * (TILE * 4 + 16) + 32 * cc + 16)
                x = b[k, 8 * cc:8 * cc + 8]             # (32 lanes, 8)
                for u in range(8):
                    bm[8 * cc + u] = int(sum(int(v) << l for l, v in
                                             enumerate(nz(x[:, u]))))
                offs = (cc >> 3) * (KS * 128) + k * 128 + (
                    ((cc & 7) ^ (k & 7)) << 4)
                op_b.access(offs)
                bits = _bits_bf16(np.ascontiguousarray(x))
                for l in lanes:
                    op_b.buf[offs[l]:offs[l] + 16] = bits[l].view(np.uint8)
    phases = op_a.phases + op_b.phases + raw.phases
    return op_a.buf, op_b.buf, am, bm, phases


def _sw(addr, width):
    """The swizzle on an absolute shared-memory address (atoms aligned)."""
    if width == 128:
        return addr ^ (((addr >> 7) & 7) << 4)
    return addr ^ (((addr >> 7) & 3) << 4)


def _read(buf, addrs, elem):
    out = np.empty(addrs.shape, np.float64)
    for idx, a_ in np.ndenumerate(addrs):
        word = buf[a_:a_ + elem]
        if elem == 4:
            out[idx] = word.view(np.float32)[0]
        else:
            out[idx] = (np.frombuffer(word.tobytes(), np.uint16)
                        .astype(np.uint32) << 16).view(np.float32)[0]
    return out


def wgmma_operands(op_a, op_b, prec, g, kk):
    """What one k-step's wgmma of consumer warpgroup g reads through the
    descriptors of ws_mma: (A (64, k), B (k, 128)) as values."""
    m = np.arange(64)[:, None]
    if prec == "high":
        kd = np.arange(8)[None, :]                      # m64n128k8 tf32
        start = 64 * g * 128 + 32 * kk
        a_addr = _sw(start + (m // 8) * 1024 + (m % 8) * 128 + 4 * kd, 128)
        n = np.arange(128)[:, None]
        b_addr = _sw(len(op_a) + 32 * kk + (n // 8) * 1024 + (n % 8) * 128
                     + 4 * kd, 128)
        both = np.concatenate([op_a, op_b])
        return _read(both, a_addr, 4), _read(both, b_addr, 4).T
    kd = np.arange(16)[None, :]                         # m64n128k16 bf16
    start = 64 * g * 64 + 32 * kk                       # K-major, 64B swz
    a_addr = _sw(start + (m // 8) * 512 + (m % 8) * 64 + 2 * kd, 64)
    n = np.arange(128)[None, :]
    kr = np.arange(16)[:, None]                         # MN-major, 128B swz
    b_addr = _sw(len(op_a) + 2048 * kk + (n % 64) * 2 + (n // 64) * 4096
                 + (kr % 8) * 128 + (kr // 8) * 1024, 128)
    both = np.concatenate([op_a, op_b])
    return _read(both, a_addr, 2), _read(both, b_addr, 2)


@pytest.mark.parametrize("prec", ["high", "default"])
def test_producer_layout_read_back_by_wgmma(prec):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((TILE, KS)).astype(np.float32)
    b = rng.standard_normal((KS, TILE)).astype(np.float32)
    a[rng.random(a.shape) < 0.7] = 0.0
    b[rng.random(b.shape) < 0.7] = 0.0
    a[3, 5] = 1e-42                 # rounds to 0: the masks still see it
    b[17, 9] = -1e-42
    a[40:48] = 0.0                  # rows without a non-zero
    op_a, op_b, am, bm, phases = replay_convert(a, b, prec)
    assert all(phases), f"{phases.count(False)} phases meet a bank twice"
    ra = macro.round_operands(torch.from_numpy(a), prec).double().numpy()
    rb = macro.round_operands(torch.from_numpy(b), prec).double().numpy()
    steps = KS // (8 if prec == "high" else 16)
    for g in range(2):
        got = np.zeros((64, TILE))
        for kk in range(steps):
            x, y = wgmma_operands(op_a, op_b, prec, g, kk)
            got += x @ y
        np.testing.assert_allclose(got, ra[64 * g:64 * g + 64] @ rb,
                                   rtol=1e-12, atol=1e-30)
    # the masks: bit l is k = LANE_K[l], A and B alike
    for l in range(32):
        np.testing.assert_array_equal((am >> l) & 1, a[:, LANE_K[l]] != 0)
        np.testing.assert_array_equal((bm >> l) & 1, b[LANE_K[l], :] != 0)
    pattern = ((a != 0).astype(int) @ (b != 0).astype(int)) > 0
    np.testing.assert_array_equal((am[:, None] & bm[None, :]) != 0, pattern)
    assert pattern[3].any()         # the subnormal's row is flagged
    assert sorted(LANE_K.tolist()) == list(range(32))


def test_quad_transpose_is_a_transpose():
    v = np.arange(128, dtype=np.uint32).reshape(32, 4)
    got = _quad_transpose(v)
    for q in range(8):
        np.testing.assert_array_equal(got[4 * q:4 * q + 4],
                                      v[4 * q:4 * q + 4].T)


# --------------------------------------------------------------------------
# the ring protocol

class Bar:
    """An mbarrier: arrival count and completed phases."""

    def __init__(self, count):
        self.count, self.pending, self.phase = count, count, 0

    def arrive(self):
        self.pending -= 1
        assert self.pending >= 0, "more arrivals than the count"
        if self.pending == 0:
            self.phase += 1
            self.pending = self.count

    def ready(self, parity):
        """try_wait.parity: the phase of this parity has completed."""
        return parity != (self.phase & 1)


BIG = 2.0 ** 63


def tile_masks(dense):
    """f32_tile_masks of a (T, 128, 128) table replayed lane by lane: words
    0-3 the columns' non-zeros, 4 the column slabs' marks, 5-8 the rows',
    9 the row slabs' marks."""
    x = dense.numpy() if isinstance(dense, torch.Tensor) else dense
    out = np.zeros((x.shape[0], 10), np.uint32)
    for t in range(x.shape[0]):
        m = [0] * 10
        nz = x[t] != 0
        with np.errstate(invalid="ignore"):
            bad = ~(np.abs(x[t]) < BIG)
        for l in range(32):                 # lane l: columns 4l .. 4l + 3
            cnz = 0
            for e in range(4):
                cnz |= int(nz[:, 4 * l + e].any()) << e
            m[l >> 3] |= cnz << ((4 * l) & 31)
            if bad[:, 4 * l:4 * l + 4].any():
                m[4] |= 1 << (l >> 3)
        for r in range(128):
            if nz[r].any():
                m[5 + (r >> 5)] |= 1 << (r & 31)
            if bad[r].any():
                m[9] |= 1 << (r >> 5)
        out[t] = m
    return out


def slabs_needed(ma, mb):
    n = int(ma[4] | mb[9]) & 0xF
    for s_ in range(4):
        n |= (1 << s_) if int(ma[s_]) & int(mb[5 + s_]) else 0
    return n


def engineered_f32_tiles():
    """Tiles with NaN, +-Inf, values of 2^63 and more, -0.0 only columns,
    subnormals, an empty tile and a full one."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 128, 128)).astype(np.float32)
    x[rng.random(x.shape) < 0.85] = 0.0
    x[0, 3, 99] = np.nan
    x[0, 70, 5] = np.inf
    x[1, 40, 33] = -np.inf
    x[1, 100, 64] = 2.0 ** 63                # marked: at BIG
    x[1, 101, 65] = -3.0e38
    x[2, :, 10:20] = -0.0                    # zeros that are not +0.0
    x[2, 17, 90] = 1e-42                     # a subnormal is a non-zero
    x[2, 120, 7] = -1e-45
    x[3] = 0.0
    x[4] = 1.0
    x[5, 64:, :] = 0.0
    x[5, 60, 127] = 2.0 ** 62                # under BIG: not marked
    return x


def test_tile_masks_plain_is_the_kernels_replay():
    """ops.macro_kernels.tile_masks_plain on float32 tiles (the plain
    version of the masks entry, which the CPU path and the kernel check
    use) equals the lane-by-lane replay of f32_tile_masks, word for word."""
    x = engineered_f32_tiles()
    got = mk.tile_masks_plain(torch.from_numpy(x)).numpy()
    want = tile_masks(x).view(np.int32)
    np.testing.assert_array_equal(got, want)
    assert want[1, 4] == 0b0110 and want[1, 9] == 0b1010     # cols 33 64 65
    assert not want[3].any() and (want[4] == [-1] * 4 + [0] + [-1] * 4
                                  + [0]).all()
    assert want[2, 0] & (0x3FF << 10) == 0 and want[2, 2] >> 26 & 1
    assert want[5, 4] == want[5, 9] == want[5, 7] == want[5, 8] == 0
    mk.reset_launch_counts()
    t = mk.TableMasks(torch.from_numpy(x)).make()     # CPU: plain version
    assert t.ready and torch.equal(t.words, torch.from_numpy(want))
    assert all(v == 0 for v in mk.LAUNCHES.values())


def test_tile_masks_replay_is_the_direct_definition():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 128, 128)).astype(np.float32)
    x[rng.random(x.shape) < 0.9] = 0.0
    x[1, :, 40:70] = 0.0
    x[2, 5, 99] = np.inf
    x[2, 70, 3] = np.nan
    m = tile_masks(x)
    for t in range(3):
        cols = (x[t] != 0).any(axis=0)
        rows = (x[t] != 0).any(axis=1)
        for k in range(128):
            assert bool((m[t, k >> 5] >> (k & 31)) & 1) == cols[k]
            assert bool((m[t, 5 + (k >> 5)] >> (k & 31)) & 1) == rows[k]
    assert m[2, 4] == 0b1001 and m[2, 9] == 0b0101     # cols 99, 3; rows 5, 70
    assert m[0, 4] == m[0, 9] == 0


class StreamTiles:
    LISTED = False

    def __init__(self, seg_ptr, a_idx, b_idx, n_tiles, masks):
        self.seg_ptr, self.a_idx, self.b_idx = seg_ptr, a_idx, b_idx
        self.n_tiles, self.masks = n_tiles, masks

    def range(self, tk):
        if tk >= self.n_tiles:
            return 0, 0, 0, 0
        return int(self.seg_ptr[tk]), int(self.seg_ptr[tk + 1]), 0, 0

    def tiles(self, q):
        return int(self.a_idx[q]), int(self.b_idx[q])

    def row(self, tk):
        return tk


class ListTiles:
    """The .cu's ListTiles, resolved: ticket tk is the walk list's tk-th
    tile (row walk[1 + 2 tk], pairs [walk[2 + 2 tk], walk[4 + 2 tk])),
    n_tiles the list's count; ``launched`` the grid's bound (c_cap)."""
    LISTED = True

    def __init__(self, walk, a_idx, b_idx, c_cap, masks):
        self.walk, self.a_idx, self.b_idx = walk, a_idx, b_idx
        self.n_tiles, self.launched, self.masks = int(walk[0]), c_cap, masks

    def range(self, tk):
        if tk >= self.n_tiles:
            return 0, 0, 0, 0
        return int(self.walk[2 + 2 * tk]), int(self.walk[4 + 2 * tk]), 0, 0

    def tiles(self, q):
        return int(self.a_idx[q]), int(self.b_idx[q])

    def row(self, tk):
        return int(self.walk[1 + 2 * tk]) if tk < self.n_tiles else 0


class ClassTiles:
    LISTED = False

    def __init__(self, ab_bases, p_list, a_offs, b_offs, t, base, n_tiles,
                 masks):
        self.p_ptr = np.concatenate([[0], np.cumsum(p_list)])
        self.ab_bases, self.a_offs, self.b_offs = ab_bases, a_offs, b_offs
        self.t, self.base, self.n_tiles = t, base, n_tiles
        self.masks = masks

    def range(self, tk):
        if tk >= self.n_tiles:
            return 0, 0, 0, 0
        step, tt = divmod(tk, self.t)
        return (int(self.p_ptr[tt]), int(self.p_ptr[tt + 1]),
                int(self.ab_bases[2 * step]), int(self.ab_bases[2 * step + 1]))

    def tiles(self, q):
        return int(self.a_offs[q]), int(self.b_offs[q])

    def row(self, tk):
        return self.base + tk


class PlanTiles:
    """The .cu's PlanTiles: every class of a plan in one launch, ticket tk
    being slab row tk; its class the last whose first row is at most tk
    (the .cu's binary search over the descriptors), then ClassTiles' tile
    (step, tt) of the concatenated tables (ops.stencil.plan_tables)."""
    LISTED = False

    def __init__(self, tables, masks):
        ab, p_ptr, ao, bo, desc, n_rows = tables
        self.ab_bases, self.p_ptr, self.a_offs, self.b_offs = (
            np.asarray(x) for x in (ab, p_ptr, ao, bo))
        self.desc, self.n_tiles, self.masks = desc, n_rows, masks

    def class_of(self, tk):
        c, s = 0, mk.PLAN_MAX_CLASSES // 2
        while s:
            if c + s < len(self.desc) and self.desc[c + s][0] <= tk:
                c += s
            s >>= 1
        return c

    def range(self, tk):
        if tk >= self.n_tiles:
            return 0, 0, 0, 0
        first, t, step0, ptr0 = (int(x) for x in self.desc[self.class_of(tk)])
        step, tt = divmod(tk - first, t)
        ab = 2 * (step0 + step)
        return (int(self.p_ptr[ptr0 + tt]), int(self.p_ptr[ptr0 + tt + 1]),
                int(self.ab_bases[ab]), int(self.ab_bases[ab + 1]))

    def tiles(self, q):
        return int(self.a_offs[q]), int(self.b_offs[q])

    def row(self, tk):
        return tk


class Issuer:
    """The issue cursor of producer warp 0 (lane values as lists): the
    claim pipeline ticket -> range -> tiles -> masks (and a LISTED walk's
    C row) -> issued, one step a tile; the tile's slabs that run, then a
    stage that stores it."""

    NONE = (0, 0, 0, 0)

    def __init__(self, w, counter):
        self.w, self.counter = w, counter
        n = w.n_tiles
        self.c0 = self.c1 = (n, self.NONE, [])     # (tk, range, tiles)
        self.need0 = []
        self.row0 = 0
        self.tk2, self.r2 = n, self.NONE
        self.tk3 = self.ticket()
        self.done = False
        for _ in range(4):
            self.advance()

    def ticket(self):
        self.counter[0] += 1
        return self.counter[0] - 1

    def lanes(self, frm, to):
        return [self.w.tiles(q) for q in range(frm, min(frm + 32, to))]

    def needs(self, a0, b0, tiles):
        m = self.w.masks
        return [slabs_needed(m[a0 + ta], m[b0 + tb]) for ta, tb in tiles]

    def advance(self):
        self.tk, (self.lo, self.hi, self.a0, self.b0), self.win_tiles = \
            self.c0
        self.nd = self.need0
        self.row = self.row0
        self.win = self.q = self.lo
        self.slab = 0
        self.c0 = self.c1
        if self.w.LISTED:
            self.row0 = self.w.row(self.c0[0])
        _lo, _hi, a0, b0 = self.c0[1]
        self.need0 = self.needs(a0, b0, self.c0[2])
        self.c1 = (self.tk2, self.r2, self.lanes(self.r2[0], self.r2[1]))
        self.tk2 = self.tk3
        self.r2 = self.w.range(self.tk2)
        self.tk3 = self.ticket() if self.tk2 < self.w.n_tiles \
            else self.w.n_tiles

    def publish(self):
        """The next stage: info = (a tile, b tile, row, k0, flags), flags
        DATA 1, LAST 2, DONE 4."""
        if self.tk >= self.w.n_tiles:
            self.done = True
            return (None, None, None, 0, 4)
        bits = 0
        while self.q < self.hi:
            if self.q - self.win == 32:
                self.win = self.q
                self.win_tiles = self.lanes(self.q, self.hi)
                self.nd = self.needs(self.a0, self.b0, self.win_tiles)
            bits = self.nd[self.q - self.win] & (0xF << self.slab)
            if bits:
                break
            self.q += 1
            self.slab = 0
        row = self.row if self.w.LISTED else self.w.row(self.tk)
        if self.q == self.hi:
            self.advance()
            return (None, None, row, 0, 2)
        self.slab = (bits & -bits).bit_length() - 1
        ta, tb = self.win_tiles[self.q - self.win]
        info = (self.a0 + ta, self.b0 + tb, row, KS * self.slab, 1)
        self.slab += 1
        if self.slab == 4:
            self.slab = 0
            self.q += 1
        return info


def block(b, w, counter, R, S, stored, rng):
    """One block's actors (producer warps 0-3, consumer warps 0-7) and its
    copy engine, as generators that yield where the kernel would wait
    (True where they moved on).  Arrivals are counted a warp: the kernel's
    raw_full counts the producer's 128 threads."""
    info_full = [Bar(1) for _ in range(R)]
    raw_full = [Bar(4) for _ in range(R)]
    raw_empty = [Bar(4) for _ in range(R)]
    op_full = [Bar(4) for _ in range(S)]
    op_empty = [Bar(8) for _ in range(S)]
    raw_info = [None] * R           # (stage, info) published in each slot
    raw_readers = [0] * R           # producer warps reading a raw slot
    op_slot = [None] * S
    op_readers = [0] * S            # consumer warps reading it
    op_writers = [0] * S
    copies = []                     # (raw slot, stage) of a warp in flight
    issuer = {}

    def publish(n):
        r = n % R
        assert raw_readers[r] == 0, "raw slot published while read"
        raw_info[r] = (n, issuer["is"].publish())
        info_full[r].arrive()

    def issue(n):
        r = n % R
        while not info_full[r].ready((n // R) & 1):
            yield False
        assert raw_info[r][0] == n
        info = raw_info[r][1]
        if info[4] & 1:
            copies.append((r, n))
        else:
            raw_full[r].arrive()
        yield True
        return not info[4] & 4

    def producer(warp):
        if warp == 0:
            issuer["is"] = Issuer(w, counter)
            for n in range(R):
                if issuer["is"].done:
                    break
                publish(n)
        issuing, n = True, 0
        while n < R and issuing:
            issuing = yield from issue(n)
            n += 1
        n = 0
        while True:
            r, s = n % R, n % S
            while not raw_full[r].ready((n // R) & 1):
                yield False
            assert raw_info[r][0] == n
            info = raw_info[r][1]
            raw_readers[r] += 1
            while not op_empty[s].ready(((n // S) & 1) ^ 1):
                yield False
            assert op_readers[s] == 0, "operand slot written while read"
            op_writers[s] += 1
            yield True                      # the conversion
            op_slot[s] = (n, info)
            op_writers[s] -= 1
            raw_readers[r] -= 1
            op_full[s].arrive()
            raw_empty[r].arrive()
            if info[4] & 4:
                return
            if issuing:
                if warp == 0:
                    while not raw_empty[r].ready((n // R) & 1):
                        yield False
                    publish(n + R)
                issuing = yield from issue(n + R)
            n += 1

    def consumer(cw):
        g = cw // 4
        n, tile = 0, []
        while True:
            s = n % S
            while not op_full[s].ready((n // S) & 1):
                yield False
            assert op_writers[s] == 0 and op_slot[s][0] == n
            info = op_slot[s][1]
            if info[4] & 4:
                return
            op_readers[s] += 1
            yield True                      # wgmma, pattern
            op_readers[s] -= 1
            op_empty[s].arrive()
            if info[4] & 1:
                tile.append(info[:2] + info[3:4])
            if info[4] & 2:
                if cw % 4 == 0:             # one record a warpgroup
                    key = (info[2], g)
                    assert key not in stored, f"row {info[2]} stored twice"
                    stored[key] = (b, tile)
                tile = []
            n += 1

    def engine():
        while True:
            moved = bool(copies)
            if copies:
                r, n = copies.pop(rng.integers(len(copies)))
                assert raw_info[r][0] == n and raw_readers[r] == 0, \
                    "copies land in a slot that is read"
                raw_full[r].arrive()
            yield moved

    actors = [producer(i) for i in range(4)] + [consumer(i)
                                                for i in range(8)]
    return actors, engine()


def run_protocol(w, grid, depths, seed, counter=None):
    """All blocks' actors in a seeded random order: {(row, g): (block,
    [(a tile, b tile, k0), ...])}.  ``counter``: the ticket counter (a
    one-element list, 0 at the launch), read back by the caller."""
    R, S = depths
    rng = np.random.default_rng(seed)
    counter = [0] if counter is None else counter
    stored = {}
    actors, engines = [], []
    for b in range(min(grid, getattr(w, "launched", w.n_tiles))):
        a, e = block(b, w, counter, R, S, stored, rng)
        actors += a
        engines.append(e)
    idle = 0                        # steps since the last progress
    while actors:
        i = rng.integers(len(actors) + len(engines))
        try:
            moved = next(engines[i - len(actors)] if i >= len(actors)
                         else actors[i])
        except StopIteration:
            actors.pop(i)
            moved = True
        idle = 0 if moved else idle + 1
        assert idle < 20_000, "the pipeline does not progress"
    return stored


def _stream(per_tile, seed):
    rng = np.random.default_rng(seed)
    seg = np.repeat(np.arange(len(per_tile)), per_tile)
    n = len(seg)
    return (np.searchsorted(seg, np.arange(len(per_tile) + 1)),
            rng.integers(0, 50, n), rng.integers(0, 50, n))


def _masks_of_bands(n, seed):
    """Masks of n tiles whose non-zeros fill a random block of rows and
    columns (so that a pair's slabs run or not), one with an Inf."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 128, 128), np.float32)
    for t in range(n):
        r0, c0 = rng.integers(0, 112, 2)
        x[t, r0:r0 + rng.integers(1, 40), c0:c0 + rng.integers(1, 40)] = 1.0
    x[7, 3, 3] = np.inf
    return tile_masks(x)


@pytest.mark.parametrize("depths", [(3, 3), (4, 4)])
@pytest.mark.parametrize("grid,seed", [(1, 0), (5, 2)])
def test_pair_stream_protocol(depths, grid, seed):
    """The fresh form (StreamTiles) stores every c_cap tile, the empty ones
    as store-only stages."""
    pair_stream_case(depths, grid, seed, "fresh")


@pytest.mark.parametrize("depths", [(3, 3), (4, 4)])
@pytest.mark.parametrize("grid,seed", [(1, 0), (5, 2)])
def test_pair_stream_protocol_walks_the_tiles_with_pairs(depths, grid, seed):
    """The accumulate form (ListTiles over the walk list, c_cap far above
    the tiles with pairs) visits exactly the tiles with pairs, once each,
    and takes its tickets in stream order, each block one past the list's
    count and no more."""
    pair_stream_case(depths, grid, seed, "accumulate")


def pair_stream_case(depths, grid, seed, form):
    # tiles of 1, 0, 40 (more than a lane window), 3, 0, 0, 2 pairs; a
    # c_cap past them (the accumulate form's far past)
    per_tile = [1, 0, 40, 3, 0, 0, 2, 1, 0, 0]
    if form == "accumulate":
        per_tile += [0] * 30
    seg_ptr, a_idx, b_idx = _stream(per_tile, seed)
    masks = _masks_of_bands(50, seed)
    c_cap = len(per_tile)
    counter = [0]
    if form == "fresh":
        w = StreamTiles(seg_ptr, a_idx, b_idx, c_cap, masks)
    else:
        seg = torch.from_numpy(np.repeat(np.arange(c_cap), per_tile)
                               .astype(np.int32))
        walk = mk.stream_walk(seg, c_cap, min(c_cap, len(a_idx))).numpy()
        w = ListTiles(walk, a_idx, b_idx, c_cap, masks)
    stored = run_protocol(w, grid, depths, seed, counter)
    skipped = 0
    with_pairs = [c for c in range(c_cap) if per_tile[c]]
    for c in range(c_cap) if form == "fresh" else with_pairs:
        want = [(int(a_idx[q]), int(b_idx[q]), KS * s_)
                for q in range(seg_ptr[c], seg_ptr[c + 1]) for s_ in range(4)
                if slabs_needed(masks[a_idx[q]], masks[b_idx[q]]) >> s_ & 1]
        skipped += 4 * (seg_ptr[c + 1] - seg_ptr[c]) - len(want)
        for g in range(2):
            assert stored[(c, g)][1] == want, (c, g)
        assert stored[(c, 0)][0] == stored[(c, 1)][0]   # one owner block
    if form == "fresh":
        assert len(stored) == 2 * c_cap
    else:
        assert sorted({row for row, _g in stored}) == with_pairs
        assert len(stored) == 2 * len(with_pairs)
        assert counter[0] == len(with_pairs) + min(grid, c_cap)
        # a block takes its tiles in ticket order, and ticket i is the
        # i-th tile with pairs: each block's tiles ascend in the stream
        for b in range(grid):
            rows = [row for (row, g), (blk, _) in stored.items()
                    if blk == b and g == 0]
            assert rows == sorted(rows)
    assert 0 < skipped < 4 * seg_ptr[-1]


def walk_numpy(seg, c_cap, cap):
    """stream_walk's list from a sorted stream, in numpy."""
    seg = np.asarray(seg, np.int64)
    tiles = np.unique(seg[seg < c_cap])
    firsts = np.searchsorted(seg, tiles)
    end = int(np.searchsorted(seg, c_cap))
    out = [len(tiles)]
    for i in range(cap + 1):
        out += [int(tiles[i]), int(firsts[i])] if i < len(tiles) \
            else [c_cap, end]
    return np.array(out, np.int32)


def replay_walk_kernel(seg, c_cap, cap, threads=1024, pairs=4):
    """stream_walk_kernel replayed step by step: ``pairs`` consecutive
    pairs a thread, those that start a tile found against their left
    neighbour, each thread's place from an inclusive scan over its warp
    and the counts of the warps before it, the count and the live pairs
    carried; the walk stops after the first step that is not all live;
    then the entries past the count."""
    seg = np.asarray(seg, np.int64)
    p_cap = len(seg)
    walk = np.full(2 * cap + 3, -7, np.int64)
    count = live_pairs = 0
    for base in range(0, p_cap, threads * pairs):
        q0 = base + pairs * np.arange(threads)
        prev = np.where((q0 > 0) & (q0 <= p_cap),
                        seg[np.clip(q0 - 1, 0, p_cap - 1)], -1)
        q = q0[:, None] + np.arange(pairs)
        v = np.where(q < p_cap, seg[np.minimum(q, p_cap - 1)], c_cap)
        live = v < c_cap
        left = np.concatenate([prev[:, None], v[:, :-1]], 1)
        first = live & (v != left)
        n = first.sum(1)
        per_warp = n.reshape(-1, 32)
        incl = per_warp.cumsum(1).reshape(-1)
        before = np.concatenate([[0], np.cumsum(per_warp.sum(1))[:-1]])
        idx0 = count + before[np.arange(threads) // 32] + incl - n
        for t in np.nonzero(n)[0]:
            idx = int(idx0[t])
            for e in np.nonzero(first[t])[0]:
                if idx <= cap:
                    walk[1 + 2 * idx], walk[2 + 2 * idx] = v[t, e], q[t, e]
                idx += 1
        count += int(n.sum())
        live_pairs += int(live.sum())
        if live.sum() < threads * pairs:
            break
    for i in range(count, cap + 1):
        walk[1 + 2 * i], walk[2 + 2 * i] = c_cap, live_pairs
    walk[0] = min(count, cap)
    return walk.astype(np.int32)


def test_source_has_the_walk_kernels_lines():
    text = _source()
    for line in ("constexpr int WALK_THREADS = 1024;",
                 "constexpr int WALK_PAIRS = 4;",
                 "        int prev = q0 > 0 && q0 <= p_cap ? seg[q0 - 1] : "
                 "-1;",
                 "            const bool first = is_live && v[e] != prev;",
                 "        int idx = count + before + incl - n;",
                 "        if (live_total < WALK_THREADS * WALK_PAIRS) break;",
                 "        walk[2 + 2 * i] = live_pairs;",
                 "    if (t == 0) walk[0] = count < cap ? count : cap;"):
        assert text.count(line) == 1, line


@pytest.mark.parametrize("case", ["seed0", "seed1", "far_c_cap", "empty",
                                  "long"])
def test_stream_walk_is_the_list_of_the_tiles_with_pairs(case):
    """The walk list on random sorted streams of tiles of 0-40 pairs,
    padding at INT32_MAX (and pairs of tiles past c_cap), a c_cap far above
    the tile count, an empty stream, and one of several 4,096-pair steps
    with tiles across their edges: the plain version (stream_walk on CPU
    tensors) and the kernel's step replay both equal numpy's, at cap =
    min(c_cap, p_cap) as the wrapper passes it."""
    rng = np.random.default_rng({"seed0": 0, "seed1": 1, "far_c_cap": 2,
                                 "empty": 3, "long": 4}[case])
    n_tiles = 200 if case == "long" else 60
    per_tile = rng.integers(0, 41, n_tiles) * (rng.random(n_tiles) < 0.4)
    if case == "empty":
        per_tile[:] = 0
    if case == "long":
        per_tile[[3, 77, 150]] = (3000, 4100, 1500)  # across step edges
    seg = np.repeat(np.arange(n_tiles), per_tile)
    c_cap = {"far_c_cap": 5000, "seed1": 45}.get(case, n_tiles)
    p_cap = -(-max(1, len(seg) + 7) // 256) * 256
    seg = np.concatenate([seg, np.full(p_cap - len(seg), symbolic.INT32_MAX)])
    seg_t = torch.from_numpy(seg.astype(np.int32))
    cap = min(c_cap, p_cap)
    got = mk.stream_walk(seg_t, c_cap, cap)
    want = walk_numpy(seg, c_cap, cap)
    assert got.dtype == torch.int32 and got.shape == (2 * cap + 3,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(replay_walk_kernel(seg, c_cap, cap), want)
    assert int(got[0]) == len(np.unique(seg[seg < c_cap]))
    if case == "long":
        assert p_cap > 2 * 4096


@pytest.fixture(scope="module")
def run_plan():
    a = coo_to_macro(wandering_device(n=4096, seed=4, device="cpu"),
                     device="cpu")
    offsets = symbolic.pair_counts(a.tile_col, a.tile_rowptr, a.ntiles)
    n_pairs = int(offsets[-1])
    p_cap = max(256, -(-n_pairs // 256) * 256)
    out = symbolic.expand_pairs(offsets, a.tile_row, a.tile_col,
                                a.tile_rowptr, a.tile_col, n_pairs, p_cap,
                                True)
    c_row, c_col, a_idx, b_idx, seg, n_tiles = out
    plan = st.plan_runs(seg, a_idx, b_idx, c_row, c_col, n_pairs,
                        int(n_tiles), a.dense.shape[0], a.dense.shape[0])
    assert plan.classes
    return a, plan


def test_class_launch_protocol_against_the_plain_class_call(run_plan):
    """Each class of a run plan walked by the persistent tiles (ticket tk =
    step tk / t, tile tk % t), products summed from the stages the
    consumers saw, against class_call_plain on the same class."""
    a, plan = run_plan
    dense = a.dense.double().numpy()
    masks = tile_masks(a.dense)
    for i, (cls, bases) in enumerate(zip(plan.classes, plan.class_bases)):
        t, p, _ar, _br, a_offs, b_offs, _base = cls
        n_steps = bases.numel() // 2
        p_list = st.p_list_of(t, p)
        w = ClassTiles(bases.numpy(), p_list, np.asarray(a_offs),
                       np.asarray(b_offs), t, 0, n_steps * t, masks)
        stored = run_protocol(w, 3, (4, 4), seed=i)
        rows = n_steps * t
        got = np.zeros((rows, TILE, TILE))
        got_f = np.zeros((rows, TILE, TILE), bool)
        for row in range(rows):
            assert stored[(row, 0)][1] == stored[(row, 1)][1]
            for ta, tb, k0 in stored[(row, 0)][1]:
                x = dense[ta][:, k0:k0 + KS]
                y = dense[tb][k0:k0 + KS]
                got[row] += x @ y
                got_f[row] |= ((x != 0).astype(int) @ (y != 0)) > 0
        want_n = torch.full((rows, TILE, TILE), float("nan"))
        want_f = torch.full((rows, TILE, TILE), 7, dtype=torch.uint8)
        st.class_call_plain(want_n, want_f, a.dense, a.dense, bases, t, p,
                            a_offs, b_offs, 0)
        np.testing.assert_array_equal(got_f, want_f.numpy() > 0)
        np.testing.assert_allclose(got, want_n.double().numpy(), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------------
# every class of a plan in one launch (PlanTiles)

def test_source_has_the_plan_walks_lines():
    text = _source()
    for line in (
            "constexpr int PLAN_MAX_CLASSES = 32;",
            "            for (int s = PLAN_MAX_CLASSES / 2; s > 0; s >>= 1)\n"
            "                if (c + s < n_classes && cls[c + s].first <= tk) "
            "c += s;",
            "            const int k = tk - pc.first, step = k / pc.t, "
            "tt = k - step * pc.t;",
            "            lo = p_ptr[pc.ptr + tt];",
            "            hi = p_ptr[pc.ptr + tt + 1];",
            "            a0 = ab_bases[2 * (pc.step + step)];",
            "            b0 = ab_bases[2 * (pc.step + step) + 1];",
            "        return launch_tiles<P, PlanTiles, false>("):
        assert text.count(line) == 1, line
    assert mk.PLAN_MAX_CLASSES == st.MAX_CLASSES_R >= st.MAX_CLASSES


def _engineered_plan(which):
    """(classes, class_bases, masks) of a hand-made plan whose classes lie
    back to back from row 0: "three" a ragged class with a tile of 0 pairs
    (1/0/9/3), a uniform one (2 a tile) and a ragged one whose tile of 70
    pairs is more than a lane window (1/70/0/3/2); "one" the first alone."""
    rng = np.random.default_rng(31)
    kinds = [(4, (1, 0, 9, 3), 3), (3, 2, 4), (5, (1, 70, 0, 3, 2), 2)]
    classes, bases_l, row = [], [], 0
    for t, p, n_steps in kinds[:1 if which == "one" else 3]:
        n_p = sum(st.p_list_of(t, p))
        a_offs = tuple(int(x) for x in rng.integers(0, 12, n_p))
        b_offs = tuple(int(x) for x in rng.integers(0, 12, n_p))
        classes.append((t, p, 12, 12, a_offs, b_offs, row))
        bases_l.append(torch.from_numpy(
            rng.integers(0, 38, 2 * n_steps).astype(np.int32)))
        row += n_steps * t
    return tuple(classes), tuple(bases_l), _masks_of_bands(50, 31)


def _plan_cases(run_plan, which):
    if which in ("one", "three"):
        return _engineered_plan(which)
    a, plan = run_plan
    return plan.classes, plan.class_bases, tile_masks(a.dense)


@pytest.mark.parametrize("which", ["run_plan", "three", "one"])
def test_plan_walk_is_the_class_walks_ticket_by_ticket(run_plan, which):
    """PlanTiles' ticket tk against the ClassTiles walk of its class at tk
    less the class's first row, for every ticket of every class (their
    boundaries included) and past the last: the slab row, the pair range
    (less the pairs of the classes before), the step's bases and the
    operand tiles of each pair."""
    classes, class_bases, masks = _plan_cases(run_plan, which)
    w = PlanTiles(st.plan_tables(classes, class_bases, "cpu"), masks)
    pairs = 0
    for (t, p, _ar, _br, a_offs, b_offs, base), bases in zip(classes,
                                                               class_bases):
        n_steps = bases.numel() // 2
        cw = ClassTiles(bases.numpy(), st.p_list_of(t, p),
                        np.asarray(a_offs), np.asarray(b_offs), t, base,
                        n_steps * t, masks)
        for tk in range(n_steps * t):
            lo, hi, a0, b0 = w.range(base + tk)
            c_lo, c_hi, c_a0, c_b0 = cw.range(tk)
            assert (lo - pairs, hi - pairs, a0, b0) == \
                (c_lo, c_hi, c_a0, c_b0), (base, tk)
            assert w.row(base + tk) == cw.row(tk)
            assert [w.tiles(q) for q in range(lo, hi)] == \
                [cw.tiles(q) for q in range(c_lo, c_hi)]
        pairs += sum(st.p_list_of(t, p))
    assert w.range(w.n_tiles) == w.range(w.n_tiles + 40) == (0, 0, 0, 0)
    assert w.n_tiles == sum(c[0] * (b.numel() // 2)
                            for c, b in zip(classes, class_bases))


@pytest.mark.parametrize("which", ["run_plan", "three", "one"])
@pytest.mark.parametrize("grid,seed", [(1, 0), (5, 2)])
def test_plan_walk_protocol(run_plan, which, grid, seed):
    """One launch over every class of a plan through the ring protocol:
    every slab row stored once by one block, with its pairs' slabs that
    the masks call, in order (a tile of 0 pairs as a store-only stage);
    tickets in slab order, each block one past the rows and no more."""
    classes, class_bases, masks = _plan_cases(run_plan, which)
    tables = st.plan_tables(classes, class_bases, "cpu")
    w = PlanTiles(tables, masks)
    counter = [0]
    stored = run_protocol(w, grid, (4, 4), seed, counter)
    n_rows = w.n_tiles
    assert len(stored) == 2 * n_rows
    assert counter[0] == n_rows + min(grid, n_rows)
    for row in range(n_rows):
        lo, hi, a0, b0 = w.range(row)
        want = []
        for q in range(lo, hi):
            ta, tb = w.tiles(q)
            need = slabs_needed(masks[a0 + ta], masks[b0 + tb])
            want += [(a0 + ta, b0 + tb, KS * s_) for s_ in range(4)
                     if need >> s_ & 1]
        for g in range(2):
            assert stored[(row, g)][1] == want, (row, g)
        assert stored[(row, 0)][0] == stored[(row, 1)][0]
    for b in range(grid):
        rows = [row for (row, g), (blk, _) in stored.items()
                if blk == b and g == 0]
        assert rows == sorted(rows)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_cpu_wrappers_take_the_plain_version_at_each_mode(run_plan,
                                                          precision):
    """On CPU tiles every float32 entry's wrapper returns its plain version
    at the mode and counts no launch; an unknown mode raises."""
    a, plan = run_plan
    mk.reset_launch_counts()
    cls, bases, tables = plan.classes[0], plan.class_bases[0], \
        plan.class_tables[0]
    t, p, ar, br, a_offs, b_offs, _base = cls
    n_steps = bases.numel() // 2
    slabs = (torch.zeros((n_steps * t, TILE, TILE)),
             torch.zeros((n_steps * t, TILE, TILE), dtype=torch.uint8))
    want = (slabs[0].clone(), slabs[1].clone())
    st.class_call_plain(*want, a.dense, a.dense, bases, t, p, a_offs, b_offs,
                        0, precision)
    got = mk.class_call2(*slabs, a.dense, a.dense, bases, t, p, ar, br,
                         a_offs, b_offs, 0, n_steps, tables=tables,
                         precision=precision)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    seg = torch.full((256,), symbolic.INT32_MAX, dtype=torch.int32)
    seg[:3] = torch.tensor([0, 0, 2], dtype=torch.int32)
    idx = torch.zeros(256, dtype=torch.int32)
    num, flags = mk.accumulate_macro_pairs(a.dense, a.dense, idx, idx, seg,
                                           4, precision=precision)
    assert num.shape == (4, TILE, TILE) and not flags[1].any()
    assert all(v == 0 for v in mk.LAUNCHES.values())
    with pytest.raises(ValueError):
        mk.class_call2(*slabs, a.dense, a.dense, bases, t, p, ar, br,
                       a_offs, b_offs, 0, n_steps, tables=tables,
                       precision="fast")


# --------------------------------------------------------------------------
# the consumers' C store

def test_store_cs_writes_the_fragment_in_16_byte_pieces():
    """Frag::store_cs replayed for one warp: its 16 rows of a C tile from
    the wgmma fragment (d[4j + e]: row l / 4 + 8 (e / 2), column 8j +
    2 (l % 4) + e % 2; flag bit 2j + e % 2 of f[e / 2]), the quad's
    exchanges by shuffles, and every store 16 bytes, aligned: values and
    flags land where the fragment says, and each row is written once."""
    text = _source()
    for line in ("odd ? make_float4(s0, s1, c0, c1)",
                 ": make_float4(a0, a1, s0, s1);",
                 "float4* p = reinterpret_cast<float4*>(cr + 8 * (j + odd)",
                 "w[ww] = (nib * 0x00204081u) & 0x01010101u;",
                 "uint4* fp = reinterpret_cast<uint4*>(fr + 32 * q);",
                 "__stcs(fp + 1, w1);"):
        assert text.count(line) == 1, line
    rng = np.random.default_rng(9)
    want_v = rng.standard_normal((16, TILE)).astype(np.float32)
    want_f = rng.random((16, TILE)) < 0.4
    lanes = np.arange(32)
    sums = np.zeros((32, 64), np.float32)
    f = np.zeros((32, 2), np.uint64)
    for l in lanes:
        for j in range(16):
            for e in range(4):
                r, c = l // 4 + 8 * (e // 2), 8 * j + 2 * (l % 4) + e % 2
                sums[l, 4 * j + e] = want_v[r, c]
                if want_f[r, c]:
                    f[l, e // 2] |= np.uint64(1 << (2 * j + e % 2))
    got_v = np.full((16, TILE), np.nan, np.float32)
    got_f = np.full((16, TILE), 7, np.uint8)
    q, odd = lanes & 3, lanes & 1
    for e2 in range(2):
        rows = lanes // 4 + 8 * e2
        for j in range(0, 16, 2):
            a0, a1 = sums[:, 4 * j + 2 * e2], sums[:, 4 * j + 2 * e2 + 1]
            c0 = sums[:, 4 * j + 4 + 2 * e2]
            c1 = sums[:, 4 * j + 4 + 2 * e2 + 1]
            s0 = np.where(odd, a0, c0)[lanes ^ 1]
            s1 = np.where(odd, a1, c1)[lanes ^ 1]
            col = 8 * (j + odd) + 4 * (q >> 1)
            vals = np.where(odd[:, None], np.stack([s0, s1, c0, c1], 1),
                            np.stack([a0, a1, s0, s1], 1))
            for l in lanes:
                assert np.isnan(got_v[rows[l], col[l]:col[l] + 4]).all()
                got_v[rows[l], col[l]:col[l] + 4] = vals[l]
        word = f[:, e2].astype(np.uint64)
        for l in lanes:
            b = [(int(word[(l & ~3) | s_]) >> (8 * q[l])) & 0xFF
                 for s_ in range(4)]
            out = []
            for ww in range(8):
                jj, s0_ = ww >> 1, 2 * (ww & 1)
                nib = ((b[s0_] >> (2 * jj)) & 3) | (
                    ((b[s0_ + 1] >> (2 * jj)) & 3) << 2)
                out.append((nib * 0x00204081) & 0x01010101)
            row_bytes = np.array(out, np.uint32).view(np.uint8)
            assert (got_f[rows[l], 32 * q[l]:32 * q[l] + 32] == 7).all()
            got_f[rows[l], 32 * q[l]:32 * q[l] + 32] = row_bytes
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f.astype(np.uint8))
