"""Macro128 accumulation kernels: wrappers of csrc/macro_accumulate.cu.

Counterpart of the JAX package's ops/pallas_macro2.py and of the kernel
half of its ops/pallas_stencil.py.  These entries, one CUDA source (built
with nvcc at first use and bound with ctypes by ops/_build.py):

  accumulate_macro_pairs   a pair stream sorted by C tile:
                           C[seg[p]] += A[a_idx[p]] @ B[b_idx[p]]
                           (accumulate_macro_pipelined of the reference);
                           the macro engine's interactive multiply, its
                           MacroPlan steady multiply and the stencil plan's
                           residual pairs; with ``out=`` its accumulate
                           form, which adds into a C the caller holds (the
                           Macro128 ring's stages after the first);
  classes_call             every signature class of a stencil / run plan
                           in one launch (the stencil plan's steady
                           multiply; the reference calls one kernel a
                           class);
  class_call2              one signature class of a stencil / run plan, per
                           tile pair counts ragged or uniform;
  class_call               the same for uniform pair counts only (the
                           reference's single-buffered class kernel, which
                           has no caller in either package);
  accumulate_macro_pairs   for float64 tiles (the f64 parity mode) the pair
  (float64)                stream's float64 entry: one block a C tile, its
                           product on the FP64 tensor cores (mma.sync f64,
                           DMMA) over a ring of k-slabs staged by cp.async;
                           the k-slabs and the DMMA blocks that multiply
                           only zeros are skipped (never where an Inf or a
                           NaN is among their operands); the same contract
                           and flags;
  TableMasks.make          the k-masks of one tile table (the slabs a pair
                           runs come from its two tiles' masks), one launch
                           a table, read by the entries' later launches;
  stream_walk              the list of a sorted pair stream's C tiles with
                           pairs, which the accumulate form walks.

The three float32 entries compute their 128x128x128 products on the
tensor cores (wgmma; a slab holding an Inf, a NaN or a value of 2^63 or
more runs in FP32 FMA, so non-finite operands give IEEE results) at the
caller's ``precision``, which the kernel takes as a template argument:
"highest" splits each operand into hi + lo (3xTF32, 3 wgmma a k-step,
float32 accuracy) on a 256-thread stage; "high" and "default" multiply its
tf32 or bfloat16 rounding once (tf32 or bf16 wgmma;
``ops.macro.round_operands`` then the "highest" plain version is their
plain version) in a warp-specialised pipeline (a producer warpgroup copies
and rounds the slabs, two consumer warpgroups multiply).  Every entry forms
the structural pattern of the same products as uint8 flags from the raw
values (see ops/macro.py).  Every C tile is written once by the block that
owns it: the float64 entry launches one block a tile; every float32 launch,
at every precision, one persistent block an SM (``persistent_grid``),
taking tiles in order from a counter the wrapper zeroes and running them as
one stream of stages, of which it copies and multiplies only the k-slabs
of a pair that its tiles' k-masks call non-zero (so every launch on the
card reads the tables' masks: ``reads_masks``).  The accumulate form walks
only the C tiles the stream has pairs for (``stream_walk``: a list built
on the device by one small launch, no host sync).

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernel (or raise, if the build or the launch fails); CPU tensors take
the plain PyTorch version (``ops.macro.accumulate_macro``,
``ops.stencil.class_call_plain``, ``ops.stencil.classes_call_plain``).
``SpGEMMConfig.use_pallas`` is not read.  Each wrapper adds one to its
entry in ``LAUNCHES`` where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from pem_spgemm_tpu_torch.config import precision_code
from pem_spgemm_tpu_torch.ops import _build
from pem_spgemm_tpu_torch.ops.macro import TILE, accumulate_macro
from pem_spgemm_tpu_torch.ops.stencil import (class_call_plain,
                                              classes_call_plain, p_list_of)

SOURCE = _build.cuda_source("macro_accumulate")
F64_MASK_WORDS = 10     # the float64 entry's k-mask words a tile (the .cu's)
TM_WORDS = 10           # the one-pass pipeline's k-mask words a tile
BIG = 2.0 ** 63         # the .cu's BIG: a float32 of this magnitude or more
                        # marks its slab

# kernel launches per entry (plain-version calls are not counted); the
# pair-stream entries' accumulate form (``out=``) counts under its own key,
# the masks entries (TableMasks.make) and the walk (stream_walk) under theirs
LAUNCHES = {"macro_accumulate_pairs": 0, "macro_classes": 0,
            "macro_class_ragged": 0, "macro_class_uniform": 0,
            "macro_accumulate_pairs_f64": 0, "macro_accumulate_pairs_acc": 0,
            "macro_accumulate_pairs_f64_acc": 0, "macro_tile_masks": 0,
            "macro_tile_masks_f64": 0, "macro_stream_walk": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # masks_a, masks_b, n_a, n_b, ready_a, ready_b
    masks = [vp, vp, ci, ci, ci, ci]
    lib.macro_accumulate_pairs_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                               ci, ci, vp, ci, *masks, ci,
                                               vp, vp]
    lib.macro_class_ragged_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                           ll, vp, vp, ci, ci, vp, *masks,
                                           vp]
    lib.macro_class_uniform_f32.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                            ll, vp, vp, ci, ci, vp, *masks,
                                            vp]
    lib.macro_classes_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, vp, ci, vp,
                                      vp, ci, ci, vp, *masks, vp]
    lib.macro_accumulate_pairs_f64.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                               ci, ci, ci, ci, vp, vp, ci,
                                               ci, vp, ci, vp, vp]
    lib.macro_tile_masks_f32.argtypes = [vp, ci, vp, vp]
    lib.macro_tile_masks_f64.argtypes = [vp, ci, vp, vp]
    lib.macro_stream_walk.argtypes = [vp, ci, ci, ci, vp, vp, vp]
    for fn in (lib.macro_accumulate_pairs_f32, lib.macro_class_ragged_f32,
               lib.macro_class_uniform_f32, lib.macro_classes_f32,
               lib.macro_accumulate_pairs_f64, lib.macro_tile_masks_f32,
               lib.macro_tile_masks_f64, lib.macro_stream_walk):
        fn.restype = ci


def _library():
    return _build.cuda_library("macro_accumulate", _declare)


# --------------------------------------------------------------------------
# argument checks

def _check_tiles(x, name, device=None):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.dim() != 3 or tuple(x.shape[1:]) != (TILE, TILE):
        raise ValueError(f"{name} must be (tiles, {TILE}, {TILE}), got "
                         f"{tuple(x.shape)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_i32(x, name, device, numel=None):
    if (not isinstance(x, torch.Tensor) or x.dtype != torch.int32
            or x.dim() != 1 or x.device != device or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor on "
                         f"{device}")
    if numel is not None and x.numel() != numel:
        raise ValueError(f"{name} has {x.numel()} entries, expected {numel}")


def _require_on_gpu(tensors, dtypes):
    """CUDA tiles must have one dtype of ``dtypes`` (the kernels' entries)
    and lie 16-byte aligned."""
    for x in tensors:
        if x.is_cuda and (x.dtype not in dtypes
                          or x.dtype != tensors[0].dtype):
            raise NotImplementedError(
                f"{x.dtype} tiles on the GPU: this kernel entry takes "
                f"{' or '.join(str(d) for d in dtypes)} tiles, all of one "
                "dtype")
        if x.is_cuda and x.data_ptr() % 16:
            raise ValueError("tile tables must be 16-byte aligned")


def _raise_on(err, entry):
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {err}")


def _pack_bits(bits):
    """(T, 32 w) bool -> (T, w) int32: bit b of word i is column 32 i + b
    (a 32-bit pattern in two's complement)."""
    t, n = bits.shape
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    words = (bits.view(t, n // 32, 32).to(torch.int64) * weights).sum(2)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words) \
        .to(torch.int32)


def _slab_word(bad, width):
    """(T, 128) bool -> (T, 1) int32: bit s where entries [width s, width s
    + width) hold a marked value."""
    slabs = bad.view(bad.shape[0], 128 // width, width).any(2)
    pad = torch.zeros((bad.shape[0], 32 - slabs.shape[1]), dtype=torch.bool,
                      device=bad.device)
    return _pack_bits(torch.cat([slabs, pad], 1))


def tile_masks_plain(tiles, per=1024):
    """(T, 10) int32: the k-masks of a (T, 128, 128) tile table, bit for bit
    the masks entry of its dtype (plain version of ``TableMasks.make``).
    Words 0-3 bit k: column k holds a non-zero (-0.0 is zero; a subnormal,
    an Inf or a NaN is not); word 4: the marked column slabs; words 5-8 and
    9 the same of the rows.  float32 (f32_tile_masks): a slab is 32 wide
    and marked by a value of 2^63 or more in magnitude, an Inf or a NaN;
    float64 (f64_tile_masks): 16 wide, marked by an Inf or a NaN.  Taken
    ``per`` tiles at a time."""
    f64 = tiles.dtype == torch.float64
    out = torch.empty((tiles.shape[0], 10), dtype=torch.int32,
                      device=tiles.device)
    for lo in range(0, tiles.shape[0], per):
        x = tiles[lo:lo + per]
        nz = x != 0
        bad = ~torch.isfinite(x) if f64 else ~(x.abs() < BIG)
        width = 16 if f64 else 32
        out[lo:lo + per] = torch.cat(
            [_pack_bits(nz.any(1)), _slab_word(bad.any(1), width),
             _pack_bits(nz.any(2)), _slab_word(bad.any(2), width)], 1)
    return out


def reads_masks(table) -> bool:
    """Whether a launch on ``table`` reads tile masks: every launch on a
    CUDA table (each runs only the slabs its tiles' masks call non-zero,
    at every precision, fresh or accumulating); the plain version on a CPU
    table reads none."""
    return table.is_cuda


class TableMasks:
    """The k-masks of one tile table in its dtype's layout (TM_WORDS int32 a
    tile for float32, the one-pass pipeline's; F64_MASK_WORDS for float64,
    the float64 entry's; ``tile_masks_plain`` says what they hold).  One
    launch makes them (``make``: the masks entry on the card, counted, the
    plain version on the CPU) and the entries' later launches read them
    with their ready flag set.  ``words`` may be received from another
    rank (the Macro128 ring passes a chunk's masks with the chunk): the
    receiver sets ``ready``.  A bfloat16 table's masks are those of its
    float32 copy, in the float32 layout (a bfloat16 value is zero, or
    marked, exactly where its float32 copy is): ``make`` reads the copy,
    and the Macro128 ring carries them with a bfloat16 chunk for the
    float32 buffer K4 reads it from."""

    def __init__(self, table):
        _check_tiles(table, "table")
        if table.dtype not in (torch.float32, torch.float64, torch.bfloat16):
            raise NotImplementedError(f"masks of {table.dtype} tiles")
        self.table = table
        words = F64_MASK_WORDS if table.dtype == torch.float64 else TM_WORDS
        self.words = torch.empty((table.shape[0], words), dtype=torch.int32,
                                 device=table.device)
        self.ready = False

    def matches(self, table) -> bool:
        t = self.table
        return (table.data_ptr() == t.data_ptr() and table.shape == t.shape
                and table.dtype == t.dtype and table.device == t.device)

    def make(self):
        """Make the masks of the table now; returns self."""
        t = self.table
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        if not t.is_cuda:
            self.words.copy_(tile_masks_plain(t))
        elif t.shape[0]:
            f64 = t.dtype == torch.float64
            entry = "macro_tile_masks_f64" if f64 else "macro_tile_masks"
            fn = _library().macro_tile_masks_f64 if f64 \
                else _library().macro_tile_masks_f32
            with torch.cuda.device(t.device):
                _raise_on(fn(t.data_ptr(), t.shape[0], self.words.data_ptr(),
                             torch.cuda.current_stream().cuda_stream), entry)
            LAUNCHES[entry] += 1
        self.ready = True
        return self


class TileMasks:
    """The k-masks of a launch's two tables: A's and B's ``TableMasks``
    (one where the tables are one), each computed by the first launch that
    is handed them unless ready, and read by the later ones.
    ops.stencil.stencil_accumulate hands one to both launches of a
    multiply, so the tables are read once for them; a launch without one
    computes its own.  ``a`` / ``b``: a table's masks made elsewhere (the
    ones a Macro128 operand keeps, ``operand_masks``; the Macro128 ring's,
    made once a plan and carried with the chunk)."""

    def __init__(self, a_dense, b_dense, a=None, b=None):
        self.a = a if a is not None else TableMasks(a_dense)
        same = b_dense.data_ptr() == a_dense.data_ptr() \
            and b_dense.shape == a_dense.shape
        self.b = b if b is not None else self.a if same \
            else TableMasks(b_dense)

    def args(self, a_dense, b_dense):
        """The entries' (masks_a, masks_b, n_a, n_b, ready_a, ready_b)."""
        if not (self.a.matches(a_dense) and self.b.matches(b_dense)):
            raise ValueError("tile masks of other tables")
        return (self.a.words.data_ptr(), self.b.words.data_ptr(),
                a_dense.shape[0], b_dense.shape[0], int(self.a.ready),
                int(self.b.ready))

    def made(self):
        """After a launch: both tables' masks are made."""
        self.a.ready = self.b.ready = True


def operand_masks(am, bm):
    """The ``TileMasks`` of two Macro128 operands' tables (``acc_dense``)
    from the masks each operand keeps (``MacroMatrix.tile_masks``: made
    once, made again where the values changed), one set where B is A; None
    on CPU tables, where no plain version reads masks."""
    a_dense, b_dense = am.acc_dense(), bm.acc_dense()
    if not reads_masks(a_dense):
        return None
    return TileMasks(a_dense, b_dense, a=am.tile_masks(), b=bm.tile_masks())


def _mask_args(a_dense, b_dense, tile_masks):
    """(masks, the entries' six mask arguments) of a launch on the card:
    ``tile_masks``, or masks of its own that the launch makes."""
    masks = tile_masks if tile_masks is not None else TileMasks(a_dense,
                                                                b_dense)
    return masks, masks.args(a_dense, b_dense)


# --------------------------------------------------------------------------
# the pair-stream entry

def segment_offsets(seg, c_cap: int):
    """(c_cap + 1,) i32: tile c owns the pairs [out[c], out[c + 1]) of the
    sorted stream ``seg``.  Padding pairs (seg = INT32_MAX) and pairs of
    tiles >= c_cap lie past out[c_cap]."""
    edges = torch.arange(c_cap + 1, dtype=torch.int32, device=seg.device)
    return torch.searchsorted(seg, edges, out_int32=True)


def stream_walk_plain(seg, c_cap: int, cap: int):
    """The plain version of ``stream_walk``: (2 cap + 3,) i32, the C tiles
    below c_cap that the sorted stream ``seg`` has pairs for, in stream
    order, as the accumulate form walks them (the .cu's ListTiles): [0]
    their count T; [1 + 2 i] the i-th tile and [2 + 2 i] its first pair,
    for i <= cap; past the count the tile is c_cap and the pair the
    stream's end seg_ptr[c_cap] (entry T bounds tile T - 1's pairs).
    ``cap`` at least T (min(c_cap, p_cap) always is)."""
    dev = seg.device
    seg_ptr = segment_offsets(seg, c_cap)
    has = torch.cumsum(seg_ptr[1:] > seg_ptr[:-1], 0, dtype=torch.int32)
    if has.numel() == 0:
        has = torch.zeros(1, dtype=torch.int32, device=dev)
    tiles = torch.searchsorted(
        has, torch.arange(1, cap + 2, dtype=torch.int32, device=dev),
        out_int32=True)
    firsts = seg_ptr[tiles.long()]
    return torch.cat([has[-1:], torch.stack([tiles, firsts], 1).view(-1)])


def stream_walk(seg, c_cap: int, cap: int, next_tile=None):
    """The walk list of the sorted pair stream ``seg`` (stream_walk_plain
    says what it holds) on seg's device: on the card one launch of
    macro_stream_walk (counted; no host sync, so a CUDA graph captures
    it), which also zeroes ``next_tile`` (the one-pass pipeline's ticket
    counter) where given; on the CPU the plain version."""
    _check_i32(seg, "seg", seg.device)
    if cap < 0 or c_cap < 0:
        raise ValueError(f"cap={cap}, c_cap={c_cap}")
    if not seg.is_cuda:
        if next_tile is not None:
            next_tile.zero_()
        return stream_walk_plain(seg, c_cap, cap)
    walk = torch.empty(2 * cap + 3, dtype=torch.int32, device=seg.device)
    with torch.cuda.device(seg.device):
        _raise_on(_library().macro_stream_walk(
            seg.data_ptr(), seg.numel(), c_cap, cap, walk.data_ptr(),
            None if next_tile is None else next_tile.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "macro_stream_walk")
    LAUNCHES["macro_stream_walk"] += 1
    return walk


def persistent_grid(device) -> int:
    """Blocks of the float32 pair-stream entry: one an SM of ``device`` (a
    block takes most of an SM's shared memory)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_out(out, c_cap, dtype, device):
    """The accumulate form's (c_num, c_flag): (c_cap, 128, 128) each, of
    ``dtype`` and uint8, contiguous, 16-byte aligned (the kernels load and
    store 16-byte pieces), on ``device``."""
    if not (isinstance(out, (tuple, list)) and len(out) == 2):
        raise TypeError("out must be a pair (c_num, c_flag)")
    for x, name, want in ((out[0], "out c_num", dtype),
                          (out[1], "out c_flag", torch.uint8)):
        _check_tiles(x, name, device)
        if x.shape[0] != c_cap:
            raise ValueError(f"{name} has {x.shape[0]} tiles, expected "
                             f"c_cap={c_cap}")
        if x.dtype != want:
            raise TypeError(f"{name} is {x.dtype}, expected {want}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return out[0], out[1]


def accumulate_macro_pairs(a_dense, b_dense, a_idx, b_idx, seg, c_cap: int,
                           *, chunk: int = 256, acc_dtype=None,
                           precision: str = "highest", tile_masks=None,
                           out=None):
    """(c_dense (c_cap,128,128), c_flags (c_cap,128,128) uint8) of a pair
    stream sorted by C tile.

    a_dense / b_dense: (T+1, 128, 128) tile tables; a_idx, b_idx, seg:
    (p_cap,) i32, seg ascending, padding pairs carry seg = INT32_MAX (they
    are skipped, never used as an index).  Tiles without pairs, among them
    every tile from the stream's tile count up to c_cap, are zero.  ``chunk``
    and ``acc_dtype`` (None: the tiles' dtype) are read by the plain version
    only (CPU tensors).  ``precision`` ("highest", "high", "default";
    anything else raises) is the float32 products' (the float64 entry
    ignores it, as float64 tiles do in the JAX package).  ``tile_masks``: a
    ``TileMasks`` of these tables shared with other launches, or made
    elsewhere (read on CUDA tiles: ``reads_masks``; else not read).
    CUDA tiles of float32 launch the float32 entry, of float64 the float64
    entry (c_dense then float64); any other dtype raises.

    ``out=(c_num, c_flag)``: the accumulate form.  The stream's products are
    added into them in place (values old + partial, flags ORed) and ``out``
    is returned; a tile without pairs is neither read nor written (on the
    card, nor is a tile none of whose slabs runs: it keeps a -0.0 the plain
    version turns into +0.0).  They must
    be (c_cap, 128, 128), contiguous, on the tiles' device, of the values'
    dtype (the tiles', or ``acc_dtype`` on the CPU) and uint8; anything else
    raises.  On CUDA tiles it launches the entry's accumulate form (counted
    as ``<entry>_acc``) over the stream's ``stream_walk`` (no tile without
    pairs is visited), running only the slabs the tiles' k-masks call
    non-zero (at every precision); on CPU tiles
    ``ops.macro.accumulate_macro(..., out=out)``.
    """
    prec = precision_code(precision)
    _check_tiles(a_dense, "a_dense")
    _check_tiles(b_dense, "b_dense", a_dense.device)
    dev = a_dense.device
    p_cap = a_idx.numel()
    for x, name in ((a_idx, "a_idx"), (b_idx, "b_idx"), (seg, "seg")):
        _check_i32(x, name, dev, p_cap)
    if c_cap < 0:
        raise ValueError(f"c_cap={c_cap}")
    _require_on_gpu((a_dense, b_dense), (torch.float32, torch.float64))
    values = a_dense.dtype if a_dense.is_cuda else acc_dtype or a_dense.dtype
    if out is not None:
        c_num, c_flag = _check_out(out, c_cap, values, dev)
    if not a_dense.is_cuda:
        return accumulate_macro(a_dense, b_dense, a_idx, b_idx, seg, c_cap,
                                chunk, values, precision, out)
    if out is None:
        c_num = torch.empty((c_cap, TILE, TILE), dtype=values, device=dev)
        c_flag = torch.empty((c_cap, TILE, TILE), dtype=torch.uint8,
                             device=dev)
    if c_cap == 0:                      # nothing to launch, nothing counted
        return c_num, c_flag
    acc = int(out is not None)
    f64 = a_dense.dtype == torch.float64
    masks, margs = _mask_args(a_dense, b_dense, tile_masks)
    next_tile = None if f64 else torch.empty(1, dtype=torch.int32,
                                             device=dev)
    if acc:
        # the walk over the tiles with pairs (it zeroes the ticket counter):
        # the pair offsets are not read
        walk = stream_walk(seg, c_cap, min(c_cap, p_cap), next_tile)
        walk_ptr, seg_ptr = walk.data_ptr(), None
    else:
        walk_ptr, seg_ptr = None, segment_offsets(seg, c_cap)
        if next_tile is not None:
            next_tile.zero_()
    lib = _library()
    ptrs = (a_dense.data_ptr(), b_dense.data_ptr(), a_idx.data_ptr(),
            b_idx.data_ptr(), None if seg_ptr is None else seg_ptr.data_ptr(),
            c_num.data_ptr(), c_flag.data_ptr(), c_cap)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if f64:
        # scratch: the slabs that run of each pair
        entry = "macro_accumulate_pairs_f64"
        need = torch.empty(p_cap, dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            err = lib.macro_accumulate_pairs_f64(
                *ptrs, a_dense.shape[0], b_dense.shape[0], p_cap,
                *margs[:2], *margs[4:], need.data_ptr(), acc, walk_ptr,
                stream)
    else:
        entry = "macro_accumulate_pairs"
        with torch.cuda.device(dev):
            err = lib.macro_accumulate_pairs_f32(
                *ptrs, persistent_grid(dev), next_tile.data_ptr(), prec,
                *margs, acc, walk_ptr, stream)
    if err == 0:
        masks.made()
    if acc:
        entry += "_acc"
    _raise_on(err, entry)
    LAUNCHES[entry] += 1
    return c_num, c_flag


# --------------------------------------------------------------------------
# the class entries

def _check_class(c_num, c_pat, a_dense, b_dense, ab_bases, t, p, ar, br,
                 a_offs, b_offs, base, n_steps):
    _check_tiles(a_dense, "a_dense")
    dev = a_dense.device
    _check_tiles(b_dense, "b_dense", dev)
    _check_tiles(c_num, "c_num", dev)
    _check_tiles(c_pat, "c_pat", dev)
    if c_num.dtype != torch.float32 or c_pat.dtype != torch.uint8:
        raise TypeError("slabs must be float32 values and uint8 flags, got "
                        f"{c_num.dtype}, {c_pat.dtype}")
    if c_pat.shape[0] != c_num.shape[0]:
        raise ValueError("the two slabs differ in rows")
    _check_i32(ab_bases, "ab_bases", dev, 2 * n_steps)
    p_list = p_list_of(t, p)
    n_p = sum(p_list)
    if len(p_list) != t or len(a_offs) != n_p or len(b_offs) != n_p \
            or min(p_list) < 0:
        raise ValueError(f"class tables do not match t={t}, p={p}")
    if n_p and (min(a_offs) < 0 or max(a_offs) >= ar or min(b_offs) < 0
                or max(b_offs) >= br):
        raise ValueError("an offset lies outside its window extent")
    if base < 0 or base + n_steps * t > c_num.shape[0]:
        raise ValueError(f"rows [{base}, {base + n_steps * t}) exceed the "
                         f"slab's {c_num.shape[0]}")
    _require_on_gpu((a_dense, b_dense), (torch.float32,))
    return dev, n_p


def _class_tables(tables, t, n_p, dev):
    if tables is None:
        raise ValueError("CUDA tiles need the class's int32 tables "
                         "(ops.stencil.class_tables)")
    p_ptr, ao, bo = tables
    _check_i32(p_ptr, "p_ptr", dev, t + 1)
    _check_i32(ao, "a_offs table", dev, n_p)
    _check_i32(bo, "b_offs table", dev, n_p)
    return p_ptr, ao, bo


def class_call2(c_num, c_pat, a_dense, b_dense, ab_bases, t, p, ar, br,
                a_offs, b_offs, base, n_steps, *, tables=None,
                precision: str = "highest", tile_masks=None):
    """Run one signature class into slab rows [base, base + n_steps*t), in
    place; returns (c_num, c_pat).

    ab_bases: (2 * n_steps,) i32 interleaved (a_base, b_base) per step;
    p an int (every tile has p pairs) or a per-tile tuple; a_offs / b_offs
    the per-pair offsets from the step's bases, below the window extents
    ar / br.  ``tables`` are the class's device tables
    (``ops.stencil.class_tables``): CUDA tiles need them, CPU tiles do not
    read them.  ``precision`` and ``tile_masks`` as in
    ``accumulate_macro_pairs``.
    """
    prec = precision_code(precision)
    dev, n_p = _check_class(c_num, c_pat, a_dense, b_dense, ab_bases, t, p,
                            ar, br, a_offs, b_offs, base, n_steps)
    if not a_dense.is_cuda:
        return class_call_plain(c_num, c_pat, a_dense, b_dense, ab_bases, t,
                                p, a_offs, b_offs, base, precision)
    if n_steps * t == 0:                # nothing to launch, nothing counted
        return c_num, c_pat
    p_ptr, ao, bo = _class_tables(tables, t, n_p, dev)
    lib = _library()
    next_tile = torch.zeros(1, dtype=torch.int32, device=dev)
    masks, margs = _mask_args(a_dense, b_dense, tile_masks)
    with torch.cuda.device(dev):
        _raise_on(lib.macro_class_ragged_f32(
            a_dense.data_ptr(), b_dense.data_ptr(), ab_bases.data_ptr(),
            p_ptr.data_ptr(), ao.data_ptr(), bo.data_ptr(), t, n_steps, base,
            c_num.data_ptr(), c_pat.data_ptr(), prec, persistent_grid(dev),
            next_tile.data_ptr(), *margs,
            torch.cuda.current_stream().cuda_stream), "macro_class_ragged")
    masks.made()
    LAUNCHES["macro_class_ragged"] += 1
    return c_num, c_pat


def class_call(c_num, c_pat, a_dense, b_dense, ab_bases, t, p, ar, br,
               a_offs, b_offs, base, *, tables=None,
               precision: str = "highest", tile_masks=None):
    """``class_call2`` for a uniform pair count (p an int) through the entry
    that needs no per-tile table; n_steps is read off ab_bases."""
    prec = precision_code(precision)
    if not isinstance(p, int):
        raise TypeError("class_call takes a uniform pair count (an int); "
                        "ragged classes go through class_call2")
    n_steps = ab_bases.shape[0] // 2
    dev, n_p = _check_class(c_num, c_pat, a_dense, b_dense, ab_bases, t, p,
                            ar, br, a_offs, b_offs, base, n_steps)
    if not a_dense.is_cuda:
        return class_call_plain(c_num, c_pat, a_dense, b_dense, ab_bases, t,
                                p, a_offs, b_offs, base, precision)
    if n_steps * t == 0:
        return c_num, c_pat
    _p_ptr, ao, bo = _class_tables(tables, t, n_p, dev)
    lib = _library()
    next_tile = torch.zeros(1, dtype=torch.int32, device=dev)
    masks, margs = _mask_args(a_dense, b_dense, tile_masks)
    with torch.cuda.device(dev):
        _raise_on(lib.macro_class_uniform_f32(
            a_dense.data_ptr(), b_dense.data_ptr(), ab_bases.data_ptr(),
            ao.data_ptr(), bo.data_ptr(), t, p, n_steps, base,
            c_num.data_ptr(), c_pat.data_ptr(), prec, persistent_grid(dev),
            next_tile.data_ptr(), *margs,
            torch.cuda.current_stream().cuda_stream), "macro_class_uniform")
    masks.made()
    LAUNCHES["macro_class_uniform"] += 1
    return c_num, c_pat


PLAN_MAX_CLASSES = 32   # the .cu's: classes one launch carries by value


def classes_call(c_num, c_pat, a_dense, b_dense, plan, *,
                 precision: str = "highest", tile_masks=None):
    """Every class of the stencil / run plan ``plan`` into its slab rows,
    in place; returns (c_num, c_pat).

    The classes' rows lie back to back from slab row 0, so on CUDA tiles
    one launch of the class kernel (``macro_classes_f32``, counted as
    ``macro_classes``) takes them all, ticket tk being slab row tk, over
    the plan's ``plan_tables`` (built once, with the plan); each tile's
    products run in the order a launch of its class alone runs them, so
    the rows are those launches' bits.  CPU tiles take
    ``ops.stencil.classes_call_plain``.  ``precision`` and ``tile_masks``
    as in ``accumulate_macro_pairs``.  A failed build or launch raises; it
    never falls back to a launch a class.
    """
    prec = precision_code(precision)
    _check_tiles(a_dense, "a_dense")
    dev = a_dense.device
    for x, name in ((b_dense, "b_dense"), (c_num, "c_num"), (c_pat, "c_pat")):
        _check_tiles(x, name, dev)
    if c_num.dtype != torch.float32 or c_pat.dtype != torch.uint8:
        raise TypeError("slabs must be float32 values and uint8 flags, got "
                        f"{c_num.dtype}, {c_pat.dtype}")
    _require_on_gpu((a_dense, b_dense), (torch.float32,))
    if not a_dense.is_cuda:
        return classes_call_plain(c_num, c_pat, a_dense, b_dense, plan,
                                  precision)
    if not plan.plan_tables:
        raise ValueError("CUDA tiles need the plan's int32 tables "
                         "(ops.stencil.plan_tables)")
    ab_bases, p_ptr, ao, bo, desc, n_rows = plan.plan_tables
    if n_rows > min(c_num.shape[0], c_pat.shape[0]):
        raise ValueError(f"the classes' {n_rows} rows exceed the slabs")
    if len(desc) > PLAN_MAX_CLASSES:
        raise ValueError(f"{len(desc)} classes with rows: one launch takes "
                         f"at most {PLAN_MAX_CLASSES}")
    for x, name in ((ab_bases, "ab_bases"), (p_ptr, "p_ptr"),
                    (ao, "a_offs table"), (bo, "b_offs table")):
        _check_i32(x, name, dev)
    if n_rows == 0:                     # nothing to launch, nothing counted
        return c_num, c_pat
    desc = desc.reshape(-1)             # int32, read by the entry now
    next_tile = torch.zeros(1, dtype=torch.int32, device=dev)
    masks, margs = _mask_args(a_dense, b_dense, tile_masks)
    with torch.cuda.device(dev):
        _raise_on(_library().macro_classes_f32(
            a_dense.data_ptr(), b_dense.data_ptr(), ab_bases.data_ptr(),
            p_ptr.data_ptr(), ao.data_ptr(), bo.data_ptr(), len(desc) // 4,
            desc.ctypes.data, n_rows, c_num.data_ptr(), c_pat.data_ptr(),
            prec, persistent_grid(dev), next_tile.data_ptr(), *margs,
            torch.cuda.current_stream().cuda_stream), "macro_classes")
    masks.made()
    LAUNCHES["macro_classes"] += 1
    return c_num, c_pat
