"""Macro128 accumulation kernels: wrappers of csrc/macro_accumulate.cu.

Counterpart of the JAX package's ops/pallas_macro2.py and of the kernel
half of its ops/pallas_stencil.py.  Four entries, one CUDA source (built
with nvcc at first use and bound with ctypes by ops/_build.py):

  accumulate_macro_pairs   a pair stream sorted by C tile:
                           C[seg[p]] += A[a_idx[p]] @ B[b_idx[p]]
                           (accumulate_macro_pipelined of the reference);
                           the macro engine's interactive multiply, its
                           MacroPlan steady multiply and the stencil plan's
                           residual pairs; with ``out=`` its accumulate
                           form, which adds into a C the caller holds (the
                           Macro128 ring's stages after the first);
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
                           and flags.

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
owns it: the float64 entry and the class entries at "highest" launch one
block a tile; the float32 pair-stream entry, and the class entries at
"high" and "default", one persistent block an SM (``persistent_grid``),
taking tiles in order from a counter the wrapper zeroes and running them as
one stream of stages.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernel (or raise, if the build or the launch fails); CPU tensors take
the plain PyTorch version (``ops.macro.accumulate_macro``,
``ops.stencil.class_call_plain``).  ``SpGEMMConfig.use_pallas`` is not read.
Each wrapper adds one to its entry in ``LAUNCHES`` where it launches its
kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from pem_spgemm_tpu_torch.config import precision_code
from pem_spgemm_tpu_torch.ops import _build
from pem_spgemm_tpu_torch.ops.macro import TILE, accumulate_macro
from pem_spgemm_tpu_torch.ops.stencil import class_call_plain, p_list_of

SOURCE = _build.cuda_source("macro_accumulate")
F64_MASK_WORDS = 10     # the float64 entry's k-mask words a tile (the .cu's)
TM_WORDS = 10           # the one-pass pipeline's k-mask words a tile

# kernel launches per entry (plain-version calls are not counted); the
# pair-stream entries' accumulate form (``out=``) counts under its own key
LAUNCHES = {"macro_accumulate_pairs": 0, "macro_class_ragged": 0,
            "macro_class_uniform": 0, "macro_accumulate_pairs_f64": 0,
            "macro_accumulate_pairs_acc": 0,
            "macro_accumulate_pairs_f64_acc": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    masks = [vp, vp, ci, ci, ci]        # masks_a, masks_b, n_a, n_b, ready
    lib.macro_accumulate_pairs_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                               ci, ci, vp, ci, *masks, ci, vp]
    lib.macro_class_ragged_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                           ll, vp, vp, ci, ci, vp, *masks,
                                           vp]
    lib.macro_class_uniform_f32.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                            ll, vp, vp, ci, ci, vp, *masks,
                                            vp]
    lib.macro_accumulate_pairs_f64.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                               ci, ci, ci, ci, vp, vp, vp,
                                               ci, vp]
    for fn in (lib.macro_accumulate_pairs_f32, lib.macro_class_ragged_f32,
               lib.macro_class_uniform_f32, lib.macro_accumulate_pairs_f64):
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


class TileMasks:
    """Scratch of the one-pass pipeline ("high", "default"): the k-masks of
    two float32 tile tables (TM_WORDS int32 a tile; one buffer where both
    operands are one table), computed by the first launch that is handed
    them and read by the later ones.  ops.stencil.stencil_accumulate hands
    one to all the launches of a multiply, so the tables are read once for
    them; a launch without one computes its own."""

    def __init__(self, a_dense, b_dense):
        self.same = b_dense.data_ptr() == a_dense.data_ptr() \
            and b_dense.shape == a_dense.shape
        self.key = (a_dense.data_ptr(), a_dense.shape[0], b_dense.data_ptr(),
                    b_dense.shape[0])
        self.a = torch.empty((a_dense.shape[0], TM_WORDS), dtype=torch.int32,
                             device=a_dense.device)
        self.b = self.a if self.same else torch.empty(
            (b_dense.shape[0], TM_WORDS), dtype=torch.int32,
            device=b_dense.device)
        self.ready = False

    def args(self, a_dense, b_dense):
        """The entries' (masks_a, masks_b, n_a, n_b, masks_ready)."""
        if self.key != (a_dense.data_ptr(), a_dense.shape[0],
                        b_dense.data_ptr(), b_dense.shape[0]):
            raise ValueError("tile masks of other tables")
        return (self.a.data_ptr(), self.b.data_ptr(), a_dense.shape[0],
                b_dense.shape[0], int(self.ready))


def _mask_args(a_dense, b_dense, prec, tile_masks):
    """(masks, the entries' five mask arguments) of a float32 launch at
    precision code ``prec``: none at "highest", which reads no mask."""
    if prec == 0:
        return None, (None, None, 0, 0, 1)
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
    ``TileMasks`` of these tables shared with other launches (float32 at
    "high" / "default" on CUDA tiles; else not read).
    CUDA tiles of float32 launch the float32 entry, of float64 the float64
    entry (c_dense then float64); any other dtype raises.

    ``out=(c_num, c_flag)``: the accumulate form.  The stream's products are
    added into them in place (values old + partial, flags ORed) and ``out``
    is returned; a tile without pairs is neither read nor written (on the
    card, nor is a tile none of whose slabs runs at "high" / "default" or in
    float64: it keeps a -0.0 the plain version turns into +0.0).  They must
    be (c_cap, 128, 128), contiguous, on the tiles' device, of the values'
    dtype (the tiles', or ``acc_dtype`` on the CPU) and uint8; anything else
    raises.  On CUDA tiles it launches the entry's accumulate form (counted
    as ``<entry>_acc``), on CPU tiles ``ops.macro.accumulate_macro(...,
    out=out)``.
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
    seg_ptr = segment_offsets(seg, c_cap)
    lib = _library()
    ptrs = (a_dense.data_ptr(), b_dense.data_ptr(), a_idx.data_ptr(),
            b_idx.data_ptr(), seg_ptr.data_ptr(), c_num.data_ptr(),
            c_flag.data_ptr(), c_cap)
    if a_dense.dtype == torch.float64:
        # scratch: the tiles' k-masks (one buffer where A and B are one
        # table) and the slabs that run of each pair
        entry = "macro_accumulate_pairs_f64"
        masks_a = torch.empty((a_dense.shape[0], F64_MASK_WORDS),
                              dtype=torch.int32, device=dev)
        masks_b = masks_a if b_dense.data_ptr() == a_dense.data_ptr() \
            and b_dense.shape == a_dense.shape else torch.empty(
                (b_dense.shape[0], F64_MASK_WORDS), dtype=torch.int32,
                device=dev)
        need = torch.empty(p_cap, dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            err = lib.macro_accumulate_pairs_f64(
                *ptrs, a_dense.shape[0], b_dense.shape[0], p_cap,
                masks_a.data_ptr(), masks_b.data_ptr(), need.data_ptr(),
                acc, torch.cuda.current_stream().cuda_stream)
    else:
        entry = "macro_accumulate_pairs"
        next_tile = torch.zeros(1, dtype=torch.int32, device=dev)
        masks, margs = _mask_args(a_dense, b_dense, prec, tile_masks)
        with torch.cuda.device(dev):
            err = lib.macro_accumulate_pairs_f32(
                *ptrs, persistent_grid(dev), next_tile.data_ptr(), prec,
                *margs, acc, torch.cuda.current_stream().cuda_stream)
        if masks is not None and err == 0:
            masks.ready = True
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
    masks, margs = _mask_args(a_dense, b_dense, prec, tile_masks)
    with torch.cuda.device(dev):
        _raise_on(lib.macro_class_ragged_f32(
            a_dense.data_ptr(), b_dense.data_ptr(), ab_bases.data_ptr(),
            p_ptr.data_ptr(), ao.data_ptr(), bo.data_ptr(), t, n_steps, base,
            c_num.data_ptr(), c_pat.data_ptr(), prec, persistent_grid(dev),
            next_tile.data_ptr(), *margs,
            torch.cuda.current_stream().cuda_stream), "macro_class_ragged")
    if masks is not None:
        masks.ready = True
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
    masks, margs = _mask_args(a_dense, b_dense, prec, tile_masks)
    with torch.cuda.device(dev):
        _raise_on(lib.macro_class_uniform_f32(
            a_dense.data_ptr(), b_dense.data_ptr(), ab_bases.data_ptr(),
            ao.data_ptr(), bo.data_ptr(), t, p, n_steps, base,
            c_num.data_ptr(), c_pat.data_ptr(), prec, persistent_grid(dev),
            next_tile.data_ptr(), *margs,
            torch.cuda.current_stream().cuda_stream), "macro_class_uniform")
    if masks is not None:
        masks.ready = True
    LAUNCHES["macro_class_uniform"] += 1
    return c_num, c_pat
