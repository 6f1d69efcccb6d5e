"""Tile16 kernels: wrappers of csrc/tile16_accumulate.cu and
csrc/tile16_structure.cu.

The Tile16 tier's numeric and structure phases on the card.  They replace
no Pallas kernel: the JAX package computes both phases in XLA (its
ops/numeric.py ``accumulate_fused_flat``, ``accumulate_dense``,
``counts_to_masks`` and ``extract_values``, its ops/cstruct.py ``c_masks``
and ``c_rowcol``, and the ring stage of its parallel/sharded.py), and the
port's first versions ran them as torch ops: the accumulation (gathers, 0/1
casts, two ``torch.bmm``, ``index_add_`` with atomics) took 42 of a 48 ms
steady multiply at pairbands-500k on an H100, ``c_masks`` (16
``scatter_reduce_`` planes) 82 of the masks engine's 88 ms interactive
multiply.  Two CUDA sources (built with nvcc at first use and bound with
ctypes by ops/_build.py), four entries; the accumulation and
``tile16_c_masks`` walk a pair stream sorted by C tile:

  tile16_accumulate_pairs_f32   float32 or bfloat16 tiles (read as they
                                lie), tf32 mma.sync: 3xTF32 at "highest",
                                one pass of the mode's rounding, done in
                                registers, at "high" / "default";
  tile16_accumulate_pairs_f64   float64 tiles, DMMA (mma.sync f64);
  tile16_c_masks                C's row bitmasks and per-tile nnz from the
                                operands' bitmasks (the reference's step 2b);
  tile16_c_rowcol               C's set bits enumerated (step 2c), and with
                                a value table the compressed values.

The accumulation entries have four forms: fresh with the structure as row
masks and nnz (the fused engine, ``accumulate_fused_masks``), fresh with
the structural counts (the JAX package's ``accumulate_fused_flat``
contract; no path of the card calls it), fresh with values only (the masks
engine, ``accumulate_dense``, and a ring rank's first stage) and
accumulate (``accumulate_dense(..., out=c)``: a ring rank's later stages
add into its C; a tile without pairs is neither read nor written).  In
the accumulation a warp takes a fixed span of the pair stream and owns the
C tiles that start in it (a half-warp owns a C tile in the structure
kernels); each tile's pairs are summed in stream order and the tile is
written once: no atomics, so a launch gives the same bits every time.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernel (or raise, if the build or the launch fails); CPU tensors take
the plain PyTorch version (``ops.numeric.fused_flat_plain``,
``fused_masks_plain``, ``dense_plain``, ``ops.cstruct.c_masks_plain``,
``c_rowcol_plain``).  Each wrapper adds one to its entry in ``LAUNCHES``
where it launches the kernel, and nowhere else: the float32 accumulation
entry's fresh forms count under ``tile16_accumulate_pairs``, its masks form
under ``tile16_accumulate_pairs_masks`` and its accumulate form under
``tile16_accumulate_pairs_acc`` (``_f64`` for the float64 entry); the
structure entries under their names.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pem_spgemm_tpu_torch.config import precision_code
from pem_spgemm_tpu_torch.ops import _build, numeric
from pem_spgemm_tpu_torch.ops.macro import require_full_fp32
from pem_spgemm_tpu_torch.ops.macro_kernels import segment_offsets

SOURCE = _build.cuda_source("tile16_accumulate")
STRUCT_SOURCE = _build.cuda_source("tile16_structure")
TILE_ELEMS = 256

# kernel launches per entry and form (plain-version calls are not counted)
LAUNCHES = {"tile16_accumulate_pairs": 0, "tile16_accumulate_pairs_acc": 0,
            "tile16_accumulate_pairs_masks": 0,
            "tile16_accumulate_pairs_f64": 0,
            "tile16_accumulate_pairs_f64_acc": 0,
            "tile16_accumulate_pairs_f64_masks": 0,
            "tile16_c_masks": 0, "tile16_c_rowcol": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tile16_accumulate_pairs_f32,
               lib.tile16_accumulate_pairs_f64):
        fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, ci, vp, ci, vp, vp,
                       vp, vp, ci, ci, vp]
        fn.restype = ci


def _declare_structure(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tile16_c_masks.argtypes = [vp, vp, ci, ci, vp, vp, vp, ci, vp, vp,
                                   vp]
    lib.tile16_c_masks.restype = ci
    lib.tile16_c_rowcol.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp, vp, vp]
    lib.tile16_c_rowcol.restype = ci


def _library():
    return _build.cuda_library("tile16_accumulate", _declare)


def _structure_library():
    return _build.cuda_library("tile16_structure", _declare_structure)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _raise_on(err, entry):
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {err}")


# --------------------------------------------------------------------------
# argument checks

def _check_table(x, name, device):
    """A CUDA tile table: (n, 256) or (n, 16, 16), n >= 1, contiguous,
    16-byte aligned (the kernel loads 16-byte pieces), on ``device``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.dim() not in (2, 3) or x.shape[0] < 1 \
            or math.prod(x.shape[1:]) != TILE_ELEMS:
        raise ValueError(f"{name} must be (tiles, 256) or (tiles, 16, 16) "
                         f"with at least one tile, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_stream(a_idx, b_idx, seg, device):
    n = a_idx.numel() if isinstance(a_idx, torch.Tensor) else -1
    for x, name in ((a_idx, "a_idx"), (b_idx, "b_idx"), (seg, "seg")):
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int32
                or x.dim() != 1 or x.device != device
                or not x.is_contiguous() or x.numel() != n):
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                             f"on {device} with as many entries as a_idx")


def _entry_dtypes(table_dtype, acc_dtype):
    """(the entry's value dtype, whether the tables are bfloat16) of CUDA
    tables of ``table_dtype`` accumulated in ``acc_dtype``: the float32
    entry reads bfloat16 tables as they lie and widens them in registers;
    any other pairing raises."""
    if table_dtype == torch.float64 and acc_dtype == torch.float64:
        return torch.float64, False
    if table_dtype in (torch.float32, torch.bfloat16) \
            and acc_dtype == torch.float32:
        return torch.float32, table_dtype == torch.bfloat16
    raise NotImplementedError(
        f"{table_dtype} tiles accumulated in {acc_dtype}: the Tile16 kernel "
        "takes float32 or bfloat16 tiles into float32, or float64 tiles "
        "into float64")


def _value_dtype(a, b, acc_dtype):
    """The dtype of C's values for the tables ``a``, ``b``, which the
    kernel reads as they lie (no copy, no rounding pass: a precision's
    rounding is done in registers)."""
    if b.dtype != a.dtype:
        raise TypeError(f"tables of two dtypes: {a.dtype}, {b.dtype}")
    return _entry_dtypes(a.dtype, acc_dtype)[0]


def _launch(a, b, a_idx, b_idx, seg, c_cap, c_val, c_cnt, accumulate,
            precision, c_mask=None, c_nnz=None):
    """One launch of the entry of ``c_val``'s dtype (c_cap > 0).  The fresh
    forms pass the tiles' pair offsets (``segment_offsets``: the kernel
    writes the tiles without pairs from them); the accumulate form walks
    the stream alone."""
    dev = a.device
    seg_ptr = None if accumulate else segment_offsets(seg, c_cap)
    f64 = c_val.dtype == torch.float64
    lib = _library()
    fn = lib.tile16_accumulate_pairs_f64 if f64 \
        else lib.tile16_accumulate_pairs_f32
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), b.data_ptr(), a.shape[0], b.shape[0],
                 int(a.dtype == torch.bfloat16), a_idx.data_ptr(),
                 b_idx.data_ptr(), seg.data_ptr(), a_idx.numel(),
                 _ptr(seg_ptr), c_cap, c_val.data_ptr(), _ptr(c_cnt),
                 _ptr(c_mask), _ptr(c_nnz), int(accumulate),
                 precision_code(precision),
                 torch.cuda.current_stream().cuda_stream)
    entry = "tile16_accumulate_pairs" + ("_f64" if f64 else "") \
        + ("_acc" if accumulate else "") \
        + ("_masks" if c_mask is not None else "")
    _raise_on(err, entry)
    LAUNCHES[entry] += 1


# --------------------------------------------------------------------------
# the two call sites' functions

def accumulate_fused_flat(a_flat, b_flat, a_idx, b_idx, c_tile_id,
                          c_cap: int, chunk: int, acc_dtype=torch.float32,
                          precision: str = "highest"):
    """(c_dense (c_cap, 256) acc_dtype, c_counts (c_cap, 256) float32) of a
    pair stream sorted by C tile: ``ops.numeric.accumulate_fused_flat``'s
    contract.

    a_flat / b_flat: (T+1, 256) value tables; a_idx, b_idx, c_tile_id:
    (p_cap,) int32, c_tile_id ascending, padding pairs at c_cap or above
    (never read on the card).  ``chunk`` is read by the plain version only.
    CUDA tables launch the kernel's fresh form with counts: float32 or
    bfloat16 tables with acc_dtype float32 the float32 entry (bfloat16
    tables read as they lie), float64 tables with acc_dtype float64 the
    float64 entry; anything else raises.  CPU tables take the plain
    version.
    """
    precision_code(precision)
    require_full_fp32()
    if not a_flat.is_cuda:
        return numeric.fused_flat_plain(a_flat, b_flat, a_idx, b_idx,
                                        c_tile_id, c_cap, chunk, acc_dtype,
                                        precision)
    dev = a_flat.device
    _check_table(a_flat, "a_flat", dev)
    _check_table(b_flat, "b_flat", dev)
    _check_stream(a_idx, b_idx, c_tile_id, dev)
    dtype = _value_dtype(a_flat, b_flat, acc_dtype)
    c_val = torch.empty((c_cap, TILE_ELEMS), dtype=dtype, device=dev)
    c_cnt = torch.empty((c_cap, TILE_ELEMS), dtype=torch.float32,
                        device=dev)
    if c_cap > 0:
        _launch(a_flat, b_flat, a_idx, b_idx, c_tile_id, c_cap, c_val, c_cnt,
                False, precision)
    return c_val, c_cnt


def accumulate_fused_masks(a_flat, b_flat, a_idx, b_idx, c_tile_id,
                           c_cap: int, chunk: int, acc_dtype=torch.float32,
                           precision: str = "highest"):
    """(c_dense (c_cap, 256) acc_dtype, cmask (c_cap, 16) int32, cptr
    (c_cap + 1,) int32) of a pair stream sorted by C tile:
    ``ops.numeric.accumulate_fused_masks``'s contract, the fused engine's
    accumulation with its structure as C's row bitmasks (bit set iff the
    structural count is > 0) and the exclusive scan of the tiles' nnz.

    Arguments as in ``accumulate_fused_flat``.  CUDA tables launch the
    kernel's masks form (no count table is written); CPU tables take
    ``numeric.fused_masks_plain``.
    """
    from pem_spgemm_tpu_torch.ops.cstruct import _exclusive_scan
    precision_code(precision)
    require_full_fp32()
    if not a_flat.is_cuda:
        return numeric.fused_masks_plain(a_flat, b_flat, a_idx, b_idx,
                                         c_tile_id, c_cap, chunk, acc_dtype,
                                         precision)
    dev = a_flat.device
    _check_table(a_flat, "a_flat", dev)
    _check_table(b_flat, "b_flat", dev)
    _check_stream(a_idx, b_idx, c_tile_id, dev)
    dtype = _value_dtype(a_flat, b_flat, acc_dtype)
    c_val = torch.empty((c_cap, TILE_ELEMS), dtype=dtype, device=dev)
    cmask = torch.empty((c_cap, 16), dtype=torch.int32, device=dev)
    nnz = torch.empty((c_cap,), dtype=torch.int32, device=dev)
    if c_cap > 0:
        _launch(a_flat, b_flat, a_idx, b_idx, c_tile_id, c_cap, c_val, None,
                False, precision, cmask, nnz)
    return c_val, cmask, _exclusive_scan(nnz)


def _check_out(out, c_cap, dtype, device):
    if not isinstance(out, torch.Tensor) or tuple(out.shape) != (
            c_cap, 16, 16):
        raise ValueError(f"out must be a ({c_cap}, 16, 16) tensor")
    if out.dtype != dtype:
        raise TypeError(f"out is {out.dtype}, expected {dtype}")
    if out.device != device or not out.is_contiguous() \
            or (out.is_cuda and out.data_ptr() % 16):
        raise ValueError(f"out must be contiguous on {device} (16-byte "
                         "aligned on the GPU)")


def accumulate_dense(a_dense, b_dense, a_idx, b_idx, c_tile_id, c_cap: int,
                     chunk: int, acc_dtype=torch.float32,
                     precision: str = "highest", out=None):
    """C_dense (c_cap, 16, 16) acc_dtype of a pair stream sorted by C tile:
    ``ops.numeric.accumulate_dense``'s contract.

    a_dense / b_dense: (T, 16, 16) tables; a_idx, b_idx, c_tile_id as in
    ``accumulate_fused_flat``.  ``out=c``: the accumulate form, the
    stream's products added into ``c`` in place (old + partial on the tiles
    the stream has pairs for; a tile without pairs is neither read nor
    written) and ``c`` returned; ``c`` must be (c_cap, 16, 16), contiguous,
    of the values' dtype, on the tables' device.  CUDA tables launch the
    kernel's fresh values-only form, or its accumulate form with ``out``
    (the dtypes as in ``accumulate_fused_flat``); CPU tables take the plain
    version.
    """
    precision_code(precision)
    require_full_fp32()
    dev = a_dense.device
    if not a_dense.is_cuda:
        if out is not None:
            _check_out(out, c_cap, acc_dtype, dev)
        return numeric.dense_plain(a_dense, b_dense, a_idx, b_idx,
                                   c_tile_id, c_cap, chunk, acc_dtype,
                                   precision, out)
    _check_table(a_dense, "a_dense", dev)
    _check_table(b_dense, "b_dense", dev)
    _check_stream(a_idx, b_idx, c_tile_id, dev)
    dtype = _value_dtype(a_dense, b_dense, acc_dtype)
    if out is None:
        c = torch.empty((c_cap, 16, 16), dtype=dtype, device=dev)
    else:
        _check_out(out, c_cap, dtype, dev)
        c = out
    if c_cap > 0:
        _launch(a_dense, b_dense, a_idx, b_idx, c_tile_id, c_cap, c, None,
                out is not None, precision)
    return c


# --------------------------------------------------------------------------
# the structure entries

def _check_int32(x, name, device, cols=None):
    """A contiguous int32 tensor on ``device``: (n,) or, with ``cols``,
    (n, cols) with n >= 1."""
    want = "1-D" if cols is None else f"(n >= 1, {cols})"
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 or (
            x.dim() != 1 if cols is None else
            x.dim() != 2 or x.shape[1] != cols or x.shape[0] < 1) \
            or x.device != device or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {want} int32 tensor "
                         f"on {device}")


def c_masks(a_masks, b_tmasks, a_idx, b_idx, c_tile_id, c_cap: int):
    """(cmask (c_cap, 16) int32, cptr (c_cap + 1,) int32, pair_ptr
    (c_cap + 1,) int32) of a pair stream sorted by C tile: bit j of row r
    of C tile c is set iff some pair of the tile has A's row mask r and
    B's transposed column mask j meet; cptr is the exclusive scan of the
    tiles' nnz, pair_ptr the tiles' pair offsets (``segment_offsets``:
    pairs at c_cap or above, the padding, lie past pair_ptr[c_cap]).
    CUDA tensors only: one launch of ``tile16_c_masks``
    (``ops.cstruct.c_masks`` dispatches; its plain version is
    ``cstruct.c_masks_plain``)."""
    from pem_spgemm_tpu_torch.ops.cstruct import _exclusive_scan
    dev = a_idx.device
    if dev.type != "cuda":
        raise ValueError("tile16_kernels.c_masks launches the CUDA kernel: "
                         "CPU tensors take cstruct.c_masks_plain")
    _check_int32(a_masks, "a_masks", dev, 16)
    _check_int32(b_tmasks, "b_tmasks", dev, 16)
    _check_stream(a_idx, b_idx, c_tile_id, dev)
    if c_cap < 1:
        raise ValueError(f"c_cap must be >= 1, got {c_cap}")
    pair_ptr = segment_offsets(c_tile_id, c_cap)
    cmask = torch.empty((c_cap, 16), dtype=torch.int32, device=dev)
    nnz = torch.empty((c_cap,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _structure_library().tile16_c_masks(
            a_masks.data_ptr(), b_tmasks.data_ptr(), a_masks.shape[0],
            b_tmasks.shape[0], a_idx.data_ptr(), b_idx.data_ptr(),
            pair_ptr.data_ptr(), c_cap, cmask.data_ptr(), nnz.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "tile16_c_masks")
    LAUNCHES["tile16_c_masks"] += 1
    return cmask, _exclusive_scan(nnz), pair_ptr


def c_rowcol(cmask, cptr, c_nnz_cap: int, c_dense=None):
    """(rowcol, elem_tile) (c_nnz_cap,) int32 of C's set bits, tile-major
    and row-major within a tile; with ``c_dense`` ((c_cap, 256) or (c_cap,
    16, 16), 4- or 8-byte values) also c_vals (c_nnz_cap,), the values at
    those positions, copied bit for bit.  Slots past C_nnz hold the last
    row of the last tile, column 0, as the plain version's.  CUDA tensors
    only: one launch of ``tile16_c_rowcol`` (``ops.cstruct.c_rowcol`` and
    ``c_rowcol_values`` dispatch; the plain version is
    ``cstruct.c_rowcol_plain`` and ``numeric.extract_values``)."""
    dev = cmask.device
    if dev.type != "cuda":
        raise ValueError("tile16_kernels.c_rowcol launches the CUDA kernel: "
                         "CPU tensors take cstruct.c_rowcol_plain")
    _check_int32(cmask, "cmask", dev, 16)
    c_cap = cmask.shape[0]
    _check_int32(cptr, "cptr", dev)
    if cptr.numel() != c_cap + 1:
        raise ValueError(f"cptr has {cptr.numel()} entries, expected "
                         f"{c_cap + 1}")
    word = 0
    if c_dense is not None:
        if c_dense.device != dev or not c_dense.is_contiguous() \
                or c_dense.numel() != c_cap * TILE_ELEMS \
                or c_dense.element_size() not in (4, 8):
            raise ValueError(f"c_dense must be {c_cap} contiguous tiles of "
                             f"4- or 8-byte values on {dev}")
        word = c_dense.element_size()
    rowcol = torch.empty((c_nnz_cap,), dtype=torch.int32, device=dev)
    elem_tile = torch.empty((c_nnz_cap,), dtype=torch.int32, device=dev)
    c_vals = None if c_dense is None else torch.empty(
        (c_nnz_cap,), dtype=c_dense.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _structure_library().tile16_c_rowcol(
            cmask.data_ptr(), cptr.data_ptr(), c_cap, c_nnz_cap,
            _ptr(c_dense), word, rowcol.data_ptr(), elem_tile.data_ptr(),
            _ptr(c_vals), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "tile16_c_rowcol")
    LAUNCHES["tile16_c_rowcol"] += 1
    if c_dense is None:
        return rowcol, elem_tile
    return rowcol, elem_tile, c_vals
