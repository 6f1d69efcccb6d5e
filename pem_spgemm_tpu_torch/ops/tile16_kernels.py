"""Tile16 accumulation kernel: wrappers of csrc/tile16_accumulate.cu.

The Tile16 tier's numeric phase on the card.  It replaces no Pallas
kernel: the JAX package computes this phase in XLA (its ops/numeric.py
``accumulate_fused_flat`` and ``accumulate_dense``, and the ring stage of
its parallel/sharded.py), and the port's first version ran it as torch ops
(gathers, 0/1 casts, two ``torch.bmm``, ``index_add_`` with atomics): 42 of
a 48 ms steady multiply at pairbands-500k on an H100.  One CUDA source,
two entries (built with nvcc at first use and bound with ctypes by
ops/_build.py), each a pair stream sorted by C tile:

  tile16_accumulate_pairs_f32   float32 tiles (and the float32 copies of
                                bfloat16 tiles), FP32 FMA;
  tile16_accumulate_pairs_f64   float64 tiles, DFMA.

Each has three forms: fresh with the structural counts (the fused engine,
``accumulate_fused_flat``), fresh with values only (the masks engine,
``accumulate_dense``, and a ring rank's first stage) and accumulate
(``accumulate_dense(..., out=c)``: a ring rank's later stages add into its
C; a tile without pairs is neither read nor written).  One warp owns a C
tile, sums its pairs in stream order in registers and writes it once: no
atomics, so a launch gives the same bits every time.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernel (or raise, if the build or the launch fails); CPU tensors take
the plain PyTorch version (``ops.numeric.fused_flat_plain``,
``ops.numeric.dense_plain``).  Each wrapper adds one to its entry in
``LAUNCHES`` where it launches the kernel, and nowhere else: the float32
entry's fresh forms count under ``tile16_accumulate_pairs``, its
accumulate form under ``tile16_accumulate_pairs_acc`` (``_f64`` for the
float64 entry).
"""

from __future__ import annotations

import ctypes
import math

import torch

from pem_spgemm_tpu_torch.config import precision_code
from pem_spgemm_tpu_torch.ops import _build, numeric
from pem_spgemm_tpu_torch.ops.macro import require_full_fp32, round_operands
from pem_spgemm_tpu_torch.ops.macro_kernels import segment_offsets

SOURCE = _build.cuda_source("tile16_accumulate")
TILE_ELEMS = 256

# kernel launches per entry and form (plain-version calls are not counted)
LAUNCHES = {"tile16_accumulate_pairs": 0, "tile16_accumulate_pairs_acc": 0,
            "tile16_accumulate_pairs_f64": 0,
            "tile16_accumulate_pairs_f64_acc": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tile16_accumulate_pairs_f32,
               lib.tile16_accumulate_pairs_f64):
        fn.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, vp, ci, vp, vp, ci,
                       vp]
        fn.restype = ci


def _library():
    return _build.cuda_library("tile16_accumulate", _declare)


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
    """(the entry's value dtype, whether the tables need a float32 copy) of
    CUDA tables of ``table_dtype`` accumulated in ``acc_dtype``; any other
    pairing raises."""
    if table_dtype == torch.float64 and acc_dtype == torch.float64:
        return torch.float64, False
    if table_dtype in (torch.float32, torch.bfloat16) \
            and acc_dtype == torch.float32:
        return torch.float32, table_dtype == torch.bfloat16
    raise NotImplementedError(
        f"{table_dtype} tiles accumulated in {acc_dtype} on the GPU: the "
        "Tile16 kernel takes float32 or bfloat16 tiles into float32, or "
        "float64 tiles into float64")


def _operands(a, b, acc_dtype, precision):
    """(a_val, b_val, a_pat, b_pat) for the kernel: float32 copies of
    bfloat16 tables (once a call), the values rounded as ``precision`` says
    where the tables are float32 (``round_operands``, once a call), the
    pattern from the raw tables (the same tensors at "highest")."""
    dtype, copy = _entry_dtypes(a.dtype, acc_dtype)
    if b.dtype != a.dtype:
        raise TypeError(f"tables of two dtypes: {a.dtype}, {b.dtype}")
    same = b is a
    if copy:
        a = a.to(dtype)
        b = a if same else b.to(dtype)
    if dtype == torch.float32 and not copy:
        a_val = round_operands(a, precision)
        b_val = a_val if same else round_operands(b, precision)
    else:
        a_val, b_val = a, b
    return a_val, b_val, a, b


def _launch(a_val, b_val, a_pat, b_pat, a_idx, b_idx, seg, c_cap, c_val,
            c_cnt, accumulate):
    """One launch of the entry of ``a_val``'s dtype (c_cap > 0)."""
    dev = a_val.device
    seg_ptr = segment_offsets(seg, c_cap)
    f64 = a_val.dtype == torch.float64
    lib = _library()
    fn = lib.tile16_accumulate_pairs_f64 if f64 \
        else lib.tile16_accumulate_pairs_f32
    with torch.cuda.device(dev):
        err = fn(a_val.data_ptr(), b_val.data_ptr(), a_pat.data_ptr(),
                 b_pat.data_ptr(), a_val.shape[0], b_val.shape[0],
                 a_idx.data_ptr(), b_idx.data_ptr(), seg_ptr.data_ptr(),
                 c_cap, c_val.data_ptr(),
                 None if c_cnt is None else c_cnt.data_ptr(),
                 int(accumulate), torch.cuda.current_stream().cuda_stream)
    entry = "tile16_accumulate_pairs" + ("_f64" if f64 else "") \
        + ("_acc" if accumulate else "")
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
    bfloat16 tables with acc_dtype float32 the float32 entry (bfloat16 as
    float32 copies), float64 tables with acc_dtype float64 the float64
    entry; anything else raises.  CPU tables take the plain version.
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
    a_val, b_val, a_pat, b_pat = _operands(a_flat, b_flat, acc_dtype,
                                           precision)
    c_val = torch.empty((c_cap, TILE_ELEMS), dtype=a_val.dtype, device=dev)
    c_cnt = torch.empty((c_cap, TILE_ELEMS), dtype=torch.float32,
                        device=dev)
    if c_cap > 0:
        _launch(a_val, b_val, a_pat, b_pat, a_idx, b_idx, c_tile_id, c_cap,
                c_val, c_cnt, False)
    return c_val, c_cnt


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
    a_val, b_val, _a_pat, _b_pat = _operands(a_dense, b_dense, acc_dtype,
                                             precision)
    if out is None:
        c = torch.empty((c_cap, 16, 16), dtype=a_val.dtype, device=dev)
    else:
        _check_out(out, c_cap, a_val.dtype, dev)
        c = out
    if c_cap > 0:
        _launch(a_val, b_val, a_val, b_val, a_idx, b_idx, c_tile_id, c_cap,
                c, None, out is not None)
    return c
