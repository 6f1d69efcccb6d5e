"""Row copy at dynamic rows: the port of the JAX package's DMA probe.

Counterpart of scripts/pallas_probe3.py (``probe_hbm2hbm``): copy rows of
a (500,000, W) int32 table, ``out[dst[k]] = table[src[k]]``, W = 128 and
256, over 100,000 rows with ``dst`` a permutation.  A probe of the memory
system: it is not part of the SpGEMM package's paths, and nothing there
calls it.  One CUDA source (csrc/row_copy.cu, built with nvcc at first use
and bound with ctypes by ops/_build.py).

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernel (or raise, if the build or the launch fails); CPU tensors take
the plain version ``row_copy_plain``.  The wrapper adds one to
``LAUNCHES["row_copy"]`` where it launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pem_spgemm_tpu_torch import config
from pem_spgemm_tpu_torch.ops import _build

SOURCE = _build.cuda_source("row_copy")
TABLE_ROWS = 500_000        # the probe's table, as the JAX script has it
N_ROWS = 100_000            # rows copied
WIDTHS = (128, 256)         # int32 columns a row

# kernel launches (plain-version calls are not counted)
LAUNCHES = {"row_copy": 0}


def reset_launch_counts() -> None:
    LAUNCHES["row_copy"] = 0


def _declare(lib) -> None:
    vp = ctypes.c_void_p
    lib.row_copy_i32.argtypes = [vp, vp, vp, vp, ctypes.c_longlong,
                                 ctypes.c_int, vp]
    lib.row_copy_i32.restype = ctypes.c_int


def probe_inputs(w: int, n_rows: int = N_ROWS, table_rows: int = TABLE_ROWS,
                 seed: int = 0, device=None):
    """(table, src, dst) of the probe on ``device`` (None: the GPU, see
    ``config.resolve_device``): table = arange as (table_rows, w) int32, src
    uniform over the table's rows, dst a permutation of n_rows; drawn with
    numpy from ``seed``."""
    device = config.resolve_device(device)
    g = np.random.default_rng(seed)
    table = torch.arange(table_rows * w, dtype=torch.int32,
                         device=device).reshape(table_rows, w)
    src = torch.from_numpy(g.integers(0, table_rows, n_rows, dtype=np.int32))
    dst = torch.from_numpy(g.permutation(n_rows).astype(np.int32))
    return table, src.to(device), dst.to(device)


def row_copy_plain(table, src, dst, n_out=None):
    """out (n_out, W) with out[dst[k]] = table[src[k]]; rows no k names are
    zero.  The plain PyTorch version of the kernel."""
    n_out = src.numel() if n_out is None else n_out
    out = torch.zeros((n_out, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    out[dst.long()] = table[src.long()]
    return out


def row_copy(table, src, dst, n_out=None):
    """out (n_out, W) int32 with out[dst[k]] = table[src[k]] (n_out
    defaults to the number of rows copied).  ``dst`` must not repeat a row:
    which copy lands would be unspecified.  On the card, rows no k names are
    left as ``torch.empty`` gives them."""
    if table.dtype != torch.int32 or table.dim() != 2:
        raise TypeError("table must be a 2-D int32 tensor")
    if not table.is_contiguous() or table.shape[1] % 4:
        raise ValueError("table must be contiguous with a width that is a "
                         "multiple of 4")
    for x, name in ((src, "src"), (dst, "dst")):
        if (x.dtype != torch.int32 or x.dim() != 1 or x.device != table.device
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                             f"on {table.device}")
    if src.numel() != dst.numel():
        raise ValueError("src and dst differ in length")
    n_out = src.numel() if n_out is None else int(n_out)
    if not table.is_cuda:
        return row_copy_plain(table, src, dst, n_out)
    out = torch.empty((n_out, table.shape[1]), dtype=torch.int32,
                      device=table.device)
    if src.numel() == 0:                # nothing to launch, nothing counted
        return out
    lib = _build.cuda_library("row_copy", _declare)
    with torch.cuda.device(table.device):
        err = lib.row_copy_i32(table.data_ptr(), src.data_ptr(),
                               dst.data_ptr(), out.data_ptr(), src.numel(),
                               table.shape[1],
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_copy: CUDA launch failed with error {err}")
    LAUNCHES["row_copy"] += 1
    return out
