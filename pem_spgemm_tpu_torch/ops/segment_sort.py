"""Segment sort + dedup: the binned element engine's collision kernel.

Counterpart of the JAX package's ops/pallas_sort.py.  Two entries, one CUDA
source (csrc/segment_sort.cu, built with nvcc at first use and bound with
ctypes by ops/_build.py):

  segment_sort_dedup(cols, vals, rounds=, presorted_w=) -> (keys, vals, first)
      per row: keys ascending (SENTINEL padding last), each duplicate
      group's total at its first slot, first-flags;
  segment_dedup(keys, vals, abits=None, count=None) -> (vals, first, count)
      the same group reduction over rows that are already sorted, plus the
      count of first-flags (added into ``count`` where the caller passes
      one); with ``abits`` the value is formed on the fly as the product of
      two float32 bit patterns.

Values at slots that are not a group's first are unspecified, in the
kernel and in the plain versions alike.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (or raises, if the build or the launch fails); a CPU
tensor takes the plain PyTorch version in this module.  Each wrapper adds
one to its entry in ``LAUNCHES`` where it launches its kernel, and nowhere
else: an input with no slots returns empty outputs without a launch.
"""

from __future__ import annotations

import ctypes

import torch

from pem_spgemm_tpu_torch.ops import _build
from pem_spgemm_tpu_torch.ops._build import (BUILD_DIR, NVCC_FLAGS,
                                             build_kernels)

SENTINEL = 0x7FFFFFFF
SORT_MAX = 4096             # widest segment the sort entry takes
# the CUDA source's launch shape (csrc/segment_sort.cu, kThreads and
# kDedupItems); tests/test_torch_segment_tiles.py replays both entries with
# these, so the two change together
THREADS = 256               # threads a block, both entries
DEDUP_ITEMS = 8             # consecutive slots a thread of the dedup entry
DEDUP_TILE = THREADS * DEDUP_ITEMS      # slots a block of the dedup entry


def sort_items(p2: int) -> int:
    """Consecutive slots a thread of the sort entry holds for segments of
    p2 slots (a block holds THREADS times as many, whole segments)."""
    return 8 if p2 <= THREADS * 8 else 16

SOURCE = _build.cuda_source("segment_sort")

# kernel launches per entry (plain-version calls are not counted)
LAUNCHES = {"segment_sort_dedup": 0, "segment_dedup": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.segment_sort_dedup_f32.argtypes = [vp, vp, vp, vp, vp, ll, ci, ci,
                                           ci, vp]
    lib.segment_sort_dedup_f32.restype = ci
    lib.segment_dedup_f32.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, vp]
    lib.segment_dedup_f32.restype = ci


def _library():
    return _build.cuda_library("segment_sort", _declare)


def _check(x, name, dtype, device=None, shape=None):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D (rows, slots), got "
                         f"{tuple(x.shape)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


# --------------------------------------------------------------------------
# plain PyTorch versions

def _group_totals(keys, vals):
    """(first, totals): first-flags and every slot's group total, for rows
    sorted by key.  One flat index_add over group ids."""
    r, l = keys.shape
    new = torch.ones((r, l), dtype=torch.bool, device=keys.device)
    new[:, 1:] = keys[:, 1:] != keys[:, :-1]
    first = new & (keys != SENTINEL)
    gid = torch.cumsum(new.reshape(-1), 0) - 1
    totals = torch.zeros(r * l, dtype=vals.dtype, device=vals.device)
    totals.index_add_(0, gid, vals.reshape(-1))
    return first, totals[gid].reshape(r, l)


def segment_sort_dedup_plain(cols, vals, *, rounds=0, presorted_w=0):
    """Plain version of segment_sort_dedup: stable torch.sort + gather, then
    a group sum.  ``rounds`` and ``presorted_w`` do not change the result."""
    keys, order = torch.sort(cols, dim=1, stable=True)
    v = torch.gather(vals, 1, order)
    first, totals = _group_totals(keys, v)
    return keys, totals, first


def segment_dedup_plain(keys, vals, abits=None, count=None):
    """Plain version of segment_dedup."""
    if abits is not None:
        vals = vals.view(torch.float32) * abits.view(torch.float32)
    first, totals = _group_totals(keys, vals)
    n = first.sum(dtype=torch.int32)
    if count is None:
        return totals, first, n
    return totals, first, count.add_(n)


# --------------------------------------------------------------------------
# wrappers

def segment_sort_dedup(cols, vals, *, rounds, presorted_w=0):
    """(keys, vals, first) for independent row segments.

    cols (R, MW) int32 with SENTINEL padding, vals (R, MW) float32,
    MW <= SORT_MAX.  ``rounds`` is the JAX kernel's dedup-scan depth; the
    contract is "the group's total at its first slot", which neither
    implementation here needs a depth for, so it is accepted and unused.
    ``presorted_w``: every presorted_w-slot run of the input is sorted, odd
    runs descending (a power of two that divides MW); the kernel then runs
    the merge stages only.
    """
    _check(cols, "cols", torch.int32)
    _check(vals, "vals", torch.float32, cols.device, cols.shape)
    r, mw = cols.shape
    if mw > SORT_MAX:
        raise ValueError(f"segment width {mw} exceeds {SORT_MAX}")
    if presorted_w and (mw % presorted_w
                        or presorted_w & (presorted_w - 1)):
        raise ValueError(f"presorted_w={presorted_w} must be a power of "
                         f"two dividing the segment width {mw}")
    if not cols.is_cuda:
        return segment_sort_dedup_plain(cols, vals, rounds=rounds,
                                        presorted_w=presorted_w)
    keys = torch.empty_like(cols)
    out = torch.empty_like(vals)
    first = torch.empty(cols.shape, dtype=torch.bool, device=cols.device)
    if cols.numel() == 0:               # nothing to launch, nothing counted
        return keys, out, first
    lib = _library()
    p2 = 1 << max(1, (mw - 1).bit_length())
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.segment_sort_dedup_f32(
            cols.data_ptr(), vals.data_ptr(), keys.data_ptr(),
            out.data_ptr(), first.data_ptr(), r, mw, p2, int(presorted_w),
            stream)
    _raise_on(err, "segment_sort_dedup")
    LAUNCHES["segment_sort_dedup"] += 1
    return keys, out, first


def segment_dedup(keys, vals, abits=None, count=None):
    """(vals, first, count) over rows whose keys are already sorted.

    keys (R, L) int32; vals (R, L) float32, or with ``abits`` two (R, L)
    int32 arrays of float32 bit patterns whose product is the value.
    count is a 0-d int32 tensor (the number of first-flags).  Any width.
    With ``count`` given (a 0-d int32 tensor on the keys' device) the
    number of first-flags is added into it and it is the count returned:
    one accumulator serves every call of a multiply.
    """
    _check(keys, "keys", torch.int32)
    if abits is None:
        _check(vals, "vals", torch.float32, keys.device, keys.shape)
    else:
        _check(vals, "vals", torch.int32, keys.device, keys.shape)
        _check(abits, "abits", torch.int32, keys.device, keys.shape)
    if count is not None and (
            not isinstance(count, torch.Tensor) or count.dtype != torch.int32
            or count.dim() != 0 or count.device != keys.device):
        raise ValueError("count must be a 0-d int32 tensor on the keys' "
                         "device")
    if not keys.is_cuda:
        return segment_dedup_plain(keys, vals, abits, count)
    r, l = keys.shape
    out = torch.empty(keys.shape, dtype=torch.float32, device=keys.device)
    first = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    if count is None:
        count = torch.zeros((), dtype=torch.int32, device=keys.device)
    if keys.numel() == 0:               # nothing to launch, nothing counted
        return out, first, count
    lib = _library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.segment_dedup_f32(
            keys.data_ptr(), vals.data_ptr(),
            abits.data_ptr() if abits is not None else None,
            out.data_ptr(), first.data_ptr(), count.data_ptr(), r, l,
            stream)
    _raise_on(err, "segment_dedup")
    LAUNCHES["segment_dedup"] += 1
    return out, first, count
