"""DIA engine: SpGEMM over diagonal-band operands (formats/dia.py).

Counterpart of the JAX package's ops/dia.py.  For DIA operands the whole
pipeline (pair search, structure generation, numeric accumulation) reduces
to one identity over band offsets:

    C[d1 + d2][i]  +=  A[d1][i] * B[d2][i + d1]

Every (A band, B band) pair contributes one shifted elementwise multiply;
the "symbolic phase" is a host loop over D1*D2 offset pairs, and the exact
structural pattern is the same algebra run on the bands' 0/1 masks.

Two execution paths, chosen by the bands' device and nothing else:
  * bands on the GPU launch the hand-written CUDA kernels
    (ops/dia_kernels.py, csrc/dia_multiply.cu): each C element is gathered
    and written once.  They take float32 and, through their float64
    entries, float64 (the f64 parity mode); other dtypes on the GPU raise
    NotImplementedError;
  * bands on the CPU take the plain PyTorch path (this module,
    ``_dia_multiply_torch``): one (D2, n) shifted multiply and one
    ``index_add_`` per A band.  It is the kernels' plain version.

Structural dispatch: detect_dia() censuses distinct diagonals on the device;
the engine engages when the count is small enough that the band stacks fit
comfortably in device memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pem_spgemm_tpu_torch.config import resolve_device
from pem_spgemm_tpu_torch.formats.coo import _to_numpy
from pem_spgemm_tpu_torch.formats.dia import DiaMatrix

# Dispatch caps: D distinct diagonals, and total band-stack footprint
# (A + B + C values + C counts) in bytes.
MAX_BANDS = 512
MAX_BYTES = 6 << 30


# --------------------------------------------------------------------------
# Census + conversion

def _coo_device(coo, device) -> torch.device:
    """Triplets that are tensors stay on their own device; numpy triplets
    go to ``resolve_device(device)`` (the GPU, or raise)."""
    if isinstance(coo.rows, torch.Tensor):
        return coo.rows.device if device is None else torch.device(device)
    return resolve_device(device)


def _diag_census(rows, cols, n_rows, n_cols):
    """(span,) bool: is any element on diagonal d = index - (n_rows - 1)."""
    span = n_rows + n_cols - 1
    idx = (cols - rows + (n_rows - 1)).long()
    return torch.bincount(idx, minlength=span) > 0


def diag_offsets(coo, device=None) -> np.ndarray:
    """Sorted distinct diagonal offsets of a COO matrix (device census)."""
    n_rows, n_cols = coo.shape
    dev = _coo_device(coo, device)
    rows = torch.as_tensor(coo.rows).to(device=dev, dtype=torch.int32)
    cols = torch.as_tensor(coo.cols).to(device=dev, dtype=torch.int32)
    present = _diag_census(rows, cols, n_rows, n_cols)
    return (torch.nonzero(present)[:, 0].cpu().numpy().astype(np.int64)
            - (n_rows - 1))


def detect_dia(coo, max_bands: int = MAX_BANDS,
               max_bytes: int = MAX_BYTES, device=None):
    """Return the sorted offsets array if the DIA engine should run,
    else None.

    Refuses matrices carrying EXPLICIT ZERO entries: band stacks encode
    structure as value != 0, so an explicit zero would be dropped from the
    structural pattern."""
    offs = diag_offsets(coo, device)
    d = len(offs)
    if d == 0 or d > max_bands:
        return None
    n = coo.shape[0]
    sums = np.unique(offs[:, None] + offs[None, :])
    # A + B bands + C values + C counts, f32
    footprint = 4 * n * (2 * d + 2 * len(sums))
    if footprint > max_bytes:
        return None
    vals = torch.as_tensor(coo.vals).to(_coo_device(coo, device))
    if bool((vals == 0).any()):
        return None
    return offs


def _fill_bands(rows, cols, vals, lut, n_rows, n_bands):
    """Scatter the triplets into the (n_bands, n_rows) band stack; ``cols``
    arrives shifted by n_rows so that cols - rows indexes ``lut``."""
    k = lut[(cols - rows).long()].long()
    flat = torch.zeros(n_bands * n_rows, dtype=vals.dtype, device=vals.device)
    flat[k * n_rows + rows.long()] = vals
    return flat.reshape(n_bands, n_rows)


def coo_to_dia(coo, dtype=torch.float32, offsets=None,
               max_bands: int = MAX_BANDS, device=None):
    """COO -> DiaMatrix (device scatter).  Returns None if the diagonal
    census exceeds max_bands (caller falls back to another engine).

    ``device=None`` means the GPU for numpy triplets; tensors stay where
    they are.  The input must be canonical COO: the fill is a scatter, and
    with duplicate coordinates which of them lands is not defined."""
    dev = _coo_device(coo, device)
    if offsets is None:
        offsets = diag_offsets(coo, dev)
        if len(offsets) > max_bands:
            return None
    offsets = np.asarray(offsets, np.int64)
    n_rows, n_cols = coo.shape
    lut_np = np.zeros(n_rows + n_cols, np.int32)      # index by d + n_rows
    lut_np[offsets + n_rows] = np.arange(len(offsets), dtype=np.int32)
    rows = torch.as_tensor(coo.rows).to(device=dev, dtype=torch.int32)
    cols = torch.as_tensor(coo.cols).to(device=dev, dtype=torch.int32)
    vals = torch.as_tensor(coo.vals).to(device=dev, dtype=dtype)
    bands = _fill_bands(rows, cols + n_rows, vals,
                        torch.from_numpy(lut_np).to(dev), n_rows,
                        len(offsets))
    return DiaMatrix(bands=bands, shape=tuple(coo.shape),
                     offsets=tuple(int(d) for d in offsets), nnz=coo.nnz)


# --------------------------------------------------------------------------
# Multiply (plain PyTorch path)

def _plan_maps(offs_a, offs_b):
    """(dc_list, idx_map): C offsets and, per A band, the C band index of
    each (d1, d2) product."""
    if not offs_a or not offs_b:
        return (), tuple(() for _ in offs_a)
    sums = np.add.outer(np.asarray(offs_a, np.int64),
                        np.asarray(offs_b, np.int64))
    dc = np.unique(sums)
    idx_map = tuple(tuple(r) for r in np.searchsorted(dc, sums).tolist())
    return tuple(dc.tolist()), idx_map


def _dia_multiply_torch(a_bands, b_bands, *, offs_a, idx_map, dc_count,
                        n_out, values_only=False):
    """(c_bands, c_counts | None): the band-pair accumulation in plain
    PyTorch, and the plain version of both CUDA kernels.

    Counterpart of the JAX package's ``_dia_multiply_xla`` in its D1-step
    form: per A band (ascending) one (D2, n) shifted multiply added into
    the C rows ``idx_map[k1]``, and the same on the 0/1 masks.  The C rows
    of one A band are distinct, so each ``index_add_`` is deterministic.
    ``values_only=True`` skips the mask algebra and returns None for the
    counts (they are a function of the structure alone; DiaPlan caches
    them after the first run)."""
    n_i = a_bands.shape[1]
    n_k = b_bands.shape[1]
    dev = a_bands.device
    pad_l = max(0, -min(offs_a))
    pad_r = max(0, n_i + max(offs_a) - n_k)
    bp = torch.nn.functional.pad(b_bands, (pad_l, pad_r))
    c = torch.zeros((dc_count, n_out), dtype=a_bands.dtype, device=dev)
    cnt = bm = None
    if not values_only:
        bm = (bp != 0).to(torch.float32)
        cnt = torch.zeros((dc_count, n_out), dtype=torch.float32, device=dev)
    for k1, d1 in enumerate(offs_a):
        s = pad_l + d1
        a_row = a_bands[k1][None, :]
        rows = torch.as_tensor(idx_map[k1], dtype=torch.long, device=dev)
        c.index_add_(0, rows, (a_row * bp[:, s:s + n_i])[:, :n_out])
        if not values_only:
            am = (a_row != 0).to(torch.float32)
            cnt.index_add_(0, rows, (am * bm[:, s:s + n_i])[:, :n_out])
    return c, cnt


@dataclasses.dataclass
class DiaPlan:
    """Fixed-step plan for the DIA engine.

    Everything is statically shaped (C band count and lengths derive from
    the offset sets alone), so there are no capacities to overflow and
    interactive == steady up to one device-to-host copy for c_nnz.

    The structural counts are a function of the operands' STRUCTURE: the
    first run computes values + counts and caches the count stack on the
    plan; every later run executes the values-only multiply, half the
    operations and half the C write traffic.  (The interactive pipeline
    builds a fresh plan per iteration, so its repeats keep the full
    structure recomputation; only the replay of one plan reuses.)
    """

    offs_a: tuple
    offs_b: tuple
    dc_list: tuple
    idx_map: tuple
    n_out: int
    # the kernel entry for bands on the GPU: 'dense' | 'pairs' (None only
    # for empty offset sets, where there is nothing to multiply)
    kernel_mode: Optional[str] = None
    _cnt_cache: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    _tables: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)

    def grown(self):
        return self

    def fence(self, out):
        return out[0]          # c_bands: the counts may be plan-cached

    def _multiply(self, a: DiaMatrix, b: DiaMatrix, values_only: bool):
        if not a.bands.is_cuda:
            return _dia_multiply_torch(
                a.bands, b.bands, offs_a=self.offs_a, idx_map=self.idx_map,
                dc_count=len(self.dc_list), n_out=self.n_out,
                values_only=values_only)
        if (a.bands.dtype not in (torch.float32, torch.float64)
                or b.bands.dtype != a.bands.dtype):
            raise NotImplementedError(
                f"DIA bands of dtype {a.bands.dtype} / {b.bands.dtype} on "
                "the GPU: the kernels take float32 or float64 bands, both "
                "of one dtype")
        from pem_spgemm_tpu_torch.ops import dia_kernels
        if self._tables is None:
            # the kernels' small offset tables, uploaded once a plan
            self._tables = dia_kernels.dia_tables(
                self.offs_a, self.offs_b, self.dc_list, self.kernel_mode,
                a.bands.device)
        return dia_kernels.dia_multiply(
            a.bands, b.bands, offs_a=self.offs_a, offs_b=self.offs_b,
            dc_list=self.dc_list, n_out=self.n_out, mode=self.kernel_mode,
            values_only=values_only, tables=self._tables)

    def run(self, a: DiaMatrix, b: DiaMatrix):
        """(c_bands, c_counts, c_nnz_dev, overflow)."""
        overflow = torch.zeros((), dtype=torch.bool, device=a.bands.device)
        if self._cnt_cache is not None:
            c, _ = self._multiply(a, b, values_only=True)
            return c, self._cnt_cache[0], self._cnt_cache[1], overflow
        c, cnt = self._multiply(a, b, values_only=False)
        nnz = _count_nnz(cnt)
        self._cnt_cache = (cnt, nnz)
        return c, cnt, nnz, overflow


def _count_nnz(cnt):
    return (cnt > 0).sum(dtype=torch.int64)


def make_dia_plan(a: DiaMatrix, b: DiaMatrix) -> DiaPlan:
    """Build the plan (host; the step-1 analog, a pure offset-set
    computation)."""
    from pem_spgemm_tpu_torch.ops.dia_kernels import dia_mode
    dc_list, idx_map = _plan_maps(a.offsets, b.offsets)
    return DiaPlan(offs_a=a.offsets, offs_b=b.offsets, dc_list=dc_list,
                   idx_map=idx_map, n_out=a.shape[0],
                   kernel_mode=dia_mode(a.offsets, b.offsets, dc_list))


# --------------------------------------------------------------------------
# Assembly (untimed)

def dia_to_coo(c_bands, c_counts, dc_list, shape, c_nnz=None):
    """C band stacks -> sorted global COO triplets (host numpy).

    The nonzero scan runs over the transposed (n, DC) mask: dc_list
    ascends, so (row, band) order is (row, col) order and no sort is
    needed."""
    cb = _to_numpy(c_bands)
    cm = _to_numpy(c_counts) > 0
    n_rows, n_cols = shape
    dcs = np.asarray(dc_list, np.int64)
    i_idx, k_idx = np.nonzero(cm.T)
    rows = i_idx.astype(np.int64)
    cols = rows + dcs[k_idx]
    keep = (cols >= 0) & (cols < n_cols) & (rows < n_rows)
    rows, cols, k_idx, i_idx = (x[keep] for x in (rows, cols, k_idx, i_idx))
    if c_nnz is not None and len(rows) != int(c_nnz):
        raise RuntimeError(f"assembled {len(rows)} entries, the structural "
                           f"count says {int(c_nnz)}")
    return rows, cols, cb[k_idx, i_idx]
