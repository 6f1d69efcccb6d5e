"""COO container: the boundary object between input and conversion.

Triplets are numpy arrays on the host, or torch tensors when they already
live on a device (the harness uploads them before the timed conversion).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    """Host numpy copy; bfloat16 values come back as float32 (numpy has no
    bfloat16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def widened(owner, slot: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels take it: float32 and float64 tensors as they
    are, a bfloat16 tensor as its float32 copy.  The copy is made once and
    cached on ``owner`` under ``slot``; where ``x`` was changed in place
    since (its version counter moved), the copy is refreshed in place, so
    it keeps its address (a captured CUDA graph that reads it stays
    valid) and sees the new values."""
    if x.dtype != torch.bfloat16:
        return x
    held = getattr(owner, slot, None)
    if held is not None and held[0] is x:
        if held[1] != x._version:
            held[2].copy_(x)
            held[1] = x._version
        return held[2]
    held = [x, x._version, x.to(torch.float32)]
    object.__setattr__(owner, slot, held)
    return held[2]


@dataclasses.dataclass
class COOMatrix:
    """COO triplets. rows/cols int32, vals any float dtype."""

    rows: object
    cols: object
    vals: object
    shape: tuple  # (n_rows, n_cols)

    def __post_init__(self):
        # Tensors stay where they are: coercing them through numpy would
        # move a device-to-host copy inside the timed conversion.
        if not isinstance(self.rows, torch.Tensor):
            self.rows = np.ascontiguousarray(self.rows, dtype=np.int32)
        if not isinstance(self.cols, torch.Tensor):
            self.cols = np.ascontiguousarray(self.cols, dtype=np.int32)
        if not isinstance(self.vals, torch.Tensor):
            self.vals = np.ascontiguousarray(self.vals)
        if not (len(self.rows) == len(self.cols) == len(self.vals)):
            raise ValueError("COO triplet arrays must have equal length")

    @property
    def nnz(self) -> int:
        return int(len(self.vals))

    def transpose(self) -> "COOMatrix":
        """A.T by swapping triplets (the A@A.T mode)."""
        return COOMatrix(self.cols, self.rows, self.vals,
                         (self.shape[1], self.shape[0]))

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.coo_matrix(
            (_to_numpy(self.vals), (_to_numpy(self.rows),
                                    _to_numpy(self.cols))),
            shape=self.shape)

    @staticmethod
    def from_scipy(m) -> "COOMatrix":
        m = m.tocoo()
        return COOMatrix(m.row, m.col, m.data, m.shape)

    def sum_duplicates(self) -> "COOMatrix":
        """Canonicalize: sort by (row, col) and sum duplicate coordinates."""
        rows, cols, vals = (_to_numpy(self.rows), _to_numpy(self.cols),
                            _to_numpy(self.vals))
        order = np.lexsort((cols, rows))
        r, c, v = rows[order], cols[order], vals[order]
        if len(r) == 0:
            return COOMatrix(r, c, v, self.shape)
        first = np.empty(len(r), dtype=bool)
        first[0] = True
        first[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        idx = np.cumsum(first) - 1
        out_v = np.zeros(int(idx[-1]) + 1, dtype=v.dtype)
        np.add.at(out_v, idx, v)
        return COOMatrix(r[first], c[first], out_v, self.shape)
