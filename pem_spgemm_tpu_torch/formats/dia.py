"""DIA: the diagonal-band format for stencil / banded structure.

Counterpart of the JAX package's formats/dia.py.  When a matrix's nonzeros
live on a small set of diagonals, SpGEMM collapses into vector algebra with
no structure handling at all:

    C[d1 + d2][i]  +=  A[d1][i] * B[d2][i + d1]

for every pair of bands (d1 of A, d2 of B) one shifted elementwise multiply
of length n, and the structural pattern falls out of running the bands' 0/1
masks through the same algebra (ops/dia.py).

Bands are stored ROW-ALIGNED: bands[k][i] = M[i, i + offsets[k]], zero
outside the valid range i in [max(0, -d), n - max(0, d)).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DiaMatrix:
    """A sparse matrix as a dense stack of diagonal bands.

    ``offsets`` is host metadata (a sorted tuple of int diagonal offsets,
    col - row); ``bands`` is the (D, n) value stack on the device.  Only
    matrices whose nonzeros all lie on one of D diagonals are representable;
    the converter (ops/dia.coo_to_dia) rejects inputs whose diagonal census
    exceeds the cap.
    """

    bands: torch.Tensor     # (D, n) value dtype, row-aligned
    shape: tuple
    offsets: tuple
    nnz: int

    @property
    def n(self) -> int:
        return int(self.bands.shape[1])

    @property
    def nbands(self) -> int:
        return len(self.offsets)

    @property
    def device(self) -> torch.device:
        return self.bands.device

    def to_coo_numpy(self):
        """Round-trip to COO triplets (host; tests/debug)."""
        bands = self.bands.detach().cpu().numpy()
        rows_l, cols_l, vals_l = [], [], []
        n_rows, n_cols = self.shape
        for k, d in enumerate(self.offsets):
            lo = max(0, -d)
            hi = min(n_rows, n_cols - d)
            i = np.arange(lo, hi)
            v = bands[k, lo:hi]
            nz = v != 0
            rows_l.append(i[nz])
            cols_l.append(i[nz] + d)
            vals_l.append(v[nz])
        rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
        cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
        vals = np.concatenate(vals_l) if vals_l else np.zeros(0)
        order = np.lexsort((cols, rows))
        return rows[order], cols[order], vals[order]
