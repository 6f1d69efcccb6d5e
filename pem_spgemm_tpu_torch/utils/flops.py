"""FLOP accounting, identical to the reference's definitions.

  flop              = sum over A's nonzeros (i, j) of nnz(row j of B)
  GFlops            = 2 * flop / time
  compression_ratio = flop / nnz(C)
"""

from __future__ import annotations

import numpy as np
import torch


def spgemm_flops(a_cols, b_rows, n_rows_b: int) -> int:
    """Intermediate-product count of A@B from COO triplets.

    Tensor triplets are counted on their own device in int64 (one scalar
    crosses to the host); numpy triplets on the host.
    """
    if isinstance(a_cols, torch.Tensor) or isinstance(b_rows, torch.Tensor):
        a_cols = torch.as_tensor(a_cols)
        b_rows = torch.as_tensor(b_rows).to(a_cols.device)
        b_row_nnz = torch.bincount(b_rows.long(), minlength=n_rows_b)
        return int(b_row_nnz[a_cols.long()].sum())
    b_row_nnz = np.bincount(np.asarray(b_rows), minlength=n_rows_b)
    return int(b_row_nnz[np.asarray(a_cols)].sum(dtype=np.int64))


def gflops(flop: int, seconds: float) -> float:
    return 2.0 * flop / seconds / 1e9 if seconds > 0 else 0.0


def compression_ratio(flop: int, c_nnz: int) -> float:
    return flop / c_nnz if c_nnz else 0.0
