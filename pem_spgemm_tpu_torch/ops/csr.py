"""Element-level CSR SpGEMM in plain torch ops: the correctness oracle.

Counterpart of the JAX package's ops/csr.py: every (A element, B row
element) product is materialized, sorted by output coordinate, and
duplicate coordinates are summed.  O(flop log flop) work: an oracle and a
path for small matrices, not the production engine.  Its expansion finds
each product's A element by a binary search over the offsets, not by the
scatter + scan of the merge engine (ops/element.py), so the two share only
the final reduction.
"""

from __future__ import annotations

import numpy as np
import torch

from pem_spgemm_tpu_torch.config import resolve_device, round_up_pow2
from pem_spgemm_tpu_torch.formats.coo import COOMatrix, _to_numpy
from pem_spgemm_tpu_torch.ops.element import (INT32_MAX, _group_starts,
                                              _lex_order, reduce_products)


def _row_structure(b_rows, n_rows_b: int):
    """CSR row pointer of B from row-sorted COO rows."""
    counts = torch.bincount(b_rows, minlength=n_rows_b)
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=b_rows.device),
                      torch.cumsum(counts, 0, dtype=torch.int32)])


def _product_offsets(a_cols, b_rowptr):
    a = a_cols.long()
    cnt = b_rowptr[a + 1] - b_rowptr[a]
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=cnt.device),
                      torch.cumsum(cnt, 0, dtype=torch.int32)])


def _expand_products(offsets, a_rows, a_cols, a_vals, b_rowptr, b_cols,
                     b_vals, n_products: int, p_cap: int):
    """All scalar products, sorted by (row, col), with each product's
    dense output rank (INT32_MAX on padding) and the distinct count."""
    dev = a_rows.device
    p = torch.arange(p_cap, dtype=torch.int32, device=dev)
    valid = p < n_products
    a = (torch.searchsorted(offsets, p, right=True) - 1).clamp(
        0, a_rows.shape[0] - 1)
    b = b_rowptr[a_cols[a].long()] + (p - offsets[a])
    b = b.clamp(0, b_cols.shape[0] - 1).long()
    ci = torch.where(valid, a_rows[a], INT32_MAX)
    cj = torch.where(valid, b_cols[b], INT32_MAX)
    cv = torch.where(valid, a_vals[a] * b_vals[b], 0.0)
    order = _lex_order(ci, cj)
    ci, cj, cv = ci[order], cj[order], cv[order]
    out_id = torch.cumsum(_group_starts(ci, cj), 0, dtype=torch.int32) - 1
    c_nnz = int(out_id[n_products - 1]) + 1 if n_products > 0 else 0
    out_id = torch.where(valid, out_id, INT32_MAX)
    return ci, cj, cv, out_id, c_nnz


def csr_spgemm(a: COOMatrix, b: COOMatrix, dtype=torch.float32,
               device=None) -> COOMatrix:
    """C = A @ B via element-level expand-sort-reduce; canonical COO out
    (numpy triplets, values in ``dtype``).  ``device=None`` means the GPU
    and raises without one."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    dev = resolve_device(device)
    b_r, b_c, b_v = (_to_numpy(x) for x in (b.rows, b.cols, b.vals))
    b_order = np.lexsort((b_c, b_r))
    a_rows = torch.as_tensor(_to_numpy(a.rows), device=dev)
    a_cols = torch.as_tensor(_to_numpy(a.cols), device=dev)
    a_vals = torch.as_tensor(_to_numpy(a.vals).astype(np.float64),
                             device=dev).to(dtype)
    b_rows = torch.as_tensor(b_r[b_order], device=dev)
    b_cols = torch.as_tensor(b_c[b_order], device=dev)
    b_vals = torch.as_tensor(b_v[b_order].astype(np.float64),
                             device=dev).to(dtype)
    b_rowptr = _row_structure(b_rows, b.shape[0])
    offsets = _product_offsets(a_cols, b_rowptr)
    n_products = int(offsets[-1])
    shape = (a.shape[0], b.shape[1])
    if n_products == 0:
        return COOMatrix(np.zeros(0, np.int32), np.zeros(0, np.int32),
                         np.zeros(0, np.float64), shape)
    p_cap = round_up_pow2(n_products)
    ci, cj, cv, out_id, c_nnz = _expand_products(
        offsets, a_rows, a_cols, a_vals, b_rowptr, b_cols, b_vals,
        n_products, p_cap)
    rows, cols, vals = reduce_products(ci, cj, cv, out_id,
                                       round_up_pow2(c_nnz))
    return COOMatrix(rows[:c_nnz].cpu().numpy(), cols[:c_nnz].cpu().numpy(),
                     vals[:c_nnz].cpu().numpy(), shape)
