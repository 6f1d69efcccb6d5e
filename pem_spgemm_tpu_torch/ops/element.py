"""Element-level SpGEMM: the merge engine and the element CSR.

Counterpart of the JAX package's ops/element.py.  Expand every scalar
product, sort by output coordinate, and reduce each coordinate's products:
no tiles, work proportional to the products.

The element coordinates and the row-sorted element CSR feed both element
engines.  The merge engine is the rest of this module; ``SpGEMM`` sends
``element_impl="merge"`` and every value dtype other than float32 to it
(the binned engine, ops/binned.py, is float32 only):

  * float32: ``expand_reduce_products``, gather-free forward fills and one
    merge sort with the B table (the value bits travel as int32, as in the
    JAX package), products grouped by one (row, col) sort and summed by a
    segmented scan; C comes out in stream form, totals at ``first`` slots;
  * wider dtypes (the f64 parity mode): ``expand_sorted_products``, the
    gather-based expansion that keeps the native dtype end to end, and
    ``reduce_products``.

Everything here is torch ops, as the JAX module is XLA with no Pallas
kernel.  Where the JAX code sorts on two int32 keys this module makes one
stable sort on the composite int64 key (hi << 32) | lo, which gives the
same order (ties keep their input order).  Group totals match the JAX
package's within the dtype's rounding: which products tie, and so the order
in which a group is summed, may differ.
"""

from __future__ import annotations

import torch

from pem_spgemm_tpu_torch.ops import scanops

INT32_MAX = 0x7FFFFFFF


def element_coords(tile_row, tile_col, elem_tile, rowcol):
    """Global (row, col) of every element of a TiledMatrix."""
    et = elem_tile.long()
    rows = tile_row[et] * 16 + (rowcol >> 4)
    cols = tile_col[et] * 16 + (rowcol & 15)
    return rows, cols


def build_element_csr(tile_row, tile_col, elem_tile, rowcol, vals,
                      n_rows: int):
    """Row-sorted element triplets + row pointer.

    The JAX package sorts on two keys; here it is one stable sort on the
    composite int64 key (row << 32) | col, which gives the same order.
    """
    rows, cols = element_coords(tile_row, tile_col, elem_tile, rowcol)
    order = _lex_order(rows, cols)
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = torch.bincount(rows, minlength=n_rows)
    rowptr = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=rows.device),
        torch.cumsum(counts, 0, dtype=torch.int32)])
    return rowptr, rows, cols, vals


def _lex_order(hi, lo):
    """Stable permutation sorting by (hi, lo), both non-negative int32."""
    return torch.sort((hi.long() << 32) | lo.long(), stable=True).indices


def _count_tensor(n, device):
    """A product count (a Python int or a 0-d device tensor) as a 0-d
    tensor on ``device``."""
    return torch.as_tensor(n, dtype=torch.int64, device=device)


def _take(x, i):
    """x[i] as a 0-d tensor for i a 0-d index tensor, without a
    device-to-host copy."""
    return x.index_select(0, i.reshape(1).long())[0]


def _group_starts(ci, cj):
    """(n,) int32: 1 where (ci, cj) differs from the slot before (and at 0)."""
    new = torch.ones_like(ci)
    new[1:] = ((ci[1:] != ci[:-1]) | (cj[1:] != cj[:-1])).to(torch.int32)
    return new


def product_offsets(a_cols, b_row_nnz):
    """(nnz_a + 1,) int32 exclusive scan of the products each A element
    makes (the nnz of its B row)."""
    cnt = b_row_nnz[a_cols.long()]
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=cnt.device),
                      torch.cumsum(cnt, 0, dtype=torch.int32)])


def expand_sorted_products(offsets, a_rows, a_cols, a_vals, b_rowptr,
                           b_cols, b_vals, n_products, p_cap: int):
    """Scalar products sorted by (row, col) with boundary flags.

    ``n_products`` is an int or a 0-d device tensor (no host copy is made
    of it).  Returns (ci, cj, cv, out_id, c_nnz): coordinates, product
    values in the operands' dtype, dense output rank per product
    (INT32_MAX on padding) and the distinct count as a 0-d tensor.
    """
    dev = a_rows.device
    p = torch.arange(p_cap, dtype=torch.int32, device=dev)
    valid = p < n_products
    a = scanops.segment_ids_from_offsets(offsets, p_cap).clamp(
        0, a_rows.shape[0] - 1).long()
    b = b_rowptr[a_cols[a].long()] + (p - offsets[a])
    b = b.clamp(0, b_cols.shape[0] - 1).long()
    ci = torch.where(valid, a_rows[a], INT32_MAX)
    cj = torch.where(valid, b_cols[b], INT32_MAX)
    cv = torch.where(valid, a_vals[a] * b_vals[b], 0.0)
    order = _lex_order(ci, cj)
    ci, cj, cv = ci[order], cj[order], cv[order]
    del order
    out_id = torch.cumsum(_group_starts(ci, cj), 0, dtype=torch.int32) - 1
    n_prod = _count_tensor(n_products, dev)
    c_nnz = torch.where(n_prod > 0,
                        _take(out_id, (n_prod - 1).clamp(min=0)) + 1, 0)
    out_id = torch.where(valid, out_id, INT32_MAX)
    return ci, cj, cv, out_id, c_nnz


def _f2i(x):
    return x.to(torch.float32).view(torch.int32)


def _i2f(x):
    return x.view(torch.float32)


def expand_reduce_products(offsets, a_rows, a_cols, a_vals, b_rowptr,
                           b_cols, b_vals, n_products, p_cap: int,
                           fill_rounds=None, merge_rounds=None,
                           sum_rounds=None):
    """Gather-free product expansion + grouping + reduction (float32).

    The JAX package's design for a chip where per-product gathers dominate:
      1. A-side terms reach the product stream by forward fills from the
         segment starts (scanops.fill_*);
      2. B-side terms attach by ONE merge sort: the B element table (keys
         2*i) and the product stream (keys 2*b(p)+1) sort together, and
         each query forward-fills (col, val bits) from the nearest table
         entry above it;
      3. products group by one (row, col) sort, and a segmented scan over
         the reversed stream leaves each group's total at its first slot.

    Returns C in STREAM FORM (rows, cols, vals, first, c_nnz) of length
    p_cap + nnz_b + 1, row-major sorted; ``first`` (int32) flags the leading
    product of each (row, col) group, whose ``vals`` slot holds the group's
    total; c_nnz is a 0-d tensor.  Values move as float32 bits.
    ``*_rounds`` bound the scans' depths (``scan_round_bounds``); None scans
    the full length.
    """
    dev = a_rows.device
    nnz_b = b_cols.shape[0]
    starts = offsets[:-1]
    p = torch.arange(p_cap, dtype=torch.int32, device=dev)
    valid = p < n_products

    # --- 1. A-side fills ---
    ci = scanops.fill_monotone_i32(starts, a_rows, p_cap)
    off = scanops.fill_monotone_i32(starts, starts, p_cap)
    b_base_e = b_rowptr[a_cols.long()]
    bb, va = scanops.fill_any_multi(starts, (b_base_e, _f2i(a_vals)), p_cap,
                                    rounds=fill_rounds)
    b = bb + (p - off)
    b = torch.where(valid, b.clamp(0, nnz_b - 1), nnz_b)
    ci = torch.where(valid, ci, INT32_MAX)

    # --- 2. merge sort with the B table ---
    tkey = torch.arange(nnz_b + 1, dtype=torch.int32, device=dev) * 2
    key = torch.cat([tkey, b * 2 + 1])
    pl1 = torch.cat([b_cols, torch.full((1,), INT32_MAX, dtype=torch.int32,
                                        device=dev), ci])
    pl2 = torch.cat([_f2i(b_vals), torch.zeros(1, dtype=torch.int32,
                                               device=dev), va])
    key, order = torch.sort(key, stable=True)
    pl1, pl2 = pl1[order], pl2[order]
    del order
    n2 = key.shape[0]
    is_table = (key & 1) == 0
    pos = torch.arange(n2, dtype=torch.int32, device=dev)
    guard = torch.where(is_table, pos, -1)

    def comb(a_, b_):
        ga, c1a, c2a = a_
        gb, c1b, c2b = b_
        t = gb >= ga
        return (torch.where(t, gb, ga), torch.where(t, c1b, c1a),
                torch.where(t, c2b, c2a))

    _, fill_col, fill_valbits = scanops.fori_scan(
        comb, (guard, pl1, pl2), (-1, 0, 0), rounds=merge_rounds)

    live = ~is_table & (pl1 != INT32_MAX)
    cv = torch.where(live, _i2f(pl2) * _i2f(fill_valbits), 0.0)
    ci2 = torch.where(live, pl1, INT32_MAX)
    cj2 = torch.where(live, fill_col, INT32_MAX)

    # --- 3. group by (row, col); segmented sum via log-shift scan ---
    order = _lex_order(ci2, cj2)
    ci2, cj2, cv = ci2[order], cj2[order], cv[order]
    del order
    new = _group_starts(ci2, cj2)
    out_id = torch.cumsum(new, 0, dtype=torch.int32) - 1
    n_prod = _count_tensor(n_products, dev)
    c_nnz = torch.where(n_prod > 0,
                        _take(out_id, (n_prod - 1).clamp(0, n2 - 1)) + 1, 0)
    last = torch.ones_like(out_id)
    last[:-1] = (out_id[1:] != out_id[:-1]).to(torch.int32)

    def segsum(a_, b_):
        fa, va_ = a_
        fb, vb_ = b_
        return fa | fb, vb_ + torch.where(fb == 1, 0.0, va_)

    _, summed_rev = scanops.fori_scan(segsum, (last.flip(0), cv.flip(0)),
                                      (0, 0.0), rounds=sum_rounds)
    return ci2, cj2, summed_rev.flip(0), new, c_nnz


def scan_round_bounds(a_rows_np, a_cols_np, b_row_nnz_np):
    """Host-computed static scan-depth bounds (see expand_reduce_products).

    Returns (fill_rounds, merge_rounds, sum_rounds), each rounded up to an
    even count (the JAX package's rule, so plans compare equal).
    """
    import numpy as np

    def ceil_log2(x):
        return max(1, int(x - 1).bit_length()) if x > 1 else 1

    def even(r):
        return r + (r & 1)

    max_brow = int(b_row_nnz_np.max()) if len(b_row_nnz_np) else 1
    arow_cnt = np.bincount(a_rows_np) if len(a_rows_np) else np.array([1])
    max_arow = int(arow_cnt.max())
    acol_cnt = np.bincount(a_cols_np) if len(a_cols_np) else np.array([1])
    max_acol = int(acol_cnt.max())
    return (even(ceil_log2(max_brow) + 1),
            even(ceil_log2(max_acol) + 2),
            even(ceil_log2(max_arow) + 1))


def compact_stream(rows, cols, vals, first):
    """Untimed assembly: stream form -> compact sorted COO (device).

    One stable sort by (first ? rank : rank | 1<<30): the flagged entries
    land in the leading c_nnz slots in row-major order.
    """
    out_id = torch.cumsum(first, 0, dtype=torch.int32) - 1
    ckey = torch.where(first == 1, out_id, out_id | (1 << 30))
    order = torch.sort(ckey, stable=True).indices
    return rows[order], cols[order], vals[order]


def element_fixed(a_rows, a_cols, a_vals, b_rowptr, b_cols, b_vals, *,
                  p_cap: int, c_cap: int, fill_rounds=None,
                  merge_rounds=None, sum_rounds=None):
    """One-shot element-level SpGEMM at static capacities, with no
    device-to-host copy (every size stays a device scalar).

    Returns C in stream form plus an overflow flag: (rows, cols, vals,
    first, c_nnz, overflow); overflow True means p_cap < the true product
    count and the result is truncated: re-plan with a larger capacity (the
    harness does).  ``c_cap`` is accepted for plan compatibility.
    """
    del c_cap
    if a_vals.dtype.itemsize > 4:
        raise TypeError(
            "element_fixed moves value bits as float32 and would silently "
            f"downcast {a_vals.dtype}; wide dtypes take element_fixed_wide")
    offsets = product_offsets(a_cols, b_rowptr[1:] - b_rowptr[:-1])
    n_products = offsets[-1].clamp(max=p_cap)
    out = expand_reduce_products(
        offsets, a_rows, a_cols, a_vals, b_rowptr, b_cols, b_vals,
        n_products, p_cap, fill_rounds, merge_rounds, sum_rounds)
    return out + (offsets[-1] > p_cap,)


def element_fixed_wide(a_rows, a_cols, a_vals, b_rowptr, b_cols, b_vals, *,
                       p_cap: int, c_cap: int):
    """Wide-dtype (f64 parity) fixed element step, with no device-to-host
    copy: ``expand_sorted_products`` + ``reduce_products``, the values in
    their own dtype end to end.

    Returns stream-compatible (rows, cols, vals, first, c_nnz, overflow):
    compact COO in the leading c_nnz slots, ``first`` set on every real
    output (each is its own group).
    """
    offsets = product_offsets(a_cols, b_rowptr[1:] - b_rowptr[:-1])
    n_products = offsets[-1].clamp(max=p_cap)
    ci, cj, cv, out_id, c_nnz = expand_sorted_products(
        offsets, a_rows, a_cols, a_vals, b_rowptr, b_cols, b_vals,
        n_products, p_cap)
    rows, cols, vals = reduce_products(ci, cj, cv, out_id, c_cap)
    first = (rows != INT32_MAX).to(torch.int32)
    overflow = (offsets[-1] > p_cap) | (c_nnz > c_cap)
    return rows, cols, vals, first, c_nnz, overflow


def reduce_products(ci, cj, cv, out_id, c_cap: int):
    """Coordinates + summed values of the distinct outputs (c_cap slots,
    padding INT32_MAX).  Ranks at or past c_cap are dropped.  The sums are
    one ``index_add_``; on the GPU it adds with atomics, so the order of a
    group's products, and the last bits of its total, may change from run
    to run."""
    dev = ci.device
    oid = out_id.clamp(max=c_cap).long()
    rows = torch.full((c_cap + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    cols = torch.full((c_cap + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    rows.scatter_(0, oid, ci)
    cols.scatter_(0, oid, cj)
    vals = torch.zeros(c_cap + 1, dtype=cv.dtype, device=dev)
    vals.index_add_(0, oid, cv)
    return rows[:c_cap], cols[:c_cap], vals[:c_cap]
