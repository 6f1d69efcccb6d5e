"""Element-level helpers of the Tile16 format.

Only the element coordinates and the row-sorted element CSR are ported:
they feed the binned element engine (ops/binned.py).  The merge-sort
engine of the JAX package's ops/element.py waits for the f64 parity slice.
"""

from __future__ import annotations

import torch


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
    key = (rows.long() << 32) | cols.long()
    order = torch.sort(key, stable=True).indices
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = torch.bincount(rows, minlength=n_rows)
    rowptr = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=rows.device),
        torch.cumsum(counts, 0, dtype=torch.int32)])
    return rowptr, rows, cols, vals
