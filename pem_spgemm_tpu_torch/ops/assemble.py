"""Result assembly: tiled C -> globally sorted COO.

Counterpart of the JAX package's ops/assemble.py (the reference's
sanitize_C and stable sort): expand tile coordinates to global (row, col)
and sort lexicographically.  Outside the timed multiply, as in the
reference.
"""

from __future__ import annotations

import torch

INT32_MAX = 0x7FFFFFFF


def assemble_coo(c_tile_row, c_tile_col, c_rowcol, c_elem_tile, c_vals,
                 c_nnz):
    """Global, row-major-sorted COO triplets (padded slots sorted last).

    c_nnz: int or device scalar, the true element count; entries at
    positions >= c_nnz get INT32_MAX keys so the caller can slice them off.
    """
    n = c_rowcol.shape[0]
    valid = torch.arange(n, dtype=torch.int32, device=c_rowcol.device) < c_nnz
    et = c_elem_tile.long()
    tr = c_tile_row[et].long()
    tc = c_tile_col[et].long()
    rows = torch.where(valid, tr * 16 + (c_rowcol >> 4), INT32_MAX)
    cols = torch.where(valid, tc * 16 + (c_rowcol & 15), INT32_MAX)
    order = torch.sort((rows << 32) | cols, stable=True).indices
    return (rows[order].to(torch.int32), cols[order].to(torch.int32),
            c_vals[order])
