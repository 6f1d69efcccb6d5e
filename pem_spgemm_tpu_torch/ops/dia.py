"""Diagonal census for the structural dispatch.

Only the census of the JAX package's ops/dia.py is ported, so that the
harness's ``engine="auto"`` still asks whether a matrix belongs to the DIA
engine; the engine itself is ROADMAP slice 2.
"""

from __future__ import annotations

import numpy as np
import torch

# Dispatch caps: D distinct diagonals, and total band-stack footprint
# (A + B + C values + C counts) in bytes.
MAX_BANDS = 512
MAX_BYTES = 6 << 30


def _diag_census(rows, cols, n_rows, n_cols):
    """(span,) bool: is any element on diagonal d = index - (n_rows - 1)."""
    span = n_rows + n_cols - 1
    idx = (cols - rows + (n_rows - 1)).long()
    return torch.bincount(idx, minlength=span) > 0


def diag_offsets(coo) -> np.ndarray:
    """Sorted distinct diagonal offsets of a COO matrix."""
    n_rows, n_cols = coo.shape
    rows = torch.as_tensor(coo.rows).to(torch.int32)
    cols = torch.as_tensor(coo.cols).to(torch.int32)
    present = _diag_census(rows, cols, n_rows, n_cols)
    return (torch.nonzero(present)[:, 0].cpu().numpy().astype(np.int64)
            - (n_rows - 1))


def detect_dia(coo, max_bands: int = MAX_BANDS,
               max_bytes: int = MAX_BYTES):
    """Return the sorted offsets array if the DIA engine should run,
    else None.

    Refuses matrices carrying EXPLICIT ZERO entries: band stacks encode
    structure as value != 0, so an explicit zero would be dropped from the
    structural pattern."""
    offs = diag_offsets(coo)
    d = len(offs)
    if d == 0 or d > max_bands:
        return None
    n = coo.shape[0]
    sums = np.unique(offs[:, None] + offs[None, :])
    # A + B bands + C values + C counts, f32
    footprint = 4 * n * (2 * d + 2 * len(sums))
    if footprint > max_bytes:
        return None
    if bool((torch.as_tensor(coo.vals) == 0).any()):
        return None
    return offs
