"""C structure phase.  Only the tile-coordinate scatter of the Macro128
engine is ported so far; the mask algebra belongs to the Tile16 tier."""

from __future__ import annotations

import torch


def c_tile_coords(c_tile_id, c_row, c_col, c_cap: int, packed: bool = False):
    """Scatter per-pair C tile keys into dense (c_cap,) coordinate arrays.

    Rows of padding tiles carry the sentinel 0x7FFFFFFF; with packed=True
    (the caller guarantees row values < 2^15 and col values < 2^16) the
    sentinel is the per-field 0x7FFF / 0xFFFF, as in the JAX package, whose
    packed variant fuses the two scatters into one.  All pairs of a C tile
    scatter the same value, so any write order gives the same arrays.
    """
    valid = c_tile_id < c_cap
    cid = c_tile_id[valid].long()
    both = []
    for src in (c_row, c_col):
        out = torch.full((c_cap,), 0x7FFFFFFF, dtype=torch.int32,
                         device=c_tile_id.device)
        out[cid] = src[valid]
        both.append(out)
    c_tile_row, c_tile_col = both
    if packed:
        pad = c_tile_row == 0x7FFFFFFF
        c_tile_row = torch.where(pad, 0x7FFF, c_tile_row)
        c_tile_col = torch.where(pad, 0xFFFF, c_tile_col)
    return c_tile_row, c_tile_col
