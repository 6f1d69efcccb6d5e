"""The Tile16 bitmask-tiled sparse format.

Same logical content and the same flat int32/float arrays as the JAX
package's ``TiledMatrix``: per-tile 16-bit row bitmasks, tile-major
CSR-ordered values, packed intra-tile coordinates, a CSR over tiles.  Tile
arrays are padded to ``tile_cap``; element arrays have exact length nnz.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True, eq=False)
class TiledMatrix:
    """A sparse matrix in Tile16 form; every array field is a tensor on
    one device.

    Instances are immutable.  Derived conversion products (element_csr,
    macro, macro_stats, dense_flat, the binned chunk table, the binned plan)
    are cached on the instance via object.__setattr__ and never
    invalidated: to change values or structure, convert again from COO.
    """

    # --- per-tile arrays, padded to tile_cap ---
    tile_row: torch.Tensor   # (cap,) i32; padded entries = n_tile_rows
    tile_col: torch.Tensor   # (cap,) i32; padded entries = n_tile_cols
    ptr: torch.Tensor        # (cap+1,) i32 exclusive scan of per-tile nnz
    masks: torch.Tensor      # (cap, 16) i32 row bitmaps, bit j = col j

    # --- per-element arrays, tile-major CSR order, length nnz ---
    vals: torch.Tensor       # (nnz,) value dtype
    rowcol: torch.Tensor     # (nnz,) i32 packed (row<<4)|col in the tile
    elem_tile: torch.Tensor  # (nnz,) i32 owning tile index

    # --- high-level CSR over tiles ---
    tile_rowptr: torch.Tensor  # (n_tile_rows+1,) i32

    # --- optional: per-tile bit-transposed masks (built for B operands) ---
    tmasks: Optional[torch.Tensor]  # (cap, 16) i32 column bitmaps

    shape: tuple
    ntiles: int

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def tile_cap(self) -> int:
        return int(self.tile_row.shape[0])

    @property
    def n_tile_rows(self) -> int:
        return cdiv(self.shape[0], 16)

    @property
    def n_tile_cols(self) -> int:
        return cdiv(self.shape[1], 16)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to_coo_numpy(self):
        """Round-trip back to global COO triplets (host numpy)."""
        et = self.elem_tile.cpu().numpy()
        rc = self.rowcol.cpu().numpy()
        tr = self.tile_row.cpu().numpy()[et]
        tc = self.tile_col.cpu().numpy()[et]
        rows = tr * 16 + (rc >> 4)
        cols = tc * 16 + (rc & 15)
        return (rows.astype(np.int64), cols.astype(np.int64),
                self.vals.cpu().numpy())

    def element_coords(self):
        """Global (row, col) tensors of all elements."""
        from pem_spgemm_tpu_torch.ops.element import element_coords
        return element_coords(self.tile_row, self.tile_col, self.elem_tile,
                              self.rowcol)

    def element_csr(self):
        """Cached row-sorted element CSR (rowptr, rows, cols, vals)."""
        cached = getattr(self, "_ecsr_cache", None)
        if cached is None:
            from pem_spgemm_tpu_torch.ops.element import build_element_csr
            cached = build_element_csr(self.tile_row, self.tile_col,
                                       self.elem_tile, self.rowcol,
                                       self.vals, self.shape[0])
            object.__setattr__(self, "_ecsr_cache", cached)
        return cached

    def fill_ratio(self) -> float:
        """Mean nonzeros per occupied tile (engine-dispatch statistic)."""
        return self.nnz / max(1, self.ntiles)

    def macro_stats(self):
        """(occupied macro tiles, nnz per macro tile) without converting."""
        cached = getattr(self, "_macro_stats", None)
        if cached is None:
            tr = self.tile_row[:self.ntiles].cpu().numpy() >> 3
            tc = self.tile_col[:self.ntiles].cpu().numpy() >> 3
            nt = len(np.unique(tr.astype(np.int64) * (self.n_tile_cols + 1)
                               + tc))
            cached = (nt, self.nnz / max(1, nt))
            object.__setattr__(self, "_macro_stats", cached)
        return cached

    def macro(self):
        """Cached Macro128 (dense 128x128) form for the macro engine."""
        cached = getattr(self, "_macro_cache", None)
        if cached is None:
            from pem_spgemm_tpu_torch.ops.convert import tiled_to_macro
            cached = tiled_to_macro(self)
            object.__setattr__(self, "_macro_cache", cached)
        return cached

    def dense_flat(self) -> torch.Tensor:
        """Cached dense value tiles, (tile_cap + 1, 256): row t holds tile
        t's 16x16 values row-major, and row tile_cap is the all-zero tile
        that padding pairs index.  The same bytes as the JAX package's
        (tile_cap + 1, 2, 128), whose last two dims are a TPU lane layout.
        Part of the converted format, built once per matrix, like the JAX
        package's."""
        cached = getattr(self, "_dense_cache", None)
        if cached is None:
            from pem_spgemm_tpu_torch.ops.numeric import densify_tiles_flat
            cached = densify_tiles_flat(self.vals, self.rowcol,
                                        self.elem_tile, self.tile_cap)
            object.__setattr__(self, "_dense_cache", cached)
        return cached

    def intra_rowptr(self) -> torch.Tensor:
        """Per-tile intra-tile CSR row pointers, (cap, 17) i32, from the
        masks' popcounts (the reference stores them; here they are
        recomputed)."""
        from pem_spgemm_tpu_torch.ops.cstruct import cumsum16, popcount16
        return torch.nn.functional.pad(cumsum16(popcount16(self.masks)),
                                       (1, 0))
