"""Macro128: the dense 128x128 macro-tile format.

Counterpart of the JAX package's formats/macro.py.  For matrices whose
occupied 128x128 blocks are reasonably filled (stencils, banded systems,
block-dense graphs) the numeric phase runs as dense 128x128 tile products:
operand gathers move whole 64 KB tiles, and the exact structural pattern
falls out of the 0/1 product of the same tiles.
"""

from __future__ import annotations

import dataclasses

import torch

TILE = 128


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True, eq=False)
class MacroMatrix:
    """A sparse matrix as dense 128x128 macro tiles (only occupied ones);
    every array field is a tensor on one device.

    Arrays are padded to ``tile_cap`` (= len(tile_row)); ``dense`` has one
    extra all-zero tile at index tile_cap for padding pairs.
    """

    tile_row: torch.Tensor      # (cap,) i32; padding = n_macro_rows
    tile_col: torch.Tensor      # (cap,) i32; padding = n_macro_cols
    tile_rowptr: torch.Tensor   # (n_macro_rows+1,) i32 CSR over macro tiles
    dense: torch.Tensor         # (cap+1, 128, 128) value dtype
    shape: tuple
    ntiles: int
    nnz: int

    @property
    def tile_cap(self) -> int:
        return int(self.tile_row.shape[0])

    @property
    def n_macro_rows(self) -> int:
        return cdiv(self.shape[0], TILE)

    @property
    def n_macro_cols(self) -> int:
        return cdiv(self.shape[1], TILE)

    @property
    def device(self) -> torch.device:
        return self.dense.device

    def fill_ratio(self) -> float:
        """Mean nonzeros per occupied macro tile (dispatch statistic)."""
        return self.nnz / max(1, self.ntiles)


def macro_operands(a, b):
    """(A, B) as MacroMatrix: operands that are not already (Tile16
    matrices) give their cached Macro128 form; B is A's when it is A."""
    am = a if isinstance(a, MacroMatrix) else a.macro()
    bm = am if b is a else (b if isinstance(b, MacroMatrix) else b.macro())
    return am, bm
