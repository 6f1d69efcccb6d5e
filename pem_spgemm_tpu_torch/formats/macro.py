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

from pem_spgemm_tpu_torch.formats.coo import widened

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

    def acc_dense(self) -> torch.Tensor:
        """The tiles as the kernels take them: ``dense`` itself, or for
        bfloat16 tiles their float32 copy, made once and cached here
        (``formats.coo.widened``)."""
        return widened(self, "_acc_cache", self.dense)

    def tile_masks(self):
        """The k-masks of ``acc_dense()`` (``ops.macro_kernels.TableMasks``,
        made): made at first use and kept here, so that a steady multiply
        reads them and launches no masks entry.  Masks depend on the
        values, so they are never read stale: where the table changed in
        place since they were made (its version counter moved; a bfloat16
        operand's float32 copy is refreshed by ``acc_dense`` first), they
        are made again into the same words, which keep their address.  On
        CPU tables they hold ``tile_masks_plain``'s words, which no plain
        version reads."""
        from pem_spgemm_tpu_torch.ops.macro_kernels import TableMasks
        table = self.acc_dense()
        held = getattr(self, "_masks_cache", None)
        if held is None or held[0] is not table:
            held = [table, table._version, TableMasks(table).make()]
            object.__setattr__(self, "_masks_cache", held)
        elif held[1] != table._version:
            held[2].make()
            held[1] = table._version
        return held[2]


def macro_operands(a, b):
    """(A, B) as MacroMatrix: operands that are not already (Tile16
    matrices) give their cached Macro128 form; B is A's when it is A."""
    am = a if isinstance(a, MacroMatrix) else a.macro()
    bm = am if b is a else (b if isinstance(b, MacroMatrix) else b.macro())
    return am, bm
