"""Numeric phase of the Tile16 engines: per-C-tile accumulation.

Counterpart of the JAX package's ops/numeric.py (the reference's step 3):

  * operand tiles are densified once into (tiles, 256) value rows (a single
    scatter: the tile-major element order makes the index just
    elem_tile * 256 + rowcol);
  * each C tile sums the 16x16 products A_tile @ B_tile of its pairs, and
    the fused engine also the 0/1 pattern's products (the structural
    counts);
  * compressed C values are gathered with the structure of the cstruct
    phase.

On the card the accumulation is one hand-written kernel
(``ops.tile16_kernels``, csrc/tile16_accumulate.cu; the JAX package runs
its einsum and scatter-add in XLA, outside any Pallas kernel): one warp a
C tile walks the tile's pairs in stream order and writes the tile once, so
no atomics and the same bits at every launch.  ``accumulate_fused_flat``
and ``accumulate_dense`` dispatch by the tensors' device: CUDA tensors
launch the kernel, CPU tensors take the plain versions here
(``fused_flat_plain``, ``dense_plain``: batched ``torch.bmm`` over chunks of
gathered tiles and ``index_add_``, sequential on the CPU).  Values match
the JAX package within the float32 dot-product bound; the 0/1 pattern
counts are integers below 2^24 in float32, exact in any order, so the
structure is equal bit for bit.  Padding pairs target C tile c_cap or
above: the plain versions drop them into one extra row, the kernel never
reads them.

Products run in full float32 (``macro.require_full_fp32``): never TF32.
``precision`` "high" or "default" rounds the float32 operand tables to
tf32 or bfloat16 once a call (``macro.round_operands``) before those
float32 products, where the JAX package hands the precision to its einsum;
the 0/1 pattern is taken from the raw tables.
"""

from __future__ import annotations

import torch

from pem_spgemm_tpu_torch.config import precision_code
from pem_spgemm_tpu_torch.ops.macro import require_full_fp32, round_operands


def _densify(vals, rowcol, elem_tile, rows: int):
    """(rows * 256,) zeros with vals scattered to elem_tile*256 + rowcol;
    positions past the end are dropped (into one extra slot)."""
    n = rows * 256
    pos = elem_tile.long() * 256 + rowcol.long()
    pos = torch.where(pos < n, pos, n)
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    out[pos] = vals
    return out[:n]


def densify_tiles(vals, rowcol, elem_tile, tile_cap: int):
    """Scatter tile-major element values into dense (tile_cap, 16, 16)."""
    return _densify(vals, rowcol, elem_tile, tile_cap).reshape(
        tile_cap, 16, 16)


def densify_tiles_flat(vals, rowcol, elem_tile, tile_cap: int):
    """Dense value tiles, (tile_cap + 1, 256); row tile_cap is the all-zero
    tile that padding pairs index.  The JAX package's layout is
    (tile_cap + 1, 2, 128): the same bytes."""
    return _densify(vals, rowcol, elem_tile, tile_cap + 1).reshape(
        tile_cap + 1, 256)


def _check_precision(precision: str) -> None:
    precision_code(precision)
    require_full_fp32()


def _rounded(table, acc_dtype, precision: str):
    """A float32 operand table rounded as ``precision`` says, where the
    products are float32; else the table itself (at "highest", for float64
    products, and for bfloat16 values, which both roundings keep), so those
    paths are unchanged."""
    if acc_dtype != torch.float32:
        return table
    return round_operands(table, precision)


def fused_flat_plain(a_flat, b_flat, a_idx, b_idx, c_tile_id, c_cap: int,
                     chunk: int, acc_dtype=torch.float32,
                     precision: str = "highest"):
    """The plain version of ``accumulate_fused_flat`` (CPU tensors).

    Per chunk of pairs: gather both operand tiles, cast them to acc_dtype
    (bf16 operands too), take one batched 16x16 product of the values and
    one of the 0/1 patterns (in float32: the counts stay exact integers),
    and add both into the C tiles.  Values are read from the tables rounded
    as ``precision`` says (once a call), the patterns from the raw tables.
    """
    _check_precision(precision)
    p_cap = a_idx.shape[0]
    assert p_cap % chunk == 0, (p_cap, chunk)
    dev = a_flat.device
    a_val = _rounded(a_flat, acc_dtype, precision)
    b_val = a_val if b_flat is a_flat else _rounded(b_flat, acc_dtype,
                                                    precision)
    seg = c_tile_id.clamp(max=c_cap).long()
    c_dense = torch.zeros((c_cap + 1, 256), dtype=acc_dtype, device=dev)
    c_cnt = torch.zeros((c_cap + 1, 256), dtype=torch.float32, device=dev)
    for sl in range(0, p_cap, chunk):
        s_c = seg[sl:sl + chunk]
        ai = a_idx[sl:sl + chunk].long()
        bi = b_idx[sl:sl + chunk].long()
        ad = a_flat[ai].view(-1, 16, 16).to(acc_dtype)
        bd = b_flat[bi].view(-1, 16, 16).to(acc_dtype)
        av = ad if a_val is a_flat else a_val[ai].view(-1, 16, 16)
        bv = bd if b_val is b_flat else b_val[bi].view(-1, 16, 16)
        c_dense.index_add_(0, s_c, torch.bmm(av, bv).view(-1, 256))
        c_cnt.index_add_(0, s_c, torch.bmm(
            (ad != 0).to(torch.float32),
            (bd != 0).to(torch.float32)).view(-1, 256))
    return c_dense[:c_cap], c_cnt[:c_cap]


def dense_plain(a_dense, b_dense, a_idx, b_idx, c_tile_id, c_cap: int,
                chunk: int, acc_dtype=torch.float32,
                precision: str = "highest", out=None):
    """The plain version of ``accumulate_dense`` (CPU tensors).

    Operand indices are clamped in range (padding pairs' products land in
    the dropped row c_cap).  ``out=c``: the stage partial is added to
    ``c`` as ``old + partial`` on the tiles the stream has pairs for, the
    kernel's association; the other tiles are left bit for bit.
    """
    _check_precision(precision)
    same = b_dense is a_dense
    a_dense = _rounded(a_dense, acc_dtype, precision)
    b_dense = a_dense if same else _rounded(b_dense, acc_dtype, precision)
    p_cap = a_idx.shape[0]
    assert p_cap % chunk == 0, (p_cap, chunk)
    seg = c_tile_id.clamp(max=c_cap).long()
    a_i = a_idx.long().clamp(max=a_dense.shape[0] - 1)
    b_i = b_idx.long().clamp(max=b_dense.shape[0] - 1)
    c_dense = torch.zeros((c_cap + 1, 16, 16), dtype=acc_dtype,
                          device=a_dense.device)
    for sl in range(0, p_cap, chunk):
        ad = a_dense[a_i[sl:sl + chunk]].to(acc_dtype)
        bd = b_dense[b_i[sl:sl + chunk]].to(acc_dtype)
        c_dense.index_add_(0, seg[sl:sl + chunk], torch.bmm(ad, bd))
    if out is None:
        return c_dense[:c_cap]
    live = torch.unique(seg[seg < c_cap])
    out[live] = out[live] + c_dense[live]
    return out


def accumulate_fused_flat(a_flat, b_flat, a_idx, b_idx, c_tile_id,
                          c_cap: int, chunk: int, acc_dtype=torch.float32,
                          precision: str = "highest"):
    """Fused numeric + structural accumulation on flat operand tables.

    a_flat / b_flat: (T+1, 256) value tables (zero tile at T); a_idx, b_idx,
    c_tile_id: (p_cap,) i32, c_tile_id ascending (p_cap a multiple of chunk
    for the plain version).  Values are products of the tables rounded as
    ``precision`` says, the counts those of the raw tables' 0/1 pattern.
    Returns (c_dense (c_cap, 256) acc_dtype, c_counts (c_cap, 256)
    float32).  CUDA tensors: the Tile16 kernel's fresh form with counts;
    CPU tensors: ``fused_flat_plain``.
    """
    from pem_spgemm_tpu_torch.ops import tile16_kernels
    return tile16_kernels.accumulate_fused_flat(
        a_flat, b_flat, a_idx, b_idx, c_tile_id, c_cap, chunk, acc_dtype,
        precision)


def accumulate_dense(a_dense, b_dense, a_idx, b_idx, c_tile_id, c_cap: int,
                     chunk: int, acc_dtype=torch.float32,
                     precision: str = "highest", out=None):
    """C_dense[t] = sum over pairs p of tile t: A[a_idx[p]] @ B[b_idx[p]].

    a_dense / b_dense: (T, 16, 16) with no zero tile.  Values are read from
    the tables rounded as ``precision`` says (once a call).  Returns
    (c_cap, 16, 16) acc_dtype.  ``out=c`` adds the products into ``c``
    instead (old + partial on the tiles with pairs, the others untouched)
    and returns it.  CUDA tensors: the Tile16 kernel's fresh values-only
    form, or its accumulate form; CPU tensors: ``dense_plain``.
    """
    from pem_spgemm_tpu_torch.ops import tile16_kernels
    return tile16_kernels.accumulate_dense(
        a_dense, b_dense, a_idx, b_idx, c_tile_id, c_cap, chunk, acc_dtype,
        precision, out)


def counts_to_masks(c_counts):
    """Pack the structural counts into per-tile row bitmasks + nnz scan.

    c_counts: (c_cap, 16, 16) (or (c_cap, 256)).  Returns (cmask (c_cap, 16)
    i32, cptr (c_cap+1,) i32)."""
    from pem_spgemm_tpu_torch.ops.cstruct import _exclusive_scan, popcount16
    c_cap = c_counts.shape[0]
    nz = (c_counts.reshape(c_cap * 16, 16) > 0).to(torch.float32)
    # each row's 16 bits as one product with the powers of two: 0/1 times
    # 2^c, summed below 2^16, exact in any float32 matmul mode
    weights = torch.pow(2.0, torch.arange(16, dtype=torch.float32,
                                          device=nz.device))
    cmask = (nz @ weights).to(torch.int32).reshape(c_cap, 16)
    return cmask, _exclusive_scan(popcount16(cmask).sum(1, dtype=torch.int32))


def extract_values(c_dense, c_rowcol, c_elem_tile):
    """Gather compressed tile-major C values from the dense C tiles."""
    flat = c_dense.reshape(-1)
    pos = (c_elem_tile.long() * 256 + c_rowcol.long()).clamp(
        max=flat.shape[0] - 1)
    return flat[pos]
