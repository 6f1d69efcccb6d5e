"""COO -> Tile16 and COO -> Macro128 conversion on the device.

One stable sort on a composite (tile_row, tile_col, intra-coord) key puts
the elements into tile-major intra-tile CSR order; the tile census, the
per-tile nnz and the masks are scatter-adds over the sorted stream; the
16x16 bitmask transpose is a butterfly network of vector bit-ops over all
tiles at once.  The tile count crosses to the host once, and tile arrays
are padded to a power-of-two bucket (config.round_up_bucket).
"""

from __future__ import annotations

import torch

from pem_spgemm_tpu_torch.config import resolve_device, round_up_bucket
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.formats.tiled import TiledMatrix, cdiv


def _sort_phase(rows, cols, vals):
    """Sort elements into tile-major intra-tile CSR order; label tiles.

    Returns sorted (tile_row, tile_col, intra, vals, tile_id), the tile
    count and the duplicate-coordinate count as device scalars.  The
    three sort keys pack into one int64 (27 + 27 + 8 bits).
    """
    tr = rows >> 4
    tc = cols >> 4
    intra = ((rows & 15) << 4) | (cols & 15)
    key = (tr.long() << 35) | (tc.long() << 8) | intra.long()
    order = torch.sort(key, stable=True).indices
    tr, tc, intra, vals = tr[order], tc[order], intra[order], vals[order]
    same_tile = (tr[1:] == tr[:-1]) & (tc[1:] == tc[:-1])
    new_tile = torch.cat([
        torch.ones(1, dtype=torch.int32, device=rows.device),
        (~same_tile).to(torch.int32)])
    tile_id = torch.cumsum(new_tile, 0, dtype=torch.int32) - 1
    cnt = tile_id[-1] + 1
    # Duplicate coordinates would double-add mask bits; they are adjacent
    # after the sort, so the caller can fail fast.
    n_dup = (same_tile & (intra[1:] == intra[:-1])).sum()
    return tr, tc, intra, vals, tile_id, cnt, n_dup


def _build_phase(tr, tc, intra, tile_id, tile_cap, n_tile_rows,
                 n_tile_cols):
    """Census + masks + high-level CSR at a fixed tile capacity."""
    dev = tr.device
    tid = tile_id.long()
    per_tile = torch.bincount(tid, minlength=tile_cap)
    ptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                     torch.cumsum(per_tile, 0, dtype=torch.int32)])
    # All elements of a tile scatter the same value: any write order is fine.
    tile_row = torch.full((tile_cap,), n_tile_rows, dtype=torch.int32,
                          device=dev)
    tile_row[tid] = tr
    tile_col = torch.full((tile_cap,), n_tile_cols, dtype=torch.int32,
                          device=dev)
    tile_col[tid] = tc
    # Row bitmaps: one scatter-add of single-bit integers per element.
    seg = tid * 16 + (intra >> 4)
    bit = torch.ones_like(intra) << (intra & 15)
    masks = torch.zeros(tile_cap * 16, dtype=torch.int32, device=dev)
    masks.index_add_(0, seg, bit)
    masks = masks.reshape(tile_cap, 16)
    # High-level CSR over tiles (tiles are sorted by row-major tile key).
    counts = torch.bincount(tile_row, minlength=n_tile_rows + 1)[:n_tile_rows]
    tile_rowptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                             torch.cumsum(counts, 0, dtype=torch.int32)])
    return tile_row, tile_col, ptr, masks, tile_rowptr


def transpose_masks(masks):
    """Bit-transpose every 16x16 tile bitmask: out[:, c] bit r = in[:, r] bit c.

    Butterfly (Hacker's-Delight-style) 16x16 bit-matrix transpose,
    vectorized across all tiles.
    """
    a = [masks[:, r] for r in range(16)]
    j, m = 8, 0x00FF
    while j != 0:
        k = 0
        while k < 16:
            t = ((a[k] >> j) ^ a[k + j]) & m
            a[k + j] = a[k + j] ^ t
            a[k] = a[k] ^ (t << j)
            k = (k + j + 1) & ~j
        j >>= 1
        m = m ^ (m << j) if j else m
    return torch.stack(a, dim=1)


def coo_to_tiled(coo: COOMatrix, dtype=torch.float32,
                 with_tmasks: bool = False, tile_cap: int | None = None,
                 device=None) -> TiledMatrix:
    """Convert COO triplets to a TiledMatrix on ``device``.

    ``device=None`` means the GPU (see config.resolve_device); triplets
    that are already tensors stay on their own device.  Requires canonical
    COO (no duplicate coordinates); use COOMatrix.sum_duplicates() first
    if unsure.
    """
    if coo.nnz == 0:
        raise ValueError("empty matrix")
    if isinstance(coo.rows, torch.Tensor):
        dev = coo.rows.device if device is None else torch.device(device)
    else:
        dev = resolve_device(device)
    n_tile_rows = cdiv(coo.shape[0], 16)
    n_tile_cols = cdiv(coo.shape[1], 16)
    rows = torch.as_tensor(coo.rows).to(device=dev, dtype=torch.int32)
    cols = torch.as_tensor(coo.cols).to(device=dev, dtype=torch.int32)
    vals = torch.as_tensor(coo.vals).to(device=dev, dtype=dtype)
    tr, tc, intra, vals_s, tile_id, cnt, n_dup = _sort_phase(rows, cols, vals)
    ntiles, n_dup = (int(x) for x in torch.stack([cnt, n_dup]).tolist())
    if n_dup:
        raise ValueError(
            f"{n_dup} duplicate coordinates; the bitmask tile format "
            "requires canonical COO — call COOMatrix.sum_duplicates() first")
    cap = tile_cap if tile_cap is not None else round_up_bucket(ntiles)
    if cap < ntiles:
        raise ValueError(f"tile_cap {cap} is below the tile count {ntiles}")
    tile_row, tile_col, ptr, masks, tile_rowptr = _build_phase(
        tr, tc, intra, tile_id, cap, n_tile_rows, n_tile_cols)
    tmasks = transpose_masks(masks) if with_tmasks else None
    return TiledMatrix(
        tile_row=tile_row, tile_col=tile_col, ptr=ptr, masks=masks,
        vals=vals_s, rowcol=intra, elem_tile=tile_id,
        tile_rowptr=tile_rowptr, tmasks=tmasks,
        shape=tuple(coo.shape), ntiles=ntiles)


# --------------------------------------------------------------------------
# COO -> Macro128

def _macro_sort_phase(rows, cols, vals):
    """Sort elements into macro-tile-major order (tile key, then the
    intra-tile coordinate) with one stable sort on a composite int64 key."""
    from pem_spgemm_tpu_torch.ops.scanops import pack_key
    tr = rows >> 7
    tc = cols >> 7
    intra = ((rows & 127) << 7) | (cols & 127)
    key = pack_key(tr, tc)
    order = torch.sort((key.long() << 14) | intra.long(),
                       stable=True).indices
    key, intra, vals = key[order], intra[order], vals[order]
    same_tile = key[1:] == key[:-1]
    new_tile = torch.cat([
        torch.ones(1, dtype=torch.int32, device=rows.device),
        (~same_tile).to(torch.int32)])
    tile_id = torch.cumsum(new_tile, 0, dtype=torch.int32) - 1
    cnt = tile_id[-1] + 1
    # Duplicate coordinates would silently last-write-win in the dense
    # scatter; they are adjacent after the sort, so the caller fails fast.
    n_dup = (same_tile & (intra[1:] == intra[:-1])).sum()
    return key, intra, vals, tile_id, cnt, n_dup


def _macro_build_phase(key, intra, vals, tile_id, tile_cap, n_macro_rows,
                       n_macro_cols):
    from pem_spgemm_tpu_torch.ops.scanops import unpack_key
    dev = key.device
    tr, tc = unpack_key(key)
    tid = tile_id.long()
    tile_row = torch.full((tile_cap,), n_macro_rows, dtype=torch.int32,
                          device=dev)
    tile_row[tid] = tr
    tile_col = torch.full((tile_cap,), n_macro_cols, dtype=torch.int32,
                          device=dev)
    tile_col[tid] = tc
    # 64-bit positions: tile_cap * 16384 passes 2^31 from 131,072 tiles on.
    # The reserved all-zero padding tile sits at index tile_cap.
    dense = torch.zeros((tile_cap + 1) * 128 * 128, dtype=vals.dtype,
                        device=dev)
    dense[tid * (128 * 128) + intra.long()] = vals
    counts = torch.bincount(tile_row, minlength=n_macro_rows + 1)
    tile_rowptr = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.cumsum(counts[:n_macro_rows], 0, dtype=torch.int32)])
    return (tile_row, tile_col, tile_rowptr,
            dense.reshape(tile_cap + 1, 128, 128))


def _macro_from_triplets(rows, cols, vals, shape, nnz, tile_cap,
                         check_dup):
    from pem_spgemm_tpu_torch.formats.macro import MacroMatrix
    from pem_spgemm_tpu_torch.ops.scanops import can_pack
    n_mr = cdiv(shape[0], 128)
    n_mc = cdiv(shape[1], 128)
    if not can_pack(n_mr, n_mc):
        raise ValueError(f"macro grid {n_mr}x{n_mc} exceeds packed-key "
                         "range (matrix > ~8.4M rows/cols)")
    key, intra, vals_s, tile_id, cnt, n_dup = _macro_sort_phase(
        rows, cols, vals)
    ntiles, n_dup = (int(x) for x in torch.stack([cnt, n_dup]).tolist())
    if check_dup and n_dup:
        raise ValueError(
            f"{n_dup} duplicate coordinates; the dense macro format "
            "requires canonical COO — call COOMatrix.sum_duplicates() first")
    cap = tile_cap if tile_cap is not None else round_up_bucket(ntiles)
    if cap < ntiles:
        raise ValueError(f"tile_cap {cap} is below the tile count {ntiles}")
    tile_row, tile_col, tile_rowptr, dense = _macro_build_phase(
        key, intra, vals_s, tile_id, cap, n_mr, n_mc)
    return MacroMatrix(tile_row=tile_row, tile_col=tile_col,
                       tile_rowptr=tile_rowptr, dense=dense,
                       shape=tuple(shape), ntiles=ntiles, nnz=nnz)


def coo_to_macro(coo: COOMatrix, dtype=torch.float32,
                 tile_cap: int | None = None, device=None):
    """Convert COO triplets to the dense 128x128 macro-tile format on
    ``device`` (``None``: the GPU; tensor triplets stay on their device)."""
    if coo.nnz == 0:
        raise ValueError("empty matrix")
    if isinstance(coo.rows, torch.Tensor):
        dev = coo.rows.device if device is None else torch.device(device)
    else:
        dev = resolve_device(device)
    rows = torch.as_tensor(coo.rows).to(device=dev, dtype=torch.int32)
    cols = torch.as_tensor(coo.cols).to(device=dev, dtype=torch.int32)
    vals = torch.as_tensor(coo.vals).to(device=dev, dtype=dtype)
    return _macro_from_triplets(rows, cols, vals, coo.shape, coo.nnz,
                                tile_cap, check_dup=True)


def tiled_to_macro(t: TiledMatrix, tile_cap: int | None = None):
    """Build the macro form from an existing Tile16 matrix (no COO reread);
    t is canonical by construction."""
    rows, cols = t.element_coords()
    return _macro_from_triplets(rows, cols, t.vals, t.shape, t.nnz,
                                tile_cap, check_dup=False)
