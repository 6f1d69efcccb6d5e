"""Symbolic phase: tile-pair generation + C tile structure.

Counterpart of the JAX package's ops/symbolic.py.  Pairs are generated by
joining A's tiles against B's tile-row CSR and sorted by C tile key, so the
pairs of one C tile are contiguous.

Shape protocol: ``pair_counts`` gives the total pair count P (one
device-to-host copy); ``expand_pairs`` then runs at a capacity p_cap >= P.
Padding pairs carry INT32_MAX keys, so they land at the end of the sorted
stream, and point at the all-zero tile appended to the operand tables.
The sorts are stable, as the reference's are: the streams equal the JAX
package's element by element.
"""

from __future__ import annotations

import torch

from pem_spgemm_tpu_torch.ops import scanops

INT32_MAX = 0x7FFFFFFF


def pair_counts(a_tile_col, b_tile_rowptr, ntiles_a: int):
    """Per-A-tile pair counts and their exclusive scan.

    a_tile_col: (capA,) i32 — A tiles' column index = B tile-row to join.
    b_tile_rowptr: (n_tile_rows_B + 1,) i32.
    ntiles_a: true A tile count (capA - ntiles_a entries are padding).

    Returns offsets (capA+1,) i32; offsets[-1] is the total pair count P.
    """
    cap = a_tile_col.shape[0]
    dev = a_tile_col.device
    valid = torch.arange(cap, dtype=torch.int32, device=dev) < ntiles_a
    k = torch.where(valid, a_tile_col, 0).long()
    cnt = torch.where(valid, b_tile_rowptr[k + 1] - b_tile_rowptr[k], 0)
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(cnt, 0, dtype=torch.int32)])


def expand_pairs(offsets, a_tile_row, a_tile_col, b_tile_rowptr, b_tile_col,
                 n_pairs, p_cap: int, packed: bool = False):
    """Materialize all (A tile, B tile) products, sorted by C tile key.

    n_pairs is an int or a device scalar; nothing is copied between the
    host and the device.
    Returns (c_row, c_col, a_idx, b_idx, c_tile_id, cnt_c):
      c_row/c_col: (p_cap,) i32 C tile coordinates (padding sorts last);
      a_idx/b_idx: (p_cap,) i32 operand tile indices;
      c_tile_id:   (p_cap,) i32 dense C tile rank (pairs of one C tile are
                   contiguous); padding pairs get INT32_MAX;
      cnt_c:       device scalar i32 — number of distinct C tiles.

    packed=True (valid when both tile-grid dims are < 2^16, see
    scanops.can_pack) sorts one packed int32 key.
    """
    dev = offsets.device
    i32 = torch.int32
    p = torch.arange(p_cap, dtype=i32, device=dev)
    valid = p < n_pairs
    a_idx = scanops.segment_ids_from_offsets(offsets, p_cap)
    a_idx = a_idx.clamp(0, offsets.shape[0] - 2)
    al = a_idx.long()
    k = a_tile_col[al].long()
    b_idx = b_tile_rowptr[k.clamp(0, b_tile_rowptr.shape[0] - 2)] \
        + (p - offsets[al])
    b_idx = b_idx.clamp(0, b_tile_col.shape[0] - 1)
    c_row = a_tile_row[al]
    c_col = b_tile_col[b_idx.long()]
    # padding pairs target the all-zero tile appended to the dense tables
    a_idx = torch.where(valid, a_idx, a_tile_row.shape[0]).to(i32)
    b_idx = torch.where(valid, b_idx, b_tile_col.shape[0]).to(i32)
    one = torch.ones(1, dtype=i32, device=dev)
    if packed:
        key = torch.where(valid, scanops.pack_key(c_row, c_col), INT32_MAX)
        key, order = torch.sort(key, stable=True)
        a_idx, b_idx = a_idx[order], b_idx[order]
        c_row, c_col = scanops.unpack_key(key)
        new_tile = torch.cat([one, (key[1:] != key[:-1]).to(i32)])
    else:
        c_row = torch.where(valid, c_row, INT32_MAX)
        c_col = torch.where(valid, c_col, INT32_MAX)
        order = torch.sort((c_row.long() << 32) | c_col.long(),
                           stable=True).indices
        c_row, c_col = c_row[order], c_col[order]
        a_idx, b_idx = a_idx[order], b_idx[order]
        new_tile = torch.cat([
            one, ((c_row[1:] != c_row[:-1])
                  | (c_col[1:] != c_col[:-1])).to(i32)])
    c_tile_id = torch.cumsum(new_tile, 0, dtype=i32) - 1
    # the valid pairs sort first: the tiles they start are the C tiles
    # (counted on the device: no host copy, whatever n_pairs is)
    cnt_c = (new_tile.bool() & valid).sum(dtype=i32)
    c_tile_id = torch.where(valid, c_tile_id, INT32_MAX)
    return c_row, c_col, a_idx, b_idx, c_tile_id, cnt_c
