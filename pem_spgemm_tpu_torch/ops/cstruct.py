"""C structure phase: tile masks, exact per-tile nnz, intra-tile coordinates.

Counterpart of the JAX package's ops/cstruct.py (the reference's steps 2b
and 2c):
  * ``c_masks``: per pair, C row-mask bit c is set iff (A row bitmap AND B
    transposed column-c bitmap) is nonzero; OR-accumulated over the pairs
    of each C tile (pairs of a C tile are contiguous after the symbolic
    sort); popcounts give the exact per-tile nnz and its exclusive scan the
    total C nnz;
  * ``c_rowcol`` (and ``c_rowcol_values``, with the compressed values of
    ``numeric.extract_values``): C's set bits enumerated in tile-major,
    row-major order;
  * ``c_tile_coords``: the per-pair C tile keys scattered to (c_cap,) arrays.

On the card ``c_masks`` and ``c_rowcol`` / ``c_rowcol_values`` are
hand-written kernels (``ops.tile16_kernels``, csrc/tile16_structure.cu: a
half-warp a C tile, no atomics; the JAX package runs this phase in XLA):
``tile16_c_masks`` ORs a tile's pairs in stream order, and the tiles'
pair offsets are ``macro_kernels.segment_offsets`` of the sorted stream;
``tile16_c_rowcol`` scans a tile's row popcounts and writes each row's
set bits.  CPU tensors take the plain versions here (``c_masks_plain``:
16 bit-plane segmented maxima; ``c_rowcol_plain``: a gather per output
slot, its tile row from the nnz scan at row granularity and its column by
a bit-rank select from a table); dispatch is by the tensors' device.
``c_tile_coords`` is torch ops on both.

Nothing here copies to the host: the steady Tile16 step (ops/fixed.py) is
captured as one CUDA graph.  Scatters that drop a padding entry write it to
one extra slot instead, sliced off after.
"""

from __future__ import annotations

import torch

from pem_spgemm_tpu_torch.ops import scanops

_SENT = 0x7FFFFFFF


def popcount16(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 entry, for entries in [0, 2^16) (the Tile16
    row and column bitmaps): a SWAR count in int32 (torch has no popcount).
    The sign bit never takes part, so the arithmetic shifts are exact."""
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def cumsum16(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along the last dim (16 wide) of an int32 tensor, in
    four shifted adds: torch.cumsum over a short innermost dim runs one
    slow scan kernel (5.4 ms over pairbands-500k's C tiles on an H100)."""
    for sh in (1, 2, 4, 8):
        x = x + torch.nn.functional.pad(x[..., :-sh], (sh, 0))
    return x


# the column of the k-th set bit of every 16-bit mask, by device
_SELECT: dict = {}


def select16(m: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Column of the k-th set bit (k from 0) of each 16-bit mask m; 0 where
    m has k or fewer set bits or k is out of [0, 16).  One gather from a
    (65536 * 16,) table made once a device from device ops, at the first
    call (``c_rowcol_plain``'s: the CPU's; the card enumerates C's bits in
    the kernel and never builds it).  The JAX package selects with a
    16-step loop over the bits; the results are equal."""
    dev = m.device
    table = _SELECT.get(dev)
    if table is None:
        every = torch.arange(1 << 16, dtype=torch.int32, device=dev)[:, None]
        c = torch.arange(16, dtype=torch.int32, device=dev)
        bits = (every >> c) & 1
        slot = torch.where(bits == 1, every * 16 + cumsum16(bits) - 1,
                           16 << 16)
        table = torch.zeros((16 << 16) + 1, dtype=torch.int32, device=dev)
        table[slot.reshape(-1).long()] = c.expand(1 << 16, 16).reshape(-1)
        table = _SELECT[dev] = table[:16 << 16]
    ok = (k >= 0) & (k < 16)
    return torch.where(ok, table[(m * 16 + k.clamp(0, 15)).long()], 0)


def _scatter_drop(c_cap: int, idx, src, fill: int):
    """out = full(c_cap, fill); out[idx] = src, with idx == c_cap dropped.
    Every writer of one slot writes the same value, so any order gives the
    same array."""
    out = torch.full((c_cap + 1,), fill, dtype=torch.int32, device=idx.device)
    out[idx.long()] = src.to(torch.int32)
    return out[:c_cap]


def c_tile_coords(c_tile_id, c_row, c_col, c_cap: int, packed: bool = False):
    """Scatter per-pair C tile keys into dense (c_cap,) coordinate arrays.

    Rows of padding tiles carry the sentinel 0x7FFFFFFF; with packed=True
    (the caller guarantees row values < 2^15 and col values < 2^16) the
    sentinel is the per-field 0x7FFF / 0xFFFF, as in the JAX package, whose
    packed variant fuses the two scatters into one.
    """
    cid = torch.where(c_tile_id < c_cap, c_tile_id, c_cap)
    c_tile_row = _scatter_drop(c_cap, cid, c_row, _SENT)
    c_tile_col = _scatter_drop(c_cap, cid, c_col, _SENT)
    if packed:
        pad = c_tile_row == _SENT
        c_tile_row = torch.where(pad, 0x7FFF, c_tile_row)
        c_tile_col = torch.where(pad, 0xFFFF, c_tile_col)
    return c_tile_row, c_tile_col


def _exclusive_scan(x):
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=x.device),
                      torch.cumsum(x, 0, dtype=torch.int32)])


def c_masks(a_masks, b_tmasks, a_idx, b_idx, c_tile_id, c_row, c_col,
            c_cap: int):
    """Per-C-tile bitmasks and exact nnz counts of a pair stream sorted by
    C tile (``c_tile_id`` ascending, padding at c_cap or above).

    Returns (c_tile_row, c_tile_col, cmask, cptr, pair_ptr):
      c_tile_row/col: (c_cap,) i32 (sentinel INT32_MAX on padding);
      cmask: (c_cap, 16) i32 row bitmaps of C tiles;
      cptr:  (c_cap+1,) i32 exclusive scan of per-tile nnz (cptr[-1] = C_nnz);
      pair_ptr: (c_cap+1,) i32 exclusive scan of per-tile pair counts.
    CUDA tensors: the kernel ``tile16_c_masks`` (pair_ptr is
    ``segment_offsets`` of the stream, which equals the scan for a sorted
    stream); CPU tensors: ``c_masks_plain``.
    """
    if not a_idx.is_cuda:
        return c_masks_plain(a_masks, b_tmasks, a_idx, b_idx, c_tile_id,
                             c_row, c_col, c_cap)
    from pem_spgemm_tpu_torch.ops import tile16_kernels
    c_tile_row, c_tile_col = c_tile_coords(c_tile_id, c_row, c_col, c_cap)
    cmask, cptr, pair_ptr = tile16_kernels.c_masks(
        a_masks, b_tmasks, a_idx, b_idx, c_tile_id, c_cap)
    return c_tile_row, c_tile_col, cmask, cptr, pair_ptr


def c_masks_plain(a_masks, b_tmasks, a_idx, b_idx, c_tile_id, c_row, c_col,
                  c_cap: int):
    """The plain version of ``c_masks`` (CPU tensors), the JAX package's
    algorithm: the structural product of every pair as one vector
    expression, then 16 bit-plane segmented maxima.  Padding pairs index
    one past the operands' tiles; they are clamped in range, their bits
    zeroed and their tile clamped to c_cap - 1, where a zero changes
    neither a count nor a maximum.
    """
    valid = c_tile_id < c_cap
    cid_seg = torch.where(valid, c_tile_id, c_cap).clamp(max=c_cap - 1).long()
    c_tile_row, c_tile_col = c_tile_coords(c_tile_id, c_row, c_col, c_cap)

    pairs_per_tile = torch.zeros(c_cap, dtype=torch.int32,
                                 device=a_idx.device)
    pairs_per_tile.index_add_(0, cid_seg, valid.to(torch.int32))
    pair_ptr = _exclusive_scan(pairs_per_tile)

    am = a_masks[a_idx.long().clamp(max=a_masks.shape[0] - 1)]
    bt = b_tmasks[b_idx.long().clamp(max=b_tmasks.shape[0] - 1)]
    # packed[p, r] bit c == (am[p, r] & bt[p, c]) != 0
    packed = torch.zeros_like(am)
    for c in range(16):
        hit = (am & bt[:, c:c + 1]) != 0
        packed |= hit.to(torch.int32) << c
    packed = torch.where(valid[:, None], packed, 0)
    del am, bt

    # segmented OR: 16 bit-plane segmented maxima from zeros
    seg = cid_seg[:, None].expand(-1, 16)
    cmask = torch.zeros((c_cap, 16), dtype=torch.int32, device=a_idx.device)
    for c in range(16):
        plane = (packed >> c) & 1
        acc = torch.zeros_like(cmask).scatter_reduce_(
            0, seg, plane, "amax", include_self=True)
        cmask |= acc << c

    cptr = _exclusive_scan(popcount16(cmask).sum(1, dtype=torch.int32))
    return c_tile_row, c_tile_col, cmask, cptr, pair_ptr


def c_rowcol(cmask, cptr, c_nnz_cap: int):
    """Enumerate C's set bits: packed intra-tile coords + owning tile index.

    Returns (rowcol, elem_tile): both (c_nnz_cap,) i32, tile-major intra-tile
    row-major order, the value order the numeric phase produces; slots past
    C_nnz hold the last row of the last tile, column 0.  CUDA tensors: the
    kernel ``tile16_c_rowcol``; CPU tensors: ``c_rowcol_plain``.
    """
    if not cmask.is_cuda:
        return c_rowcol_plain(cmask, cptr, c_nnz_cap)
    from pem_spgemm_tpu_torch.ops import tile16_kernels
    return tile16_kernels.c_rowcol(cmask, cptr, c_nnz_cap)


def c_rowcol_values(cmask, cptr, c_nnz_cap: int, c_dense):
    """(rowcol, elem_tile, c_vals): ``c_rowcol`` and the compressed values
    ``numeric.extract_values(c_dense, rowcol, elem_tile)`` gives, padding
    slots included (c_dense's dtype).  CUDA tensors: one launch of the
    kernel ``tile16_c_rowcol`` with the value table; CPU tensors:
    ``c_rowcol_plain``, then ``extract_values``."""
    if not cmask.is_cuda:
        from pem_spgemm_tpu_torch.ops.numeric import extract_values
        rowcol, elem_tile = c_rowcol_plain(cmask, cptr, c_nnz_cap)
        return rowcol, elem_tile, extract_values(c_dense, rowcol, elem_tile)
    from pem_spgemm_tpu_torch.ops import tile16_kernels
    return tile16_kernels.c_rowcol(cmask, cptr, c_nnz_cap, c_dense)


def c_rowcol_plain(cmask, cptr, c_nnz_cap: int):
    """The plain version of ``c_rowcol`` (CPU tensors).  Each
    output slot k finds its tile row (tile * 16 + row) from the nnz scan at
    row granularity (``cptr`` plus the tile's popcount scan) and its column
    by a bit-rank select (``select16``): O(c_nnz) vector work, no
    (c_cap*256)-sized scatter and no (c_nnz_cap, 16) temporaries.  The
    arrays equal the JAX package's (whose slots find the tile first, then
    the row), padding slots included: they fall in the last row of the
    last tile, with column 0.
    """
    c_cap = cmask.shape[0]
    pc = popcount16(cmask)
    rowptr = torch.cat([(cptr[:-1, None] + cumsum16(pc) - pc).reshape(-1),
                        cptr[-1:]])
    tr = scanops.segment_ids_from_offsets(rowptr, c_nnz_cap).clamp(
        0, c_cap * 16 - 1)
    trl = tr.long()
    jr = torch.arange(c_nnz_cap, dtype=torch.int32,
                      device=cmask.device) - rowptr[trl]
    col = select16(cmask.reshape(-1)[trl], jr)
    return (((tr & 15) << 4) | col).to(torch.int32), tr >> 4


def c_rowcol_scatter(cmask, c_nnz_cap: int):
    """Scatter-formulated variant of c_rowcol (kept for cross-checking)."""
    c_cap = cmask.shape[0]
    dev = cmask.device
    shifts = torch.arange(16, dtype=torch.int32, device=dev)
    bits = ((cmask[:, :, None] >> shifts[None, None, :]) & 1).reshape(-1)
    rank = torch.cumsum(bits, 0, dtype=torch.int32) - 1     # output slot
    r = shifts[None, :, None].expand(c_cap, 16, 16)
    c = shifts[None, None, :].expand(c_cap, 16, 16)
    tidx = torch.arange(c_cap, dtype=torch.int32,
                        device=dev)[:, None, None].expand(c_cap, 16, 16)
    intra = ((r << 4) | c).reshape(-1)
    slot = torch.where(bits == 1, rank, c_nnz_cap)
    rowcol = torch.zeros(c_nnz_cap + 1, dtype=torch.int32, device=dev)
    rowcol[slot.long()] = intra
    elem_tile = torch.zeros(c_nnz_cap + 1, dtype=torch.int32, device=dev)
    elem_tile[slot.long()] = tidx.reshape(-1)
    return rowcol[:c_nnz_cap], elem_tile[:c_nnz_cap]
