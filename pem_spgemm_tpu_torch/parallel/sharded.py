"""Multi-GPU Tile16 SpGEMM: row-sharded A, B 16x16 tiles passed round a
ring.

Counterpart of the JAX package's parallel/sharded.py.  C tile rows follow A
tile rows, so C tiles split into contiguous per-rank ranges balanced by pair
count, and each rank owns the A tiles and C tiles of its range.  B's dense
tile values split into n contiguous chunks that pass round the ring: at
stage s rank d holds chunk (d - s) mod n and multiplies the pairs whose B
tile lies there, while the chunk moves on (the ring and its schedule are the
Macro128 ring's: ``sharded_macro``).

The planner is the JAX package's: the symbolic phase expands the pairs,
``ops.cstruct`` builds the exact C bitmask structure, and the ring schedule
is shared with the macro planner.  A stage's body is the Tile16 kernel
(``ops.numeric.accumulate_dense`` on the card: ``ops.tile16_kernels``,
where the JAX package's stage is plain XLA): a rank's first stage with
pairs writes its C (the fresh form), and each later one adds its products
into that C (the accumulate form), as the JAX ring's
``c_dense.at[sg].add`` adds into the loop-carried C; no partial C.
Padding pairs target C tile ``c_cap``, which the kernel never reads, as in
the JAX plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pem_spgemm_tpu_torch.config import round_up_bucket
from pem_spgemm_tpu_torch.formats.tiled import TiledMatrix
from pem_spgemm_tpu_torch.ops import cstruct, numeric
from pem_spgemm_tpu_torch.parallel.distributed import (RankGroup,
                                                       gather_coo, make_mesh)
from pem_spgemm_tpu_torch.parallel.sharded_macro import (expand_schedule,
                                                         rank_coords,
                                                         rank_stages,
                                                         rank_tiles,
                                                         replay_chunks,
                                                         ring_chunks)


@dataclasses.dataclass
class ShardedPlan:
    """Rank ``rank``'s share of one sharded Tile16 multiply.  Its arrays
    equal row ``rank`` of the JAX plan's (padding included: ``pairs_a`` 0,
    ``pairs_b`` 0, ``seg`` c_cap)."""

    n_devices: int
    rank: int
    a_dense: torch.Tensor    # (a_cap + 1, 16, 16) local A slice (+ zero)
    b_dense: torch.Tensor    # (b_chunk, 16, 16) this rank's B chunk
    pairs_a: torch.Tensor    # (n, stage_cap) local A tile
    pairs_b: torch.Tensor    # (n, stage_cap) index within the B chunk
    seg: torch.Tensor        # (n, stage_cap) local C tile (pad c_cap)
    stage_pairs: tuple       # (n,) live pairs of each stage (host)
    rowcol: torch.Tensor     # (nnz_cap,) intra-tile coords of local C
    elem_tile: torch.Tensor  # (nnz_cap,) local C tile of each entry
    c_cap: int
    c_tile_row: torch.Tensor  # (c_cap,) global tile coords (pad SENT)
    c_tile_col: torch.Tensor
    c_nnz_per_dev: np.ndarray  # (n,) C entries of every rank
    c_nnz: int
    n_pairs: int

    @property
    def stages(self) -> int:
        return self.pairs_a.shape[0]


def plan_sharded_spgemm(a: TiledMatrix, b: TiledMatrix, n_devices: int,
                        rank: int) -> ShardedPlan:
    """Rank ``rank``'s plan: pair expansion, the ring schedule (computed
    whole, identically on every rank), the exact C structure, then this
    rank's stage tables, A slice, B chunk, element structure and C tile
    coordinates.  Capacities are the JAX planner's."""
    from pem_spgemm_tpu_torch.ops.convert import transpose_masks
    if a.vals.dtype != torch.float32 or b.vals.dtype != torch.float32:
        raise NotImplementedError(
            f"values of dtype {a.vals.dtype} / {b.vals.dtype}: the Tile16 "
            "ring multiplies float32")
    n, d = n_devices, rank
    if not 0 <= d < n:
        raise ValueError(f"rank {d} of {n}")
    sched, n_pairs, b_chunk, pairs = expand_schedule(
        a, b, n, a.ntiles, a.n_tile_rows, b.n_tile_cols)
    c_row, c_col, a_idx, b_idx, seg, _cnt_c = pairs
    stage_cap = max(1, round_up_bucket(sched.stage_cap))
    a_caps = np.maximum(1, sched.a_hi - sched.a_lo + 1)
    a_cap = round_up_bucket(int(a_caps.max()))
    c_bounds = sched.c_bounds
    n_c = int(c_bounds[-1])
    c_cap = round_up_bucket(max(1, int(np.diff(c_bounds).max())))

    # exact C structure: bitmasks, per-tile nnz, set-bit coordinates
    b_tmasks = b.tmasks if b.tmasks is not None else transpose_masks(b.masks)
    _ctr, _ctc, cmask, cptr, _pp = cstruct.c_masks(
        a.masks, b_tmasks, a_idx, b_idx, seg, c_row, c_col,
        round_up_bucket(max(1, n_c)))
    bounds = torch.from_numpy(c_bounds).to(cptr.device)
    nnz_at = cptr[bounds].cpu().numpy().astype(np.int64)
    nnz_dev = np.diff(nnz_at)
    c_nnz = int(nnz_dev.sum())
    nnz_cap = round_up_bucket(max(1, int(nnz_dev.max())))
    rowcol_g, elem_t_g = cstruct.c_rowcol(cmask, cptr,
                                          round_up_bucket(max(1, c_nnz)))

    pa, pb, sg, live = rank_stages(sched, d, stage_cap, b_chunk, a_pad=0,
                                   seg_pad=c_cap)
    flat = a.dense_flat()                  # (tile_cap + 1, 256), zero last
    a_lo = int(sched.a_lo[d])
    a_slice = rank_tiles(flat, a_lo, a_cap, a_cap + 1).reshape(-1, 16, 16)
    b_flat = flat if b is a else b.dense_flat()
    b_chunk_d = rank_tiles(b_flat, d * b_chunk,
                           max(0, min(b_chunk, b.ntiles - d * b_chunk)),
                           b_chunk).reshape(-1, 16, 16)
    # rank d's element structure: its slice of the tile-major stream
    lo, hi = int(nnz_at[d]), int(nnz_at[d + 1])
    rc = torch.zeros(nnz_cap, dtype=torch.int32, device=cptr.device)
    et = torch.zeros(nnz_cap, dtype=torch.int32, device=cptr.device)
    rc[:hi - lo] = rowcol_g[lo:hi]
    et[:hi - lo] = elem_t_g[lo:hi] - int(c_bounds[d])
    ctr, ctc = rank_coords(sched, d, c_cap)
    return ShardedPlan(
        n_devices=n, rank=d, a_dense=a_slice, b_dense=b_chunk_d,
        pairs_a=pa, pairs_b=pb, seg=sg, stage_pairs=live, rowcol=rc,
        elem_tile=et, c_cap=c_cap, c_tile_row=ctr, c_tile_col=ctc,
        c_nnz_per_dev=nnz_dev, c_nnz=c_nnz, n_pairs=n_pairs)


def local_numeric(plan: ShardedPlan, chunks, precision: str = "highest"):
    """(nnz_cap,) float32 C values of this rank: one accumulation for each
    stage that has pairs, on the chunk ``chunks`` yields for it.  The
    first writes the rank's dense C tiles (the fresh form), each later one
    adds its products into that C (the accumulate form, ``out=``); zeros
    where no stage has pairs.  Then the values at its C structure."""
    stage_cap = plan.pairs_a.shape[1]
    c_dense = None
    for s, b_cur in enumerate(chunks):
        if plan.stage_pairs[s] == 0:
            continue
        c_dense = numeric.accumulate_dense(
            plan.a_dense, b_cur, plan.pairs_a[s], plan.pairs_b[s],
            plan.seg[s], plan.c_cap, stage_cap, torch.float32, precision,
            out=c_dense)
    if c_dense is None:
        c_dense = torch.zeros((plan.c_cap, 16, 16), dtype=torch.float32,
                              device=plan.a_dense.device)
    return numeric.extract_values(c_dense, plan.rowcol, plan.elem_tile)


def sharded_numeric(plan: ShardedPlan, mesh: RankGroup | None = None,
                    precision: str = "highest"):
    """This rank's C values (nnz_cap,) of the ring multiply."""
    mesh = mesh or make_mesh()
    return local_numeric(plan, ring_chunks(plan.b_dense, plan.n_devices,
                                           mesh), precision)


def replay_numeric(plans, d: int, precision: str = "highest"):
    """Rank d's C values with its chunks read from every rank's plan."""
    return local_numeric(plans[d], replay_chunks(plans, d), precision)


def local_coo(plan: ShardedPlan, vals):
    """(rows, cols, vals) of this rank's C on its device."""
    nv = int(plan.c_nnz_per_dev[plan.rank])
    rc = plan.rowcol[:nv].long()
    et = plan.elem_tile[:nv].long()
    return (plan.c_tile_row[et].long() * 16 + (rc >> 4),
            plan.c_tile_col[et].long() * 16 + (rc & 15), vals[:nv])


def assemble_sharded(plan: ShardedPlan, vals, mesh: RankGroup | None = None,
                     host: bool = True):
    """Global sorted COO on every rank (host numpy; ``host=False``: tensors
    on the device)."""
    mesh = mesh or make_mesh()
    return gather_coo(*local_coo(plan, vals), mesh, host)


__all__ = ["ShardedPlan", "assemble_sharded", "make_mesh",
           "plan_sharded_spgemm", "sharded_numeric"]
