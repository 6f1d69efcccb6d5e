"""Multi-GPU Macro128 SpGEMM: row-sharded A, B macro tiles passed round a
ring.

Counterpart of the JAX package's parallel/sharded_macro.py, the regime
where several cards matter most: B is dense 64 KB macro tiles.  C macro
tiles split into contiguous per-rank ranges balanced by pair count; B's
tiles split into n contiguous chunks.  The multiply runs n stages: at stage
s rank d holds B chunk (d - s) mod n, sends it to the right while it
receives the next one from the left, and accumulates the pairs whose B tile
lies in the chunk it holds.

Each stage with pairs is one launch of the pair-stream kernel K4
(``ops.macro_kernels.accumulate_macro_pairs``; its plain version on the
CPU), on two buffers: a stage's K4 runs while the next chunk arrives, and
the receive is waited for before the next stage reads it.  As the JAX
ring's stage scatter-adds into the C it carries, the first stage with
pairs writes the rank's C (K4's fresh form, which zeroes the tiles without
pairs) and every later one adds into it (K4's accumulate form, which reads
and writes only the tiles the stage has pairs for).  K4 skips only pairs
whose C tile is INT32_MAX, so this port pads a stage's ``seg`` with
INT32_MAX where the JAX layout pads with ``c_cap`` (the C tile it drops);
the stable key sort keeps each stage's pairs ascending in C tile, which K4
needs.

bfloat16 tiles go round the ring as they lie, in bfloat16 as in the JAX
ring (half the bytes of their float32 copies a stage); K4 takes float32
or float64 tiles, so a rank widens each chunk it holds into one float32
buffer before its stage, and its A slice once a plan (``local_macro``).
C is float32, as the JAX stage's ``preferred_element_type``.

Every launch on the card reads tile k-masks (it runs only the k-slabs the
masks call non-zero, at every precision, fresh or accumulating), so a plan
makes those of its A slice and
of its B chunk once (``plan_masks``: one launch a table) and the ring
passes a chunk's masks with the chunk, in the same exchange (40 bytes a
64 KB tile), so that no stage reads a table to make masks.

The schedule (pair expansion, cuts, stage keys; int arrays of O(pairs)) is
computed whole on every rank, identically; a rank then takes its own
slice and materializes only its own A slice and B chunk.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pem_spgemm_tpu_torch.config import round_up_bucket
from pem_spgemm_tpu_torch.formats.coo import widened
from pem_spgemm_tpu_torch.formats.macro import MacroMatrix
from pem_spgemm_tpu_torch.ops import macro_kernels as mk
from pem_spgemm_tpu_torch.ops import symbolic
from pem_spgemm_tpu_torch.ops.scanops import can_pack
from pem_spgemm_tpu_torch.parallel.distributed import (RankGroup,
                                                       gather_coo, make_mesh,
                                                       ring_exchange)

SENT = 0x7FFFFFFF
TILE = 128


@dataclasses.dataclass
class Schedule:
    """The ring schedule, identical on every rank (``_plan_schedule``):
    the key-sorted pair stream and the small host statistics."""

    n: int
    key_s: torch.Tensor     # (p_cap,) i32 rank * n + stage, sorted
    a_s: torch.Tensor       # (p_cap,) i32 A tile of each pair
    b_s: torch.Tensor       # (p_cap,) i32 B tile
    seg_s: torch.Tensor     # (p_cap,) i32 C tile (global rank)
    t_row: torch.Tensor     # (p_cap + 1,) i32 C tile coordinates
    t_col: torch.Tensor
    c_bounds: np.ndarray    # (n + 1,) C tile range of each rank
    a_lo: np.ndarray        # (n,) first A tile of each rank (0 if none)
    a_hi: np.ndarray        # (n,) last A tile of each rank (-1 if none)
    gptr: np.ndarray        # (n * n + 2,) start of each (rank, stage) group
    stage_cap: int          # largest group (not yet bucketed)


def _plan_schedule(c_row, c_col, a_idx, b_idx, seg, n_pairs: int, cnt_c,
                   *, p_cap: int, n: int, b_chunk: int) -> Schedule:
    """Device cuts, stage keys and group layout (the JAX package's jitted
    phase 1), then one small copy to the host: the bounds, the A ranges,
    the group pointers and the largest group."""
    dev = seg.device
    i32 = torch.int32
    valid = torch.arange(p_cap, dtype=i32, device=dev) < n_pairs
    segc = seg.clamp(max=p_cap)
    segl = segc.long()
    tile_pairs = torch.zeros(p_cap + 1, dtype=i32, device=dev).index_add_(
        0, segl, valid.to(i32))
    pair_cum = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                          torch.cumsum(tile_pairs, 0, dtype=i32)])
    # balanced contiguous C ranges by pair count: floor(k * n_pairs / n)
    # without an int32 overflow
    k = torch.arange(1, n, dtype=i32, device=dev)
    targets = k * (n_pairs // n) + (k * (n_pairs % n)) // n
    cuts = torch.searchsorted(pair_cum, targets).to(i32)
    c_bounds = torch.cat([torch.zeros(1, dtype=i32, device=dev), cuts,
                          cnt_c.reshape(1).to(i32)])
    rank = torch.searchsorted(cuts, segc, right=True).to(i32)
    rank = torch.where(valid, rank, n)
    owner = (b_idx // b_chunk).clamp(max=n - 1)
    stage = torch.where(valid, (rank - owner) % n, n * n)
    key = torch.where(valid, rank * n + stage, n * n).to(i32)
    gcnt = torch.zeros(n * n + 1, dtype=i32, device=dev).index_add_(
        0, key.clamp(max=n * n).long(), torch.ones_like(key))
    gptr = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                      torch.cumsum(gcnt, 0, dtype=i32)])
    stage_cap = gcnt[:n * n].max()
    rk = rank.clamp(max=n).long()
    a_lo = torch.full((n + 1,), SENT, dtype=i32, device=dev).scatter_reduce_(
        0, rk, torch.where(valid, a_idx, SENT), "amin")
    a_hi = torch.full((n + 1,), -1, dtype=i32, device=dev).scatter_reduce_(
        0, rk, torch.where(valid, a_idx, -1), "amax")
    # stable key sort with payloads: the pairs of one group stay C-sorted
    key_s, order = torch.sort(key, stable=True)
    t_row = torch.full((p_cap + 1,), SENT, dtype=i32,
                       device=dev).scatter_reduce_(
        0, segl, torch.where(valid, c_row, SENT), "amin")
    t_col = torch.full((p_cap + 1,), SENT, dtype=i32,
                       device=dev).scatter_reduce_(
        0, segl, torch.where(valid, c_col, SENT), "amin")
    stats = torch.cat([c_bounds, a_lo[:n], a_hi[:n], gptr,
                       stage_cap.reshape(1)]).cpu().numpy().astype(np.int64)
    c_bounds_h, a_lo_h, a_hi_h, gptr_h = np.split(
        stats[:-1], np.cumsum([n + 1, n, n]))
    return Schedule(
        n=n, key_s=key_s, a_s=a_idx[order], b_s=b_idx[order],
        seg_s=segc[order], t_row=t_row, t_col=t_col, c_bounds=c_bounds_h,
        a_lo=np.where(a_lo_h == SENT, 0, a_lo_h), a_hi=a_hi_h, gptr=gptr_h,
        stage_cap=int(stats[-1]))


def expand_schedule(a, b, n: int, ntiles_a: int, n_rows: int, n_cols: int):
    """Pair expansion of A @ B over tile grids (the jitted symbolic phase
    of the JAX package) and the ring schedule of n ranks.  Returns
    (schedule, n_pairs, b_chunk, pairs) with pairs the expanded stream
    (c_row, c_col, a_idx, b_idx, seg, cnt_c)."""
    offsets = symbolic.pair_counts(a.tile_col, b.tile_rowptr, ntiles_a)
    n_pairs = int(offsets[-1])
    p_cap = round_up_bucket(max(1, n_pairs))
    pairs = symbolic.expand_pairs(
        offsets, a.tile_row, a.tile_col, b.tile_rowptr, b.tile_col, n_pairs,
        p_cap, can_pack(n_rows, n_cols))
    b_chunk = max(1, -(-b.ntiles // n))
    sched = _plan_schedule(*pairs[:5], n_pairs, pairs[5], p_cap=p_cap, n=n,
                           b_chunk=b_chunk)
    return sched, n_pairs, b_chunk, pairs


def rank_stages(sched: Schedule, d: int, stage_cap: int, b_chunk: int,
                a_pad: int, seg_pad: int):
    """Rank d's stage tables (n, stage_cap) i32: local A tile, index within
    the B chunk, local C tile; padding slots carry ``a_pad``, 0 and
    ``seg_pad``.  Also the live pairs of each stage (host ints)."""
    n = sched.n
    dev = sched.key_s.device
    lo, hi = int(sched.gptr[d * n]), int(sched.gptr[d * n + n])
    key = sched.key_s[lo:hi].long()
    pos = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    gptr = torch.from_numpy(sched.gptr).to(dev)
    dst = (key - d * n) * stage_cap + (pos - gptr[key])
    flat = n * stage_cap
    pa = torch.full((flat,), a_pad, dtype=torch.int32, device=dev)
    pb = torch.zeros(flat, dtype=torch.int32, device=dev)
    sg = torch.full((flat,), seg_pad, dtype=torch.int32, device=dev)
    pa[dst] = sched.a_s[lo:hi] - int(sched.a_lo[d])
    pb[dst] = sched.b_s[lo:hi] % b_chunk
    sg[dst] = sched.seg_s[lo:hi] - int(sched.c_bounds[d])
    live = tuple(int(x) for x in np.diff(sched.gptr[d * n:d * n + n + 1]))
    return (pa.reshape(n, stage_cap), pb.reshape(n, stage_cap),
            sg.reshape(n, stage_cap), live)


def rank_tiles(table: torch.Tensor, first: int, count: int, cap: int):
    """(cap, ...) rows ``first`` .. ``first + count - 1`` of a tile table
    whose last row is its zero tile; every other slot takes the zero
    tile."""
    zero = table.shape[0] - 1
    idx = first + torch.arange(cap, dtype=torch.int64, device=table.device)
    idx = torch.where((idx < first + count) & (idx < zero), idx, zero)
    return table[idx]


def rank_coords(sched: Schedule, d: int, c_cap: int):
    """(c_cap,) i32 global coordinates of rank d's C tiles (SENT padding)."""
    lo, hi = int(sched.c_bounds[d]), int(sched.c_bounds[d + 1])
    out = []
    for t in (sched.t_row, sched.t_col):
        x = torch.full((c_cap,), SENT, dtype=torch.int32, device=t.device)
        x[:hi - lo] = t[lo:hi]
        out.append(x)
    return out


@dataclasses.dataclass
class ShardedMacroPlan:
    """Rank ``rank``'s share of one sharded macro multiply.

    ``seg`` is padded with INT32_MAX (the JAX plan pads with ``c_cap``),
    ``pairs_a`` with ``a_cap`` (the A slice's zero tile) and ``pairs_b``
    with 0, as the JAX plan's row ``rank`` is."""

    n_devices: int
    rank: int
    a_dense: torch.Tensor    # (a_cap + 1, 128, 128) local A slice (+ zero)
    b_dense: torch.Tensor    # (b_chunk, 128, 128) this rank's B chunk
    pairs_a: torch.Tensor    # (n, stage_cap) local A tile
    pairs_b: torch.Tensor    # (n, stage_cap) index within the B chunk
    seg: torch.Tensor        # (n, stage_cap) local C tile (pad INT32_MAX)
    stage_pairs: tuple       # (n,) live pairs of each stage (host)
    c_cap: int
    c_tile_row: torch.Tensor  # (c_cap,) global macro coords (pad SENT)
    c_tile_col: torch.Tensor
    c_counts_dev: np.ndarray  # (n,) true C tile counts of every rank
    n_pairs: int
    masks: tuple = None      # (A slice's, B chunk's) TableMasks: plan_masks

    @property
    def stages(self) -> int:
        return self.pairs_a.shape[0]

    @property
    def c_count(self) -> int:
        return int(self.c_counts_dev[self.rank])


def plan_sharded_macro(a: MacroMatrix, b: MacroMatrix, n_devices: int,
                       rank: int) -> ShardedMacroPlan:
    """Rank ``rank``'s plan: the schedule computed whole (identically on
    every rank), then this rank's stage tables, A slice, B chunk and C tile
    coordinates.  Capacities are the JAX planner's: a_cap and stage_cap
    bucketed, c_cap the largest rank's C tile count."""
    if a.dense.dtype not in (torch.float32, torch.float64, torch.bfloat16) \
            or b.dense.dtype != a.dense.dtype:
        raise NotImplementedError(
            f"tiles of dtype {a.dense.dtype} / {b.dense.dtype}: the macro "
            "ring takes float32, float64 or bfloat16 tiles, both of one "
            "dtype")
    n, d = n_devices, rank
    if not 0 <= d < n:
        raise ValueError(f"rank {d} of {n}")
    sched, n_pairs, b_chunk, _pairs = expand_schedule(
        a, b, n, a.ntiles, a.n_macro_rows, b.n_macro_cols)
    a_caps = np.maximum(1, sched.a_hi - sched.a_lo + 1)
    a_cap = round_up_bucket(int(a_caps.max()))
    c_counts = np.diff(sched.c_bounds).astype(np.int64)
    c_cap = max(1, int(c_counts.max()))
    stage_cap = max(1, round_up_bucket(sched.stage_cap))
    pa, pb, sg, live = rank_stages(sched, d, stage_cap, b_chunk,
                                   a_pad=a_cap, seg_pad=SENT)
    a_lo = int(sched.a_lo[d])
    a_slice = rank_tiles(a.dense, a_lo, a_cap, a_cap + 1)
    b_chunk_d = rank_tiles(b.dense, d * b_chunk,
                           max(0, min(b_chunk, b.ntiles - d * b_chunk)),
                           b_chunk)
    ctr, ctc = rank_coords(sched, d, c_cap)
    return ShardedMacroPlan(
        n_devices=n, rank=d, a_dense=a_slice, b_dense=b_chunk_d,
        pairs_a=pa, pairs_b=pb, seg=sg, stage_pairs=live, c_cap=c_cap,
        c_tile_row=ctr, c_tile_col=ctc, c_counts_dev=c_counts,
        n_pairs=n_pairs)


def acc_slice(plan: ShardedMacroPlan) -> torch.Tensor:
    """The plan's A slice as K4 takes it: ``a_dense`` itself, or for
    bfloat16 tiles its float32 copy, made once a plan and cached on it
    (``formats.coo.widened``)."""
    return widened(plan, "_a_acc", plan.a_dense)


def plan_masks(plan: ShardedMacroPlan):
    """(A slice's, B chunk's) ``TableMasks`` of the plan, made once: the
    first call makes them (one launch a table on the card, the plain
    version on the CPU), later ones return the same (made anew only if the
    plan's tables were replaced).  The A slice's are those of the table K4
    reads (``acc_slice``); a bfloat16 chunk's are made from its float32
    copy (``TableMasks``)."""
    m = plan.masks
    a = acc_slice(plan)
    if m is None or not (m[0].matches(a) and m[1].matches(plan.b_dense)):
        plan.masks = m = (mk.TableMasks(a).make(),
                          mk.TableMasks(plan.b_dense).make())
    return m


def ring_chunks(first: torch.Tensor, n: int, mesh: RankGroup, masks=None):
    """The B chunk of each of n stages on this rank: ``first`` at stage 0;
    each stage passes its chunk to the right while the next arrives from
    the left, into two buffers of its own in turn (``first``, the plan's,
    is only read, so the plan runs again as it was).  The consumer computes
    a stage between two ``next()``s, so the exchange overlaps it; the
    receive is waited for before the next stage is handed out.  With
    ``masks`` (``first``'s TableMasks) each stage yields (chunk, its
    masks): the masks pass with the chunk in the same exchange, into masks
    of the receiving buffer, ready once received."""
    spare = [torch.empty_like(first) for _ in range(min(2, n - 1))]
    spare_m = [mk.TableMasks(x) for x in spare] if masks is not None \
        else [None] * len(spare)
    cur, cur_m = first, masks
    for s in range(n):
        nxt, nxt_m = (spare[s % 2], spare_m[s % 2]) if s < n - 1 \
            else (None, None)
        reqs = []
        if nxt_m is not None:
            nxt_m.ready = False
            reqs = ring_exchange([cur, cur_m.words], [nxt, nxt_m.words],
                                 mesh)
        elif nxt is not None:
            reqs = ring_exchange(cur, nxt, mesh)
        yield cur if masks is None else (cur, cur_m)
        for req in reqs:
            req.wait()
        if nxt_m is not None:
            nxt_m.ready = True
        cur, cur_m = nxt, nxt_m


def local_macro(plan: ShardedMacroPlan, chunks, precision: str = "highest"):
    """(c_dense (c_cap, 128, 128), c_flags uint8) of this rank: one K4
    launch for each stage that has pairs, at ``precision``, on the chunk
    ``chunks`` yields for it (a chunk, or a (chunk, its TableMasks) pair).
    The first writes C (the fresh form), each later one adds its products
    into that C and ORs its flags in (the accumulate form, ``out=``).
    Where the launch reads tile masks, every stage gets the A slice's
    (plan_masks) and the chunk's it was handed (none: the launch makes
    them).  Zeros where no stage has pairs.

    bfloat16 tiles run as float32 copies, as on one card, and C is
    float32 (the JAX stage's ``preferred_element_type``): the A slice's is
    made once a plan (``acc_slice``), and each bfloat16 chunk is widened
    into one float32 buffer kept for the run, with the masks it was handed
    as that buffer's.  The launches run in stream order, so a stage's
    widening waits for the K4 launch before it."""
    from pem_spgemm_tpu_torch.ops.macro_kernels import accumulate_macro_pairs
    a_acc = acc_slice(plan)
    out = wide = None
    chunk = min(256, plan.pairs_a.shape[1])
    for s, item in enumerate(chunks):
        b_cur, b_masks = item if isinstance(item, tuple) else (item, None)
        if plan.stage_pairs[s] == 0:
            continue
        if b_cur.dtype == torch.bfloat16:
            if wide is None or wide.shape != b_cur.shape:
                wide = torch.empty(b_cur.shape, dtype=torch.float32,
                                   device=b_cur.device)
                wide_masks = mk.TableMasks(wide)
            b_cur = wide.copy_(b_cur)
            if b_masks is not None:
                wide_masks.words, wide_masks.ready = (b_masks.words,
                                                      b_masks.ready)
                b_masks = wide_masks
        masks = mk.TileMasks(a_acc, b_cur, a=plan_masks(plan)[0],
                             b=b_masks) if mk.reads_masks(b_cur) else None
        out = accumulate_macro_pairs(
            a_acc, b_cur, plan.pairs_a[s], plan.pairs_b[s],
            plan.seg[s], plan.c_cap, chunk=chunk, precision=precision,
            tile_masks=masks, out=out)
    if out is None:
        dev = plan.a_dense.device
        out = (torch.zeros((plan.c_cap, TILE, TILE), dtype=a_acc.dtype,
                           device=dev),
               torch.zeros((plan.c_cap, TILE, TILE), dtype=torch.uint8,
                           device=dev))
    return out


def sharded_macro_numeric(plan: ShardedMacroPlan,
                          mesh: RankGroup | None = None,
                          precision: str = "highest"):
    """This rank's (c_dense, c_flags) of the ring multiply, each stage's K4
    at ``precision``; the chunks carry their masks where K4 reads them
    (``mk.reads_masks``: every stage on the card, a ring of one rank's
    too)."""
    mesh = mesh or make_mesh()
    masks = plan_masks(plan)[1] if mk.reads_masks(plan.b_dense) else None
    return local_macro(plan, ring_chunks(plan.b_dense, plan.n_devices, mesh,
                                         masks), precision)


def replay_chunks(plans, d: int, masks: bool = False):
    """The chunks rank d meets at each stage, read from every rank's plan
    (no exchange: one card replaying the ranks in turn); with ``masks``
    each with its plan's masks (plan_masks), as the ring carries them.  A
    replay at a precision is ``local_macro(plans[d], replay_chunks(plans,
    d, masks), precision)``."""
    n = len(plans)
    if not masks:
        return (plans[(d - s) % n].b_dense for s in range(n))
    return ((plans[(d - s) % n].b_dense, plan_masks(plans[(d - s) % n])[1])
            for s in range(n))


def largest_accumulating_stage(plans):
    """(rank, stage) of the stage with the most pairs among those that K4
    runs in its accumulate form (a stage with pairs after its rank's first)
    over a ring's plans, or None."""
    best = None
    for d, p in enumerate(plans):
        live = [s for s, x in enumerate(p.stage_pairs) if x]
        for s in live[1:]:
            if best is None or p.stage_pairs[s] > \
                    plans[best[0]].stage_pairs[best[1]]:
                best = (d, s)
    return best


def local_macro_coo(plan: ShardedMacroPlan, c_dense, c_flags):
    """(rows, cols, vals) of this rank's C on its device: the flagged
    entries of its first ``c_count`` tiles (structural zeros kept)."""
    t, r, c = torch.nonzero(c_flags[:plan.c_count], as_tuple=True)
    return (plan.c_tile_row[t].long() * TILE + r,
            plan.c_tile_col[t].long() * TILE + c, c_dense[t, r, c])


def assemble_sharded_macro(plan: ShardedMacroPlan, c_dense, c_flags,
                           mesh: RankGroup | None = None,
                           host: bool = True):
    """Global sorted COO on every rank (host numpy; ``host=False``: tensors
    on the device)."""
    mesh = mesh or make_mesh()
    return gather_coo(*local_macro_coo(plan, c_dense, c_flags), mesh, host)
