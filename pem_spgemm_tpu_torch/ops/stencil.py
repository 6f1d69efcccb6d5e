"""Stencil / run plans of the Macro128 engine: write-once accumulation for
pair structure that repeats.

Counterpart of the planner half of the JAX package's ops/pallas_stencil.py
(the kernel half is ops/macro_kernels.py + csrc/macro_accumulate.cu).

  * ``plan_stencil`` walks each C diagonal in steps of T consecutive tiles
    and hashes the step's operand-offset pattern (all pair positions
    relative to the step's first positions).  Steps with identical patterns
    form a CLASS.
  * ``plan_runs`` makes one step per C macro row (its tiles, their ragged
    pair lists and the operand windows they reference), grouped by the same
    kind of signature: the plan for locally regular, globally aperiodic
    matrices (a wandering band).
  * the class calls compute, for every step and tile, the sum of the
    tile's pair products from ``base + offset`` operand positions and write
    the tile's slab row once: on the card one launch over all of a plan's
    classes (``plan_tables``), where the reference compiles and calls one
    kernel a class.
  * steps whose pattern is rare or too wide fall back to the residual path:
    their pairs, sorted by slab row, go through the pair-stream entry into
    reserved rows of the same slabs.

C arrays come out SLAB-ORDERED (class-major); ``StencilPlan.order`` maps a
slab row to its sorted-tile index.  The planners are host numpy and give
the same plan as the JAX package's on the same pair stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pem_spgemm_tpu_torch.config import precision_code
from pem_spgemm_tpu_torch.ops.macro import (TILE, require_full_fp32,
                                            round_operands)

T_STEP = 8              # C tiles per step of the stencil plan
MIN_CLASS_STEPS = 4     # rarer patterns go to the residual path
MAX_CLASSES = 8
MAX_WIN = 40            # window extent cap (tiles); wider goes residual

# Run-plan bounds: a C macro row becomes one step when its tiles, pairs and
# operand window extents fit; anything wider goes residual.
T_MAXR = 16             # C tiles per row step
P_MAXR = 64             # pairs per row step
MAX_WIN_R = 48          # window extent cap (tiles) for the run plan
MAX_CLASSES_R = 32      # row signatures are finer than diagonal ones


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """Host-built class layout for one (A, B) pair structure."""

    classes: tuple         # per class: (t, p, ar, br, a_offs, b_offs, base)
    class_bases: tuple     # per class: (2*n_steps,) i32 tensor
    res_pa: torch.Tensor   # residual pairs (chunked scatter-add path)
    res_pb: torch.Tensor
    res_seg: torch.Tensor  # residual pair -> slab row
    n_res_tiles: int
    order: np.ndarray      # (slab rows,) slab row -> sorted-tile index
    c_cap: int             # slab rows allocated (>= real rows)
    n_tiles: int
    coverage: float        # fraction of pairs on the class path
    # per class: (p_ptr (t+1,), a_offs (P,), b_offs (P,)) i32 tensors, the
    # run-time tables of the class kernels (built once, with the plan)
    class_tables: tuple = ()
    # the same for all classes in one launch (plan_tables, built once)
    plan_tables: tuple = ()


def p_list_of(t: int, p) -> tuple:
    """Per-tile pair counts of a class: p is an int (uniform, stencil plan)
    or a per-tile tuple (ragged, run plan)."""
    return (int(p),) * t if isinstance(p, (int, np.integer)) else tuple(p)


def class_tables(classes, device) -> tuple:
    """The int32 tables of every class on ``device``."""
    out = []
    for (t, p, _ar, _br, a_offs, b_offs, _base) in classes:
        p_ptr = np.concatenate([[0], np.cumsum(p_list_of(t, p))])
        out.append(tuple(
            torch.from_numpy(np.asarray(x, np.int32)).to(device)
            for x in (p_ptr, a_offs, b_offs)))
    return tuple(out)


def plan_tables(classes, class_bases, device) -> tuple:
    """The tables of every class of a plan in one launch, on ``device``:
    (ab_bases, p_ptr, a_offs, b_offs, descriptors, n_rows).  The first four
    are int32 tensors, the classes' ``class_bases`` and ``class_tables``
    concatenated in class order, each class's p_ptr rebased by the pairs of
    the classes before it so that it indexes the concatenated offset
    tables; ``descriptors`` is a host (classes with rows, 4) int32 array:
    a class's first slab row, its t, its first step in ab_bases and its
    first entry in p_ptr; n_rows the slab rows of all classes.  The
    classes' rows must lie back to back from row 0, as the planners lay
    them (a slab row is then the launch's ticket)."""
    bases_l, ptr_l, ao_l, bo_l, desc = [], [], [], [], []
    row = step = ptr = pairs = 0
    for (t, p, _ar, _br, a_offs, b_offs, base), bases in zip(classes,
                                                               class_bases):
        n_steps = int(bases.shape[0]) // 2
        if base != row:
            raise ValueError(f"class rows start at {base}, expected {row}: "
                             "the classes' slab rows must lie back to back "
                             "from row 0")
        if n_steps * t:
            desc.append((row, t, step, ptr))
        bases_l.append(_host(bases, 2 * n_steps).astype(np.int32))
        ptr_l.append(pairs + np.concatenate([[0], np.cumsum(p_list_of(t, p))]))
        ao_l.append(np.asarray(a_offs, np.int64))
        bo_l.append(np.asarray(b_offs, np.int64))
        row += n_steps * t
        step += n_steps
        ptr += t + 1
        pairs += sum(p_list_of(t, p))

    def cat(xs):
        return torch.from_numpy(np.concatenate(xs).astype(np.int32)
                                if xs else np.zeros(0, np.int32)).to(device)

    return (cat(bases_l), cat(ptr_l), cat(ao_l), cat(bo_l),
            np.asarray(desc, np.int32).reshape(-1, 4), row)


def _host(x, n):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x)[:n]


def _tile_census(seg, a_idx, b_idx, n_pairs, n_tiles):
    segn = _host(seg, n_pairs)
    pan = _host(a_idx, n_pairs).astype(np.int64)
    pbn = _host(b_idx, n_pairs).astype(np.int64)
    counts = np.bincount(segn, minlength=n_tiles)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return segn, pan, pbn, counts, starts


def plan_stencil(seg, a_idx, b_idx, c_row, c_col, n_pairs, n_tiles,
                 a_rows, b_rows, t_step=T_STEP, device=None) -> StencilPlan:
    """Group C tiles into diagonal-step signature classes (host numpy)."""
    device = seg.device if device is None else device
    segn, pan, pbn, counts, starts = _tile_census(seg, a_idx, b_idx,
                                                  n_pairs, n_tiles)
    crow = _host(c_row, n_pairs).astype(np.int64)
    ccol = _host(c_col, n_pairs).astype(np.int64)
    first = starts[:-1]
    tile_row = crow[np.minimum(first, n_pairs - 1)]
    tile_col = ccol[np.minimum(first, n_pairs - 1)]

    # order tiles by (P, diagonal, row): runs of same-P tiles along each
    # diagonal become candidate steps
    diag = tile_col - tile_row
    order_t = np.lexsort((tile_row, diag, counts))
    sig_steps = {}          # signature -> list of (tiles, a_base, b_base)
    res_tiles = []

    i = 0
    nt = n_tiles
    while i < nt:
        j = i
        p0 = counts[order_t[i]]
        d0 = diag[order_t[i]]
        while j < nt and counts[order_t[j]] == p0 and diag[order_t[j]] == d0:
            j += 1
        run = order_t[i:j]
        i = j
        if p0 == 0:
            continue
        # chop the run into steps of t_step tiles
        for s in range(0, len(run) - t_step + 1, t_step):
            tiles = run[s:s + t_step]
            a0 = pan[starts[tiles[0]]]
            b0 = pbn[starts[tiles[0]]]
            a_offs, b_offs = [], []
            ok = True
            for tt in tiles:
                lo, hi = starts[tt], starts[tt + 1]
                ao = np.sort(pan[lo:hi]) - a0
                bo = np.sort(pbn[lo:hi]) - b0
                if (ao < 0).any() or (bo < 0).any() or \
                        ao.max(initial=0) >= MAX_WIN or \
                        bo.max(initial=0) >= MAX_WIN:
                    ok = False
                    break
                a_offs += list(ao)
                b_offs += list(bo)
            # the operand windows must stay inside the operand tables
            if ok and (a0 + max(a_offs) >= a_rows
                       or b0 + max(b_offs) >= b_rows):
                ok = False
            if not ok:
                res_tiles += list(tiles)
                continue
            key = (t_step, int(p0), tuple(a_offs), tuple(b_offs))
            sig_steps.setdefault(key, []).append((tiles, int(a0), int(b0)))
        leftover = run[len(run) - (len(run) % t_step):]
        res_tiles += list(leftover)

    return _finish_plan(sig_steps, res_tiles, segn, pan, pbn, n_pairs,
                        n_tiles, MAX_CLASSES, device)


def plan_runs(seg, a_idx, b_idx, c_row, c_col, n_pairs, n_tiles,
              a_rows, b_rows, device=None) -> StencilPlan:
    """Consecutive-run clustering plan: one write-once step per C MACRO
    ROW, grouped by in-window offset signature (host numpy).

    All pairs of one C macro row reference an A-table range (the row's
    tiles are contiguous in the row-major table) and a B-table range (the
    contributing B rows are consecutive table spans).  Locally regular
    matrices collapse to a handful of classes; rows with rare signatures
    or oversized windows degrade to the residual per-pair path.
    """
    device = seg.device if device is None else device
    segn, pan, pbn, counts, starts = _tile_census(seg, a_idx, b_idx,
                                                  n_pairs, n_tiles)
    crow = _host(c_row, n_pairs).astype(np.int64)
    first = starts[:-1]
    tile_row = crow[np.minimum(first, n_pairs - 1)]

    # tiles are already in (row, col) sort order by construction of the
    # pair stream (seg is the sorted C tile id); group by macro row
    row_change = np.nonzero(np.diff(tile_row))[0] + 1
    bounds = np.concatenate([[0], row_change, [n_tiles]])
    sig_steps = {}
    res_tiles = []
    for gi in range(len(bounds) - 1):
        tiles = np.arange(bounds[gi], bounds[gi + 1])
        total_p = int(counts[tiles].sum())
        if total_p == 0:
            continue
        if len(tiles) > T_MAXR or total_p > P_MAXR:
            res_tiles += list(tiles)
            continue
        lo, hi = starts[tiles[0]], starts[tiles[-1] + 1]
        a0 = int(pan[lo:hi].min())
        b0 = int(pbn[lo:hi].min())
        p_list, a_offs, b_offs = [], [], []
        ok = True
        for tt in tiles:
            tl, th = starts[tt], starts[tt + 1]
            ao = np.sort(pan[tl:th]) - a0
            bo = np.sort(pbn[tl:th]) - b0
            if ao.max(initial=0) >= MAX_WIN_R or \
                    bo.max(initial=0) >= MAX_WIN_R:
                ok = False
                break
            p_list.append(int(th - tl))
            a_offs += list(ao)
            b_offs += list(bo)
        if ok and (a0 + max(a_offs) >= a_rows
                   or b0 + max(b_offs) >= b_rows):
            ok = False
        if not ok:
            res_tiles += list(tiles)
            continue
        key = (len(tiles), tuple(p_list),
               tuple(int(x) for x in a_offs),
               tuple(int(x) for x in b_offs))
        sig_steps.setdefault(key, []).append((tiles, a0, b0))

    return _finish_plan(sig_steps, res_tiles, segn, pan, pbn, n_pairs,
                        n_tiles, MAX_CLASSES_R, device)


def _finish_plan(sig_steps, res_tiles, segn, pan, pbn, n_pairs, n_tiles,
                 max_classes, device):
    """Shared plan tail: rank signatures, lay out the slab, build the
    residual stream.  sig_steps keys are (t, p, a_offs, b_offs) with p an
    int (uniform, stencil plan) or a per-tile tuple (ragged, run plan);
    values are lists of (tiles, a_base, b_base)."""
    ranked = sorted(sig_steps.items(), key=lambda kv: -len(kv[1]))
    classes, bases_l, order_parts = [], [], []
    slab_base = 0
    kept = 0
    for key, steps in ranked:
        if kept >= max_classes or len(steps) < MIN_CLASS_STEPS:
            for tiles, _a, _b in steps:
                res_tiles += list(tiles)
            continue
        kept += 1
        t_step, p0, a_offs, b_offs = key
        ar = max(a_offs) + 1
        br = max(b_offs) + 1
        bases = np.empty(2 * len(steps), np.int32)
        for si, (tiles, a0, b0) in enumerate(steps):
            bases[2 * si] = a0
            bases[2 * si + 1] = b0
            order_parts.append(tiles)
        classes.append((t_step, p0, int(ar), int(br),
                        tuple(int(x) for x in a_offs),
                        tuple(int(x) for x in b_offs), slab_base))
        bases_l.append(bases)
        slab_base += len(steps) * t_step

    res_tiles = np.asarray(sorted(res_tiles), np.int64)
    n_res = len(res_tiles)
    if n_res:
        rpos = np.zeros(n_tiles, np.int64)
        rpos[res_tiles] = np.arange(n_res)
        rsel = np.isin(segn, res_tiles)
        res_pa = pan[rsel].astype(np.int32)
        res_pb = pbn[rsel].astype(np.int32)
        res_seg = (slab_base + rpos[segn[rsel]]).astype(np.int32)
        order_parts.append(res_tiles)
    else:
        res_pa = np.zeros(0, np.int32)
        res_pb = np.zeros(0, np.int32)
        res_seg = np.zeros(0, np.int32)
    slab_rows = slab_base + n_res
    order = (np.concatenate(order_parts) if order_parts
             else np.zeros(0, np.int64))
    c_cap = max(256, -(-slab_rows // 256) * 256)

    def dev(x):
        return torch.from_numpy(x).to(device)

    return StencilPlan(
        classes=tuple(classes), class_bases=tuple(dev(b) for b in bases_l),
        res_pa=dev(res_pa), res_pb=dev(res_pb), res_seg=dev(res_seg),
        n_res_tiles=n_res, order=order, c_cap=c_cap, n_tiles=n_tiles,
        coverage=1.0 - len(res_pa) / max(1, n_pairs),
        class_tables=class_tables(classes, device),
        plan_tables=plan_tables(classes, bases_l, device))


# --------------------------------------------------------------------------
# plain PyTorch versions of the class calls

PLAIN_PAIRS = 1024      # pairs per batched product of the plain class call


def class_call_plain(c_num, c_pat, a_dense, b_dense, ab_bases, t, p, a_offs,
                     b_offs, base, precision: str = "highest"):
    """One class into slab rows [base, base + n_steps*t), in place: for step
    s and tile tt, row base + s*t + tt = the sum over the tile's pairs of
    A[a0_s + a_off] @ B[b0_s + b_off] on operands rounded as ``precision``
    says (ops.macro.round_operands), and the flag of the same sum over the
    raw 0/1 patterns.  The plain version of both class kernels (ragged or
    uniform p); serves CPU tensors and is the kernels' parity oracle."""
    require_full_fp32()
    precision_code(precision)
    dev = a_dense.device
    p_list = p_list_of(t, p)
    n_p = sum(p_list)
    n_steps = ab_bases.shape[0] // 2
    bases = ab_bases.reshape(n_steps, 2).long()
    ao = torch.as_tensor(a_offs, dtype=torch.long, device=dev)
    bo = torch.as_tensor(b_offs, dtype=torch.long, device=dev)
    tile_of = torch.repeat_interleave(
        torch.arange(t, device=dev),
        torch.as_tensor(p_list, dtype=torch.long, device=dev))
    per = max(1, PLAIN_PAIRS // n_p)
    for s0 in range(0, n_steps, per):
        b = bases[s0:s0 + per]
        s = b.shape[0]
        ad = a_dense[(b[:, :1] + ao[None, :]).reshape(-1)]
        bd = b_dense[(b[:, 1:] + bo[None, :]).reshape(-1)]
        prod = torch.bmm(round_operands(ad, precision),
                         round_operands(bd, precision)).reshape(
            s, n_p, TILE, TILE)
        pat = torch.bmm((ad != 0).float(), (bd != 0).float()).reshape(
            s, n_p, TILE, TILE)
        num = torch.zeros((s, t, TILE, TILE), dtype=c_num.dtype, device=dev)
        cnt = torch.zeros((s, t, TILE, TILE), dtype=torch.float32,
                          device=dev)
        num.index_add_(1, tile_of, prod)
        cnt.index_add_(1, tile_of, pat)
        lo = base + s0 * t
        c_num[lo:lo + s * t] = num.reshape(s * t, TILE, TILE)
        c_pat[lo:lo + s * t] = (cnt > 0).reshape(s * t, TILE, TILE).to(
            c_pat.dtype)
    return c_num, c_pat


def classes_call_plain(c_num, c_pat, a_dense, b_dense, plan: StencilPlan,
                       precision: str = "highest"):
    """Every class of ``plan`` into its slab rows, in place: the plain
    version of the one launch over all classes (``macro_kernels.
    classes_call``), one ``class_call_plain`` a class."""
    for (t, p, _ar, _br, a_offs, b_offs, base), bases in zip(
            plan.classes, plan.class_bases):
        class_call_plain(c_num, c_pat, a_dense, b_dense, bases, t, p,
                         a_offs, b_offs, base, precision)
    return c_num, c_pat


def _residual_add(c_num, c_pat, a_dense, b_dense, pa, pb, seg, row0, n_rows,
                  chunk, precision: str = "highest", tile_masks=None):
    """The residual pairs into slab rows [row0, row0 + n_rows), in place.
    No class writes those rows, so the pair stream (sorted by slab row) is
    accumulated into a buffer of n_rows tiles that is then copied in: by
    the pair-stream kernel for CUDA tiles, by ``accumulate_macro`` for CPU
    tiles (``macro_kernels.accumulate_macro_pairs`` decides by the device);
    pairs whose seg is past the range (the padding) are dropped."""
    from pem_spgemm_tpu_torch.ops.macro_kernels import accumulate_macro_pairs
    num, flags = accumulate_macro_pairs(a_dense, b_dense, pa, pb, seg - row0,
                                        n_rows, chunk=chunk,
                                        acc_dtype=c_num.dtype,
                                        precision=precision,
                                        tile_masks=tile_masks)
    c_num[row0:row0 + n_rows] = num
    c_pat[row0:row0 + n_rows] = flags
    return c_num, c_pat


def stencil_accumulate(a_dense, b_dense, plan: StencilPlan,
                       macro_chunk: int = 256, precision: str = "highest",
                       tile_masks=None):
    """Full macro accumulation: every class in one call + the residual pair
    stream, both at ``precision``.

    Returns (c_num (c_cap,128,128) f32, c_flags (c_cap,128,128) uint8) in
    SLAB order (plan.order maps slab row -> sorted-tile index).  Every slab
    row is written exactly once: by its class, by the residual path, or (the
    rows past the last real one) by the zero fill.  CUDA tables go through
    one launch of the class kernel over all of the plan's classes, CPU
    tables through ``classes_call_plain`` (ops/macro_kernels.classes_call
    decides by the tensors' device).  ``tile_masks``: the tables'
    ``TileMasks``, made where the operands keep them
    (``MacroMatrix.tile_masks``, as StencilMacroPlan.run passes them);
    without it, on the card, the two launches share one made by the
    first.
    """
    from pem_spgemm_tpu_torch.ops.macro_kernels import TileMasks, classes_call
    dev = a_dense.device
    masks = tile_masks
    if masks is None and a_dense.is_cuda:
        masks = TileMasks(a_dense, b_dense)
    c_num = torch.empty((plan.c_cap, TILE, TILE), dtype=torch.float32,
                        device=dev)
    c_pat = torch.empty((plan.c_cap, TILE, TILE), dtype=torch.uint8,
                        device=dev)
    slab_rows = len(plan.order)
    c_num[slab_rows:].zero_()
    c_pat[slab_rows:].zero_()
    classes_call(c_num, c_pat, a_dense, b_dense, plan, precision=precision,
                 tile_masks=masks)
    n_res_pairs = plan.res_pa.shape[0]
    if n_res_pairs:
        p_cap = max(macro_chunk, -(-n_res_pairs // macro_chunk) * macro_chunk)
        pad = p_cap - n_res_pairs

        def padded(x, fill):
            return torch.cat([x, torch.full((pad,), fill, dtype=torch.int32,
                                            device=dev)])

        _residual_add(c_num, c_pat, a_dense, b_dense,
                      padded(plan.res_pa, a_dense.shape[0] - 1),
                      padded(plan.res_pb, b_dense.shape[0] - 1),
                      padded(plan.res_seg, plan.c_cap),
                      slab_rows - plan.n_res_tiles, plan.n_res_tiles,
                      macro_chunk, precision, masks)
    return c_num, c_pat
