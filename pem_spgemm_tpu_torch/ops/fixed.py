"""Steady-state plans: the multiply with its structure already planned.

Counterpart of the JAX package's ops/fixed.py: the Tile16 step
(``spgemm_fixed``, ``SpGEMMPlan``: one CUDA graph a multiply on the GPU),
the binned element engine's adapter (one CUDA graph a multiply on the GPU),
the merge element engine's plan (``ElementPlan``, the f64 parity mode's),
the DIA branch (a DIA plan is already fixed-step, and replays one CUDA graph
a multiply on the GPU: ops/dia.DiaPlan) and the two plans of the Macro128
engine.
"""

from __future__ import annotations

import dataclasses

import torch

from pem_spgemm_tpu_torch.config import round_up_pow2
from pem_spgemm_tpu_torch.formats.macro import macro_operands
from pem_spgemm_tpu_torch.ops import cstruct, numeric, symbolic
from pem_spgemm_tpu_torch.ops.scanops import can_pack


def spgemm_fixed(a_tile_row, a_tile_col, a_flat,
                 b_tile_rowptr, b_tile_col, b_flat,
                 ntiles_a: int, *, p_cap: int, c_cap: int, c_nnz_cap: int,
                 chunk: int, acc_dtype=torch.float32,
                 precision: str = "highest", packed: bool = False,
                 packed_coords: bool = False):
    """The fused-engine Tile16 SpGEMM at fixed capacities, with no
    device-to-host copy (every size stays a device scalar).

    Operands arrive as tile structure + dense flat value tables
    (``TiledMatrix.dense_flat()``).  The step covers pair expansion, fused
    numeric + structural accumulation, masks and nnz, intra-tile
    coordinates and the compressed tile-major values, in acc_dtype.  On the
    card the accumulation writes C's masks itself (the Tile16 kernel's
    masks form: no count table, no ``counts_to_masks``) and one structure
    kernel enumerates C's bits and gathers their values.

    Returns (c_tile_row, c_tile_col, cmask, cptr, c_rowcol, c_elem_tile,
    c_vals, c_nnz, overflow).  ``overflow`` is a device bool, True when a
    capacity was exceeded (pairs, C tiles or C nnz): the result is then
    truncated and the caller must re-plan with larger capacities (the
    harness does).
    """
    offsets = symbolic.pair_counts(a_tile_col, b_tile_rowptr, ntiles_a)
    total = offsets[-1]
    c_row, c_col, a_idx, b_idx, c_tile_id, cnt_c = symbolic.expand_pairs(
        offsets, a_tile_row, a_tile_col, b_tile_rowptr, b_tile_col,
        total.clamp(max=p_cap), p_cap, packed)
    c_dense, cmask, cptr = numeric.accumulate_fused_masks(
        a_flat, b_flat, a_idx, b_idx, c_tile_id, c_cap, chunk, acc_dtype,
        precision)
    del a_idx, b_idx
    c_tile_row, c_tile_col = cstruct.c_tile_coords(
        c_tile_id, c_row, c_col, c_cap, packed_coords)
    del c_row, c_col, c_tile_id
    c_rowcol, c_elem_tile, c_vals = cstruct.c_rowcol_values(
        cmask, cptr, c_nnz_cap, c_dense)
    c_nnz = cptr[-1]
    overflow = (total > p_cap) | (cnt_c > c_cap) | (c_nnz > c_nnz_cap)
    return (c_tile_row, c_tile_col, cmask, cptr, c_rowcol, c_elem_tile,
            c_vals, c_nnz, overflow)


@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    """Static capacities of the Tile16 step, learned from one interactive
    run.

    On the GPU the step is ONE CUDA graph, the counterpart of the JAX
    package's one jitted ``spgemm_fixed``: the first ``run`` on a pair of
    operands multiplies eagerly once with any host synchronisation an error,
    then captures one multiply (``ops.graphs.capture``, replays counted
    under ``"spgemm_fixed"`` in ``ops.graphs.REPLAYED``, and the Tile16
    kernels' launches recorded at capture added there once a replay);
    every later run on them is one replay.  The dense value tables are
    made outside the graph (cached on the operands).  A graph reads fixed
    addresses: the plan keeps the operand tensors it captured on, and a
    run on others captures again.  A replay writes its outputs into the
    same memory every time: it overwrites the outputs of the replay
    before.  A grown plan starts with
    no graph and captures again.  CPU plans run eagerly.
    """

    p_cap: int
    c_cap: int
    c_nnz_cap: int
    chunk: int
    packed: bool
    acc_dtype: object
    precision: str
    # "captured": the captured step (ops.graphs.Captured); "operands": the
    # tensors it reads, with their operand_key
    _graph: dict = dataclasses.field(default_factory=dict, init=False,
                                     compare=False, repr=False)

    def fence(self, out):
        return out[6]                         # c_vals

    def grown(self):
        """Next-size plan after an overflow trip (double every capacity)."""
        return dataclasses.replace(self, p_cap=self.p_cap * 2,
                                   c_cap=self.c_cap * 2,
                                   c_nnz_cap=self.c_nnz_cap * 2)

    def _operands(self, a, b):
        return (a.tile_row, a.tile_col, a.dense_flat(),
                b.tile_rowptr, b.tile_col, b.dense_flat())

    def multiply(self, a, b):
        """The step, eagerly (what a replay is held to)."""
        return spgemm_fixed(
            *self._operands(a, b), a.ntiles, p_cap=self.p_cap,
            c_cap=self.c_cap, c_nnz_cap=self.c_nnz_cap, chunk=self.chunk,
            acc_dtype=self.acc_dtype, precision=self.precision,
            packed=self.packed,
            packed_coords=self.packed and a.n_tile_rows < (1 << 15))

    def run(self, a, b):
        """(c_tile_row, c_tile_col, cmask, cptr, c_rowcol, c_elem_tile,
        c_vals, c_nnz, overflow), with no device-to-host copy."""
        if not a.vals.is_cuda:
            return self.multiply(a, b)
        from pem_spgemm_tpu_torch.ops import graphs, tile16_kernels
        from pem_spgemm_tpu_torch.ops.dia import operand_key, same_operand
        ops = self._operands(a, b)
        g = self._graph
        with torch.cuda.device(a.vals.device):
            if not g or not all(same_operand(h, x)
                                for h, x in zip(g["operands"], ops)):
                g.clear()               # the old graph and its operands go
                g["captured"] = graphs.capture(
                    lambda: self.multiply(a, b), tile16_kernels.LAUNCHES,
                    name="spgemm_fixed")
                g["operands"] = tuple((x, operand_key(x)) for x in ops)
            return g["captured"].replay()


@dataclasses.dataclass(frozen=True)
class BinnedElementPlan:
    """Fixed-step adapter for the binned element engine (ops/binned.py).

    The plan arrays are exact-structure (no capacities to overflow): the
    binning derives every bucket from the true chunk counts, so `overflow`
    is constantly False; a sparsity change requires re-planning, which the
    harness does per matrix.

    On the GPU the multiply is ONE CUDA graph, the counterpart of the JAX
    package's ``_binned_multiply_fused`` (one jitted program a multiply):
    the first ``run`` multiplies eagerly once (that builds the kernel
    libraries and warms the allocator), then captures one multiply; every
    later ``run`` is one replay.  The graph reads the plan's arrays where
    they lie, so values changed in place are seen by the next replay, and
    it writes its outputs into the same memory every time: a replay
    overwrites the stream (and c_nnz) of the replay before.  CPU plans run
    eagerly.
    """

    plan: object            # ops.binned.BinnedPlan
    vmem_sort: bool = False  # kernel sort+dedup for sort-path buckets
    # "captured": the captured multiply (ops.graphs.Captured: its graph,
    # static BinnedStream and launches); "overflow": the constant flag, made
    # once outside the graph
    _graph: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def grown(self):
        return self

    def fence(self, out):
        return out[0]                         # c_nnz depends on every stream

    @property
    def stream(self):
        """The static BinnedStream the replays write (None before the
        first GPU run)."""
        captured = self._graph.get("captured")
        return None if captured is None else captured.out

    @property
    def launches(self):
        """Kernel launches of one multiply, by entry, recorded at capture
        (a replay does not pass through the wrappers' counters)."""
        captured = self._graph.get("captured")
        return {} if captured is None else dict(captured.launches)

    def capture(self):
        """Multiply eagerly once, with any host synchronisation an error
        (it would break the capture), then capture one multiply
        (``ops.graphs.capture``).  Runs on the current device, which
        ``run`` sets to the plan's."""
        from pem_spgemm_tpu_torch.ops import graphs
        from pem_spgemm_tpu_torch.ops import segment_sort as ss
        from pem_spgemm_tpu_torch.ops.binned import binned_multiply
        captured = graphs.capture(
            lambda: binned_multiply(self.plan, vmem_sort=self.vmem_sort),
            ss.LAUNCHES)
        self._graph.update(
            captured=captured,
            overflow=torch.zeros((), dtype=torch.bool,
                                 device=captured.out.c_nnz.device))

    def run(self, a, b):
        """Dispatch the planned multiply; returns (c_nnz_device, overflow).
        The c_nnz scalar depends on every stream, so syncing it fences the
        whole multiply."""
        if not self.plan.table.is_cuda:
            from pem_spgemm_tpu_torch.ops.binned import binned_multiply
            stream = binned_multiply(self.plan, vmem_sort=self.vmem_sort)
            return stream.c_nnz, torch.zeros((), dtype=torch.bool)
        with torch.cuda.device(self.plan.table.device):
            if not self._graph:
                self.capture()
            stream = self._graph["captured"].replay()
        return stream.c_nnz, self._graph["overflow"]


@dataclasses.dataclass(frozen=True)
class ElementPlan:
    """Static capacities for the merge element engine's fixed step
    (ops/element.py)."""

    p_cap: int
    c_cap: int
    fill_rounds: object = None
    merge_rounds: object = None
    sum_rounds: object = None
    wide: bool = False      # >4-byte dtype: the gather-based wide step

    def grown(self):
        """Next-size plan after an overflow trip (double every capacity)."""
        return dataclasses.replace(self, p_cap=self.p_cap * 2,
                                   c_cap=self.c_cap * 2)

    def fence(self, out):
        return out[2]                         # vals

    def run(self, a, b):
        """C stream form (rows, cols, vals, first, c_nnz, overflow), with
        no device-to-host copy.  The wide step keeps the values' dtype end
        to end: the float32 merge pipeline moves value bits as float32 and
        would downcast."""
        from pem_spgemm_tpu_torch.ops.element import (element_fixed,
                                                      element_fixed_wide)
        b_rowptr, _b_rows, b_cols, b_vals = b.element_csr()
        a_rows, a_cols = a.element_coords()
        if self.wide:
            return element_fixed_wide(
                a_rows, a_cols, a.vals, b_rowptr, b_cols, b_vals,
                p_cap=self.p_cap, c_cap=self.c_cap)
        return element_fixed(a_rows, a_cols, a.vals, b_rowptr, b_cols,
                             b_vals, p_cap=self.p_cap, c_cap=self.c_cap,
                             fill_rounds=self.fill_rounds,
                             merge_rounds=self.merge_rounds,
                             sum_rounds=self.sum_rounds)


@dataclasses.dataclass(frozen=True)
class StencilMacroPlan:
    """Macro fixed step through the class kernels (ops/stencil.py).  The
    Macro128 plans read bfloat16 tiles as their float32 copies
    (``MacroMatrix.acc_dense``) and emit float32 C.

    Built when the pair structure repeats enough (plan coverage >= 0.6); C
    arrays come out slab-ordered with precomputed slab-order tile
    coordinates.  Capacities are structure-exact, so overflow is constantly
    False (a sparsity change requires re-planning, which the harness does
    per matrix).
    """

    plan: object             # ops.stencil.StencilPlan
    c_tile_row: torch.Tensor  # (c_cap,) i32, slab order
    c_tile_col: torch.Tensor
    macro_chunk: int
    n_pairs: int
    planner: str             # "plan_stencil" | "plan_runs": who built it
    precision: str = "highest"   # of the class kernels and residual pairs

    def grown(self):
        return self

    def fence(self, out):
        """cptr is derived from the flags on the device, unlike c_tile_row /
        c_tile_col, which are precomputed constants."""
        return out[4]

    def run(self, a, b):
        """One steady multiply: on the card one class launch over all of
        the plan's classes, then the residual pairs, both reading the
        masks the operands keep (``MacroMatrix.tile_masks``: no masks
        launch while the operands are unchanged)."""
        from pem_spgemm_tpu_torch.ops.macro import macro_structure
        from pem_spgemm_tpu_torch.ops.macro_kernels import operand_masks
        from pem_spgemm_tpu_torch.ops.stencil import stencil_accumulate
        am, bm = macro_operands(a, b)
        c_dense, c_flags = stencil_accumulate(am.acc_dense(), bm.acc_dense(),
                                              self.plan, self.macro_chunk,
                                              self.precision,
                                              operand_masks(am, bm))
        cptr = macro_structure(c_flags)
        return (self.c_tile_row, self.c_tile_col, c_dense, c_flags, cptr,
                cptr[-1], torch.zeros((), dtype=torch.bool,
                                      device=c_dense.device))


@dataclasses.dataclass(frozen=True)
class MacroPlan:
    """Static capacities for the Macro128 engine's fixed step over the
    generic pair stream (the pair-stream kernel on the GPU)."""

    p_cap: int
    c_cap: int
    chunk: int
    acc_dtype: object
    precision: str = "highest"

    def grown(self):
        """Next-size plan after an overflow trip (double every capacity)."""
        return dataclasses.replace(self, p_cap=self.p_cap * 2,
                                   c_cap=self.c_cap * 2)

    def fence(self, out):
        return out[4]                         # cptr

    def run(self, a, b):
        """(c_tile_row, c_tile_col, c_dense, c_flags, cptr, c_nnz,
        overflow), with no device-to-host copy; the pair-stream launch
        reads the masks the operands keep (``MacroMatrix.tile_masks``)."""
        from pem_spgemm_tpu_torch.ops.macro import macro_spgemm_fixed
        from pem_spgemm_tpu_torch.ops.macro_kernels import operand_masks
        am, bm = macro_operands(a, b)
        return macro_spgemm_fixed(
            am.tile_row, am.tile_col, am.acc_dense(),
            bm.tile_rowptr, bm.tile_col, bm.acc_dense(), am.ntiles,
            p_cap=self.p_cap, c_cap=self.c_cap, chunk=self.chunk,
            acc_dtype=self.acc_dtype, precision=self.precision,
            packed_coords=am.n_macro_rows < (1 << 15),
            tile_masks=operand_masks(am, bm))


def _try_stencil_plan(config, a, b):
    """Stencil macro plan when the pair structure repeats enough: the
    periodic-diagonal planner first, the per-row run planner where that
    covers under 0.9 of the pairs, None where neither covers 0.6."""
    import numpy as np
    from pem_spgemm_tpu_torch.ops import stencil as st
    am, bm = macro_operands(a, b)
    dev = am.device
    offsets = symbolic.pair_counts(am.tile_col, bm.tile_rowptr, am.ntiles)
    n_pairs = int(offsets[-1])
    chunk = config.macro_chunk
    p_cap = max(chunk, -(-n_pairs // chunk) * chunk)
    c_row, c_col, a_idx, b_idx, seg, cnt = symbolic.expand_pairs(
        offsets, am.tile_row, am.tile_col, bm.tile_rowptr, bm.tile_col,
        n_pairs, p_cap, True)
    n_tiles = int(cnt)
    args = (seg, a_idx, b_idx, c_row, c_col, n_pairs, n_tiles,
            am.dense.shape[0], bm.dense.shape[0])
    plan, planner = st.plan_stencil(*args), "plan_stencil"
    if plan.coverage < 0.9:
        plan, planner = st.plan_runs(*args), "plan_runs"
    if plan.coverage < 0.6:
        return None
    # slab-order tile coordinates (host): sorted-order coords first
    first_rows = c_row[:n_pairs].cpu().numpy()
    first_cols = c_col[:n_pairs].cpu().numpy()
    counts = np.bincount(seg[:n_pairs].cpu().numpy(), minlength=n_tiles)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    tr_sorted = first_rows[np.minimum(starts, n_pairs - 1)]
    tc_sorted = first_cols[np.minimum(starts, n_pairs - 1)]
    ctr = np.full(plan.c_cap, 0x7FFFFFFF, np.int32)
    ctc = np.full(plan.c_cap, 0x7FFFFFFF, np.int32)
    real = plan.order < n_tiles
    ctr[:len(plan.order)][real] = tr_sorted[plan.order[real]]
    ctc[:len(plan.order)][real] = tc_sorted[plan.order[real]]
    return StencilMacroPlan(
        plan=plan, c_tile_row=torch.from_numpy(ctr).to(dev),
        c_tile_col=torch.from_numpy(ctc).to(dev), macro_chunk=chunk,
        n_pairs=n_pairs, planner=planner, precision=config.precision)


def make_plan(result, config, a, b):
    """Build a steady-state plan from an interactive SpGEMMResult."""

    def gran(n, g):
        return max(g, -(-int(n) // g) * g)

    if result.engine == "dia":
        # C structure is static given the offset sets: rebuild the plan
        # from the operands' offsets
        from pem_spgemm_tpu_torch.ops.dia import make_dia_plan
        return make_dia_plan(a, b)
    if result.engine == "element" and result.binned is not None:
        from pem_spgemm_tpu_torch.ops.binned import build_plan_device
        return BinnedElementPlan(
            plan=build_plan_device(a, b),
            vmem_sort=config.element_vmem_sort and a.vals.is_cuda)
    if result.engine == "element":
        # the merge engine: capacities from the interactive run, scan
        # depths bounded on the host
        import numpy as np
        from pem_spgemm_tpu_torch.ops.element import scan_round_bounds
        b_rowptr = b.element_csr()[0].cpu().numpy()
        a_rows, a_cols = (x.cpu().numpy() for x in a.element_coords())
        fr, mr, sr = scan_round_bounds(a_rows, a_cols, np.diff(b_rowptr))
        return ElementPlan(
            p_cap=gran(result.n_pairs, config.numeric_chunk),
            c_cap=round_up_pow2(max(1, result.c_nnz)),
            fill_rounds=fr, merge_rounds=mr, sum_rounds=sr,
            wide=config.dtype.itemsize > 4)
    if result.engine == "macro":
        # the class kernels serve float32 tiles on the GPU; CPU operands (and
        # structure that neither planner covers) take the generic pair
        # stream, as the reference does off its accelerator
        am, _bm = macro_operands(a, b)
        if am.dense.is_cuda and config.acc() == torch.float32:
            sp = _try_stencil_plan(config, a, b)
            if sp is not None:
                return sp
        return MacroPlan(p_cap=gran(result.n_pairs, config.macro_chunk),
                         c_cap=gran(result.c_ntiles, 256),
                         chunk=config.macro_chunk, acc_dtype=config.acc(),
                         precision=config.precision)
    return SpGEMMPlan(
        p_cap=gran(result.n_pairs, config.numeric_chunk),
        c_cap=gran(result.c_ntiles, 1024),
        c_nnz_cap=round_up_pow2(max(1, result.c_nnz)),
        chunk=config.numeric_chunk,
        packed=can_pack(a.n_tile_rows, b.n_tile_cols),
        acc_dtype=config.acc(), precision=config.precision)
