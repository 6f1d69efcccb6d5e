"""Steady-state plans: the multiply with its structure already planned.

Ported: the binned element engine's adapter (one CUDA graph a multiply on
the GPU), the merge element engine's plan (``ElementPlan``, the f64 parity
mode's), the DIA branch (a DIA plan is already fixed-step, ops/dia.DiaPlan)
and the two plans of the Macro128 engine.
"""

from __future__ import annotations

import dataclasses

import torch

from pem_spgemm_tpu_torch.formats.macro import macro_operands


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
    # the captured graph, its static BinnedStream and overflow flag, and the
    # kernel launches of one multiply (counted while capturing)
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
        return self._graph.get("stream")

    @property
    def launches(self):
        """Kernel launches of one multiply, by entry, recorded at capture
        (a replay does not pass through the wrappers' counters)."""
        return dict(self._graph.get("launches", {}))

    def capture(self):
        """Multiply eagerly once, with any host synchronisation an error
        (it would break the capture), then capture one multiply.  Runs on
        the current device, which ``run`` sets to the plan's."""
        from pem_spgemm_tpu_torch.ops import segment_sort as ss
        from pem_spgemm_tpu_torch.ops.binned import binned_multiply
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                binned_multiply(self.plan, vmem_sort=self.vmem_sort)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream().wait_stream(side)
        before = dict(ss.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            stream = binned_multiply(self.plan, vmem_sort=self.vmem_sort)
            overflow = torch.zeros((), dtype=torch.bool,
                                   device=stream.c_nnz.device)
        self._graph.update(
            graph=graph, stream=stream, overflow=overflow,
            launches={k: v - before[k] for k, v in ss.LAUNCHES.items()})

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
            self._graph["graph"].replay()
        return self._graph["stream"].c_nnz, self._graph["overflow"]


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
    """Macro fixed step through the class kernels (ops/stencil.py).

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

    def grown(self):
        return self

    def fence(self, out):
        """cptr is derived from the flags on the device, unlike c_tile_row /
        c_tile_col, which are precomputed constants."""
        return out[4]

    def run(self, a, b):
        from pem_spgemm_tpu_torch.ops.macro import macro_structure
        from pem_spgemm_tpu_torch.ops.stencil import stencil_accumulate
        am, bm = macro_operands(a, b)
        c_dense, c_flags = stencil_accumulate(am.dense, bm.dense, self.plan,
                                              self.macro_chunk)
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

    def grown(self):
        """Next-size plan after an overflow trip (double every capacity)."""
        return dataclasses.replace(self, p_cap=self.p_cap * 2,
                                   c_cap=self.c_cap * 2)

    def fence(self, out):
        return out[4]                         # cptr

    def run(self, a, b):
        """(c_tile_row, c_tile_col, c_dense, c_flags, cptr, c_nnz,
        overflow), with no device-to-host copy."""
        from pem_spgemm_tpu_torch.ops.macro import macro_spgemm_fixed
        am, bm = macro_operands(a, b)
        return macro_spgemm_fixed(
            am.tile_row, am.tile_col, am.dense,
            bm.tile_rowptr, bm.tile_col, bm.dense, am.ntiles,
            p_cap=self.p_cap, c_cap=self.c_cap, chunk=self.chunk,
            acc_dtype=self.acc_dtype,
            packed_coords=am.n_macro_rows < (1 << 15))


def _try_stencil_plan(config, a, b):
    """Stencil macro plan when the pair structure repeats enough: the
    periodic-diagonal planner first, the per-row run planner where that
    covers under 0.9 of the pairs, None where neither covers 0.6."""
    import numpy as np
    from pem_spgemm_tpu_torch.ops import stencil as st
    from pem_spgemm_tpu_torch.ops import symbolic
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
        n_pairs=n_pairs, planner=planner)


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
        from pem_spgemm_tpu_torch.config import round_up_pow2
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
                         chunk=config.macro_chunk, acc_dtype=config.acc())
    from pem_spgemm_tpu_torch.ops.spgemm import not_ported
    raise not_ported(result.engine)
