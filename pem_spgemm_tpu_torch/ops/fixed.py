"""Steady-state plans: the multiply with its structure already planned.

Ported: the binned element engine's adapter and the DIA branch (a DIA
plan is already fixed-step, ops/dia.DiaPlan).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BinnedElementPlan:
    """Fixed-step adapter for the binned element engine (ops/binned.py).

    The plan arrays are exact-structure (no capacities to overflow): the
    binning derives every bucket from the true chunk counts, so `overflow`
    is constantly False; a sparsity change requires re-planning, which the
    harness does per matrix.
    """

    plan: object            # ops.binned.BinnedPlan
    vmem_sort: bool = False  # kernel sort+dedup for sort-path buckets

    def grown(self):
        return self

    def fence(self, out):
        return out[0]                         # c_nnz depends on every stream

    def run(self, a, b):
        """Dispatch the planned multiply; returns (c_nnz_device, overflow).
        The c_nnz scalar depends on every stream, so syncing it fences the
        whole multiply."""
        from pem_spgemm_tpu_torch.ops.binned import binned_multiply
        stream = binned_multiply(self.plan, vmem_sort=self.vmem_sort)
        return stream.c_nnz, torch.zeros((), dtype=torch.bool,
                                         device=stream.c_nnz.device)


def make_plan(result, config, a, b):
    """Build a steady-state plan from an interactive SpGEMMResult."""
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
    from pem_spgemm_tpu_torch.ops.spgemm import not_ported
    raise not_ported(result.engine)
