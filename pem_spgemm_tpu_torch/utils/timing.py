"""Per-phase wall timing.

The reference brackets every phase with cudaEvent pairs plus wall timers.
Here a phase is timed on the host clock around work that ends in a device
synchronise: CUDA launches are asynchronous, so a phase's cost is only
observable at a sync point.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _first_tensor(obj):
    if isinstance(obj, torch.Tensor):
        return obj
    if isinstance(obj, (tuple, list)):
        for x in obj:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def force_sync(obj) -> None:
    """Wait until the device that holds `obj` has finished its queued
    work: torch.cuda.synchronize() for a CUDA tensor (or the first tensor
    leaf of a tuple/list), a no-op for CPU tensors."""
    t = _first_tensor(obj)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class PhaseTimers:
    """Accumulates named phase durations (seconds) across iterations.

    `detail` gates the per-phase device syncs: a phase boundary is only
    observable at a sync point, and each sync stalls the host until the
    device drains, which the reference's cudaEvent timestamps never pay.
    The harness records phase detail on the FIRST timed repeat only and
    lets the remaining repeats run with just the pipeline's own mandatory
    size-feedback syncs, so the wall-time headline is not inflated by
    instrumentation.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.per_iter = defaultdict(list)
        self.detail = True

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a block; if `sync` is given, block on it before stopping.

        With detail off, the block runs unsynced and unrecorded (its cost
        lands in the caller's wall time only)."""
        if not self.detail:
            yield {}
            return
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            obj = box.get("sync", sync)
            if obj is not None:
                force_sync(obj)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.per_iter[name].append(dt)

    def per_iteration(self, name: str, n_iters: int):
        """Per-iteration durations when a phase may be entered several times
        per iteration (the same number of times each iteration)."""
        xs = self.per_iter.get(name, [])
        if not xs or n_iters <= 0 or len(xs) % n_iters:
            return xs
        k = len(xs) // n_iters
        return [sum(xs[i * k:(i + 1) * k]) for i in range(n_iters)]

    def mean(self, name: str, n_iters: int = 0) -> float:
        xs = self.per_iteration(name, n_iters) if n_iters else \
            self.per_iter.get(name, [])
        return sum(xs) / len(xs) if xs else 0.0

    def min(self, name: str, n_iters: int = 0) -> float:
        xs = self.per_iteration(name, n_iters) if n_iters else \
            self.per_iter.get(name, [])
        return min(xs) if xs else 0.0

    def pick(self, name: str, fastest: bool, n_iters: int = 0) -> float:
        """Mean across repeats, or min with fastest=True (reference -DFASTEST)."""
        return self.min(name, n_iters) if fastest else self.mean(name, n_iters)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.per_iter.clear()
