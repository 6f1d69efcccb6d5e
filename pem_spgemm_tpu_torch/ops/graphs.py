"""One multiply captured as a CUDA graph: what the steady plans share.

The binned element plan (ops/fixed.BinnedElementPlan), the DIA plan
(ops/dia.DiaPlan) and the Tile16 plan (ops/fixed.SpGEMMPlan) each replay one
CUDA graph a multiply on the GPU, the counterpart of the JAX package's one
jitted dispatch.  ``capture`` runs the
multiply eagerly once on a side stream with any host synchronisation an
error (it would break the capture), then captures one multiply and records
the kernel launches it made.  A replay passes no wrapper, so its wrappers'
counters do not see it: ``Captured.replay`` adds the launches recorded at
capture to ``REPLAYED`` instead, once a replay.  A graph captured with a
``name`` (the Tile16 step) also adds one under that name a replay.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# kernel launches made by graph replays, by kernel entry (the wrappers'
# LAUNCHES count the launches they make themselves, and nothing else), and
# the replays of each named graph, by its name
REPLAYED: dict = {}


def reset_replayed() -> None:
    REPLAYED.clear()


@dataclasses.dataclass
class Captured:
    """A captured multiply: its graph, the static outputs every replay
    writes, the kernel launches of one multiply, by entry, and the name its
    replays are counted under (None: not counted)."""

    graph: torch.cuda.CUDAGraph
    out: object
    launches: dict
    name: Optional[str] = None

    def replay(self):
        """Replay the multiply; returns its static outputs."""
        self.graph.replay()
        for k, v in self.launches.items():
            if v:
                REPLAYED[k] = REPLAYED.get(k, 0) + v
        if self.name is not None:
            REPLAYED[self.name] = REPLAYED.get(self.name, 0) + 1
        return self.out


def capture(multiply, counts: dict, name: Optional[str] = None) -> Captured:
    """Run ``multiply()`` eagerly once on a side stream with host syncs an
    error, then capture one call of it.  ``counts`` is its kernels'
    wrapper counter (e.g. ``dia_kernels.LAUNCHES``; ``{}`` for a multiply
    that launches none): the capture's launches are read from it; ``name``
    counts the replays.  Runs on the current device; a capture that fails
    raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(side):
            multiply()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream().wait_stream(side)
    before = dict(counts)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = multiply()
    return Captured(graph, out,
                    {k: v - before[k] for k, v in counts.items()}, name)
