"""Scan helpers.  Only what the binned planner needs is ported so far."""

from __future__ import annotations

import torch


def segment_ids_from_offsets(offsets: torch.Tensor, total_cap: int):
    """offsets: (n_seg+1,) exclusive scan. Returns (total_cap,) i32 segment
    id per slot: id[k] = the segment s with offsets[s] <= k < offsets[s+1].

    Slots beyond offsets[-1] get id >= n_seg (clamp/mask downstream).
    Empty segments are handled: several segments starting at one slot
    accumulate in the scatter-add, so the cumsum skips them correctly.
    """
    starts = offsets[:-1].clamp(max=total_cap).long()
    ind = torch.zeros(total_cap + 1, dtype=torch.int32,
                      device=offsets.device)
    ind.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    return torch.cumsum(ind[:-1], 0, dtype=torch.int32) - 1
