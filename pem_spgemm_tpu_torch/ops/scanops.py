"""Scan helpers: segment ids from offsets (the binned planner, the pair
expansion) and the packed 16+16-bit sort key of the Macro128 engine."""

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


# 16-bit packed lexicographic sort keys ------------------------------------

PACK_LIMIT = 1 << 16
_SIGN = -0x80000000


def can_pack(n_hi: int, n_lo: int) -> bool:
    """True when fields in [0, n_hi) x [0, n_lo) pack losslessly AND the
    all-ones sentinel (0xFFFF, 0xFFFF) stays reserved for padding."""
    return n_hi < PACK_LIMIT and n_lo < PACK_LIMIT


def pack_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) int32 -> one int32 whose SIGNED order equals the
    lexicographic order of the unsigned fields (sign-bit flip)."""
    return ((hi << 16) | (lo & 0xFFFF)) ^ _SIGN


def unpack_key(key: torch.Tensor):
    k = key ^ _SIGN
    return (k >> 16) & 0xFFFF, k & 0xFFFF
