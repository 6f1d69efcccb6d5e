"""Scan helpers: segment ids from offsets (the binned planner, the pair
expansion), the forward fills and the log-depth scan of the merge element
engine (ops/element.py), and the packed 16+16-bit sort key of the Macro128
engine."""

from __future__ import annotations

import torch


def fori_scan(combine, xs, identities, rounds=None):
    """Inclusive scan of ``combine`` over the tuple of 1-D tensors ``xs``.

    Hillis-Steele, as the JAX package's: round r combines every slot with
    the slot 2^r before it (the identity where there is none), so after r
    rounds slot k holds the combination of the 2^r slots ending at k.
    ``combine((a1..ak), (b1..bk)) -> (c1..ck)`` must be associative;
    ``identities`` are left-identity scalars, one an array.  ``rounds``
    caps the passes where the caller bounds the dependency distance by
    2**rounds; None scans the full length.
    """
    n = xs[0].shape[0]
    full = max(1, (n - 1).bit_length())
    rounds = full if rounds is None else min(full, max(1, rounds))
    xs = tuple(xs)
    for r in range(rounds):
        sh = min(1 << r, n)
        left = tuple(
            torch.cat([torch.full((sh,), idv, dtype=x.dtype, device=x.device),
                       x[:n - sh]])
            for x, idv in zip(xs, identities))
        xs = tuple(combine(left, xs))
    return xs


# Forward fills: expand per-segment values to a product stream without a
# gather per product (one small scatter and one cumulative pass).

def fill_monotone_i32(starts, values, total_cap: int):
    """stream[k] = values[s] for the largest s with starts[s] <= k.

    Requires ``values`` nondecreasing in s (rows, offsets, ...).  Exact:
    scatter per-segment deltas at the start positions, cumulative-sum.
    Empty segments (duplicate starts) resolve to the largest s (the
    scatter-add accumulates all deltas at the shared position).
    """
    deltas = torch.cat([values[:1], values[1:] - values[:-1]])
    st = starts.clamp(max=total_cap).long()
    acc = torch.zeros(total_cap + 1, dtype=torch.int32, device=values.device)
    acc.index_add_(0, st, deltas.to(torch.int32))
    return torch.cumsum(acc[:-1], 0, dtype=torch.int32)


def fill_any_multi(starts, value_bits_tuple, total_cap: int, rounds=None):
    """Forward-fill several per-segment int32 bit patterns in one scan.

    stream_j[k] = value_bits_tuple[j][s] for the largest s with
    starts[s] <= k.  Exact for any bit pattern (float32 travels as its
    int32 view).  Each segment's bits are scattered at its start position
    (``starts`` nondecreasing, so the duplicate starts of empty segments
    are adjacent and only the last of them is kept), then ONE scan over the
    (guard, bits...) tuple keeps the entry with the larger guard (the most
    recent start).
    """
    dev = starts.device
    st = starts.clamp(max=total_cap)
    last_of_start = torch.ones_like(st, dtype=torch.bool)
    last_of_start[:-1] = st[1:] != st[:-1]
    st_eff = torch.where(last_of_start, st, total_cap).long()
    guard = torch.full((total_cap + 1,), -1, dtype=torch.int32, device=dev)
    guard[st_eff] = st.to(torch.int32)
    bits = []
    for vb in value_bits_tuple:
        x = torch.zeros(total_cap + 1, dtype=torch.int32, device=dev)
        x[st_eff] = vb.to(torch.int32)
        bits.append(x[:-1])

    def comb(a, b):
        take_b = b[0] >= a[0]
        return tuple(torch.where(take_b, xb, xa) for xa, xb in zip(a, b))

    out = fori_scan(comb, (guard[:-1], *bits), (-1,) + (0,) * len(bits),
                    rounds=rounds)
    return out[1:]


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
