"""Macro128 engine: SpGEMM as batched dense 128x128 tile products.

Counterpart of the JAX package's ops/macro.py.  Pipeline: pair expansion
sorted by C tile, fused numeric + 0/1 structural accumulation, exact-nnz
structure.  C tiles are dense (c_cap, 128, 128) and written once.

``accumulate_macro`` is the plain PyTorch accumulation (a chunked batched
product and a scatter-add): it is the interactive path on every device, the
version a CPU tensor takes, and the parity oracle of the pair-stream kernel
(ops/macro_kernels.accumulate_macro_pairs), which carries the steady path
on the GPU.

Structural counts are returned as **uint8 flags** (1 where at least one
product of two stored entries lands, else 0): downstream reads only
``count > 0``, a flag is a quarter of a float32 count, and it cannot wrap.
"""

from __future__ import annotations

import torch

from pem_spgemm_tpu_torch.ops import symbolic

TILE = 128


def require_full_fp32() -> None:
    """The plain products below are the float32 reference of the kernels:
    they must not run in TF32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the Macro128 "
            "engine accumulates in full float32 (precision 'highest')")


def accumulate_macro(a_dense, b_dense, a_idx, b_idx, c_tile_id, c_cap: int,
                     chunk: int, acc_dtype=torch.float32):
    """Fused numeric + structural accumulation over macro-tile pairs.

    a_dense/b_dense: (T+1, 128, 128) tables (zero tile at T).  a_idx, b_idx,
    c_tile_id: (p_cap,) i32, p_cap a multiple of chunk; padding pairs carry
    c_tile_id >= c_cap and are dropped (they land in one scratch row).
    Returns (c_dense (c_cap,128,128) acc_dtype, c_flags (c_cap,128,128)
    uint8).  index_add_ on the GPU adds duplicates with atomics, so values
    differ from run to run within the float32 bound; the flags do not.
    """
    require_full_fp32()
    p_cap = a_idx.shape[0]
    assert p_cap % chunk == 0, (p_cap, chunk)
    dev = a_dense.device
    seg = c_tile_id.clamp(max=c_cap).long()
    c_dense = torch.zeros((c_cap + 1, TILE, TILE), dtype=acc_dtype,
                          device=dev)
    c_cnt = torch.zeros((c_cap + 1, TILE, TILE), dtype=torch.float32,
                        device=dev)
    for sl in range(0, p_cap, chunk):
        s_c = seg[sl:sl + chunk]
        ad = a_dense[a_idx[sl:sl + chunk].long()].to(acc_dtype)
        bd = b_dense[b_idx[sl:sl + chunk].long()].to(acc_dtype)
        c_dense.index_add_(0, s_c, torch.bmm(ad, bd))
        c_cnt.index_add_(0, s_c, torch.bmm((ad != 0).float(),
                                           (bd != 0).float()))
    return c_dense[:c_cap], (c_cnt[:c_cap] > 0).to(torch.uint8)


def macro_structure(c_flags):
    """Exact per-tile nnz scan from the structural flags (uint8, 0 or 1).

    Returns cptr (c_cap+1,) i32 with cptr[-1] = exact C nnz.

    ``sum`` with another result type than its input's first makes a copy of
    the whole input in that type (several GB for a flag slab), so the flags
    are summed as they lie: four to an int32 word, 64 words at a time, so no
    byte lane of a partial sum passes 64 and carries into its neighbour;
    the lanes of the small partial sums are then added up.
    """
    if c_flags.dtype != torch.uint8:
        raise TypeError(f"structural flags are uint8, got {c_flags.dtype}")
    c_cap = c_flags.shape[0]
    part = c_flags.contiguous().view(torch.int32).view(c_cap, 64, 64).sum(
        dim=2, dtype=torch.int32)
    per_tile = ((part & 0xFF) + ((part >> 8) & 0xFF) + ((part >> 16) & 0xFF)
                + (part >> 24)).sum(dim=1, dtype=torch.int32)
    return torch.cat([torch.zeros(1, dtype=torch.int32,
                                  device=c_flags.device),
                      torch.cumsum(per_tile, 0, dtype=torch.int32)])


def macro_spgemm_fixed(a_tile_row, a_tile_col, a_dense,
                       b_tile_rowptr, b_tile_col, b_dense, ntiles_a: int, *,
                       p_cap: int, c_cap: int, chunk: int,
                       acc_dtype=torch.float32, packed: bool = True,
                       packed_coords: bool = False):
    """The macro SpGEMM at fixed capacities, without size feedback (no
    device-to-host copy: every size stays a device scalar).

    The accumulation goes through ``macro_kernels.accumulate_macro_pairs``:
    the hand-written pair-stream kernel for CUDA tensors, ``accumulate_macro``
    for CPU tensors.  Returns (c_tile_row, c_tile_col, c_dense, c_flags,
    cptr, c_nnz, overflow); ``overflow`` True means a capacity was exceeded
    and the result is truncated: re-plan with larger caps (the harness does).
    """
    from pem_spgemm_tpu_torch.ops import cstruct
    from pem_spgemm_tpu_torch.ops.macro_kernels import accumulate_macro_pairs
    offsets = symbolic.pair_counts(a_tile_col, b_tile_rowptr, ntiles_a)
    total = offsets[-1]
    n_pairs = total.clamp(max=p_cap)
    c_row, c_col, a_idx, b_idx, c_tile_id, cnt = symbolic.expand_pairs(
        offsets, a_tile_row, a_tile_col, b_tile_rowptr, b_tile_col,
        n_pairs, p_cap, packed)
    c_dense, c_flags = accumulate_macro_pairs(
        a_dense, b_dense, a_idx, b_idx, c_tile_id, c_cap, chunk=chunk,
        acc_dtype=acc_dtype)
    c_tile_row, c_tile_col = cstruct.c_tile_coords(
        c_tile_id, c_row, c_col, c_cap, packed_coords)
    cptr = macro_structure(c_flags)
    overflow = (cnt > c_cap) | (total > p_cap)
    return c_tile_row, c_tile_col, c_dense, c_flags, cptr, cptr[-1], overflow


ASSEMBLE_TILES = 1 << 15        # C tiles per nonzero() pass (2^29 elements)


def assemble_macro_coo(c_tile_row, c_tile_col, c_dense, c_flags, c_nnz):
    """Untimed assembly: macro tiles -> sorted global COO (numpy arrays).

    The flag scan and the (row, col) sort run on the operands' device, a
    bounded number of tiles at a time (one ``nonzero`` pass stays below
    2^31 elements).  Structural zeros (flag set, value cancelled to 0.0)
    are kept: the structure is exact.
    """
    rows_l, cols_l, vals_l = [], [], []
    for lo in range(0, c_flags.shape[0], ASSEMBLE_TILES):
        t, r, c = torch.nonzero(c_flags[lo:lo + ASSEMBLE_TILES],
                                as_tuple=True)
        tg = t + lo
        rows_l.append(c_tile_row[tg].long() * TILE + r)
        cols_l.append(c_tile_col[tg].long() * TILE + c)
        vals_l.append(c_dense[tg, r, c])
    rows, cols, vals = (torch.cat(x) for x in (rows_l, cols_l, vals_l))
    assert rows.numel() == int(c_nnz), (rows.numel(), int(c_nnz))
    # tiles hold disjoint coordinates, so the key is unique: any sort works
    order = torch.sort((rows << 32) | cols).indices
    return (rows[order].cpu().numpy(), cols[order].cpu().numpy(),
            vals[order].cpu().numpy())
