"""Multi-GPU DIA SpGEMM: column-block sharding with a halo exchange.

Counterpart of the JAX package's parallel/sharded_dia.py.  The DIA engine's
multiply is band-offset algebra,

    C[d1 + d2][i]  +=  A[d1][i] * B[d2][i + d1],

so sharding the length-n axis into contiguous blocks of l columns leaves
each output column i needing B columns [i + min(offs_a), i + max(offs_a)]
only: each rank takes a halo of hl = max(0, -min(offs_a)) columns from its
left neighbour and hr = max(0, max(offs_a)) from its right one and computes
its C block with no other communication.  The two non-cyclic exchanges of
the JAX package (``ppermute``) are point-to-point sends to the ring
neighbours; the edge ranks keep zeros, the out-of-matrix padding the band
algebra needs.

The JAX package runs the local block as plain XLA.  This port runs it
through the DIA kernels (``ops.dia_kernels.dia_multiply``: the dense entry
K2 or the pairs entry K3, by the offsets), with no kernel change: the
kernels take row-aligned band stacks with n_out <= the A bands' length, so
A goes in as [0_hl | a_blk] and B as [left | b_blk | right], and the block
is C[:, hl:].
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from pem_spgemm_tpu_torch.formats.dia import DiaMatrix
from pem_spgemm_tpu_torch.ops import dia_kernels
from pem_spgemm_tpu_torch.ops.dia import _plan_maps
from pem_spgemm_tpu_torch.parallel.distributed import RankGroup, make_mesh


@dataclasses.dataclass(frozen=True)
class DiaBlocks:
    """The column-block geometry of one sharded DIA multiply."""

    n_devices: int
    l: int                  # columns a block
    hl: int                 # left halo (columns from rank d - 1)
    hr: int                 # right halo (columns from rank d + 1)
    dc_list: tuple          # C offsets
    mode: str               # the kernel entry: 'dense' (K2) | 'pairs' (K3)


def dia_blocks(a: DiaMatrix, b: DiaMatrix, n_devices: int) -> DiaBlocks:
    """Blocks of l = ceil(max(n, n_k) / n_devices) columns.  A halo wider
    than a block would need more than one hop: refused (the DIA dispatch
    caps the band census far below that)."""
    if not a.offsets or not b.offsets:
        raise ValueError("empty offset set")
    dc_list, _ = _plan_maps(a.offsets, b.offsets)
    hl = max(0, -min(a.offsets))
    hr = max(0, max(a.offsets))
    n_k = b.bands.shape[1]
    l = -(-max(a.shape[0], n_k) // n_devices)
    if not (hl <= l and hr <= l):
        raise ValueError(f"halos ({hl}, {hr}) wider than a block of {l} "
                         f"columns at {n_devices} devices")
    return DiaBlocks(n_devices, l, hl, hr, dc_list,
                     dia_kernels.dia_mode(a.offsets, b.offsets, dc_list))


def _block(bands: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Columns [lo, hi) of a band stack, zeros past its end."""
    out = torch.zeros((bands.shape[0], hi - lo), dtype=bands.dtype,
                      device=bands.device)
    top = min(hi, bands.shape[1])
    if top > lo:
        out[:, :top - lo] = bands[:, lo:top]
    return out


def local_dia(a_blk, b_halo, a: DiaMatrix, b: DiaMatrix, geo: DiaBlocks,
              tables=None):
    """(c_blk, cnt_blk), both (len(dc_list), l): one rank's block from its
    A block and its B block with both halos ([left | b_blk | right])."""
    z = torch.zeros((a_blk.shape[0], geo.hl), dtype=a_blk.dtype,
                    device=a_blk.device)
    a_in = torch.cat([z, a_blk], 1)
    if tables is None and a_blk.is_cuda:
        tables = dia_kernels.dia_tables(a.offsets, b.offsets, geo.dc_list,
                                        geo.mode, a_blk.device)
    c, cnt = dia_kernels.dia_multiply(
        a_in, b_halo.contiguous(), offs_a=a.offsets, offs_b=b.offsets,
        dc_list=geo.dc_list, n_out=geo.hl + geo.l, mode=geo.mode,
        tables=tables)
    return c[:, geo.hl:], cnt[:, geo.hl:]


def replay_blocks(a: DiaMatrix, b: DiaMatrix, geo: DiaBlocks, d: int):
    """Rank d's inputs cut from the whole band stacks, halos included: what
    the exchange hands rank d, without an exchange (one card replaying the
    ranks in turn)."""
    l = geo.l
    lo = d * l
    left = _block(b.bands, lo - geo.hl, lo) if d > 0 else \
        torch.zeros((b.bands.shape[0], geo.hl), dtype=b.bands.dtype,
                    device=b.bands.device)
    right = _block(b.bands, lo + l, lo + l + geo.hr) \
        if d + 1 < geo.n_devices else torch.zeros(
            (b.bands.shape[0], geo.hr), dtype=b.bands.dtype,
            device=b.bands.device)
    return (_block(a.bands, lo, lo + l),
            torch.cat([left, _block(b.bands, lo, lo + l), right], 1))


def _exchange(b_blk, geo: DiaBlocks, mesh: RankGroup):
    """[left | b_blk | right]: the left halo from rank d - 1, the right one
    from rank d + 1; the edge ranks keep zeros."""
    d, n = mesh.rank, mesh.world_size
    left = torch.zeros((b_blk.shape[0], geo.hl), dtype=b_blk.dtype,
                       device=b_blk.device)
    right = torch.zeros((b_blk.shape[0], geo.hr), dtype=b_blk.dtype,
                        device=b_blk.device)
    ops = []
    if geo.hl > 0:
        if d + 1 < n:
            ops.append(dist.P2POp(dist.isend,
                                  b_blk[:, geo.l - geo.hl:].contiguous(),
                                  mesh.right, mesh.group))
        if d > 0:
            ops.append(dist.P2POp(dist.irecv, left, mesh.left, mesh.group))
    if geo.hr > 0:
        if d > 0:
            ops.append(dist.P2POp(dist.isend, b_blk[:, :geo.hr].contiguous(),
                                  mesh.left, mesh.group))
        if d + 1 < n:
            ops.append(dist.P2POp(dist.irecv, right, mesh.right, mesh.group))
    for req in (dist.batch_isend_irecv(ops) if ops else []):
        req.wait()
    return torch.cat([left, b_blk, right], 1)


def sharded_dia_multiply(a: DiaMatrix, b: DiaMatrix,
                         mesh: RankGroup | None = None):
    """Sharded DIA multiply over the group's ranks, each holding the whole
    operands and computing its column block.

    Returns (c_bands (dc, n), c_counts (dc, n), dc_list) on every rank (the
    blocks gathered at the end for assembly parity with
    ``ops.dia.dia_to_coo``), on the rank's device."""
    mesh = mesh or make_mesh()
    geo = dia_blocks(a, b, mesh.world_size)
    lo = mesh.rank * geo.l
    a_blk = _block(a.bands, lo, lo + geo.l)
    b_blk = _block(b.bands, lo, lo + geo.l)
    c, cnt = local_dia(a_blk, _exchange(b_blk, geo, mesh), a, b, geo)
    if mesh.group is not None:
        parts = []
        for x in (c.contiguous(), cnt.contiguous()):
            got = [torch.empty_like(x) for _ in range(mesh.world_size)]
            dist.all_gather(got, x, group=mesh.group)
            parts.append(torch.cat(got, 1))
        c, cnt = parts
    n = a.shape[0]
    return c[:, :n], cnt[:, :n], geo.dc_list
