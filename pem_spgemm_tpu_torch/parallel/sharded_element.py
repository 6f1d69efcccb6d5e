"""Multi-GPU element-level SpGEMM: column-sharded B, replicated A.

Counterpart of the JAX package's parallel/sharded_element.py, the
distributed path of the hypersparse regime (the binned element engine,
ops/binned.py).  Partitioning B by COLUMN ranges, balanced by nnz,
partitions the products exactly: rank d computes C[:, j_d:j_{d+1}] =
A @ B[:, j_d:j_{d+1}], a complete local binned multiply.  The j-ranges are
disjoint, so no rank merges another's duplicates; the only collectives are
the c_nnz sum (the JAX ``psum``) and the gather of C.

The JAX package builds every shard's plan on the host and pads them to
common shapes so that one ``shard_map`` program serves every device.  Here
each rank runs its own code: it plans only its own shard, on the device,
and nothing is padded.  The multiply is ``ops.binned.binned_multiply`` as
the single-GPU engine runs it, so the shard's buckets launch the segment
sort+dedup kernels (K1b, and K1a on chunk-granular buckets) on the GPU.
"""

from __future__ import annotations

import dataclasses

import torch

from pem_spgemm_tpu_torch.ops import binned
from pem_spgemm_tpu_torch.parallel.distributed import (RankGroup,
                                                       all_reduce_sum,
                                                       gather_coo, make_mesh)


class _CsrView:
    """Minimal element-CSR operand for ops/binned (a B column shard is not a
    TiledMatrix: it needs ``element_csr()``, ``shape`` and room for the
    chunk table ``binned.chunk_b`` caches on it)."""

    def __init__(self, rowptr, rows, cols, vals, shape):
        self._ecsr = (rowptr, rows, cols, vals)
        self.shape = shape

    def element_csr(self):
        return self._ecsr


def column_bounds(b_cols: torch.Tensor, n_cols: int, n: int) -> torch.Tensor:
    """(n + 1,) int64 j-range boundaries balanced by B's nnz, on B's
    device: bincount, cumsum and searchsorted over B's columns, as the
    JAX package computes them on the host (the float64 targets and the
    left-side search give the same cuts)."""
    dev = b_cols.device
    hist = torch.bincount(b_cols.long(), minlength=n_cols)
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum(hist, 0)])
    nnz = int(b_cols.numel())
    targets = torch.arange(1, n, dtype=torch.float64, device=dev) * (nnz / n)
    cuts = torch.searchsorted(cum.to(torch.float64), targets)
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), cuts,
                      torch.full((1,), n_cols, dtype=torch.int64,
                                 device=dev)])


def column_shard(b, lo: int, hi: int) -> _CsrView:
    """B's element CSR restricted to the columns [lo, hi): a stable filter
    on the device keeps the row-major order."""
    b_rowptr, b_rows, b_cols, b_vals = b.element_csr()
    keep = torch.nonzero((b_cols >= lo) & (b_cols < hi)).squeeze(1)
    rows = b_rows[keep]
    counts = torch.bincount(rows.long(), minlength=b.shape[0])
    rowptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                    device=rows.device),
                        torch.cumsum(counts, 0)]).to(torch.int32)
    return _CsrView(rowptr, rows, b_cols[keep], b_vals[keep], b.shape)


@dataclasses.dataclass
class ShardedElementPlan:
    """Rank ``rank``'s binned plan of its B column shard.

    ``build_plan_device`` caches one plan on ``a``, keyed on the B operand
    (a weak reference): the plan keeps its shard view alive here, and a
    process that plans several shards over one ``a`` must keep each plan,
    or it plans again."""

    n_devices: int
    rank: int
    plan: object             # ops.binned.BinnedPlan of the shard
    shard: _CsrView          # B[:, col_bounds[rank]:col_bounds[rank + 1]]
    col_bounds: torch.Tensor  # (n + 1,) int64 j-range boundaries
    w: int
    n_products: int          # this shard's


def plan_sharded_element(a, b, n_devices: int, rank: int
                         ) -> ShardedElementPlan:
    """Plan rank ``rank``'s shard of A @ B over ``n_devices`` column
    shards.  Every rank computes the same bounds and the same chunk width
    (B's whole, as ``binned.chunk_b(b).w`` gives it) and plans only its
    own shard.  float32 and bfloat16 values (both of one dtype): the
    binned engine widens bfloat16 values to float32, as the JAX
    decomposition does, and C is float32.  float64 raises: the JAX
    decomposition computes float64 input in float32, which the port's
    float64 parity mode does not do."""
    if a.vals.dtype not in (torch.float32, torch.bfloat16) \
            or b.vals.dtype != a.vals.dtype:
        raise NotImplementedError(
            f"values of dtype {a.vals.dtype} / {b.vals.dtype}: the sharded "
            "element engine multiplies float32 or bfloat16 values (widened "
            "to float32, the binned engine's dtype), both of one dtype")
    if not 0 <= rank < n_devices:
        raise ValueError(f"rank {rank} of {n_devices}")
    _rowptr, _rows, b_cols, _vals = b.element_csr()
    bounds = column_bounds(b_cols, b.shape[1], n_devices)
    w = binned.chunk_b(b).w
    lo, hi = (int(x) for x in bounds[rank:rank + 2].tolist())
    shard = column_shard(b, lo, hi)
    plan = binned.build_plan_device(a, shard, w=w)
    return ShardedElementPlan(n_devices=n_devices, rank=rank, plan=plan,
                              shard=shard, col_bounds=bounds, w=w,
                              n_products=plan.n_products)


def local_element_multiply(plan: ShardedElementPlan):
    """This rank's binned multiply: its C stream (None for a shard with no
    products)."""
    if plan.n_products == 0:
        return None
    return binned.binned_multiply(plan.plan,
                                  vmem_sort=plan.plan.table.is_cuda)


def sharded_element_multiply(plan: ShardedElementPlan,
                             mesh: RankGroup | None = None):
    """(this rank's C stream, global c_nnz): the local multiply, then the
    c_nnz sum over the group."""
    mesh = mesh or make_mesh()
    stream = local_element_multiply(plan)
    dev = plan.col_bounds.device
    n = torch.zeros(1, dtype=torch.int64, device=dev) if stream is None \
        else stream.c_nnz.to(torch.int64).reshape(1)
    return stream, int(all_reduce_sum(n, mesh)[0])


def local_coo(stream, device):
    """(rows, cols, vals) of this rank's C on its device, unsorted."""
    if stream is None:
        z = torch.zeros(0, dtype=torch.int32, device=device)
        return z, z, torch.zeros(0, dtype=torch.float32, device=device)
    return stream.device_coo()


def assemble_sharded_element(plan: ShardedElementPlan, stream,
                             mesh: RankGroup | None = None,
                             host: bool = True):
    """Global sorted COO on every rank (host numpy; ``host=False``: tensors
    on the device): the ranks' entries gathered and sorted on the device
    (column shards interleave in the global (row, col) order)."""
    mesh = mesh or make_mesh()
    return gather_coo(*local_coo(stream, plan.col_bounds.device), mesh, host)
