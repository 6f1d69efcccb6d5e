"""Multi-process scaffolding of the port: bring-up, the rank ring, the
collectives the sharded engines share, and scaling efficiency.

Counterpart of the JAX package's parallel/distributed.py.  JAX runs one
program over a device mesh (``shard_map``); here each rank is one process
with one device, and the engines' per-device bodies become rank-local code
over ``torch.distributed``:

  * ``initialize()`` brings up the default process group: NCCL when the
    device is a GPU, gloo when the caller asks for ``device="cpu"``.  The
    device picks the backend; nothing switches to gloo or to the CPU
    because a GPU is missing.  A single process is a no-op that returns 1,
    so one code path serves a lone process and a ``torchrun`` job;
  * ``pod_mesh()`` / ``make_mesh()`` give the ordered rank group the
    engines run on (``RankGroup``): this rank, the world size, the ring
    neighbours, the device and the process group;
  * ``scaling_efficiency()`` is the BASELINE.md harness: nnz(C)/s at
    n = 1..world size over the groups of the first n ranks.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from pem_spgemm_tpu_torch.config import resolve_device


def backend_for(device: torch.device) -> str:
    """NCCL for a GPU, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device=None, rank: int = 0) -> torch.device:
    """This rank's device: ``device`` as given (``"cuda"`` without an index,
    or None, means the GPU of ``LOCAL_RANK``, else of rank modulo the
    visible cards; None raises without a GPU)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    resolve_device(None)                    # raises without a GPU
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None) -> int:
    """Bring up the default process group for a multi-process run and
    return the world size.

    Unset arguments come from torchrun's environment (``WORLD_SIZE``,
    ``RANK``; ``MASTER_ADDR`` / ``MASTER_PORT`` through ``env://``).  With
    neither an ``init_method`` nor a world size above 1 (a single process)
    it initializes nothing and returns 1.  A group already up is kept."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env \
            and (world_size or 1) > 1:
        init_method = "env://"
    if init_method is None:
        if (world_size or 1) > 1:
            raise ValueError("world_size > 1 needs an init_method (or "
                             "torchrun's MASTER_ADDR)")
        return 1
    dev = rank_device(device, rank or 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            world_size=world_size or 1, rank=rank or 0)
    return dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """The ordered rank group a sharded engine runs on: the counterpart of
    the JAX package's 1-D device mesh.  ``rank`` is this process's place in
    the group (-1 where it is not a member), ``ranks`` the members' global
    ranks in ring order, ``group`` the process group (None: no process
    group, a lone process)."""

    rank: int
    world_size: int
    device: torch.device
    group: object = None
    ranks: tuple = (0,)

    @property
    def member(self) -> bool:
        return self.rank >= 0

    @property
    def left(self) -> int:
        """Global rank of the ring neighbour on the left (d - 1 mod n)."""
        return self.ranks[(self.rank - 1) % self.world_size]

    @property
    def right(self) -> int:
        """Global rank of the ring neighbour on the right (d + 1 mod n)."""
        return self.ranks[(self.rank + 1) % self.world_size]


def pod_mesh(n_devices: Optional[int] = None, device=None) -> RankGroup:
    """The group of the first ``n_devices`` ranks (all by default), in rank
    order.  A group smaller than the world is a new process group: every
    rank must call this with the same ``n_devices`` (ranks outside get a
    group they are not a member of).  Without a process group: a lone
    process, world size 1."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"{n_devices} devices without a process group "
                             "(call initialize first)")
        return RankGroup(0, 1, rank_device(device))
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"{n} devices in a world of {world}")
    dev = rank_device(device, dist.get_rank())
    if dev.type != "cpu" and backend_for(dev) != dist.get_backend():
        raise ValueError(f"device {dev} in a {dist.get_backend()} group")
    ranks = tuple(range(n))
    group = dist.group.WORLD if n == world else dist.new_group(list(ranks))
    me = dist.get_rank()
    return RankGroup(me if me < n else -1, n, dev, group, ranks)


make_mesh = pod_mesh


def _grouped(mesh: RankGroup) -> bool:
    return mesh.group is not None


def all_reduce_sum(x: torch.Tensor, mesh: RankGroup) -> torch.Tensor:
    """Sum of ``x`` over the group (the JAX ``psum``), in place."""
    if _grouped(mesh):
        dist.all_reduce(x, group=mesh.group)
    return x


def all_reduce_max(x: torch.Tensor, mesh: RankGroup) -> torch.Tensor:
    if _grouped(mesh):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return x


def gather_rows(tensors, mesh: RankGroup) -> list:
    """Concatenate 1-D tensors of one length (which may differ from rank to
    rank) over the group, in rank order, on every rank.  The lengths cross
    first; each rank pads to the largest, because ``all_gather`` takes
    equal sizes."""
    if not _grouped(mesh):
        return list(tensors)
    dev = tensors[0].device
    n = torch.tensor([tensors[0].numel()], dtype=torch.int64, device=dev)
    counts = [torch.empty_like(n) for _ in range(mesh.world_size)]
    dist.all_gather(counts, n, group=mesh.group)
    counts = [int(c) for c in counts]
    top = max(counts)
    out = []
    for x in tensors:
        pad = torch.zeros(top, dtype=x.dtype, device=dev)
        pad[:x.numel()] = x
        got = [torch.empty_like(pad) for _ in range(mesh.world_size)]
        dist.all_gather(got, pad, group=mesh.group)
        out.append(torch.cat([g[:c] for g, c in zip(got, counts)]))
    return out


def gather_coo(rows, cols, vals, mesh: RankGroup, host: bool = True):
    """Every rank's COO entries, on every rank, sorted by (row, col) with
    one sort on the device; returned as host numpy arrays (the JAX
    package's assembly returns numpy too), or with ``host=False`` as
    tensors on the device.  Shards hold disjoint coordinates, so the key
    is unique."""
    rows, cols, vals = gather_rows(
        [rows.to(torch.int64), cols.to(torch.int64), vals], mesh)
    order = torch.sort((rows << 32) | cols).indices
    out = (rows[order], cols[order], vals[order])
    return to_numpy_tree(out) if host else out


def ring_exchange(send, recv, mesh: RankGroup) -> list:
    """Start passing ``send`` to the right neighbour while ``recv`` takes
    the left neighbour's (the JAX package's cyclic ``ppermute``); each a
    tensor, or a list of tensors passed together, in one batch.  Returns
    the requests; ``wait()`` them before ``recv`` is read or ``send``
    written."""
    sends = send if isinstance(send, (list, tuple)) else [send]
    recvs = recv if isinstance(recv, (list, tuple)) else [recv]
    ops = []
    for x, y in zip(sends, recvs, strict=True):
        ops += [dist.P2POp(dist.isend, x, mesh.right, mesh.group),
                dist.P2POp(dist.irecv, y, mesh.left, mesh.group)]
    return dist.batch_isend_irecv(ops)


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    c_nnz: int
    seconds: float
    nnz_per_s: float
    efficiency: float                  # vs n=1, per-device


def _sync(x) -> None:
    from pem_spgemm_tpu_torch.utils.timing import force_sync
    force_sync(x)


def _engine_run(coo, engine: str, mesh: RankGroup):
    """(run, c_nnz_of) of one sharded engine on ``mesh``: ``run()``
    multiplies once, ``c_nnz_of(out)`` reads C's nnz from its output."""
    from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, coo_to_tiled
    from pem_spgemm_tpu_torch.parallel import sharded, sharded_element
    from pem_spgemm_tpu_torch.parallel import sharded_macro
    n, d, dev = mesh.world_size, mesh.rank, mesh.device
    if engine == "macro":
        op = coo_to_macro(coo, dtype=torch.float32, device=dev)
        plan = sharded_macro.plan_sharded_macro(op, op, n, d)
        return (lambda: sharded_macro.sharded_macro_numeric(plan, mesh),
                lambda out: plan_nnz_macro(plan, out, mesh))
    if engine == "element":
        op = coo_to_tiled(coo, dtype=torch.float32, device=dev)
        plan = sharded_element.plan_sharded_element(op, op, n, d)
        return (lambda: sharded_element.sharded_element_multiply(plan, mesh),
                lambda out: out[1])
    if engine != "tile16":
        raise ValueError(f"unknown engine {engine!r}")
    op = coo_to_tiled(coo, dtype=torch.float32, with_tmasks=True, device=dev)
    plan = sharded.plan_sharded_spgemm(op, op, n, d)
    return (lambda: sharded.sharded_numeric(plan, mesh),
            lambda out: plan.c_nnz)


def scaling_efficiency(coo, engine: str = "tile16", max_devices: int = 0,
                       repeats: int = 3, verbose: bool = True, device=None):
    """nnz(C)/s at n = 1..max_devices for one sharded engine, on every rank.

    Each n runs on the group of the first n ranks (``pod_mesh(n)``); the
    other ranks wait at a barrier.  A point's time is the slowest member's
    (the best of ``repeats`` multiplies, each synchronised).  Efficiency(n)
    = (nnz_per_s(n) / n) / nnz_per_s(1), the BASELINE.md metric.  Rank 0's
    points are broadcast, so every rank returns the same list."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_max = max_devices or world
    points, base = [], None
    for n in range(1, n_max + 1):
        if n > 1 and n_max % n and n != n_max:
            continue                   # keep the sweep short: divisors
        mesh = pod_mesh(n, device)
        if mesh.member:
            run, c_nnz_of = _engine_run(coo, engine, mesh)
            out = run()                # warm
            _sync(out[0])
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                out = run()
                _sync(out[0])
                ts.append(time.perf_counter() - t0)
            sec = all_reduce_max(torch.tensor([min(ts)], dtype=torch.float64,
                                              device=mesh.device), mesh)
            sec = float(sec[0])
            c_nnz = int(c_nnz_of(out))
            rate = c_nnz / sec
            base = rate if base is None else base
            points.append(ScalingPoint(n, c_nnz, sec, rate,
                                       (rate / n) / base))
            if verbose and mesh.rank == 0:
                print(f"[{engine}] n={n}: {sec * 1e3:.1f} ms, "
                      f"{rate / 1e6:.2f} Mnnz/s, efficiency "
                      f"{(rate / n) / base:.2f}", flush=True)
        if dist.is_initialized():
            dist.barrier()
    if dist.is_initialized():
        box = [points]
        dist.broadcast_object_list(box, src=0)
        points = box[0]
    return points


def plan_nnz_macro(plan, out, mesh: Optional[RankGroup] = None) -> int:
    """Exact C nnz from a sharded-macro run's structural flags: this rank's
    first ``plan.c_count`` tiles are its real C tiles (counting padded
    tiles would inflate the metric if one ever carried a flag), summed over
    the group."""
    if not isinstance(out, tuple):
        return -1
    flags = out[1]
    n = torch.count_nonzero(flags[:plan.c_count]).to(torch.int64).reshape(1)
    if mesh is not None:
        all_reduce_sum(n, mesh)
    return int(n[0])


def to_numpy_tree(obj):
    """Tensors (in dicts, lists and tuples) as host numpy arrays."""
    if isinstance(obj, torch.Tensor):
        from pem_spgemm_tpu_torch.formats.coo import _to_numpy
        return _to_numpy(obj)
    if isinstance(obj, dict):
        return {k: to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy_tree(v) for v in obj)
    return obj


__all__ = ["RankGroup", "ScalingPoint", "all_reduce_sum", "backend_for",
           "gather_coo", "gather_rows", "initialize", "make_mesh",
           "plan_nnz_macro", "pod_mesh", "ring_exchange",
           "scaling_efficiency"]
