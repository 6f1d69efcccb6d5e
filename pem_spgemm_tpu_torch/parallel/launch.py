"""Spawn N gloo ranks on the CPU and collect what each returns.

    results = spawn(fn, 4, *args)     # [fn(*args) on rank 0, ..., rank 3]

Each rank is a fresh process (``torch.multiprocessing.spawn``) that joins
one gloo process group through a ``FileStore`` in a temporary directory,
runs ``fn(*args)`` and hands its result back pickled.  ``fn`` crosses by
its module and name, so it must be a module-level function of an
importable module that imports no more than a rank needs (the port's
functions: ``parallel.dryrun.rank_cases``); its result should hold numpy
arrays, not tensors.  This is how the tests run the sharded engines on
several ranks with no GPU; ``torchrun`` starts the ranks of a GPU job.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn, world_size: int, tmp: str, args) -> None:
    import torch
    torch.set_num_threads(1)         # N ranks share the host's cores
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world_size),
        rank=rank, world_size=world_size)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, world_size: int, *args, timeout: float = 600.0) -> list:
    """``fn(*args)`` on each of ``world_size`` gloo ranks; their results in
    rank order.  A rank that raises fails the call (its traceback in the
    error); ranks still running at ``timeout`` seconds are killed and the
    call raises ``TimeoutError``."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_rank_main, args=(fn, world_size, tmp, args),
                       nprocs=world_size, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks still running "
                                       f"after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
