"""Run-time configuration of the PyTorch/CUDA port.

Field names and defaults follow the JAX package's ``SpGEMMConfig`` so the
two packages can be driven by the same settings; ``dtype`` is a
``torch.dtype`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def round_up_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def round_up_bucket(n: int, granularity: int = 1) -> int:
    """Bucket a data-dependent size to the enclosing power of two.

    The port runs eagerly, so there is no recompilation to bound; the
    bucket is kept so tile capacities (and therefore array shapes) equal
    the JAX package's on the same input.
    """
    return max(granularity, round_up_pow2(max(1, int(n))))


def resolve_device(device=None) -> torch.device:
    """The device an entry point creates its tensors on.

    ``None`` means the GPU.  Nothing falls back to the CPU on its own:
    without a CUDA device ``None`` raises, and the CPU has to be asked
    for by name (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the "
                "caller passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class SpGEMMConfig:
    """Configuration for the SpGEMM pipeline."""

    # Tile edge of the Tile16 bitmask format (fixed at 16).
    tile: int = 16

    # Value dtype of the numeric phase.  The binned element engine is
    # float32; other dtypes (torch.float64: the f64 parity mode) take the
    # merge element engine, and DIA bands and Macro128 tiles of that dtype
    # their kernels' float64 entries on the GPU.
    dtype: torch.dtype = torch.float32

    # Accumulation dtype of the tiled engines (None: the value dtype).
    acc_dtype: Optional[torch.dtype] = None

    # Matmul precision of the tiled engines.  The Macro128 engine runs in
    # full float32 ("highest") and refuses anything else.
    precision: str = "highest"

    # Pairs per matmul chunk of the tiled engines (not ported yet); the
    # granularity of the merge element engine's product capacity.
    numeric_chunk: int = 1 << 14

    # Structure engine: "fused" | "masks" | "element" | "dia" | "macro" |
    # "auto".  "auto" dispatches on structure: DIA census first (harness
    # level, on COO), then mean macro-tile / tile fill.  The element, DIA
    # and Macro128 engines are ported; the Tile16 engines ("fused",
    # "masks") raise NotImplementedError.
    engine: str = "auto"

    # "auto"/"dia" consider the DIA engine only when the matrix's
    # distinct-diagonal census is at most this.
    dia_max_bands: int = 512

    # Route the binned element engine's sort-path buckets of at most
    # ops.binned.VMEM_SORT_MAX slots through the hand-written CUDA
    # segment sort+dedup kernel (ops/segment_sort.py): one thread block
    # sorts a whole segment in shared memory, so device memory sees each
    # slot once in and once out.  Wider segments use torch.sort followed
    # by the kernel's dedup entry.  Applies to CUDA operands; CPU tensors
    # always take the plain PyTorch versions.
    element_vmem_sort: bool = True

    # "auto" picks the element engine when the mean nnz-per-occupied-tile
    # of both operands is below this; above it (but under the macro
    # threshold) the Tile16 fused engine would run.
    element_threshold: float = float("inf")

    # Element-engine implementation: "binned" (ops/binned.py, float32) or
    # "merge" (ops/element.py, the dtype-agnostic merge-sort engine, which
    # every dtype other than float32 takes whatever this says).
    element_impl: str = "binned"

    # "auto" picks the macro (dense 128x128) engine when the mean nnz per
    # occupied 128x128 macro tile of both operands is at least this.
    macro_threshold: float = 512.0

    # Macro-tile pairs per batched product of the Macro128 engine's plain
    # accumulation (the interactive path and the residual pairs).
    macro_chunk: int = 256

    # The JAX package's switch between its hand-written kernels and their
    # plain versions.  Unused by the ported engines: here the tensors'
    # device alone decides (GPU tensors launch the kernels, CPU tensors
    # take the plain versions).  Kept for the Tile16 engines (not ported yet).
    use_pallas: bool = True

    # Benchmark protocol (reference defaults: WARMUP=1, REPEAT=10).
    warmup: int = 1
    repeat: int = 10
    # Report the min across repeats instead of the mean.
    fastest: bool = False

    def acc(self) -> torch.dtype:
        return self.acc_dtype if self.acc_dtype is not None else self.dtype

    def with_(self, **kw) -> "SpGEMMConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SpGEMMConfig()
