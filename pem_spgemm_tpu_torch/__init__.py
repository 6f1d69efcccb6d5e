"""pem_spgemm_tpu_torch: the PyTorch/CUDA port of pem_spgemm_tpu.

A second package beside the JAX one, with the same sub-package and module
names so a reader finds each counterpart.  Plain tensor code is PyTorch;
the kernels are written by hand for Hopper (csrc/, built at first use).
Entry points run on the GPU unless the caller passes ``device="cpu"``.

Ported so far: the binned element engine end to end (COO -> Tile16 ->
element CSR -> chunk table -> binned plan -> multiply -> sorted COO), the
DIA engine end to end (COO -> diagonal census -> band stacks -> plan ->
multiply with exact structural counts -> sorted COO), the Macro128 engine
end to end (COO -> dense 128x128 tiles -> pair stream -> accumulation with
exact structural flags -> sorted COO; steady state through the stencil /
run class plans or the generic pair stream), the Tile16 tier (the fused
and masks engines over 16x16 bitmask tiles, in float32, float64 and
bfloat16; its steady step one CUDA graph), the benchmark harness,
MatrixMarket I/O, persistence of the converted formats (io/persist.py) and
the command line (bench/cli.py), and the f64 parity mode (the merge element
engine, the kernels' float64 entries), bfloat16 on every engine (float32
accumulation, C rounded to bfloat16), and the multi-GPU layer
(``parallel/``: one process a rank over torch.distributed, NCCL on the
GPUs, gloo on the CPU; the Tile16 and Macro128 rings, the column-sharded
element engine and the DIA halo exchange).
"""

from pem_spgemm_tpu_torch.config import SpGEMMConfig
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.formats.dia import DiaMatrix
from pem_spgemm_tpu_torch.formats.macro import MacroMatrix
from pem_spgemm_tpu_torch.formats.tiled import TiledMatrix
from pem_spgemm_tpu_torch.io.mtx import read_matrix_market
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, coo_to_tiled
from pem_spgemm_tpu_torch.ops.dia import coo_to_dia, detect_dia
from pem_spgemm_tpu_torch.ops.spgemm import SpGEMM, SpGEMMResult

__version__ = "0.1.0"

__all__ = [
    "SpGEMMConfig",
    "COOMatrix",
    "DiaMatrix",
    "MacroMatrix",
    "TiledMatrix",
    "coo_to_tiled",
    "coo_to_macro",
    "coo_to_dia",
    "detect_dia",
    "read_matrix_market",
    "SpGEMM",
    "SpGEMMResult",
]
