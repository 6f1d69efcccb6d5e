"""The multi-GPU layer: one process per rank over torch.distributed (NCCL on
the GPU, gloo on the CPU), with the four decompositions of the JAX
package's parallel/: the Tile16 ring (sharded.py), the Macro128 ring
(sharded_macro.py), column-sharded B on the element engine
(sharded_element.py) and the DIA halo exchange (sharded_dia.py)."""

from pem_spgemm_tpu_torch.parallel.sharded import (ShardedPlan,
                                                   assemble_sharded,
                                                   plan_sharded_spgemm,
                                                   sharded_numeric)
from pem_spgemm_tpu_torch.parallel.distributed import make_mesh

__all__ = ["ShardedPlan", "plan_sharded_spgemm", "sharded_numeric",
           "assemble_sharded", "make_mesh"]
