from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled
from pem_spgemm_tpu_torch.ops.spgemm import SpGEMM, SpGEMMResult

__all__ = ["coo_to_tiled", "SpGEMM", "SpGEMMResult"]
