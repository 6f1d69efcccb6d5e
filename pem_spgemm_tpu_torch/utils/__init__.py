from pem_spgemm_tpu_torch.utils.timing import PhaseTimers
from pem_spgemm_tpu_torch.utils.flops import spgemm_flops, compression_ratio

__all__ = ["PhaseTimers", "spgemm_flops", "compression_ratio"]
