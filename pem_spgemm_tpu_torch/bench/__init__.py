from pem_spgemm_tpu_torch.bench.harness import run_benchmark

__all__ = ["run_benchmark"]
