from pem_spgemm_tpu_torch.io.mtx import (read_matrix_market,
                                         write_matrix_market)

__all__ = ["read_matrix_market", "write_matrix_market"]
