from pem_spgemm_tpu_torch.models.synthetic import (banded, banded_device,
                                                   power_law, rmat,
                                                   uniform_random, by_name)

__all__ = ["banded", "banded_device", "power_law", "rmat", "uniform_random",
           "by_name"]
