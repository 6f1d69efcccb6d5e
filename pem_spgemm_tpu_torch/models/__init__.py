from pem_spgemm_tpu_torch.models.synthetic import (banded, banded_device,
                                                   power_law, rmat,
                                                   uniform_random,
                                                   wandering_device, by_name)

__all__ = ["banded", "banded_device", "power_law", "rmat", "uniform_random",
           "wandering_device", "by_name"]
