from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.formats.dia import DiaMatrix
from pem_spgemm_tpu_torch.formats.macro import MacroMatrix
from pem_spgemm_tpu_torch.formats.tiled import TiledMatrix

__all__ = ["COOMatrix", "DiaMatrix", "MacroMatrix", "TiledMatrix"]
