"""Persist converted formats to disk: the checkpoint of a converted operand.

Counterpart of the JAX package's io/persist.py, with the same ``.npz`` keys
and magic strings, so an archive written by one package loads in the
other.  One archive per matrix holds every array field and the static
metadata; loaders return tensors on ``device`` (``None``: the GPU).

    save_tiled("a.tile16.npz", tiled)
    tiled = load_tiled("a.tile16.npz")
    save_macro("a.macro.npz", macro)
    macro = load_macro("a.macro.npz")
    save_dia("a.dia.npz", dia)
    dia = load_dia("a.dia.npz")

bfloat16 values are refused both ways: numpy has no bfloat16, and the JAX
package writes such values as raw 2-byte records that neither package can
load back as numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from pem_spgemm_tpu_torch.config import resolve_device

_MAGIC_TILED = "pem-spgemm-tpu/tile16/v1"
_MAGIC_MACRO = "pem-spgemm-tpu/macro128/v1"
_MAGIC_DIA = "pem-spgemm-tpu/dia/v1"


def _np(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        raise TypeError("bfloat16 values cannot be persisted: numpy has no "
                        "bfloat16 (convert to float32 first)")
    return x.detach().cpu().numpy()


def _t(a: np.ndarray, dev) -> torch.Tensor:
    if a.dtype.kind not in "iufb":
        raise TypeError(f"array of dtype {a.dtype} in the archive (bfloat16 "
                        "values are written as raw 2-byte records, which "
                        "cannot be loaded as numbers)")
    return torch.from_numpy(np.array(a, order="C")).to(dev)


def _open(path: str, magic: str):
    z = np.load(path, allow_pickle=False)
    if str(z["magic"]) != magic:
        raise ValueError(f"{path}: not a {magic} archive")
    return z


def save_tiled(path: str, t) -> None:
    """Write a TiledMatrix to an .npz archive."""
    np.savez_compressed(
        path,
        magic=np.asarray(_MAGIC_TILED),
        shape=np.asarray(t.shape, np.int64),
        ntiles=np.asarray(t.ntiles, np.int64),
        tile_row=_np(t.tile_row),
        tile_col=_np(t.tile_col),
        ptr=_np(t.ptr),
        masks=_np(t.masks),
        vals=_np(t.vals),
        rowcol=_np(t.rowcol),
        elem_tile=_np(t.elem_tile),
        tile_rowptr=_np(t.tile_rowptr),
        tmasks=(_np(t.tmasks) if t.tmasks is not None
                else np.zeros((0,), np.int32)),
    )


def load_tiled(path: str, device=None):
    """Load a TiledMatrix saved by save_tiled (tensors on ``device``)."""
    from pem_spgemm_tpu_torch.formats.tiled import TiledMatrix
    dev = resolve_device(device)
    z = _open(path, _MAGIC_TILED)
    tm = z["tmasks"]
    return TiledMatrix(
        tile_row=_t(z["tile_row"], dev),
        tile_col=_t(z["tile_col"], dev),
        ptr=_t(z["ptr"], dev),
        masks=_t(z["masks"], dev),
        vals=_t(z["vals"], dev),
        rowcol=_t(z["rowcol"], dev),
        elem_tile=_t(z["elem_tile"], dev),
        tile_rowptr=_t(z["tile_rowptr"], dev),
        tmasks=_t(tm, dev) if tm.size else None,
        shape=tuple(int(x) for x in z["shape"]),
        ntiles=int(z["ntiles"]),
    )


def save_macro(path: str, m) -> None:
    """Write a MacroMatrix to an .npz archive."""
    np.savez_compressed(
        path,
        magic=np.asarray(_MAGIC_MACRO),
        shape=np.asarray(m.shape, np.int64),
        ntiles=np.asarray(m.ntiles, np.int64),
        nnz=np.asarray(m.nnz, np.int64),
        tile_row=_np(m.tile_row),
        tile_col=_np(m.tile_col),
        tile_rowptr=_np(m.tile_rowptr),
        dense=_np(m.dense),
    )


def load_macro(path: str, device=None):
    """Load a MacroMatrix saved by save_macro (tensors on ``device``)."""
    from pem_spgemm_tpu_torch.formats.macro import MacroMatrix
    dev = resolve_device(device)
    z = _open(path, _MAGIC_MACRO)
    return MacroMatrix(
        tile_row=_t(z["tile_row"], dev),
        tile_col=_t(z["tile_col"], dev),
        tile_rowptr=_t(z["tile_rowptr"], dev),
        dense=_t(z["dense"], dev),
        shape=tuple(int(x) for x in z["shape"]),
        ntiles=int(z["ntiles"]),
        nnz=int(z["nnz"]),
    )


def save_dia(path: str, d) -> None:
    """Write a DiaMatrix (band stack + offsets) to an .npz archive."""
    np.savez_compressed(
        path,
        magic=np.asarray(_MAGIC_DIA),
        bands=_np(d.bands),
        offsets=np.asarray(d.offsets, np.int64),
        shape=np.asarray(d.shape, np.int64),
        nnz=np.asarray(d.nnz, np.int64),
    )


def load_dia(path: str, device=None):
    """Load a DiaMatrix saved by save_dia (bands on ``device``)."""
    from pem_spgemm_tpu_torch.formats.dia import DiaMatrix
    dev = resolve_device(device)
    z = _open(path, _MAGIC_DIA)
    return DiaMatrix(
        bands=_t(z["bands"], dev),
        shape=tuple(int(x) for x in z["shape"]),
        offsets=tuple(int(x) for x in z["offsets"]),
        nnz=int(z["nnz"]),
    )
