"""State carried across from the JAX package.

The JAX package's objects are handed over as **dicts of numpy arrays plus
Python scalars**, keyed by the field names of its dataclasses (nested
dataclasses as nested dicts, tuples of them as lists).  This module turns
those dicts into the port's objects; it never sees a JAX type.  With them a
caller can compare conversion products and plans array by array, or feed a
plan built by one package into the other's multiply.  Arrays keep their
dtype (float64 values stay float64).
"""

from __future__ import annotations

import numpy as np
import torch

from pem_spgemm_tpu_torch.config import resolve_device
from pem_spgemm_tpu_torch.formats.dia import DiaMatrix
from pem_spgemm_tpu_torch.formats.macro import MacroMatrix
from pem_spgemm_tpu_torch.formats.tiled import TiledMatrix
from pem_spgemm_tpu_torch.ops.binned import (BinnedPlan, Bucket, ChunkedB,
                                             FineStream, FineTable,
                                             PackedBucket)


def _t(x, dev):
    """numpy array -> tensor on dev, through a writable copy (None stays
    None)."""
    if x is None:
        return None
    return torch.from_numpy(np.array(x, order="C")).to(dev)


def _tt(xs, dev):
    """tuple of numpy arrays -> tuple of tensors (None stays None)."""
    if xs is None:
        return None
    return tuple(_t(x, dev) for x in xs)


def tiled_from_numpy(d: dict, device=None) -> TiledMatrix:
    """TiledMatrix from a dict of its fields."""
    dev = resolve_device(device)
    arrays = ("tile_row", "tile_col", "ptr", "masks", "vals", "rowcol",
              "elem_tile", "tile_rowptr", "tmasks")
    return TiledMatrix(**{k: _t(d.get(k), dev) for k in arrays},
                       shape=tuple(d["shape"]), ntiles=int(d["ntiles"]))


def dia_from_numpy(d: dict, device=None) -> DiaMatrix:
    """DiaMatrix from a dict of its fields (``bands`` a numpy array)."""
    dev = resolve_device(device)
    return DiaMatrix(bands=_t(d["bands"], dev), shape=tuple(d["shape"]),
                     offsets=tuple(int(x) for x in d["offsets"]),
                     nnz=int(d["nnz"]))


def macro_from_numpy(d: dict, device=None) -> MacroMatrix:
    """MacroMatrix from a dict of its fields."""
    dev = resolve_device(device)
    arrays = ("tile_row", "tile_col", "tile_rowptr", "dense")
    return MacroMatrix(**{k: _t(d[k], dev) for k in arrays},
                       shape=tuple(d["shape"]), ntiles=int(d["ntiles"]),
                       nnz=int(d["nnz"]))


def stencil_plan_from_numpy(d: dict, device=None):
    """ops.stencil.StencilPlan from a dict of the JAX package's StencilPlan
    fields (``classes`` tuples, ``class_bases`` a list of arrays); the class
    kernels' tables are rebuilt for ``device``."""
    from pem_spgemm_tpu_torch.ops.stencil import StencilPlan, class_tables
    dev = resolve_device(device)
    classes = tuple(
        (int(t), int(p) if np.ndim(p) == 0 else tuple(int(x) for x in p),
         int(ar), int(br), tuple(int(x) for x in ao),
         tuple(int(x) for x in bo), int(base))
        for (t, p, ar, br, ao, bo, base) in d["classes"])
    return StencilPlan(
        classes=classes, class_bases=_tt(d["class_bases"], dev),
        res_pa=_t(d["res_pa"], dev), res_pb=_t(d["res_pb"], dev),
        res_seg=_t(d["res_seg"], dev), n_res_tiles=int(d["n_res_tiles"]),
        order=np.asarray(d["order"], np.int64), c_cap=int(d["c_cap"]),
        n_tiles=int(d["n_tiles"]), coverage=float(d["coverage"]),
        class_tables=class_tables(classes, dev))


def element_plan_from_numpy(d: dict):
    """ops.fixed.ElementPlan (the merge element engine's capacities and scan
    depths; ``wide`` for the float64 step) from a dict of the JAX package's
    ElementPlan fields.  Holds no array, so it has no device."""
    from pem_spgemm_tpu_torch.ops.fixed import ElementPlan

    def opt(x):
        return None if x is None else int(x)

    return ElementPlan(p_cap=int(d["p_cap"]), c_cap=int(d["c_cap"]),
                       fill_rounds=opt(d.get("fill_rounds")),
                       merge_rounds=opt(d.get("merge_rounds")),
                       sum_rounds=opt(d.get("sum_rounds")),
                       wide=bool(d.get("wide", False)))


def chunked_b_from_numpy(d: dict, device=None) -> ChunkedB:
    """ChunkedB from a dict of its fields (``fine`` a list of FineTable
    dicts, or None)."""
    dev = resolve_device(device)
    fine = d.get("fine")
    if fine is not None:
        fine = tuple(FineTable(w=int(f["w"]), table=_t(f["table"], dev),
                               n_rows=int(f["n_rows"])) for f in fine)
    dev_fields = ("table", "cptr_dev", "lens_dev", "fcls_dev", "fidx_dev",
                  "rowof_dev", "starts_dev", "ends_dev", "wintab")
    return ChunkedB(cptr=np.asarray(d["cptr"], np.int64),
                    lens=np.asarray(d["lens"], np.int64),
                    w=int(d["w"]), nb=int(d.get("nb", 0)), fine=fine,
                    **{k: _t(d.get(k), dev) for k in dev_fields})


def plan_from_numpy(d: dict, device=None) -> BinnedPlan:
    """BinnedPlan from a dict of its fields: ``buckets``, ``packed`` and
    ``fine`` are lists of dicts, ``win`` and ``coarse`` tuples of arrays
    or None."""
    dev = resolve_device(device)
    buckets = tuple(
        Bucket(m=int(b["m"]), src=_t(b["src"], dev),
               avals=_t(b["avals"], dev), seg_rows=_t(b["seg_rows"], dev),
               n_rows=int(b["n_rows"]), single=bool(b["single"]),
               rounds=int(b["rounds"]), consec=bool(b["consec"]))
        for b in d["buckets"])
    packed = tuple(
        PackedBucket(l=int(p["l"]), keys=_t(p["keys"], dev),
                     bbits=_t(p["bbits"], dev), abits=_t(p["abits"], dev),
                     seg_rows=_t(p["seg_rows"], dev),
                     n_rows=int(p["n_rows"]), rounds=int(p["rounds"]))
        for p in d.get("packed", ()))
    fine = tuple(
        FineStream(mode=str(f["mode"]), w=int(f["w"]),
                   table=_t(f["table"], dev), refs=_t(f.get("refs"), dev),
                   block_ids=_t(f.get("block_ids"), dev),
                   loc=_t(f.get("loc"), dev), avals=_t(f["avals"], dev),
                   rows=_t(f["rows"], dev))
        for f in d.get("fine", ()))
    return BinnedPlan(
        buckets=buckets, res_src=_t(d["res_src"], dev),
        res_avals=_t(d["res_avals"], dev), res_rows=_t(d["res_rows"], dev),
        n_res_chunks=int(d["n_res_chunks"]), w=int(d["w"]),
        n_products=int(d["n_products"]), table=_t(d["table"], dev),
        win=_tt(d.get("win"), dev), wintab=_t(d.get("wintab"), dev),
        coarse=_tt(d.get("coarse"), dev), fine=fine, packed=packed)
