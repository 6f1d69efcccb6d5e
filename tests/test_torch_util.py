"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py).

The same numpy inputs go through the JAX package and through the port on
the CPU; these helpers turn JAX dataclasses into dicts of numpy arrays (the
hand-over format of pem_spgemm_tpu_torch.interop) and compare a JAX object
with its counterpart in the port field by field.
"""

import dataclasses

import numpy as np
import torch

from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.ops.convert import coo_to_tiled as j_coo_to_tiled
from pem_spgemm_tpu_torch.formats.coo import COOMatrix as TCOO
from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled as t_coo_to_tiled


def is_array(x):
    return isinstance(x, np.ndarray) or type(x).__module__.startswith(
        ("jax", "jaxlib"))


def to_np(obj):
    """JAX dataclass / tuple / array tree -> dicts, lists, numpy arrays."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_np(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [to_np(x) for x in obj]
    if is_array(obj):
        return np.asarray(obj)
    return obj


def assert_same(jx, tc, path="obj"):
    """A JAX-side tree equals a port-side tree exactly (arrays bit for
    bit, dtypes by kind and width)."""
    if dataclasses.is_dataclass(jx):
        assert dataclasses.is_dataclass(tc), path
        names = {f.name for f in dataclasses.fields(tc)}
        for f in dataclasses.fields(jx):
            assert f.name in names, f"{path}.{f.name} missing in the port"
            assert_same(getattr(jx, f.name), getattr(tc, f.name),
                        f"{path}.{f.name}")
    elif isinstance(jx, (tuple, list)) and not (
            len(jx) == 2 and all(isinstance(x, int) for x in jx)):
        assert isinstance(tc, (tuple, list)), path
        assert len(jx) == len(tc), (path, len(jx), len(tc))
        for i, (x, y) in enumerate(zip(jx, tc)):
            assert_same(x, y, f"{path}[{i}]")
    elif is_array(jx):
        want = np.asarray(jx)
        got = tc.numpy() if isinstance(tc, torch.Tensor) else np.asarray(tc)
        assert want.shape == got.shape, (path, want.shape, got.shape)
        assert want.dtype.kind == got.dtype.kind, (path, want.dtype,
                                                   got.dtype)
        if isinstance(tc, torch.Tensor):
            assert want.dtype.itemsize == got.dtype.itemsize, (
                path, want.dtype, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif jx is None:
        assert tc is None, path
    else:
        assert jx == tc, (path, jx, tc)


def both_coo(coo):
    """(JAX COOMatrix, port COOMatrix) from one set of numpy triplets."""
    rows, cols, vals = (np.asarray(coo.rows), np.asarray(coo.cols),
                        np.asarray(coo.vals))
    return (JCOO(rows, cols, vals, tuple(coo.shape)),
            TCOO(rows, cols, vals, tuple(coo.shape)))


def both_tiled(coo, **kw):
    """(JAX TiledMatrix, port TiledMatrix on the CPU) of one matrix."""
    jc, tc = both_coo(coo)
    return (j_coo_to_tiled(jc, dtype=np.float32, **kw),
            t_coo_to_tiled(tc, dtype=torch.float32, device="cpu", **kw))


def scipy_product(coo, b_coo=None):
    """Sorted COO of A@B from scipy: (rows, cols, vals, nnz)."""
    sa = coo.to_scipy().tocsr()
    sb = sa if b_coo is None else b_coo.to_scipy().tocsr()
    want = (sa @ sb).tocoo()
    want.sum_duplicates()
    order = np.lexsort((want.col, want.row))
    return want.row[order], want.col[order], want.data[order], want.nnz


def test_to_np_and_assert_same_roundtrip():
    @dataclasses.dataclass
    class Box:
        a: object
        n: int

    b = Box(a=np.arange(4, dtype=np.int32), n=3)
    d = to_np(b)
    assert d["n"] == 3 and d["a"].dtype == np.int32
    assert_same(b, Box(a=torch.arange(4, dtype=torch.int32), n=3))
