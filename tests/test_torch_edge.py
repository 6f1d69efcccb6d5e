"""Edge cases of the element and Macro128 engines of the port, against
scipy and the JAX package on the same inputs (a mirror of the element and
macro cases of tests/test_edge.py; the fused and bf16 cases wait for the
Tile16 tier)."""

import numpy as np
import pytest
import torch

from pem_spgemm_tpu import SpGEMM as JSpGEMM, SpGEMMConfig as JConfig
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import banded
from pem_spgemm_tpu.ops.convert import coo_to_macro as j_coo_to_macro
from pem_spgemm_tpu.ops.convert import coo_to_tiled as j_coo_to_tiled
from pem_spgemm_tpu_torch import SpGEMM, SpGEMMConfig
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, coo_to_tiled

CPU = "cpu"


def _coo(rows, cols, vals, shape):
    return COOMatrix(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                     np.asarray(vals, np.float64), shape)


def _j(c):
    return JCOO(np.asarray(c.rows), np.asarray(c.cols), np.asarray(c.vals),
                tuple(c.shape))


def _jax_config(cfg):
    """The JAX package's configuration for the same run; its element cases
    take the merge engine, whose compile is a few seconds (the binned
    planner's is tens), and which gives the same structure."""
    if cfg["engine"] == "element":
        return JConfig(**cfg, element_impl="merge")
    return JConfig(**cfg)


def _same_as_jax(res, jres):
    """Equal structure and close values to the JAX package's result."""
    assert res.c_nnz == jres.c_nnz
    got, want = res.to_coo(), jres.to_coo()
    np.testing.assert_array_equal(got.rows, np.asarray(want.rows))
    np.testing.assert_array_equal(got.cols, np.asarray(want.cols))
    np.testing.assert_allclose(got.vals, np.asarray(want.vals), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("engine", ["element", "macro"])
def test_rectangular_aat(engine):
    rs = np.random.default_rng(5)
    nr, nc, nnz = 300, 700, 4000
    coo = _coo(rs.integers(0, nr, nnz), rs.integers(0, nc, nnz),
               rs.standard_normal(nnz), (nr, nc)).sum_duplicates()
    s = coo.to_scipy().tocsr()
    want = (s @ s.T).tocoo()
    want.sum_duplicates()
    a = coo_to_tiled(coo, device=CPU)
    b = coo_to_tiled(coo.transpose(), with_tmasks=True, device=CPU)
    cfg = dict(numeric_chunk=1 << 10, macro_chunk=16, engine=engine)
    r = SpGEMM(SpGEMMConfig(**cfg))(a, b)
    assert r.c_nnz == want.nnz, (engine, r.c_nnz, want.nnz)
    np.testing.assert_allclose(r.to_coo().to_scipy().toarray(),
                               want.toarray(), rtol=1e-4, atol=1e-4)
    jc = _j(coo)
    jr = JSpGEMM(_jax_config(cfg))(
        j_coo_to_tiled(jc, dtype=np.float32),
        j_coo_to_tiled(jc.transpose(), dtype=np.float32, with_tmasks=True))
    _same_as_jax(r, jr)


def test_structurally_empty_product():
    # A's columns never hit an occupied B row: an empty C is a result
    a = _coo([0, 1], [40, 41], [1.0, 2.0], (64, 64))
    b = _coo([0, 1], [3, 4], [1.0, 2.0], (64, 64))
    ta = coo_to_tiled(a, device=CPU)
    tb = coo_to_tiled(b, device=CPU)
    for cfg in (SpGEMMConfig(engine="element"),
                SpGEMMConfig(engine="element", element_impl="merge"),
                SpGEMMConfig(engine="element", dtype=torch.float64)):
        r = SpGEMM(cfg)(ta, tb)
        assert r.c_nnz == 0 and r.n_pairs == 0
        assert r.vals.dtype == cfg.dtype
        got = r.to_coo()
        assert got.nnz == 0 and got.shape == (64, 64)


def test_single_element_matrix():
    coo = _coo([5], [7], [3.0], (16, 16))
    t = coo_to_tiled(coo, device=CPU)
    # the element engine counts products directly: structurally empty
    r1 = SpGEMM(SpGEMMConfig(engine="element"))(t, t)
    assert r1.c_nnz == 0 and r1.to_coo().nnz == 0
    coo2 = _coo([7], [7], [3.0], (16, 16))
    for dtype, impl in ((torch.float32, "binned"), (torch.float32, "merge"),
                        (torch.float64, "binned")):
        t2 = coo_to_tiled(coo2, dtype=dtype, device=CPU)
        r = SpGEMM(SpGEMMConfig(engine="element", dtype=dtype,
                                element_impl=impl))(t2, t2)
        assert r.c_nnz == 1
        got = r.to_coo()
        assert got.rows[0] == 7 and got.cols[0] == 7
        np.testing.assert_allclose(got.vals[0], 9.0, rtol=1e-6)


def test_identity_macro():
    n = 256
    coo = _coo(np.arange(n), np.arange(n), np.ones(n), (n, n))
    m = coo_to_macro(coo, device=CPU)
    r = SpGEMM(SpGEMMConfig(engine="macro", macro_chunk=16))(m, m)
    assert r.c_nnz == n
    np.testing.assert_allclose(r.to_coo().to_scipy().toarray(), np.eye(n),
                               rtol=1e-6)


@pytest.mark.parametrize("engine", ["element", "macro"])
def test_non_multiple_of_tile_shapes(engine):
    # n not a multiple of 16 or 128: border tiles are partial
    jcoo = banded(n=333, bands=(0, 1, -1, 17, -17), seed=2)
    coo = COOMatrix(np.asarray(jcoo.rows), np.asarray(jcoo.cols),
                    np.asarray(jcoo.vals), tuple(jcoo.shape))
    s = coo.to_scipy().tocsr()
    want = s @ s
    cfg = dict(numeric_chunk=1 << 10, macro_chunk=16, engine=engine)
    if engine == "macro":
        op, jop = (coo_to_macro(coo, device=CPU),
                   j_coo_to_macro(jcoo, dtype=np.float32))
    else:
        op, jop = (coo_to_tiled(coo, device=CPU),
                   j_coo_to_tiled(jcoo, dtype=np.float32))
    r = SpGEMM(SpGEMMConfig(**cfg))(op, op)
    assert r.c_nnz == want.nnz, engine
    np.testing.assert_allclose(r.to_coo().to_scipy().toarray(),
                               want.toarray(), rtol=1e-4, atol=1e-4)
    _same_as_jax(r, JSpGEMM(_jax_config(cfg))(jop, jop))
