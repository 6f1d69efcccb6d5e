"""Edge cases of the element, Tile16 (fused) and Macro128 engines of the
port, against scipy and the JAX package on the same inputs (a mirror of
tests/test_edge.py, its bfloat16 case included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_util import one_torch_thread, xla_unoptimized
from pem_spgemm_tpu import SpGEMM as JSpGEMM, SpGEMMConfig as JConfig
from pem_spgemm_tpu.bench.harness import run_benchmark as j_run_benchmark
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import banded, uniform_random
from pem_spgemm_tpu.ops.convert import coo_to_macro as j_coo_to_macro
from pem_spgemm_tpu.ops.convert import coo_to_tiled as j_coo_to_tiled
from pem_spgemm_tpu_torch import SpGEMM, SpGEMMConfig
from pem_spgemm_tpu_torch.bench.harness import run_benchmark
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, coo_to_tiled

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

CPU = "cpu"


def _coo(rows, cols, vals, shape):
    return COOMatrix(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                     np.asarray(vals, np.float64), shape)


def _j(c):
    return JCOO(np.asarray(c.rows), np.asarray(c.cols), np.asarray(c.vals),
                tuple(c.shape))


def _jax_config(cfg):
    """The JAX package's configuration for the same run; its element cases
    (and those "auto" sends to the element engine) take the merge engine,
    whose compile is a few seconds (the binned planner's is tens), and which
    gives the same structure."""
    if cfg["engine"] in ("element", "auto"):
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


@pytest.mark.parametrize("engine", ["fused", "element", "macro"])
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


@pytest.mark.parametrize("kind,engine", [("rectangular", "element"),
                                         ("banded", "dia")])
def test_harness_aat_matches_jax(kind, engine):
    """run_benchmark(aat=True, engine="auto") in both packages: the same
    engine, C's structure bit for bit, values within rtol=1e-5.  The
    rectangular case is the uniform suite family at 1,200 x 600 (4 nnz a
    row, as the card's rectangular A.A^T); the banded one has offsets whose
    transposes differ from them, so B = A^T has other bands than A."""
    if kind == "rectangular":
        jcoo = uniform_random(1200, 600, 4800, seed=3)
    else:
        jcoo = banded(600, bands=(0, 1, -1, 5, -7), seed=2)
    coo = _coo(jcoo.rows, jcoo.cols, jcoo.vals, tuple(jcoo.shape))
    rec, res = run_benchmark(coo, kind, SpGEMMConfig(repeat=1, warmup=0),
                             aat=True, verbose=False, device=CPU)
    jrec, jres = j_run_benchmark(
        jcoo, kind, _jax_config(dict(engine="auto", repeat=1, warmup=0)),
        aat=True, verbose=False)
    assert res.engine == jres.engine == engine
    assert tuple(res.shape) == tuple(jres.shape) == (coo.shape[0],) * 2
    assert rec.c_nnz == jrec.c_nnz and rec.flop == jrec.flop
    _same_as_jax(res, jres)


def test_structurally_empty_product():
    # A's columns never hit an occupied B row: an empty C is a result
    a = _coo([0, 1], [40, 41], [1.0, 2.0], (64, 64))
    b = _coo([0, 1], [3, 4], [1.0, 2.0], (64, 64))
    ta = coo_to_tiled(a, device=CPU)
    tb = coo_to_tiled(b, device=CPU)
    for cfg in (SpGEMMConfig(engine="fused"),
                SpGEMMConfig(engine="element"),
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
    # a tile-level pair exists but the element product is empty: exact 0
    r0 = SpGEMM(SpGEMMConfig(engine="fused"))(t, t)
    assert r0.c_nnz == 0 and r0.n_pairs == 1 and r0.to_coo().nnz == 0
    # the element engine counts products directly: structurally empty
    r1 = SpGEMM(SpGEMMConfig(engine="element"))(t, t)
    assert r1.c_nnz == 0 and r1.to_coo().nnz == 0
    coo2 = _coo([7], [7], [3.0], (16, 16))
    for dtype, engine, impl in ((torch.float32, "element", "binned"),
                                (torch.float32, "element", "merge"),
                                (torch.float64, "element", "binned"),
                                (torch.float32, "fused", "binned")):
        t2 = coo_to_tiled(coo2, dtype=dtype, device=CPU)
        r = SpGEMM(SpGEMMConfig(engine=engine, dtype=dtype,
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


@pytest.mark.parametrize("engine", ["fused", "element", "macro"])
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


def test_values_bf16_dtype():
    """bfloat16 values on the fused engine with float32 accumulation, as
    tests/test_edge.py runs them: exact C_nnz, values within bfloat16's
    reach of scipy's, and the JAX package's structure and values (both
    round the float32 sums to bfloat16 the same way).  The element engine
    takes bfloat16 too (through the merge engine), with the same structure
    (tests/test_torch_bf16.py holds every engine's values)."""
    jcoo = banded(n=200, bands=(0, 1, -1), seed=3)
    coo = COOMatrix(np.asarray(jcoo.rows), np.asarray(jcoo.cols),
                    np.asarray(jcoo.vals), tuple(jcoo.shape))
    t = coo_to_tiled(coo, dtype=torch.bfloat16, device=CPU)
    cfg = dict(engine="fused", acc_dtype=torch.float32, numeric_chunk=1 << 10)
    r = SpGEMM(SpGEMMConfig(dtype=torch.bfloat16, **cfg))(t, t)
    s = coo.to_scipy().tocsr()
    assert r.c_nnz == (s @ s).nnz and r.vals.dtype == torch.bfloat16
    c = r.to_coo()
    dense = np.zeros(c.shape, np.float32)
    dense[c.rows, c.cols] = c.vals
    np.testing.assert_allclose(dense, (s @ s).toarray(), rtol=2e-2,
                               atol=1e-2)
    jt = j_coo_to_tiled(jcoo, dtype=jnp.bfloat16)
    jr = JSpGEMM(JConfig(engine="fused", dtype=jnp.bfloat16,
                         acc_dtype=jnp.float32, numeric_chunk=1 << 10))(jt, jt)
    jc = jr.to_coo()
    np.testing.assert_array_equal(c.rows, np.asarray(jc.rows))
    np.testing.assert_array_equal(c.cols, np.asarray(jc.cols))
    np.testing.assert_array_equal(c.vals, np.asarray(jc.vals, np.float32))
    re = SpGEMM(SpGEMMConfig(engine="element", dtype=torch.bfloat16))(t, t)
    ce = re.to_coo()
    assert re.c_nnz == r.c_nnz and re.vals.dtype == torch.bfloat16
    np.testing.assert_array_equal(ce.rows, c.rows)
    np.testing.assert_array_equal(ce.cols, c.cols)
