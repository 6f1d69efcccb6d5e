"""The port's plain CSR SpGEMM oracle (ops/csr.py) against scipy and
against the JAX package's csr_spgemm on the same inputs (a mirror of
tests/test_csr.py)."""

import numpy as np
import pytest
import torch

from conftest import random_sparse
from test_torch_util import one_torch_thread, xla_unoptimized
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.ops.csr import csr_spgemm as j_csr_spgemm
from pem_spgemm_tpu_torch import SpGEMM, SpGEMMConfig
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled
from pem_spgemm_tpu_torch.ops.csr import csr_spgemm

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

CPU = "cpu"


@pytest.mark.parametrize("n,density,seed", [
    (50, 0.1, 0), (300, 0.01, 1), (128, 0.05, 2),
])
def test_csr_squared(n, density, seed):
    m = random_sparse(n, n, density, seed)
    got = csr_spgemm(COOMatrix.from_scipy(m), COOMatrix.from_scipy(m),
                     device=CPU)
    want = (m @ m).tocsr()
    want.sum_duplicates()
    g = got.to_scipy().tocsr()
    assert g.nnz == want.nnz
    assert (g.indices == want.indices).all()
    np.testing.assert_allclose(g.data, want.data, rtol=1e-4, atol=1e-5)
    # the JAX package's oracle on the same triplets: the same sorted COO
    j = j_csr_spgemm(JCOO.from_scipy(m), JCOO.from_scipy(m))
    np.testing.assert_array_equal(got.rows, np.asarray(j.rows))
    np.testing.assert_array_equal(got.cols, np.asarray(j.cols))
    np.testing.assert_allclose(got.vals, np.asarray(j.vals), rtol=1e-5,
                               atol=1e-6)


def test_csr_rectangular():
    a = random_sparse(40, 90, 0.05, 3)
    b = random_sparse(90, 25, 0.08, 4)
    got = csr_spgemm(COOMatrix.from_scipy(a), COOMatrix.from_scipy(b),
                     device=CPU).to_scipy().toarray()
    np.testing.assert_allclose(got, (a @ b).toarray(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="shape mismatch"):
        csr_spgemm(COOMatrix.from_scipy(a), COOMatrix.from_scipy(a),
                   device=CPU)


def test_csr_empty_product():
    a = COOMatrix(np.array([0]), np.array([5]), np.array([1.0]), (8, 8))
    b = COOMatrix(np.array([0]), np.array([5]), np.array([1.0]), (8, 8))
    got = csr_spgemm(a, b, device=CPU)
    assert got.nnz == 0 and got.shape == (8, 8)


def test_csr_float64_is_exact_to_scipy():
    m = random_sparse(200, 200, 0.03, 5)
    m.data = m.data * 1e8 + 1.0             # float32 rounding would show
    got = csr_spgemm(COOMatrix.from_scipy(m), COOMatrix.from_scipy(m),
                     dtype=torch.float64, device=CPU)
    want = (m @ m).tocoo()
    want.sum_duplicates()
    o = np.lexsort((want.col, want.row))
    assert got.vals.dtype == np.float64 and got.nnz == want.nnz
    np.testing.assert_allclose(got.vals, want.data[o], rtol=1e-12)


def test_csr_matches_tiled_pipeline():
    m = random_sparse(200, 200, 0.02, 7)
    coo = COOMatrix.from_scipy(m)
    oracle = csr_spgemm(coo, coo, device=CPU).to_scipy().tocsr()
    a = coo_to_tiled(coo, device=CPU)
    b = coo_to_tiled(coo, with_tmasks=True, device=CPU)
    res = SpGEMM(SpGEMMConfig(numeric_chunk=1 << 10))(a, b)
    got = res.to_coo().to_scipy().tocsr()
    assert res.c_nnz == oracle.nnz
    np.testing.assert_allclose(got.data, oracle.data, rtol=1e-4, atol=1e-5)
