"""COO -> Tile16 conversion and the element CSR of the port against the
JAX package on the same numpy inputs: every array equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_sparse
from test_torch_util import assert_same, both_coo, both_tiled
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import power_law
from pem_spgemm_tpu.ops import scanops as j_scanops
from pem_spgemm_tpu.ops.convert import coo_to_tiled as j_coo_to_tiled
from pem_spgemm_tpu.ops.convert import transpose_masks as j_transpose_masks
from pem_spgemm_tpu_torch.formats.coo import COOMatrix as TCOO
from pem_spgemm_tpu_torch.ops import scanops as t_scanops
from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled as t_coo_to_tiled
from pem_spgemm_tpu_torch.ops.convert import transpose_masks \
    as t_transpose_masks


def _matrix(kind):
    if kind == "square":
        return JCOO.from_scipy(random_sparse(200, 200, 0.02, seed=1))
    if kind == "wide":
        return JCOO.from_scipy(random_sparse(70, 333, 0.03, seed=2))
    if kind == "tall":
        return JCOO.from_scipy(random_sparse(500, 33, 0.03, seed=3))
    if kind == "dense_tiles":
        return JCOO.from_scipy(random_sparse(64, 64, 0.5, seed=4))
    return power_law(n=3000, nnz=9000, seed=3, hub_correlation=0.1)


KINDS = ["square", "wide", "tall", "dense_tiles", "power_law"]


@pytest.mark.parametrize("kind", KINDS)
def test_tiled_fields_equal(kind):
    ja, ta = both_tiled(_matrix(kind), with_tmasks=True)
    assert_same(ja, ta, "tiled")
    assert ta.tmasks is not None
    assert (ta.nnz, ta.tile_cap, ta.n_tile_rows, ta.n_tile_cols) == \
        (ja.nnz, ja.tile_cap, ja.n_tile_rows, ja.n_tile_cols)
    assert ta.fill_ratio() == ja.fill_ratio()
    assert ta.macro_stats() == ja.macro_stats()


@pytest.mark.parametrize("kind", KINDS)
def test_element_csr_equal(kind):
    ja, ta = both_tiled(_matrix(kind))
    assert_same(ja.element_coords(), ta.element_coords(), "coords")
    assert_same(ja.element_csr(), ta.element_csr(), "ecsr")
    assert ta.element_csr() is ta.element_csr()      # cached


@pytest.mark.parametrize("kind", ["square", "wide"])
def test_roundtrip_to_coo_numpy(kind):
    coo = _matrix(kind)
    ja, ta = both_tiled(coo)
    for x, y in zip(ja.to_coo_numpy(), ta.to_coo_numpy()):
        np.testing.assert_array_equal(x, y)
    r, c, v = ta.to_coo_numpy()
    order = np.lexsort((c, r))
    want = np.lexsort((coo.cols, coo.rows))
    np.testing.assert_array_equal(r[order], coo.rows[want])
    np.testing.assert_array_equal(c[order], coo.cols[want])
    np.testing.assert_allclose(v[order], coo.vals[want].astype(np.float32))


def test_without_tmasks_and_explicit_tile_cap():
    coo = _matrix("square")
    jc, tc = both_coo(coo)
    ja = j_coo_to_tiled(jc, dtype=np.float32, tile_cap=512)
    ta = t_coo_to_tiled(tc, tile_cap=512, device="cpu")
    assert ta.tmasks is None and ta.tile_cap == 512
    assert_same(ja, ta, "tiled")


def test_transpose_masks_equal_and_involutive():
    rs = np.random.default_rng(0)
    masks = rs.integers(0, 1 << 16, (37, 16)).astype(np.int32)
    want = np.asarray(j_transpose_masks(jnp.asarray(masks)))
    got = t_transpose_masks(torch.from_numpy(masks))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_transpose_masks(got).numpy(), masks)


def test_duplicate_coordinates_raise_in_both():
    rows = np.array([0, 0, 5], np.int32)
    cols = np.array([3, 3, 1], np.int32)
    vals = np.array([1.0, 2.0, 3.0], np.float32)
    with pytest.raises(ValueError, match="duplicate coordinates"):
        j_coo_to_tiled(JCOO(rows, cols, vals, (8, 8)), dtype=np.float32)
    with pytest.raises(ValueError, match="duplicate coordinates"):
        t_coo_to_tiled(TCOO(rows, cols, vals, (8, 8)), device="cpu")
    # canonicalised, both accept it and agree
    ja, ta = both_tiled(TCOO(rows, cols, vals, (8, 8)).sum_duplicates())
    assert_same(ja, ta, "tiled")


def test_empty_matrix_raises():
    z = np.zeros(0, np.int32)
    with pytest.raises(ValueError, match="empty"):
        t_coo_to_tiled(TCOO(z, z, np.zeros(0, np.float32), (4, 4)),
                       device="cpu")


def test_tensor_triplets_stay_on_their_device():
    coo = _matrix("wide")
    dev = TCOO(torch.from_numpy(coo.rows), torch.from_numpy(coo.cols),
               torch.from_numpy(coo.vals), coo.shape)
    assert isinstance(dev.rows, torch.Tensor) and dev.nnz == coo.nnz
    ta = t_coo_to_tiled(dev)          # no device argument: the tensors' own
    ja, _ = both_tiled(coo)
    assert_same(ja, ta, "tiled")
    np.testing.assert_array_equal(dev.to_scipy().toarray(),
                                  coo.to_scipy().toarray())
    assert dev.transpose().shape == (coo.shape[1], coo.shape[0])


@pytest.mark.parametrize("offsets,cap", [
    ([0, 2, 2, 5, 9], 12), ([0, 0, 0, 3], 3), ([0, 4, 8], 6)])
def test_segment_ids_from_offsets_equal(offsets, cap):
    off = np.asarray(offsets, np.int32)
    want = np.asarray(j_scanops.segment_ids_from_offsets(jnp.asarray(off),
                                                         cap))
    got = t_scanops.segment_ids_from_offsets(torch.from_numpy(off), cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


@pytest.mark.parametrize("member", ["macro", "dense_flat", "intra_rowptr"])
def test_tile16_members_of_later_slices_raise(member):
    ja, ta = both_tiled(_matrix("square"))
    if member == "macro":
        # slice 3 has landed: the member gives the Macro128 form, equal to
        # the JAX package's
        assert_same(ja.macro(), ta.macro(), "macro")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP slice"):
        getattr(ta, member)()
