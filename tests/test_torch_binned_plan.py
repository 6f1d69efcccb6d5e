"""The port's chunk tables and binned plans against the JAX package's on
the same numpy inputs: every plan array equal exactly.

Every sort in both planners is stable, so all orderings are defined and
the comparison is array by array, not per segment as sets.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import random_sparse
from test_torch_util import assert_same, both_tiled
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import power_law
from pem_spgemm_tpu.ops import binned as jb
from pem_spgemm_tpu_torch.ops import binned as tb


def _hub_matrix():
    """Single-element A rows pointing at long B rows: the element-window
    stream engages (as in tests/test_binned.py)."""
    rs = np.random.default_rng(21)
    n = 4000
    rows_l, cols_l = [], []
    for hub, ln in [(7, 500), (11, 128), (13, 129), (17, 1000), (23, 37)]:
        rows_l.append(np.full(ln, hub))
        cols_l.append(rs.choice(n, ln, replace=False))
    for i, hub in zip(range(100, 400), [7, 11, 13, 17, 23] * 60):
        rows_l.append([i])
        cols_l.append([hub])
    rows = np.concatenate(rows_l).astype(np.int64)
    cols = np.concatenate([np.asarray(c) for c in cols_l]).astype(np.int64)
    m = sp.coo_matrix((rs.standard_normal(len(rows)), (rows, cols)),
                      shape=(n, n))
    m.sum_duplicates()
    return JCOO.from_scipy(m)


_MATRICES = {
    "power_law": lambda: power_law(n=2500, nnz=12000, seed=4,
                                   hub_correlation=0.25),
    "uniform": lambda: JCOO.from_scipy(random_sparse(900, 900, 0.003,
                                                     seed=7)),
    "hubs": _hub_matrix,
}
_tiled_cache = {}


def _tiled(name):
    """(JAX, port) operands, built once per test process: the planners
    cache their products on the operand."""
    if name not in _tiled_cache:
        _tiled_cache[name] = both_tiled(_MATRICES[name]())
    return _tiled_cache[name]


@pytest.mark.parametrize("w", [None, 8, 16, 32, 64])
@pytest.mark.parametrize("name", ["power_law", "uniform"])
def test_chunk_b_tables_equal(name, w):
    ja, ta = both_tiled(_MATRICES[name]())
    jc, tc = jb.chunk_b(ja, w), tb.chunk_b(ta, w)
    assert_same(jc, tc, "chunked_b")
    assert tc.nc == jc.nc
    assert tb.chunk_b(ta, w) is tc                  # cached on the operand


def test_chunk_b_wide_column_space_has_no_fine_tables():
    # n_cols >= 2^24: f32 columns would lose exactness, so no fine tables
    rows = np.array([0, 1, 1, 2], np.int32)
    cols = np.array([5, 0, (1 << 24) + 3, 2], np.int32)
    coo = JCOO(rows, cols, np.ones(4, np.float32), (3, (1 << 24) + 8))
    ja, ta = both_tiled(coo)
    jc, tc = jb.chunk_b(ja), tb.chunk_b(ta)
    assert tc.fine is None
    assert_same(jc, tc, "chunked_b")


@pytest.mark.parametrize("name", ["power_law", "uniform", "hubs"])
def test_pick_w_equal(name):
    ja, ta = _tiled(name)
    assert tb.pick_w(ta, ta) == jb.pick_w(ja, ja)
    assert tb.pick_w(ta, ta, w_max=16) <= 64


@pytest.mark.parametrize("name,kw", [
    ("power_law", dict()),
    ("power_law", dict(pack=False)),
    ("power_law", dict(max_chunks=2)),
    ("uniform", dict()),
    ("hubs", dict()),
], ids=["power_law-packed", "power_law-chunk_granular",
        "power_law-residual", "uniform-packed", "hubs-packed"])
def test_build_plan_device_arrays_equal(name, kw):
    ja, ta = _tiled(name)
    jp = jb.build_plan_device(ja, ja, **kw)
    tp = tb.build_plan_device(ta, ta, **kw)
    assert_same(jp, tp, "plan")
    if name == "hubs":
        assert tp.win is not None
    if kw == dict(pack=False):
        assert [b for b in tp.buckets if not b.single] and not tp.packed
    if kw == dict(max_chunks=2):
        assert tp.n_res_chunks > 0
    if name == "power_law" and not kw:
        assert tp.packed and not tp.buckets


def test_plan_is_cached_per_operand_pair_and_key():
    coo = power_law(n=1200, nnz=5000, seed=8, hub_correlation=0.2)
    _, ta = both_tiled(coo)
    _, tb2 = both_tiled(coo)
    p1 = tb.build_plan_device(ta, ta)
    assert tb.build_plan_device(ta, ta) is p1       # layout reused
    assert tb.build_plan_device(ta, ta, pack=False) is not p1
    assert tb.build_plan_device(ta, tb2) is not p1  # another B operand
    assert ta._pick_w_cache[0]() is tb2


def test_empty_product_plan_equal():
    a = JCOO(np.array([0, 1], np.int32), np.array([10, 11], np.int32),
             np.array([2.0, 3.0], np.float32), (32, 32))
    b = JCOO(np.array([3], np.int32), np.array([5], np.int32),
             np.array([4.0], np.float32), (32, 32))
    ja, ta = both_tiled(a)
    jbm, tbm = both_tiled(b)
    jp, tp = jb.build_plan_device(ja, jbm), tb.build_plan_device(ta, tbm)
    assert tp.n_products == 0 and not tp.buckets
    assert_same(jp, tp, "plan")


def test_rectangular_plan_equal():
    a = JCOO.from_scipy(random_sparse(300, 500, 0.01, seed=1))
    b = JCOO.from_scipy(random_sparse(500, 200, 0.01, seed=2))
    ja, ta = both_tiled(a)
    jbm, tbm = both_tiled(b)
    assert_same(jb.build_plan_device(ja, jbm, pack=False),
                tb.build_plan_device(ta, tbm, pack=False), "plan")
