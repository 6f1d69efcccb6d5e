"""The port's binned element engine (pem_spgemm_tpu_torch/ops/binned.py):
the cases of tests/test_binned.py, each held against scipy AND against the
JAX package's stream on the same numpy inputs.

Rows, cols and C_nnz must be equal exactly; values to rtol=1e-5 / atol=1e-6
(duplicate groups sum in a different member order).  The port has no host
planner, so it plans with build_plan_device wherever tests/test_binned.py
calls build_plan; the JAX side keeps its (much quicker to compile) host
planner for the stream it is compared with, except where a case is about
the device plan itself.
"""

import jax
import numpy as np
import scipy.sparse as sp
import torch

from conftest import random_sparse
from test_torch_util import both_tiled, scipy_product, to_np
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import power_law
from pem_spgemm_tpu.ops import binned as jb
from pem_spgemm_tpu_torch import interop
from pem_spgemm_tpu_torch.config import SpGEMMConfig as TConfig
from pem_spgemm_tpu_torch.ops import binned as tb
from pem_spgemm_tpu_torch.ops import segment_sort as ss
from pem_spgemm_tpu_torch.ops.spgemm import SpGEMM as TSpGEMM


def _coo_of(stream):
    stream.c_nnz = int(stream.c_nnz)
    return stream.to_coo_arrays()


def _assert_stream(got, want_rows, want_cols, want_vals, what):
    r, c, v = got
    np.testing.assert_array_equal(r, want_rows, err_msg=what)
    np.testing.assert_array_equal(c, want_cols, err_msg=what)
    np.testing.assert_allclose(v, want_vals, rtol=1e-5, atol=1e-6,
                               err_msg=what)


def _check(coo, b_coo=None, jax_plan=None, vmem_sort=False, **plan_kw):
    """Port device plan + multiply vs scipy and vs the JAX stream."""
    ja, ta = both_tiled(coo)
    jbm, tbm = (ja, ta) if b_coo is None else both_tiled(b_coo)
    wr, wc, wv, wnnz = scipy_product(coo, b_coo)
    plan = tb.build_plan_device(ta, tbm, **plan_kw)
    stream = tb.binned_multiply(plan, vmem_sort=vmem_sort)
    got = _coo_of(stream)
    assert stream.c_nnz == wnnz, (stream.c_nnz, wnnz)
    _assert_stream(got, wr, wc, wv, "port vs scipy")
    if jax_plan is None:
        jkw = {k: v for k, v in plan_kw.items() if k != "pack"}
        jax_plan = jb.build_plan(ja, jbm, **jkw)
    else:
        jax_plan = jax_plan(ja, jbm)
    jstream = jb.binned_multiply(jax_plan)
    jgot = _coo_of(jstream)
    assert stream.c_nnz == jstream.c_nnz
    assert plan.n_products == jax_plan.n_products
    _assert_stream(got, *jgot, "port vs JAX stream")
    return plan, jax_plan, ta, tbm


def test_binned_power_law():
    _check(power_law(n=3000, nnz=9000, seed=3, hub_correlation=0.1))


def test_binned_uniform():
    _check(JCOO.from_scipy(random_sparse(900, 900, 0.003, seed=7)))


def test_binned_rectangular():
    a = JCOO.from_scipy(random_sparse(300, 500, 0.01, seed=1))
    b = JCOO.from_scipy(random_sparse(500, 200, 0.01, seed=2))
    _check(a, b)


def test_binned_residual_path():
    # tiny max_chunks forces most rows through the residual stream
    coo = power_law(n=2000, nnz=8000, seed=5, hub_correlation=0.2)
    plan, jplan, _, _ = _check(coo, max_chunks=2)
    assert plan.n_res_chunks > 0, "expected residual rows at max_chunks=2"
    assert plan.n_res_chunks == jplan.n_res_chunks


def test_binned_cancellation_keeps_structure():
    # +1 and -1 products on the same (i, j): value 0.0 but structurally
    # present (exact-structure semantics, like the reference)
    rows = np.array([0, 0, 1, 2], np.int32)
    cols = np.array([1, 2, 3, 3], np.int32)
    vals = np.array([1.0, 1.0, 1.0, -1.0], np.float32)
    coo = JCOO(rows, cols, vals, (4, 4))
    ja, ta = both_tiled(coo)
    stream = tb.binned_multiply(tb.build_plan_device(ta, ta))
    r, c, v = _coo_of(stream)
    m = coo.to_scipy().toarray()
    want_nnz = int((((m != 0).astype(int) @ (m != 0).astype(int)) != 0).sum())
    assert stream.c_nnz == want_nnz
    i = np.nonzero((r == 0) & (c == 3))[0]
    assert len(i) == 1 and v[i[0]] == 0.0
    jr, jc, jv = _coo_of(jb.binned_multiply(jb.build_plan(ja, ja)))
    _assert_stream((r, c, v), jr, jc, jv, "port vs JAX stream")


def test_binned_through_spgemm_api():
    coo = power_law(n=4000, nnz=14000, seed=11, hub_correlation=0.15)
    ja, ta = both_tiled(coo)
    r = TSpGEMM(TConfig(engine="element"))(ta, ta)
    assert r.binned is not None, "f32 element path must use the binned impl"
    wr, wc, wv, wnnz = scipy_product(coo)
    assert r.c_nnz == wnnz
    got = r.to_coo()
    _assert_stream((got.rows, got.cols, got.vals), wr, wc, wv,
                   "port vs scipy")
    # the JAX stream of the same product (the two SpGEMM front ends are
    # compared with each other in tests/test_torch_spgemm.py)
    jplan = jb.build_plan(ja, ja)
    assert r.n_pairs == jplan.n_products
    _assert_stream((got.rows, got.cols, got.vals),
                   *_coo_of(jb.binned_multiply(jplan)), "port vs JAX stream")


def test_binned_empty_b_rows():
    # A columns referencing empty B rows produce nothing
    a = JCOO(np.array([0, 1], np.int32), np.array([10, 11], np.int32),
             np.array([2.0, 3.0], np.float32), (32, 32))
    b = JCOO(np.array([10], np.int32), np.array([5], np.int32),
             np.array([4.0], np.float32), (32, 32))
    plan, _, _, _ = _check(a, b)
    assert plan.n_products == 1
    r, c, v = _coo_of(tb.binned_multiply(plan))
    assert r[0] == 0 and c[0] == 5 and v[0] == 8.0


def test_device_plan_matches_host_plan():
    """The port's device plan against the JAX package's device plan: the
    same C from both, and the JAX plan, handed over as numpy through
    interop.plan_from_numpy, gives the same C through the port's multiply
    (so a mismatch would be pinned to the planner or to the multiply)."""
    coo = power_law(n=3000, nnz=10000, seed=21, hub_correlation=0.2)
    plan, jplan, _, _ = _check(
        coo, jax_plan=lambda ja, jbm: jb.build_plan_device(ja, jbm))
    handed = interop.plan_from_numpy(to_np(jplan), device="cpu")
    assert handed.n_products == plan.n_products
    assert len(handed.packed) == len(plan.packed) > 0
    own = _coo_of(tb.binned_multiply(plan))
    via = _coo_of(tb.binned_multiply(handed))
    np.testing.assert_array_equal(via[0], own[0])
    np.testing.assert_array_equal(via[1], own[1])
    np.testing.assert_array_equal(via[2], own[2])   # same plan, same bits


def test_device_plan_residual():
    coo = power_law(n=2000, nnz=8000, seed=5, hub_correlation=0.2)
    plan, _, _, _ = _check(coo, max_chunks=2, pack=False)
    assert plan.n_res_chunks > 0


def test_dup_free_split_exact():
    # the plan must route duplicate-free products to the sort-free
    # streams and keep truly-colliding chunks on narrow sort sub-buckets,
    # staying exact on a hub-heavy matrix where both paths carry real rows
    coo = power_law(n=3000, nnz=15000, seed=9, hub_correlation=0.3)
    plan, _, _, _ = _check(coo)
    assert plan.fine or plan.coarse is not None, \
        "no dup-free stream (fine/coarse) was split out"
    assert plan.packed, \
        "no packed collision class survived (test matrix too easy)"
    assert all(p.rounds >= 1 for p in plan.packed)


def test_vmem_sort_matches_xla_path():
    # the sort+dedup entry (its plain version on the CPU) and the
    # torch.sort bucket path must agree per bucket, and both with the JAX
    # package's bucket_multiply on the same bucket, across ragged widths
    coo = power_law(n=2500, nnz=12000, seed=4, hub_correlation=0.25)
    ja, ta = both_tiled(coo)
    plan = tb.build_plan_device(ta, ta, pack=False)
    jtable = jax.numpy.asarray(plan.table.numpy())
    checked = 0
    for b in plan.buckets:
        if b.single or b.m * plan.w > tb.VMEM_SORT_MAX:
            continue                    # wider segments never reach it
        k0, v0, f0, c0 = tb.bucket_multiply(plan.table, b.src, b.avals,
                                            b.m, plan.w, b.rounds)
        k1, v1, f1, c1 = tb.bucket_multiply_vmem(plan.table, b.src, b.avals,
                                                 b.m, plan.w, b.rounds)
        kj, vj, fj, cj = jb.bucket_multiply(
            jtable, jax.numpy.asarray(b.src.numpy()),
            jax.numpy.asarray(b.avals.numpy()), b.m, plan.w, b.rounds)
        for k, f, c in ((k1, f1, c1), (torch.from_numpy(np.array(kj)),
                                       torch.from_numpy(np.array(fj)),
                                       int(cj))):
            assert torch.equal(k0, k) and torch.equal(f0, f)
            assert int(c0) == int(c)
        fm = f0.numpy()
        np.testing.assert_allclose(v1.numpy()[fm], v0.numpy()[fm],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(vj)[fm], v0.numpy()[fm],
                                   rtol=1e-4, atol=1e-6)
        checked += 1
    assert checked >= 2, "no sort-path buckets exercised"


def test_binned_multiply_vmem_end_to_end():
    # chunk-granular plan with the kernel route switched on: on the CPU the
    # wrapper takes the plain version and launches nothing
    coo = power_law(n=2000, nnz=10000, seed=6, hub_correlation=0.3)
    ss.reset_launch_counts()
    plan, _, _, _ = _check(coo, vmem_sort=True, pack=False)
    assert [b for b in plan.buckets if not b.single]
    assert ss.LAUNCHES == {"segment_sort_dedup": 0, "segment_dedup": 0}


def test_window_singles_path_exact():
    # rows with ONE A element hitting long B rows (m >= WIN_MIN_M chunks)
    # route through the element-window stream (plan.win); exactness incl.
    # rows straddling multiple windows and short-tail windows
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
    plan, _, _, _ = _check(JCOO.from_scipy(m))
    assert plan.win is not None          # the path actually engaged


def test_packed_collision_exact():
    # the packed collision classes must reproduce the chunk-granular sort
    # path's result exactly (same C structure, fp-tolerant values)
    coo = power_law(n=3000, nnz=18000, seed=21, hub_correlation=0.35)
    p1, jplan, ta, _ = _check(coo)
    p0 = tb.build_plan_device(ta, ta, pack=False)
    assert p1.packed, "packing produced no classes"
    assert not [b for b in p1.buckets if not b.single]
    assert [b for b in p0.buckets if not b.single] and not p0.packed
    s1 = _coo_of(tb.binned_multiply(p1))
    for vmem_sort in (False, True):
        s0 = _coo_of(tb.binned_multiply(p0, vmem_sort=vmem_sort))
        _assert_stream(s0, *s1, "chunk-granular vs packed")
