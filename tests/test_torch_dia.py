"""DIA engine of the PyTorch port: mirrors of tests/test_dia.py on
device="cpu", and parity with the JAX package on the same numpy inputs.

The CUDA kernels cannot run here; a CPU tensor takes their plain version
(ops.dia._dia_multiply_torch), which is held against scipy, against the JAX
package's XLA path and against its Pallas kernels in interpret mode.  The
kernels' index arithmetic (the dense entry's row mapping, the pairs entry's
CSR table) is replayed in numpy from the same tables the wrapper uploads.
"""

import types

import numpy as np
import pytest
import torch

from test_torch_util import one_torch_thread, xla_unoptimized
from pem_spgemm_tpu.config import SpGEMMConfig as JConfig
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.ops import dia as j_dia
from pem_spgemm_tpu.ops import pallas_dia as j_pd
from pem_spgemm_tpu.ops.spgemm import SpGEMM as JSpGEMM
from pem_spgemm_tpu_torch import interop
from pem_spgemm_tpu_torch.bench.harness import run_benchmark
from pem_spgemm_tpu_torch.config import SpGEMMConfig
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.formats.dia import DiaMatrix
from pem_spgemm_tpu_torch.ops import dia_kernels as dk
from pem_spgemm_tpu_torch.ops.dia import (_dia_multiply_torch, _plan_maps,
                                          coo_to_dia, detect_dia, dia_to_coo,
                                          diag_offsets, make_dia_plan)
from pem_spgemm_tpu_torch.ops.fixed import make_plan
from pem_spgemm_tpu_torch.ops.spgemm import SpGEMM

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

CPU = "cpu"
PAIRBANDS = (0, 1, 60, 61, -60, -61, 120, 121, -120, -121)


def _banded_coo(n, bands, seed=0, n_cols=None):
    rs = np.random.default_rng(seed)
    n_cols = n_cols or n
    rows_l, cols_l = [], []
    for d in bands:
        lo, hi = max(0, -d), min(n, n_cols - d)
        i = np.arange(lo, hi)
        rows_l.append(i)
        cols_l.append(i + d)
    rows = np.concatenate(rows_l).astype(np.int32)
    cols = np.concatenate(cols_l).astype(np.int32)
    vals = rs.standard_normal(len(rows))
    return COOMatrix(rows, cols, vals, (n, n_cols))


def _jax(coo):
    return JCOO(coo.rows, coo.cols, coo.vals, coo.shape)


def _scipy_product(coo, b_coo):
    want = (coo.to_scipy().tocsr() @ b_coo.to_scipy().tocsr()).tocoo()
    want.sum_duplicates()
    order = np.lexsort((want.col, want.row))
    return want, order


def _check_product(coo, b_coo=None, engine="dia"):
    b_coo = b_coo or coo
    a = coo_to_dia(coo, device=CPU)
    b = a if b_coo is coo else coo_to_dia(b_coo, device=CPU)
    assert a is not None and b is not None
    cfg = SpGEMMConfig(engine=engine)
    res = SpGEMM(cfg)(a, b)
    want, order = _scipy_product(coo, b_coo)
    assert res.engine == "dia"
    assert res.c_nnz == want.nnz
    got = res.to_coo()
    np.testing.assert_array_equal(got.rows, want.row[order])
    np.testing.assert_array_equal(got.cols, want.col[order])
    np.testing.assert_allclose(got.vals, want.data[order].astype(np.float32),
                               rtol=2e-5, atol=1e-5)
    return res, a, b, cfg


def _band_reference(coo, b_coo, dc_list):
    """(c_bands, c_counts) from scipy's product and its pattern product."""
    sa, sb = coo.to_scipy().tocsr(), b_coo.to_scipy().tocsr()
    c = (sa @ sb).toarray()
    pat = ((sa != 0).astype(np.float64) @ (sb != 0).astype(np.float64))
    pat = pat.toarray()
    n, m = c.shape
    cb = np.zeros((len(dc_list), n))
    cn = np.zeros((len(dc_list), n))
    for k, dc in enumerate(dc_list):
        i = np.arange(max(0, -dc), min(n, m - dc))
        cb[k, i] = c[i, i + dc]
        cn[k, i] = pat[i, i + dc]
    return cb, cn


def _torch_multiply(a, b, values_only=False):
    dc_list, idx_map = _plan_maps(a.offsets, b.offsets)
    out = _dia_multiply_torch(a.bands, b.bands, offs_a=a.offsets,
                              idx_map=idx_map, dc_count=len(dc_list),
                              n_out=a.shape[0], values_only=values_only)
    return dc_list, out


# --------------------------------------------------------------------------
# mirrors of tests/test_dia.py

def test_round_trip():
    coo = _banded_coo(300, (-7, -1, 0, 2, 11))
    d = coo_to_dia(coo, device=CPU)
    assert d.offsets == (-7, -1, 0, 2, 11)
    assert d.device == torch.device("cpu") and d.n == 300 and d.nbands == 5
    r, c, v = d.to_coo_numpy()
    order = np.lexsort((coo.cols, coo.rows))
    np.testing.assert_array_equal(r, coo.rows[order])
    np.testing.assert_array_equal(c, coo.cols[order])
    np.testing.assert_allclose(v, coo.vals[order].astype(np.float32),
                               rtol=1e-6)


def test_square_tridiagonal():
    _check_product(_banded_coo(257, (-1, 0, 1)))


def test_sparse_nonuniform_offsets():
    _check_product(_banded_coo(400, (0, 1, 60, 61, -60, -61)))


def test_wide_dense_band():
    _check_product(_banded_coo(300, tuple(range(-9, 10))))


def test_asymmetric_offsets():
    _check_product(_banded_coo(200, (-3, 0, 5, 17)))


def test_a_times_b_different_offsets():
    a_coo = _banded_coo(256, (0, 1, 2), seed=1)
    b_coo = _banded_coo(256, (-5, 0, 9), seed=2)
    _check_product(a_coo, b_coo)


def test_rectangular_aat():
    # A (200x300) @ A.T (300x200): offsets differ per operand
    a_coo = _banded_coo(200, (0, 4, 50), n_cols=300, seed=3)
    res, a, b, _ = _check_product(a_coo, a_coo.transpose(), engine="auto")
    assert a.bands.shape == (3, 200) and b.bands.shape == (3, 300)
    assert res.shape == (200, 200)


def test_structural_nnz_survives_cancellation():
    # a C entry sums to exactly zero numerically; the structural counts
    # must keep it
    n = 64
    coo = COOMatrix(np.array([0, 0, 1, 2], np.int32),
                    np.array([1, 2, 3, 3], np.int32),
                    np.array([1.0, 1.0, 1.0, -1.0]), (n, n))
    a = coo_to_dia(coo, device=CPU)
    res = SpGEMM(SpGEMMConfig())(a, a)
    s = coo.to_scipy()
    pattern = ((s != 0).astype(np.int64) @ (s != 0).astype(np.int64))
    assert res.c_nnz == pattern.nnz
    nonzero = (s @ s).tocoo()
    nonzero.eliminate_zeros()
    assert pattern.nnz > nonzero.nnz  # cancellation actually happened
    got = res.to_coo()
    assert (got.rows.tolist(), got.cols.tolist()) == ([0], [3])
    assert got.vals[0] == 0.0


def test_detect_rejects_explicit_zero():
    coo = _banded_coo(100, (0, 1))
    coo.vals[3] = 0.0
    assert detect_dia(coo, device=CPU) is None


def test_detect_rejects_many_diagonals():
    rs = np.random.default_rng(5)
    n = 2000
    rows = rs.integers(0, n, 4000).astype(np.int32)
    cols = rs.integers(0, n, 4000).astype(np.int32)
    coo = COOMatrix(rows, cols, np.ones(4000), (n, n)).sum_duplicates()
    assert detect_dia(coo, max_bands=64, device=CPU) is None
    assert len(diag_offsets(coo, device=CPU)) > 64
    assert coo_to_dia(coo, max_bands=64, device=CPU) is None


def test_fixed_plan_replay_matches_interactive():
    coo = _banded_coo(333, (-2, 0, 3, 40))
    res, a, b, cfg = _check_product(coo)
    plan = make_plan(res, cfg, a, b)
    out = plan.run(a, b)
    assert int(out[2]) == res.c_nnz
    assert not bool(out[3])
    assert plan.grown() is plan and plan.fence(out) is out[0]
    r, c, v = dia_to_coo(out[0], out[1], plan.dc_list, res.shape, res.c_nnz)
    got = res.to_coo()
    np.testing.assert_array_equal(r, got.rows)
    np.testing.assert_array_equal(c, got.cols)
    np.testing.assert_allclose(v, got.vals, rtol=1e-6)


def test_harness_runs_dia_engine():
    coo = _banded_coo(500, (0, 1, 30, 31))
    cfg = SpGEMMConfig(engine="dia", warmup=1, repeat=2)
    record, result = run_benchmark(coo, "dia-banded", cfg, verbose=False,
                                   device=CPU)
    assert result.engine == "dia"
    want, order = _scipy_product(coo, coo)
    assert record.c_nnz == want.nnz
    assert record.steady_state_time > 0 and record.pipelined_time > 0
    # the steady loop released the band stacks and refreshed them
    assert result.vals is not None and result.c_counts is not None
    got = result.to_coo()
    np.testing.assert_array_equal(got.rows, want.row[order])
    np.testing.assert_allclose(got.vals, want.data[order].astype(np.float32),
                               rtol=2e-5, atol=1e-5)


def test_harness_dia_engine_refuses_unqualified_matrix():
    coo = _banded_coo(100, (0, 1))
    coo.vals[3] = 0.0
    with pytest.raises(ValueError, match="does not qualify"):
        run_benchmark(coo, "x", SpGEMMConfig(engine="dia", warmup=0,
                                             repeat=1),
                      verbose=False, device=CPU)


def test_harness_auto_detects_dia():
    coo = _banded_coo(500, (-1, 0, 1))
    cfg = SpGEMMConfig(engine="auto", warmup=0, repeat=1)
    record, result = run_benchmark(coo, "dia-auto", cfg, verbose=False,
                                   device=CPU)
    assert result.engine == "dia"
    assert record.c_nnz == _scipy_product(coo, coo)[0].nnz


def test_harness_auto_falls_back_for_scattered():
    rs = np.random.default_rng(6)
    n = 600
    rows = rs.integers(0, n, 1200).astype(np.int32)
    cols = rs.integers(0, n, 1200).astype(np.int32)
    coo = COOMatrix(rows, cols, rs.standard_normal(1200),
                    (n, n)).sum_duplicates()
    cfg = SpGEMMConfig(engine="auto", warmup=0, repeat=1,
                       dia_max_bands=16)
    record, result = run_benchmark(coo, "dia-fallback", cfg, verbose=False,
                                   device=CPU)
    assert result.engine == "element"
    assert record.c_nnz == _scipy_product(coo, coo)[0].nnz


def test_torch_path_matches_scipy_on_wide_stencil():
    # counterpart of test_pallas_path_interpret_matches_xla: the plain
    # version of the dense kernel against an independent band reference
    coo = _banded_coo(700, tuple(range(-4, 5)), seed=8)
    a = coo_to_dia(coo, device=CPU)
    dc_list, (c, cnt) = _torch_multiply(a, a)
    cb, cn = _band_reference(coo, coo, dc_list)
    np.testing.assert_allclose(c.numpy(), cb, rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt.numpy(), cn)


def test_dense_mode_rejects_gapped_sums():
    # offs_a spaced wider than B's dense range: the C diagonal set has
    # gaps, the dense entry's row mapping would misindex, so the qualifier
    # must refuse and the plan takes the pairs entry
    offs_a = (0, 10)                 # spacing 10 > len(offs_b) = 5
    offs_b = (-2, -1, 0, 1, 2)
    dc_list, _ = _plan_maps(offs_a, offs_b)
    dc_dense = (max(offs_a) + max(offs_b)) - (min(offs_a) + min(offs_b)) + 1
    assert len(dc_list) < dc_dense   # gaps actually exist
    assert not dk.dense_qualifies(offs_a, offs_b, dc_list)
    assert dk.dia_mode(offs_a, offs_b, dc_list) == "pairs"
    a = torch.zeros((2, 32))
    b = torch.zeros((5, 32))
    with pytest.raises(ValueError, match="dense"):
        dk.dia_multiply(a, b, offs_a=offs_a, offs_b=offs_b, dc_list=dc_list,
                        n_out=32, mode="dense")


def test_torch_path_d2_not_multiple_of_8():
    # counterpart of test_pallas_interpret_d2_not_multiple_of_8: one A band
    # against five B bands
    a_coo = _banded_coo(600, (5,), seed=9)
    b_coo = _banded_coo(600, (-2, -1, 0, 1, 2), seed=10)
    a = coo_to_dia(a_coo, device=CPU)
    b = coo_to_dia(b_coo, device=CPU)
    dc_list, (c, cnt) = _torch_multiply(a, b)
    cb, cn = _band_reference(a_coo, b_coo, dc_list)
    np.testing.assert_allclose(c.numpy(), cb, rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt.numpy(), cn)


def test_fixed_plan_count_cache_second_run():
    # DiaPlan caches the structural counts after the first run; the second
    # (values-only) run must return identical values, counts and nnz
    coo = _banded_coo(400, (-3, 0, 2, 25), seed=17)
    res, a, b, cfg = _check_product(coo)
    plan = make_plan(res, cfg, a, b)
    assert getattr(plan, "_cnt_cache", None) is None
    out1 = plan.run(a, b)
    assert getattr(plan, "_cnt_cache", None) is not None
    out2 = plan.run(a, b)
    np.testing.assert_array_equal(out2[0].numpy(), out1[0].numpy())
    assert out2[1] is out1[1]
    assert int(out2[2]) == int(out1[2]) == res.c_nnz


def test_torch_path_values_only():
    coo = _banded_coo(500, tuple(range(-4, 5)), seed=18)
    a = coo_to_dia(coo, device=CPU)
    _, (c_full, cnt) = _torch_multiply(a, a)
    _, (c_vo, none) = _torch_multiply(a, a, values_only=True)
    assert none is None and cnt is not None
    np.testing.assert_array_equal(c_vo.numpy(), c_full.numpy())


def test_torch_path_gapped_bands_matches_scipy():
    # counterpart of test_pallas_pairs_kernel_interpret_matches_xla
    coo = _banded_coo(900, PAIRBANDS, seed=21)
    a = coo_to_dia(coo, device=CPU)
    dc_list, (c, cnt) = _torch_multiply(a, a)
    assert len(dc_list) < 2 * (max(PAIRBANDS) - min(PAIRBANDS)) + 1
    cb, cn = _band_reference(coo, coo, dc_list)
    np.testing.assert_allclose(c.numpy(), cb, rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt.numpy(), cn)


def test_mode_selection():
    # counterpart of test_pallas_mode_selects_pairs_for_gapped_bands: only
    # the structural precondition decides
    bands = tuple(sorted(b * 10 for b in PAIRBANDS))
    dc_list, _ = _plan_maps(bands, bands)
    assert dk.dia_mode(bands, bands, dc_list) == "pairs"
    dense_bands = tuple(range(-8, 8))
    dcd, _ = _plan_maps(dense_bands, dense_bands)
    assert dk.dia_mode(dense_bands, dense_bands, dcd) == "dense"
    # no profitability gate: a tiny product still launches
    assert dk.dia_mode((0,), (0,), (0,)) == "dense"
    # no staged window: a span of millions of columns is still 'pairs'
    wide = tuple(b * 1000 for b in bands)
    dcw, _ = _plan_maps(wide, wide)
    assert dk.dia_mode(wide, wide, dcw) == "pairs"
    assert dk.dia_mode((), (), ()) is None
    # every plan records its entry: no option turns the kernels off
    a = coo_to_dia(_banded_coo(200, (-1, 0, 1)), device=CPU)
    assert make_dia_plan(a, a).kernel_mode == "dense"
    g = coo_to_dia(_banded_coo(200, (-40, 0, 40)), device=CPU)
    assert make_dia_plan(g, g).kernel_mode == "pairs"


# --------------------------------------------------------------------------
# the kernels' index arithmetic, replayed from the uploaded tables

def _replay_dense(a, b, offs_a, dcn, n_out):
    """What dia_dense_kernel computes: row r of C takes, per A band k1, the
    B band k2 = r - (offs_a[k1] - offs_a[0])."""
    d2n, n_k = b.shape
    c = np.zeros((dcn, n_out), np.float32)
    cnt = np.zeros((dcn, n_out), np.float32)
    i = np.arange(n_out)
    for r in range(dcn):
        for k1, d1 in enumerate(offs_a):
            k2 = r - (d1 - offs_a[0])
            if not 0 <= k2 < d2n:
                continue
            ok = (i + d1 >= 0) & (i + d1 < n_k)
            j = np.clip(i + d1, 0, n_k - 1)
            av, bv = a[k1, :n_out], np.where(ok, b[k2, j], 0)
            c[r] += av * bv
            cnt[r] += (av != 0) & (bv != 0)
    return c, cnt


def _replay_pairs(a, b, row_ptr, trip, n_out):
    n_k = b.shape[1]
    dcn = len(row_ptr) - 1
    c = np.zeros((dcn, n_out), np.float32)
    cnt = np.zeros((dcn, n_out), np.float32)
    i = np.arange(n_out)
    for r in range(dcn):
        for k1, k2, d1 in trip[row_ptr[r]:row_ptr[r + 1]]:
            ok = (i + d1 >= 0) & (i + d1 < n_k)
            j = np.clip(i + d1, 0, n_k - 1)
            av, bv = a[k1, :n_out], np.where(ok, b[k2, j], 0)
            c[r] += av * bv
            cnt[r] += (av != 0) & (bv != 0)
    return c, cnt


@pytest.mark.parametrize("case", [
    ("stencil", (-4, -3, -2, -1, 0, 1, 2, 3), None, 301, None),
    ("d2=5", (5,), (-2, -1, 0, 1, 2), 203, None),
    ("gapped a", (0, 2, 4), (-3, -2, -1, 0), 157, None),
    ("rect", (-1, 0, 1, 2), (-2, -1, 0), 120, 170),
    ("near n", (97, 98, 99), (-1, 0, 1), 100, None),
    ("pairbands", tuple(sorted(PAIRBANDS)), None, 400, None),
    ("sparse sums", (0, 10), (-2, -1, 0, 1, 2), 90, None),
], ids=lambda c: c[0])
def test_kernel_tables_reproduce_plain_version(case):
    _, offs_a, offs_b, n, n_k = case
    offs_b = offs_b or offs_a
    n_k = n_k or n
    a_coo = _banded_coo(n, offs_a, seed=31, n_cols=n_k)
    b_coo = _banded_coo(n_k, offs_b, seed=32, n_cols=n)
    a = coo_to_dia(a_coo, device=CPU)
    b = coo_to_dia(b_coo, device=CPU)
    assert a.offsets == tuple(offs_a) and b.offsets == tuple(offs_b)
    dc_list, (c, cnt) = _torch_multiply(a, b)
    an, bn = a.bands.numpy(), b.bands.numpy()
    mode = dk.dia_mode(a.offsets, b.offsets, dc_list)
    row_ptr, trip = (t.numpy() for t in dk.dia_tables(
        a.offsets, b.offsets, dc_list, "pairs", CPU))
    assert row_ptr[-1] == len(offs_a) * len(offs_b) == len(trip)
    for r in range(len(dc_list)):       # ascending A band within a C row
        k1 = trip[row_ptr[r]:row_ptr[r + 1], 0]
        assert (np.diff(k1) > 0).all()
    cp, np_ = _replay_pairs(an, bn, row_ptr, trip, n)
    np.testing.assert_allclose(cp, c.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np_, cnt.numpy())
    if mode == "dense":
        (offs_dev,) = dk.dia_tables(a.offsets, b.offsets, dc_list, "dense",
                                    CPU)
        cd, nd = _replay_dense(an, bn, offs_dev.numpy().tolist(),
                               len(dc_list), n)
        np.testing.assert_allclose(cd, c.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(nd, cnt.numpy())
    else:
        assert case[0] in ("pairbands", "sparse sums")


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    coo = _banded_coo(150, (-1, 0, 1, 2), seed=4)
    a = coo_to_dia(coo, device=CPU)
    dc_list, (c, cnt) = _torch_multiply(a, a)
    dk.reset_launch_counts()
    for mode in ("dense", "pairs"):
        for values_only in (False, True):
            gc, gn = dk.dia_multiply(a.bands, a.bands, offs_a=a.offsets,
                                     offs_b=a.offsets, dc_list=dc_list,
                                     n_out=150, mode=mode,
                                     values_only=values_only)
            np.testing.assert_array_equal(gc.numpy(), c.numpy())
            assert (gn is None) if values_only else torch.equal(gn, cnt)
    assert dk.LAUNCHES == {"dia_multiply_dense": 0, "dia_multiply_pairs": 0,
                           "dia_multiply_dense_f64": 0,
                           "dia_multiply_pairs_f64": 0}


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((3, 40))
    kw = dict(offs_a=(-1, 0, 1), offs_b=(-1, 0, 1),
              dc_list=(-2, -1, 0, 1, 2), n_out=40)
    with pytest.raises(TypeError, match="float32"):
        dk.dia_multiply(a.double(), a, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        dk.dia_multiply(torch.zeros((40, 3)).T, a, **kw)
    with pytest.raises(ValueError, match="do not match"):
        dk.dia_multiply(a[:2], a, **kw)
    with pytest.raises(ValueError, match="n_out"):
        dk.dia_multiply(a, a, **{**kw, "n_out": 41})
    with pytest.raises(ValueError, match="unknown mode"):
        dk.dia_multiply(a, a, mode="window", **kw)
    with pytest.raises(ValueError, match="offset sums"):
        dk.dia_multiply(a, a, **{**kw, "dc_list": (-2, -1, 0, 1, 3)})


def test_non_f32_bands_take_the_torch_path():
    coo = _banded_coo(180, (-2, 0, 1), seed=6)
    a64 = coo_to_dia(coo, dtype=torch.float64, device=CPU)
    res = SpGEMM(SpGEMMConfig(dtype=torch.float64))(a64, a64)
    want, order = _scipy_product(coo, coo)
    assert res.c_nnz == want.nnz and res.vals.dtype == torch.float64
    np.testing.assert_allclose(res.to_coo().vals, want.data[order],
                               rtol=1e-12, atol=1e-12)
    # only because the bands lie on the CPU: the device alone picks the
    # path, and on the GPU the kernels take float32 or float64 (their
    # float64 entries) and raise on any other dtype (a stand-in operand,
    # since there is no card here)
    gpu16 = types.SimpleNamespace(bands=types.SimpleNamespace(
        is_cuda=True, dtype=torch.float16))
    with pytest.raises(NotImplementedError, match="float32 or float64"):
        make_dia_plan(a64, a64)._multiply(gpu16, gpu16, False)


def test_empty_offsets_give_an_empty_result():
    empty = DiaMatrix(bands=torch.zeros((0, 8)), shape=(8, 8), offsets=(),
                      nnz=0)
    res = SpGEMM(SpGEMMConfig())(empty, empty)
    assert res.engine == "dia" and res.c_nnz == 0
    assert res.to_coo().nnz == 0


def test_numpy_coo_with_device_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the GPU here")
    coo = _banded_coo(50, (0, 1))
    for fn in (diag_offsets, detect_dia, coo_to_dia):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(coo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.dia_from_numpy(dict(bands=np.zeros((1, 4), np.float32),
                                    shape=(4, 4), offsets=(0,), nnz=4))
    # tensors stay on their own device
    tcoo = COOMatrix(torch.from_numpy(coo.rows), torch.from_numpy(coo.cols),
                     torch.from_numpy(coo.vals), coo.shape)
    assert coo_to_dia(tcoo).device == torch.device("cpu")
    assert detect_dia(tcoo).tolist() == [0, 1]


# --------------------------------------------------------------------------
# parity with the JAX package on the same operands

_PARITY = {
    "stencil": (350, tuple(range(-4, 5)), None),
    "pairbands": (500, PAIRBANDS, None),
    "rect": (200, (0, 4, 50), 300),
}


@pytest.mark.parametrize("name", sorted(_PARITY))
def test_conversion_and_plan_maps_equal_jax(name):
    n, bands, n_cols = _PARITY[name]
    coo = _banded_coo(n, bands, seed=11, n_cols=n_cols)
    np.testing.assert_array_equal(diag_offsets(coo, device=CPU),
                                  j_dia.diag_offsets(_jax(coo)))
    t = coo_to_dia(coo, device=CPU)
    j = j_dia.coo_to_dia(_jax(coo), dtype=np.float32)
    assert t.offsets == j.offsets and t.shape == tuple(j.shape)
    assert t.nnz == j.nnz
    np.testing.assert_array_equal(t.bands.numpy(), np.asarray(j.bands))
    offs_b = t.offsets if n_cols is None else tuple(
        -d for d in reversed(t.offsets))
    assert _plan_maps(t.offsets, offs_b) == j_dia._plan_maps(j.offsets,
                                                             offs_b)
    # the JAX operand carried over through interop
    back = interop.dia_from_numpy(
        dict(bands=np.asarray(j.bands), shape=j.shape, offsets=j.offsets,
             nnz=j.nnz), device=CPU)
    assert back.offsets == t.offsets and back.shape == t.shape
    assert torch.equal(back.bands, t.bands) and back.nnz == t.nnz


@pytest.mark.parametrize("values_only", [False, True],
                         ids=["counts", "values_only"])
@pytest.mark.parametrize("mode", ["dense", "pairs"])
def test_multiply_equals_jax_xla_and_pallas_interpret(mode, values_only):
    n, bands, _ = _PARITY["stencil" if mode == "dense" else "pairbands"]
    coo = _banded_coo(n, bands, seed=12)
    t = coo_to_dia(coo, device=CPU)
    j = j_dia.coo_to_dia(_jax(coo), dtype=np.float32)
    dc_list, idx_map = _plan_maps(t.offsets, t.offsets)
    assert dk.dia_mode(t.offsets, t.offsets, dc_list) == mode
    c, cnt = _dia_multiply_torch(t.bands, t.bands, offs_a=t.offsets,
                                 idx_map=idx_map, dc_count=len(dc_list),
                                 n_out=n, values_only=values_only)
    cx, nx = j_dia._dia_multiply_xla(j.bands, j.bands, offs_a=j.offsets,
                                     idx_map=idx_map, dc_count=len(dc_list),
                                     n_out=n, values_only=values_only)
    cp, np_ = j_pd.dia_multiply_pallas(j.bands, j.bands, offs_a=j.offsets,
                                       offs_b=j.offsets, mode=mode,
                                       dc_list=dc_list, n_out=n,
                                       values_only=values_only,
                                       interpret=True)
    # the tolerance tests/test_dia.py uses between the JAX package's own
    # two paths: the three sum in different orders
    for ref in (cx, cp):
        np.testing.assert_allclose(c.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    if values_only:
        assert cnt is None and np_ is None
    else:
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(nx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(np_))


@pytest.mark.parametrize("name", sorted(_PARITY))
def test_spgemm_end_to_end_equals_jax(name):
    n, bands, n_cols = _PARITY[name]
    coo = _banded_coo(n, bands, seed=13, n_cols=n_cols)
    b_coo = coo if n_cols is None else coo.transpose()
    ta = coo_to_dia(coo, device=CPU)
    tb = ta if b_coo is coo else coo_to_dia(b_coo, device=CPU)
    ja = j_dia.coo_to_dia(_jax(coo), dtype=np.float32)
    jb = ja if b_coo is coo else j_dia.coo_to_dia(_jax(b_coo),
                                                  dtype=np.float32)
    tres = SpGEMM(SpGEMMConfig())(ta, tb)
    jres = JSpGEMM(JConfig())(ja, jb)
    assert tres.engine == jres.engine == "dia"
    assert tres.c_nnz == jres.c_nnz and tres.dia_dc == jres.dia_dc
    assert tres.n_pairs == jres.n_pairs and tres.shape == jres.shape
    np.testing.assert_array_equal(tres.c_counts.numpy(),
                                  np.asarray(jres.c_counts))
    tc, jc = tres.to_coo(), jres.to_coo()
    np.testing.assert_array_equal(tc.rows, jc.rows)
    np.testing.assert_array_equal(tc.cols, jc.cols)
    np.testing.assert_allclose(tc.vals, jc.vals, rtol=2e-5, atol=1e-5)
