"""The slice as a whole: SpGEMM(SpGEMMConfig()) of the port against the JAX
package's on the same numpy inputs, the engines of the later slices (each
raised until its slice landed; all run now), and the benchmark harness with
its 14-column CSV."""

import numpy as np
import pytest
import torch

from conftest import random_sparse
from test_torch_util import (both_tiled, one_torch_thread, scipy_product,
                             xla_unoptimized)
from pem_spgemm_tpu import SpGEMM as JSpGEMM, SpGEMMConfig as JConfig
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import banded, power_law
from pem_spgemm_tpu.utils.csv_report import CSV_HEADER as J_CSV_HEADER
from pem_spgemm_tpu_torch import SpGEMM, SpGEMMConfig, SpGEMMResult
from pem_spgemm_tpu_torch.bench.harness import run_benchmark
from pem_spgemm_tpu_torch.formats.coo import COOMatrix as TCOO
from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled
from pem_spgemm_tpu_torch.ops import segment_sort as ss
from pem_spgemm_tpu_torch.ops.fixed import (BinnedElementPlan, MacroPlan,
                                            SpGEMMPlan, make_plan)
from pem_spgemm_tpu_torch.utils.timing import PhaseTimers

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)


def _inputs(kind):
    if kind == "power_law":
        c = power_law(n=1500, nnz=6000, seed=13, hub_correlation=0.2)
        return c, None
    if kind == "uniform":
        return JCOO.from_scipy(random_sparse(700, 700, 0.004, seed=5)), None
    if kind == "rectangular":
        return (JCOO.from_scipy(random_sparse(260, 400, 0.012, seed=1)),
                JCOO.from_scipy(random_sparse(400, 180, 0.012, seed=2)))
    rows = np.array([0, 0, 1, 2], np.int32)
    cols = np.array([1, 2, 3, 3], np.int32)
    vals = np.array([1.0, 1.0, 1.0, -1.0], np.float32)
    return JCOO(rows, cols, vals, (4, 4)), None


@pytest.mark.parametrize("kind", ["power_law", "uniform", "rectangular",
                                  "cancellation"])
def test_default_config_matches_jax_and_scipy(kind):
    a_coo, b_coo = _inputs(kind)
    ja, ta = both_tiled(a_coo)
    jbm, tbm = (ja, ta) if b_coo is None else both_tiled(b_coo)
    jr = JSpGEMM(JConfig())(ja, jbm)
    timers = PhaseTimers()
    tr = SpGEMM(SpGEMMConfig())(ta, tbm, timers)
    assert isinstance(tr, SpGEMMResult) and tr.binned is not None
    assert (tr.engine, tr.c_nnz, tr.n_pairs, tuple(tr.shape)) == \
        (jr.engine, jr.c_nnz, jr.n_pairs, tuple(jr.shape))
    assert set(timers.counts) == {"step1", "step2", "step3"}
    got, jgot = tr.to_coo(), jr.to_coo()
    np.testing.assert_array_equal(got.rows, jgot.rows)
    np.testing.assert_array_equal(got.cols, jgot.cols)
    np.testing.assert_allclose(got.vals, jgot.vals, rtol=1e-5, atol=1e-6)
    if kind == "cancellation":
        # scipy may prune the cancelled zero: compare the pattern product
        m = a_coo.to_scipy().toarray() != 0
        assert tr.c_nnz == int(((m.astype(int) @ m.astype(int)) != 0).sum())
        hit = (got.rows == 0) & (got.cols == 3)
        assert hit.sum() == 1 and got.vals[hit][0] == 0.0
    else:
        wr, wc, wv, wnnz = scipy_product(a_coo, b_coo)
        assert tr.c_nnz == wnnz
        np.testing.assert_array_equal(got.rows, wr)
        np.testing.assert_array_equal(got.cols, wc)
        np.testing.assert_allclose(got.vals, wv, rtol=1e-5, atol=1e-6)


def test_empty_product_is_a_result_in_both():
    a = JCOO(np.array([0, 1], np.int32), np.array([10, 11], np.int32),
             np.array([2.0, 3.0], np.float32), (32, 32))
    b = JCOO(np.array([3], np.int32), np.array([5], np.int32),
             np.array([4.0], np.float32), (32, 32))
    ja, ta = both_tiled(a)
    jbm, tbm = both_tiled(b)
    jr = JSpGEMM(JConfig())(ja, jbm)
    tr = SpGEMM(SpGEMMConfig())(ta, tbm)
    assert (tr.c_nnz, tr.n_pairs, tr.engine) == (jr.c_nnz, jr.n_pairs,
                                                 jr.engine) == (0, 0,
                                                                "element")
    coo = tr.to_coo()
    assert coo.nnz == 0 and tuple(coo.shape) == (32, 32)


def test_shape_mismatch_raises():
    _, ta = both_tiled(JCOO.from_scipy(random_sparse(40, 60, 0.05, seed=1)))
    with pytest.raises(ValueError, match="shape mismatch"):
        SpGEMM(SpGEMMConfig())(ta, ta)


def test_pick_engine_matches_jax():
    dense = JCOO.from_scipy(random_sparse(256, 256, 0.9, seed=3))
    sparse = power_law(n=1500, nnz=6000, seed=13, hub_correlation=0.2)
    for coo in (dense, sparse):
        ja, ta = both_tiled(coo)
        for cfg_kw in (dict(), dict(macro_threshold=1.0),
                       dict(element_threshold=0.5), dict(engine="masks")):
            assert SpGEMM(SpGEMMConfig(**cfg_kw)).pick_engine(ta, ta) == \
                JSpGEMM(JConfig(**cfg_kw)).pick_engine(ja, ja), cfg_kw


@pytest.mark.parametrize("engine,slice_no", [
    ("macro", 3), ("fused", 4), ("masks", 4), ("dia", 2)])
def test_engines_of_later_slices_raise(engine, slice_no):
    """The name dates from when these engines raised; every slice has
    landed, and each engine runs as the JAX package's does."""
    _, ta = both_tiled(JCOO.from_scipy(random_sparse(64, 64, 0.1, seed=2)))
    if engine == "macro":
        # slice 3 has landed: the engine runs on Tile16 operands (through
        # their Macro128 form) and through the harness, and agrees with scipy
        coo = TCOO.from_scipy(random_sparse(64, 64, 0.1, seed=2))
        wr, wc, wv, wnnz = scipy_product(coo)
        res = SpGEMM(SpGEMMConfig(engine=engine))(ta, ta)
        rec, res_h = run_benchmark(coo, "m", SpGEMMConfig(engine=engine,
                                                          repeat=1),
                                   device="cpu", verbose=False)
        for r in (res, res_h):
            assert r.engine == "macro" and r.c_nnz == wnnz
            got = r.to_coo()
            np.testing.assert_array_equal(got.rows, wr)
            np.testing.assert_array_equal(got.cols, wc)
            np.testing.assert_allclose(got.vals, wv, rtol=1e-4, atol=1e-4)
        assert rec.c_nnz == wnnz
        return
    if engine == "dia":
        # slice 2 has landed: the engine refuses Tile16 operands by type, and
        # the harness converts the matrix (at most 127 diagonals) and runs it
        with pytest.raises(TypeError, match="DiaMatrix"):
            SpGEMM(SpGEMMConfig(engine=engine))(ta, ta)
        coo = TCOO.from_scipy(random_sparse(64, 64, 0.1, seed=2))
        rec, res = run_benchmark(coo, "m", SpGEMMConfig(engine=engine,
                                                        repeat=1),
                                 device="cpu", verbose=False)
        s = coo.to_scipy().tocsr()
        assert res.engine == "dia" and rec.c_nnz == (s @ s).nnz
        return
    # slice 4 has landed: the Tile16 engines run on Tile16 operands and
    # through the harness, with the JAX package's arrays and scipy's C
    coo = JCOO.from_scipy(random_sparse(64, 64, 0.1, seed=2))
    ja, _ = both_tiled(coo)
    jres = JSpGEMM(JConfig(engine=engine))(ja, ja)
    res = SpGEMM(SpGEMMConfig(engine=engine))(ta, ta)
    for f in ("c_tile_row", "c_tile_col", "cmask", "cptr", "rowcol",
              "elem_tile"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(jres, f)),
                                      err_msg=f)
    rec, res_h = run_benchmark(TCOO(coo.rows, coo.cols, coo.vals, coo.shape),
                               "m", SpGEMMConfig(engine=engine, repeat=1),
                               device="cpu", verbose=False)
    wr, wc, wv, wnnz = scipy_product(coo)
    for r in (res, res_h):
        assert r.engine == engine and r.c_nnz == wnnz == jres.c_nnz
        got = r.to_coo()
        np.testing.assert_array_equal(got.rows, wr)
        np.testing.assert_array_equal(got.cols, wc)
        np.testing.assert_allclose(got.vals, wv, rtol=1e-5, atol=1e-6)
    assert rec.c_nnz == wnnz and rec.steady_state_time > 0


@pytest.mark.parametrize("cfg_kw", [
    dict(engine="element", dtype=torch.float64),
    dict(engine="element", element_impl="merge")])
def test_merge_engine_configurations_raise(cfg_kw):
    """The name dates from when the merge element engine was not ported and
    these configurations raised; now they run it, as the JAX package does
    (float64 keeps its dtype), and an unknown implementation raises."""
    coo = JCOO.from_scipy(random_sparse(64, 64, 0.1, seed=2))
    cfg = SpGEMMConfig(**cfg_kw)
    ta = coo_to_tiled(TCOO(coo.rows, coo.cols, coo.vals, coo.shape),
                      dtype=cfg.dtype, device="cpu")
    res = SpGEMM(cfg)(ta, ta)
    assert res.engine == "element" and res.binned is None
    assert res.vals.dtype == cfg.dtype
    wr, wc, wv, wnnz = scipy_product(coo, None)
    got = res.to_coo()
    assert res.c_nnz == wnnz
    np.testing.assert_array_equal(got.rows, wr)
    np.testing.assert_array_equal(got.cols, wc)
    np.testing.assert_allclose(got.vals, wv, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="element_impl"):
        SpGEMM(cfg.with_(element_impl="sorted"))(ta, ta)


def test_auto_dispatch_to_macro_raises_not_detours():
    """The name dates from when the Macro128 engine was not ported and
    "auto" raised on dense tiles; now "auto" runs the macro engine there, as
    the JAX package does, and never quietly takes the element engine."""
    coo = JCOO.from_scipy(random_sparse(256, 256, 0.9, seed=3))
    ja, ta = both_tiled(coo)
    eng = SpGEMM(SpGEMMConfig(macro_threshold=100.0))
    assert eng.pick_engine(ta, ta) == "macro"
    res = eng(ta, ta)
    jres = JSpGEMM(JConfig(macro_threshold=100.0))(ja, ja)
    assert res.engine == jres.engine == "macro" and res.binned is None
    assert (res.c_nnz, res.n_pairs, res.c_ntiles) == \
        (jres.c_nnz, jres.n_pairs, jres.c_ntiles)
    wr, wc, wv, wnnz = scipy_product(coo)
    got = res.to_coo()
    assert res.c_nnz == wnnz
    np.testing.assert_array_equal(got.rows, wr)
    np.testing.assert_array_equal(got.cols, wc)
    np.testing.assert_allclose(got.vals, wv, rtol=1e-4, atol=1e-4)


def test_run_benchmark_writes_the_14_column_csv(tmp_path):
    coo = power_law(n=3000, nnz=9000, seed=3, hub_correlation=0.1)
    tcoo = TCOO(coo.rows, coo.cols, coo.vals, coo.shape)
    path = tmp_path / "bench.csv"
    ss.reset_launch_counts()
    rec, res = run_benchmark(tcoo, "some/dir/plaw3k.mtx",
                             SpGEMMConfig(engine="auto", repeat=2),
                             csv_path=str(path), verbose=False, device="cpu")
    wr, wc, wv, wnnz = scipy_product(coo)
    assert rec.matrix == "plaw3k" and rec.c_nnz == res.c_nnz == wnnz
    got = res.to_coo()
    np.testing.assert_array_equal(got.rows, wr)
    np.testing.assert_array_equal(got.cols, wc)
    np.testing.assert_allclose(got.vals, wv, rtol=1e-5, atol=1e-6)
    lines = path.read_text().splitlines()
    assert lines[0] == J_CSV_HEADER and len(lines) == 2
    assert len(lines[1].split(",")) == 14
    assert rec.flop == res.n_pairs
    assert rec.pem_spgemm_time > 0 and rec.steady_state_time > 0
    assert rec.pipelined_time > 0 and rec.step3_time > 0
    assert ss.LAUNCHES == {"segment_sort_dedup": 0, "segment_dedup": 0}


def test_run_benchmark_aat_mode():
    a = TCOO.from_scipy(random_sparse(300, 500, 0.01, seed=1))
    rec, res = run_benchmark(a, "rect", SpGEMMConfig(engine="element",
                                                     repeat=1),
                             aat=True, verbose=False, device="cpu")
    s = a.to_scipy().tocsr()
    want = (s @ s.T).tocoo()
    want.sum_duplicates()
    assert tuple(res.shape) == (300, 300) and res.c_nnz == want.nnz


def test_run_benchmark_auto_refuses_a_dia_matrix():
    """The name dates from when the DIA engine was not ported and "auto"
    refused such a matrix; now "auto" sends it to the DIA engine, and both
    engines agree on it."""
    coo = banded(400, bands=(0, 1, -1, 5), seed=1)
    tcoo = TCOO(coo.rows, coo.cols, coo.vals, coo.shape)
    rec, res = run_benchmark(tcoo, "banded",
                             SpGEMMConfig(engine="auto", repeat=1),
                             verbose=False, device="cpu")
    assert res.engine == "dia" and rec.c_nnz == scipy_product(coo)[3]
    # forced onto the element engine it runs too
    rec_e, res_e = run_benchmark(tcoo, "banded",
                                 SpGEMMConfig(engine="element", repeat=1),
                                 verbose=False, device="cpu")
    assert res_e.engine == "element" and rec_e.c_nnz == rec.c_nnz
    got, want = res.to_coo(), res_e.to_coo()
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_allclose(got.vals, want.vals, rtol=2e-5, atol=1e-5)


def test_make_plan_element_branch():
    coo = power_law(n=1500, nnz=6000, seed=13, hub_correlation=0.2)
    _, ta = both_tiled(coo)
    cfg = SpGEMMConfig()
    res = SpGEMM(cfg)(ta, ta)
    plan = make_plan(res, cfg, ta, ta)
    assert isinstance(plan, BinnedElementPlan)
    assert plan.vmem_sort is False          # CPU operands: no kernel route
    assert plan.grown() is plan
    out = plan.run(ta, ta)
    assert int(plan.fence(out)) == res.c_nnz and not bool(out[-1])
    # the macro branch: a MacroPlan on CPU operands, equal to the
    # interactive macro result; the Tile16 branch (it raised until slice 4
    # landed): an SpGEMMPlan at the JAX package's granularities
    mcfg = SpGEMMConfig(engine="macro")
    mres = SpGEMM(mcfg)(ta, ta)
    mplan = make_plan(mres, mcfg, ta, ta)
    assert isinstance(mplan, MacroPlan)
    mout = mplan.run(ta, ta)
    assert int(mout[5]) == mres.c_nnz == res.c_nnz and not bool(mout[-1])
    fcfg = SpGEMMConfig(engine="fused")
    fres = SpGEMM(fcfg)(ta, ta)
    fplan = make_plan(fres, fcfg, ta, ta)
    assert isinstance(fplan, SpGEMMPlan)
    assert fplan.p_cap == -(-fres.n_pairs // fcfg.numeric_chunk) \
        * fcfg.numeric_chunk and fplan.c_cap % 1024 == 0
    fout = fplan.run(ta, ta)
    assert int(fout[7]) == fres.c_nnz == res.c_nnz and not bool(fout[-1])
