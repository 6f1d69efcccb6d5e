"""The port's steady plans of the element engines: the merge engine's
ElementPlan (mirrors of tests/test_fixed.py's element cases), and the binned
multiply's single count accumulator against the per-call counts it
replaced.  The CUDA-graph replay of BinnedElementPlan needs the card; on the
CPU the plan runs eagerly, and chip_smoke.py's graph_replay phase holds the
replay to the eager multiply bit for bit."""

import numpy as np
import pytest
import torch

from conftest import random_sparse
from test_torch_util import one_torch_thread, xla_unoptimized
from pem_spgemm_tpu.models.synthetic import power_law
from pem_spgemm_tpu_torch import SpGEMM, SpGEMMConfig
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops import binned
from pem_spgemm_tpu_torch.ops import segment_sort as ss
from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled
from pem_spgemm_tpu_torch.ops.element import compact_stream
from pem_spgemm_tpu_torch.ops.fixed import (BinnedElementPlan, ElementPlan,
                                            make_plan)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

CPU = "cpu"


def test_planned_element_matches_scipy():
    # the merge element engine (the f64 parity implementation) in float32
    m = random_sparse(700, 700, 0.002, seed=9)
    coo = COOMatrix.from_scipy(m)
    a = coo_to_tiled(coo, device=CPU)
    b = coo_to_tiled(coo, device=CPU)
    cfg = SpGEMMConfig(numeric_chunk=1 << 10, engine="element",
                       element_impl="merge")
    res = SpGEMM(cfg)(a, b)
    plan = make_plan(res, cfg, a, b)
    assert isinstance(plan, ElementPlan) and not plan.wide
    rows, cols, vals, first, c_nnz, overflow = plan.run(a, b)
    assert int(c_nnz) == res.c_nnz and not bool(overflow)
    want = (m @ m).tocoo()
    want.sum_duplicates()
    n = int(c_nnz)
    assert want.nnz == n
    rows, cols, vals = compact_stream(rows, cols, vals, first)
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(rows[:n].numpy(), want.row[order])
    np.testing.assert_array_equal(cols[:n].numpy(), want.col[order])
    np.testing.assert_allclose(vals[:n].numpy(), want.data[order],
                               rtol=1e-5, atol=1e-6)
    # an overflow trip doubles every capacity
    grown = plan.grown()
    assert (grown.p_cap, grown.c_cap) == (2 * plan.p_cap, 2 * plan.c_cap)


def test_planned_element_wide_keeps_f64():
    # an f64 ElementPlan must not route values through the float32 merge
    # pipeline: the wide step keeps double accumulation
    m = random_sparse(500, 500, 0.003, seed=11, dtype=np.float64)
    m.data = m.data * 1e8 + 1.0             # float32 rounding would show
    coo = COOMatrix.from_scipy(m)
    a = coo_to_tiled(coo, dtype=torch.float64, device=CPU)
    b = coo_to_tiled(coo, dtype=torch.float64, device=CPU)
    cfg = SpGEMMConfig(numeric_chunk=1 << 10, engine="element",
                       element_impl="merge", dtype=torch.float64)
    res = SpGEMM(cfg)(a, b)
    plan = make_plan(res, cfg, a, b)
    assert plan.wide
    rows, cols, vals, first, c_nnz, overflow = plan.run(a, b)
    assert int(c_nnz) == res.c_nnz and not bool(overflow)
    assert vals.dtype == torch.float64
    want = (m @ m).tocoo()
    want.sum_duplicates()
    n = int(c_nnz)
    assert want.nnz == n
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(rows[:n].numpy(), want.row[order])
    np.testing.assert_array_equal(cols[:n].numpy(), want.col[order])
    np.testing.assert_allclose(vals[:n].numpy(), want.data[order],
                               rtol=1e-12)
    assert bool(first[:n].all()) and not bool(first[n:].any())


def test_dedup_count_adds_into_the_accumulator():
    g = np.random.default_rng(4)
    keys = np.sort(g.integers(0, 20, (6, 40)), axis=1).astype(np.int32)
    keys[:, -5:] = ss.SENTINEL
    vals = torch.from_numpy(g.standard_normal((6, 40)).astype(np.float32))
    k = torch.from_numpy(keys)
    v0, f0, c0 = ss.segment_dedup(k, vals)
    acc = torch.tensor(7, dtype=torch.int32)
    v1, f1, c1 = ss.segment_dedup(k, vals, count=acc)
    assert c1 is acc and int(acc) == 7 + int(c0) == 7 + int(f0.sum())
    assert torch.equal(f0, f1) and torch.equal(v0[f0], v1[f1])
    # the plain version directly, and with the fused product
    bits = vals.view(torch.int32)
    ones = torch.ones_like(vals).view(torch.int32)
    _v, _f, c2 = ss.segment_dedup_plain(k, bits, ones, count=acc)
    assert c2 is acc and int(acc) == 7 + 2 * int(c0)
    for bad in (torch.tensor(0, dtype=torch.int64),
                torch.zeros(1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int32"):
            ss.segment_dedup(k, vals, count=bad)


def _per_call_total(plan, vmem_sort):
    """The multiply's count as it was formed before the accumulator: each
    stream's own count, summed one at a time."""
    w, table = plan.w, plan.table
    total = 0
    if plan.win is not None:
        total += int(binned.singles_window_multiply(plan.wintab,
                                                    *plan.win)[4])
    if plan.coarse is not None:
        total += int(binned.coarse_flat_multiply(table, *plan.coarse, w)[4])
    for fs in plan.fine:
        if fs.mode == "flat":
            total += int(binned.fine_flat_multiply(
                fs.table, fs.refs, fs.avals, fs.rows, fs.w)[4])
        else:
            total += int(binned.fine_route_multiply(
                fs.table, fs.block_ids, fs.loc, fs.avals, fs.rows, fs.w)[4])
    for p in plan.packed:
        total += int(binned.packed_multiply(p.keys, p.bbits, p.abits,
                                            p.seg_rows, p.rounds)[3])
    singles = [bk for bk in plan.buckets if bk.single]
    if singles:
        total += int(binned.singles_multiply_flat(
            table, [bk.src for bk in singles], [bk.avals for bk in singles],
            [bk.seg_rows for bk in singles], [bk.m for bk in singles],
            w)[4])
    for bk in plan.buckets:
        if bk.single:
            continue
        fn = binned.bucket_multiply_vmem if (
            vmem_sort and bk.m * w <= binned.VMEM_SORT_MAX) \
            else binned.bucket_multiply
        total += int(fn(table, bk.src, bk.avals, bk.m, w, bk.rounds)[3])
    total += int(binned.residual_multiply(table, plan.res_src,
                                          plan.res_avals, plan.res_rows,
                                          w)[4])
    return total


@pytest.mark.parametrize("pack,vmem_sort", [(True, False), (False, False),
                                            (False, True)])
def test_one_accumulator_equals_the_per_call_counts(pack, vmem_sort):
    coo = power_law(n=3000, nnz=12000, seed=13, hub_correlation=0.2)
    t = COOMatrix(np.asarray(coo.rows), np.asarray(coo.cols),
                  np.asarray(coo.vals), tuple(coo.shape))
    a = coo_to_tiled(t, device=CPU)
    b = coo_to_tiled(t, with_tmasks=True, device=CPU)
    plan = binned.build_plan_device(a, b, pack=pack)
    stream = binned.binned_multiply(plan, vmem_sort=vmem_sort)
    assert stream.c_nnz.dtype == torch.int32 and stream.c_nnz.dim() == 0
    s = t.to_scipy().tocsr()
    want = (s @ s).nnz
    assert int(stream.c_nnz) == _per_call_total(plan, vmem_sort) == want
    assert len(stream.to_coo_arrays()[0]) == want


def test_binned_plan_runs_eagerly_on_the_cpu():
    coo = COOMatrix.from_scipy(random_sparse(300, 300, 0.01, seed=6))
    a = coo_to_tiled(coo, device=CPU)
    b = coo_to_tiled(coo, with_tmasks=True, device=CPU)
    cfg = SpGEMMConfig()
    res = SpGEMM(cfg)(a, b)
    plan = make_plan(res, cfg, a, b)
    assert isinstance(plan, BinnedElementPlan) and not plan.vmem_sort
    c_nnz, overflow = plan.run(a, b)
    assert int(c_nnz) == res.c_nnz and not bool(overflow)
    # no graph off the card: nothing captured, no launches recorded
    assert plan.stream is None and plan.launches == {}
    assert plan == BinnedElementPlan(plan=plan.plan, vmem_sort=False)
