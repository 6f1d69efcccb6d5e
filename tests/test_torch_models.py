"""Host-side pieces of the port that are copies of numpy-only modules of
the JAX package: generators, config helpers, flop accounting, the CSV
schema, the COO container and the phase timers."""

import dataclasses

import numpy as np
import pytest
import torch

from pem_spgemm_tpu import config as j_config
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models import synthetic as j_syn
from pem_spgemm_tpu.ops import binned as j_binned
from pem_spgemm_tpu.ops import dia as j_dia
from pem_spgemm_tpu.utils import csv_report as j_csv
from pem_spgemm_tpu.utils import flops as j_flops
from pem_spgemm_tpu_torch import config as t_config
from pem_spgemm_tpu_torch.formats.coo import COOMatrix as TCOO
from pem_spgemm_tpu_torch.models import synthetic as t_syn
from pem_spgemm_tpu_torch.ops import binned as t_binned
from pem_spgemm_tpu_torch.ops import dia as t_dia
from pem_spgemm_tpu_torch.utils import csv_report as t_csv
from pem_spgemm_tpu_torch.utils import flops as t_flops
from pem_spgemm_tpu_torch.utils.timing import PhaseTimers, force_sync


def _same_coo(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.vals, b.vals)


@pytest.mark.parametrize("spec", [
    "banded:n=500", "power_law:n=2000,nnz=6000,seed=4,hub_correlation=0.1",
    "rmat:scale=9,edge_factor=4,seed=7",
    "uniform_random:n_rows=300,n_cols=200,nnz=900,seed=3"])
def test_generators_give_the_same_triplets(spec):
    _same_coo(j_syn.by_name(spec), t_syn.by_name(spec))


@pytest.mark.parametrize("bands", [(0, 1, -1, 16, -16), (3,),
                                   tuple(range(-8, 8)),
                                   (0, 1, 60, 61, -60, -61)])
def test_banded_device_structure_equals_banded(bands):
    n = 257
    dev = t_syn.banded_device(n, bands=bands, seed=5, device="cpu")
    assert isinstance(dev.rows, torch.Tensor) and dev.shape == (n, n)
    assert dev.vals.dtype == torch.float32 and not bool((dev.vals == 0).any())
    host = t_syn.banded(n, bands=bands, seed=5)
    got = TCOO(dev.rows.numpy(), dev.cols.numpy(), dev.vals.numpy(),
               dev.shape)
    order = np.lexsort((got.cols, got.rows))
    np.testing.assert_array_equal(got.rows[order], host.rows)
    np.testing.assert_array_equal(got.cols[order], host.cols)
    # the JAX generator emits the same coordinates in the same (band-major)
    # order; the values come from another generator
    j = j_syn.banded_device(n, bands=bands, seed=5)
    np.testing.assert_array_equal(got.rows, np.asarray(j.rows))
    np.testing.assert_array_equal(got.cols, np.asarray(j.cols))
    # same seed, same values; another seed, other values
    again = t_syn.banded_device(n, bands=bands, seed=5, device="cpu")
    other = t_syn.banded_device(n, bands=bands, seed=6, device="cpu")
    assert torch.equal(again.vals, dev.vals)
    assert not torch.equal(other.vals, dev.vals)


def test_banded_device_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the GPU here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_syn.banded_device(64)


def test_by_name_rejects_unknown_family():
    with pytest.raises(ValueError, match="unknown synthetic family"):
        t_syn.by_name("kronecker:n=1024")
    # "wandering" was refused here until the Macro128 engine was ported: now
    # it is a family, generated on the device the caller names
    got = t_syn.by_name("wandering:n=1024", device="cpu")
    assert got.nnz == 1024 * 64 and tuple(got.shape) == (1024, 1024)


def test_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(j_config.SpGEMMConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(t_config.SpGEMMConfig)}
    assert list(jf) == list(tf)
    for name in jf:
        if name in ("dtype",):
            assert tf[name] is torch.float32
        else:
            assert jf[name] == tf[name], name
    cfg = t_config.SpGEMMConfig().with_(engine="element", repeat=3)
    assert cfg.engine == "element" and cfg.repeat == 3
    assert cfg.acc() is torch.float32


@pytest.mark.parametrize("n", [0, 1, 2, 3, 17, 1024, 1025, 10**6])
def test_rounding_helpers_match(n):
    assert t_config.round_up_pow2(n) == j_config.round_up_pow2(n)
    assert t_config.round_up_bucket(n) == j_config.round_up_bucket(n)
    assert t_config.round_up_bucket(n, 64) == j_config.round_up_bucket(n, 64)
    assert t_binned.quarter_pow2(n) == j_binned.quarter_pow2(n)


def test_binned_constants_match():
    for name in ("W", "MAX_CHUNKS", "VMEM_SORT_MAX", "FINE_CLASSES", "FSENT",
                 "ROUTE_K", "ROUTE_P", "ROUTE_MIN_FILL", "ROUTE_MIN_REFS",
                 "WIN", "WIN_MIN_M", "CLASSES", "PACK_CLASSES"):
        assert getattr(t_binned, name) == getattr(j_binned, name), name
    assert t_binned.SENTINEL == int(j_binned.SENTINEL)


def test_flops_host_and_tensor_paths_match():
    coo = j_syn.power_law(n=1500, nnz=5000, seed=2, hub_correlation=0.2)
    want = j_flops.spgemm_flops(coo.cols, coo.rows, coo.shape[0])
    assert t_flops.spgemm_flops(coo.cols, coo.rows, coo.shape[0]) == want
    assert t_flops.spgemm_flops(torch.from_numpy(coo.cols),
                                torch.from_numpy(coo.rows),
                                coo.shape[0]) == want
    assert t_flops.gflops(want, 0.5) == j_flops.gflops(want, 0.5)
    assert t_flops.gflops(want, 0.0) == 0.0
    assert t_flops.compression_ratio(want, 7) == \
        j_flops.compression_ratio(want, 7)


def test_csv_schema_is_the_reference_14_columns(tmp_path):
    assert t_csv.CSV_HEADER == j_csv.CSV_HEADER
    assert len(t_csv.CSV_HEADER.split(",")) == 14
    kw = dict(matrix="m", flop=10, c_nnz=5, compression_ratio=2.0,
              a_conversion_kernel_time=1.0, b_conversion_kernel_time=2.0,
              total_conversion_overhead_time=3.0, step1_time=0.1,
              step2_time=0.2, step3_time=0.3, pem_spgemm_time=0.7,
              pem_spgemm_kernel_time=0.6, pem_spgemm_malloc_time=0.1,
              gflops=1.5, steady_state_time=0.5, steady_gflops=2.0,
              pipelined_time=0.4, pipelined_gflops=2.5)
    jr, tr = j_csv.BenchmarkRecord(**kw), t_csv.BenchmarkRecord(**kw)
    assert tr.csv_row() == jr.csv_row()
    assert t_csv.report_stdout(tr) == j_csv.report_stdout(jr)
    assert t_csv.matrix_name("/x/y/web.mtx") == j_csv.matrix_name(
        "/x/y/web.mtx") == "web"
    path = tmp_path / "out.csv"
    t_csv.append_csv(str(path), tr)
    t_csv.append_csv(str(path), tr)
    lines = path.read_text().splitlines()
    assert lines[0] == j_csv.CSV_HEADER and len(lines) == 3


def test_coo_container_matches():
    rows = np.array([2, 0, 2, 0], np.int64)
    cols = np.array([1, 3, 1, 0], np.int64)
    vals = np.array([1.0, 2.0, 3.0, 4.0])
    j = JCOO(rows, cols, vals, (3, 4)).sum_duplicates()
    t = TCOO(rows, cols, vals, (3, 4)).sum_duplicates()
    _same_coo(j, t)
    assert t.nnz == 3 and t.rows.dtype == np.int32
    _same_coo(j.transpose(), t.transpose())
    _same_coo(JCOO.from_scipy(j.to_scipy()), TCOO.from_scipy(t.to_scipy()))
    with pytest.raises(ValueError, match="equal length"):
        TCOO(rows, cols[:2], vals, (3, 4))


@pytest.mark.parametrize("kind", ["banded", "random", "explicit_zero"])
def test_dia_census_matches(kind):
    if kind == "random":
        coo = j_syn.uniform_random(400, 400, 3000, seed=1)
    else:
        coo = j_syn.banded(300, bands=(0, 1, -1, 7, -40), seed=2)
        if kind == "explicit_zero":
            coo.vals[5] = 0.0
    tcoo = TCOO(coo.rows, coo.cols, coo.vals, coo.shape)
    np.testing.assert_array_equal(t_dia.diag_offsets(tcoo, device="cpu"),
                                  j_dia.diag_offsets(coo))
    want = j_dia.detect_dia(coo, max_bands=64)
    got = t_dia.detect_dia(tcoo, max_bands=64, device="cpu")
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
    assert (got is not None) == (kind == "banded")


def test_phase_timers_interface():
    t = PhaseTimers()
    for _ in range(3):
        with t.phase("step1") as box:
            box["sync"] = torch.zeros(4)
        with t.phase("step2"):
            pass
        with t.phase("step2"):
            pass
    assert t.counts["step1"] == 3 and t.counts["step2"] == 6
    assert len(t.per_iteration("step2", 3)) == 3
    assert t.mean("step1", 3) >= t.min("step1", 3) > 0.0
    assert t.pick("step1", True, 3) == t.min("step1", 3)
    assert t.pick("missing", False) == 0.0
    t.detail = False
    with t.phase("step1") as box:
        assert box == {}
    assert t.counts["step1"] == 3
    t.reset()
    assert not t.totals and not t.per_iter
    force_sync((None, [torch.zeros(2)]))      # CPU tensors: a no-op
    force_sync(None)
