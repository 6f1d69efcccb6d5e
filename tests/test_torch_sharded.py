"""The port's multi-GPU layer, element and DIA decompositions, on gloo ranks
(mirrors tests/test_sharded_element.py and
tests/test_dia.py::test_sharded_dia_matches_single_device), and the
Macro128 ring passing each B chunk with its tile masks.

A module-scoped fixture spawns the ranks once per world size (2 and 4,
``parallel.launch.spawn``) and runs every case of this file there
(``parallel.dryrun.rank_cases``); each rank returns its plan arrays and the
assembled C.  The JAX package's sharded functions run on the virtual CPU
mesh at the same world size.  C_nnz and the sorted COO are exact; values
are held within the float32 dot-product bound, |err| <= 1e-5 * sum|a*b| +
1e-6 against scipy's float64 product.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_sparse
from test_torch_util import (bf16_rounded, one_torch_thread,
                             structural_product, xla_unoptimized)
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import banded as j_banded
from pem_spgemm_tpu.models.synthetic import power_law as j_power_law
from pem_spgemm_tpu.ops.convert import coo_to_tiled as j_coo_to_tiled
from pem_spgemm_tpu.ops.dia import coo_to_dia as j_coo_to_dia
from pem_spgemm_tpu.parallel.sharded import make_mesh as j_make_mesh
from pem_spgemm_tpu.parallel.sharded_dia import sharded_dia_multiply as \
    j_sharded_dia_multiply
from pem_spgemm_tpu.parallel.sharded_element import (
    assemble_sharded_element as j_assemble_element,
    plan_sharded_element as j_plan_element,
    sharded_element_multiply as j_element_multiply)
from pem_spgemm_tpu_torch import interop
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled
from pem_spgemm_tpu_torch.ops.dia import coo_to_dia
from pem_spgemm_tpu_torch.ops.spgemm import SpGEMM
from pem_spgemm_tpu_torch.config import SpGEMMConfig
from pem_spgemm_tpu_torch.parallel import distributed as D
from pem_spgemm_tpu_torch.parallel import launch, dryrun, sharded_dia
from pem_spgemm_tpu_torch.parallel import sharded_element as se

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6


def _triplets(m):
    m = m.tocoo()
    return (m.row.astype(np.int32), m.col.astype(np.int32),
            m.data.astype(np.float64), m.shape)


def _jcoo_scipy(jcoo):
    return JCOO(np.asarray(jcoo.rows), np.asarray(jcoo.cols),
                np.asarray(jcoo.vals), tuple(jcoo.shape)).to_scipy()


POWER = _jcoo_scipy(j_power_law(n=3000, nnz=9000, seed=13,
                                hub_correlation=0.15))
AAT = random_sparse(400, 700, 0.004, seed=6)
DIA = _jcoo_scipy(j_banded(1000, bands=(-7, -1, 0, 2, 11), seed=13))
RING = _jcoo_scipy(j_banded(1500, bands=(0, 2, -2, 64, -64, 140, -140),
                            seed=3))
CASES = {
    "element_power_law": dict(kind="element", coo=_triplets(POWER)),
    "element_aat": dict(kind="element", coo=_triplets(AAT),
                        b_coo=_triplets(AAT.T)),
    "dia": dict(kind="dia", coo=_triplets(DIA)),
    "ring_masks": dict(kind="ring_masks", coo=_triplets(RING)),
    "element_aat_bf16": dict(kind="element", coo=_triplets(AAT),
                             b_coo=_triplets(AAT.T), dtype=torch.bfloat16),
}
NAMES = list(CASES)


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def ranks(request):
    """(world size, {case: [rank 0's result, ...]}) from one spawn."""
    n = request.param
    per_rank = launch.spawn(dryrun.rank_cases, n,
                            [CASES[k] for k in NAMES], "cpu")
    return n, {k: [r[i] for r in per_rank] for i, k in enumerate(NAMES)}


def _want(a, b):
    """scipy's A@B sorted, with sum|a*b| of each entry (|A|@|B| has the
    same structure: absolute values never cancel)."""
    a, b = a.tocsr().astype(np.float64), b.tocsr().astype(np.float64)
    want = (a @ b).tocoo()
    mag = (abs(a) @ abs(b)).tocoo()
    want.sum_duplicates()
    mag.sum_duplicates()
    o, mo = np.lexsort((want.col, want.row)), np.lexsort((mag.col, mag.row))
    assert np.array_equal(want.row[o], mag.row[mo])
    assert np.array_equal(want.col[o], mag.col[mo])
    return want.row[o], want.col[o], want.data[o], mag.data[mo]


def _hold(out, want, what):
    r, c, v, mag = want
    assert out["c_nnz"] == len(r), what
    np.testing.assert_array_equal(out["rows"], r, err_msg=what)
    np.testing.assert_array_equal(out["cols"], c, err_msg=what)
    assert np.all(np.abs(out["vals"] - v) <= RTOL * mag + ATOL), what


def _same_on_every_rank(outs):
    for o in outs[1:]:
        for k in ("c_nnz", "rows", "cols", "vals"):
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_element_aat(n):
    coo = JCOO.from_scipy(AAT)
    a = j_coo_to_tiled(coo, dtype=jnp.float32)
    b = j_coo_to_tiled(coo.transpose(), dtype=jnp.float32)
    plan = j_plan_element(a, b, n)
    per_class, res, c_nnz = j_element_multiply(plan, j_make_mesh(n))
    return plan, c_nnz, j_assemble_element(plan, per_class, res)


def _jax_col_bounds(cols, n_cols, n):
    """The JAX planner's column bounds (plan_sharded_element's first lines,
    on the host), for the cases the JAX plan is not built for: its host
    planner takes about 30 s at this matrix, so the JAX sharded run is held
    on the smaller A@A.T case below."""
    hist = np.bincount(cols, minlength=n_cols)
    cum = np.concatenate([[0], np.cumsum(hist)])
    cuts = np.searchsorted(cum, np.arange(1, n) * (len(cols) / n))
    return np.concatenate([[0], cuts, [n_cols]]).astype(np.int64)


def test_sharded_element_power_law(ranks):
    n, res = ranks
    outs = res["element_power_law"]
    _same_on_every_rank(outs)
    _hold(outs[0], _want(POWER, POWER), "element power law")
    bounds = outs[0]["col_bounds"]
    for o in outs:
        np.testing.assert_array_equal(o["col_bounds"], bounds)
    # a shard per rank: the products split exactly
    a = coo_to_tiled(COOMatrix.from_scipy(POWER), device=CPU)
    whole = SpGEMM(SpGEMMConfig(engine="element"))(a, a)
    assert sum(o["n_products"] for o in outs) == whole.n_pairs
    csr = POWER.tocsr()
    csr.sort_indices()
    np.testing.assert_array_equal(
        bounds, _jax_col_bounds(csr.indices, POWER.shape[1], n))


def test_sharded_element_aat(ranks):
    n, res = ranks
    outs = res["element_aat"]
    _same_on_every_rank(outs)
    _hold(outs[0], _want(AAT, AAT.T), "element A@A.T")
    if n == 2:
        # against the JAX package's sharded run at this world size
        plan, c_nnz, (jr, jc, jv) = _jax_element_aat(n)
        fields = {f.name: getattr(plan, f.name)
                  for f in dataclasses.fields(plan)}
        for d, o in enumerate(outs):
            lo, hi, w = interop.sharded_element_range_from_numpy(fields, d)
            assert (lo, hi, w) == (o["col_bounds"][d],
                                   o["col_bounds"][d + 1], o["w"])
        np.testing.assert_array_equal(outs[0]["col_bounds"], plan.col_bounds)
        assert outs[0]["c_nnz"] == c_nnz
        np.testing.assert_array_equal(outs[0]["rows"], jr)
        np.testing.assert_array_equal(outs[0]["cols"], jc)


@functools.lru_cache(maxsize=None)
def _jax_dia(n):
    a = j_coo_to_dia(JCOO.from_scipy(DIA), dtype=jnp.float32)
    c, cnt, dc_list = j_sharded_dia_multiply(a, a, j_make_mesh(n))
    return np.asarray(c), np.asarray(cnt), dc_list


def test_sharded_dia_matches_single_device(ranks):
    n, res = ranks
    outs = res["dia"]
    _same_on_every_rank(outs)
    _hold(outs[0], _want(DIA, DIA), "dia")
    c, cnt, dc_list = _jax_dia(n)
    o = outs[0]
    assert tuple(o["dc_list"]) == tuple(dc_list)
    np.testing.assert_array_equal(o["cnt"] > 0, cnt > 0)
    # as tests/test_dia.py holds the JAX sharded path to its single device
    np.testing.assert_allclose(o["c"], c, rtol=1e-6, atol=1e-6)
    # the single-device engine's C band stack, on the same bands
    a = coo_to_dia(COOMatrix.from_scipy(DIA), device=CPU)
    single = SpGEMM()(a, a)
    np.testing.assert_allclose(o["c"], single.vals.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_single_process_is_world_size_one():
    """Without a process group: initialize() is a no-op that returns 1, the
    mesh is one rank, and each path runs locally (no collective)."""
    assert D.initialize(device=CPU) == 1
    mesh = D.pod_mesh(device=CPU)
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert (mesh.left, mesh.right) == (0, 0)
    a = coo_to_tiled(COOMatrix.from_scipy(POWER), device=CPU)
    plan = se.plan_sharded_element(a, a, 1, 0)
    stream, c_nnz = se.sharded_element_multiply(plan, mesh)
    _hold(dict(zip(("rows", "cols", "vals"),
                   se.assemble_sharded_element(plan, stream, mesh)),
               c_nnz=c_nnz), _want(POWER, POWER), "element, one rank")
    d = coo_to_dia(COOMatrix.from_scipy(DIA), device=CPU)
    c, cnt, dc_list = sharded_dia.sharded_dia_multiply(d, d, mesh)
    single = SpGEMM()(d, d)
    assert torch.equal(cnt, single.c_counts) and dc_list == single.dia_dc
    with pytest.raises(ValueError):
        D.pod_mesh(2, device=CPU)


def test_sharded_dia_refuses_a_halo_wider_than_a_block():
    """The JAX package asserts hl <= l and hr <= l; here a ValueError."""
    d = coo_to_dia(COOMatrix.from_scipy(DIA), device=CPU)
    with pytest.raises(ValueError, match="halos"):
        sharded_dia.dia_blocks(d, d, 200)        # l = 5 < hr = 11


def test_sharded_element_refuses_other_dtypes():
    """What the element decomposition still refuses: float64 (the JAX
    decomposition computes float64 input in float32, which the port's
    float64 parity mode does not do), integer values, and operands of two
    dtypes."""
    coo = COOMatrix.from_scipy(AAT)
    a = coo_to_tiled(coo, device=CPU)
    a64 = coo_to_tiled(coo, dtype=torch.float64, device=CPU)
    a16 = coo_to_tiled(coo, dtype=torch.bfloat16, device=CPU)
    ai = dataclasses.replace(a, vals=a.vals.to(torch.int32))
    for x, y in ((a64, a64), (ai, ai), (a, a16), (a16, a64)):
        with pytest.raises(NotImplementedError,
                           match=f"{x.vals.dtype} / {y.vals.dtype}"):
            se.plan_sharded_element(x, y, 2, 0)


@functools.lru_cache(maxsize=None)
def _jax_element_aat_bf16(n):
    """The JAX decomposition on the bfloat16 operands (it widens the values
    to float32): its plan, C_nnz, assembled COO, and each device's own
    entries, sorted."""
    coo = JCOO.from_scipy(AAT)
    a = j_coo_to_tiled(coo, dtype=jnp.bfloat16)
    b = j_coo_to_tiled(coo.transpose(), dtype=jnp.bfloat16)
    plan = j_plan_element(a, b, n)
    per_class, res, c_nnz = j_element_multiply(plan, j_make_mesh(n))
    devices = []
    for d in range(n):
        rs, cs, vs = [], [], []
        for i, (k3, v3, f3) in enumerate(per_class):
            fm = np.asarray(f3)[d]
            rows = np.asarray(plan.bucket_rows[i])[d]
            rs.append(np.broadcast_to(rows[:, None], fm.shape)[fm])
            cs.append(np.asarray(k3)[d][fm])
            vs.append(np.asarray(v3)[d][fm])
        rr, rc, rv, rf = (np.asarray(x)[d] for x in res)
        rs.append(rr[rf])
        cs.append(rc[rf])
        vs.append(rv[rf])
        r, c, v = (np.concatenate(x) for x in (rs, cs, vs))
        o = np.lexsort((c, r))
        devices.append((r[o], c[o], v[o]))
    return plan, c_nnz, j_assemble_element(plan, per_class, res), devices


def test_sharded_element_bf16(ranks):
    """The element decomposition on bfloat16 operands over gloo: the values
    widened to float32 as the JAX decomposition widens them, C float32,
    scipy's product of the bfloat16-rounded operands (structure |A|@|B|,
    values within the float32 bound); each rank's own entries lie in its
    column range and together make the assembled C; at world size 2, each
    rank's entries against the JAX device's and the assembled COO against
    the JAX decomposition on the same bfloat16 operands."""
    n, res = ranks
    outs = res["element_aat_bf16"]
    _same_on_every_rank(outs)
    assert outs[0]["vals"].dtype == np.float32
    want = structural_product(bf16_rounded(AAT), bf16_rounded(AAT.T))
    _hold(outs[0], want, "element A@A.T, bf16")
    bounds = outs[0]["col_bounds"]
    mag = dict(zip(zip(want[0].tolist(), want[1].tolist()), want[3]))
    for d, o in enumerate(outs):
        r, c, v = o["local"]
        assert np.all((c >= bounds[d]) & (c < bounds[d + 1])), d
    assert sum(len(o["local"][0]) for o in outs) == outs[0]["c_nnz"]
    if n == 2:
        plan, c_nnz, (jr, jc, jv), devices = _jax_element_aat_bf16(n)
        np.testing.assert_array_equal(bounds, plan.col_bounds)
        assert outs[0]["w"] == plan.w and outs[0]["c_nnz"] == c_nnz
        np.testing.assert_array_equal(outs[0]["rows"], jr)
        np.testing.assert_array_equal(outs[0]["cols"], jc)
        for d, (o, (wr, wc, wv)) in enumerate(zip(outs, devices)):
            r, c, v = o["local"]
            np.testing.assert_array_equal(r, wr, err_msg=f"rows[{d}]")
            np.testing.assert_array_equal(c, wc, err_msg=f"cols[{d}]")
            m = np.array([mag[k] for k in zip(r.tolist(), c.tolist())])
            assert np.all(np.abs(v - wv) <= RTOL * m + ATOL), d


def test_ring_passes_each_chunk_with_its_masks(ranks):
    """The macro ring with its tile masks carried (``ring_chunks(...,
    masks)``, the path a plan takes where K4 reads masks) over gloo: at
    every stage of every rank the chunk held is its owner's B chunk, and
    the masks beside it, received in the same exchange, are ready, belong
    to the buffer it was received into and equal the masks made from it
    (``tile_masks_plain``)."""
    n, res = ranks
    for d, out in enumerate(res["ring_masks"]):
        assert len(out["held"]) == n
        for s, h in enumerate(out["held"]):
            assert h["ready"] and h["of_buffer"], (d, s)
            assert h["chunk"] and h["masks"], (d, s)
        assert all(h["set_words"] > 0 for h in out["held"])


def test_replayed_ranks_union_is_the_product():
    """Each rank's plan and local multiply replayed in one process (what
    chip_smoke.py does on one card): the union of the ranks' C equals
    scipy's, for both decompositions."""
    a = coo_to_tiled(COOMatrix.from_scipy(POWER), device=CPU)
    plans = [se.plan_sharded_element(a, a, 4, d) for d in range(4)]
    parts = [se.local_coo(se.local_element_multiply(p), CPU) for p in plans]
    rows, cols, vals = (torch.cat(x) for x in zip(*parts))
    order = torch.sort((rows.long() << 32) | cols.long()).indices
    _hold(dict(rows=rows[order].numpy(), cols=cols[order].numpy(),
               vals=vals[order].numpy(), c_nnz=len(rows)),
          _want(POWER, POWER), "element replay")
    d = coo_to_dia(COOMatrix.from_scipy(DIA), device=CPU)
    geo = sharded_dia.dia_blocks(d, d, 4)
    blocks = [sharded_dia.local_dia(*sharded_dia.replay_blocks(d, d, geo, r),
                                    d, d, geo) for r in range(4)]
    c = torch.cat([b[0] for b in blocks], 1)[:, :DIA.shape[0]]
    single = SpGEMM()(d, d)
    np.testing.assert_allclose(c.numpy(), single.vals.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_no_gpu_means_no_fallback():
    """The device picks the backend: without a GPU, a rank group or a
    process group on the default device raises instead of turning to gloo
    or the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.pod_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.initialize(init_method="tcp://localhost:29501", world_size=1,
                     rank=0)
    assert D.backend_for(torch.device("cuda", 0)) == "nccl"
    assert D.backend_for(torch.device("cpu")) == "gloo"
