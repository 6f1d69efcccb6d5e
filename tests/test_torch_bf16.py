"""bfloat16 on the element, DIA and Macro128 engines of the PyTorch port,
against the JAX package's bfloat16 runs on the same seeded inputs.

The port runs bfloat16 operands with float32 accumulation on every engine,
and rounds C to bfloat16 on the element and DIA engines.  The JAX package
takes the element engine's bfloat16 through its merge pipeline in float32
and rounds C (as the port does), accumulates DIA bands in their own dtype
(bfloat16 sums), and accumulates Macro128 tiles in ``acc_dtype`` (float32
here) without rounding C; the port's Macro128 engine does the same, in its
interactive and its steady tier alike.  In every case C_nnz and the sorted coordinates are exact, and C's
structure is taken from |A|@|A| of the bfloat16-rounded operands: scipy's
A@A drops sums that cancel to 0.0, the engines keep them.

Tolerances, each against scipy's float64 product of the bfloat16-rounded
operands (``mag`` = sum|a*b| of the entry):
  * the port: the float32 bound 1e-5 * mag + 1e-6, plus half a bfloat16 ulp
    of the rounded result (2^-8 |got|) where C is rounded (element, DIA);
    the float32 bound alone on the Macro128 engine;
  * the JAX DIA engine: it adds the len(offs_a) products of an entry's
    band pairs in bfloat16 (per A band one rounded product added into a
    rounded sum), so each of its at most len(offs_a) + 1 roundings moves
    the value by 2^-8 of a partial sum, at most mag: the bound is
    (len(offs_a) + 1) * 2^-8 * mag.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_util import one_torch_thread, xla_unoptimized
from pem_spgemm_tpu.config import SpGEMMConfig as JConfig
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import banded as j_banded
from pem_spgemm_tpu.models.synthetic import power_law as j_power_law
from pem_spgemm_tpu.ops.convert import coo_to_macro as j_coo_to_macro
from pem_spgemm_tpu.ops.convert import coo_to_tiled as j_coo_to_tiled
from pem_spgemm_tpu.ops.dia import coo_to_dia as j_coo_to_dia
from pem_spgemm_tpu.ops.spgemm import SpGEMM as JSpGEMM
from pem_spgemm_tpu_torch import interop
from pem_spgemm_tpu_torch.bench.harness import run_benchmark
from pem_spgemm_tpu_torch.config import SpGEMMConfig
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops import element
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, coo_to_tiled
from pem_spgemm_tpu_torch.ops.dia import coo_to_dia, make_dia_plan
from pem_spgemm_tpu_torch.ops.fixed import MacroPlan, make_plan
from pem_spgemm_tpu_torch.ops.spgemm import SpGEMM

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

CPU = "cpu"
BF = torch.bfloat16
F32_RTOL, F32_ATOL = 1e-5, 1e-6
HALF_ULP = 2.0 ** -8          # half a bfloat16 ulp, relative to the value
DENSE_BANDS = (-3, -2, -1, 0, 1, 2, 3)            # the dense entry's shape
PAIR_BANDS = (0, 1, 40, 41, -40, -41, 90, -90)    # the pairs entry's shape


def _port(jcoo):
    return COOMatrix(np.asarray(jcoo.rows), np.asarray(jcoo.cols),
                     np.asarray(jcoo.vals), tuple(jcoo.shape))


def _bf16_ref(coo):
    """(rows, cols, want, mag), sorted: C's structure from |A|@|A| of the
    bfloat16-rounded operand, A@A's float64 values read there (0.0 where
    scipy dropped a cancelled sum) and sum|a*b| of each entry."""
    v = torch.from_numpy(np.asarray(coo.vals, np.float32)).to(BF).to(
        torch.float64).numpy()
    s = COOMatrix(coo.rows, coo.cols, v, coo.shape).to_scipy().tocsr()
    sa = abs(s)
    mag = (sa @ sa).tocoo()
    mag.sum_duplicates()
    o = np.lexsort((mag.col, mag.row))
    r, c = mag.row[o], mag.col[o]
    want = np.asarray((s @ s).tocsr()[r, c]).ravel()
    return r, c, want, mag.data[o]


def _hold(rows, cols, vals, ref, bound, what):
    r, c, want, mag = ref
    np.testing.assert_array_equal(rows, r, err_msg=what)
    np.testing.assert_array_equal(cols, c, err_msg=what)
    vals = np.asarray(vals, np.float64)
    assert np.all(np.isfinite(vals)), what
    over = np.abs(vals - want) / bound(vals, mag)
    assert over.max() <= 1.0, (what, float(over.max()))


def _port_bound(vals, mag):
    return F32_RTOL * mag + F32_ATOL + HALF_ULP * np.abs(vals)


def _jax_coo(res):
    c = res.to_coo()
    return (np.asarray(c.rows), np.asarray(c.cols),
            np.asarray(jnp.asarray(c.vals, jnp.float32)))


def _run_port(op, c_dtype=BF, **cfg):
    r = SpGEMM(SpGEMMConfig(dtype=BF, **cfg))(op, op)
    assert r.vals.dtype == c_dtype
    return r, r.to_coo()


def _f32_bound(vals, mag):
    return F32_RTOL * mag + F32_ATOL


# --------------------------------------------------------------------------
# element


@pytest.fixture(scope="module")
def element_case():
    jcoo = j_power_law(n=600, nnz=2400, seed=11, hub_correlation=0.2)
    coo = _port(jcoo)
    jr = JSpGEMM(JConfig(engine="element", dtype=jnp.bfloat16,
                         numeric_chunk=1 << 10))(
        *(2 * (j_coo_to_tiled(jcoo, dtype=jnp.bfloat16),)))
    return coo, _bf16_ref(coo), jr


def test_element_bf16_matches_jax_and_scipy(element_case):
    coo, ref, jr = element_case
    t = coo_to_tiled(coo, dtype=BF, device=CPU)
    r, c = _run_port(t, engine="element", numeric_chunk=1 << 10)
    assert r.engine == "element" and r.binned is None    # the merge engine
    assert r.c_nnz == len(ref[0]) == jr.c_nnz
    _hold(c.rows, c.cols, c.vals, ref, _port_bound, "port element")
    jrows, jcols, jvals = _jax_coo(jr)
    _hold(jrows, jcols, jvals, ref, _port_bound, "JAX element")
    # both round float32 sums of the same float32 products to bfloat16:
    # within one bfloat16 ulp of each other and of the float32 bound
    assert np.all(np.abs(c.vals - jvals) <= 2 * (
        F32_RTOL * ref[3] + F32_ATOL) + 2 * HALF_ULP * np.abs(jvals))


def test_element_bf16_moves_float32_product_bits():
    """The merge pipeline moves values as int32 bit patterns: a bfloat16
    operand crosses as the bits of its float32 value, and the products and
    sums it carries are float32, not bfloat16 words."""
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.standard_normal(64).astype(np.float32)).to(BF)
    bits = element._f2i(x)
    assert bits.dtype == torch.int32
    assert torch.equal(bits, x.to(torch.float32).view(torch.int32))
    # a float32 product of two bfloat16 values needs more than bfloat16's
    # 8 mantissa bits: the low 16 bits of some moved words are set
    prod = element._i2f(bits) * element._i2f(bits.flip(0))
    assert bool(((prod.view(torch.int32) & 0xFFFF) != 0).any())
    t = coo_to_tiled(_port(j_power_law(n=200, nnz=700, seed=2)), dtype=BF,
                     device=CPU)
    b_rowptr, _r, b_cols, b_vals = t.element_csr()
    a_rows, a_cols = t.element_coords()
    offsets = element.product_offsets(a_cols, b_rowptr[1:] - b_rowptr[:-1])
    n = int(offsets[-1])
    _rows, _cols, vals, _first, _cnt = element.expand_reduce_products(
        offsets, a_rows, a_cols, t.vals, b_rowptr, b_cols, b_vals, n,
        -(-n // 256) * 256)
    assert vals.dtype == torch.float32


# --------------------------------------------------------------------------
# DIA


@pytest.fixture(scope="module", params=[("dense", DENSE_BANDS),
                                        ("pairs", PAIR_BANDS)],
                ids=["k2_dense", "k3_pairs"])
def dia_case(request):
    mode, bands = request.param
    jcoo = j_banded(n=700, bands=bands, seed=5)
    coo = _port(jcoo)
    ja = j_coo_to_dia(jcoo, dtype=jnp.bfloat16)
    jr = JSpGEMM(JConfig(dtype=jnp.bfloat16))(ja, ja)
    return mode, coo, _bf16_ref(coo), jr


def test_dia_bf16_matches_jax_and_scipy(dia_case):
    mode, coo, ref, jr = dia_case
    a = coo_to_dia(coo, dtype=BF, device=CPU)
    assert make_dia_plan(a, a).kernel_mode == mode
    r, c = _run_port(a)
    assert r.engine == "dia" and r.c_nnz == len(ref[0]) == jr.c_nnz
    _hold(c.rows, c.cols, c.vals, ref, _port_bound, f"port dia {mode}")
    n_a = len(a.offsets)
    jrows, jcols, jvals = _jax_coo(jr)
    _hold(jrows, jcols, jvals, ref,
          lambda v, mag: (n_a + 1) * HALF_ULP * mag + F32_ATOL,
          f"JAX dia {mode} (bfloat16 sums)")


def test_dia_bf16_bands_widen_once(dia_case):
    """The float32 copy of bfloat16 bands is made once an operand and
    reused by every multiply; a change made in place is copied into it in
    place (same address: a captured graph stays valid)."""
    _mode, coo, _ref, _jr = dia_case
    a = coo_to_dia(coo, dtype=BF, device=CPU)
    wide = a.acc_bands()
    assert wide.dtype == torch.float32 and a.acc_bands() is wide
    plan = make_dia_plan(a, a)
    c1 = plan.run(a, a)[0]
    assert a.acc_bands() is wide and c1.dtype == torch.float32
    ptr = wide.data_ptr()
    a.bands.mul_(2)
    assert a.acc_bands() is wide and wide.data_ptr() == ptr
    assert torch.equal(wide, a.bands.to(torch.float32))
    c2 = plan.run(a, a)[0]
    assert torch.equal(c2, 4 * c1)       # powers of two scale exactly


def test_dia_bf16_through_the_harness_auto():
    coo = _port(j_banded(n=400, bands=PAIR_BANDS, seed=8))
    rec, res = run_benchmark(coo, "pairbands", SpGEMMConfig(
        dtype=BF, repeat=1, warmup=0), verbose=False, device=CPU)
    ref = _bf16_ref(coo)
    assert res.engine == "dia" and rec.c_nnz == len(ref[0])
    assert res.vals.dtype == BF
    c = res.to_coo()
    _hold(c.rows, c.cols, c.vals, ref, _port_bound, "harness dia steady")


# --------------------------------------------------------------------------
# Macro128


@pytest.fixture(scope="module")
def macro_case():
    jcoo = j_banded(n=500, bands=(0, 1, -1, 60, -60, 140, -140), seed=6)
    coo = _port(jcoo)
    jm = j_coo_to_macro(jcoo, dtype=jnp.bfloat16)
    jr = JSpGEMM(JConfig(engine="macro", dtype=jnp.bfloat16,
                         acc_dtype=jnp.float32))(jm, jm)
    return coo, _bf16_ref(coo), jr


def test_macro_bf16_matches_jax_and_scipy(macro_case):
    coo, ref, jr = macro_case
    m = coo_to_macro(coo, dtype=BF, device=CPU)
    jm = j_coo_to_macro(JCOO(coo.rows, coo.cols, coo.vals, coo.shape),
                        dtype=jnp.bfloat16)
    assert torch.equal(m.dense, interop._t(np.asarray(jm.dense), CPU))
    # C stays in float32 (acc_dtype), as the JAX package's does
    r, c = _run_port(m, c_dtype=torch.float32, engine="macro",
                     acc_dtype=torch.float32)
    assert r.engine == "macro" and r.c_nnz == len(ref[0]) == jr.c_nnz
    assert jr.vals.dtype == jnp.float32
    assert m.acc_dense().dtype == torch.float32
    assert m.acc_dense() is m.acc_dense()
    _hold(c.rows, c.cols, c.vals, ref, _f32_bound, "port macro")
    jrows, jcols, jvals = _jax_coo(jr)
    _hold(jrows, jcols, jvals, ref, _f32_bound, "JAX macro")
    # the port's C is the JAX package's within the float32 bound of two
    # accumulation orders
    assert np.all(np.abs(c.vals - jvals) <= 2 * (
        F32_RTOL * ref[3] + F32_ATOL))
    with pytest.raises(NotImplementedError, match="acc_dtype"):
        SpGEMM(SpGEMMConfig(engine="macro", dtype=BF))(m, m)


def test_macro_bf16_steady_plan(macro_case):
    coo, ref, _jr = macro_case
    rec, res = run_benchmark(coo, "banded", SpGEMMConfig(
        engine="macro", dtype=BF, acc_dtype=torch.float32, repeat=1,
        warmup=0), verbose=False, device=CPU)
    # the harness leaves the steady plan's C in float32
    assert rec.c_nnz == len(ref[0]) and res.vals.dtype == torch.float32
    c = res.to_coo()
    _hold(c.rows, c.cols, c.vals, ref, _f32_bound, "macro steady plan")
    cfg = SpGEMMConfig(engine="macro", dtype=BF, acc_dtype=torch.float32)
    m = coo_to_macro(coo, dtype=BF, device=CPU)
    plan = make_plan(res, cfg, m, m)
    assert isinstance(plan, MacroPlan)
    out = plan.run(m, m)
    assert int(out[5]) == rec.c_nnz
    # the interactive and the steady tier return C in one dtype
    assert out[2].dtype == SpGEMM(cfg)(m, m).vals.dtype == torch.float32
