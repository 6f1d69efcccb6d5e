"""SpGEMMConfig.precision "high" and "default" in the port against the JAX
package, on the CPU.

A mode rounds both operands elementwise (tf32: 11 significant bits, to
nearest with ties away from zero; bfloat16: 8 significant bits, to nearest
even), and then multiplies at "highest" (``ops.macro.round_operands``); the
0/1 pattern comes from the raw values.  XLA:CPU ignores the precision, so
the JAX package computes every mode in full float32 here: the port is held
to it within (2u + u^2) sum|a*b| (u = 2^-11 or 2^-8, the rounding of both
factors of a product) plus twice the float32 bound 1e-5 sum|a*b| + 1e-6
(both sides sum in float32, in another order), with the structure (flags,
counts, C_nnz, sorted coordinates) equal bit for bit.  The port's plain
version at a mode is held bit for bit to the port at "highest" on tables
rounded beforehand.  The inputs are seeded numpy arrays handed to both
packages; the JAX side is jitted once a function and mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_sparse
from test_torch_util import both_coo, both_tiled, one_torch_thread
from pem_spgemm_tpu import SpGEMM as JSpGEMM, SpGEMMConfig as JConfig
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import banded
from pem_spgemm_tpu.ops import macro as j_macro
from pem_spgemm_tpu.ops import numeric as j_numeric
from pem_spgemm_tpu.ops import pallas_stencil as ps
from pem_spgemm_tpu.ops import symbolic as j_symbolic
from pem_spgemm_tpu.ops.convert import coo_to_macro as j_coo_to_macro
from pem_spgemm_tpu.ops.scanops import can_pack
from pem_spgemm_tpu_torch import SpGEMM, SpGEMMConfig
from pem_spgemm_tpu_torch.config import round_up_bucket, round_up_pow2
from pem_spgemm_tpu_torch.formats.coo import COOMatrix as TCOO
from pem_spgemm_tpu_torch.ops import macro, numeric, stencil as st, symbolic
from pem_spgemm_tpu_torch.ops import macro_kernels as mk
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, coo_to_tiled
from pem_spgemm_tpu_torch.ops.dia import coo_to_dia
from pem_spgemm_tpu_torch.ops.fixed import (MacroPlan, SpGEMMPlan,
                                            StencilMacroPlan,
                                            _try_stencil_plan, make_plan)
from pem_spgemm_tpu_torch.parallel import sharded, sharded_macro as sm

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)
LOWER = ("high", "default")
U = {"highest": 0.0, "high": 2.0 ** -11, "default": 2.0 ** -8}
RTOL, ATOL = 1e-5, 1e-6         # the float32 dot-product bound
CHUNK = 1 << 10                 # Tile16 pairs a chunk
CPU = "cpu"


def _bound(mag, p, sides=2):
    """(2u + u^2) mag + ``sides`` float32 bounds (float64 numpy)."""
    u = U[p]
    return (2 * u + u * u) * mag + sides * (RTOL * mag + ATOL)


def _hold(got, want, mag, p, what, sides=2):
    got, want, mag = (np.asarray(x, np.float64) for x in (got, want, mag))
    over = np.abs(got - want) / _bound(mag, p, sides)
    assert over.max(initial=0.0) <= 1.0, (what, float(over.max()))
    return float(over.max(initial=0.0))


def _bits(x):
    return x.contiguous().view(torch.int32)


# --------------------------------------------------------------------------
# round_operands against numpy

def _tf32_numpy(x):
    """tf32 rounding in numpy on the bits: add half of the 13 dropped bits
    to the magnitude, clear them; NaN stays."""
    b = x.view(np.uint32)
    mag = b & np.uint32(0x7FFFFFFF)
    out = (b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(mag > 0x7F800000, b, out).view(np.float32)


def _edge_values():
    f = np.float32
    one = 1.0
    specials = [0.0, -0.0, np.inf, -np.inf, np.nan,
                np.finfo(f).max, -np.finfo(f).max, 3.4025e38, 3.3e38,
                np.finfo(f).tiny, 1e-38, 1e-40, 1e-42, 1e-45, -1e-45,
                2.0 ** 63, 2.0 ** 100,
                # tf32 ties (spacing 2^-10 above 1) and their neighbours
                one + 2 ** -11, one + 3 * 2 ** -11, -(one + 2 ** -11),
                one + 2 ** -11 - 2 ** -23, one + 2 ** -11 + 2 ** -23,
                # bfloat16 ties (spacing 2^-7 above 1), even and odd below
                one + 2 ** -8, one + 3 * 2 ** -8, -(one + 3 * 2 ** -8),
                one + 2 ** -8 + 2 ** -23, 65536.0 + 256.0]
    g = np.random.default_rng(3)
    rand = g.standard_normal(4096) * np.exp(g.uniform(-80, 80, 4096))
    return np.concatenate([np.asarray(specials), rand]).astype(f)


@pytest.mark.parametrize("p", LOWER)
def test_round_operands_is_numpy_rounding_bit_for_bit(p):
    x = _edge_values()
    got = macro.round_operands(torch.from_numpy(x.copy()), p).numpy()
    if p == "default":
        want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    else:
        want = _tf32_numpy(x.copy())
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32),
                          want[~nan].view(np.uint32))
    # what the rounding does at the edges
    assert np.isinf(got[5]) and np.isinf(got[7]) and got[6] == -np.inf
    assert got[12] == 0.0 and x[12] != 0.0          # 1e-42 rounds to 0
    bits = got.view(np.uint32)[np.isfinite(got)]
    low = 0x1FFF if p == "high" else 0xFFFF
    assert not (bits & low).any()


def test_round_operands_leaves_highest_and_other_dtypes_alone():
    x = torch.randn(64)
    assert macro.round_operands(x, "highest") is x
    for dt in (torch.float64, torch.bfloat16):
        y = x.to(dt)
        for p in LOWER:
            assert macro.round_operands(y, p) is y
    for p in LOWER:                     # bfloat16 values: exact in both
        b = x.to(torch.bfloat16).float()
        assert torch.equal(macro.round_operands(b, p), b)


def _refusals():
    t = torch.zeros(2, 128, 128)
    z = torch.zeros(256, dtype=torch.int32)
    bases = torch.zeros(2, dtype=torch.int32)
    slabs = (torch.zeros(1, 128, 128), torch.zeros(1, 128, 128,
                                                   dtype=torch.uint8))
    flat = torch.zeros(2, 256)
    return {
        "config": lambda p: SpGEMMConfig(precision=p),
        "config.with_": lambda p: SpGEMMConfig().with_(precision=p),
        "round_operands": lambda p: macro.round_operands(t, p),
        "accumulate_macro": lambda p: macro.accumulate_macro(
            t, t, z, z, z, 1, 256, precision=p),
        "accumulate_macro_pairs": lambda p: mk.accumulate_macro_pairs(
            t, t, z, z, z, 1, precision=p),
        "class_call2": lambda p: mk.class_call2(
            *slabs, t, t, bases, 1, 1, 1, 1, (0,), (0,), 0, 1, precision=p),
        "class_call": lambda p: mk.class_call(
            *slabs, t, t, bases, 1, 1, 1, 1, (0,), (0,), 0, precision=p),
        "class_call_plain": lambda p: st.class_call_plain(
            *slabs, t, t, bases, 1, 1, (0,), (0,), 0, p),
        "accumulate_fused_flat": lambda p: numeric.accumulate_fused_flat(
            flat, flat, z, z, z, 1, 256, precision=p),
        "accumulate_dense": lambda p: numeric.accumulate_dense(
            flat.view(2, 16, 16), flat.view(2, 16, 16), z, z, z, 1, 256,
            precision=p),
    }


@pytest.mark.parametrize("where", sorted(_refusals()))
def test_unknown_precision_raises(where):
    call = _refusals()[where]
    for bad in ("bf16", "HIGHEST", "tf32", ""):
        with pytest.raises(ValueError, match="precision"):
            call(bad)
    call("default")                     # the three modes pass
    call("high")


# --------------------------------------------------------------------------
# the Macro128 tier: one small banded matrix (12 macro rows: a run-plan
# class of interior rows covering 0.73 of the pairs, and residual boundary
# rows), shared

@pytest.fixture(scope="module")
def mcase():
    coo = banded(n=1536, bands=tuple(range(-40, 41)), seed=7)
    jc, tc = both_coo(coo)
    jm = j_coo_to_macro(jc, dtype=jnp.float32)
    tm = coo_to_macro(tc, device=CPU)
    off = symbolic.pair_counts(tm.tile_col, tm.tile_rowptr, tm.ntiles)
    n_pairs = int(off[-1])
    p_cap = -(-n_pairs // 256) * 256
    out = symbolic.expand_pairs(off, tm.tile_row, tm.tile_col,
                                tm.tile_rowptr, tm.tile_col, n_pairs, p_cap,
                                True)
    n_tiles = int(out[5])
    c_cap = -(-n_tiles // 256) * 256
    a_idx, b_idx, seg = out[2], out[3], out[4]
    mag = macro.accumulate_macro(tm.dense.abs(), tm.dense.abs(), a_idx,
                                 b_idx, seg, c_cap, 256)[0]
    args = (seg, a_idx, b_idx, out[0], out[1], n_pairs, n_tiles,
            tm.dense.shape[0], tm.dense.shape[0])
    tplan = st.plan_runs(*args)
    jargs = tuple(jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor)
                  else x for x in args)
    jplan = ps.plan_runs(*jargs)
    assert tplan.classes and tplan.res_pa.numel()  # both paths run
    return dict(coo=coo, jm=jm, tm=tm, a_idx=a_idx, b_idx=b_idx, seg=seg,
                n_pairs=n_pairs, n_tiles=n_tiles, c_cap=c_cap, mag=mag,
                tplan=tplan, jplan=jplan)


@pytest.mark.parametrize("p", LOWER)
def test_accumulate_macro_against_jax(mcase, p):
    c = mcase
    ji = [jnp.asarray(x.numpy()) for x in (c["a_idx"], c["b_idx"],
                                            c["seg"])]
    j_num, j_cnt = j_macro.accumulate_macro(
        c["jm"].dense, c["jm"].dense, *ji, c["c_cap"], 256, jnp.float32, p)
    args = (c["a_idx"], c["b_idx"], c["seg"], c["c_cap"], 256)
    num, flags = macro.accumulate_macro(c["tm"].dense, c["tm"].dense, *args,
                                        precision=p)
    assert flags.dtype == torch.uint8
    np.testing.assert_array_equal(flags.numpy() > 0,
                                  np.asarray(j_cnt, np.float32) > 0)
    _hold(num.numpy(), np.asarray(j_num), c["mag"].numpy(), p,
          f"accumulate_macro {p}")
    # the mode really rounds: it is not the "highest" result
    high, high_f = macro.accumulate_macro(c["tm"].dense, c["tm"].dense,
                                          *args)
    assert not torch.equal(num, high) and torch.equal(flags, high_f)
    # the plain version at p is "highest" on pre-rounded tables, bit for
    # bit, with the pattern from the raw tables
    r = macro.round_operands(c["tm"].dense, p)
    pre, _ = macro.accumulate_macro(r, r, *args)
    assert torch.equal(_bits(num), _bits(pre))
    # the wrapper takes it on CPU tiles
    w_num, w_flags = mk.accumulate_macro_pairs(
        c["tm"].dense, c["tm"].dense, c["a_idx"], c["b_idx"], c["seg"],
        c["c_cap"], precision=p)
    assert torch.equal(_bits(w_num), _bits(num)) and torch.equal(w_flags,
                                                                 flags)


@pytest.mark.parametrize("p", LOWER)
def test_stencil_accumulate_against_jax(mcase, p):
    c = mcase
    j_num, j_pat = ps.stencil_accumulate(c["jm"].dense, c["jm"].dense,
                                         c["jplan"], p, interpret=True)
    num, flags = st.stencil_accumulate(c["tm"].dense, c["tm"].dense,
                                       c["tplan"], precision=p)
    rows = len(c["tplan"].order)
    np.testing.assert_array_equal(c["tplan"].order, np.asarray(
        c["jplan"].order))
    np.testing.assert_array_equal(flags.numpy() > 0,
                                  np.asarray(j_pat, np.float32) > 0)
    order = torch.from_numpy(c["tplan"].order)
    _hold(num.numpy()[:rows], np.asarray(j_num)[:rows],
          c["mag"][order].numpy(), p, f"stencil_accumulate {p}")
    assert not num[rows:].any()
    # bit for bit "highest" on pre-rounded tables, flags from the raw ones
    r = macro.round_operands(c["tm"].dense, p)
    pre, pre_f = st.stencil_accumulate(r, r, c["tplan"])
    assert torch.equal(_bits(num), _bits(pre)) and torch.equal(flags, pre_f)


@pytest.mark.parametrize("p", LOWER)
def test_class_call_plain_rounds_values_not_flags(p):
    """A class whose only products are a subnormal (1e-42, 0 in tf32 and in
    bfloat16) against normal values: its values are 0 at "high" and
    "default", its flags still 1."""
    a = torch.zeros(2, 128, 128)
    b = torch.zeros(2, 128, 128)
    a[0, 5, 7] = 1e-42
    b[0, 7] = 3.0
    num = torch.full((1, 128, 128), float("nan"))
    pat = torch.full((1, 128, 128), 7, dtype=torch.uint8)
    bases = torch.zeros(2, dtype=torch.int32)
    st.class_call_plain(num, pat, a, b, bases, 1, 1, (0,), (0,), 0, p)
    assert bool((pat[0, 5] == 1).all()) and not bool(num[0, 5].any())
    st.class_call_plain(num, pat, a, b, bases, 1, 1, (0,), (0,), 0)
    assert bool((num[0, 5] != 0).all())


@pytest.mark.parametrize("p", LOWER)
def test_macro_plans_hold_to_the_interactive_result(mcase, p):
    """The port's steady plans at p (MacroPlan, StencilMacroPlan) against
    its own interactive multiply at p: structure equal, values within the
    float32 bound of each other (both compute the same products)."""
    c = mcase
    cfg = SpGEMMConfig(engine="macro", precision=p)
    tm = c["tm"]
    res = SpGEMM(cfg)(tm, tm)
    plan = make_plan(res, cfg, tm, tm)
    assert isinstance(plan, MacroPlan) and plan.precision == p
    out = plan.run(tm, tm)
    n = res.c_ntiles
    assert torch.equal(out[3][:n], res.c_counts[:n])
    assert int(out[5]) == res.c_nnz
    _hold(out[2][:n].numpy(), res.vals[:n].numpy(),
          c["mag"][:n].numpy(), "highest", f"MacroPlan {p}")
    sp = _try_stencil_plan(cfg, tm, tm)
    assert isinstance(sp, StencilMacroPlan) and sp.precision == p
    s_out = sp.run(tm, tm)
    order = torch.from_numpy(sp.plan.order)
    rows = len(order)
    assert torch.equal(s_out[3][:rows], res.c_counts[order])
    assert int(s_out[5]) == res.c_nnz
    _hold(s_out[2][:rows].numpy(), res.vals[order].numpy(),
          c["mag"][order].numpy(), "highest", f"StencilMacroPlan {p}")


def _sorted(c):
    order = np.lexsort((c.cols, c.rows))
    return c.rows[order], c.cols[order], c.vals[order]


def _mag_of(coo, rows, cols):
    s = coo.to_scipy().tocsr().astype(np.float64)
    m = (abs(s) @ abs(s)).tocsr()
    return np.asarray(m[rows, cols]).ravel()


def test_macro_engine_end_to_end_at_default(mcase):
    """SpGEMM(engine="macro") at "default" in both packages: C_nnz and the
    sorted coordinates equal, values within the bound."""
    c = mcase
    jc, _tc = both_coo(c["coo"])
    jm = c["jm"]
    jres = JSpGEMM(JConfig(engine="macro", precision="default"))(jm, jm)
    res = SpGEMM(SpGEMMConfig(engine="macro", precision="default"))(
        c["tm"], c["tm"])
    assert res.c_nnz == jres.c_nnz
    jr, jcl, jv = _sorted(jres.to_coo())
    tr, tcl, tv = _sorted(res.to_coo())
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tcl, jcl)
    _hold(tv, jv, _mag_of(c["coo"], tr, tcl), "default", "macro engine")


def test_macro_ring_replayed_at_each_precision(mcase):
    """The macro ring's ranks replayed in one process at each mode (the
    chunks read from the other ranks' plans): the union of the ranks' C
    has the single-card multiply's structure at that mode, values within
    the float32 bound of it."""
    c = mcase
    tm = c["tm"]
    plans = [sm.plan_sharded_macro(tm, tm, 2, d) for d in range(2)]
    for p in ("highest",) + LOWER:
        parts = [sm.local_macro_coo(q, *sm.local_macro(
            q, sm.replay_chunks(plans, d), p)) for d, q in enumerate(plans)]
        rows, cols, vals = (torch.cat(x) for x in zip(*parts))
        order = torch.sort((rows << 32) | cols).indices
        want = SpGEMM(SpGEMMConfig(engine="macro", precision=p))(tm, tm)
        wr, wc, wv = _sorted(want.to_coo())
        np.testing.assert_array_equal(rows[order].numpy(), wr)
        np.testing.assert_array_equal(cols[order].numpy(), wc)
        _hold(vals[order].numpy(), wv, _mag_of(c["coo"], wr, wc), "highest",
              f"macro ring {p}")


# --------------------------------------------------------------------------
# the Tile16 tier

@pytest.fixture(scope="module")
def tcase():
    coo = JCOO.from_scipy(random_sparse(1000, 1000, 0.005, seed=12))
    ja, ta = both_tiled(coo)
    jb, tb = both_tiled(coo, with_tmasks=True)
    off = symbolic.pair_counts(ta.tile_col, tb.tile_rowptr, ta.ntiles)
    n_pairs = int(off[-1])
    p_cap = max(CHUNK, round_up_pow2(n_pairs))
    packed = can_pack(ta.n_tile_rows, tb.n_tile_cols)
    pairs = symbolic.expand_pairs(off, ta.tile_row, ta.tile_col,
                                  tb.tile_rowptr, tb.tile_col, n_pairs,
                                  p_cap, packed)
    c_cap = round_up_bucket(int(pairs[5]))
    a_f, b_f = ta.dense_flat(), tb.dense_flat()
    mag = numeric.accumulate_fused_flat(a_f.abs(), b_f.abs(), *pairs[2:5],
                                        c_cap, CHUNK)[0]
    return dict(coo=coo, ja=ja, jb=jb, ta=ta, tb=tb, pairs=pairs,
                c_cap=c_cap, mag=mag)


@pytest.mark.parametrize("p", LOWER)
def test_accumulate_fused_flat_against_jax(tcase, p):
    c = tcase
    ji = [jnp.asarray(x.numpy()) for x in c["pairs"][2:5]]
    j_dense, j_cnt = j_numeric.accumulate_fused_flat(
        c["ja"].dense_flat(), c["jb"].dense_flat(), *ji, c["c_cap"], CHUNK,
        jnp.float32, p)
    a_f, b_f = c["ta"].dense_flat(), c["tb"].dense_flat()
    args = (*c["pairs"][2:5], c["c_cap"], CHUNK)
    dense, cnt = numeric.accumulate_fused_flat(a_f, b_f, *args, precision=p)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(j_cnt))
    _hold(dense.numpy(), np.asarray(j_dense), c["mag"].numpy(), p,
          f"accumulate_fused_flat {p}")
    # bit for bit "highest" on pre-rounded tables; counts from the raw ones
    pre, _ = numeric.accumulate_fused_flat(
        macro.round_operands(a_f, p), macro.round_operands(b_f, p), *args)
    _raw, raw_cnt = numeric.accumulate_fused_flat(a_f, b_f, *args)
    assert torch.equal(_bits(dense), _bits(pre))
    assert torch.equal(cnt, raw_cnt)
    # accumulate_dense (the masks engine's values) rounds the same way
    ad = numeric.densify_tiles(c["ta"].vals, c["ta"].rowcol,
                               c["ta"].elem_tile, c["ta"].tile_cap)
    bd = numeric.densify_tiles(c["tb"].vals, c["tb"].rowcol,
                               c["tb"].elem_tile, c["tb"].tile_cap)
    got = numeric.accumulate_dense(ad, bd, *args, precision=p)
    pre = numeric.accumulate_dense(macro.round_operands(ad, p),
                                   macro.round_operands(bd, p), *args)
    assert torch.equal(_bits(got), _bits(pre))


@pytest.mark.parametrize("p", LOWER)
def test_tile16_engines_and_plan_at_precision(tcase, p):
    """Both Tile16 engines at p against the port at "highest" (structure
    equal array for array, values within the bound of each other), and
    SpGEMMPlan at p against the interactive multiply at p."""
    c = tcase
    ta, tb = c["ta"], c["tb"]
    ref = SpGEMM(SpGEMMConfig(engine="fused", numeric_chunk=CHUNK))(ta, tb)
    rr, rc, rv = _sorted(ref.to_coo())
    mag = _mag_of(c["coo"], rr, rc)
    for engine in ("fused", "masks"):
        cfg = SpGEMMConfig(engine=engine, numeric_chunk=CHUNK, precision=p)
        res = SpGEMM(cfg)(ta, tb)
        tr, tcl, tv = _sorted(res.to_coo())
        np.testing.assert_array_equal(tr, rr)
        np.testing.assert_array_equal(tcl, rc)
        _hold(tv, rv, mag, p, f"{engine} {p}")
    plan = make_plan(res, cfg, ta, tb)
    assert isinstance(plan, SpGEMMPlan) and plan.precision == p
    out = plan.run(ta, tb)
    assert int(out[7]) == res.c_nnz
    for i, name in ((0, "c_tile_row"), (1, "c_tile_col"), (2, "cmask"),
                    (3, "cptr")):
        assert torch.equal(out[i][:res.c_ntiles],
                           getattr(res, name)[:res.c_ntiles]), name
    n = res.c_nnz
    assert torch.equal(out[4][:n], res.rowcol[:n])
    _hold(out[6][:n].numpy(), res.vals[:n].numpy(),
          np.abs(res.vals[:n].numpy()) + 1.0, "highest", f"plan {p}")


def test_tile16_ring_replayed_at_default(tcase):
    c = tcase
    ta, tb = c["ta"], c["tb"]
    plans = [sharded.plan_sharded_spgemm(ta, tb, 2, d) for d in range(2)]
    parts = [sharded.local_coo(q, sharded.replay_numeric(plans, d,
                                                         "default"))
             for d, q in enumerate(plans)]
    rows, cols, vals = (torch.cat(x) for x in zip(*parts))
    order = torch.sort((rows << 32) | cols).indices
    want = SpGEMM(SpGEMMConfig(engine="fused", numeric_chunk=CHUNK,
                               precision="default"))(ta, tb)
    wr, wc, wv = _sorted(want.to_coo())
    np.testing.assert_array_equal(rows[order].numpy(), wr)
    np.testing.assert_array_equal(cols[order].numpy(), wc)
    _hold(vals[order].numpy(), wv, _mag_of(c["coo"], wr, wc), "highest",
          "tile16 ring default")


# --------------------------------------------------------------------------
# what ignores the precision

@pytest.mark.parametrize("engine", ["element", "dia", "macro-f64"])
def test_engines_that_ignore_the_precision(engine):
    """The element engine (binned and merge), the DIA engine and float64
    Macro128 tiles give the same C, bit for bit, at all three modes."""
    coo = banded(n=600, bands=(-9, -3, 0, 2, 7), seed=5)
    _jc, tc = both_coo(coo)
    if engine == "dia":
        a = b = coo_to_dia(tc, device=CPU)
    elif engine == "element":
        a = coo_to_tiled(tc, device=CPU)
        b = coo_to_tiled(tc, with_tmasks=True, device=CPU)
    else:
        a = b = coo_to_macro(tc, dtype=torch.float64, device=CPU)
    kw = dict(engine="macro", dtype=torch.float64) \
        if engine == "macro-f64" else dict(engine=engine)
    outs = []
    for p in ("highest",) + LOWER:
        res = SpGEMM(SpGEMMConfig(precision=p, **kw))(a, b)
        assert res.engine == kw["engine"]
        outs.append(_sorted(res.to_coo()))
    for o in outs[1:]:
        for x, y in zip(o, outs[0]):
            np.testing.assert_array_equal(x, y)
    if engine == "element":             # the merge engine too
        tm = TCOO(np.asarray(coo.rows), np.asarray(coo.cols),
                  np.asarray(coo.vals, np.float64), tuple(coo.shape))
        a64 = coo_to_tiled(tm, dtype=torch.float64, device=CPU)
        b64 = coo_to_tiled(tm, dtype=torch.float64, with_tmasks=True,
                           device=CPU)
        got = [_sorted(SpGEMM(SpGEMMConfig(
            engine="element", dtype=torch.float64, precision=p))(
                a64, b64).to_coo()) for p in ("highest", "default")]
        for x, y in zip(*got):
            np.testing.assert_array_equal(x, y)
