"""The stencil / run plans of the port's Macro128 engine against the JAX
package's on the same numpy inputs (CPU tensors: the plain class calls run;
the JAX package's class kernel runs in interpret mode).

Plans must be equal field by field.  Values: rtol=1e-5, atol=1e-5 (as
tests/test_stencil.py states; the order of additions differs); structural
flags / counts compared as ``> 0``, exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_util import assert_same, both_coo, to_np
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import banded, wandering_device
from pem_spgemm_tpu.ops import pallas_stencil as ps, symbolic as j_symbolic
from pem_spgemm_tpu.ops.convert import coo_to_macro as j_coo_to_macro
from pem_spgemm_tpu_torch import SpGEMM, SpGEMMConfig, interop
from pem_spgemm_tpu_torch.ops import macro, macro_kernels as mk, \
    stencil as st, symbolic
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro
from pem_spgemm_tpu_torch.ops.fixed import (MacroPlan, StencilMacroPlan,
                                            _try_stencil_plan, make_plan)


def _irregular():
    # every 128x128 block occupied: 16^3 tile pairs, windows far too wide
    rs = np.random.default_rng(5)
    n, nnz = 2000, 8000
    return JCOO(rs.integers(0, n, nnz).astype(np.int32),
                rs.integers(0, n, nnz).astype(np.int32),
                rs.standard_normal(nnz), (n, n)).sum_duplicates()


def _wandering(**kw):
    c = wandering_device(**kw)
    return JCOO(np.array(c.rows), np.array(c.cols), np.array(c.vals),
                c.shape)


# case -> (matrix, planner whose plan runs through stencil_accumulate)
CASES = {
    "banded32": (lambda: banded(n=12_000, bands=tuple(range(-16, 16)),
                                seed=3), "plan_stencil"),
    "irregular": (_irregular, "plan_stencil"),
    "wandering": (lambda: _wandering(n=8192, width=32, block=128, seed=11),
                  "plan_runs"),
    "banded40": (lambda: banded(n=6000, bands=tuple(range(-20, 20)),
                                seed=9), "plan_runs"),
}
PLANNERS = {"plan_stencil": (ps.plan_stencil, st.plan_stencil),
            "plan_runs": (ps.plan_runs, st.plan_runs)}


@pytest.fixture(scope="module")
def cases():
    """case -> everything both packages make of the matrix, built once: the
    macro operands, the pair streams, both planners' plans, the JAX
    stencil_accumulate (class kernel in interpret mode) of the case's plan
    and the port's plain pair accumulation."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        make, planner = CASES[name]
        jc, tc = both_coo(make())
        jm = j_coo_to_macro(jc, dtype=jnp.float32)
        tm = coo_to_macro(tc, device="cpu")
        off = j_symbolic.pair_counts(jm.tile_col, jm.tile_rowptr,
                                     jnp.int32(jm.ntiles))
        n_pairs = int(off[-1])
        p_cap = -(-n_pairs // 256) * 256
        j_out = j_symbolic.expand_pairs(
            off, jm.tile_row, jm.tile_col, jm.tile_rowptr, jm.tile_col,
            jnp.int32(n_pairs), p_cap, True)
        t_off = symbolic.pair_counts(tm.tile_col, tm.tile_rowptr, tm.ntiles)
        t_out = symbolic.expand_pairs(
            t_off, tm.tile_row, tm.tile_col, tm.tile_rowptr, tm.tile_col,
            n_pairs, p_cap, True)
        n_tiles = int(j_out[5])
        assert int(t_off[-1]) == n_pairs and int(t_out[5]) == n_tiles

        def args(o, m):
            c_row, c_col, a_idx, b_idx, seg, _cnt = o
            return (seg, a_idx, b_idx, c_row, c_col, n_pairs, n_tiles,
                    m.dense.shape[0], m.dense.shape[0])

        plans = {k: (jp(*args(j_out, jm)), tp(*args(t_out, tm)))
                 for k, (jp, tp) in PLANNERS.items()}
        jplan = plans[planner][0]
        j_num, j_pat = ps.stencil_accumulate(jm.dense, jm.dense, jplan,
                                             "highest", interpret=True)
        c_cap = -(-n_tiles // 256) * 256
        ref = macro.accumulate_macro(tm.dense, tm.dense, t_out[2], t_out[3],
                                     t_out[4], c_cap, 256)
        cache[name] = dict(jm=jm, tm=tm, t_out=t_out, n_pairs=n_pairs,
                           n_tiles=n_tiles, plans=plans, planner=planner,
                           jax_out=(np.asarray(j_num),
                                    np.asarray(j_pat, np.float32)), ref=ref)
        return cache[name]
    return get


def _assert_plain_equal(plan, got, ref, n_tiles):
    """Slab rows against the sorted-tile accumulation through plan.order."""
    num, flags = got
    order = plan.order
    real = order < n_tiles
    assert real.all() and np.unique(order).size == n_tiles
    np.testing.assert_allclose(num.numpy()[:len(order)],
                               ref[0].numpy()[order], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(flags.numpy()[:len(order)] > 0,
                                  ref[1].numpy()[order] > 0)
    assert not num[len(order):].any() and not flags[len(order):].any()


# --------------------------------------------------------------------------
# plans

def test_planner_constants_equal():
    for name in ("T_STEP", "MIN_CLASS_STEPS", "MAX_CLASSES", "MAX_WIN",
                 "T_MAXR", "P_MAXR", "MAX_WIN_R", "MAX_CLASSES_R"):
        assert getattr(st, name) == getattr(ps, name), name


@pytest.mark.parametrize("planner", sorted(PLANNERS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plans_equal_the_jax_plans(cases, case, planner):
    jplan, tplan = cases(case)["plans"][planner]
    assert isinstance(tplan, st.StencilPlan)
    assert_same(jplan, tplan, f"{planner}({case})")
    assert tplan.order.dtype == jplan.order.dtype
    assert len(tplan.class_tables) == len(tplan.classes)
    for (t, p, _ar, _br, a_offs, b_offs, _b), (p_ptr, ao, bo) in zip(
            tplan.classes, tplan.class_tables):
        assert p_ptr.dtype == ao.dtype == bo.dtype == torch.int32
        assert p_ptr.tolist() == np.concatenate(
            [[0], np.cumsum(st.p_list_of(t, p))]).tolist()
        assert ao.tolist() == list(a_offs) and bo.tolist() == list(b_offs)


def test_stencil_plan_from_numpy_hands_the_jax_plan_over(cases):
    c = cases("wandering")
    jplan, tplan = c["plans"]["plan_runs"]
    handed = interop.stencil_plan_from_numpy(to_np(jplan), device="cpu")
    assert_same(jplan, handed, "interop")
    assert handed.classes == tplan.classes
    for x, y in zip(handed.class_tables, tplan.class_tables):
        assert all(torch.equal(u, v) for u, v in zip(x, y))


# --------------------------------------------------------------------------
# accumulation

@pytest.mark.parametrize("case", sorted(CASES))
def test_stencil_accumulate_matches_jax_interpret(cases, case):
    """Both packages multiply the same operands under the same plan: the JAX
    package's, handed over as numpy."""
    c = cases(case)
    jplan = c["plans"][c["planner"]][0]
    plan = interop.stencil_plan_from_numpy(to_np(jplan), device="cpu")
    tm = interop.macro_from_numpy(to_np(c["jm"]), device="cpu")
    mk.reset_launch_counts()
    num, flags = st.stencil_accumulate(tm.dense, tm.dense, plan)
    assert sum(mk.LAUNCHES.values()) == 0       # CPU tensors: plain version
    assert flags.dtype == torch.uint8 and tuple(num.shape) == \
        (plan.c_cap, 128, 128) == tuple(c["jax_out"][0].shape)
    np.testing.assert_allclose(num.numpy(), c["jax_out"][0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(flags.numpy() > 0, c["jax_out"][1] > 0)
    _assert_plain_equal(plan, (num, flags), c["ref"], c["n_tiles"])


def test_stencil_matches_xla_banded(cases):
    c = cases("banded32")
    plan = c["plans"]["plan_stencil"][1]
    assert plan.coverage > 0.9 and len(plan.classes) >= 1
    assert all(isinstance(cl[1], int) for cl in plan.classes)   # uniform p
    got = st.stencil_accumulate(c["tm"].dense, c["tm"].dense, plan)
    _assert_plain_equal(plan, got, c["ref"], c["n_tiles"])


def test_stencil_irregular_goes_residual(cases):
    c = cases("irregular")
    plan = c["plans"]["plan_stencil"][1]
    assert plan.coverage < 0.6 and plan.res_pa.numel() > 0
    got = st.stencil_accumulate(c["tm"].dense, c["tm"].dense, plan)
    _assert_plain_equal(plan, got, c["ref"], c["n_tiles"])


def test_run_plan_wandering_matches_xla(cases):
    c = cases("wandering")
    sp, rp = (c["plans"][k][1] for k in ("plan_stencil", "plan_runs"))
    assert rp.coverage > 0.6 and rp.coverage > sp.coverage
    assert len(rp.classes) >= 1
    # ragged classes: per-tile pair counts ride the signature
    assert any(isinstance(cl[1], tuple) for cl in rp.classes)
    got = st.stencil_accumulate(c["tm"].dense, c["tm"].dense, rp)
    _assert_plain_equal(rp, got, c["ref"], c["n_tiles"])


def test_run_plan_banded_still_exact(cases):
    c = cases("banded40")
    rp = c["plans"]["plan_runs"][1]
    got = st.stencil_accumulate(c["tm"].dense, c["tm"].dense, rp)
    _assert_plain_equal(rp, got, c["ref"], c["n_tiles"])


def test_run_plan_coverage_scales():
    # planning only (host): at realistic scale the wandering signature
    # space is fully covered by the class budget, in both packages
    from pem_spgemm_tpu_torch.models.synthetic import \
        wandering_device as t_wandering_device
    tm = coo_to_macro(t_wandering_device(n=131072, width=32, block=128,
                                         seed=11, device="cpu"))
    off = symbolic.pair_counts(tm.tile_col, tm.tile_rowptr, tm.ntiles)
    n_pairs = int(off[-1])
    c_row, c_col, a_idx, b_idx, seg, cnt = symbolic.expand_pairs(
        off, tm.tile_row, tm.tile_col, tm.tile_rowptr, tm.tile_col, n_pairs,
        -(-n_pairs // 256) * 256, True)
    rp = st.plan_runs(seg, a_idx, b_idx, c_row, c_col, n_pairs, int(cnt),
                      tm.dense.shape[0], tm.dense.shape[0])
    assert rp.coverage > 0.95, rp.coverage
    jplan = ps.plan_runs(seg.numpy(), a_idx.numpy(), b_idx.numpy(),
                         c_row.numpy(), c_col.numpy(), n_pairs, int(cnt),
                         tm.dense.shape[0], tm.dense.shape[0])
    assert_same(jplan, rp, "plan_runs at n=131072")


# --------------------------------------------------------------------------
# the class calls

def _one_class(c, planner):
    plan = c["plans"][planner][1]
    return plan, plan.classes[0], plan.class_bases[0], plan.class_tables[0]


def _replay_class(tm, cls, bases, tables, uniform_entry):
    """numpy replay of a class kernel's index arithmetic from the tables the
    wrapper uploads: block -> (step, tile), the tile's pair range (from
    p_ptr, or tt * p for the uniform entry), operand tiles base + offset,
    slab row base + block."""
    t, p, _ar, _br, _ao, _bo, base = cls
    p_ptr, ao, bo = (x.numpy() for x in tables)
    ab = bases.numpy()
    d = tm.dense.numpy()
    n_steps = len(ab) // 2
    out = {}
    for block in range(n_steps * t):
        step, tt = divmod(block, t)
        if uniform_entry:
            lo, n = tt * p, p
        else:
            lo, n = p_ptr[tt], p_ptr[tt + 1] - p_ptr[tt]
        a0, b0 = ab[2 * step], ab[2 * step + 1]
        num = np.zeros((128, 128), np.float32)
        pat = np.zeros((128, 128), np.float32)
        for q in range(lo, lo + n):
            at, bt = d[a0 + ao[q]], d[b0 + bo[q]]
            num += at @ bt
            pat += (at != 0).astype(np.float32) @ (bt != 0).astype(np.float32)
        row = base + block
        assert row not in out                   # every row written once
        out[row] = (num, pat > 0)
    return out


@pytest.mark.parametrize("case,planner,uniform_entry", [
    ("wandering", "plan_runs", False), ("banded32", "plan_stencil", False),
    ("banded32", "plan_stencil", True)])
def test_class_kernel_index_arithmetic_replayed_in_numpy(cases, case,
                                                         planner,
                                                         uniform_entry):
    c = cases(case)
    plan, cls, bases, tables = _one_class(c, planner)
    bases = bases[:2 * 3]                       # three steps are enough
    replay = _replay_class(c["tm"], cls, bases, tables, uniform_entry)
    t, p, ar, br, a_offs, b_offs, base = cls
    assert sorted(replay) == list(range(base, base + 3 * t))
    num = torch.full((plan.c_cap, 128, 128), float("nan"))
    flags = torch.full((plan.c_cap, 128, 128), 7, dtype=torch.uint8)
    call = mk.class_call if uniform_entry else mk.class_call2
    extra = () if uniform_entry else (3,)
    call(num, flags, c["tm"].dense, c["tm"].dense, bases, t, p, ar, br,
         a_offs, b_offs, base, *extra, tables=tables)
    for row, (want_n, want_f) in replay.items():
        np.testing.assert_allclose(num[row].numpy(), want_n, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(flags[row].numpy() > 0, want_f)
    # nothing outside the class's rows was touched
    untouched = torch.ones(plan.c_cap, dtype=torch.bool)
    untouched[base:base + 3 * t] = False
    assert torch.isnan(num[untouched]).all()
    assert (flags[untouched] == 7).all()


def test_class_call_equals_class_call2_on_uniform_classes(cases):
    c = cases("banded32")
    plan, cls, bases, tables = _one_class(c, "plan_stencil")
    t, p, ar, br, a_offs, b_offs, base = cls
    d = c["tm"].dense
    outs = []
    for call, extra in ((mk.class_call2, (bases.numel() // 2,)),
                        (mk.class_call, ())):
        num = torch.zeros((plan.c_cap, 128, 128))
        flags = torch.zeros((plan.c_cap, 128, 128), dtype=torch.uint8)
        got = call(num, flags, d, d, bases, t, p, ar, br, a_offs, b_offs,
                   base, *extra, tables=tables)
        assert got[0] is num and got[1] is flags        # in place
        outs.append((num, flags))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    rp = _one_class(cases("wandering"), "plan_runs")
    ragged = next(i for i, cl in enumerate(rp[0].classes)
                  if isinstance(cl[1], tuple))
    t, p, ar, br, a_offs, b_offs, base = rp[0].classes[ragged]
    with pytest.raises(TypeError, match="uniform"):
        mk.class_call(*outs[0], d, d, rp[0].class_bases[ragged], t, p, ar,
                      br, a_offs, b_offs, base)


def test_class_wrappers_refuse_what_the_kernels_do_not_take(cases):
    c = cases("banded32")
    plan, cls, bases, tables = _one_class(c, "plan_stencil")
    t, p, ar, br, a_offs, b_offs, base = cls
    d = c["tm"].dense
    n_steps = bases.numel() // 2
    num = torch.zeros((plan.c_cap, 128, 128))
    flags = torch.zeros((plan.c_cap, 128, 128), dtype=torch.uint8)

    def call(**kw):
        a = dict(c_num=num, c_pat=flags, a_dense=d, b_dense=d,
                 ab_bases=bases, t=t, p=p, ar=ar, br=br, a_offs=a_offs,
                 b_offs=b_offs, base=base, n_steps=n_steps)
        a.update(kw)
        return mk.class_call2(**a, tables=tables)

    with pytest.raises(TypeError, match="uint8"):
        call(c_pat=flags.float())
    with pytest.raises(ValueError, match="window extent"):
        call(ar=max(a_offs))
    with pytest.raises(ValueError, match="exceed the slab"):
        call(base=plan.c_cap - 1)
    with pytest.raises(ValueError, match="entries"):
        call(n_steps=n_steps + 1)
    with pytest.raises(ValueError, match="do not match"):
        call(a_offs=a_offs[:-1])


# --------------------------------------------------------------------------
# the plans through ops.fixed

@pytest.mark.parametrize("case,planner", [("banded32", "plan_stencil"),
                                          ("wandering", "plan_runs")])
def test_stencil_macro_plan_runs_and_equals_the_interactive_result(
        cases, case, planner):
    c = cases(case)
    tm = c["tm"]
    cfg = SpGEMMConfig(engine="macro")
    res = SpGEMM(cfg)(tm, tm)
    # CPU operands: make_plan gives the generic plan, as the reference does
    # off its accelerator; the class plan is built by hand here
    assert isinstance(make_plan(res, cfg, tm, tm), MacroPlan)
    sp = _try_stencil_plan(cfg, tm, tm)
    assert isinstance(sp, StencilMacroPlan) and sp.planner == planner
    assert sp.n_pairs == c["n_pairs"] and sp.grown() is sp
    assert_same(c["plans"][planner][0], sp.plan, "plan through fixed")
    out = sp.run(tm, tm)
    assert int(out[5]) == res.c_nnz and not bool(out[6])
    assert sp.fence(out) is out[4]
    want = res.to_coo()
    (res.c_tile_row, res.c_tile_col, res.vals, res.c_counts,
     res.cptr) = out[:5]
    got = res.to_coo()                          # slab order, same COO
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_allclose(got.vals, want.vals, rtol=1e-5, atol=1e-5)


def test_try_stencil_plan_refuses_irregular_structure(cases):
    tm = cases("irregular")["tm"]
    assert _try_stencil_plan(SpGEMMConfig(engine="macro"), tm, tm) is None
