"""The merge element engine (ops/element.py) and its scans (ops/scanops.py)
against the JAX package's on the same seeded numpy inputs: structure (rows,
cols, first-flags, c_nnz) bit for bit, float32 values at rtol=1e-5, float64
values at rtol=1e-12.

The float64 references come from ONE subprocess for this file (a
module-scoped fixture) with JAX_ENABLE_X64=1 in its environment: x64 is
process-global, and setting it here would change every other test that a
worker runs after this file."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import random_sparse
from test_torch_util import both_tiled
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.models.synthetic import power_law
from pem_spgemm_tpu.ops import element as JE
from pem_spgemm_tpu.ops import scanops as JS
from pem_spgemm_tpu_torch.ops import element as TE
from pem_spgemm_tpu_torch.ops import scanops as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX = 0x7FFFFFFF


def _matrix(kind):
    if kind == "uniform":
        return JCOO.from_scipy(random_sparse(300, 300, 0.01, seed=4))
    if kind == "power_law":
        return power_law(n=500, nnz=2500, seed=13, hub_correlation=0.2)
    return JCOO.from_scipy(random_sparse(240, 240, 0.03, seed=8))


def _operands(kind):
    """(jax inputs, port inputs) of A@A: element coords of A and the
    element CSR of B, from one set of numpy triplets."""
    ja, ta = both_tiled(_matrix(kind))
    jrp, _jr, jc, jv = ja.element_csr()
    jar, jac = ja.element_coords()
    trp, _tr, tc, tv = ta.element_csr()
    tar, tac = ta.element_coords()
    return (jar, jac, ja.vals, jrp, jc, jv), (tar, tac, ta.vals, trp, tc, tv)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("kind", ["uniform", "power_law", "dense"])
def test_sorted_products_and_reduction_match_jax(kind):
    (jar, jac, jav, jrp, jc, jv), (tar, tac, tav, trp, tc, tv) = \
        _operands(kind)
    joff = JE.product_offsets(jac, jrp[1:] - jrp[:-1])
    toff = TE.product_offsets(tac, trp[1:] - trp[:-1])
    np.testing.assert_array_equal(_np(toff), _np(joff))
    n = int(toff[-1])
    p_cap = n + 37                      # padding slots past the products
    jout = JE.expand_sorted_products(joff, jar, jac, jav, jrp, jc, jv, n,
                                     p_cap)
    tout = TE.expand_sorted_products(toff, tar, tac, tav, trp, tc, tv, n,
                                     p_cap)
    for i in (0, 1, 3, 4):              # ci, cj, out_id, c_nnz
        np.testing.assert_array_equal(_np(tout[i]), _np(jout[i]))
    c_nnz = int(tout[4])
    c_cap = c_nnz + 5
    jr = JE.reduce_products(*jout[:4], c_cap)
    tr = TE.reduce_products(*tout[:4], c_cap)
    np.testing.assert_array_equal(_np(tr[0]), _np(jr[0]))
    np.testing.assert_array_equal(_np(tr[1]), _np(jr[1]))
    assert tr[2].dtype == torch.float32
    np.testing.assert_allclose(_np(tr[2]), _np(jr[2]), rtol=1e-5, atol=1e-6)
    assert (_np(tr[0])[c_nnz:] == MAX).all()


@pytest.mark.parametrize("kind", ["uniform", "power_law"])
@pytest.mark.parametrize("bounded", [True, False])
def test_merge_pipeline_matches_jax(kind, bounded):
    """expand_reduce_products: the gather-free fills, the merge sort with
    the B table and the segmented scan, with the host-bounded scan depths
    and with full-length scans."""
    (jar, jac, jav, jrp, jc, jv), (tar, tac, tav, trp, tc, tv) = \
        _operands(kind)
    bounds = TE.scan_round_bounds(_np(tar), _np(tac), np.diff(_np(trp)))
    assert bounds == JE.scan_round_bounds(np.asarray(jar), np.asarray(jac),
                                          np.diff(np.asarray(jrp)))
    rounds = bounds if bounded else (None, None, None)
    joff = JE.product_offsets(jac, jrp[1:] - jrp[:-1])
    toff = TE.product_offsets(tac, trp[1:] - trp[:-1])
    n = int(toff[-1])
    p_cap = -(-n // 256) * 256
    jout = JE.expand_reduce_products(joff, jar, jac, jav, jrp, jc, jv, n,
                                     p_cap, *rounds)
    tout = TE.expand_reduce_products(toff, tar, tac, tav, trp, tc, tv, n,
                                     p_cap, *rounds)
    for i in (0, 1, 3, 4):              # rows, cols, first, c_nnz
        np.testing.assert_array_equal(_np(tout[i]), _np(jout[i]))
    first = _np(tout[3]) == 1
    np.testing.assert_allclose(_np(tout[2])[first], _np(jout[2])[first],
                               rtol=1e-5, atol=1e-6)
    # untimed assembly: both compact to the same sorted COO
    jr, jc2, jv2 = JE.compact_stream(*jout[:4])
    tr, tc2, tv2 = TE.compact_stream(*tout[:4])
    k = int(tout[4])
    np.testing.assert_array_equal(_np(tr)[:k], _np(jr)[:k])
    np.testing.assert_array_equal(_np(tc2)[:k], _np(jc2)[:k])
    np.testing.assert_allclose(_np(tv2)[:k], _np(jv2)[:k], rtol=1e-5,
                               atol=1e-6)


def test_fixed_step_and_its_overflow_flag_match_jax():
    (jar, jac, jav, jrp, jc, jv), (tar, tac, tav, trp, tc, tv) = \
        _operands("uniform")
    n = int(_np(TE.product_offsets(tac, trp[1:] - trp[:-1]))[-1])
    for p_cap in (-(-n // 256) * 256, 256):     # enough, and too few
        jo = JE.element_fixed(jar, jac, jav, jrp, jc, jv, p_cap=p_cap,
                              c_cap=1)
        to = TE.element_fixed(tar, tac, tav, trp, tc, tv, p_cap=p_cap,
                              c_cap=1)
        for i in (0, 1, 3, 4, 5):
            np.testing.assert_array_equal(_np(to[i]), _np(jo[i]))
        assert bool(to[5]) == (p_cap < n)
    with pytest.raises(TypeError, match="element_fixed_wide"):
        TE.element_fixed(tar, tac, tav.double(), trp, tc, tv.double(),
                         p_cap=256, c_cap=1)


def test_forward_fills_and_scan_match_jax():
    g = np.random.default_rng(21)
    cap = 1000
    # nondecreasing starts with repeats (empty segments) and a start past
    # the capacity
    starts = np.sort(g.integers(0, cap, 120)).astype(np.int32)
    starts[-1] = cap + 5
    mono = np.cumsum(g.integers(0, 3, 120)).astype(np.int32)
    bits = g.integers(-2**31, 2**31 - 1, 120, dtype=np.int64).astype(
        np.int32)
    bits2 = g.standard_normal(120).astype(np.float32).view(np.int32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        _np(TS.fill_monotone_i32(t(starts), t(mono), cap)),
        np.asarray(JS.fill_monotone_i32(starts, mono, cap)))
    np.testing.assert_array_equal(
        _np(TS.fill_any_multi(t(starts), (t(bits),), cap)[0]),
        np.asarray(JS.fill_any_32(starts, bits, cap)))
    for rounds in (None, 4):
        got = TS.fill_any_multi(t(starts), (t(bits), t(bits2)), cap,
                                rounds=rounds)
        want = JS.fill_any_multi(starts, (bits, bits2), cap, rounds=rounds)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(_np(x), np.asarray(y))
    # a segmented sum through fori_scan, int32 so the sums are exact
    flags = (g.random(777) < 0.1).astype(np.int32)
    vals = g.integers(-50, 50, 777).astype(np.int32)

    def seg(a, b):
        return a[0] | b[0], b[1] + (1 - b[0]) * a[1]

    for rounds in (None, 3):
        got = TS.fori_scan(seg, (t(flags), t(vals)), (0, 0), rounds=rounds)
        want = JS.fori_scan(seg, (flags, vals), (0, 0), rounds=rounds)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(_np(x), np.asarray(y))


# --------------------------------------------------------------------------
# float64: the JAX references from one x64 subprocess

_X64 = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from pem_spgemm_tpu.ops import element as E
d = dict(np.load(sys.argv[1]))
off = E.product_offsets(d["a_cols"], d["b_rowptr"][1:] - d["b_rowptr"][:-1])
n = int(off[-1])
p_cap = int(d["p_cap"])
s = E.expand_sorted_products(off, d["a_rows"], d["a_cols"], d["a_vals"],
                             d["b_rowptr"], d["b_cols"], d["b_vals"], n,
                             p_cap)
c_cap = int(s[4]) + 3
r = E.reduce_products(*s[:4], c_cap)
w = E.element_fixed_wide(d["a_rows"], d["a_cols"], d["a_vals"],
                         d["b_rowptr"], d["b_cols"], d["b_vals"],
                         p_cap=p_cap, c_cap=c_cap)
out = {"ci": s[0], "cj": s[1], "out_id": s[3], "c_nnz": s[4],
       "rows": r[0], "cols": r[1], "vals": r[2],
       "w_rows": w[0], "w_cols": w[1], "w_vals": w[2], "w_first": w[3],
       "w_c_nnz": w[4], "w_overflow": w[5]}
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print(np.asarray(r[2]).dtype)
"""


def _f64_inputs():
    """Float64 operands whose values make float32 rounding visible."""
    m = random_sparse(260, 260, 0.02, seed=11, dtype=np.float64)
    m.data = m.data * 1e8 + 1.0
    coo = JCOO.from_scipy(m)
    from pem_spgemm_tpu_torch.formats.coo import COOMatrix as TCOO
    from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled
    t = coo_to_tiled(TCOO(coo.rows, coo.cols, coo.vals, coo.shape),
                     dtype=torch.float64, device="cpu")
    rp, _r, c, v = t.element_csr()
    ar, ac = t.element_coords()
    n = int(TE.product_offsets(ac, rp[1:] - rp[:-1])[-1])
    return m, dict(a_rows=ar, a_cols=ac, a_vals=t.vals, b_rowptr=rp,
                   b_cols=c, b_vals=v, p_cap=-(-n // 256) * 256)


@pytest.fixture(scope="module")
def x64_reference(tmp_path_factory):
    m, d = _f64_inputs()
    tmp = tmp_path_factory.mktemp("x64")
    np.savez(tmp / "in.npz", **{k: _np(v) if isinstance(v, torch.Tensor)
                                else np.asarray(v) for k, v in d.items()})
    env = dict(os.environ, REPO=ROOT, JAX_ENABLE_X64="1",
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", _X64, str(tmp / "in.npz"),
                        str(tmp / "out.npz")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "float64"
    return m, d, dict(np.load(tmp / "out.npz"))


def test_f64_sorted_products_match_jax_x64(x64_reference):
    m, d, want = x64_reference
    off = TE.product_offsets(d["a_cols"],
                             d["b_rowptr"][1:] - d["b_rowptr"][:-1])
    n = int(off[-1])
    s = TE.expand_sorted_products(off, d["a_rows"], d["a_cols"], d["a_vals"],
                                  d["b_rowptr"], d["b_cols"], d["b_vals"], n,
                                  d["p_cap"])
    assert s[2].dtype == torch.float64
    for i, k in ((0, "ci"), (1, "cj"), (3, "out_id"), (4, "c_nnz")):
        np.testing.assert_array_equal(_np(s[i]), want[k])
    r = TE.reduce_products(*s[:4], int(s[4]) + 3)
    np.testing.assert_array_equal(_np(r[0]), want["rows"])
    np.testing.assert_array_equal(_np(r[1]), want["cols"])
    assert r[2].dtype == torch.float64
    np.testing.assert_allclose(_np(r[2]), want["vals"], rtol=1e-12,
                               atol=1e-300)
    # and scipy's float64 product, tighter than float32 could be
    c = (m @ m).tocoo()
    c.sum_duplicates()
    o = np.lexsort((c.col, c.row))
    k = int(s[4])
    assert k == c.nnz
    np.testing.assert_allclose(_np(r[2])[:k], c.data[o], rtol=1e-12)


def test_f64_fixed_wide_step_matches_jax_x64(x64_reference):
    _m, d, want = x64_reference
    w = TE.element_fixed_wide(d["a_rows"], d["a_cols"], d["a_vals"],
                              d["b_rowptr"], d["b_cols"], d["b_vals"],
                              p_cap=d["p_cap"], c_cap=int(want["c_nnz"]) + 3)
    for i, k in ((0, "w_rows"), (1, "w_cols"), (3, "w_first"),
                 (4, "w_c_nnz"), (5, "w_overflow")):
        np.testing.assert_array_equal(_np(w[i]), want[k])
    assert w[2].dtype == torch.float64
    np.testing.assert_allclose(_np(w[2]), want["w_vals"], rtol=1e-12,
                               atol=1e-300)
    # c_cap below the distinct count trips the flag
    small = TE.element_fixed_wide(d["a_rows"], d["a_cols"], d["a_vals"],
                                  d["b_rowptr"], d["b_cols"], d["b_vals"],
                                  p_cap=d["p_cap"], c_cap=8)
    assert bool(small[5])
