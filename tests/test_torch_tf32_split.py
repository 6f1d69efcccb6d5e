"""The 3xTF32 split of the tensor-core class kernel, emulated on the CPU.

csrc/macro_accumulate.cu's class entries (K5, K6) multiply on the tensor
cores in tf32: every float32 operand x is split as hi = tf32(x), lo =
tf32(x - hi), both rounded to nearest with ties away from zero (PTX
cvt.rna.tf32.f32: 10 explicit mantissa bits), and a C tile accumulates
hi*hi + hi*lo + lo*hi over each 32-deep k-slab in float32 before the slab's
partial is added to the tile's sum.  This file replays that arithmetic in
plain PyTorch over the Macro128 tiles of wandering_device and banded_device
matrices and holds it within the bound chip_smoke.py holds the kernel to,
|C - C64| <= 1e-5 * sum|a*b| + 1e-6 against the float64 product: the
float32 dot-product bound, which is what the reference's precision
"highest" promises.  The dropped lo*lo term and the rounding of lo cost
about 2^-22 of |a*b| a product, far inside it; one tf32 product alone
(plain TF32) costs about 2^-11 and must fall outside it.  The pattern is
taken from the raw values: the tf32 hi of a small subnormal is 0.

Non-finite operands: a stage (one pair's 32-deep k-slab) that holds a value
with |x| >= 2^63, an Inf or a NaN is marked and runs in float32 on the raw
values instead (stage_rule_product), so the kernels' NaN positions and Inf
signs are the plain version's (IEEE); the split alone (split_rule_old, the
kernels' earlier rule) turns an Inf into NaN and skips an Inf that meets
only zeros.

At precision "high" and "default" the kernels keep hi alone (one_pass: the
tf32 rounding, or the bfloat16 rounding, which is exact in tf32) and run
one product a k-step; a marked stage rounds its raw operands the same way
before the float32 product.  Those replays are held to the plain version
at the precision (ops.macro.round_operands, then float32 products) and to
the float64 product within (2u + u^2) sum|a*b| plus the float32 bound,
u = 2^-11 (tf32) or 2^-8 (bfloat16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_util import one_torch_thread
from pem_spgemm_tpu.ops import macro as j_macro
from pem_spgemm_tpu_torch.models.synthetic import (banded_device,
                                                   wandering_device)
from pem_spgemm_tpu_torch.ops import macro, symbolic
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)
RTOL, ATOL = 1e-5, 1e-6         # chip_smoke.COO_RTOL, COO_ATOL
KS = 32                         # the kernel's k-slab depth
BIG = 2.0 ** 63                 # the kernel's BIG: a stage holding |x| >=
                                # BIG, an Inf or a NaN is marked


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> tf32 (as float32), round to nearest, ties away from zero:
    add half of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    out = (bits + 0x1000) & ~0x1FFF
    return out.view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split_product(a, b, terms=3):
    """(P, 128, 128) @ (P, 128, 128) as the kernel forms it: per 32-deep
    k-slab lo*hi + hi*lo + hi*hi in float32, the slab's partial added to
    the sum.  terms=1 is plain TF32 (hi*hi alone)."""
    ah, al = split(a)
    bh, bl = split(b)
    out = torch.zeros(a.shape[0], a.shape[1], b.shape[2])
    for k0 in range(0, a.shape[2], KS):
        ks = slice(k0, k0 + KS)
        part = torch.bmm(ah[:, :, ks], bh[:, ks, :])
        if terms == 3:
            part = (torch.bmm(al[:, :, ks], bh[:, ks, :])
                    + torch.bmm(ah[:, :, ks], bl[:, ks, :])) + part
        out += part
    return out


U = {"high": 2.0 ** -11, "default": 2.0 ** -8}


def one_pass(x, precision):
    """The one-pass entries' hi (csrc split<P>): tf32_rna at "high", the
    bfloat16 rounding (to nearest even) at "default"."""
    if precision == "high":
        return tf32_rna(x)
    return x.to(torch.bfloat16).to(torch.float32)


def one_pass_product(a, b, precision):
    """(P, 128, 128) @ (P, 128, 128) as a one-pass entry forms it: per
    32-deep k-slab the float32 product of the hi parts (exact: 11 x 11 or
    8 x 8 bits), the slab's partial added to the sum."""
    ah, bh = one_pass(a, precision), one_pass(b, precision)
    out = torch.zeros(a.shape[0], a.shape[1], b.shape[2])
    for k0 in range(0, a.shape[2], KS):
        ks = slice(k0, k0 + KS)
        out += torch.bmm(ah[:, :, ks], bh[:, ks, :])
    return out


def _tiles_and_pairs(coo):
    m = coo_to_macro(coo)
    offsets = symbolic.pair_counts(m.tile_col, m.tile_rowptr, m.ntiles)
    n_pairs = int(offsets[-1])
    out = symbolic.expand_pairs(offsets, m.tile_row, m.tile_col,
                                m.tile_rowptr, m.tile_col, n_pairs,
                                max(256, -(-n_pairs // 256) * 256), True)
    a_idx, b_idx, seg = (x[:n_pairs].long() for x in out[2:5])
    return m.dense, a_idx, b_idx, seg, int(out[5])


MATRICES = {
    "wandering-4096": lambda: wandering_device(n=4_096, seed=4, device="cpu"),
    "banded64-2048": lambda: banded_device(
        n=2_048, seed=1, bands=tuple(range(-32, 32)), device="cpu"),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_split_product_holds_the_float32_bound(name):
    dense, a_idx, b_idx, seg, n_tiles = _tiles_and_pairs(MATRICES[name]())
    a, b = dense[a_idx], dense[b_idx]
    got = torch.zeros(n_tiles, 128, 128).index_add_(
        0, seg, split_product(a, b))
    a64, b64 = a.double(), b.double()
    want = torch.zeros(n_tiles, 128, 128, dtype=torch.float64).index_add_(
        0, seg, torch.bmm(a64, b64))
    mag = torch.zeros_like(want).index_add_(
        0, seg, torch.bmm(a64.abs(), b64.abs()))
    bound = RTOL * mag + ATOL
    err = (got.double() - want).abs()
    assert a_idx.numel() > 50 and int((mag > 0).sum()) > 10_000
    assert float((err / bound).max()) < 0.1
    # plain TF32: one product of the hi parts falls outside the bound
    tf32 = torch.zeros(n_tiles, 128, 128).index_add_(
        0, seg, split_product(a, b, terms=1))
    assert float(((tf32.double() - want).abs() / bound).max()) > 1.0


@pytest.mark.parametrize("precision", sorted(U))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_one_pass_product_holds_its_bound(name, precision):
    dense, a_idx, b_idx, seg, n_tiles = _tiles_and_pairs(MATRICES[name]())
    # the kernels' hi is the plain version's rounding, bit for bit
    hi = one_pass(dense, precision)
    assert torch.equal(hi.view(torch.int32), macro.round_operands(
        dense, precision).view(torch.int32))
    assert not (hi.view(torch.int32) & 0x1FFF).any()     # exact in tf32
    a, b = dense[a_idx], dense[b_idx]
    got = torch.zeros(n_tiles, 128, 128).index_add_(
        0, seg, one_pass_product(a, b, precision))
    a64, b64 = a.double(), b.double()
    want = torch.zeros(n_tiles, 128, 128, dtype=torch.float64).index_add_(
        0, seg, torch.bmm(a64, b64))
    mag = torch.zeros_like(want).index_add_(
        0, seg, torch.bmm(a64.abs(), b64.abs()))
    u = U[precision]
    err = (got.double() - want).abs()
    assert float((err / ((2 * u + u * u) * mag + RTOL * mag
                         + ATOL)).max()) <= 1.0
    # and outside the float32 bound alone: the mode does round
    assert float((err / (RTOL * mag + ATOL)).max()) > 1.0
    # the plain version at the precision forms the same products
    i32 = [x.to(torch.int32) for x in (a_idx, b_idx, seg)]
    plain, _ = macro.accumulate_macro(dense, dense, *i32, n_tiles,
                                      a_idx.numel(), precision=precision)
    assert float(((got - plain).double().abs()
                  / (2 * (RTOL * mag + ATOL))).max()) <= 1.0


def test_tf32_rounding_is_to_nearest_ties_away():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10                    # tf32's spacing above 1
    cases = [(1 + ulp / 2, 1 + ulp), (1 + ulp / 2 - 2 ** -23, 1.0),
             (-(1 + ulp / 2), -(1 + ulp)), (1 + 3 * ulp / 2, 1 + 2 * ulp)]
    for x, want in cases:
        assert float(tf32_rna(one * x)) == want, x
    x = torch.randn(10_000)
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # hi + lo is x to about 2^-22 relative; hi alone to about 2^-11
    assert float(((hi + lo - x).abs() / x.abs()).max()) < 2.0 ** -21
    assert float(((hi - x).abs() / x.abs()).max()) > 2.0 ** -14


def test_flags_come_from_raw_values_not_from_hi():
    a = torch.zeros(1, 128, 128)
    b = torch.zeros(1, 128, 128)
    a[0, 5, 7] = 1e-42                  # subnormal: its tf32 hi is 0
    b[0, 7, :] = 1.0
    hi_a, _ = split(a)
    assert float(hi_a[0, 5, 7]) == 0.0 and float(a[0, 5, 7]) != 0.0
    raw = torch.bmm((a != 0).float(), (b != 0).float()) > 0
    from_hi = torch.bmm((hi_a != 0).float(), (b != 0).float()) > 0
    assert bool(raw[0, 5].all()) and not bool(from_hi[0, 5].any())
    # a negative zero is no entry either way
    a[0, 6, 7] = -0.0
    assert not bool((torch.bmm((a != 0).float(), (b != 0).float())
                     > 0)[0, 6].any())


# --------------------------------------------------------------------------
# non-finite operands

def stage_rule_product(a, b, precision="highest"):
    """(128, 128) @ (128, 128) by the kernels' per-stage rule: each 32-deep
    k-slab is a stage; a marked stage (its A slab or its B slab holds a
    value with |x| >= BIG, an Inf or a NaN) adds its float32 product of the
    raw values (rounded as ``precision`` rounds them: csrc rounded<P>), any
    other stage its 3xTF32 split product (at "highest") or its one-pass
    product; stages added in order in float32."""
    out = torch.zeros(128, 128)
    for k0 in range(0, 128, KS):
        sa, sb = a[:, k0:k0 + KS], b[k0:k0 + KS, :]
        marked = not bool((sa.abs() < BIG).all() and (sb.abs() < BIG).all())
        if marked:
            part = macro.round_operands(sa, precision) @ \
                macro.round_operands(sb, precision)
        elif precision == "highest":
            part = split_product(sa[None], sb[None])[0]
        else:
            part = one_pass_product(sa[None], sb[None], precision)[0]
        out = out + part
    return out


def split_rule_old(a, b):
    """The same stages by the earlier rule: every slab split, and a slab in
    which a warpgroup's 64 A rows or the B slab hold no non-zero skipped."""
    out = torch.zeros(128, 128)
    for k0 in range(0, 128, KS):
        sa, sb = a[:, k0:k0 + KS], b[k0:k0 + KS, :]
        part = split_product(sa[None], sb[None])[0]
        for g in range(2):
            rows = slice(64 * g, 64 * g + 64)
            if not (bool((sa[rows] != 0).any()) and bool((sb != 0).any())):
                part[rows] = 0.0
        out = out + part
    return out


def _nonfinite_tiles():
    """8 + 1 tiles (the last the zero tile): about 1/3 stored normals, with
    +Inf, -Inf and NaN in A and in B, values near FLT_MAX whose tf32
    rounding overflows (3.4025e38), subnormals against them, an Inf whose
    k-slab of B is all zero, and a finite value at 2^63."""
    g = np.random.default_rng(61)
    x = g.standard_normal((9, 128, 128)).astype(np.float32)
    x[g.random(x.shape) < 0.67] = 0.0
    x[8] = 0.0
    x[0, 3, 5] = np.inf
    x[1, 7, 33] = -np.inf
    x[2, 10, 40] = -np.inf
    x[3, 32:64] = 0.0                   # tile 2's k-slab 1 meets this B
    x[4, 20, 9] = np.nan
    x[5, 17, 100] = np.nan
    x[6, 40, 50] = 3.4025e38
    x[6, 50] = 0.5
    x[6, 41, 50] = 1e-40                # a subnormal against 0.5 and
    x[7, 90, 100] = -3.4025e38          # against -3.4025e38 below
    x[7, 60, :] = 0.25
    x[6, :, 90] = 0.0
    x[6, ::3, 90] = 1e-40
    x[7, 1, 2] = 2.0 ** 63
    return x


# C tile 0: pairs (0, 0), (1, 1), (2, 3); tile 1: (2, 3) alone (the Inf that
# meets only zeros); tile 2: (4, 4), (5, 5); tile 3: (6, 6), (6, 7), (7, 7)
_PAIRS = [(0, 0, 0), (1, 1, 0), (2, 3, 0), (2, 3, 1), (4, 4, 2), (5, 5, 2),
          (6, 6, 3), (6, 7, 3), (7, 7, 3)]


def _nonfinite_stream():
    pairs = np.array(_PAIRS, np.int32)
    pad = 32 - len(pairs)
    a_idx = np.concatenate([pairs[:, 0], np.full(pad, 8, np.int32)])
    b_idx = np.concatenate([pairs[:, 1], np.full(pad, 8, np.int32)])
    seg = np.concatenate([pairs[:, 2], np.full(pad, np.iinfo(np.int32).max,
                                               np.int32)])
    return a_idx, b_idx, seg


def test_nonfinite_stages_give_the_plain_results():
    x = _nonfinite_tiles()
    a_idx, b_idx, seg = _nonfinite_stream()
    tx = torch.from_numpy(x)
    ti = [torch.from_numpy(v) for v in (a_idx, b_idx, seg)]
    want, want_f = macro.accumulate_macro(tx, tx, *ti, 4, 32)
    jwant, jwant_f = j_macro.accumulate_macro(
        jnp.asarray(x), jnp.asarray(x), *(jnp.asarray(v) for v in
                                          (a_idx, b_idx, seg)), 4, 32,
        jnp.float32)
    jwant, jwant_f = torch.tensor(np.asarray(jwant)), np.asarray(jwant_f)
    got = torch.zeros(4, 128, 128)
    old = torch.zeros(4, 128, 128)
    flags = torch.zeros(4, 128, 128, dtype=torch.bool)
    for ai, bi, c in _PAIRS:            # stream order, a tile's sum in f32
        got[c] = got[c] + stage_rule_product(tx[ai], tx[bi])
        old[c] = old[c] + split_rule_old(tx[ai], tx[bi])
        flags[c] |= ((tx[ai] != 0).float() @ (tx[bi] != 0).float()) > 0
    np.testing.assert_array_equal(flags.numpy(), want_f.numpy() > 0)
    np.testing.assert_array_equal(jwant_f > 0, want_f.numpy() > 0)
    for ref in (want, jwant):           # IEEE: the same NaNs, signed Infs
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        inf = torch.isinf(ref)
        assert torch.equal(torch.isinf(got), inf)
        assert torch.equal(got[inf] > 0, ref[inf] > 0)
    x64 = torch.from_numpy(x.astype(np.float64))
    mag = torch.zeros(4, 128, 128, dtype=torch.float64)
    exact = torch.zeros(4, 128, 128, dtype=torch.float64)
    for ai, bi, c in _PAIRS:
        mag[c] += x64[ai].abs() @ x64[bi].abs()
        exact[c] += x64[ai] @ x64[bi]
    fin = torch.isfinite(want)
    assert int(torch.isnan(want).sum()) > 128 and int(torch.isinf(
        want).sum()) > 10 and int(fin.sum()) > 50_000
    err = (got.double() - exact).abs()[fin]
    assert float((err / (RTOL * mag[fin] + ATOL)).max()) < 0.1
    # the fault, shown: the split alone makes NaN of the Infs of tile 0's
    # row 3 (hi = Inf, lo = tf32(Inf - Inf) = NaN) ...
    row3 = torch.isinf(want[0, 3])
    assert bool(row3.any()) and bool(torch.isnan(old[0, 3][row3]).all())
    # ... and skips the -Inf of tile 1 that meets only zeros: the plain
    # version's NaN row is 0 there
    assert bool(torch.isnan(want[1, 10]).all())
    assert not bool(torch.isnan(old[1, 10]).any())
    # and where a value near FLT_MAX meets finite partners the product is
    # finite, not NaN (hi = Inf there)
    fin40 = torch.isfinite(want[3, 40])
    assert bool(fin40.any()) and bool(torch.isnan(old[3, 40][fin40]).any())


@pytest.mark.parametrize("precision", sorted(U))
def test_nonfinite_stages_at_one_pass(precision):
    """The stage rule at "high" / "default" on the same non-finite tiles:
    the plain version's NaN positions and Inf signs at the precision (its
    near-FLT_MAX values round to Inf, so more entries are Inf or NaN than
    at "highest"), flags from the raw values, finite entries within the
    float32 bound of it."""
    x = _nonfinite_tiles()
    tx = torch.from_numpy(x)
    ti = [torch.from_numpy(v) for v in _nonfinite_stream()]
    want, want_f = macro.accumulate_macro(tx, tx, *ti, 4, 32,
                                          precision=precision)
    high, _ = macro.accumulate_macro(tx, tx, *ti, 4, 32)
    got = torch.zeros(4, 128, 128)
    for ai, bi, c in _PAIRS:
        got[c] = got[c] + stage_rule_product(tx[ai], tx[bi], precision)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf] > 0, want[inf] > 0)
    assert int((~torch.isfinite(want)).sum()) > int(
        (~torch.isfinite(high)).sum())
    # 3.4025e38 rounds to Inf: row 40 of tile 3 is no longer finite
    assert not bool(torch.isfinite(want[3, 40]).any())
    x64 = torch.from_numpy(x.astype(np.float64))
    mag = torch.zeros(4, 128, 128, dtype=torch.float64)
    for ai, bi, c in _PAIRS:
        mag[c] += x64[ai].abs() @ x64[bi].abs()
    fin = torch.isfinite(want)
    err = (got - want).double().abs()[fin]
    assert float((err / (2 * (RTOL * mag[fin] + ATOL))).max()) <= 1.0
    flags = torch.zeros(4, 128, 128, dtype=torch.bool)
    for ai, bi, c in _PAIRS:
        flags[c] |= ((tx[ai] != 0).float() @ (tx[bi] != 0).float()) > 0
    np.testing.assert_array_equal(flags.numpy(), want_f.numpy() > 0)


def test_stage_marks_match_the_tf32_overflow():
    """BIG = 2^63 marks every value whose tf32 rounding overflows, every
    non-finite value, and leaves room: below it no product of two split
    parts overflows, and a subnormal's split error (at most 2^-137) times a
    partner below BIG stays under 2^-74."""
    near = torch.tensor([3.4025e38, -3.4025e38, float("inf"),
                         float("nan")])
    assert not bool(torch.isfinite(tf32_rna(near)).all())
    assert not bool((near.abs() < BIG).any())
    below = torch.tensor([2.0 ** 63 * (1 - 2 ** -24), -1e18, 3.0])
    assert bool((below.abs() < BIG).all())
    assert float(tf32_rna(below).abs().max()) ** 2 < 3.4e38
    sub = torch.tensor([1e-40, 3e-42, 1.17e-38])
    hi, lo = split(sub)
    assert float((hi + lo - sub).abs().max()) <= 2.0 ** -137
    assert 2.0 ** -137 * BIG <= 2.0 ** -74
