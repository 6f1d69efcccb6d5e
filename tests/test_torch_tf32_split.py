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
"""

import numpy as np
import pytest
import torch

from pem_spgemm_tpu_torch.models.synthetic import (banded_device,
                                                   wandering_device)
from pem_spgemm_tpu_torch.ops import symbolic
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro

RTOL, ATOL = 1e-5, 1e-6         # chip_smoke.COO_RTOL, COO_ATOL
KS = 32                         # the kernel's k-slab depth


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
