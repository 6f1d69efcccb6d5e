"""Persistence of converted operands in the port (a mirror of
tests/test_persist.py): Tile16, Macro128 and DIA round trips that multiply
as the originals do, the magic check, the command line's
--save-converted, and archives that cross between the two packages both
ways with equal arrays.  The JAX functions are called as they are."""

import numpy as np
import pytest
import torch

from test_torch_util import one_torch_thread, xla_unoptimized
from pem_spgemm_tpu.io import persist as j_persist
from pem_spgemm_tpu.models.synthetic import banded, power_law
from pem_spgemm_tpu.ops.convert import coo_to_macro as j_coo_to_macro
from pem_spgemm_tpu.ops.convert import coo_to_tiled as j_coo_to_tiled
from pem_spgemm_tpu.ops.dia import coo_to_dia as j_coo_to_dia
from pem_spgemm_tpu_torch import SpGEMM, SpGEMMConfig
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.io import persist
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, coo_to_tiled
from pem_spgemm_tpu_torch.ops.dia import coo_to_dia

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

CPU = "cpu"
FIELDS = {
    "tiled": ("tile_row", "tile_col", "ptr", "masks", "vals", "rowcol",
              "elem_tile", "tile_rowptr", "tmasks"),
    "macro": ("tile_row", "tile_col", "tile_rowptr", "dense"),
    "dia": ("bands",),
}
META = {"tiled": ("shape", "ntiles"), "macro": ("shape", "ntiles", "nnz"),
        "dia": ("shape", "offsets", "nnz")}


def _port(jcoo):
    return COOMatrix(np.asarray(jcoo.rows), np.asarray(jcoo.cols),
                     np.asarray(jcoo.vals), tuple(jcoo.shape))


def _same(form, got, want):
    """Every array field and the metadata of two operands (either
    package's) equal."""
    for f in FIELDS[form]:
        g, w = getattr(got, f), getattr(want, f)
        if g is None or w is None:
            assert g is None and w is None, f
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in META[form]:
        assert tuple(np.atleast_1d(getattr(got, f))) == \
            tuple(np.atleast_1d(getattr(want, f))), f


def _coo_of(c):
    return (np.asarray(c.rows), np.asarray(c.cols), np.asarray(c.vals))


@pytest.mark.parametrize("engine", ["element", "fused"])
def test_tiled_roundtrip_and_multiply(tmp_path, engine):
    coo = _port(power_law(n=2000, nnz=7000, seed=8, hub_correlation=0.1))
    t = coo_to_tiled(coo, with_tmasks=True, device=CPU)
    p = str(tmp_path / "a.tile16.npz")
    persist.save_tiled(p, t)
    t2 = persist.load_tiled(p, device=CPU)
    assert t2.shape == t.shape and t2.ntiles == t.ntiles
    _same("tiled", t2, t)
    cfg = SpGEMMConfig(engine=engine, numeric_chunk=1 << 10)
    r1, r2 = SpGEMM(cfg)(t, t), SpGEMM(cfg)(t2, t2)
    assert r1.c_nnz == r2.c_nnz
    for x, y in zip(_coo_of(r1.to_coo()), _coo_of(r2.to_coo())):
        np.testing.assert_array_equal(x, y)


def test_macro_roundtrip_and_multiply(tmp_path):
    m = coo_to_macro(_port(banded(n=1000, bands=(0, 2, -2, 64), seed=2)),
                     device=CPU)
    p = str(tmp_path / "a.macro.npz")
    persist.save_macro(p, m)
    m2 = persist.load_macro(p, device=CPU)
    assert m2.ntiles == m.ntiles and m2.nnz == m.nnz
    _same("macro", m2, m)
    cfg = SpGEMMConfig(engine="macro", macro_chunk=16)
    assert SpGEMM(cfg)(m, m).c_nnz == SpGEMM(cfg)(m2, m2).c_nnz


def test_dia_roundtrip_and_multiply(tmp_path):
    d = coo_to_dia(_port(banded(n=700, bands=(0, 1, -1, 40), seed=5)),
                   device=CPU)
    p = str(tmp_path / "a.dia.npz")
    persist.save_dia(p, d)
    d2 = persist.load_dia(p, device=CPU)
    _same("dia", d2, d)
    r1, r2 = SpGEMM(SpGEMMConfig())(d, d), SpGEMM(SpGEMMConfig())(d2, d2)
    assert r1.engine == r2.engine == "dia" and r1.c_nnz == r2.c_nnz
    for x, y in zip(_coo_of(r1.to_coo()), _coo_of(r2.to_coo())):
        np.testing.assert_array_equal(x, y)


def test_magic_mismatch(tmp_path):
    t = coo_to_tiled(_port(banded(n=500, bands=(0, 1), seed=1)), device=CPU)
    p = str(tmp_path / "x.npz")
    persist.save_tiled(p, t)
    with pytest.raises(ValueError, match="not a"):
        persist.load_macro(p, device=CPU)
    with pytest.raises(ValueError, match="not a"):
        persist.load_dia(p, device=CPU)


def test_cli_save_converted(tmp_path):
    from pem_spgemm_tpu_torch.bench import cli
    path = str(tmp_path / "conv.npz")
    cli.main(["banded:n=300", "0", "--repeat", "1", "--warmup", "0",
              "--no-csv", "--save-converted", path, "--engine", "element",
              "--device", CPU])
    t = persist.load_tiled(path, device=CPU)
    assert t.shape == (300, 300) and t.tmasks is not None
    # the JAX package loads what the port's command line wrote
    assert j_persist.load_tiled(path).shape == (300, 300)


def _both(form):
    """(JAX operand, port operand) of one matrix, converted alike."""
    jcoo = banded(n=600, bands=(0, 3, -3, 130), seed=7)
    coo = _port(jcoo)
    if form == "tiled":
        return (j_coo_to_tiled(jcoo, dtype=np.float32, with_tmasks=True),
                coo_to_tiled(coo, with_tmasks=True, device=CPU))
    if form == "macro":
        return (j_coo_to_macro(jcoo, dtype=np.float32),
                coo_to_macro(coo, device=CPU))
    return j_coo_to_dia(jcoo, dtype=np.float32), coo_to_dia(coo, device=CPU)


@pytest.mark.parametrize("form", ["tiled", "macro", "dia"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_archives_cross_between_the_packages(tmp_path, form, direction):
    jx, tx = _both(form)
    _same(form, tx, jx)              # the two conversions agree to begin
    p = str(tmp_path / f"x.{form}.npz")
    if direction == "jax_to_port":
        getattr(j_persist, f"save_{form}")(p, jx)
        got = getattr(persist, f"load_{form}")(p, device=CPU)
        _same(form, got, jx)
    else:
        getattr(persist, f"save_{form}")(p, tx)
        got = getattr(j_persist, f"load_{form}")(p)
        _same(form, got, tx)
    # the archives hold the same keys
    q = str(tmp_path / f"y.{form}.npz")
    getattr(j_persist, f"save_{form}")(q, jx)
    getattr(persist, f"save_{form}")(p, tx)
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files)
        assert str(a["magic"]) == str(b["magic"])


def test_bfloat16_is_refused_both_ways(tmp_path):
    """numpy has no bfloat16: the port refuses to write one, and refuses
    the raw 2-byte records the JAX package writes for one."""
    import jax.numpy as jnp
    jcoo = banded(n=200, bands=(0, 1), seed=3)
    t = coo_to_tiled(_port(jcoo), dtype=torch.bfloat16, device=CPU)
    with pytest.raises(TypeError, match="bfloat16"):
        persist.save_tiled(str(tmp_path / "p.npz"), t)
    p = str(tmp_path / "j.npz")
    j_persist.save_tiled(p, j_coo_to_tiled(jcoo, dtype=jnp.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        persist.load_tiled(p, device=CPU)
