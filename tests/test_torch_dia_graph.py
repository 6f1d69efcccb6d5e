"""A cached DIA plan across runs (ops/dia.DiaPlan): the count cache, the
operand check that decides when a CUDA graph is captured again, and one plan
run on two operand pairs against the JAX package's plan on the same inputs.

On the GPU a cached plan replays one CUDA graph of its values-only multiply
(chip_smoke.py, phase dia_graph_replay, holds the replay to the eager
multiply on the card); a graph reads fixed addresses, so a run on other
band stacks captures again.  Here, on the CPU, the plan stays eager and
records no launches; the operand check (``same_operand``) and the rule
that decides between a replay, a capture and an eager multiply
(``graph_step``) are plain Python.

The JAX side is its XLA path (``make_dia_plan(a, b)`` with no config), run
in this process for float32 and, for float64, in ONE subprocess for this
file with JAX_ENABLE_X64=1 (x64 is process-global), as
tests/test_torch_f64.py does.  In float64 the port is held bit for bit to a
numpy replay of its rounding rule (each product, then each sum, in
ascending A band) and to the JAX package within 1e-12 * sum|a*b|: the JAX
package's XLA:CPU path lands a few ulps away from that rule (about a fifth
of the entries, at most 1.8e-15 here), and its Pallas kernels accumulate in
float32.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_util import one_torch_thread, xla_unoptimized
from pem_spgemm_tpu.formats.coo import COOMatrix as JCOO
from pem_spgemm_tpu.ops import dia as j_dia
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops.dia import (_hold, _plan_maps, coo_to_dia,
                                          graph_step, make_dia_plan,
                                          operand_key, same_operand)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
# (A offsets, B offsets): a gapped set (the pairs entry on the GPU) and a
# stencil (the dense entry)
SETS = {
    "pairs": ((-61, -60, -1, 0, 1, 60, 61), (-60, 0, 1, 60)),
    "dense": ((-3, -1, 0, 2), tuple(range(-2, 3))),
}
N = 700


def _coo(offs, seed):
    """(rows, cols, vals) of an N x N matrix with every entry of the bands
    ``offs``, standard normal values (no exact zero), seeded."""
    rs = np.random.default_rng(seed)
    rows, cols = [], []
    for d in offs:
        i = np.arange(max(0, -d), min(N, N - d))
        rows.append(i)
        cols.append(i + d)
    rows = np.concatenate(rows).astype(np.int32)
    cols = np.concatenate(cols).astype(np.int32)
    vals = rs.standard_normal(len(rows))
    vals[vals == 0] = 1.0
    return rows, cols, vals


def _operand_pairs(name):
    """Two (A, B) pairs of one structure, other values: [(a, b), (a, b)]
    of (rows, cols, vals)."""
    offs_a, offs_b = SETS[name]
    return [(_coo(offs_a, 10 * k + 1), _coo(offs_b, 10 * k + 2))
            for k in range(2)]


def _port_runs(name, dtype):
    """The port's plan, built on the first pair and run on both."""
    ops = [tuple(coo_to_dia(COOMatrix(*m, (N, N)), dtype=dtype, device=CPU)
                 for m in pair) for pair in _operand_pairs(name)]
    plan = make_dia_plan(*ops[0])
    outs = [plan.run(a, b) for a, b in ops]
    return plan, outs


def test_same_operand_tells_a_new_tensor_from_one_changed_in_place():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    held = (x, operand_key(x))          # as a capture keeps it
    assert same_operand(held, x)
    x.mul_(2.0)                         # values changed in place: the same
    x[1, 2] = -5.0
    assert same_operand(held, x)
    assert not same_operand(held, x.clone())    # equal values, new memory
    assert not same_operand(held, x.view(3, 4))  # another tensor object
    assert not same_operand(held, x.double())
    x.resize_(6, 4)                     # the same object, grown in place
    assert not same_operand(held, x)
    y = torch.zeros(4, 3)
    held = (y, operand_key(y))
    y.as_strided_((3, 4), (1, 3))       # the same memory, other strides
    assert not same_operand(held, y)


def test_graph_step_captures_only_operands_met_twice_in_a_row():
    # the GPU plan's rule, driven on CPU band stacks: its first (counting)
    # run notes the operands, the next run on them captures; other
    # operands run eagerly once, and a plan that alternates never captures
    pairs = [tuple(coo_to_dia(COOMatrix(*m, (N, N)), device=CPU)
                   for m in pair) for pair in _operand_pairs("pairs")]
    (xa, xb), (ya, yb) = pairs
    g = {"seen": _hold(xa, xb)}             # as the counting run leaves it

    def step(a, b):
        s = graph_step(g, a, b)
        if s == "capture":                  # what DiaPlan.capture keeps
            g["operands"] = _hold(a, b)
        return s

    assert step(xa, xb) == "capture"
    assert step(xa, xb) == "replay"
    xa.bands.mul_(2.0)                      # values changed in place
    assert step(xa, xb) == "replay"
    assert step(ya, yb) == "eager"
    assert [step(*p) for p in pairs * 3] == ["replay", "eager"] * 3
    assert step(ya, yb) == "capture"        # met twice in a row
    assert step(ya, yb) == "replay"
    assert step(xa, xb) == "eager"          # the graph now holds y
    assert step(xa, yb) == "eager"          # a mixed pair is another pair
    assert step(xa, yb) == "capture"
    other = dataclasses.replace(xa, bands=xa.bands.clone())
    assert step(other, yb) == "eager"       # equal values, other memory


@pytest.mark.parametrize("name", sorted(SETS))
def test_cpu_plan_stays_eager(name):
    plan, outs = _port_runs(name, torch.float32)
    assert plan.launches == {} and plan._graph == {}
    # the counts and c_nnz of the first run are cached and returned again
    assert outs[1][1] is outs[0][1] and outs[1][2] is outs[0][2]
    assert not bool(outs[0][3]) and not bool(outs[1][3])
    # a third run on the first pair gives the first run's values
    ops = [coo_to_dia(COOMatrix(*m, (N, N)), device=CPU)
           for m in _operand_pairs(name)[0]]
    again = plan.run(*ops)
    assert plan._graph == {}
    assert torch.equal(again[0], outs[0][0])


@pytest.mark.parametrize("name", sorted(SETS))
def test_plan_on_two_operand_pairs_equals_jax_float32(name):
    plan, outs = _port_runs(name, torch.float32)
    pairs = _operand_pairs(name)
    jops = [tuple(j_dia.coo_to_dia(JCOO(*m, (N, N))) for m in pair)
            for pair in pairs]
    jplan = j_dia.make_dia_plan(*jops[0])
    assert plan.dc_list == tuple(jplan.dc_list)
    for k, ((ja, jb), (c, cnt, nnz, _ovf)) in enumerate(zip(jops, outs)):
        jc, jcnt, jnnz, jovf = jplan.run(ja, jb)
        assert int(nnz) == int(jnnz) and not bool(jovf), k
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-6)
    # the second pair's values are not the first's
    assert not np.allclose(outs[0][0].numpy(), outs[1][0].numpy())


_SCRIPT = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
from pem_spgemm_tpu.formats.coo import COOMatrix
from pem_spgemm_tpu.ops import dia
d = dict(np.load(sys.argv[1]))
n = int(d["n"])
out = {}
for name in d["names"]:
    ops = [tuple(dia.coo_to_dia(COOMatrix(d[f"{name}_{k}{m}_rows"],
                                          d[f"{name}_{k}{m}_cols"],
                                          d[f"{name}_{k}{m}_vals"], (n, n)),
                                dtype=jnp.float64) for m in "ab")
           for k in range(2)]
    plan = dia.make_dia_plan(*ops[0])
    for k, (a, b) in enumerate(ops):
        c, cnt, nnz, _ = plan.run(a, b)
        out[f"{name}_{k}_c"] = np.asarray(c)
        out[f"{name}_{k}_cnt"] = np.asarray(cnt)
        out[f"{name}_{k}_nnz"] = np.asarray(nnz)
np.savez(sys.argv[2], **out)
print("ok")
"""


@pytest.fixture(scope="module")
def x64(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dia_graph")
    arrays = {"n": np.asarray(N), "names": np.asarray(sorted(SETS))}
    for name in SETS:
        for k, pair in enumerate(_operand_pairs(name)):
            for m, (rows, cols, vals) in zip("ab", pair):
                arrays.update({f"{name}_{k}{m}_rows": rows,
                               f"{name}_{k}{m}_cols": cols,
                               f"{name}_{k}{m}_vals": vals})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, REPO=ROOT, JAX_ENABLE_X64="1",
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp / "in.npz"),
                        str(tmp / "out.npz")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _products_then_sums(a, b, offs_a, offs_b):
    """C band stack of a (d1n, n) x b (d2n, n) in numpy float64, each
    product rounded, then added to its C element in ascending A band: the
    rounding rule of the kernels' float64 entries and their plain version;
    a B column outside [0, n) adds nothing."""
    dc, idx_map = _plan_maps(offs_a, offs_b)
    n = a.shape[1]
    c = np.zeros((len(dc), n))
    for k1, d1 in enumerate(offs_a):
        j = np.arange(n) + d1
        ok = (j >= 0) & (j < b.shape[1])
        for k2 in range(len(offs_b)):
            p = a[k1] * b[k2, np.clip(j, 0, b.shape[1] - 1)]
            row = idx_map[k1][k2]
            c[row] = np.where(ok, c[row] + p, c[row])
    return c


@pytest.mark.parametrize("name", sorted(SETS))
def test_plan_on_two_operand_pairs_equals_jax_float64(name, x64):
    plan, outs = _port_runs(name, torch.float64)
    offs_a, offs_b = SETS[name]
    pairs = _operand_pairs(name)
    for k, (c, cnt, nnz, _ovf) in enumerate(outs):
        got = c.numpy()
        assert c.dtype == torch.float64
        # bit for bit the rule's rounding (-0.0 and +0.0 told apart)
        a, b = (coo_to_dia(COOMatrix(*m, (N, N)), dtype=torch.float64,
                           device=CPU).bands.numpy() for m in pairs[k])
        want = _products_then_sums(a, b, offs_a, offs_b)
        assert np.array_equal(got.view(np.int64), want.view(np.int64)), k
        # the JAX package's x64 plan: counts and c_nnz exact, values
        # within 1e-12 * sum|a*b| (its XLA:CPU path does not round every
        # product and sum as the rule does: a few ulps apart)
        np.testing.assert_array_equal(cnt.numpy(), x64[f"{name}_{k}_cnt"])
        assert int(nnz) == int(x64[f"{name}_{k}_nnz"])
        mag = _products_then_sums(np.abs(a), np.abs(b), offs_a, offs_b)
        jc = x64[f"{name}_{k}_c"]
        assert jc.dtype == np.float64
        assert (np.abs(got - jc) <= 1e-12 * mag).all(), k
    assert plan.launches == {}
