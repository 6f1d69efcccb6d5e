"""The port's segment sort + dedup (ops/segment_sort.py) against the JAX
package's Pallas kernel in interpret mode and its _dedup_tail.

On the CPU the port's wrappers take their plain versions, so this holds
the plain versions (which the GPU kernel is in turn held against on the
card by chip_smoke.py) to the JAX contract: keys and first-flags exact,
first-slot values to rtol=1e-4 / atol=1e-6 (group members are summed in a
different order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pem_spgemm_tpu.ops import binned as jb
from pem_spgemm_tpu.ops.pallas_sort import segment_sort_dedup as j_ssd
from pem_spgemm_tpu_torch.ops import segment_sort as ss

SENT = 0x7FFFFFFF


def _segments(r, mw, seed, presorted_w=0, key_space=None):
    """Seeded (cols, vals): duplicate runs of 1-4, sentinel tails of
    random length.  With presorted_w every presorted_w-slot run is sorted,
    odd runs descending (the invariant the merge-only network needs)."""
    rs = np.random.default_rng(seed)
    key_space = key_space or max(4, mw // 2)
    cols = rs.integers(0, key_space, (r, mw)).astype(np.int32)
    live = rs.integers(0, mw + 1, r)
    cols[np.arange(mw)[None, :] >= live[:, None]] = SENT
    vals = rs.standard_normal((r, mw)).astype(np.float32)
    if presorted_w:
        c3 = cols.reshape(r, mw // presorted_w, presorted_w)
        v3 = vals.reshape(r, mw // presorted_w, presorted_w)
        order = np.argsort(c3, axis=2, kind="stable")
        c3 = np.take_along_axis(c3, order, 2)
        v3 = np.take_along_axis(v3, order, 2)
        c3[:, 1::2] = c3[:, 1::2, ::-1]
        v3[:, 1::2] = v3[:, 1::2, ::-1]
        cols, vals = c3.reshape(r, mw), v3.reshape(r, mw)
    return np.ascontiguousarray(cols), np.ascontiguousarray(vals)


def _max_run(cols):
    best = 1
    for row in np.sort(cols, axis=1):
        row = row[row != SENT]
        if len(row):
            best = max(best, np.unique(row, return_counts=True)[1].max())
    return int(best)


def _rounds(cols):
    return max(1, int(np.ceil(np.log2(max(2, _max_run(cols))))))


@pytest.mark.parametrize("mw,presorted_w", [
    (16, 0), (48, 0), (96, 0), (16, 8), (48, 16), (96, 32), (192, 64)])
def test_sort_dedup_matches_jax_kernel(mw, presorted_w):
    jax.clear_caches()
    cols, vals = _segments(9, mw, seed=mw + presorted_w,
                           presorted_w=presorted_w)
    rounds = _rounds(cols)
    jk, jv, jf = j_ssd(jnp.asarray(cols), jnp.asarray(vals), rounds=rounds,
                       interpret=True, presorted_w=presorted_w)
    tk, tv, tf = ss.segment_sort_dedup(
        torch.from_numpy(cols), torch.from_numpy(vals), rounds=rounds,
        presorted_w=presorted_w)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    fm = np.asarray(jf)
    np.testing.assert_allclose(tv.numpy()[fm], np.asarray(jv)[fm],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("l", [2, 16, 48, 1024])
def test_dedup_matches_jax_dedup_tail(l):
    cols, vals = _segments(7, l, seed=l)
    order = np.argsort(cols, axis=1, kind="stable")
    keys = np.take_along_axis(cols, order, 1)
    vals = np.take_along_axis(vals, order, 1)
    n_rounds = _rounds(cols)
    jv, jf, jc = jb._dedup_tail(jnp.asarray(keys), jnp.asarray(vals),
                                n_rounds, l)
    tv, tf, tcnt = ss.segment_dedup(torch.from_numpy(keys),
                                    torch.from_numpy(vals))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert int(tcnt) == int(jc)
    fm = np.asarray(jf)
    np.testing.assert_allclose(tv.numpy()[fm], np.asarray(jv)[fm],
                               rtol=1e-4, atol=1e-6)


def test_fused_dedup_matches_jax_packed_multiply():
    cols, bvals = _segments(6, 64, seed=5)
    avals = np.random.default_rng(6).standard_normal(
        cols.shape).astype(np.float32)
    order = np.argsort(cols, axis=1, kind="stable")
    keys = np.take_along_axis(cols, order, 1)
    bbits = np.take_along_axis(bvals, order, 1).view(np.int32)
    abits = avals.view(np.int32)
    rows = np.arange(6, dtype=np.int32)
    jk, jv, jf, jc = jb.packed_multiply(
        jnp.asarray(keys), jnp.asarray(bbits), jnp.asarray(abits),
        jnp.asarray(rows), _rounds(cols))
    tv, tf, tcnt = ss.segment_dedup(torch.from_numpy(keys),
                                    torch.from_numpy(bbits),
                                    torch.from_numpy(abits))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert int(tcnt) == int(jc)
    fm = np.asarray(jf)
    np.testing.assert_allclose(tv.numpy()[fm], np.asarray(jv)[fm],
                               rtol=1e-4, atol=1e-6)


def test_plain_versions_against_numpy_groupby():
    # independent of JAX: per-row numpy group sums
    cols, vals = _segments(5, 96, seed=11, key_space=12)
    k, v, f = ss.segment_sort_dedup_plain(torch.from_numpy(cols),
                                          torch.from_numpy(vals))
    for i in range(cols.shape[0]):
        live = cols[i] != SENT
        uniq = np.unique(cols[i][live])
        np.testing.assert_array_equal(k[i].numpy()[f[i].numpy()], uniq)
        sums = np.array([vals[i][cols[i] == u].sum(dtype=np.float64)
                         for u in uniq])
        np.testing.assert_allclose(v[i].numpy()[f[i].numpy()], sums,
                                   rtol=1e-4, atol=1e-6)
        assert (k[i].numpy()[len(cols[i][live]):] == SENT).all()


def test_cpu_calls_launch_no_kernel():
    ss.reset_launch_counts()
    cols, vals = _segments(3, 16, seed=1)
    ss.segment_sort_dedup(torch.from_numpy(cols), torch.from_numpy(vals),
                          rounds=2)
    ss.segment_dedup(torch.from_numpy(np.sort(cols, axis=1)),
                     torch.from_numpy(vals))
    assert ss.LAUNCHES == {"segment_sort_dedup": 0, "segment_dedup": 0}


@pytest.mark.parametrize("case", [
    "cols_dtype", "vals_dtype", "too_wide", "shape_mismatch",
    "non_contiguous", "one_dim", "presorted_not_pow2",
    "presorted_not_dividing", "dedup_keys_dtype", "dedup_abits_dtype",
    "dedup_shape"])
def test_wrapper_refusals(case):
    c = torch.zeros((4, 32), dtype=torch.int32)
    v = torch.zeros((4, 32), dtype=torch.float32)
    if case == "cols_dtype":
        call = lambda: ss.segment_sort_dedup(c.long(), v, rounds=1)
    elif case == "vals_dtype":
        call = lambda: ss.segment_sort_dedup(c, v.double(), rounds=1)
    elif case == "too_wide":
        call = lambda: ss.segment_sort_dedup(
            torch.zeros((1, 4097), dtype=torch.int32),
            torch.zeros((1, 4097), dtype=torch.float32), rounds=1)
    elif case == "shape_mismatch":
        call = lambda: ss.segment_sort_dedup(c, v[:, :16].contiguous(),
                                             rounds=1)
    elif case == "non_contiguous":
        call = lambda: ss.segment_sort_dedup(c.t(), v.t(), rounds=1)
    elif case == "one_dim":
        call = lambda: ss.segment_sort_dedup(c[0], v[0], rounds=1)
    elif case == "presorted_not_pow2":
        call = lambda: ss.segment_sort_dedup(
            torch.zeros((1, 48), dtype=torch.int32),
            torch.zeros((1, 48), dtype=torch.float32), rounds=1,
            presorted_w=12)
    elif case == "presorted_not_dividing":
        call = lambda: ss.segment_sort_dedup(
            torch.zeros((1, 48), dtype=torch.int32),
            torch.zeros((1, 48), dtype=torch.float32), rounds=1,
            presorted_w=32)
    elif case == "dedup_keys_dtype":
        call = lambda: ss.segment_dedup(c.long(), v)
    elif case == "dedup_abits_dtype":
        call = lambda: ss.segment_dedup(c, c, v)
    else:
        call = lambda: ss.segment_dedup(c, v[:2].contiguous())
    with pytest.raises((TypeError, ValueError)):
        call()
