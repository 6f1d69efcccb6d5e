"""The segment sort + dedup kernels' decomposition, replayed in numpy.

csrc/segment_sort.cu cannot run here.  Its two entries are replayed thread
by thread with the launch shape that ops/segment_sort.py exports for the
source (THREADS, DEDUP_ITEMS, sort_items):

  * the dedup entry: tiles of consecutive slots of the flat array, strips
    of DEDUP_ITEMS slots a thread, the reversed segmented scan in the strip,
    across the warp (shuffles, Hillis-Steele) and across the block, the
    last warp's read-ahead that finishes a run going on past the tile, and
    the count summed a block;
  * the sort entry: E slots a thread in registers; each bitonic substep in
    registers (slots less than E apart), by shuffles (less than 32 E apart)
    or, in the transposed layout, through shared memory, with the barriers
    counted; then the dedup scan on the sorted strips.

Each replay is held against the plain versions and against the JAX
package (_dedup_tail, and the Pallas sort kernel in interpret mode) on the
same seeded inputs: keys, first-flags and count exactly, values to
rtol=1e-5 / atol=1e-6 (the sums are taken in another order).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pem_spgemm_tpu.ops import binned as jb
from pem_spgemm_tpu.ops.pallas_sort import segment_sort_dedup as j_ssd
from pem_spgemm_tpu_torch.bench import k1_split
from pem_spgemm_tpu_torch.ops import binned as tb
from pem_spgemm_tpu_torch.ops import segment_sort as ss

SENT = ss.SENTINEL
T = ss.THREADS
W = T // 32
F32 = np.float32
# one XLA compile a case, not one an operation of the eager tail
_jax_dedup_tail = jax.jit(jb._dedup_tail, static_argnums=(2, 3))


# --------------------------------------------------------------------------
# the scan, as each thread, warp and block of the source runs it

def _row_starts(pos0, l, e_items):
    """(..., E+1) bool: slot e of a strip starts a row (row_starts<E>)."""
    o = np.where(pos0 == 0, 0, l - pos0)[..., None]
    offs = np.arange(e_items + 1)
    return (offs >= o) & ((offs - o) % l == 0)


def _strip_flags(k, prev, nxt, rs):
    p = np.concatenate([prev[..., None], k[..., :-1]], -1)
    n = np.concatenate([k[..., 1:], nxt[..., None]], -1)
    head = rs[..., :-1] | (k != p)
    return head & (k != SENT), rs[..., 1:] | (k != n), head


def _scan_strip(v, last):
    for e in range(v.shape[-1] - 2, -1, -1):
        v[..., e] = np.where(last[..., e], v[..., e],
                             v[..., e] + v[..., e + 1])
    return v[..., 0].copy(), last.any(-1)


def _warp_scan(s, f):
    """(..., 32) pairs -> exclusive and inclusive reversed scans."""
    lane = np.arange(32)
    for d in (1, 2, 4, 8, 16):
        s_d = np.zeros_like(s)
        f_d = np.zeros_like(f)
        s_d[..., :-d], f_d[..., :-d] = s[..., d:], f[..., d:]
        ok = lane + d < 32
        s, f = (np.where(ok, np.where(f, s, s + s_d), s),
                np.where(ok, f | f_d, f))
    exc_s, exc_f = np.zeros_like(s), np.zeros_like(f)
    exc_s[..., :-1], exc_f[..., :-1] = s[..., 1:], f[..., 1:]
    return exc_s, exc_f, s, f


def _block_scan(v, last, tile_carry):
    """v, last (blocks, T, E): the scan of one block, tile_carry (blocks,)
    flowing in from after the tile.  Updates v in place."""
    nb = v.shape[0]
    s, f = _scan_strip(v, last)
    exc_s, exc_f, inc_s, inc_f = _warp_scan(s.reshape(nb, W, 32),
                                            f.reshape(nb, W, 32))
    x = np.empty_like(exc_s)
    acc_s = tile_carry.astype(F32)
    for w in range(W - 1, -1, -1):
        x[:, w] = np.where(exc_f[:, w], exc_s[:, w],
                           exc_s[:, w] + acc_s[:, None])
        acc_s = np.where(inc_f[:, w, 0], inc_s[:, w, 0],
                         inc_s[:, w, 0] + acc_s)
    x = x.reshape(nb, T)
    e_items = v.shape[-1]
    hi = np.where(last.any(-1), e_items - 1 - np.argmax(last[..., ::-1], -1),
                  -1)
    open_ = np.arange(e_items)[None, None, :] > hi[..., None]
    v[...] = np.where(open_, v + x[..., None], v)


# --------------------------------------------------------------------------
# the dedup entry

def _run_parts(flat_k, flat_v, q, kt, limit, e_items):
    """run_part for every thread of every reading tile: q (m, threads) the
    threads' first slots -> (part, ended) of shape (m, threads)."""
    total = len(flat_k)
    q = q[..., None] + np.arange(e_items)
    inn = (q < limit[:, None, None]) & (
        flat_k[np.minimum(q, total - 1)] == kt[:, None, None])
    brk = np.where(inn.all(-1), e_items, np.argmin(inn, -1))
    vq = flat_v[np.minimum(q, total - 1)]
    part = np.zeros(brk.shape, F32)
    for e in range(e_items):
        part = np.where(e < brk, part + vq[..., e], part)
    return part, brk < e_items


def _warp_sums(part):
    """(..., 32) -> lane 0's value of the xor-shuffle tree (warp_sum)."""
    lanes = np.arange(32)
    for d in (16, 8, 4, 2, 1):
        part = part + part[..., lanes ^ d]
    return part[..., 0]


def replay_dedup(keys, vals, abits=None):
    """(vals, first, count, read_ahead) as segment_dedup_kernel computes
    them; read_ahead lists (tile, block steps) of every block that read
    past its tile (its last warp's step, then block steps while the run
    goes on)."""
    r, l = keys.shape
    e_items, tile = ss.DEDUP_ITEMS, ss.DEDUP_TILE
    total = r * l
    flat_k = keys.reshape(-1)
    flat_v = (vals.view(F32) * abits.view(F32) if abits is not None
              else vals).reshape(-1).astype(F32)
    nt = -(-total // tile)
    pad = nt * tile - total
    k = np.concatenate([flat_k, np.full(pad, SENT, np.int32)])
    v = np.concatenate([flat_v, np.zeros(pad, F32)])
    k, v = k.reshape(nt, T, e_items), v.reshape(nt, T, e_items).copy()
    start = (np.arange(nt)[:, None] * tile
             + np.arange(T)[None, :] * e_items)
    lane = np.arange(T) % 32
    prev = np.roll(k[..., -1], 1, axis=1)
    edge = (start > 0) & (start <= total)
    prev = np.where(lane == 0, np.where(
        edge, flat_k[np.clip(start - 1, 0, total - 1)], 0), prev)
    nxt = np.roll(k[..., 0], -1, axis=1)
    inside = start + e_items < total
    nxt = np.where(lane == 31, np.where(
        inside, flat_k[np.clip(start + e_items, 0, total - 1)], SENT), nxt)
    rs = _row_starts(start % l, l, e_items)
    first, last, head = _strip_flags(k, prev, nxt, rs)
    count = int(first.sum())

    # the read-ahead of the last warp, for every tile whose last run starts
    # in it and goes on
    tail = np.where(last[:, -1, -1] | (k[:, -1, -1] == SENT), SENT,
                    k[:, -1, -1])
    need = np.nonzero((tail != SENT) & head.any((1, 2)))[0]
    carry = np.zeros(nt, F32)
    base = need * tile
    limit = np.minimum(total, ((base + tile - 1) // l + 1) * l)
    q0 = base + tile
    kt = tail[need]
    lanes = np.arange(32)
    # the last warp's step: 32 lanes of e_items slots
    part, ended = _run_parts(flat_k, flat_v, q0[:, None] + lanes * e_items,
                             kt, limit, e_items)
    stop = np.where(ended.any(1), np.argmax(ended, 1), 32)
    sums = _warp_sums(np.where(lanes > stop[:, None], F32(0), part))
    active = ~ended.any(1) & (q0 + 32 * e_items < limit)
    q0 = q0 + 32 * e_items
    steps = np.zeros(len(need), np.int64)
    threads = np.arange(T)
    while active.any():                 # the block's steps, tile-wide
        part, ended = _run_parts(flat_k, flat_v,
                                 q0[:, None] + threads * e_items, kt, limit,
                                 e_items)
        stop = np.where(ended.any(1), np.argmax(ended, 1), T)
        part = np.where(threads > stop[:, None], F32(0), part)
        ws = _warp_sums(part.reshape(-1, W, 32))
        add = sums.copy()
        for w in range(W):
            add = add + ws[:, w]
        sums = np.where(active, add, sums)
        steps += active
        active &= (stop == T) & (q0 + tile < limit)
        q0 = q0 + tile
    carry[need] = sums
    _block_scan(v, last, carry)
    out_v = v.reshape(-1)[:total].reshape(r, l)
    out_f = first.reshape(-1)[:total].reshape(r, l)
    return out_v, out_f, count, list(zip(need.tolist(), steps.tolist()))


def _sorted_rows(r, l, seed, key_space=None, sentinel_tail=True):
    """Rows sorted by key: duplicate runs of 1-4 (keys from key_space),
    sentinel tails of random length; values standard normal."""
    rs = np.random.default_rng(seed)
    key_space = key_space or max(4, l // 2)
    keys = rs.integers(0, key_space, (r, l)).astype(np.int32)
    if sentinel_tail:
        live = rs.integers(0, l + 1, r)
        keys[np.arange(l)[None, :] >= live[:, None]] = SENT
    keys = np.sort(keys, axis=1)
    return keys, rs.standard_normal((r, l)).astype(F32)


def _long_runs(l, runs, seed):
    """One row of length l: runs given as (start, length) of one key each,
    the rest short runs; values positive."""
    keys, _ = _sorted_rows(1, l, seed, key_space=l, sentinel_tail=False)
    keys = keys[0]
    for s, n in runs:
        keys[s:s + n] = keys[s]
    keys = np.sort(keys)[None, :]
    vals = np.random.default_rng(seed + 1).random((1, l)).astype(F32) + 0.5
    return keys, vals


def _dedup_case(name):
    tile = ss.DEDUP_TILE
    if name == "run across a tile boundary":
        keys, vals = _sorted_rows(4, 2 * tile, seed=1, sentinel_tail=False)
        keys[:, tile - 5:tile + 7] = keys[:, tile - 5][:, None]
        return np.sort(keys, 1), vals, None
    if name == "run longer than two tiles":
        keys, vals = _long_runs(4 * tile, [(tile // 2, 2 * tile + 300)], 2)
        return keys, vals, None
    if name == "l = 2":
        return (*_sorted_rows(3001, 2, seed=3, key_space=2), None)
    if name == "l = 6":
        return (*_sorted_rows(1001, 6, seed=4, key_space=4), None)
    if name == "residual: one row, l >> tile":
        keys, vals = _sorted_rows(1, 11 * tile + 13, seed=5,
                                  key_space=4 * tile)
        return keys, vals, None
    if name == "all-sentinel rows":
        keys, vals = _sorted_rows(40, 96, seed=6)
        keys[::3] = SENT
        return keys, vals, None
    if name == "fused: -0.0 and subnormals":
        keys, bv = _sorted_rows(64, 48, seed=7, key_space=12)
        av = np.random.default_rng(8).standard_normal(keys.shape).astype(F32)
        bv[::2, ::5] = -0.0
        bv[1::2, ::7] = F32(1e-40)          # subnormal operand
        av[::3, 1::4] = F32(1e-20)
        bv[::3, 1::4] = F32(1e-20)          # subnormal product
        return keys, bv.view(np.int32), av.view(np.int32)
    if name == "fused, runs of 1-4":
        keys, bv = _sorted_rows(37, 384, seed=9)
        av = np.random.default_rng(10).standard_normal(keys.shape)
        return keys, bv.view(np.int32), av.astype(F32).view(np.int32)
    if name == "widest packed class":
        l = tb.PACK_CLASSES[-1]
        keys, vals = _sorted_rows(2, l, seed=11)
        return keys, vals, None
    raise KeyError(name)


DEDUP_CASES = ["run across a tile boundary", "run longer than two tiles",
               "l = 2", "l = 6", "residual: one row, l >> tile",
               "all-sentinel rows", "fused: -0.0 and subnormals",
               "fused, runs of 1-4", "widest packed class"]


def _max_run(keys):
    best = 1
    for row in keys:
        row = row[row != SENT]
        if len(row):
            best = max(best, int(np.unique(row, return_counts=True)[1].max()))
    return best


@pytest.mark.parametrize("name", DEDUP_CASES)
def test_dedup_replay_matches_plain_and_jax(name):
    keys, vals, abits = _dedup_case(name)
    got_v, got_f, got_c, _ = replay_dedup(keys, vals, abits)
    tk = torch.from_numpy(keys)
    pv, pf, pc = ss.segment_dedup(tk, torch.from_numpy(vals),
                                  None if abits is None
                                  else torch.from_numpy(abits))
    np.testing.assert_array_equal(got_f, pf.numpy())
    assert got_c == int(pc)
    fm = pf.numpy()
    np.testing.assert_allclose(got_v[fm], pv.numpy()[fm], rtol=1e-5,
                               atol=1e-6)
    # the JAX package's tail: the product rounded as the port forms it
    v = vals.view(F32) * abits.view(F32) if abits is not None else vals
    rounds = int(np.ceil(np.log2(max(2, _max_run(keys))))) + 1
    jv, jf, jc = _jax_dedup_tail(jnp.asarray(keys), jnp.asarray(v), rounds,
                                 keys.shape[1])
    np.testing.assert_array_equal(got_f, np.asarray(jf))
    assert got_c == int(jc)
    np.testing.assert_allclose(got_v[fm], np.asarray(jv)[fm], rtol=1e-5,
                               atol=1e-6)


def test_dedup_read_ahead_once_per_run():
    # a run of 2 tiles + 300 slots starting mid-tile: only the tile with
    # its first slot reads ahead, over the rest of the run (the next tile
    # holds no run start and reads nothing)
    tile = ss.DEDUP_TILE
    keys, vals = _long_runs(4 * tile, [(tile // 2, 2 * tile + 300)], 2)
    in_run = np.nonzero(keys[0] == keys[0, tile // 2])[0]
    first_slot, run_end = int(in_run[0]), int(in_run[-1]) + 1
    assert run_end - first_slot >= 2 * tile + 300
    _, got_f, _, reads = replay_dedup(keys, vals)
    assert got_f[0, first_slot]
    owner = first_slot // tile
    # the last warp's 32 x DEDUP_ITEMS slots, then block steps of a tile up
    # to the one that sees the end
    warp_span = 32 * ss.DEDUP_ITEMS
    steps = (run_end - (owner + 1) * tile - warp_span) // tile + 1
    assert [(t, s) for t, s in reads if s > 0] == [(owner, steps)]
    assert all(t != owner + 1 for t, _ in reads)


def test_dedup_count_is_block_sums():
    # the count: one atomic a block adding its warps' popcounts
    keys, vals = _sorted_rows(9, 1000, seed=12)
    _, got_f, got_c, _ = replay_dedup(keys, vals)
    flat = np.concatenate([got_f.reshape(-1),
                           np.zeros((-got_f.size) % ss.DEDUP_TILE, bool)])
    per_block = flat.reshape(-1, W, 32 * ss.DEDUP_ITEMS).sum((1, 2))
    assert got_c == int(per_block.sum()) == int(got_f.sum())


# --------------------------------------------------------------------------
# the sort entry

def _exchange(ka, kb, va, vb, up):
    sw = ((ka > kb) == up) & (ka != kb)
    return (np.where(sw, kb, ka), np.where(sw, ka, kb),
            np.where(sw, vb, va), np.where(sw, va, vb))


def replay_sort(cols, vals, presorted_w=0):
    """(keys, vals, first, barriers, substeps by where they run) as
    segment_sort_dedup_kernel computes them."""
    r, mw = cols.shape
    p2 = 1 << max(1, (mw - 1).bit_length())
    e_items = ss.sort_items(p2)
    tile = T * e_items
    segs = tile // p2
    nb = -(-r // segs)
    kk = np.full((nb * segs, p2), SENT, np.int32)
    vv = np.zeros((nb * segs, p2), F32)
    kk[:r, :mw], vv[:r, :mw] = cols, vals
    k = kk.reshape(nb, T, e_items)
    v = vv.reshape(nb, T, e_items)
    t = np.arange(T)
    i0 = t * e_items
    lane = t % 32
    where = {"registers": 0, "shuffles": 0, "shared": 0}
    barriers = 0
    k_st = 2 * presorted_w if presorted_w > 1 else 2
    while k_st <= p2:
        last_stage = k_st == p2
        if k_st // 2 >= 32 * e_items:
            barriers += 2
            kb = k.reshape(nb, e_items, T).copy()   # layout B: slot r T + t
            vb = v.reshape(nb, e_items, T).copy()
            j = tile // 2
            while j >= 32 * e_items:
                if j < k_st:
                    rj = j // T
                    assert 0 < rj < e_items
                    for a in range(e_items):
                        if not a & rj:
                            b = a | rj
                            up = last_stage | ((a * T + t) & k_st == 0)
                            kb[:, a], kb[:, b], vb[:, a], vb[:, b] = \
                                _exchange(kb[:, a], kb[:, b], vb[:, a],
                                          vb[:, b], up)
                    where["shared"] += 1
                j //= 2
            k = kb.reshape(nb, T, e_items)
            v = vb.reshape(nb, T, e_items)
        # warps whose slots lie in a k-block of padding alone skip the
        # narrow substeps: their slots must all be sentinels
        local0 = (np.arange(W) * 32 * e_items) & (p2 - 1)
        idle = (local0 & ~(k_st - 1)) >= mw
        if idle.any():
            kw = k.reshape(nb, W, 32 * e_items)
            assert (kw[:, idle] == SENT).all()
            where["idle warps"] = where.get("idle warps", 0) + int(idle.sum())
        live = np.repeat(~idle, 32)[None, :, None]
        k0, v0 = k, v
        up = (last_stage | (i0 & k_st == 0))[None, :, None]
        j = 16 * e_items
        while j >= e_items:
            if j < k_st:
                lm = j // e_items
                assert lm < 32              # the partner is in the warp
                keep_min = ((lane & lm) == 0)[None, :, None] == up
                pk, pv = k[:, t ^ lm], v[:, t ^ lm]
                take = np.where(keep_min, pk < k, pk > k)
                k, v = np.where(take, pk, k), np.where(take, pv, v)
                where["shuffles"] += 1
            j //= 2
        j = e_items // 2
        while j >= 1:
            if j < k_st:
                k, v = k.copy(), v.copy()
                for e in range(e_items):
                    if not e & j:
                        upe = last_stage | ((i0 + e) & k_st == 0)
                        k[..., e], k[..., e | j], v[..., e], v[..., e | j] = \
                            _exchange(k[..., e], k[..., e | j], v[..., e],
                                      v[..., e | j], upe[None, :])
                where["registers"] += 1
            j //= 2
        k, v = np.where(live, k, k0), np.where(live, v, v0)
        k_st *= 2
    # dedup on the sorted strips: neighbours in the tile, sentinel at its
    # ends; every tile ends with a segment, so nothing flows in after it
    barriers += 2
    v = v.copy()
    prev = np.concatenate([np.full((nb, 1), SENT, np.int32),
                           k[:, :-1, -1]], 1)
    nxt = np.concatenate([k[:, 1:, 0], np.full((nb, 1), SENT, np.int32)], 1)
    rs = _row_starts(np.broadcast_to(i0 & (p2 - 1), (nb, T)), p2, e_items)
    first, last, _ = _strip_flags(k, prev, nxt, rs)
    _block_scan(v, last, np.zeros(nb, F32))
    out = lambda a: a.reshape(nb * segs, p2)[:r, :mw]
    return out(k), out(v), out(first), barriers, where


SORT_CASES = [(1536, 64), (3072, 64), (4096, 0), (24, 8), (6, 0), (96, 32),
              (2, 0), (40, 8)]


@pytest.mark.parametrize("mw,presorted_w", SORT_CASES)
def test_sort_replay_matches_plain(mw, presorted_w):
    rows = max(3, 2 * ss.THREADS * ss.sort_items(mw) // mw + 1)
    cols, vals = _presorted_segments(rows, mw, seed=mw + presorted_w,
                                   presorted_w=presorted_w)
    gk, gv, gf, _, _ = replay_sort(cols, vals, presorted_w)
    pk, pv, pf = ss.segment_sort_dedup(torch.from_numpy(cols),
                                       torch.from_numpy(vals), rounds=1,
                                       presorted_w=presorted_w)
    np.testing.assert_array_equal(gk, pk.numpy())
    np.testing.assert_array_equal(gf, pf.numpy())
    fm = pf.numpy()
    np.testing.assert_allclose(gv[fm], pv.numpy()[fm], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mw,presorted_w", [(1536, 64), (24, 8), (6, 0)])
def test_sort_replay_matches_jax_kernel(mw, presorted_w):
    cols, vals = _presorted_segments(5, mw, seed=3 * mw + presorted_w,
                                   presorted_w=presorted_w)
    gk, gv, gf, _, _ = replay_sort(cols, vals, presorted_w)
    rounds = int(np.ceil(np.log2(max(2, _max_run(np.sort(cols, 1)))))) + 1
    jk, jv, jf = j_ssd(jnp.asarray(cols), jnp.asarray(vals), rounds=rounds,
                       interpret=True, presorted_w=presorted_w)
    np.testing.assert_array_equal(gk, np.asarray(jk))
    np.testing.assert_array_equal(gf, np.asarray(jf).astype(bool))
    fm = gf
    np.testing.assert_allclose(gv[fm], np.asarray(jv)[fm], rtol=1e-5,
                               atol=1e-6)


def test_sort_barriers_and_substep_placement():
    # p2 = 2048 from mw = 1536 with presorted runs of 64: stages 128..2048,
    # 45 substeps; only the 6 with slots >= 256 apart need shared memory,
    # in three stages of two barriers each (one barrier a substep before)
    cols, vals = _presorted_segments(2, 1536, seed=1, presorted_w=64)
    *_, barriers, where = replay_sort(cols, vals, 64)
    idle = where.pop("idle warps")
    assert sum(where.values()) == 7 + 8 + 9 + 10 + 11
    assert where == {"registers": 15, "shuffles": 24, "shared": 6}
    assert barriers == 3 * 2 + 2
    # slots 1536-2047 (warps 6 and 7) are padding through stages 128-512
    assert idle == 2 * 3


def _presorted_segments(r, mw, seed, presorted_w=0):
    """Seeded (cols, vals) as the path gives the sort entry: duplicate runs
    of 1-4, sentinel tails; with presorted_w every presorted_w-slot run
    sorted, odd runs descending."""
    rs = np.random.default_rng(seed)
    cols = rs.integers(0, max(4, mw // 2), (r, mw)).astype(np.int32)
    live = rs.integers(0, mw + 1, r)
    cols[np.arange(mw)[None, :] >= live[:, None]] = SENT
    vals = rs.standard_normal((r, mw)).astype(F32)
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


# --------------------------------------------------------------------------
# the source and the split builds

def test_launch_constants_match_the_source():
    with open(ss.SOURCE) as f:
        text = f.read()
    assert re.search(r"constexpr int kThreads = (\d+);", text).group(1) \
        == str(ss.THREADS)
    assert re.search(r"constexpr int kDedupItems = (\d+);", text).group(1) \
        == str(ss.DEDUP_ITEMS)
    assert "if (p2 <= kThreads * 8)" in text
    assert ss.sort_items(2048) == 8 and ss.sort_items(4096) == 16


def test_split_builds_guard_one_place_each():
    # bench/k1_split.py builds the source with each cut's macro defined;
    # each guards code in the dedup entry only
    with open(ss.SOURCE) as f:
        text = f.read()
    for name, defines in k1_split.CUTS.items():
        for d in defines:
            assert text.count(f"#ifndef {d}\n") >= 1, name
            assert text.index(f"#ifndef {d}\n") \
                < text.index("// sort entry"), name
