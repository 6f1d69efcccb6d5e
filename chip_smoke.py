"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --only kernel_check
    python3 chip_smoke.py --profile rmat-16 [--no-pack] [--iters 20]

Builds the port's CUDA kernel from the sources in this checkout, holds both
of its entries against their plain PyTorch versions on the card, drives the
binned element engine end to end at full size (powerlaw-1M, rmat-16,
uniform-1M through bench.harness.run_benchmark; powerlaw-1M again through
the chunk-granular plan that reaches the sort+dedup entry), checks C against
scipy on the host, and times both kernel entries at powerlaw-1M's largest
bucket beside their memory bound.

With --profile the script instead shows where one matrix's steady multiply
spends its time: each stream of the planned multiply timed alone with CUDA
events, the host-clock time per multiply (synchronising after each one, and
only once after a batch) with the kernel launches counted per multiply, and
a torch.profiler pass that gives device-busy time, the idle share and the
kernels that take most device time.

Each phase prints one JSON line.  There is no CPU path: without a CUDA
device the script fails.  It exits non-zero on the first failed phase and
prints the line {"ok": true, ...} last only when every phase passed.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from pem_spgemm_tpu_torch.bench.harness import run_benchmark
from pem_spgemm_tpu_torch.config import SpGEMMConfig
from pem_spgemm_tpu_torch.models.synthetic import (power_law, rmat,
                                                   uniform_random)
from pem_spgemm_tpu_torch.ops import binned
from pem_spgemm_tpu_torch.ops import segment_sort as ss
from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled

SENT = ss.SENTINEL
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM data sheet, outside tensor cores
VAL_RTOL, VAL_ATOL = 1e-4, 1e-6     # kernel vs plain: summation order differs
# C values vs scipy's float64 product: |got - want| <= COO_RTOL * S + COO_ATOL
# with S the sum of |a*b| over the entry's products (the forward-error bound
# of a float32 dot product).  At full size some entries cancel (|want| << S),
# so a tolerance relative to |want|, as the small CPU tests use, cannot hold
# for them in float32; the script counts those entries and prints the count.
COO_RTOL, COO_ATOL = 1e-5, 1e-6
SOURCE = "pem_spgemm_tpu_torch/csrc/segment_sort.cu"

# C_nnz the JAX package recorded for the same generators (BENCH_r05.json)
RECORDED_C_NNZ = {"rmat-16": 66_875_950, "uniform-1M": 16_004_570}

MATRICES = {
    "powerlaw-1M": lambda: power_law(n=1_000_000, nnz=3_000_000, seed=42,
                                     hub_correlation=0.1),
    "rmat-16": lambda: rmat(scale=16, edge_factor=8, seed=7),
    "uniform-1M": lambda: uniform_random(1_000_000, 1_000_000, 4_000_000,
                                         seed=3),
}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n=20):
    """Device ms per call: CUDA events around n calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


# --------------------------------------------------------------------------
# seeded kernel inputs

def make_segments(r, mw, seed, presorted_w=0):
    """(cols, vals) on the card: duplicate runs of 1-4 (keys drawn from a
    space of mw/2), sentinel tails of random length.  With presorted_w every
    presorted_w-slot run is sorted, odd runs descending."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    space = max(4, mw // 2)
    cols = torch.randint(0, space, (r, mw), generator=g, device="cuda",
                         dtype=torch.int32)
    live = torch.randint(0, mw + 1, (r, 1), generator=g, device="cuda")
    cols[torch.arange(mw, device="cuda")[None, :] >= live] = SENT
    vals = torch.randn((r, mw), generator=g, device="cuda")
    if presorted_w:
        c3 = cols.reshape(r, mw // presorted_w, presorted_w)
        v3 = vals.reshape(r, mw // presorted_w, presorted_w)
        c3, order = torch.sort(c3, dim=2, stable=True)
        v3 = torch.gather(v3, 2, order)
        odd = (torch.arange(mw // presorted_w, device="cuda") & 1).bool()
        odd = odd[None, :, None]
        c3 = torch.where(odd, c3.flip(2), c3)
        v3 = torch.where(odd, v3.flip(2), v3)
        cols, vals = c3.reshape(r, mw), v3.reshape(r, mw)
    return cols.contiguous(), vals.contiguous()


def compare(kernel_out, plain_out, what):
    """Keys and first-flags exact, first-slot values within tolerance.
    Returns the max abs error over first slots."""
    (kk, kv, kf), (pk, pv, pf) = kernel_out, plain_out
    if kk is not None and not torch.equal(kk, pk):
        raise AssertionError(f"{what}: keys differ")
    if not torch.equal(kf, pf):
        raise AssertionError(f"{what}: first-flags differ")
    a, b = kv[pf], pv[pf]
    if not torch.allclose(a, b, rtol=VAL_RTOL, atol=VAL_ATOL):
        raise AssertionError(
            f"{what}: first-slot values differ, max abs "
            f"{(a - b).abs().max().item()}")
    return (a - b).abs().max().item() if a.numel() else 0.0


def phase_kernel_check():
    worst = {"segment_sort_dedup": 0.0, "segment_dedup": 0.0}
    cases = 0
    widths = {16: 8, 48: 16, 96: 32, 192: 64, 1024: 64, 3072: 64, 4096: 64}
    for mw, pw in widths.items():
        r = max(67, (1 << 20) // mw + 3)         # odd counts: ragged blocks
        for presorted_w in (0, pw):
            cols, vals = make_segments(r, mw, seed=mw + presorted_w,
                                       presorted_w=presorted_w)
            got = ss.segment_sort_dedup(cols, vals, rounds=2,
                                        presorted_w=presorted_w)
            torch.cuda.synchronize()
            want = ss.segment_sort_dedup_plain(cols, vals)
            err = compare(got, want, f"sort mw={mw} presorted={presorted_w}")
            worst["segment_sort_dedup"] = max(worst["segment_sort_dedup"],
                                              err)
            cases += 1
    for l in (2, 48, 1024, 4096, 262144):
        r = max(5, (1 << 21) // l + 1)
        cols, vals = make_segments(r, l, seed=l)
        keys, order = torch.sort(cols, dim=1, stable=True)
        vals = torch.gather(vals, 1, order)
        avals = torch.randn_like(vals)
        for fused in (False, True):
            if fused:
                args = (keys, vals.view(torch.int32), avals.view(torch.int32))
            else:
                args = (keys, vals)
            kv, kf, kc = ss.segment_dedup(*args)
            torch.cuda.synchronize()
            pv, pf, pc = ss.segment_dedup_plain(*args)
            err = compare((None, kv, kf), (None, pv, pf),
                          f"dedup l={l} fused={fused}")
            if int(kc) != int(pc):
                raise AssertionError(f"dedup l={l}: count {int(kc)} != "
                                     f"{int(pc)}")
            worst["segment_dedup"] = max(worst["segment_dedup"], err)
            cases += 1
    # one key across a whole 4096-slot row: the thread at the row's first
    # slot walks all of it.  Positive values, so the total cannot cancel.
    r, l = 512, 4096
    g = torch.Generator(device="cuda").manual_seed(l)
    vals = torch.rand((r, l), generator=g, device="cuda") + 0.5
    one_key = torch.arange(r, device="cuda", dtype=torch.int32)[:, None] \
        .expand(r, l).contiguous()
    got = ss.segment_sort_dedup(one_key, vals, rounds=1)
    torch.cuda.synchronize()
    want = ss.segment_sort_dedup_plain(one_key, vals)
    err_sort = compare(got, want, "sort, one 4096-slot run a row")
    kv, kf, kc = ss.segment_dedup(one_key, vals)
    torch.cuda.synchronize()
    pv, pf, pc = ss.segment_dedup_plain(one_key, vals)
    err_dedup = compare((None, kv, kf), (None, pv, pf),
                        "dedup, one 4096-slot run a row")
    if int(kc) != r or int(pc) != r:
        raise AssertionError(f"dedup long run: count {int(kc)}, plain "
                             f"{int(pc)}, expected {r}")
    cases += 2
    short_keys = torch.sort(make_segments(r, l, seed=1)[0], dim=1)[0]
    long_run = {
        "shape": [r, l],
        # totals are about 4096 here, so these errors are kept apart from
        # max_abs_err, which speaks of the shapes the path uses
        "max_abs_err": {"segment_sort_dedup": err_sort,
                        "segment_dedup": err_dedup},
        "dedup_ms_one_run_a_row": time_ms(
            lambda: ss.segment_dedup(one_key, vals)),
        "dedup_ms_runs_of_1_to_4": time_ms(
            lambda: ss.segment_dedup(short_keys, vals)),
        "sort_ms_one_run_a_row": time_ms(
            lambda: ss.segment_sort_dedup(one_key, vals, rounds=1)),
        "sort_ms_runs_of_1_to_4": time_ms(
            lambda: ss.segment_sort_dedup(short_keys, vals, rounds=1)),
    }
    emit("kernel_check", cases=cases, max_abs_err=worst,
         rtol=VAL_RTOL, atol=VAL_ATOL, long_run=long_run)
    return worst


# --------------------------------------------------------------------------
# end-to-end paths

def scipy_square(coo, with_abs=False):
    """scipy's A@A as canonical COO; with_abs also returns |A|@|A| in the
    same entry order (same structure: absolute values never cancel)."""
    s = coo.to_scipy().tocsr()
    want = (s @ s).tocoo()
    want.sum_duplicates()
    if not with_abs:
        return want
    order = np.lexsort((want.col, want.row))
    sa = abs(s)
    mag = (sa @ sa).tocoo()
    mag.sum_duplicates()
    mo = np.lexsort((mag.col, mag.row))
    if not (np.array_equal(mag.row[mo], want.row[order])
            and np.array_equal(mag.col[mo], want.col[order])):
        raise AssertionError("|A|@|A| and A@A differ in structure")
    return want, order, mag.data[mo]


def check_coo(rows, cols, vals, ref, what):
    """Exact structure, finite values within the float32 dot-product bound.
    Returns (entries outside rtol*|want|+atol, max error over the bound)."""
    want, order, mag = ref
    if len(rows) != want.nnz:
        raise AssertionError(f"{what}: C_nnz {len(rows)} != {want.nnz}")
    if not (np.array_equal(rows, want.row[order])
            and np.array_equal(cols, want.col[order])):
        raise AssertionError(f"{what}: sorted COO structure differs")
    if not np.all(np.isfinite(vals)):
        raise AssertionError(f"{what}: non-finite values")
    err = np.abs(vals - want.data[order])
    ratio = float((err / (COO_RTOL * mag + COO_ATOL)).max())
    if ratio > 1.0:
        raise AssertionError(f"{what}: values exceed the float32 "
                             f"dot-product bound by {ratio}x")
    cancelled = int((err > COO_RTOL * np.abs(want.data[order])
                     + COO_ATOL).sum())
    return cancelled, ratio


def record_times(rec):
    return {k: getattr(rec, k) for k in (
        "a_conversion_kernel_time", "b_conversion_kernel_time", "step1_time",
        "step2_time", "step3_time", "pem_spgemm_time", "steady_state_time",
        "pipelined_time", "gflops", "steady_gflops", "pipelined_gflops")}


def phase_default_path(coo_pl, want_pl):
    """run_benchmark with the default configuration on the three matrices;
    returns the dedup entry's launch count of the powerlaw-1M run."""
    cfg = SpGEMMConfig(engine="auto")
    ss.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rec, res = run_benchmark(coo_pl, "powerlaw-1M", cfg, verbose=False)
    launches = dict(ss.LAUNCHES)
    if res.engine != "element" or res.binned is None:
        raise AssertionError("powerlaw-1M did not take the binned engine")
    if launches["segment_dedup"] <= 0:
        raise AssertionError("default path launched no dedup kernel")
    if res.c_nnz != want_pl[0].nnz:
        raise AssertionError(f"powerlaw-1M C_nnz {res.c_nnz} != scipy "
                             f"{want_pl[0].nnz}")
    c = res.to_coo()
    cancelled, ratio = check_coo(c.rows, c.cols, c.vals, want_pl,
                                 "powerlaw-1M default")
    emit("default_path", matrix="powerlaw-1M", flop=rec.flop,
         c_nnz=res.c_nnz, scipy_c_nnz=int(want_pl[0].nnz), coo_equal=True,
         values_worst_over_bound=ratio, values_outside_plain_rtol=cancelled,
         launches=launches, times_ms=record_times(rec),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    del res, c

    for name in ("rmat-16", "uniform-1M"):
        coo = MATRICES[name]()
        want_nnz = int(scipy_square(coo).nnz)
        ss.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rec, res = run_benchmark(coo, name, cfg.with_(repeat=3),
                                 verbose=False)
        if res.c_nnz != want_nnz:
            raise AssertionError(f"{name} C_nnz {res.c_nnz} != scipy "
                                 f"{want_nnz}")
        emit("default_path", matrix=name, flop=rec.flop, c_nnz=res.c_nnz,
             scipy_c_nnz=want_nnz, jax_recorded_c_nnz=RECORDED_C_NNZ[name],
             launches=dict(ss.LAUNCHES), times_ms=record_times(rec),
             peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        del res
    return launches["segment_dedup"]


def phase_kernel_sort_path(coo_pl, want_pl):
    """powerlaw-1M through the chunk-granular plan and the sort+dedup
    entry; returns (launch count, the plan)."""
    a = coo_to_tiled(coo_pl)
    b = coo_to_tiled(coo_pl, with_tmasks=True)
    plan = binned.build_plan_device(a, b, pack=False)
    torch.cuda.synchronize()
    ss.reset_launch_counts()
    t0 = time.perf_counter()
    stream = binned.binned_multiply(plan, vmem_sort=True)
    c_nnz = int(stream.c_nnz)
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ss.LAUNCHES)
    stream.c_nnz = c_nnz
    if launches["segment_sort_dedup"] <= 0:
        raise AssertionError("chunk-granular path launched no sort kernel")
    rows, cols, vals = stream.to_coo_arrays()
    cancelled, ratio = check_coo(rows, cols, vals, want_pl,
                                 "powerlaw-1M chunk-granular")
    sort_b = [bk for bk in plan.buckets if not bk.single]
    emit("kernel_sort_path", matrix="powerlaw-1M", c_nnz=c_nnz,
         scipy_c_nnz=int(want_pl[0].nnz), coo_equal=True, launches=launches,
         values_worst_over_bound=ratio, values_outside_plain_rtol=cancelled,
         sort_buckets=[(bk.m * plan.w, int(bk.src.shape[0]))
                       for bk in sort_b], first_multiply_ms=ms)
    return launches["segment_sort_dedup"], plan, a, b


# --------------------------------------------------------------------------
# kernel timings at powerlaw-1M's largest bucket

def sort_network_ops(r, mw, presorted_w):
    """Compare-exchanges the bitonic network needs for these inputs (the
    merge stages only when presorted_w is given)."""
    p2 = 1 << max(1, (mw - 1).bit_length())
    stages = range((presorted_w.bit_length() if presorted_w else 1),
                   p2.bit_length())
    return r * (p2 // 2) * sum(stages)


def phase_kernels(plan_cg, a, b, launches, check_err):
    w = plan_cg.w
    # sort entry: the sort bucket with the most slots among those the
    # kernel takes, with the inputs the path gives it
    sort_b = [bk for bk in plan_cg.buckets
              if not bk.single and bk.m * w <= binned.VMEM_SORT_MAX]
    bk = max(sort_b, key=lambda x: x.src.numel())
    r, mw = int(bk.src.shape[0]), bk.m * w
    cols, vals = binned._expand_bucket(plan_cg.table, bk.src, bk.avals,
                                       bk.m, w)
    if bk.m > 1:
        odd = (torch.arange(bk.m, device="cuda") & 1).bool()[None, :, None]
        cols = torch.where(odd, cols.flip(2), cols)
        vals = torch.where(odd, vals.flip(2), vals)
    cols = cols.reshape(r, mw).contiguous()
    vals = vals.reshape(r, mw).contiguous()
    got = ss.segment_sort_dedup(cols, vals, rounds=bk.rounds or 1,
                                presorted_w=w)
    want = ss.segment_sort_dedup_plain(cols, vals)
    err_sort = compare(got, want, "sort entry at the largest bucket")
    slots = r * mw
    bytes_sort = slots * (8 + 9)
    ops_sort = sort_network_ops(r, mw, w) + slots
    bound_b, bound_o = bytes_sort / HBM_BYTES_PER_S, ops_sort / FP32_OPS_PER_S

    def library_sort():
        k, order = torch.sort(cols, dim=1, stable=True)
        return k, torch.gather(vals, 1, order)

    sort_row = {
        "name": "segment_sort_dedup", "route": "cuda", "source": SOURCE,
        "replaces": "pem_spgemm_tpu/ops/pallas_sort.py:38",
        "launches": launches["segment_sort_dedup"],
        "max_abs_err": max(err_sort, check_err["segment_sort_dedup"]),
        "ms": time_ms(lambda: ss.segment_sort_dedup(
            cols, vals, rounds=1, presorted_w=w)),
        "plain_ms": time_ms(lambda: ss.segment_sort_dedup_plain(cols, vals)),
        "bound_ms": max(bound_b, bound_o) * 1e3,
        "bound_by": "bytes" if bound_b >= bound_o else "operations",
        "library_ms": time_ms(library_sort),
        "library_covers": "torch.sort(stable) + gather: the sort half only",
        "shape": [r, mw], "presorted_w": w, "bytes": bytes_sort,
        "operations": ops_sort,
        # the chunk-granular phase runs exactly one multiply
        "launches_per_multiply": launches["segment_sort_dedup"],
    }
    del cols, vals, got, want

    # dedup entry: the packed class with the most slots of the default plan
    plan = binned.build_plan_device(a, b)
    torch.cuda.synchronize()
    ss.reset_launch_counts()
    int(binned.binned_multiply(plan).c_nnz)
    per_multiply = dict(ss.LAUNCHES)    # counted over this one multiply
    p = max(plan.packed, key=lambda x: x.keys.numel())
    got = ss.segment_dedup(p.keys, p.bbits, p.abits)
    want = ss.segment_dedup_plain(p.keys, p.bbits, p.abits)
    err_dedup = compare((None,) + tuple(got[:2]), (None,) + tuple(want[:2]),
                        "dedup entry at the largest class")
    if int(got[2]) != int(want[2]):
        raise AssertionError("dedup entry: counts differ")
    slots = p.keys.numel()
    bytes_dedup = slots * (12 + 5)
    ops_dedup = slots * 2               # one multiply, at most one add a slot
    bound_b = bytes_dedup / HBM_BYTES_PER_S
    bound_o = ops_dedup / FP32_OPS_PER_S
    dedup_row = {
        "name": "segment_dedup", "route": "cuda", "source": SOURCE,
        "replaces": "pem_spgemm_tpu/ops/pallas_sort.py:77",
        "launches": launches["segment_dedup"],
        "max_abs_err": max(err_dedup, check_err["segment_dedup"]),
        "ms": time_ms(lambda: ss.segment_dedup(p.keys, p.bbits, p.abits)),
        "plain_ms": time_ms(lambda: ss.segment_dedup_plain(
            p.keys, p.bbits, p.abits)),
        "bound_ms": max(bound_b, bound_o) * 1e3,
        "bound_by": "bytes" if bound_b >= bound_o else "operations",
        "library_ms": None,
        "shape": [int(p.keys.shape[0]), p.l], "fused_product": True,
        "bytes": bytes_dedup, "operations": ops_dedup,
        "launches_per_multiply": per_multiply["segment_dedup"],
        "packed_classes": len(plan.packed),
    }
    for row in (sort_row, dedup_row):
        row["kernel_ms"] = row["ms"]
    return [sort_row, dedup_row]


# --------------------------------------------------------------------------
# --profile: where one matrix's steady multiply spends its time

def stage_times(plan, kernel_sort, n):
    """Device time of each stream of the multiply, run alone."""
    w, table = plan.w, plan.table
    out = {}
    if plan.win is not None:
        out["window"] = (int(plan.win[0].numel()) * binned.WIN, time_ms(
            lambda: binned.singles_window_multiply(plan.wintab, *plan.win),
            n))
    if plan.coarse is not None:
        out["coarse"] = (int(plan.coarse[0].numel()) * w, time_ms(
            lambda: binned.coarse_flat_multiply(table, *plan.coarse, w), n))
    for fs in plan.fine:
        if fs.mode == "flat":
            slots = int(fs.refs.numel()) * fs.w
            fn = lambda fs=fs: binned.fine_flat_multiply(
                fs.table, fs.refs, fs.avals, fs.rows, fs.w)
        else:
            slots = int(fs.loc.numel()) * fs.w
            fn = lambda fs=fs: binned.fine_route_multiply(
                fs.table, fs.block_ids, fs.loc, fs.avals, fs.rows, fs.w)
        out[f"fine_{fs.mode}_w{fs.w}"] = (slots, time_ms(fn, n))
    if plan.packed:
        def packed():
            for p in plan.packed:
                binned.packed_multiply(p.keys, p.bbits, p.abits, p.seg_rows,
                                       p.rounds)
        out["packed_dedup"] = (sum(int(p.keys.numel()) for p in plan.packed),
                               time_ms(packed, n))
    sort_b = [b for b in plan.buckets if not b.single]
    if sort_b:
        def sort_buckets():
            for b in sort_b:
                if kernel_sort and b.m * w <= binned.VMEM_SORT_MAX:
                    binned.bucket_multiply_vmem(table, b.src, b.avals, b.m,
                                                w, b.rounds)
                else:
                    binned.bucket_multiply(table, b.src, b.avals, b.m, w,
                                           b.rounds)
        out["sort_buckets"] = (sum(int(b.src.numel()) * w for b in sort_b),
                               time_ms(sort_buckets, n))
    out["residual"] = (int(plan.res_src.numel()) * w, time_ms(
        lambda: binned.residual_multiply(table, plan.res_src, plan.res_avals,
                                         plan.res_rows, w), n))
    return {k: {"slots": s, "ms": ms} for k, (s, ms) in out.items()}


def run_profile(matrix, no_pack, n):
    """pack=True plan, or with no_pack the chunk-granular plan with the
    sort+dedup kernel route on."""
    coo = MATRICES[matrix]()
    a = coo_to_tiled(coo)
    b = coo_to_tiled(coo, with_tmasks=True)
    plan = binned.build_plan_device(a, b, pack=not no_pack)

    def multiply():
        return binned.binned_multiply(plan, vmem_sort=no_pack).c_nnz

    c_nnz = int(multiply())
    emit("profile_setup", matrix=matrix, pack=not no_pack, w=plan.w,
         n_products=plan.n_products, c_nnz=c_nnz,
         packed_classes=len(plan.packed),
         sort_buckets=len([x for x in plan.buckets if not x.single]),
         fine=[(f.mode, f.w) for f in plan.fine])
    emit("profile_stages", matrix=matrix,
         stages=stage_times(plan, no_pack, n))

    torch.cuda.reset_peak_memory_stats()
    ss.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        int(multiply())
    synced = (time.perf_counter() - t0) / n
    launches = {k: v / n for k, v in ss.LAUNCHES.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        last = multiply()
    int(last)
    queued = (time.perf_counter() - t0) / n
    emit("profile_steady", matrix=matrix, synced_ms=synced * 1e3,
         queued_ms=queued * 1e3, device_ms=time_ms(multiply, n),
         kernel_launches_per_multiply=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            last = multiply()
        int(last)
        wall = (time.perf_counter() - t0) / n
    # kernel entries only: an operator's entry repeats its kernels' time
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(t for _, _, t in rows)
    if busy_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    rows.sort(key=lambda x: -x[2])
    emit("profile_device", matrix=matrix, wall_ms=wall * 1e3,
         device_busy_ms=busy_us / 1e3 / n,
         idle_share=1.0 - busy_us / 1e6 / (wall * n),
         device_ops_per_multiply=sum(c for _, c, _ in rows) / n,
         top=[{"name": k[:80], "calls_per_multiply": c / n,
               "ms_per_multiply": t / 1e3 / n} for k, c, t in rows[:12]])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernel_check"], default=None,
                    help="build the kernel, check it, and stop")
    ap.add_argument("--profile", choices=sorted(MATRICES), default=None,
                    help="profile this matrix's steady multiply and stop")
    ap.add_argument("--no-pack", action="store_true",
                    help="with --profile: the chunk-granular plan "
                         "(pack=False) through the sort+dedup kernel")
    ap.add_argument("--iters", type=int, default=20,
                    help="with --profile: multiplies per measurement")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    build_s = ss.build_kernels(verbose=args.only is not None)
    emit("device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         kernel_build_s=build_s)

    if args.profile is not None:
        run_profile(args.profile, args.no_pack, args.iters)
        return 0

    check_err = phase_kernel_check()
    if args.only == "kernel_check":
        return 0

    coo_pl = MATRICES["powerlaw-1M"]()
    want_pl = scipy_square(coo_pl, with_abs=True)
    dedup_launches = phase_default_path(coo_pl, want_pl)
    sort_launches, plan_cg, a, b = phase_kernel_sort_path(coo_pl, want_pl)
    kernels = phase_kernels(
        plan_cg, a, b,
        {"segment_dedup": dedup_launches,
         "segment_sort_dedup": sort_launches}, check_err)
    for row in kernels:
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was never launched on "
                                 "the main path")
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
