"""Where the dedup entry's time goes: builds without its count or its sums.

    python -m pem_spgemm_tpu_torch.bench.k1_split [--baseline FILE]

Builds csrc/segment_sort.cu three ways into the package's build directory,
each a copy of the source with one line of #define on top:
  whole     as it is;
  no_count  K1_SPLIT_NO_COUNT: the count of first-flags is not added up;
  no_runs   K1_SPLIT_NO_RUNS: no group sums, each slot writes its own value.
With --baseline FILE it also builds FILE as it is (another version of the
same source with the same C interface, for example the parent commit's),
so that two versions are timed in one process, on one card, on the same
inputs.

Times the dedup entry (segment_dedup_f32) of each build by CUDA events
over the inputs of every dedup launch of one steady multiply of rmat-16's
default plan (each packed class and the residual call, recorded as the path
makes them), over two (512, 4096) cases: one duplicate run a row, and
runs of 1-4, and at powerlaw-1M's largest packed class.  The sort entry
(segment_sort_dedup_f32) of the whole and the baseline build is timed at
powerlaw-1M's largest sort bucket of the chunk-granular plan and at the
one-run-a-row case.  Prints one JSON line a case.  The cut builds give
wrong results and are timed only; the whole build is held against the
plain version first.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from pem_spgemm_tpu_torch.models.synthetic import power_law, rmat
from pem_spgemm_tpu_torch.ops import _build, binned
from pem_spgemm_tpu_torch.ops import segment_sort as ss
from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
CUTS = {"whole": (), "no_count": ("K1_SPLIT_NO_COUNT",),
        "no_runs": ("K1_SPLIT_NO_RUNS",)}


def build(name: str, source: str = ss.SOURCE, defines=()):
    """The library of one build: ``source`` with ``defines`` set on top,
    compiled as build/<name>.cu (the defines are part of the hashed text,
    so an edited build is never a stale library)."""
    with open(source) as f:
        text = f.read()
    head = "".join(f"#define {d} 1\n" for d in defines)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, f"segment_sort_{name}.cu")
    with open(src, "w") as f:
        f.write(head + text)
    so = _build.compile_shared([_build.find_nvcc(), *_build.NVCC_FLAGS], src)
    return _build.load(so, ss._declare)


def time_ms(fn, n=20):
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


def record_dedup_calls(plan):
    """(keys, vals, abits) of every dedup launch of one multiply of a binned
    plan, in the order the path makes them (calls with no slots launch
    nothing and are left out)."""
    calls = []
    real = binned.segment_dedup

    def rec(keys, vals, abits=None, count=None):
        if keys.numel():
            calls.append((keys, vals, abits))
        return real(keys, vals, abits, count=count)

    binned.segment_dedup = rec
    try:
        int(binned.binned_multiply(plan).c_nnz)
    finally:
        binned.segment_dedup = real
    return calls


def dedup_bytes(keys, abits):
    """Bytes the dedup entry must move: each input once (keys and one or two
    value operands), the values and the flag bytes out once."""
    return keys.numel() * ((12 if abits is not None else 8) + 5)


def plan_of(coo, pack=True):
    a = coo_to_tiled(coo)
    b = coo_to_tiled(coo, with_tmasks=True)
    plan = binned.build_plan_device(a, b, pack=pack)
    torch.cuda.synchronize()
    return plan


def rmat16_dedup_calls():
    """The dedup inputs of one steady multiply of rmat-16's default plan."""
    return record_dedup_calls(plan_of(rmat(scale=16, edge_factor=8, seed=7)))


def largest_sort_bucket(plan):
    """(cols, vals, w) of the chunk-granular plan's sort bucket with the
    most slots among those the sort entry takes, as the path gives them to
    it: odd chunks lane-reversed (binned.bucket_multiply_vmem)."""
    w = plan.w
    sort_b = [bk for bk in plan.buckets
              if not bk.single and bk.m * w <= binned.VMEM_SORT_MAX]
    bk = max(sort_b, key=lambda x: x.src.numel())
    r, mw = int(bk.src.shape[0]), bk.m * w
    cols, vals = binned._expand_bucket(plan.table, bk.src, bk.avals, bk.m, w)
    if bk.m > 1:
        odd = (torch.arange(bk.m, device=cols.device) & 1).bool()
        odd = odd[None, :, None]
        cols = torch.where(odd, cols.flip(2), cols)
        vals = torch.where(odd, vals.flip(2), vals)
    return (cols.reshape(r, mw).contiguous(), vals.reshape(r, mw).contiguous(),
            w)


def long_run_inputs(r=512, l=4096):
    """(one_key, short_keys, vals): every row one duplicate run, or sorted
    runs of 1-4 (keys drawn from l/2), positive values."""
    g = torch.Generator(device="cuda").manual_seed(l)
    vals = torch.rand((r, l), generator=g, device="cuda") + 0.5
    one_key = torch.arange(r, device="cuda", dtype=torch.int32)[:, None] \
        .expand(r, l).contiguous()
    short = torch.randint(0, l // 2, (r, l), generator=g, device="cuda",
                          dtype=torch.int32)
    return one_key, torch.sort(short, dim=1)[0].contiguous(), vals


def dedup_launcher(lib, keys, vals, abits=None):
    """A closure that launches ``lib``'s dedup entry on these inputs into
    outputs allocated once, and the outputs (vals, first, count)."""
    out = torch.empty(keys.shape, dtype=torch.float32, device=keys.device)
    first = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    count = torch.zeros((), dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (keys.data_ptr(), vals.data_ptr(),
            abits.data_ptr() if abits is not None else None, out.data_ptr(),
            first.data_ptr(), count.data_ptr(), keys.shape[0], keys.shape[1],
            stream)

    def run():
        err = lib.segment_dedup_f32(*args)
        if err:
            raise RuntimeError(f"segment_dedup_f32 failed with error {err}")
    return run, (out, first, count)


def sort_launcher(lib, cols, vals, presorted_w=0):
    r, mw = cols.shape
    p2 = 1 << max(1, (mw - 1).bit_length())
    keys, out = torch.empty_like(cols), torch.empty_like(vals)
    first = torch.empty(cols.shape, dtype=torch.bool, device=cols.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (cols.data_ptr(), vals.data_ptr(), keys.data_ptr(), out.data_ptr(),
            first.data_ptr(), r, mw, p2, presorted_w, stream)

    def run():
        err = lib.segment_sort_dedup_f32(*args)
        if err:
            raise RuntimeError(f"segment_sort_dedup_f32 failed with error "
                               f"{err}")
    return run, (keys, out, first)


def hold_dedup(lib, keys, vals, abits, what):
    """The whole build's flags and count equal the plain version's, its
    group totals within the float32 bound of the group's sum of |v|."""
    run, (out, first, count) = dedup_launcher(lib, keys, vals, abits)
    count.zero_()
    run()
    torch.cuda.synchronize()
    want, wfirst, wcount = ss.segment_dedup_plain(keys, vals, abits)
    v = vals.view(torch.float32) * abits.view(torch.float32) \
        if abits is not None else vals
    mag, _, _ = ss.segment_dedup_plain(keys, v.abs())
    if not torch.equal(first, wfirst) or int(count) != int(wcount):
        raise AssertionError(f"{what}: flags or count differ from the "
                             "plain version")
    err = (out[wfirst] - want[wfirst]).abs()
    if bool((err > 1e-5 * mag[wfirst] + 1e-6).any()):
        raise AssertionError(f"{what}: group totals outside the bound")


def split_dedup(libs, calls, case):
    names = list(libs)
    for k, v, a in calls:
        hold_dedup(libs["whole"], k, v, a, case)
    per = {n: [] for n in names}
    for k, v, a in calls:
        for n in names:
            per[n].append(time_ms(dedup_launcher(libs[n], k, v, a)[0]))
    nbytes = sum(dedup_bytes(k, a) for k, _, a in calls)
    return {"case": case, "launches": len(calls),
            "slots": sum(k.numel() for k, _, _ in calls),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ms": {n: sum(per[n]) for n in names},
            "ms_per_launch": per if len(calls) > 1 else None}


def split_sort(libs, cols, vals, presorted_w, case):
    out = {"case": case, "shape": list(cols.shape),
           "presorted_w": presorted_w,
           "bound_ms": cols.numel() * (8 + 9) / HBM_BYTES_PER_S * 1e3}
    want = ss.segment_sort_dedup_plain(cols, vals)
    for n in ("whole", "baseline"):
        if n not in libs:
            continue
        run, got = sort_launcher(libs[n], cols, vals, presorted_w)
        run()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
            raise AssertionError(f"{case}: {n} build's keys or flags differ "
                                 "from the plain version")
        out[n + "_ms"] = time_ms(run)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", default=None,
                    help="another segment_sort.cu to build and time as it is")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_split: no CUDA device", file=sys.stderr)
        return 1
    libs = {name: build(name, defines=d) for name, d in CUTS.items()}
    if args.baseline:
        libs["baseline"] = build("baseline", args.baseline)
    calls = rmat16_dedup_calls()
    print(json.dumps(split_dedup(libs, calls, "rmat-16 dedup launches")),
          flush=True)
    del calls
    one_key, short_keys, vals = long_run_inputs()
    for keys, case in ((one_key, "one run a row (512, 4096)"),
                       (short_keys, "runs of 1-4 (512, 4096)")):
        print(json.dumps(split_dedup(libs, [(keys, vals, None)], case)),
              flush=True)
    print(json.dumps(split_sort(libs, one_key, vals, 0,
                                "sort, one run a row (512, 4096)")),
          flush=True)
    del one_key, short_keys, vals
    torch.cuda.empty_cache()
    coo = power_law(n=1_000_000, nnz=3_000_000, seed=42, hub_correlation=0.1)
    p = max(plan_of(coo).packed, key=lambda x: x.keys.numel())
    print(json.dumps(split_dedup(libs, [(p.keys, p.bbits, p.abits)],
                                 "powerlaw-1M largest packed class")),
          flush=True)
    del p
    plan = plan_of(coo, pack=False)
    cols, vals, w = largest_sort_bucket(plan)
    print(json.dumps(split_sort(libs, cols, vals, w,
                                "sort, powerlaw-1M largest bucket")),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
