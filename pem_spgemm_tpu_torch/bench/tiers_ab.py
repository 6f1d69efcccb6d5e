"""The harness's three tiers of two checkouts of the port, in turns.

    python -m pem_spgemm_tpu_torch.bench.tiers_ab --parent DIR [--change DIR]
        [--rounds 3] [--only NAME ...]

Runs ``bench.harness.run_benchmark`` on the DIA matrices (float32, and
pairbands-500k in float64), the Macro128 ones of ``chip_smoke.py`` and
pairbands-500k on the Tile16 engines (float32 at each precision, float64,
bfloat16), at full size, the Tile16 ring's world-size-1 plan of
pairbands-500k (``ring_plan_split``) and its numeric part at world size 1
and over the four ranks of a 4-rank plan replayed on the card
(``ring_numeric``), in one child process a checkout (its own package, its
own kernel build): parent,
change, change, parent, ``--rounds`` times, on one card.  Each child
process is one sample of each matrix's interactive, steady and pipelined
tier (host-clock ms, the mean of ``repeat`` multiplies) and step 1 / 2 /
3 ms (the harness's timers), or of the plan's parts.  Prints one JSON
line a sample, then a summary line a matrix: each checkout's samples,
their median and spread (max - min), and whether the change's median of
each tier lies above the parent's by more than the larger of the two
spreads.  DIR is a checkout's root (for example
``git archive <commit> | tar -x -C DIR`` inside a git-ignored directory);
the change defaults to this package's checkout.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PAIRBANDS = (-1201, -1200, -601, -600, 0, 1, 600, 601, 1200, 1201)
# name: (generator, its arguments, engine, dtype, repeat[, precision]), as
# chip_smoke.py runs them (phases dia_path, f64_path, macro_path,
# tile16_path, precision_path)
CASES = {
    "pairbands-500k": ("banded_device", dict(n=500_000, seed=9,
                                             bands=PAIRBANDS),
                       "auto", "float32", 5),
    "banded16-1M": ("banded_device", dict(n=1_000_000, seed=1,
                                          bands=list(range(-8, 8))),
                    "auto", "float32", 5),
    "banded64-1M": ("banded_device", dict(n=1_000_000, seed=1,
                                          bands=list(range(-32, 32))),
                    "auto", "float32", 5),
    "banded128-1M": ("banded_device", dict(n=1_000_000, seed=1,
                                           bands=list(range(-64, 64))),
                     "auto", "float32", 5),
    "pairbands-500k f64": ("banded_device", dict(n=500_000, seed=9,
                                                 bands=PAIRBANDS),
                           "auto", "float64", 2),
    "wandering64-1M macro": ("wandering_device", dict(n=999_936, seed=4),
                             "macro", "float32", 3),
    # the steady class path at the lower modes, and the float64 pair stream
    "wandering64-1M macro high": ("wandering_device", dict(n=999_936,
                                                           seed=4),
                                  "macro", "float32", 3, "high"),
    "wandering64-1M macro default": ("wandering_device", dict(n=999_936,
                                                              seed=4),
                                     "macro", "float32", 3, "default"),
    "wandering64-1M macro f64": ("wandering_device", dict(n=999_936, seed=4),
                                 "macro", "float64", 3),
    "banded64-1M macro": ("banded_device", dict(n=1_000_000, seed=1,
                                                bands=list(range(-32, 32))),
                          "macro", "float32", 3),
    "pairbands-500k macro": ("banded_device", dict(n=500_000, seed=9,
                                                   bands=PAIRBANDS),
                             "macro", "float32", 3),
    "pairbands-500k fused": ("banded_device", dict(n=500_000, seed=9,
                                                   bands=PAIRBANDS),
                             "fused", "float32", 5),
    "pairbands-500k masks": ("banded_device", dict(n=500_000, seed=9,
                                                   bands=PAIRBANDS),
                             "masks", "float32", 5),
    "pairbands-500k fused high": ("banded_device", dict(
        n=500_000, seed=9, bands=PAIRBANDS), "fused", "float32", 5, "high"),
    "pairbands-500k fused default": ("banded_device", dict(
        n=500_000, seed=9, bands=PAIRBANDS), "fused", "float32", 5,
        "default"),
    "pairbands-500k fused f64": ("banded_device", dict(
        n=500_000, seed=9, bands=PAIRBANDS), "fused", "float64", 3),
    "pairbands-500k fused bf16": ("banded_device", dict(
        n=500_000, seed=9, bands=PAIRBANDS), "fused", "bfloat16", 5),
    # the Tile16 ring's plan at world size 1: ring_plan_split, median of 5
    "pairbands-500k ring plan": ("banded_device", dict(n=500_000, seed=9,
                                                       bands=PAIRBANDS),
                                 "ring_plan", "float32", 5),
    # the Tile16 ring's numeric part (ring_numeric), median of 5: world
    # size 1, and the four ranks of a 4-rank plan
    "pairbands-500k ring": ("banded_device", dict(n=500_000, seed=9,
                                                  bands=PAIRBANDS),
                            "ring", "float32", 5),
    "pairbands-500k ring4": ("banded_device", dict(n=500_000, seed=9,
                                                   bands=PAIRBANDS),
                             "ring4", "float32", 5),
}
TIERS = ("pem_spgemm_time", "steady_state_time", "pipelined_time",
         "step1_time", "step2_time", "step3_time")
PLAN_PARTS = ("total", "pairs_and_schedule", "c_masks", "c_rowcol", "rest")
RING_PARTS = ("numeric_ms",)


def ring_plan_split(a, b, n):
    """The Tile16 ring's world-size-1 plan of A @ B
    (``parallel.sharded.plan_sharded_spgemm``), median of ``n`` after one
    warm-up, split by synchronised host clocks into the pair expansion and
    ring schedule (``expand_schedule``), ``cstruct.c_masks``,
    ``cstruct.c_rowcol`` and the rest, in ms; with the plan's C_nnz.  Only
    names every checkout since the Tile16 ring has (a child process runs
    this function's source in another checkout)."""
    import statistics
    import time
    import torch
    from pem_spgemm_tpu_torch.ops import cstruct
    from pem_spgemm_tpu_torch.parallel import sharded as sh
    spent = {}

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    saved = (sh.expand_schedule, cstruct.c_masks, cstruct.c_rowcol)
    sh.expand_schedule = timed("pairs_and_schedule", sh.expand_schedule)
    cstruct.c_masks = timed("c_masks", cstruct.c_masks)
    cstruct.c_rowcol = timed("c_rowcol", cstruct.c_rowcol)
    runs, c_nnz = [], set()
    try:
        for i in range(n + 1):
            spent.clear()
            c_nnz.add(timed("total", sh.plan_sharded_spgemm)(a, b, 1,
                                                             0).c_nnz)
            if i:                               # the first warms up
                ms = {k: v * 1e3 for k, v in spent.items()}
                ms["rest"] = ms["total"] - sum(
                    v for k, v in ms.items() if k != "total")
                runs.append(ms)
    finally:
        sh.expand_schedule, cstruct.c_masks, cstruct.c_rowcol = saved
    if len(c_nnz) != 1:
        raise AssertionError(f"ring plans of C_nnz {sorted(c_nnz)}")
    return {k: statistics.median(r[k] for r in runs)
            for k in runs[0]}, c_nnz.pop()

def ring_numeric(a, b, n_ranks, n):
    """ms of the Tile16 ring's numeric part (``parallel.sharded``'s
    ``replay_numeric``: each stage with pairs in the Tile16 kernel's fresh
    form, then its accumulate form into the same C, then the values at the
    structure) summed over the ranks of an ``n_ranks`` plan replayed on
    one card, median of ``n`` after one warm-up, by synchronised host
    clocks; with the plan's C_nnz."""
    import statistics
    import time
    import torch
    from pem_spgemm_tpu_torch.parallel import sharded as sh
    plans = [sh.plan_sharded_spgemm(a, b, n_ranks, d)
             for d in range(n_ranks)]
    runs = []
    for i in range(n + 1):
        total = 0.0
        for d in range(n_ranks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sh.replay_numeric(plans, d)
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
        if i:                                   # the first warms up
            runs.append(total * 1e3)
    return statistics.median(runs), plans[0].c_nnz


# One sample of each case in the checkout the process runs in (its root is
# the working directory and the first entry of sys.path).  Only calls that
# every checkout of the port since its DIA and Macro128 slices has.
CHILD = r"""
import json, sys
import torch
import pem_spgemm_tpu_torch
from pem_spgemm_tpu_torch.bench.harness import run_benchmark
from pem_spgemm_tpu_torch.config import SpGEMMConfig
from pem_spgemm_tpu_torch.models import synthetic
from pem_spgemm_tpu_torch.ops import _build
tag, cases = sys.argv[1], json.loads(sys.argv[2])
_build.build_kernels()
for name, (gen, kw, engine, dtype, repeat, *prec) in cases.items():
    if "bands" in kw:
        kw = dict(kw, bands=tuple(kw["bands"]))
    coo = getattr(synthetic, gen)(**kw)
    row = {"tree": tag, "case": name,
           "package": pem_spgemm_tpu_torch.__file__}
    if engine == "ring_plan":
        from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled
        a, b = coo_to_tiled(coo), coo_to_tiled(coo, with_tmasks=True)
        ms, row["c_nnz"] = ring_plan_split(a, b, repeat)
        row.update(ms)
        del a, b
    elif engine in ("ring", "ring4"):
        from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled
        a, b = coo_to_tiled(coo), coo_to_tiled(coo, with_tmasks=True)
        row["numeric_ms"], row["c_nnz"] = ring_numeric(
            a, b, 1 if engine == "ring" else 4, repeat)
        del a, b
    else:
        # bfloat16 tiles accumulate in float32 on the Tile16 tier
        acc = torch.float32 if dtype == "bfloat16" else None
        cfg = SpGEMMConfig(engine=engine, dtype=getattr(torch, dtype),
                           acc_dtype=acc, repeat=repeat,
                           **({"precision": prec[0]} if prec else {}))
        rec, res = run_benchmark(coo, name, cfg, verbose=False)
        row.update(c_nnz=rec.c_nnz, **{k: getattr(rec, k) for k in TIERS})
        del rec, res
    print(json.dumps(row), flush=True)
    del coo
    torch.cuda.empty_cache()
"""


def run_child(tag, tree, cases):
    env = dict(os.environ, PYTHONPATH=tree)
    code = (f"TIERS = {TIERS!r}\n" + inspect.getsource(ring_plan_split)
            + inspect.getsource(ring_numeric) + CHILD)
    p = subprocess.run([sys.executable, "-c", code, tag, json.dumps(cases)],
                       cwd=tree, env=env, capture_output=True, text=True,
                       timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"{tag} ({tree}) failed:\n{p.stderr[-4000:]}")
    out = [json.loads(ln) for ln in p.stdout.splitlines()
           if ln.startswith("{")]
    for row in out:
        if not row["package"].startswith(os.path.abspath(tree)):
            raise RuntimeError(f"{tag} imported {row['package']}")
        print(json.dumps(row), flush=True)
    return out


def summary(samples, names):
    for name in names:
        rows = {t: [s for s in samples if s["case"] == name and
                    s["tree"] == t] for t in ("parent", "change")}
        nnz = {s["c_nnz"] for t in rows for s in rows[t]}
        if len(nnz) != 1:
            raise AssertionError(f"{name}: C_nnz {sorted(nnz)}")
        line = {"summary": name, "c_nnz": nnz.pop()}
        engine = CASES[name][2]
        parts = {"ring_plan": PLAN_PARTS, "ring": RING_PARTS,
                 "ring4": RING_PARTS}.get(engine, TIERS)
        for tier in parts:
            got = {t: sorted(s[tier] for s in rows[t]) for t in rows}
            med = {t: statistics.median(v) for t, v in got.items()}
            spread = {t: v[-1] - v[0] for t, v in got.items()}
            line[tier] = {
                "samples": got, "median": med, "spread": spread,
                "change_minus_parent": med["change"] - med["parent"],
                "worse_beyond_spread": med["change"] - med["parent"]
                > max(spread.values())}
        print(json.dumps(line), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", default=ROOT)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", action="append", choices=sorted(CASES))
    args = ap.parse_args()
    names = args.only or list(CASES)
    cases = {k: CASES[k] for k in names}
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    samples = []
    for _ in range(args.rounds):
        for tag in ("parent", "change", "change", "parent"):
            samples += run_child(tag, trees[tag], cases)
    summary(samples, names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
