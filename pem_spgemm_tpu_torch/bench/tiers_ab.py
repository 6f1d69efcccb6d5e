"""The harness's three tiers of two checkouts of the port, in turns.

    python -m pem_spgemm_tpu_torch.bench.tiers_ab --parent DIR [--change DIR]
        [--rounds 3] [--only NAME ...]

Runs ``bench.harness.run_benchmark`` on the DIA matrices (float32, and
pairbands-500k in float64) and the Macro128 ones of ``chip_smoke.py``, at
full size, in one child process a checkout (its own package, its own
kernel build): parent, change, change, parent, ``--rounds`` times, on one
card.  Each child process is one sample of each matrix's interactive,
steady and pipelined tier (host-clock ms, the mean of ``repeat``
multiplies).  Prints one JSON line a sample, then a summary line a matrix:
each checkout's samples, their median and spread (max - min), and whether
the change's median of each tier lies above the parent's by more than the
larger of the two spreads.  DIR is a checkout's root (for example
``git archive <commit> | tar -x -C DIR`` inside a git-ignored directory);
the change defaults to this package's checkout.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PAIRBANDS = (-1201, -1200, -601, -600, 0, 1, 600, 601, 1200, 1201)
# name: (generator, its arguments, engine, dtype, repeat), as chip_smoke.py
# runs them (phases dia_path, f64_path and macro_path)
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
    "banded64-1M macro": ("banded_device", dict(n=1_000_000, seed=1,
                                                bands=list(range(-32, 32))),
                          "macro", "float32", 3),
    "pairbands-500k macro": ("banded_device", dict(n=500_000, seed=9,
                                                   bands=PAIRBANDS),
                             "macro", "float32", 3),
}
TIERS = ("pem_spgemm_time", "steady_state_time", "pipelined_time")

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
for name, (gen, kw, engine, dtype, repeat) in cases.items():
    if "bands" in kw:
        kw = dict(kw, bands=tuple(kw["bands"]))
    coo = getattr(synthetic, gen)(**kw)
    cfg = SpGEMMConfig(engine=engine, dtype=getattr(torch, dtype),
                       repeat=repeat)
    rec, res = run_benchmark(coo, name, cfg, verbose=False)
    print(json.dumps({"tree": tag, "case": name, "c_nnz": rec.c_nnz,
                      "package": pem_spgemm_tpu_torch.__file__,
                      **{k: getattr(rec, k) for k in (
                          "pem_spgemm_time", "steady_state_time",
                          "pipelined_time", "step3_time")}}), flush=True)
    del rec, res, coo
    torch.cuda.empty_cache()
"""


def run_child(tag, tree, cases):
    env = dict(os.environ, PYTHONPATH=tree)
    p = subprocess.run([sys.executable, "-c", CHILD, tag, json.dumps(cases)],
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
        for tier in TIERS:
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
