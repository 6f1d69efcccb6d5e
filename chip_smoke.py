"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --only kernel_check
    python3 chip_smoke.py --only f64_path
    python3 chip_smoke.py --only dia_path
    python3 chip_smoke.py --only tile16_path
    python3 chip_smoke.py --only sharded
    python3 chip_smoke.py --only aat_path
    python3 chip_smoke.py --only suite
    python3 chip_smoke.py --only precision_path
    python3 chip_smoke.py --profile rmat-16 [--no-pack] [--iters 20] [--graph]
    python3 chip_smoke.py --profile banded64-1M
    python3 chip_smoke.py --profile wandering64-1M
    python3 chip_smoke.py --profile pairbands-500k --engine fused [--graph]

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, started together) and holds every entry against its plain
PyTorch version on the card.  Then it drives the three ported engines end to
end at full size through bench.harness.run_benchmark (engine="auto" for the
first two, engine="macro" for the third):

  * the binned element engine on powerlaw-1M, rmat-16 and uniform-1M, and
    powerlaw-1M again through the chunk-granular plan that reaches the
    sort+dedup entry; C is checked against scipy on the host.  Phase
    graph_replay holds the steady multiply's CUDA graph (the harness's
    steady and pipelined tiers replay it) to the eager multiply bit for bit
    on the three matrices, packed and (powerlaw-1M) with pack=False, also
    after the plan's values are changed in place between replays, and
    reports the launches a multiply recorded at capture;
  * the f64 parity mode (phase f64_path): powerlaw-1M through the merge
    element engine, pairbands-500k and banded64-1M through the DIA kernels'
    float64 entries, wandering64-1M through the pair-stream kernel's
    float64 entry (engine="macro"), each through run_benchmark at
    dtype=float64 with C_nnz as recorded and C against scipy's float64
    product within 1e-12 * sum|a*b| (every entry for the first two, 20,000
    sampled rows for the wide two);
  * the DIA engine on pairbands-500k, banded16-1M, banded64-1M and
    banded128-1M; C_nnz and flop are held against the values the JAX package
    recorded for the same generators, the sorted COO against scipy's for the
    first two, and the C band stack and counts against the plain PyTorch
    path on the card for the two wide stencils.  Phase dia_graph_replay
    holds a cached DIA plan's CUDA graph (the harness's steady and
    pipelined tiers replay it) to the eager values-only multiply bit for
    bit on pairbands-500k (float32 and float64), banded16-1M and
    banded128-1M, also after the bands' values are changed in place and
    after two runs on other band stacks (the first eager, the second
    captures again), and times both, and what a run on new band stacks
    costs beside one eager multiply;
  * the Macro128 engine on wandering64-1M (run-plan classes, the ragged class
    kernel), banded64-1M (stencil classes) and pairbands-500k (neither
    planner covers it: the pair-stream kernel); every interactive multiply
    goes through the pair-stream kernel (one launch, counted), each
    matrix's C_nnz is equal on the interactive and the steady path and its
    C tiles are held against the plain accumulation on the card; per-row
    nnz against scipy on 20,000 sampled rows of wandering64-1M, the
    recorded C_nnz for banded64-1M, scipy's sorted COO for pairbands-500k;
  * the Tile16 tier (phase tile16_path; its accumulation is the Tile16
    kernel, csrc/tile16_accumulate.cu, whose masks form also gives the
    fused engine's structure, and its structure the kernels of
    csrc/tile16_structure.cu: tile16_c_masks for the masks engine and the
    ring's planner, tile16_c_rowcol everywhere): pairbands-500k through
    engine="fused" and "masks" in float32, and "fused" in float64 and in
    bfloat16 with float32 accumulation, each with C_nnz as recorded, the
    sorted COO equal to scipy's, values within the dtype's bound, exactly
    the Tile16 kernels of the engine launched (and nothing else of this
    package), exactly three host syncs in an interactive multiply (torch's
    sync debug mode), and the steady plan's CUDA graph held to the eager
    step bit for bit, values too (the kernels add a tile's pairs in stream
    order, with no atomics), with its device time split by share, beside
    the DIA engine's steady time on the same matrix;
  * persistence (phase persist): pairbands-500k's Tile16 and DIA forms
    saved, loaded onto the card and multiplied, C_nnz as recorded;
  * bfloat16 on the element, DIA and Macro128 engines (phase bf16_path:
    float32 accumulation): powerlaw-1M (the merge engine), banded64-1M (K2
    on the bands' float32 copies) and wandering64-1M (K4, then K5 on the
    steady path) through run_benchmark, C_nnz equal to the float32 runs',
    values within the float32 bound against the bfloat16-rounded operands'
    product, plus half a bfloat16 ulp where C is rounded to bfloat16 (the
    Macro128 engine keeps C in float32, as the JAX package does; structure
    from |A|@|A|);
  * the multi-GPU layer (parallel/): phase sharded_path runs the four
    decompositions at world size 1 in an NCCL process group of this card
    (the c_nnz all_reduce and the gathers go through NCCL; no
    point-to-point op runs at one rank): the column-sharded element engine
    on powerlaw-1M (K1b), the DIA halo exchange on banded64-1M (K2), the
    Macro128 ring on wandering64-1M (one K4 a stage with pairs: a rank's
    first in K4's fresh form, the later ones in its accumulate form, which
    adds into the rank's C) and the Tile16 ring on pairbands-500k (one
    Tile16 kernel launch a stage with pairs, fresh then accumulating, in
    the same way; its plan's structure through tile16_c_masks and
    tile16_c_rowcol, the plan's time split into the pair expansion and
    schedule, those two and the rest); phase
    sharded_ranks replays a 4-rank plan of each on the card, rank by rank,
    each rank's B chunks and halos read from the plan (two NCCL ranks
    cannot share one card: the exchange is carried by the gloo tests), with
    each rank's time and the load balance; the Macro128 ring also in
    float64.  Each is held to scipy (sampled rows for wandering64-1M) or,
    for banded64-1M, to the plain path on the card; each rank's Macro128 C
    also to the composition of K4's fresh form with a torch add and OR,
    under == with flags bit for bit (timed beside it), with its time split
    into the K4 launches and local_macro_coo and the ring's peak memory;
    each Tile16 rank's values likewise to the kernel's fresh form plus a
    torch add, under ==, timed beside it;
  * A.A^T (phase aat_path, run_benchmark(aat=True), B = A^T != A): rmat-16
    and a rectangular 1,000,000 x 500,000 uniform matrix on the binned
    element engine (K1b), banded16-1M on K2, pairbands-500k on K3 and
    wandering64-1M on the Macro128 engine (K4, then the steady plan's
    entry), each with C_nnz and the sorted coordinates equal to the
    structure of |A|.|A|^T from scipy (20,000 sampled rows of
    wandering64-1M) and values within the float32 bound;
  * SpGEMMConfig.precision "high" and "default" beside "highest" (phase
    precision_path, run_benchmark at each, repeat 2): wandering64-1M as
    macro (K4 interactive, K5 steady), pairbands-500k as macro (K4) and
    through engine="fused" (the Tile16 kernel at the mode), and the macro
    ring as a 4-rank plan of wandering64-1M replayed on the card (K4 a
    stage at the precision, held like sharded_ranks' to the fresh-form
    composition); C_nnz and structure equal the "highest" run's, sorted
    COO scipy's |A|.|A| (20,000 sampled rows of wandering64-1M), values
    within (2u + u^2) sum|a*b| plus the float32 bound (u = 2^-11 for tf32,
    2^-8 for bfloat16);
  * the suite driver (phase suite): python -m
    pem_spgemm_tpu_torch.bench.suite, the counterpart of the JAX package's
    bench.py, cut to its first four rows (one matrix an engine tier), in a
    child process: its summary line has bench.py's keys, n_matrices 4 and
    no "partial", and every matrix's C_nnz is the one on record.

The Tile16 kernel's two entries are held on pairbands-500k's stream in
phase tile16_kernel_check (every form: values within the dtype's bound,
counts bit for bit, the masks form's masks and nnz scan those of the
counts and its values bit for bit the counts form's, two launches
bit-equal, the accumulate form into a C with -0.0, +-Inf and NaN in every
tile old + partial under == with the tiles without pairs bit for bit, and
at "high" / "default" equal to itself at "highest" on pre-rounded tables,
bfloat16 tables read as they lie bit-equal to their float32 copies),
and so are the two structure entries (tile16_c_masks: masks, nnz scan,
pair offsets and tile coordinates; tile16_c_rowcol: coordinates, tiles
and float32 / float64 values, padding slots included; bit for bit their
plain versions, also on engineered streams: tiles without pairs, of one
pair, of all 256 bits, padding at INT32_MAX and at c_cap, c_cap above the
tile count, c_nnz_cap above and below C_nnz; tile16_c_rowcol also on
engineered row masks: tiles of 0, 1, 2 and 256 bits, rows of 0, 1 and 16
bits, c_nnz_cap above, at and below C_nnz); their rows
(tile16_accumulate_pairs, _f64, _masks, _f64_masks, _acc, tile16_c_masks,
tile16_c_rowcol) are timed at that stream and at the 4-rank Tile16 ring's
largest accumulating stage, beside torch.bmm over the pre-gathered pairs
(the structure rows beside no library call, the value gather beside
``flat[pos]``); the accumulation's rows carry the operations bound at the
rate of the tensor cores that run their products (3xTF32, TF32, DMMA)
beside the FP32 one.
Beside each path it times every kernel entry at the largest shape its path
gives it, beside its bound (the Macro128 entries run on the tensor cores
with a 3xTF32 split: their rows carry the tensor-core bound too; the
pair-stream entry is timed at pairbands-500k's stream and at
wandering64-1M's; the three float32 Macro128 entries also at "high" and
"default", rows K4@high ... K6@default, bounded at one TF32 or bf16 pass;
K4's accumulate form at "highest", "high", "default" and in float64, rows
macro_accumulate_pairs_acc[@...] and macro_accumulate_pairs_f64_acc, on the
4-rank ring's largest accumulating stage, held against the plain
accumulate into a C with -0.0, +-Inf and NaN in every tile, the tiles
without pairs bit for bit, timed by CUDA-graph replay as the ring runs
them: the tables' masks made once a plan and the chunk's carried with it,
the walk over the stage's tiles with pairs (tiles_visited), at every
precision (at "highest" the list kernel, which runs only the slabs the
masks call non-zero); rows
macro_tile_masks and macro_tile_masks_f64 time the masks entries over a
plan's A slice and B chunk).  The kernel check also holds both masks
entries bit for bit to their plain version (tile_masks_plain) on tiles
with NaN, +-Inf, values of 2^63 and more, -0.0 and subnormals, every
accumulate form on a stream whose c_cap lies far above its tiles with
pairs and on a stage of a single pair, and a stage's CUDA-graph replay
bit for bit its eager launch (made under set_sync_debug_mode("error"));
sharded_ranks and precision_path hold every plan's carried masks to
masks made anew from its tables, count one masks launch a table a plan,
and report each rank's launches (rank_launches).
The kernel checks hold the Macro128 entries at each precision to the
plain version at it (and each entry at "high" / "default" to itself at
"highest" on tables rounded beforehand), with the plain version's NaN
positions and Inf signs on engineered tiles with Inf, NaN, near-FLT_MAX
values and subnormals that round to 0; phase macro_path runs each
matrix's steady plan at "high" and "default" too and holds its C tiles to
the plain pair accumulation at that mode, so every @precision row's
max_abs_err is also taken at the shapes it is timed at (the uniform class
entry, which no plan calls, is held bit-equal to the ragged one at each
mode on those classes).  Last, phase probe
checks and times the row-copy probe (the port of the JAX package's
scripts/pallas_probe3.py), which no path runs.

With --profile the script instead shows where one matrix's steady multiply
spends its time (with --engine fused, pairbands-500k's steady Tile16
multiply, with the eager step's device time split into the symbolic phase,
the accumulation's Tile16 kernel and the rest, and the structure
functions and kernel) (with --graph: the eager multiply and its CUDA graph
replay, in turns): the host-clock time per multiply (synchronising after each
one, and only once after a batch) with the kernel launches counted per
multiply, and a torch.profiler pass that gives device-busy time, the idle
share and the kernels that take most device time; for the element matrices
also each stream of the planned multiply timed alone with CUDA events.

A kernel's launches on a path are its wrapper's count plus the launches of
the CUDA-graph replays (ops.graphs.REPLAYED: a replay adds those its plan
recorded at capture).  Each kernel row of the last lines also counts its
launches on the later slices' paths (launches_by_path: bf16_path,
sharded_path, sharded_ranks, aat_path); the @precision rows count their
entry's launches over phase precision_path's runs at that precision.  Each phase prints one JSON line.
There is no CPU path: without a CUDA device the script fails.  It exits
non-zero on the first failed phase and prints the line {"ok": true, ...}
last only when every phase passed.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pem_spgemm_tpu_torch.bench import k1_split, k2_split, k4_split
from pem_spgemm_tpu_torch.bench import probe as pr
from pem_spgemm_tpu_torch.bench import suite, tiers_ab
from pem_spgemm_tpu_torch.bench.harness import run_benchmark
from pem_spgemm_tpu_torch.config import SpGEMMConfig, round_up_bucket
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.models.synthetic import (banded_device, power_law,
                                                   rmat, uniform_random,
                                                   wandering_device)
from pem_spgemm_tpu_torch.ops import _build, binned, cstruct, graphs, symbolic
from pem_spgemm_tpu_torch.ops import dia as D
from pem_spgemm_tpu_torch.ops import dia_kernels as dk
from pem_spgemm_tpu_torch.ops import macro as M
from pem_spgemm_tpu_torch.ops import macro_kernels as mk
from pem_spgemm_tpu_torch.ops import segment_sort as ss
from pem_spgemm_tpu_torch.ops import stencil as st
from pem_spgemm_tpu_torch.ops import tile16_kernels as tk
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, coo_to_tiled
from pem_spgemm_tpu_torch.ops.fixed import (MacroPlan, StencilMacroPlan,
                                            make_plan)
from pem_spgemm_tpu_torch.ops.spgemm import SpGEMM
from pem_spgemm_tpu_torch.parallel import sharded_macro as sm

SENT = ss.SENTINEL
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM data sheet, outside tensor cores
TF32_OPS_PER_S = 495e12         # H100 SXM data sheet, tensor cores, dense
BF16_OPS_PER_S = 989e12         # H100 SXM data sheet, tensor cores, dense
FP64_OPS_PER_S = 67e12          # H100 SXM data sheet, FP64 on the tensor
                                # cores (DMMA): the card's peak for float64
FP64_INSTR_PER_S = 17e12        # H100 SXM data sheet, FP64 units outside
                                # the tensor cores: 34 TFLOP/s of FMA, so
                                # 17 T instructions/s (DMUL or DADD alike)
VAL_RTOL, VAL_ATOL = 1e-4, 1e-6     # kernel vs plain: summation order differs
# C values vs scipy's float64 product: |got - want| <= COO_RTOL * S + COO_ATOL
# with S the sum of |a*b| over the entry's products (the forward-error bound
# of a float32 dot product).  At full size some entries cancel (|want| << S),
# so a tolerance relative to |want|, as the small CPU tests use, cannot hold
# for them in float32; the script counts those entries and prints the count.
COO_RTOL, COO_ATOL = 1e-5, 1e-6
# The same bound for float64 (the f64 parity mode): 1e-12 * sum|a*b|; the
# atol only keeps 0/0 out where an entry has no product.
F64_RTOL, F64_ATOL = 1e-12, 1e-300
SOURCE = "pem_spgemm_tpu_torch/csrc/segment_sort.cu"
DIA_SOURCE = "pem_spgemm_tpu_torch/csrc/dia_multiply.cu"
MACRO_SOURCE = "pem_spgemm_tpu_torch/csrc/macro_accumulate.cu"
DEV = "cuda"            # where the DIA checks make their inputs

# C_nnz the JAX package recorded for the same generators (BENCH_r05.json)
RECORDED_C_NNZ = {"rmat-16": 66_875_950, "uniform-1M": 16_004_570}

MATRICES = {
    "powerlaw-1M": lambda: power_law(n=1_000_000, nnz=3_000_000, seed=42,
                                     hub_correlation=0.1),
    "rmat-16": lambda: rmat(scale=16, edge_factor=8, seed=7),
    "uniform-1M": lambda: uniform_random(1_000_000, 1_000_000, 4_000_000,
                                         seed=3),
}


# The DIA matrices of the JAX package's suite (generators and arguments of its
# bench.py), with the C_nnz and flop that package recorded for them.  Both are
# facts of the structure, which banded_device reproduces; they do not depend
# on the values.
PAIRBANDS = (0, 1, 600, 601, -600, -601, 1200, 1201, -1200, -1201)
PAIRBANDS_SORTED = tuple(sorted(PAIRBANDS))
DIA_MATRICES = {
    "pairbands-500k": dict(n=500_000, seed=9, bands=PAIRBANDS),
    "banded16-1M": dict(n=1_000_000, seed=1, bands=tuple(range(-8, 8))),
    "banded64-1M": dict(n=1_000_000, seed=1, bands=tuple(range(-32, 32))),
    "banded128-1M": dict(n=1_000_000, seed=1, bands=tuple(range(-64, 64))),
}
DIA_RECORDED = {        # name: (C_nnz, flop, kernel entry)
    "pairbands-500k": (14_962_177, 49_879_920, "pairs"),
    "banded16-1M": (30_999_759, 255_998_288, "dense"),
    "banded64-1M": (126_995_967, 4_095_890_752, "dense"),
    "banded128-1M": (254_983_743, 16_383_126_144, "dense"),
}
# scipy's product and a host sort of C are affordable up to here; the two
# wide stencils (4.1 G and 16.4 G products, 127 M and 255 M entries of C)
# would take most of the script's time limit on the host alone, so their C
# is held against the plain PyTorch path on the card instead.
DIA_SCIPY = ("pairbands-500k", "banded16-1M")


# The Macro128 matrices: wandering64-1M as the JAX package's bench.py generates
# it (engine="macro" there too), and two DIA matrices forced onto the macro
# engine because they reach the other plans: banded64-1M the periodic stencil
# classes, pairbands-500k (which neither planner covers) the pair stream.
MACRO_MATRICES = {
    "wandering64-1M": lambda: wandering_device(n=999_936, seed=4),
    "banded64-1M": lambda: banded_device(**DIA_MATRICES["banded64-1M"]),
    "pairbands-500k": lambda: banded_device(**DIA_MATRICES["pairbands-500k"]),
}
MACRO_EXPECT = {        # name: (plan type, planner, entry on the steady path)
    "wandering64-1M": (StencilMacroPlan, "plan_runs", "macro_class_ragged"),
    "banded64-1M": (StencilMacroPlan, "plan_stencil", "macro_class_ragged"),
    "pairbands-500k": (MacroPlan, None, "macro_accumulate_pairs"),
}
MACRO_SAMPLE_ROWS = 20_000
TILE_FLOP = 2 * 128 ** 3        # operations of one 128x128x128 product


def reset_launch_counts():
    ss.reset_launch_counts()
    dk.reset_launch_counts()
    mk.reset_launch_counts()
    tk.reset_launch_counts()
    pr.reset_launch_counts()
    graphs.reset_replayed()


# the row-copy probe's launches, summed over every path run (no path calls
# it: its row reports what was counted all the same)
PATH_LAUNCHES = {"row_copy": 0}


def path_launches(counts):
    """An engine's kernel launches in a path run, read just after it: each
    entry's wrapper count plus the launches its CUDA-graph replays made
    (a replay passes no wrapper: ops.graphs.REPLAYED adds, once a replay,
    the launches the plan recorded at capture).  The probe's count of the
    same run is added to PATH_LAUNCHES."""
    PATH_LAUNCHES["row_copy"] += pr.LAUNCHES["row_copy"]
    return {k: v + graphs.REPLAYED.get(k, 0) for k, v in counts.items()}


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


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


def graph_ms(fn, n=20, replays=3):
    """Device ms per call with no host time in it: n calls captured in one
    CUDA graph, the graph replayed and timed by CUDA events.  For entries
    whose launches are shorter than their wrapper's host work (time_ms
    then measures the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                            # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (n * replays)


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


def bound_ratio(got_v, want_v, first, mag, what):
    """Worst |got - want| / (COO_RTOL * sum|v| + COO_ATOL) over first slots,
    sum|v| being the group's sum of magnitudes: the float32 bound the path
    phases hold C to.  Raises above 1."""
    if not bool(first.any()):
        return 0.0
    err = (got_v[first] - want_v[first]).abs()
    ratio = float((err / (COO_RTOL * mag[first] + COO_ATOL)).max())
    if ratio > 1.0:
        raise AssertionError(f"{what}: group totals exceed the float32 "
                             f"bound by {ratio}x")
    return ratio


def hold_dedup(keys, vals, abits, what, relative=True):
    """The dedup entry against its plain version: flags and count exact,
    totals within the float32 bound and, with ``relative``, within
    VAL_RTOL of the plain totals as well.  A path's own inputs are held to
    the bound alone: there groups of products cancel (as C's entries do at
    full size), and a tolerance relative to a cancelled total cannot hold
    in float32.  Returns (max abs error, worst error over the bound)."""
    kv, kf, kc = ss.segment_dedup(keys, vals, abits)
    torch.cuda.synchronize()
    pv, pf, pc = ss.segment_dedup_plain(keys, vals, abits)
    if relative:
        err = compare((None, kv, kf), (None, pv, pf), what)
    elif not torch.equal(kf, pf):
        raise AssertionError(f"{what}: first-flags differ")
    else:
        err = float((kv[pf] - pv[pf]).abs().max()) if bool(pf.any()) else 0.0
    if int(kc) != int(pc):
        raise AssertionError(f"{what}: count {int(kc)} != {int(pc)}")
    v = (vals.view(torch.float32) * abits.view(torch.float32)
         if abits is not None else vals)
    mag = ss.segment_dedup_plain(keys, v.abs())[0]
    return err, bound_ratio(kv, pv, pf, mag, what)


def sorted_rows(r, l, seed, key_space=None, tails=True):
    """Rows sorted by key on the card: duplicate runs of 1-4 (keys drawn
    from key_space, l/2 by default), sentinel tails of random length;
    values standard normal."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    keys = torch.randint(0, key_space or max(4, l // 2), (r, l),
                         generator=g, device="cuda", dtype=torch.int32)
    if tails:
        live = torch.randint(0, l + 1, (r, 1), generator=g, device="cuda")
        keys[torch.arange(l, device="cuda")[None, :] >= live] = SENT
    vals = torch.randn((r, l), generator=g, device="cuda")
    return torch.sort(keys, dim=1)[0].contiguous(), vals


def engineered_dedup_cases():
    """(name, keys, vals, abits) at the kernel's edges: runs across and
    longer than its tiles of ss.DEDUP_TILE slots, widths that are not a
    multiple of 4, the residual's single row, sentinel rows, signed zeros
    and subnormals in the fused product, the widest packed class, and
    pointers that are not 16-byte aligned."""
    tile = ss.DEDUP_TILE
    keys, vals = sorted_rows(64, 2 * tile, seed=21, tails=False)
    keys[:, tile - 5:tile + 7] = keys[:, tile - 5:tile - 4]
    yield ("run across a tile boundary", torch.sort(keys, 1)[0].contiguous(),
           vals, None)
    keys, vals = sorted_rows(16, 8 * tile, seed=22, key_space=8 * tile,
                             tails=False)
    lo = tile // 2
    keys[:, lo:lo + 2 * tile + 300] = keys[:, lo:lo + 1]
    yield ("run longer than two tiles", torch.sort(keys, 1)[0].contiguous(),
           vals.abs() + 0.5, None)
    yield ("l = 2", *sorted_rows(1_000_003, 2, seed=23, key_space=2), None)
    yield ("l = 6", *sorted_rows(333_335, 6, seed=24, key_space=4), None)
    keys, vals = sorted_rows(1, 3_000_017, seed=25, key_space=1_000_000)
    keys[0, 1000:1000 + 3 * tile] = keys[0, 1000]
    yield ("residual: one row, l >> tile",
           torch.sort(keys, 1)[0].contiguous(), vals, None)
    keys, vals = sorted_rows(4096, 96, seed=26)
    keys[::3] = SENT
    yield "all-sentinel rows", keys, vals, None
    keys, bv = sorted_rows(8192, 48, seed=27, key_space=12)
    av = torch.randn_like(bv)
    bv[::2, ::5] = -0.0
    bv[1::2, ::7] = 1e-40               # subnormal operand
    av[::3, 1::4] = 1e-20
    bv[::3, 1::4] = 1e-20               # subnormal product
    yield ("fused: -0.0 and subnormals", keys, bv.view(torch.int32),
           av.view(torch.int32))
    l = binned.PACK_CLASSES[-1]
    keys, bv = sorted_rows(9, l, seed=28)
    yield ("fused, widest packed class", keys, bv.view(torch.int32),
           torch.randn_like(bv).view(torch.int32))
    keys, vals = sorted_rows(1, 300_001, seed=29)
    flat_k = torch.cat([keys.new_zeros(1), keys.reshape(-1)])
    flat_v = torch.cat([vals.new_zeros(1), vals.reshape(-1)])
    yield ("offset by one slot (scalar loads)", flat_k[1:].view(1, -1),
           flat_v[1:].view(1, -1), None)


def phase_kernel_check():
    worst = {"segment_sort_dedup": 0.0, "segment_dedup": 0.0}
    over = {"segment_sort_dedup": 0.0, "segment_dedup": 0.0}
    cases = 0
    widths = {16: 8, 48: 16, 96: 32, 192: 64, 1024: 64, 1536: 64, 3072: 64,
              4096: 64, 24: 8, 6: 2}
    for mw, pw in widths.items():
        r = max(67, (1 << 20) // mw + 3)         # odd counts: ragged blocks
        for presorted_w in (0, pw):
            cols, vals = make_segments(r, mw, seed=mw + presorted_w,
                                       presorted_w=presorted_w)
            got = ss.segment_sort_dedup(cols, vals, rounds=2,
                                        presorted_w=presorted_w)
            torch.cuda.synchronize()
            want = ss.segment_sort_dedup_plain(cols, vals)
            what = f"sort mw={mw} presorted={presorted_w}"
            err = compare(got, want, what)
            mag = ss.segment_sort_dedup_plain(cols, vals.abs())[1]
            over["segment_sort_dedup"] = max(
                over["segment_sort_dedup"],
                bound_ratio(got[1], want[1], want[2], mag, what))
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
                args = (keys, vals, None)
            err, ratio = hold_dedup(*args, f"dedup l={l} fused={fused}")
            worst["segment_dedup"] = max(worst["segment_dedup"], err)
            over["segment_dedup"] = max(over["segment_dedup"], ratio)
            cases += 1
    engineered = {}
    for name, keys, vals, abits in engineered_dedup_cases():
        err, ratio = hold_dedup(keys, vals, abits, f"dedup, {name}")
        engineered[name] = {"shape": list(keys.shape),
                            "max_abs_err": err, "worst_over_bound": ratio}
        over["segment_dedup"] = max(over["segment_dedup"], ratio)
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
        # device time (CUDA-graph replay): the wrapper's host work is
        # longer than these launches
        "dedup_ms_one_run_a_row": graph_ms(
            lambda: ss.segment_dedup(one_key, vals)),
        "dedup_ms_runs_of_1_to_4": graph_ms(
            lambda: ss.segment_dedup(short_keys, vals)),
        "sort_ms_one_run_a_row": graph_ms(
            lambda: ss.segment_sort_dedup(one_key, vals, rounds=1)),
        "sort_ms_runs_of_1_to_4": graph_ms(
            lambda: ss.segment_sort_dedup(short_keys, vals, rounds=1)),
    }
    emit("kernel_check", cases=cases, max_abs_err=worst,
         worst_over_bound=over, engineered_dedup=engineered,
         rtol=VAL_RTOL, atol=VAL_ATOL, long_run=long_run)
    return worst


# --------------------------------------------------------------------------
# DIA kernels against their plain version

def make_bands(offs, n_rows, n_cols, seed, zero_frac=0.2):
    """(len(offs), n_rows) float32 row-aligned band stack on the card:
    standard normals with interior zeros, zero outside each band's valid
    range (the tails a converted matrix has)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((len(offs), n_rows), generator=g, device=DEV)
    x[torch.rand(x.shape, generator=g, device=DEV) < zero_frac] = 0.0
    col = (torch.arange(n_rows, device=DEV)[None, :]
           + torch.tensor(offs, device=DEV)[:, None])
    x[(col < 0) | (col >= n_cols)] = 0.0
    return x.contiguous()


def dia_bound(a, b, offs_a, idx_map, dcn, n_out):
    """COO_RTOL * sum|a*b| + COO_ATOL for every C element: the forward
    error bound of a float32 dot product, from the plain path run on the
    absolute values."""
    mag, _ = D._dia_multiply_torch(a.abs(), b.abs(), offs_a=offs_a,
                                   idx_map=idx_map, dc_count=dcn,
                                   n_out=n_out, values_only=True)
    return COO_RTOL * mag + COO_ATOL


# worst |err| / bound of each kernel entry over its kernel-check cases
WORST_OVER = {}


def note_over(key, over):
    if key is not None:
        WORST_OVER[key] = max(WORST_OVER.get(key, 0.0), over)


def dia_hold(got, want, bound, what, key=None, label="float32"):
    """Counts exactly equal (so cnt > 0 is too), values inside the bound.
    Returns the max abs error of the values; ``key`` names the entry whose
    worst ratio to the bound is kept in WORST_OVER."""
    (gc, gn), (wc, wn) = got, want
    if (gn is None) != (wn is None):
        raise AssertionError(f"{what}: one side returned no counts")
    if gn is not None and not torch.equal(gn, wn):
        raise AssertionError(f"{what}: structural counts differ")
    err = (gc - wc).abs()
    if not bool(torch.isfinite(gc).all()):
        raise AssertionError(f"{what}: non-finite values")
    over = float((err / bound).max())
    if not over <= 1.0:
        raise AssertionError(f"{what}: values exceed the {label} "
                             f"dot-product bound by {over}x")
    note_over(key, over)
    return float(err.max())


# per float64 entry: did every kernel-check case give the plain version's
# values bit for bit (each product and sum rounded as the plain version
# rounds them)?
F64_BIT_EQUAL = {}


def dia_case_f64(a, b, offs_a, offs_b, modes, what, tables, kw, outs32):
    """The float64 entries on the same bands cast to float64: against the
    plain version within the float64 bound, counts equal to the plain
    version's and to the float32 entry's (``outs32``).  Returns
    {entry: max abs err}."""
    a, b = a.double(), b.double()
    dc_list = tuple(kw["dc_list"])
    pk = dict(offs_a=offs_a, idx_map=kw["idx_map"], dc_count=len(dc_list),
              n_out=kw["n_out"])
    mag, _ = D._dia_multiply_torch(a.abs(), b.abs(), values_only=True, **pk)
    bound = F64_RTOL * mag + F64_ATOL
    errs = {}
    for values_only in (False, True):
        want = D._dia_multiply_torch(a, b, values_only=values_only, **pk)
        for mode in modes:
            got = dk.dia_multiply(a, b, offs_a=offs_a, offs_b=offs_b,
                                  dc_list=dc_list, n_out=kw["n_out"],
                                  mode=mode, values_only=values_only,
                                  tables=tables[mode])
            torch.cuda.synchronize()
            entry = f"dia_multiply_{mode}_f64"
            if got[0].dtype != torch.float64:
                raise AssertionError(f"{what}: {entry} gave {got[0].dtype}")
            e = dia_hold(got, want, bound,
                         f"{what} {entry} values_only={values_only}",
                         key=entry, label="float64")
            if not values_only and not torch.equal(
                    got[1], outs32[mode, False][1]):
                raise AssertionError(f"{what}: {entry}'s counts differ from "
                                     "the float32 entry's")
            F64_BIT_EQUAL[entry] = F64_BIT_EQUAL.get(entry, True) and \
                torch.equal(got[0], want[0])
            errs[entry] = max(errs.get(entry, 0.0), e)
    return errs


def dia_case(a, b, offs_a, offs_b, modes, what):
    """Every mode in ``modes``, with and without counts, against the plain
    version; where both modes run they must agree bit for bit (same order
    of additions).  Then the float64 entries on the same bands
    (dia_case_f64).  Returns {entry: max abs err}."""
    dc_list, idx_map = D._plan_maps(offs_a, offs_b)
    n_out = a.shape[1]
    kw = dict(offs_a=offs_a, idx_map=idx_map, dc_count=len(dc_list),
              n_out=n_out)
    bound = dia_bound(a, b, offs_a, idx_map, len(dc_list), n_out)
    tables = {mode: dk.dia_tables(offs_a, offs_b, dc_list, mode, a.device)
              for mode in modes}
    errs, outs = {}, {}
    for values_only in (False, True):
        want = D._dia_multiply_torch(a, b, values_only=values_only, **kw)
        for mode in modes:
            got = dk.dia_multiply(a, b, offs_a=offs_a, offs_b=offs_b,
                                  dc_list=dc_list, n_out=n_out, mode=mode,
                                  values_only=values_only,
                                  tables=tables[mode])
            torch.cuda.synchronize()
            e = dia_hold(got, want, bound,
                         f"{what} mode={mode} values_only={values_only}",
                         key=f"dia_multiply_{mode}")
            entry = f"dia_multiply_{mode}"
            errs[entry] = max(errs.get(entry, 0.0), e)
            outs[mode, values_only] = got
        if len(modes) == 2 and not torch.equal(
                outs["dense", values_only][0], outs["pairs", values_only][0]):
            raise AssertionError(f"{what}: the two entries disagree")
    errs.update(dia_case_f64(a, b, offs_a, offs_b, modes, what, tables,
                             dict(dc_list=dc_list, idx_map=idx_map,
                                  n_out=n_out), outs))
    return errs


def pairs_interior(offs_a, n, word):
    """Which blocks of the pairs entry at ``word``-byte words run with no
    bounds test (the .cu's `interior`), for A*A on n x n operands."""
    L = dk.pairs_launch(len(offs_a), 1, 1, n, word)["L"]
    return [i0 + L <= n and i0 + offs_a[0] >= 0 and i0 + L - 1 + offs_a[-1] < n
            for i0 in range(0, n, L)]


def phase_dia_kernel_check():
    worst = {k: 0.0 for k in dk.LAUNCHES}
    cases = 0

    def run(offs_a, offs_b, n_i, n_k, n_cols_b, modes, what, seed):
        nonlocal cases
        a = make_bands(offs_a, n_i, n_k, seed)
        b = make_bands(offs_b, n_k, n_cols_b, seed + 1)
        for entry, e in dia_case(a, b, offs_a, offs_b, modes,
                                 what).items():
            worst[entry] = max(worst[entry], e)
        cases += 4 * len(modes)

    both = ("dense", "pairs")
    # stencils of every width the path uses and below; n is no multiple of
    # the kernels' 256-column blocks nor of anything else
    for d in (1, 3, 9, 16, 64, 128):
        offs = tuple(range(-(d // 2), d - d // 2))
        n = 10_007
        run(offs, offs, n, n, n, both if d <= 16 else ("dense",),
            f"stencil D={d}", seed=d)
    # the dense entry's last column block holds one column: n = 1 mod L
    # (dk.dense_launch: 64 columns a range at 128 bands, 256 at 16)
    for d, n in ((128, 6_401), (16, 6_145)):
        offs = tuple(range(-(d // 2), d - d // 2))
        if n % dk.dense_launch(offs, d, 2 * d - 1)["L"] != 1:
            raise AssertionError(f"D={d}: n={n} leaves no 1-column block")
        run(offs, offs, n, n, n, both if d <= 16 else ("dense",),
            f"stencil D={d}, 1-column last block", seed=d + 1)
    # n a multiple of 4 with a ragged last block (4 of its 256 columns): the
    # dense entry's 16-byte stores end exactly at the last column
    offs16 = tuple(range(-8, 8))
    run(offs16, offs16, 6_148, 6_148, 6_148, both, "stencil D=16, n=6148", 17)
    # gapped A offsets in the dense mode: chunks of one and of three bands,
    # reloads at the gaps, a window wider than L + the chunk's band count
    run((0, 3, 40, 41, 42), tuple(range(-20, 20)), 3_001, 3_001, 3_001, both,
        "gapped dense", 55)
    # gapped A offsets again, with runs longer than the float64 entry's 4-row
    # groups between the gaps (a group ends at a gap, mid-run or whole)
    run((0, 1, 2, 5, 9, 10, 11, 12, 13, 14, 20, 23), tuple(range(-12, 12)),
        9_001, 9_001, 9_001, both, "gapped dense, long runs", 57)
    # banded128-1M's offsets: the float64 window holds fewer bands a chunk
    # (a smaller kc, more chunks) than the float32 one
    offs128 = tuple(range(-64, 64))
    kc = {w: dk.dense_launch(offs128, 128, 255, w)["kc"] for w in (4, 8)}
    if not kc[8] < kc[4]:
        raise AssertionError(f"banded128 offsets: kc {kc}")
    run(offs128, offs128, 40_009, 40_009, 40_009, ("dense",),
        f"banded128 offsets, kc {kc[4]} / {kc[8]}", 58)
    # 1,000 B bands: the dense entry's ring holds a row group of the C rows
    # (4 groups in float32, 8 in float64), each staging the B rows it
    # reaches
    wide_b = tuple(range(-500, 500))
    if not all(dk.dense_launch((0, 1, 2), 1000, 1002, w)["grid_y"] > 1
               for w in (4, 8)):
        raise AssertionError("1,000 B bands: expected row groups")
    run((0, 1, 2), wide_b, 20_011, 20_011, 20_011, ("dense",),
        "dense row groups, 1,000 B bands", 59)
    # NaN words count as non-zero (x != 0): every entry's counts, both
    # words, exactly the plain version's, with NaNs in A and in B
    nan_offs = tuple(range(-8, 8))
    for dt in (torch.float32, torch.float64):
        an = make_bands(nan_offs, 4_099, 4_099, 61).to(dt)
        bn = make_bands(nan_offs, 4_099, 4_099, 62).to(dt)
        an[3, 100:140] = float("nan")
        bn[:, 2_000:2_003] = float("nan")
        dc_n, idx_n = D._plan_maps(nan_offs, nan_offs)
        want_n = D._dia_multiply_torch(an, bn, offs_a=nan_offs,
                                       idx_map=idx_n, dc_count=len(dc_n),
                                       n_out=4_099)[1]
        for mode in both:
            got_n = dk.dia_multiply(
                an, bn, offs_a=nan_offs, offs_b=nan_offs, dc_list=dc_n,
                n_out=4_099, mode=mode,
                tables=dk.dia_tables(nan_offs, nan_offs, dc_n, mode,
                                     DEV))[1]
            if not torch.equal(got_n, want_n):
                raise AssertionError(f"NaN words, mode={mode}, {dt}: the "
                                     "counts differ from the plain version")
            cases += 1
    # one A band against five B bands (a B stack that is no multiple of 8)
    run((5,), (-2, -1, 0, 1, 2), 6_001, 6_001, 6_001, both, "D2=5", 50)
    # A and B with different offset sets
    run((0, 2, 4), (-3, -2, -1, 0), 7_919, 7_919, 7_919, both, "A!=B", 60)
    # rectangular: A is 5003 x 7001, B is 7001 x 6007
    run((-1, 0, 1, 2), (-2, -1, 0), 5_003, 7_001, 6_007, both, "rect", 70)
    # offsets within a few columns of +n and -n
    n = 4_099
    run((n - 3, n - 2, n - 1), (-1, 0, 1), n, n, n, both, "near +n", 80)
    run((-(n - 1), -(n - 2)), (0, 1), n, n, n, both, "near -n", 90)
    run((-(n - 2), 0, n - 3), (-(n - 2), 0, n - 3), n, n, n, ("pairs",),
        "near +-n, gapped", 100)
    # the pairbands offsets, and the same set blown out 1000x: its span
    # (2.4 M columns) is beyond any window a block could stage
    run(PAIRBANDS_SORTED, PAIRBANDS_SORTED, 20_011, 20_011, 20_011,
        ("pairs",), "pairbands", 110)
    wide = tuple(o * 1000 for o in PAIRBANDS_SORTED)
    run(wide, wide, 1_500_007, 1_500_007, 1_500_007, ("pairs",),
        "pairbands x1000", 120)
    # the pairs entry with 40 gapped A bands, and where its pair table
    # does not fit in shared memory (12,000 pairs): it is read where it
    # lies (pairs_launch)
    gapped40 = tuple(range(0, 120, 3))
    run(gapped40, (0, 1), 3_001, 3_001, 3_001, ("pairs",),
        "pairs, 40 gapped A bands", 130)
    n_dc = len(D._plan_maps(tuple(range(0, 900, 3)), tuple(range(40)))[0])
    if dk.pairs_launch(300, n_dc, 12_000, 3_001)["stage_tables"]:
        raise AssertionError("12,000 pairs: expected unstaged tables")
    run(tuple(range(0, 900, 3)), tuple(range(40)), 3_001, 3_001, 3_001,
        ("pairs",), "pairs, tables not staged", 140)
    # 20 gapped A bands at a width where the row groups set the grid: 40 C
    # rows in 14 groups of 2 or 3 rows, at both words' geometries
    gapped20 = tuple(range(0, 60, 3))
    n_dc = len(D._plan_maps(gapped20, (0, 1))[0])
    for w in (4, 8):
        gy = dk.pairs_launch(20, n_dc, 40, 200_003, w)["grid_y"]
        if gy != 14 or n_dc % gy == 0:
            raise AssertionError(f"uneven row groups, {w}-byte words: "
                                 f"{n_dc} rows in {gy} groups")
    run(gapped20, (0, 1), 200_003, 200_003, 200_003, ("pairs",),
        "pairs, uneven row groups", 145)
    # edge blocks at both ends for both words' geometries: the first block
    # reaches left of B, the last ones right of B and past n_out, the
    # blocks between run with no bounds test
    offs_e, n_e = (-700, -3, 0, 5, 900), 5 * 1_024 + 77
    for w in (4, 8):
        inner = pairs_interior(offs_e, n_e, w)
        if inner[0] or inner[-1] or not any(inner):
            raise AssertionError(f"edge blocks, {w}-byte words: {inner}")
    run(offs_e, (-2, 0, 2), n_e, n_e, n_e, ("pairs",),
        "pairs, edge blocks at both ends", 150)

    # an engineered cancellation: C[0, 3] = 1*1 + 1*(-1) is numerically zero
    # and structurally present (count 2)
    coo = COOMatrix(
        torch.tensor([0, 0, 1, 2], dtype=torch.int32, device=DEV),
        torch.tensor([1, 2, 3, 3], dtype=torch.int32, device=DEV),
        torch.tensor([1.0, 1.0, 1.0, -1.0], device=DEV), (64, 64))
    m = D.coo_to_dia(coo)
    dc_list, _ = D._plan_maps(m.offsets, m.offsets)
    for mode in both:
        c, cnt = dk.dia_multiply(
            m.bands, m.bands, offs_a=m.offsets, offs_b=m.offsets,
            dc_list=dc_list, n_out=64, mode=mode,
            tables=dk.dia_tables(m.offsets, m.offsets, dc_list, mode, DEV))
        k = dc_list.index(3)
        if float(c[k, 0]) != 0.0 or float(cnt[k, 0]) != 2.0:
            raise AssertionError(f"cancellation, mode={mode}: value "
                                 f"{float(c[k, 0])}, count {float(cnt[k, 0])}")
        if int((cnt > 0).sum()) != 1:
            raise AssertionError(f"cancellation, mode={mode}: C_nnz "
                                 f"{int((cnt > 0).sum())} != 1")
        cases += 1
    # the same through the float64 entries
    m64 = D.coo_to_dia(coo, dtype=torch.float64)
    for mode in both:
        c, cnt = dk.dia_multiply(
            m64.bands, m64.bands, offs_a=m64.offsets, offs_b=m64.offsets,
            dc_list=dc_list, n_out=64, mode=mode,
            tables=dk.dia_tables(m64.offsets, m64.offsets, dc_list, mode,
                                 DEV))
        k = dc_list.index(3)
        if (c.dtype != torch.float64 or float(c[k, 0]) != 0.0
                or float(cnt[k, 0]) != 2.0 or int((cnt > 0).sum()) != 1):
            raise AssertionError(f"cancellation, mode={mode}, float64: "
                                 f"value {float(c[k, 0])}, count "
                                 f"{float(cnt[k, 0])}")
        cases += 1
    # the device alone picks the path: bands of a dtype no entry takes
    # raise on the card, they do not take the plain version
    m16 = D.coo_to_dia(coo, dtype=torch.float16)
    try:
        D.make_dia_plan(m16, m16).run(m16, m16)
    except NotImplementedError:
        cases += 1
    else:
        raise AssertionError("float16 bands on the card did not raise")
    unequal = [k for k, v in F64_BIT_EQUAL.items()
               if k.startswith("dia") and not v]
    if unequal:
        raise AssertionError(f"{unequal}: not bit-equal to the plain version")
    emit("dia_kernel_check", cases=cases, max_abs_err=worst,
         worst_over_bound={k: WORST_OVER.get(k) for k in dk.LAUNCHES},
         f64_bit_equal_to_plain={k: v for k, v in F64_BIT_EQUAL.items()
                                 if k.startswith("dia")},
         bound="abs err <= 1e-5 * sum|a*b| + 1e-6 (float32 dot product), "
               "<= 1e-12 * sum|a*b| (float64 entries); counts equal "
               "exactly, the float64 entries' also to the float32 entries'")
    return worst


# --------------------------------------------------------------------------
# Macro128 kernels against their plain versions

def macro_pairs(am, bm, gran=256):
    """(n_pairs, n_tiles, (c_row, c_col, a_idx, b_idx, seg)) of am @ bm, the
    stream padded to a multiple of ``gran``."""
    offsets = symbolic.pair_counts(am.tile_col, bm.tile_rowptr, am.ntiles)
    n_pairs = int(offsets[-1])
    p_cap = max(gran, -(-n_pairs // gran) * gran)
    out = symbolic.expand_pairs(offsets, am.tile_row, am.tile_col,
                                bm.tile_rowptr, bm.tile_col, n_pairs, p_cap,
                                True)
    return n_pairs, int(out[5]), out[:5]


def dot_bound(mag):
    """The dot-product bound in the dtype of ``mag`` (sum|a*b|)."""
    if mag.dtype == torch.float64:
        return F64_RTOL * mag + F64_ATOL, "float64"
    return COO_RTOL * mag + COO_ATOL, "float32"


def macro_hold(got, want, mag, what, key=None):
    """Flags equal exactly, values inside the dot-product bound of their
    dtype (dot_bound).  Returns the max abs error; ``key`` as in
    dia_hold."""
    (gn, gf), (wn, wf) = got, want
    if gf.dtype != torch.uint8 or not torch.equal(gf > 0, wf > 0):
        raise AssertionError(f"{what}: structural flags differ")
    if gn.dtype != wn.dtype:
        raise AssertionError(f"{what}: values {gn.dtype}, plain {wn.dtype}")
    if not bool(torch.isfinite(gn).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (gn - wn).abs()
    bound, label = dot_bound(mag)
    over = float((err / bound).max()) if err.numel() else 0.0
    if not over <= 1.0:
        raise AssertionError(f"{what}: values exceed the {label} "
                             f"dot-product bound by {over}x")
    note_over(key, over)
    return float(err.max()) if err.numel() else 0.0


def fresh_slabs(rows, fill=float("nan")):
    """Slabs filled with what no kernel writes, so a row that was skipped or
    written twice shows."""
    return (torch.full((rows, 128, 128), fill, device=DEV),
            torch.full((rows, 128, 128), 7, dtype=torch.uint8, device=DEV))


def prec_key(entry, precision):
    """An entry's key at a precision: the entry at "highest", else
    entry@precision (its own worst error and kernel row)."""
    return entry if precision == "highest" else f"{entry}@{precision}"


def class_case(a_dense, b_dense, cls, bases, tables, n_steps, entries, what,
               precision="highest"):
    """One class (its first n_steps steps) through each entry in ``entries``
    at ``precision`` against the plain version at it; where both entries run
    they must agree bit for bit.  Returns ({key: max abs err}, outputs)."""
    t, p, ar, br, a_offs, b_offs, _base = cls
    bases = bases[:2 * n_steps].contiguous()
    rows = n_steps * t + 3
    base = 2                    # rows 0, 1 and the last stay untouched
    wn, wf = fresh_slabs(rows)
    st.class_call_plain(wn, wf, a_dense, b_dense, bases, t, p, a_offs,
                        b_offs, base, precision)
    mn, mf = fresh_slabs(rows, 0.0)
    st.class_call_plain(mn, mf, a_dense.abs(), b_dense.abs(), bases, t, p,
                        a_offs, b_offs, base)
    errs, outs = {}, {}
    live = slice(base, base + n_steps * t)
    for entry in entries:
        gn, gf = fresh_slabs(rows)
        key = prec_key(entry, precision)
        if entry == "macro_class_ragged":
            mk.class_call2(gn, gf, a_dense, b_dense, bases, t, p, ar, br,
                           a_offs, b_offs, base, n_steps, tables=tables,
                           precision=precision)
        else:
            mk.class_call(gn, gf, a_dense, b_dense, bases, t, p, ar, br,
                          a_offs, b_offs, base, tables=tables,
                          precision=precision)
        torch.cuda.synchronize()
        for x in (gn[:base], gn[base + n_steps * t:]):
            if not bool(torch.isnan(x).all()):
                raise AssertionError(f"{what} {key}: wrote outside its "
                                     "rows")
        errs[key] = macro_hold((gn[live], gf[live]), (wn[live], wf[live]),
                               mn[live], f"{what} {key}", key=key)
        outs[key] = (gn[live], gf[live])
    if len(entries) == 2 and not all(
            torch.equal(x, y) for x, y in zip(*outs.values())):
        raise AssertionError(f"{what}: the two class entries disagree")
    return errs, outs


def plan_case(am, bm, planner, what, worst, uniform, precision="highest"):
    """A whole plan at ``precision``: every class through the class kernels
    (uniform classes through both entries), a one-step and an odd-step
    slice of the first class, and stencil_accumulate (classes + residual
    pairs) against the plain pair accumulation in sorted-tile order.
    Returns (cases, plan)."""
    n_pairs, n_tiles, (c_row, c_col, a_idx, b_idx, seg) = macro_pairs(am, bm)
    plan = planner(seg, a_idx, b_idx, c_row, c_col, n_pairs, n_tiles,
                   am.dense.shape[0], bm.dense.shape[0])
    if not plan.classes:
        raise AssertionError(f"{what}: the plan has no class")
    entries = ("macro_class_ragged", "macro_class_uniform") if uniform \
        else ("macro_class_ragged",)
    cases = 0

    def run(cls, bases, tables, n_steps, tag):
        nonlocal cases
        if uniform != isinstance(cls[1], int):
            raise AssertionError(f"{what}: class p={cls[1]!r}")
        for k, e in class_case(am.dense, bm.dense, cls, bases, tables,
                               n_steps, entries, f"{what} {tag}",
                               precision)[0].items():
            worst[k] = max(worst[k], e)
        cases += len(entries)

    for ci, (cls, bases, tables) in enumerate(zip(
            plan.classes, plan.class_bases, plan.class_tables)):
        run(cls, bases, tables, bases.shape[0] // 2, f"class {ci}")
    cls, bases, tables = (plan.classes[0], plan.class_bases[0],
                          plan.class_tables[0])
    n0 = bases.shape[0] // 2
    run(cls, bases, tables, 1, "one step")
    run(cls, bases, tables, n0 - 1 if n0 % 2 == 0 else n0, "odd steps")

    c_cap = -(-n_tiles // 256) * 256
    want = M.accumulate_macro(am.dense, bm.dense, a_idx, b_idx, seg, c_cap,
                              256, precision=precision)
    mag = M.accumulate_macro(am.dense.abs(), bm.dense.abs(), a_idx, b_idx,
                             seg, c_cap, 256)[0]
    got = st.stencil_accumulate(am.dense, bm.dense, plan,
                                precision=precision)
    torch.cuda.synchronize()
    order = torch.from_numpy(plan.order).to(DEV)
    rows = len(plan.order)
    if not (np.unique(plan.order).size == n_tiles == rows):
        raise AssertionError(f"{what}: slab order is no permutation")
    key = prec_key("macro_class_ragged", precision)
    e = macro_hold((got[0][:rows], got[1][:rows]),
                   (want[0][order], want[1][order]), mag[order],
                   f"{what} stencil_accumulate", key=key)
    if bool(got[0][rows:].any()) or bool(got[1][rows:].any()):
        raise AssertionError(f"{what}: slab rows past the last are not zero")
    worst[key] = max(worst[key], e)
    return cases + 1, plan


def pairs_case(a_dense, b_dense, a_idx, b_idx, seg, c_cap, what, worst,
               precision="highest"):
    """The pair-stream entry at ``precision`` against the plain version at
    it, and its float64 entry on the same tiles cast to float64 (which
    ignores the precision; flags equal to the float32 entry's).  Returns
    the float32 entry's output."""
    key = prec_key("macro_accumulate_pairs", precision)
    want = M.accumulate_macro(a_dense, b_dense, a_idx, b_idx, seg, c_cap,
                              256, precision=precision)
    mag = M.accumulate_macro(a_dense.abs(), b_dense.abs(), a_idx, b_idx, seg,
                             c_cap, 256)[0]
    got = mk.accumulate_macro_pairs(a_dense, b_dense, a_idx, b_idx, seg,
                                    c_cap, precision=precision)
    torch.cuda.synchronize()
    e = macro_hold(got, want, mag, f"{what} {key}", key=key)
    worst[key] = max(worst[key], e)
    del want, mag
    got64 = pairs_case_f64(a_dense.double(), b_dense.double(), a_idx, b_idx,
                           seg, c_cap, what, worst, precision=precision)
    if not torch.equal(got64[1], got[1]):
        raise AssertionError(f"{what}: the float64 entry's flags differ "
                             "from the float32 entry's")
    return got


def pairs_case_f64(a64, b64, a_idx, b_idx, seg, c_cap, what, worst,
                   hold=None, precision="highest"):
    """The float64 pair-stream entry against the plain version in float64
    (``hold``: macro_hold, or macro_hold_ieee for non-finite operands),
    called with ``precision``, which float64 ignores.  Returns its
    output."""
    key = "macro_accumulate_pairs_f64"
    want = M.accumulate_macro(a64, b64, a_idx, b_idx, seg, c_cap, 256,
                              torch.float64)
    mag = M.accumulate_macro(a64.abs(), b64.abs(), a_idx, b_idx, seg, c_cap,
                             256, torch.float64)[0]
    got = mk.accumulate_macro_pairs(a64, b64, a_idx, b_idx, seg, c_cap,
                                    precision=precision)
    torch.cuda.synchronize()
    e = (hold or macro_hold)(got, want, mag, f"{what}, float64", key=key)
    worst[key] = max(worst[key], e)
    return got


def f64_skipped_share(a_dense, b_dense, a_idx, b_idx, chunk=8_192):
    """The share of the float64 entry's DMMA blocks (16 A rows x 8 B
    columns x a 16-deep slab, 1,024 a pair) that it skips: those where no k
    of the slab has a non-zero in both, and neither side an Inf or a NaN;
    and the slabs it copies (those with a block that runs; the others it
    skips whole).  Computed from the tiles on the card, as the kernel
    decides.  The bound counts every product; this says how many the
    kernel did not run."""
    # A: (T, 8 slabs, 8 row groups, 16 k) non-zeros, (T, slab, row group)
    # Inf / NaN; B: (T, slab, 16 k, 16 column groups), (T, slab, group)
    a5 = a_dense.view(-1, 8, 16, 8, 16)
    nza = (a5 != 0).any(2).permute(0, 2, 1, 3).to(torch.float32)
    bada = (~torch.isfinite(a5)).any(4).any(2).permute(0, 2, 1)
    b5 = b_dense.view(-1, 8, 16, 16, 8)
    nzb = (b5 != 0).any(4).to(torch.float32)
    badb = (~torch.isfinite(b5)).any(4).any(2)
    need = slabs = 0
    for lo in range(0, a_idx.numel(), chunk):
        ai, bi = a_idx[lo:lo + chunk].long(), b_idx[lo:lo + chunk].long()
        live = torch.matmul(nza[ai], nzb[bi]) > 0       # (P, 8, 8, 16)
        bad = bada[ai][:, :, :, None] | badb[bi][:, :, None, :]
        run = live | bad
        need += int(run.sum())
        slabs += int(run.flatten(2).any(2).sum())       # slabs copied
    total = 1024 * a_idx.numel()
    return {"share": 1.0 - need / total, "blocks_run": need,
            "blocks": total, "slabs_copied": slabs,
            "slabs": 8 * a_idx.numel()}


def engineered_tiles(n_tiles, seed):
    """(n_tiles + 1, 128, 128) float32 tiles on the card, about 1/3 stored,
    with subnormal (1e-40) and negative-zero entries sprinkled in; the last
    tile is the all-zero padding tile."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((n_tiles + 1, 128, 128), generator=g, device=DEV)
    u = torch.rand(x.shape, generator=g, device=DEV)
    x[u < 0.67] = 0.0
    x[(u >= 0.67) & (u < 0.69)] = 1e-40
    x[(u >= 0.69) & (u < 0.71)] = -0.0
    x[-1] = 0.0
    return x.contiguous()


def engineered_class_cases(worst, precision="highest"):
    """The tensor-core class kernel's failure modes on engineered tiles, at
    ``precision``: tiles of 1, 0, 9 and 3 pairs (the 9-pair tile wraps the
    stage ring across pairs), subnormal and -0.0 entries (flags from the
    raw values), a tile whose only products are subnormal x normal (flags
    1; 1e-42 rounds to 0 in tf32 and in bfloat16 alike) and one whose only
    A entries are -0.0 (flags 0); then a uniform class of 9 pairs a tile
    through both entries, bit for bit.  Returns the count."""
    a = engineered_tiles(24, seed=21)
    b = engineered_tiles(24, seed=22)
    # tile pair (A 0, B 0): A row 5 holds one subnormal, row 6 one -0.0, in
    # column 7; B row 7 is all normal
    a[0, 5:7] = 0.0
    a[0, 5, 7] = 1e-42          # its tf32 hi (round to nearest) is 0
    a[0, 6, 7] = -0.0
    b[0, 7] = torch.randn(128, device=DEV).abs() + 0.5
    g = np.random.default_rng(23)
    cases = 0
    p = (1, 0, 9, 3)
    n_p = sum(p)
    a_offs = (0,) + tuple(int(x) for x in g.integers(0, 12, n_p - 1))
    b_offs = (0,) + tuple(int(x) for x in g.integers(0, 12, n_p - 1))
    cls = (4, p, 12, 12, a_offs, b_offs, 0)
    tables = st.class_tables((cls,), DEV)[0]
    bases = torch.tensor([0, 0, 12, 12], dtype=torch.int32, device=DEV)
    key = prec_key("macro_class_ragged", precision)
    errs, outs = class_case(a, b, cls, bases, tables, 2,
                            ("macro_class_ragged",), "engineered 1/0/9/3",
                            precision)
    worst[key] = max(worst[key], errs[key])
    num, flag = outs[key]
    # step 0, tile 0: the single pair (A 0, B 0)
    if not (bool((flag[0, 5] == 1).all()) and not bool(flag[0, 6].any())):
        raise AssertionError("engineered: the subnormal row must flag every "
                             "column and the -0.0 row none")
    if bool(flag[1].any()) or bool(num[1].any()):
        raise AssertionError("engineered: the tile without pairs is not zero")
    cases += 1
    cls_u = (3, 9, 12, 12, tuple(int(x) for x in g.integers(0, 12, 27)),
             tuple(int(x) for x in g.integers(0, 12, 27)), 0)
    tables_u = st.class_tables((cls_u,), DEV)[0]
    errs, _ = class_case(a, b, cls_u, bases, tables_u, 2,
                         ("macro_class_ragged", "macro_class_uniform"),
                         "engineered uniform 9", precision)
    for k, e in errs.items():
        worst[k] = max(worst[k], e)
    return cases + 2


def macro_hold_ieee(got, want, mag, what, key=None):
    """Non-finite operands: flags equal, NaN at the plain version's NaNs and
    an Inf of the same sign at each of its Infs (IEEE), finite entries
    within the float32 bound.  Returns the max abs error over the finite
    entries."""
    (gn, gf), (wn, wf) = got, want
    if gf.dtype != torch.uint8 or not torch.equal(gf > 0, wf > 0):
        raise AssertionError(f"{what}: structural flags differ")
    if not torch.equal(torch.isnan(gn), torch.isnan(wn)):
        raise AssertionError(
            f"{what}: NaN at {int(torch.isnan(gn).sum())} entries, the plain "
            f"version at {int(torch.isnan(wn).sum())}")
    inf = torch.isinf(wn)
    if not torch.equal(torch.isinf(gn), inf) or \
            not torch.equal(gn[inf] > 0, wn[inf] > 0):
        raise AssertionError(f"{what}: Inf positions or signs differ")
    fin = torch.isfinite(wn)
    err = (gn[fin] - wn[fin]).abs()
    bound, label = dot_bound(mag[fin])
    over = float((err / bound).max())
    if not over <= 1.0:
        raise AssertionError(f"{what}: finite values exceed the {label} "
                             f"dot-product bound by {over}x")
    note_over(key, over)
    return float(err.max())


def nonfinite_tiles():
    """(a, b): 12 + 1 engineered tiles each (the last the zero tile) with,
    in tiles 0-6, +Inf and NaN in A, -Inf and NaN in B, an A -Inf whose
    k-slab of B is all zero (an Inf that meets only zeros), finite A and B
    values whose tf32 and bfloat16 roundings overflow (3.4025e38), and
    subnormals that round to 0 in both (1e-42) in a stage that also holds
    a value above 2^63 (so the marked stage's FMA rounds them too)."""
    a = engineered_tiles(12, seed=31)
    b = engineered_tiles(12, seed=32)
    a[0, 3, 5] = float("inf")           # B[0] row 5: +-Inf, NaN at its zeros
    b[2, 7, 33] = float("-inf")
    a[3, 10, 40] = float("-inf")        # k-slab 1 of B[3] is all zero
    b[3, 32:64] = 0.0
    b[4, 20, 9] = float("nan")          # one column of C all NaN
    a[5, 17, 100] = float("nan")        # one row of C all NaN
    a[6, 40, 50] = 3.4025e38            # finite; its tf32 rounding is Inf
    b[6, 50] = 0.5
    a[6, :, 90] = 0.0
    a[6, ::3, 90] = 0.25
    b[6, 90, 100] = -3.4025e38
    a[6, 41, 51] = 1e-42
    b[6, 51, 7] = 2.0 ** 100
    return a.contiguous(), b.contiguous()


def pairs_direct(a_dense, b_dense, a_idx, b_idx, seg, c_cap, grid,
                 precision="highest", out=None):
    """The pair-stream entry launched with ``grid`` blocks (the wrapper
    launches one an SM), so that each block takes several C tiles; with
    ``out`` its accumulate form, into ``out`` (over the stream's walk list,
    the masks made by the launch); not counted."""
    seg_ptr = mk.segment_offsets(seg, c_cap)
    next_tile = torch.zeros(1, dtype=torch.int32, device=DEV)
    num, flag = fresh_slabs(c_cap) if out is None else out
    prec = M.precision_code(precision)
    _masks, margs = mk._mask_args(
        a_dense, b_dense, mk.reads_masks(a_dense, precision, out is not None),
        None)
    walk = mk.stream_walk(seg, c_cap, min(c_cap, a_idx.numel()), next_tile) \
        if out is not None else None
    mk._raise_on(mk._library().macro_accumulate_pairs_f32(
        a_dense.data_ptr(), b_dense.data_ptr(), a_idx.data_ptr(),
        b_idx.data_ptr(), seg_ptr.data_ptr(), num.data_ptr(),
        flag.data_ptr(), c_cap, grid, next_tile.data_ptr(), prec, *margs,
        int(out is not None), None if walk is None else walk.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "pairs_direct")
    torch.cuda.synchronize()
    return num, flag


def engineered_nonfinite_cases(worst, precision="highest"):
    """K4, K5 and K6 at ``precision`` on operands with Inf, -Inf, NaN,
    near-FLT_MAX values and subnormals: each against the plain version at
    it (macro_hold_ieee: its NaN positions and Inf signs), K4 through the
    wrapper and with 2 blocks (several tiles a block, an empty tile, tiles
    past the stream's count), the two class entries bit for bit equal.
    Returns the count of cases."""
    a, b = nonfinite_tiles()
    amag, bmag = a.abs(), b.abs()
    # a pair stream: C tiles of 3, 2, 0, 2 and 2 pairs in a c_cap of 7
    pairs = [(0, 0, 0), (1, 1, 0), (2, 2, 0), (3, 3, 1), (7, 7, 1),
             (4, 4, 3), (5, 5, 3), (6, 6, 4), (1, 6, 4)]
    pad = 256 - len(pairs)
    cols = torch.tensor(pairs, dtype=torch.int32, device=DEV).T
    a_idx, b_idx, seg = (torch.cat([x, torch.full((pad,), f, dtype=torch.int32,
                                                  device=DEV)]).contiguous()
                         for x, f in zip(cols, (12, 12, symbolic.INT32_MAX)))
    want = M.accumulate_macro(a, b, a_idx, b_idx, seg, 7, 256,
                              precision=precision)
    mag = M.accumulate_macro(amag, bmag, a_idx, b_idx, seg, 7, 256)[0]
    if not (bool(torch.isnan(want[0]).any()) and bool(
            torch.isinf(want[0]).any())):
        raise AssertionError("non-finite: the plain product has no NaN/Inf")
    cases = 0
    k4 = prec_key("macro_accumulate_pairs", precision)
    for what, got in (
            ("wrapper", mk.accumulate_macro_pairs(a, b, a_idx, b_idx, seg,
                                                  7, precision=precision)),
            ("2 blocks", pairs_direct(a, b, a_idx, b_idx, seg, 7, 2,
                                      precision))):
        torch.cuda.synchronize()
        e = macro_hold_ieee(got, want, mag, f"non-finite pairs, {what}, "
                            f"{precision}", key=k4)
        worst[k4] = max(worst[k4], e)
        if bool(got[0][2].any()) or bool(got[1][2].any()) or \
                bool(got[0][5:].any()) or bool(got[1][5:].any()):
            raise AssertionError(f"non-finite pairs, {what}: an empty tile "
                                 "is not zero")
        cases += 1
    # the -Inf that meets only zeros: row 10 of C tile 1 is NaN
    if not bool(torch.isnan(want[0][1, 10]).all()):
        raise AssertionError("non-finite: the plain row 10 is not all NaN")
    # the float64 entry on the same tiles: the plain version's NaNs and
    # signed Infs, flags equal to the float32 entry's
    got64 = pairs_case_f64(a.double(), b.double(), a_idx, b_idx, seg, 7,
                           "non-finite pairs", worst, hold=macro_hold_ieee,
                           precision=precision)
    if not torch.equal(got64[1], got[1]):
        raise AssertionError("non-finite pairs: the float64 entry's flags "
                             "differ from the float32 entry's")
    if bool(got64[0][2].any()) or bool(got64[0][5:].any()):
        raise AssertionError("non-finite pairs, float64: an empty tile is "
                             "not zero")
    cases += 1

    bases = torch.tensor([0, 0, 4, 4], dtype=torch.int32, device=DEV)
    ragged = (2, (3, 2), 8, 8, (0, 1, 2, 3, 7), (0, 1, 2, 3, 7), 0)
    uniform = (2, 2, 8, 8, (0, 1, 2, 3), (0, 1, 2, 3), 0)
    for cls, entries in ((ragged, ("macro_class_ragged",)),
                         (uniform, ("macro_class_ragged",
                                    "macro_class_uniform"))):
        t, p, ar, br, a_offs, b_offs, _ = cls
        tables = st.class_tables((cls,), DEV)[0]
        rows = 2 * t
        wn, wf = fresh_slabs(rows)
        st.class_call_plain(wn, wf, a, b, bases, t, p, a_offs, b_offs, 0,
                            precision)
        mn, mf = fresh_slabs(rows, 0.0)
        st.class_call_plain(mn, mf, amag, bmag, bases, t, p, a_offs, b_offs,
                            0)
        outs = []
        for entry in entries:
            gn, gf = fresh_slabs(rows)
            key = prec_key(entry, precision)
            if entry == "macro_class_ragged":
                mk.class_call2(gn, gf, a, b, bases, t, p, ar, br, a_offs,
                               b_offs, 0, 2, tables=tables,
                               precision=precision)
            else:
                mk.class_call(gn, gf, a, b, bases, t, p, ar, br, a_offs,
                              b_offs, 0, tables=tables, precision=precision)
            torch.cuda.synchronize()
            e = macro_hold_ieee((gn, gf), (wn, wf), mn,
                                f"non-finite class p={p!r} {key}", key=key)
            worst[key] = max(worst[key], e)
            outs.append((gn.view(torch.int32), gf))
            cases += 1
        if len(outs) == 2 and not all(torch.equal(x, y)
                                      for x, y in zip(*outs)):
            raise AssertionError("non-finite: the two class entries differ")
    return cases


def onepass_tiles():
    """(a, b): 4 + 1 engineered tiles each (the last the zero tile) at the
    edges of the one-pass pipeline ("high", "default"): tile 0 holds its
    non-zeros only in k 32-63 (A columns, B rows: stage 0 of the pair is
    empty and skipped, stage 1 runs), tile 1 none in A rows 0-63 (the first
    consumer warpgroup skips every stage, the second runs), tile 2 an Inf
    in k-slab 1 alone (a marked stage between unmarked ones), tile 3 only
    subnormals below 2^-134 in A (0 in bfloat16 and in tf32) against normal
    B rows, whose flags must be set."""
    a = engineered_tiles(4, seed=51)
    b = engineered_tiles(4, seed=52)
    a[0, :, :32] = 0.0
    a[0, :, 64:] = 0.0
    b[0, :32] = 0.0
    b[0, 64:] = 0.0
    a[1, :64] = 0.0
    a[2, 10, 40] = float("inf")
    b[2, 40] = torch.randn(128, device=DEV)
    b[2, 40, ::3] = 0.0             # the Inf meets zeros too: NaN there
    a[3] = 0.0
    a[3, 5, 7] = 1e-41
    a[3, 6, 100] = -1e-41
    b[3, 7] = torch.randn(128, device=DEV).abs() + 0.5
    b[3, 100] = torch.randn(128, device=DEV).abs() + 0.5
    return a.contiguous(), b.contiguous()


def class_direct(entry, slabs, a, b, bases, t, p, a_offs, b_offs, tables,
                 base, n_steps, grid, precision):
    """A class entry launched with ``grid`` persistent blocks (the wrapper
    launches one an SM), so that each block takes several tiles; not
    counted."""
    p_ptr, ao, bo = tables
    ticket = torch.zeros(1, dtype=torch.int32, device=DEV)
    lib = mk._library()
    stream = torch.cuda.current_stream().cuda_stream
    prec = M.precision_code(precision)
    _masks, margs = mk._mask_args(a, b, prec != 0, None)
    head = (a.data_ptr(), b.data_ptr(), bases.data_ptr())
    tail = (n_steps, base, slabs[0].data_ptr(), slabs[1].data_ptr(), prec,
            grid, ticket.data_ptr(), *margs, stream)
    if entry == "macro_class_ragged":
        err = lib.macro_class_ragged_f32(*head, p_ptr.data_ptr(),
                                         ao.data_ptr(), bo.data_ptr(), t,
                                         *tail)
    else:
        err = lib.macro_class_uniform_f32(*head, ao.data_ptr(),
                                          bo.data_ptr(), t, p, *tail)
    mk._raise_on(err, "class_direct")
    torch.cuda.synchronize()
    return slabs


def engineered_onepass_cases(worst, precision):
    """The one-pass pipeline's edges (onepass_tiles) at ``precision``, each
    against the plain version at it (macro_hold_ieee: flags exact, NaN
    positions, Inf signs, finite values within the float32 bound): K4
    through the wrapper and with 2 blocks; a ragged and a uniform class of
    150 tiles (more than the card's SMs: a persistent block takes two or
    more) through the wrappers and with 2 blocks, the two entries bit for
    bit equal.  Returns the count of cases."""
    a, b = onepass_tiles()
    amag, bmag = a.abs(), b.abs()
    # C tiles 0-3: one pair each, tile i x tile i; tile 4: (0, 0) and (2, 2)
    # (an unmarked stage, then marked ones); tile 5 empty
    pairs = [(0, 0, 0), (1, 1, 1), (2, 2, 2), (3, 3, 3), (0, 0, 4),
             (2, 2, 4)]
    pad = 256 - len(pairs)
    cols = torch.tensor(pairs, dtype=torch.int32, device=DEV).T
    a_idx, b_idx, seg = (torch.cat([x, torch.full((pad,), f, dtype=torch.int32,
                                                  device=DEV)]).contiguous()
                         for x, f in zip(cols, (4, 4, symbolic.INT32_MAX)))
    want = M.accumulate_macro(a, b, a_idx, b_idx, seg, 6, 256,
                              precision=precision)
    mag = M.accumulate_macro(amag, bmag, a_idx, b_idx, seg, 6, 256)[0]
    if not bool(torch.isnan(want[0][2]).any()) or \
            not bool((want[1][3, 5] == 1).all()):
        raise AssertionError("one-pass tiles: the plain product lacks its "
                             "NaN or its subnormal row's flags")
    cases = 0
    k4 = prec_key("macro_accumulate_pairs", precision)
    for what, got in (
            ("wrapper", mk.accumulate_macro_pairs(a, b, a_idx, b_idx, seg,
                                                  6, precision=precision)),
            ("2 blocks", pairs_direct(a, b, a_idx, b_idx, seg, 6, 2,
                                      precision))):
        torch.cuda.synchronize()
        worst[k4] = max(worst[k4], macro_hold_ieee(
            got, want, mag, f"one-pass pairs, {what}, {precision}", key=k4))
        if not bool((got[1][3, 5:7] == want[1][3, 5:7]).all()) or \
                bool(got[0][5].any()) or bool(got[1][5].any()):
            raise AssertionError(f"one-pass pairs, {what}: the subnormal "
                                 "rows' flags or the empty tile")
        cases += 1
    n_steps = 50
    bases = torch.zeros(2 * n_steps, dtype=torch.int32, device=DEV)
    ragged = (3, (2, 1, 3), 4, 4, (0, 1, 2, 3, 0, 2), (0, 1, 2, 3, 0, 2), 0)
    uniform = (3, 2, 4, 4, (0, 1, 2, 3, 3, 2), (0, 1, 2, 3, 3, 2), 0)
    for cls, entries in ((ragged, ("macro_class_ragged",)),
                         (uniform, ("macro_class_ragged",
                                    "macro_class_uniform"))):
        t, p, ar, br, a_offs, b_offs, _ = cls
        tables = st.class_tables((cls,), DEV)[0]
        rows = n_steps * t
        wn, wf = fresh_slabs(rows)
        st.class_call_plain(wn, wf, a, b, bases, t, p, a_offs, b_offs, 0,
                            precision)
        mn, _mf = fresh_slabs(rows, 0.0)
        st.class_call_plain(mn, _mf, amag, bmag, bases, t, p, a_offs,
                            b_offs, 0)
        outs = []
        for entry in entries:
            key = prec_key(entry, precision)
            gn, gf = fresh_slabs(rows)
            if entry == "macro_class_ragged":
                mk.class_call2(gn, gf, a, b, bases, t, p, ar, br, a_offs,
                               b_offs, 0, n_steps, tables=tables,
                               precision=precision)
            else:
                mk.class_call(gn, gf, a, b, bases, t, p, ar, br, a_offs,
                              b_offs, 0, tables=tables, precision=precision)
            two = class_direct(entry, fresh_slabs(rows), a, b, bases, t, p,
                               a_offs, b_offs, tables, 0, n_steps, 2,
                               precision)
            torch.cuda.synchronize()
            for what, got in (("wrapper", (gn, gf)), ("2 blocks", two)):
                worst[key] = max(worst[key], macro_hold_ieee(
                    got, (wn, wf), mn, f"one-pass class p={p!r} {key} "
                    f"{what}", key=key))
                cases += 1
            outs.append((gn.view(torch.int32), gf))
        if len(outs) == 2 and not all(torch.equal(x, y)
                                      for x, y in zip(*outs)):
            raise AssertionError("one-pass: the two class entries differ")
    return cases


# --------------------------------------------------------------------------
# K4's accumulate form (``out=``): the Macro128 ring's stages after a rank's
# first add into the rank's C

def acc_prior(c_cap, dtype, seed):
    """A C on the card that a stage adds into: normal values with -0.0,
    +-Inf and NaN in every tile (with pairs or without), flags 0 and 1."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    num = torch.randn((c_cap, 128, 128), generator=g, device=DEV,
                      dtype=dtype)
    u = torch.rand((c_cap, 128, 128), generator=g, device=DEV)
    num.masked_fill_(u < 0.05, -0.0)
    num.masked_fill_((u >= 0.05) & (u < 0.055), float("inf"))
    num.masked_fill_((u >= 0.055) & (u < 0.06), float("-inf"))
    num.masked_fill_((u >= 0.06) & (u < 0.065), float("nan"))
    del u
    flag = (torch.rand((c_cap, 128, 128), generator=g, device=DEV)
            < 0.3).to(torch.uint8)
    return num, flag


def stream_tiles(seg, c_cap):
    """(c_cap,) bool on the card: the C tiles the stream has pairs for."""
    live = torch.zeros(c_cap, dtype=torch.bool, device=seg.device)
    live[seg[seg < c_cap].long()] = True
    return live


def int_view(x):
    return x.view(torch.int64 if x.element_size() == 8 else torch.int32)


def hold_accumulate(got, want, prior, mag, live, what, key=None):
    """The accumulate form (added into a copy of ``prior``) against the
    plain one (added into another): the tiles without pairs (``live``
    False) bit for bit the prior's, values and flags; in the others the
    flags bit for bit, NaN where the plain version has NaN, an Inf of its
    sign where it has one, finite values within the dot-product bound of
    sum|a*b| + |old| (``mag`` the former).  Returns the max abs error."""
    (gn, gf), (wn, wf) = got, want
    dead = ~live
    if not (torch.equal(int_view(gn[dead]), int_view(prior[0][dead]))
            and torch.equal(gf[dead], prior[1][dead])):
        raise AssertionError(f"{what}: a tile without pairs changed")
    if not torch.equal(gf[live], wf[live]):
        raise AssertionError(f"{what}: flags differ from the plain "
                             "version's")
    old = prior[0][live]
    return macro_hold_ieee((gn[live], gf[live]), (wn[live], wf[live]),
                           mag[live] + torch.nan_to_num(old.abs(), 0.0, 0.0),
                           what, key=key)


def accumulate_case(a, b, a_idx, b_idx, seg, c_cap, what, worst,
                    precision="highest", seed=0, grid=None):
    """K4's accumulate form (the float32 entry at ``precision`` or, for
    float64 tiles, the float64 entry) through the wrapper and, with
    ``grid``, launched with that many blocks, each into a copy of one prior
    C (acc_prior), against the plain accumulate into another copy
    (hold_accumulate).  Returns the wrapper's output."""
    f64 = a.dtype == torch.float64
    key = "macro_accumulate_pairs_f64_acc" if f64 else prec_key(
        "macro_accumulate_pairs_acc", precision)
    prior = acc_prior(c_cap, a.dtype, seed)
    chunk = min(256, a_idx.numel())
    want = M.accumulate_macro(a, b, a_idx, b_idx, seg, c_cap, chunk, a.dtype,
                              precision,
                              out=tuple(x.clone() for x in prior))
    mag = M.accumulate_macro(a.abs(), b.abs(), a_idx, b_idx, seg, c_cap,
                             chunk, a.dtype)[0]
    live = stream_tiles(seg, c_cap)
    got = mk.accumulate_macro_pairs(a, b, a_idx, b_idx, seg, c_cap,
                                    chunk=chunk, precision=precision,
                                    out=tuple(x.clone() for x in prior))
    outs = [("wrapper", got)]
    if grid is not None:
        outs.append((f"{grid} blocks", pairs_direct(
            a, b, a_idx, b_idx, seg, c_cap, grid, precision,
            out=tuple(x.clone() for x in prior))))
    torch.cuda.synchronize()
    for how, out in outs:
        worst[key] = max(worst[key], hold_accumulate(
            out, want, prior, mag, live, f"{what}, accumulate form, {how}, "
            f"{'float64' if f64 else precision}", key=key))
    return got


def engineered_accumulate_cases(worst):
    """K4's accumulate form at each precision and in float64, on the
    non-finite tiles (+-Inf, NaN, near-FLT_MAX, values of 2^63 and more,
    subnormals; the plain version's NaNs and Inf signs) and on a stream
    with an empty tile, a tile whose pair multiplies only zeros (A's
    columns and B's rows share no k: no slab of it runs, so the kernel
    leaves it, where the plain version adds +0.0), and tiles past the
    stream's count; each into a prior C with -0.0, +-Inf and NaN in
    every tile.  The float32 entry also with 2 blocks.  Returns the
    count."""
    a, b = nonfinite_tiles()
    a[8, :, 32:] = 0.0                  # A tile 8: non-zeros in k < 32
    b[9, :32] = 0.0                     # B tile 9: non-zeros in k >= 32
    # C tiles of 3, 2, 0, 2, 2 and 1 pairs (the last multiplies only
    # zeros) in a c_cap of 8
    pairs = [(0, 0, 0), (1, 1, 0), (2, 2, 0), (3, 3, 1), (7, 7, 1),
             (4, 4, 3), (5, 5, 3), (6, 6, 4), (1, 6, 4), (8, 9, 5)]
    pad = 256 - len(pairs)
    cols = torch.tensor(pairs, dtype=torch.int32, device=DEV).T
    a_idx, b_idx, seg = (torch.cat([x, torch.full((pad,), f, dtype=torch.int32,
                                                  device=DEV)]).contiguous()
                         for x, f in zip(cols, (12, 12, symbolic.INT32_MAX)))
    cases = 0
    for q in ("highest",) + LOWER_PRECISIONS:
        accumulate_case(a, b, a_idx, b_idx, seg, 8, "engineered", worst, q,
                        seed=61, grid=2)
        cases += 2
    accumulate_case(a.double(), b.double(), a_idx, b_idx, seg, 8,
                    "engineered", worst, seed=62)
    cases += 1
    # the same stream in a c_cap far above its 6 tiles with pairs (the walk
    # list visits those alone), and a stage of a single pair
    one = torch.full((256,), symbolic.INT32_MAX, dtype=torch.int32,
                     device=DEV)
    one[0] = 5
    one_a, one_b = torch.full_like(one, 12), torch.full_like(one, 12)
    one_a[0], one_b[0] = 2, 3
    for x, y, ia, ib, sg, c_cap, what in (
            (a, b, a_idx, b_idx, seg, 2048, "c_cap 2048, 6 tiles with pairs"),
            (a, b, one_a, one_b, one, 8, "a single pair")):
        for q in ("highest",) + LOWER_PRECISIONS:
            accumulate_case(x, y, ia, ib, sg, c_cap, what, worst, q, seed=65,
                            grid=3)
            cases += 2
        accumulate_case(x.double(), y.double(), ia, ib, sg, c_cap, what,
                        worst, seed=66)
        cases += 1
    return cases


def engineered_masks_cases():
    """Both masks entries (TableMasks.make: macro_tile_masks_f32 / _f64)
    bit for bit their plain version (tile_masks_plain) on tiles with NaN,
    +-Inf, values of 2^63 and more, -0.0 columns, subnormals, an empty tile
    and a full one, float32 and float64.  Returns the count."""
    g = torch.Generator(device=DEV).manual_seed(67)
    x = torch.randn((6, 128, 128), generator=g, device=DEV)
    x.masked_fill_(torch.rand(x.shape, generator=g, device=DEV) < 0.85, 0.0)
    x[0, 3, 99] = float("nan")
    x[0, 70, 5] = float("inf")
    x[1, 40, 33] = float("-inf")
    x[1, 100, 64] = 2.0 ** 63
    x[1, 101, 65] = -3.0e38
    x[2, :, 10:20] = -0.0
    x[2, 17, 90] = 1e-42
    x[2, 120, 7] = -1e-45
    x[3] = 0.0
    x[4] = 1.0
    x[5, 60, 127] = 2.0 ** 62
    cases = 0
    for t in (x, x.double()):
        got = mk.TableMasks(t).make().words
        if not torch.equal(got, mk.tile_masks_plain(t)):
            raise AssertionError(f"masks entry, {t.dtype}: words differ "
                                 "from the plain version's")
        cases += 1
    return cases


def walk_stream(per_tile, c_cap, past=0, pad_to=256):
    """A sorted stream on the card: tile i with per_tile[i] pairs, ``past``
    pairs of tile c_cap + 1 after them, padded with INT32_MAX to a multiple
    of ``pad_to``."""
    seg = np.concatenate([np.repeat(np.arange(len(per_tile)), per_tile),
                          np.full(past, c_cap + 1)]).astype(np.int64)
    p_cap = max(pad_to, -(-len(seg) // pad_to) * pad_to)
    seg = np.concatenate([seg, np.full(p_cap - len(seg),
                                       symbolic.INT32_MAX)])
    return torch.from_numpy(seg.astype(np.int32)).to(DEV)


def engineered_walk_cases():
    """The walk entry (mk.stream_walk: macro_stream_walk) bit for bit its
    plain version on streams: empty, a c_cap far above its tiles, pairs
    past c_cap, a single pair, a tile of 1,024 pairs and tiles across
    several 4,096-pair steps; each with the ticket counter zeroed.
    Returns the count."""
    g = np.random.default_rng(91)
    many = g.integers(0, 41, 300) * (g.random(300) < 0.4)
    many[[5, 100, 200]] = (3000, 4100, 1500)
    cases = 0
    for per_tile, c_cap, past in (([], 8, 0), ([0, 3, 0, 0, 2], 4096, 0),
                                  ([1, 2, 0, 4], 4, 5), ([0, 0, 1], 3, 0),
                                  ([1024, 1, 0, 7], 9, 0),
                                  (list(many), 300, 0)):
        seg = walk_stream(per_tile, c_cap, past)
        cap = min(c_cap, seg.numel())
        ticket = torch.full((1,), 7, dtype=torch.int32, device=DEV)
        got = mk.stream_walk(seg, c_cap, cap, ticket)
        want = mk.stream_walk_plain(seg, c_cap, cap)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and int(ticket[0]) == 0):
            raise AssertionError(f"stream walk, tiles {per_tile[:8]}..., "
                                 f"c_cap {c_cap}: differs from the plain "
                                 "version")
        cases += 1
    return cases


def graph_stage_case(a, b, a_idx, b_idx, seg, c_cap, precision, what):
    """One stage's accumulate launch through the wrapper, its tables' masks
    made beforehand as a ring plan's are: eagerly under
    set_sync_debug_mode("error") (a host sync raises), and captured in a
    CUDA graph and replayed once, each into a copy of one prior C: the
    replay bit for bit the eager launch.  Returns the tiles it visits (the
    walk list's count)."""
    prior = acc_prior(c_cap, a.dtype, 81)
    masks = mk.TileMasks(a, b)
    masks.a.make()
    if masks.b is not masks.a:
        masks.b.make()
    run = lambda out: mk.accumulate_macro_pairs(
        a, b, a_idx, b_idx, seg, c_cap, precision=precision,
        tile_masks=masks, out=out)
    eager = tuple(x.clone() for x in prior)
    replay = tuple(x.clone() for x in prior)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(eager)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run(replay)
    graph.replay()
    torch.cuda.synchronize()
    del graph
    if not (torch.equal(int_view(eager[0]), int_view(replay[0]))
            and torch.equal(eager[1], replay[1])):
        raise AssertionError(f"{what}: the graph replay differs from the "
                             "eager launch")
    walk = mk.stream_walk(seg, c_cap, min(c_cap, a_idx.numel()))
    return int(walk[0])


F32_MACRO_ENTRIES = ("macro_accumulate_pairs", "macro_class_ragged",
                     "macro_class_uniform", "macro_accumulate_pairs_acc")
LOWER_PRECISIONS = ("high", "default")


def prerounded_case(a_dense, b_dense, plan, a_idx, b_idx, seg, c_cap,
                    precision, worst):
    """The second oracle on the card: each float32 entry at ``precision``
    against the same entry at "highest" on tables rounded beforehand
    (M.round_operands), whose split is then exact (lo = 0): the same
    products, so values within the float32 bound and flags equal (randn
    values never round to 0).  Returns the count of cases."""
    ra = M.round_operands(a_dense, precision)
    rb = ra if b_dense is a_dense else M.round_operands(b_dense, precision)
    mag = M.accumulate_macro(a_dense.abs(), b_dense.abs(), a_idx, b_idx, seg,
                             c_cap, 256)[0]
    got = mk.accumulate_macro_pairs(a_dense, b_dense, a_idx, b_idx, seg,
                                    c_cap, precision=precision)
    want = mk.accumulate_macro_pairs(ra, rb, a_idx, b_idx, seg, c_cap)
    torch.cuda.synchronize()
    key = prec_key("macro_accumulate_pairs", precision)
    worst[key] = max(worst[key], macro_hold(
        got, want, mag, f"pre-rounded pairs, {key}", key=key))
    cases = 1
    for cls, bases, tables in zip(plan.classes, plan.class_bases,
                                  plan.class_tables):
        t, p, ar, br, a_offs, b_offs, _base = cls
        n_steps = bases.numel() // 2
        rows = n_steps * t
        entries = [("macro_class_ragged", lambda x, y, out, pr: mk.class_call2(
            *out, x, y, bases, t, p, ar, br, a_offs, b_offs, 0, n_steps,
            tables=tables, precision=pr))]
        if isinstance(p, int):
            entries.append(("macro_class_uniform",
                            lambda x, y, out, pr: mk.class_call(
                                *out, x, y, bases, t, p, ar, br, a_offs,
                                b_offs, 0, tables=tables, precision=pr)))
        mn, _mf = fresh_slabs(rows, 0.0)
        st.class_call_plain(mn, _mf, a_dense.abs(), b_dense.abs(), bases, t,
                            p, a_offs, b_offs, 0)
        for entry, call in entries:
            got, want = fresh_slabs(rows), fresh_slabs(rows)
            call(a_dense, b_dense, got, precision)
            call(ra, rb, want, "highest")
            torch.cuda.synchronize()
            key = prec_key(entry, precision)
            worst[key] = max(worst[key], macro_hold(
                got, want, mn, f"pre-rounded class, {key}", key=key))
            cases += 1
    return cases


def phase_macro_kernel_check():
    worst = {prec_key(k, p): 0.0 for k in F32_MACRO_ENTRIES
             for p in LOWER_PRECISIONS}
    worst.update({k: 0.0 for k in mk.LAUNCHES})
    cases = 0
    info = {}

    # a ragged run-plan class set, with residual pairs (at this size many row
    # signatures are too rare for a class)
    am = coo_to_macro(wandering_device(n=16_384, seed=4))
    n, plan = plan_case(am, am, st.plan_runs, "wandering", worst,
                        uniform=False)
    if not plan.res_pa.numel():
        raise AssertionError("wandering: the plan has no residual pair")
    cases += n
    info["wandering"] = dict(classes=len(plan.classes),
                             coverage=plan.coverage,
                             residual_pairs=int(plan.res_pa.numel()))
    # a uniform stencil class set: both class entries, bit-equal
    ab = coo_to_macro(banded_device(n=16_384, seed=1,
                                    bands=tuple(range(-32, 32))))
    n, plan = plan_case(ab, ab, st.plan_stencil, "banded64", worst,
                        uniform=True)
    cases += n
    info["banded64"] = dict(classes=len(plan.classes),
                            coverage=plan.coverage,
                            residual_pairs=int(plan.res_pa.numel()))
    # A != B operands (A @ A^T of the wandering band), classes and stream
    coo = wandering_device(n=16_384, seed=5)
    at = coo_to_macro(COOMatrix(coo.cols, coo.rows, coo.vals, coo.shape))
    aw = coo_to_macro(coo)
    n, plan = plan_case(aw, at, st.plan_runs, "A@A^T", worst, uniform=False)
    cases += n
    n_pairs, n_tiles, (_r, _c, a_idx, b_idx, seg) = macro_pairs(aw, at)
    pairs_case(aw.dense, at.dense, a_idx, b_idx, seg,
               -(-n_tiles // 256) * 256, "pairs A@A^T", worst)
    cases += 1
    del at, aw, ab, am

    n = engineered_class_cases(worst)
    cases += n
    cases += engineered_nonfinite_cases(worst)
    cases += engineered_accumulate_cases(worst)
    cases += engineered_masks_cases()
    cases += engineered_walk_cases()

    # "high" and "default": every entry against its plain version at the
    # precision (round_operands, then the "highest" plain path), and
    # against itself at "highest" on pre-rounded tables; the engineered
    # cases (subnormals that round to 0, values whose rounding is Inf,
    # +-Inf, NaN) at each
    am = coo_to_macro(wandering_device(n=16_384, seed=4))
    ab = coo_to_macro(banded_device(n=16_384, seed=1,
                                    bands=tuple(range(-32, 32))))
    for p in LOWER_PRECISIONS:
        cases += plan_case(am, am, st.plan_runs, f"wandering {p}", worst,
                           uniform=False, precision=p)[0]
        n, plan = plan_case(ab, ab, st.plan_stencil, f"banded64 {p}", worst,
                            uniform=True, precision=p)
        cases += n
        _np, n_tiles, (_r, _c, a_idx, b_idx, seg) = macro_pairs(ab, ab)
        c_cap = -(-n_tiles // 256) * 256
        pairs_case(ab.dense, ab.dense, a_idx, b_idx, seg, c_cap,
                   f"pairs banded64 {p}", worst, precision=p)
        cases += 1
        cases += prerounded_case(ab.dense, ab.dense, plan, a_idx, b_idx,
                                 seg, c_cap, p, worst)
        cases += engineered_class_cases(worst, p)
        cases += engineered_nonfinite_cases(worst, p)
        cases += engineered_onepass_cases(worst, p)
    del am, ab, plan, a_idx, b_idx, seg

    # the pair stream of a gapped-band matrix (neither planner covers it),
    # with padding pairs, cut to a tile count that is no multiple of 4 and a
    # c_cap beyond it
    ap = coo_to_macro(banded_device(n=32_768, seed=9, bands=PAIRBANDS))
    n_pairs, n_tiles, (_r, _c, a_idx, b_idx, seg) = macro_pairs(ap, ap)
    if n_pairs == a_idx.numel():
        raise AssertionError("pairs: the stream has no padding pair")
    pairs_case(ap.dense, ap.dense, a_idx, b_idx, seg,
               -(-n_tiles // 256) * 256, "pairs gapped bands", worst)
    # its accumulate form at each precision and in float64, with tiles past
    # the stream's count
    for q in ("highest",) + LOWER_PRECISIONS:
        accumulate_case(ap.dense, ap.dense, a_idx, b_idx, seg, n_tiles + 40,
                        "pairs gapped bands", worst, q, seed=63, grid=3)
        cases += 2
    accumulate_case(ap.dense.double(), ap.dense.double(), a_idx, b_idx, seg,
                    n_tiles + 40, "pairs gapped bands", worst, seed=64)
    cases += 1
    # the stage's launch replayed from a CUDA graph, bit for bit its eager
    # launch (no host sync in it), in every accumulate form; and the masks
    # entries on a whole table
    for t in (ap.dense, ap.dense.double()):
        for q in ("highest",) + LOWER_PRECISIONS \
                if t.dtype == torch.float32 else ("highest",):
            graph_stage_case(t, t, a_idx, b_idx, seg, n_tiles + 40, q,
                             f"pairs gapped bands, {t.dtype}, {q}")
            cases += 1
        if not torch.equal(mk.TableMasks(t).make().words,
                           mk.tile_masks_plain(t)):
            raise AssertionError(f"masks entry, {t.dtype}, gapped bands: "
                                 "words differ from the plain version's")
        cases += 1
    cnt_c = n_tiles - 1 - (n_tiles - 1) % 4 + 1        # = 1 mod 4
    cut = seg >= cnt_c
    seg_cut = torch.where(cut, symbolic.INT32_MAX, seg)
    a_cut = torch.where(cut, ap.dense.shape[0] - 1, a_idx)
    b_cut = torch.where(cut, ap.dense.shape[0] - 1, b_idx)
    got = pairs_case(ap.dense, ap.dense, a_cut, b_cut, seg_cut, cnt_c + 6,
                     f"pairs cnt_c={cnt_c}", worst)
    if bool(got[0][cnt_c:].any()) or bool(got[1][cnt_c:].any()):
        raise AssertionError("pairs: tiles past cnt_c are not zero")
    cases += 2
    # an engineered stream: a C tile of one pair, one of 70, an empty one,
    # one of 3; 5 tiles in a c_cap of 9
    g = torch.Generator(device=DEV).manual_seed(11)
    per_tile = [1, 70, 0, 3, 2]
    seg_e = torch.repeat_interleave(
        torch.arange(len(per_tile), device=DEV),
        torch.tensor(per_tile, device=DEV)).to(torch.int32)
    pad = 256 - seg_e.numel()
    seg_e = torch.cat([seg_e, torch.full((pad,), symbolic.INT32_MAX,
                                         dtype=torch.int32, device=DEV)])
    idx = torch.randint(0, ap.ntiles, (2, 256), generator=g, device=DEV,
                        dtype=torch.int32)
    idx[:, 256 - pad:] = ap.dense.shape[0] - 1
    got = pairs_case(ap.dense, ap.dense, idx[0].contiguous(),
                     idx[1].contiguous(), seg_e, 9, "pairs 1/70/0/3/2",
                     worst)
    if bool(got[1][2].any()) or bool(got[1][5:].any()):
        raise AssertionError("pairs: a tile without pairs is not zero")
    # the same stream with 2 blocks: each takes several tiles, the empty
    # tile 2 and the tiles past the stream's count are zeroed on the way
    two = pairs_direct(ap.dense, ap.dense, idx[0].contiguous(),
                       idx[1].contiguous(), seg_e, 9, 2)
    if not all(torch.equal(x, y) for x, y in zip(two, got)):
        raise AssertionError("pairs: 2 blocks and one a tile disagree")
    cases += 2
    del ap
    # a float64 stream alone: a C tile of 40 pairs (the float64 entry's slab
    # ring wraps across 320 slabs), an empty tile, tiles of 1, 7 and 2
    # pairs, float64 subnormals in A and B; 5 tiles in a c_cap of 6
    a64 = engineered_tiles(16, seed=41).double()
    b64 = engineered_tiles(16, seed=42).double()
    a64[0, ::7, 3] = 5e-320
    b64[1, 3, ::5] = -5e-320
    per_tile = [40, 0, 1, 7, 2]
    seg_f = torch.repeat_interleave(
        torch.arange(len(per_tile), device=DEV),
        torch.tensor(per_tile, device=DEV)).to(torch.int32)
    pad = 256 - seg_f.numel()
    seg_f = torch.cat([seg_f, torch.full((pad,), symbolic.INT32_MAX,
                                         dtype=torch.int32, device=DEV)])
    idx = torch.randint(0, 16, (2, 256), generator=g, device=DEV,
                        dtype=torch.int32)
    idx[:, 256 - pad:] = 16
    idx[:, 0] = torch.tensor([0, 1], dtype=torch.int32, device=DEV)
    got = pairs_case_f64(a64, b64, idx[0].contiguous(), idx[1].contiguous(),
                         seg_f, 6, "f64 pairs 40/0/1/7/2", worst)
    if bool(got[0][1].any()) or bool(got[1][1].any()) or \
            bool(got[0][5].any()) or bool(got[1][5].any()):
        raise AssertionError("f64 pairs: a tile without pairs is not zero")
    cases += 1
    # banded float64 tiles, whose products the float64 entry mostly skips
    # (16 x 8 blocks that multiply only zeros), with a NaN and an Inf in
    # blocks that would be skipped but for them: the plain version's NaNs
    # and signed Infs
    band = (torch.arange(128, device=DEV)[:, None]
            - torch.arange(128, device=DEV)[None, :]).abs() < 12
    a64 *= band
    b64 *= band
    a64[2, 100, 3] = float("nan")
    b64[3, 90, 5] = float("-inf")
    a64[4, 7, 120] = float("inf")
    got = pairs_case_f64(a64, b64, idx[0].contiguous(), idx[1].contiguous(),
                         seg_f, 6, "f64 pairs, banded, non-finite", worst,
                         hold=macro_hold_ieee)
    if not (bool(torch.isnan(got[0]).any()) and bool(
            torch.isinf(got[0]).any())):
        raise AssertionError("f64 pairs, banded: no NaN or Inf in C")
    skip = f64_skipped_share(a64, b64, idx[0][:50], idx[1][:50])
    if not 0.3 < skip["share"] < 1.0:
        raise AssertionError(f"f64 pairs, banded: skipped share {skip}")
    cases += 1
    del a64, b64

    # an engineered cancellation: C[0, 3] = 1*1 + 1*(-1) is numerically zero
    # and structurally present
    coo = COOMatrix(
        torch.tensor([0, 0, 1, 2], dtype=torch.int32, device=DEV),
        torch.tensor([1, 2, 3, 3], dtype=torch.int32, device=DEV),
        torch.tensor([1.0, 1.0, 1.0, -1.0], device=DEV), (256, 256))
    m = coo_to_macro(coo)
    _np, n_tiles, (_r, _c, a_idx, b_idx, seg) = macro_pairs(m, m)
    num, flag = mk.accumulate_macro_pairs(m.dense, m.dense, a_idx, b_idx,
                                          seg, 256)
    if (float(num[0, 0, 3]) != 0.0 or int(flag[0, 0, 3]) != 1
            or int(M.macro_structure(flag)[-1]) != 1):
        raise AssertionError(
            f"cancellation: value {float(num[0, 0, 3])}, flag "
            f"{int(flag[0, 0, 3])}, C_nnz {int(M.macro_structure(flag)[-1])}")
    cases += 1
    # the same through the float64 entry
    m64 = coo_to_macro(coo, dtype=torch.float64)
    num, flag = mk.accumulate_macro_pairs(m64.dense, m64.dense, a_idx, b_idx,
                                          seg, 256)
    if (num.dtype != torch.float64 or float(num[0, 0, 3]) != 0.0
            or int(flag[0, 0, 3]) != 1
            or int(M.macro_structure(flag)[-1]) != 1):
        raise AssertionError(f"cancellation, float64: value "
                             f"{float(num[0, 0, 3])}, flag "
                             f"{int(flag[0, 0, 3])}")
    cases += 1
    # the device alone picks the path: tiles of a dtype an entry does not
    # take raise on the card (float16 anywhere; float64 in the class
    # entries), they do not take the plain version
    m16 = coo_to_macro(coo, dtype=torch.float16)
    slabs = fresh_slabs(8)
    tables = st.class_tables(((1, 1, 1, 1, (0,), (0,), 0),), DEV)[0]
    bases = torch.zeros(2, dtype=torch.int32, device=DEV)
    for call in (
            lambda: mk.accumulate_macro_pairs(m16.dense, m16.dense, a_idx,
                                              b_idx, seg, 256),
            lambda: mk.class_call2(*slabs, m64.dense, m64.dense, bases, 1, 1,
                                   1, 1, (0,), (0,), 0, 1, tables=tables),
            lambda: mk.class_call(*slabs, m64.dense, m64.dense, bases, 1, 1,
                                  1, 1, (0,), (0,), 0, tables=tables)):
        try:
            call()
        except NotImplementedError:
            cases += 1
        else:
            raise AssertionError("tiles of a dtype the entry does not take "
                                 "did not raise")
    emit("macro_kernel_check", cases=cases, max_abs_err=worst, plans=info,
         worst_over_bound={k: WORST_OVER.get(k) for k in worst},
         precisions=("highest",) + LOWER_PRECISIONS,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         flags_dtype="uint8",
         bound="abs err <= 1e-5 * sum|a*b| + 1e-6 (float32 dot product), "
               "<= 1e-12 * sum|a*b| (the float64 entry); flags equal "
               "exactly, the float64 entry's also to the float32 entry's")
    return worst


# --------------------------------------------------------------------------
# end-to-end paths

def scipy_square(coo, with_abs=False):
    """scipy's A@A as canonical COO; with_abs also returns |A|@|A| in the
    same entry order (same structure: absolute values never cancel)."""
    s = coo.to_scipy().tocsr().astype(np.float64)
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


def check_coo(rows, cols, vals, ref, what, f64=False):
    """Exact structure, finite values within the float32 dot-product bound
    (with ``f64``: float64 values within the float64 bound).  Returns
    (entries outside rtol*|want|+atol, max error over the bound)."""
    want, order, mag = ref
    rtol, atol, label = (F64_RTOL, F64_ATOL, "float64") if f64 \
        else (COO_RTOL, COO_ATOL, "float32")
    if f64 and vals.dtype != np.float64:
        raise AssertionError(f"{what}: values are {vals.dtype}")
    if len(rows) != want.nnz:
        raise AssertionError(f"{what}: C_nnz {len(rows)} != {want.nnz}")
    if not (np.array_equal(rows, want.row[order])
            and np.array_equal(cols, want.col[order])):
        raise AssertionError(f"{what}: sorted COO structure differs")
    if not np.all(np.isfinite(vals)):
        raise AssertionError(f"{what}: non-finite values")
    err = np.abs(vals - want.data[order])
    ratio = float((err / (rtol * mag + atol)).max())
    if ratio > 1.0:
        raise AssertionError(f"{what}: values exceed the {label} "
                             f"dot-product bound by {ratio}x")
    cancelled = int((err > rtol * np.abs(want.data[order]) + atol).sum())
    return cancelled, ratio


def record_times(rec):
    return {k: getattr(rec, k) for k in (
        "a_conversion_kernel_time", "b_conversion_kernel_time", "step1_time",
        "step2_time", "step3_time", "pem_spgemm_time", "steady_state_time",
        "pipelined_time", "gflops", "steady_gflops", "pipelined_gflops")}


def phase_default_path(coo_pl, want_pl):
    """run_benchmark with the default configuration on the three matrices;
    returns the dedup entry's launch count of the powerlaw-1M run and the
    three matrices.  The steady and pipelined tiers replay the multiply as
    one CUDA graph (ops.fixed.BinnedElementPlan)."""
    cfg = SpGEMMConfig(engine="auto")
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rec, res = run_benchmark(coo_pl, "powerlaw-1M", cfg, verbose=False)
    launches = path_launches(ss.LAUNCHES)
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

    coos = {"powerlaw-1M": coo_pl}
    for name in ("rmat-16", "uniform-1M"):
        coo = coos[name] = MATRICES[name]()
        want_nnz = int(scipy_square(coo).nnz)
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rec, res = run_benchmark(coo, name, cfg.with_(repeat=3),
                                 verbose=False)
        if res.c_nnz != want_nnz:
            raise AssertionError(f"{name} C_nnz {res.c_nnz} != scipy "
                                 f"{want_nnz}")
        emit("default_path", matrix=name, flop=rec.flop, c_nnz=res.c_nnz,
             scipy_c_nnz=want_nnz, jax_recorded_c_nnz=RECORDED_C_NNZ[name],
             launches=path_launches(ss.LAUNCHES),
             times_ms=record_times(rec),
             peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        del res
    return launches["segment_dedup"], coos


def sparse_mm_ms(coo):
    """ms of torch.sparse.mm(A, A) with A in CSR: the library's product of
    the same matrix from another format.  A yardstick only: the port never
    calls it."""
    n = coo.shape[0]
    m = torch.sparse_coo_tensor(
        torch.stack([coo.rows.long(), coo.cols.long()]), coo.vals,
        (n, n)).coalesce().to_sparse_csr()
    return time_ms(lambda: torch.sparse.mm(m, m), 3)


def phase_dia_path():
    """The four DIA matrices of the suite through run_benchmark with
    engine="auto", at full size.  Returns, for the two matrices the kernel
    rows are timed at, {name: dict(launch counts of the run, operand, plan
    maps, max abs err against the plain path or None, library ms or None)}."""
    cfg = SpGEMMConfig(engine="auto", repeat=5)
    kept = {}
    for name, args in DIA_MATRICES.items():
        want_nnz, want_flop, want_mode = DIA_RECORDED[name]
        coo = banded_device(**args)
        n = args["n"]
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rec, res = run_benchmark(coo, name, cfg, verbose=False)
        launches = path_launches(dk.LAUNCHES)
        if res.engine != "dia":
            raise AssertionError(f"{name}: engine {res.engine!r}, not 'dia'")
        offs = tuple(int(x) for x in D.diag_offsets(coo))
        dc_list, idx_map = D._plan_maps(offs, offs)
        mode = dk.dia_mode(offs, offs, dc_list)
        if mode != want_mode or res.dia_dc != dc_list:
            raise AssertionError(f"{name}: mode {mode!r}, expected "
                                 f"{want_mode!r}")
        other = "pairs" if mode == "dense" else "dense"
        if (launches[f"dia_multiply_{mode}"] <= 0
                or launches[f"dia_multiply_{other}"] != 0):
            raise AssertionError(f"{name}: launches {launches}")
        if res.c_nnz != want_nnz or rec.flop != want_flop:
            raise AssertionError(
                f"{name}: C_nnz {res.c_nnz} (recorded {want_nnz}), flop "
                f"{rec.flop} (recorded {want_flop})")
        if mode == "dense":                 # full bands: a closed form
            closed = sum(n - abs(dc) for dc in dc_list)
            if res.c_nnz != closed:
                raise AssertionError(f"{name}: C_nnz {res.c_nnz} != {closed}")
        info = dict(matrix=name, mode=mode, flop=rec.flop, c_nnz=res.c_nnz,
                    jax_recorded_c_nnz=want_nnz, bands=len(offs),
                    c_bands=len(dc_list), launches=launches,
                    replayed_launches=dict(graphs.REPLAYED),
                    times_ms=record_times(rec),
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        a = D.coo_to_dia(coo)
        err = library = None
        if name in DIA_SCIPY:
            library = sparse_mm_ms(coo)
            info.update(sparse_mm_csr_ms=library)
            c = res.to_coo()
            ref = scipy_square(coo, with_abs=True)
            cancelled, ratio = check_coo(c.rows, c.cols, c.vals, ref, name)
            info.update(scipy_c_nnz=len(c.rows), coo_equal=True,
                        values_worst_over_bound=ratio,
                        values_outside_plain_rtol=cancelled)
            del c
        else:
            kw = dict(offs_a=offs, idx_map=idx_map, dc_count=len(dc_list),
                      n_out=n)
            want = D._dia_multiply_torch(a.bands, a.bands, **kw)
            bound = dia_bound(a.bands, a.bands, offs, idx_map, len(dc_list),
                              n)
            err = dia_hold((res.vals, res.c_counts), want, bound,
                           f"{name} against the plain path")
            info.update(plain_path_equal=True, max_abs_err=err)
            del want, bound
        emit("dia_path", **info)
        del res, coo
        if name in ("pairbands-500k", "banded16-1M", "banded128-1M"):
            kept[name] = dict(launches=launches, a=a, offs=offs,
                              dc_list=dc_list, idx_map=idx_map, err=err,
                              library_ms=library, times=info["times_ms"],
                              ref=ref if name == "pairbands-500k" else None)
        ref = None
        del a
        torch.cuda.empty_cache()
    return kept


def phase_kernel_sort_path(coo_pl, want_pl):
    """powerlaw-1M through the chunk-granular plan and the sort+dedup
    entry; returns (launch count, the plan)."""
    a = coo_to_tiled(coo_pl)
    b = coo_to_tiled(coo_pl, with_tmasks=True)
    plan = binned.build_plan_device(a, b, pack=False)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    stream = binned.binned_multiply(plan, vmem_sort=True)
    c_nnz = int(stream.c_nnz)
    ms = (time.perf_counter() - t0) * 1e3
    launches = path_launches(ss.LAUNCHES)
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


def rmat16_dedup_reading():
    """The dedup entry over every launch of one steady multiply of
    rmat-16's default plan (each packed class and the residual call, with
    the inputs the path gives them): each held against its plain version,
    then timed alone; times and bytes bounds summed."""
    calls = k1_split.rmat16_dedup_calls()
    ms = wrapper = plain = 0.0
    nbytes = slots = 0
    worst = 0.0
    for i, (keys, vals, abits) in enumerate(calls):
        worst = max(worst, hold_dedup(keys, vals, abits,
                                      f"dedup, rmat-16 launch {i}",
                                      relative=False)[1])
        call = lambda: ss.segment_dedup(keys, vals, abits)
        ms += graph_ms(call)
        wrapper += time_ms(call)
        plain += time_ms(lambda: ss.segment_dedup_plain(keys, vals, abits), 3)
        nbytes += k1_split.dedup_bytes(keys, abits)
        slots += keys.numel()
    return {"launches": len(calls), "slots": slots, "ms": ms,
            "wrapper_ms": wrapper, "plain_ms": plain, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "worst_over_bound": worst,
            "timed": "each launch alone, summed: ms by CUDA-graph replay "
                     "(device only), wrapper_ms by CUDA events around "
                     "wrapper calls (host-bound for the small classes)"}


def phase_kernels(plan_cg, a, b, launches, check_err, replayed):
    # sort entry: the sort bucket with the most slots among those the
    # kernel takes, with the inputs the path gives it
    cols, vals, w = k1_split.largest_sort_bucket(plan_cg)
    r, mw = cols.shape
    got = ss.segment_sort_dedup(cols, vals, rounds=1, presorted_w=w)
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
        "ms": graph_ms(lambda: ss.segment_sort_dedup(
            cols, vals, rounds=1, presorted_w=w)),
        "wrapper_ms": time_ms(lambda: ss.segment_sort_dedup(
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
        # recorded at the capture of the steady multiply's CUDA graph
        "launches_per_replayed_multiply":
            replayed["powerlaw-1M", False]["segment_sort_dedup"],
    }
    del cols, vals, got, want

    # dedup entry: the packed class with the most slots of the default plan
    plan = binned.build_plan_device(a, b)
    torch.cuda.synchronize()
    reset_launch_counts()
    int(binned.binned_multiply(plan).c_nnz)
    per_multiply = dict(ss.LAUNCHES)    # counted over this one multiply
    p = max(plan.packed, key=lambda x: x.keys.numel())
    err_dedup, over_dedup = hold_dedup(p.keys, p.bbits, p.abits,
                                       "dedup entry at the largest class")
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
        "ms": graph_ms(lambda: ss.segment_dedup(p.keys, p.bbits, p.abits)),
        "wrapper_ms": time_ms(lambda: ss.segment_dedup(p.keys, p.bbits,
                                                       p.abits)),
        "plain_ms": time_ms(lambda: ss.segment_dedup_plain(
            p.keys, p.bbits, p.abits)),
        "bound_ms": max(bound_b, bound_o) * 1e3,
        "bound_by": "bytes" if bound_b >= bound_o else "operations",
        "library_ms": None,
        "shape": [int(p.keys.shape[0]), p.l], "fused_product": True,
        "worst_over_bound": over_dedup,
        "bytes": bytes_dedup, "operations": ops_dedup,
        "launches_per_multiply": per_multiply["segment_dedup"],
        "launches_per_replayed_multiply": {
            m: replayed[m, True]["segment_dedup"]
            for m in ("powerlaw-1M", "rmat-16", "uniform-1M")},
        "packed_classes": len(plan.packed),
        "rmat16_multiply": rmat16_dedup_reading(),
    }
    for row in (sort_row, dedup_row):
        row["kernel_ms"] = row["ms"]
    return [sort_row, dedup_row]


def dia_kernel_fn(a, offs, dc_list, mode, values_only):
    """One A*A multiply through the wrapper, with the tables uploaded once
    as a plan does."""
    n = a.shape[1]
    tables = dk.dia_tables(offs, offs, dc_list, mode, a.device)
    return lambda: dk.dia_multiply(
        a, a, offs_a=offs, offs_b=offs, dc_list=dc_list, n_out=n, mode=mode,
        values_only=values_only, tables=tables)


def dia_times(a, offs, dc_list, idx_map, mode, n_plain):
    """(kernel ms with counts, values-only, plain ms with counts,
    values-only) of one A*A multiply: the kernel's device time by CUDA-graph
    replay (graph_ms: the small kernels are shorter than the wrapper's host
    work), the plain version's by CUDA events around its calls."""
    kw = dict(offs_a=offs, idx_map=idx_map, dc_count=len(dc_list),
              n_out=a.shape[1])

    def plain(values_only):
        return lambda: D._dia_multiply_torch(a, a, values_only=values_only,
                                             **kw)

    return (graph_ms(dia_kernel_fn(a, offs, dc_list, mode, False)),
            graph_ms(dia_kernel_fn(a, offs, dc_list, mode, True)),
            time_ms(plain(False), n_plain), time_ms(plain(True), n_plain))


def dia_wrapper_ms(a, offs, dc_list, mode):
    """(with counts, values-only) ms a wrapper call by CUDA events around
    the calls: the host's time where it exceeds the kernel's."""
    return tuple(time_ms(dia_kernel_fn(a, offs, dc_list, mode, vo))
                 for vo in (False, True))


# There is no PyTorch call on band stacks.  Where the path phase timed
# torch.sparse.mm on the row's own matrix in CSR (the small matrices), the
# row carries that as a yardstick; elsewhere it carries none.
LIBRARY_COVERS = {True: "torch.sparse.mm(A, A) on this matrix in CSR: "
                        "another format",
                  False: "none: no PyTorch call takes band stacks"}
# cuSPARSE's SpGEMM refuses banded64-1M and banded128-1M (insufficient
# resources in cusparseSpGEMM_workEstimation), so the dense entry's row
# carries the library call, and the kernel beside it, at banded16-1M.
DENSE_LIBRARY_MATRIX = "banded16-1M"


def dense_staging_fields(offs, n, word, device):
    """What the dense entry's launch at this matrix stages into shared
    memory (dk.dense_staging of the launch shape the wrapper uses): bytes,
    and words a column range against the useful A and B words; beside it
    the same ratio under the launch rule of commit 5b9f52f, which staged a
    window a row block and chunk (k2_split.parent_staging)."""
    dcn = len(D._plan_maps(offs, offs)[0])
    sh = dk.dense_launch(offs, len(offs), dcn, word, n, dk.sm_count(device))
    st = dk.dense_staging(offs, len(offs), dcn, sh)
    parent = k2_split.parent_staging(
        offs, len(offs), dcn, n,
        k4_split.parent_dense_launch(offs, len(offs), dcn, word))
    return {"staged_bytes": st["staged_bytes"],
            "staging_factor": st["factor"],
            "staging_factor_parent_rule": parent["factor"],
            "staged_words_per_range": st["per_range"],
            "useful_words_per_range": st["useful_per_range"],
            "launch": {k: sh[k] for k in ("threads", "L", "passes", "grid_y",
                                          "chunks", "strip", "grid_x",
                                          "smem_bytes")}}


def dia_kernel_row(name, matrix, kept, check_err, per_multiply):
    launches, a, offs, dc_list, idx_map, err = (
        kept[k] for k in ("launches", "a", "offs", "dc_list", "idx_map",
                          "err"))
    mode = name.rsplit("_", 1)[1]
    if err is None:             # the path check was scipy's: hold it here
        n = a.n
        got = dk.dia_multiply(
            a.bands, a.bands, offs_a=offs, offs_b=offs, dc_list=dc_list,
            n_out=n, mode=mode,
            tables=dk.dia_tables(offs, offs, dc_list, mode, a.device))
        want = D._dia_multiply_torch(a.bands, a.bands, offs_a=offs,
                                     idx_map=idx_map, dc_count=len(dc_list),
                                     n_out=n)
        err = dia_hold(got, want, dia_bound(a.bands, a.bands, offs, idx_map,
                                            len(dc_list), n),
                       f"{name} at {matrix}")
        del got, want
    ms, ms_vo, plain, plain_vo = dia_times(a.bands, offs, dc_list, idx_map,
                                           mode, n_plain=3)
    wrapper = dia_wrapper_ms(a.bands, offs, dc_list, mode)
    flop = DIA_RECORDED[matrix][1]
    c_bytes = 4 * len(dc_list) * a.n
    # the timed function is A*A on one band stack (as on the main path,
    # where the harness passes the same operand twice): it is read once
    in_bytes = 4 * a.bands.numel()

    def bound(with_counts):
        by = (in_bytes + c_bytes * (2 if with_counts else 1)) \
            / HBM_BYTES_PER_S
        ops = flop * (4 if with_counts else 2) / FP32_OPS_PER_S
        return max(by, ops) * 1e3, "bytes" if by >= ops else "operations"

    (b_ms, b_by), (bv_ms, bv_by) = bound(True), bound(False)
    staging = dense_staging_fields(offs, a.n, 4, a.device) \
        if mode == "dense" else {}
    return {
        **staging,
        "name": name, "route": "cuda", "source": DIA_SOURCE,
        "replaces": "pem_spgemm_tpu/ops/pallas_dia.py:"
                    + ("140" if mode == "dense" else "171"),
        "launches": launches[name],
        "max_abs_err": max(err, check_err[name]),
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": kept["library_ms"],
        "library_covers": LIBRARY_COVERS[kept["library_ms"] is not None],
        "values_only_ms": ms_vo, "values_only_plain_ms": plain_vo,
        "values_only_bound_ms": bv_ms, "values_only_bound_by": bv_by,
        "matrix": matrix, "shape": [len(offs), a.n], "c_rows": len(dc_list),
        "products": flop, "bytes": in_bytes + 2 * c_bytes,
        "operations": 4 * flop, "launches_per_multiply": per_multiply,
        "kernel_ms": ms, "timed_by": "CUDA-graph replay of 20 wrapper calls",
        "wrapper_ms": wrapper[0], "values_only_wrapper_ms": wrapper[1],
    }


def all_launches():
    return {**dict(ss.LAUNCHES), **dict(dk.LAUNCHES), **dict(mk.LAUNCHES),
            **dict(pr.LAUNCHES)}


def dia_steady_launches(a, entry):
    """The launches of one steady multiply of a DIA plan for a*a: its first
    run counts, its second captures the CUDA graph, and a replay must pass
    no wrapper; the launches a multiply are those recorded at capture,
    which must be one of ``entry`` and nothing else."""
    plan = D.make_dia_plan(a, a)
    plan.run(a, a)
    plan.run(a, a)
    reset_launch_counts()
    plan.run(a, a)
    torch.cuda.synchronize()
    if any(all_launches().values()):
        raise AssertionError(f"{entry}: a replay went through a wrapper: "
                             f"{all_launches()}")
    got = plan.launches
    if got.get(entry, 0) != 1 or sum(got.values()) != 1 \
            or graphs.REPLAYED != nonzero(got):
        raise AssertionError(f"{entry}: a replayed multiply launches {got}, "
                             f"counted {graphs.REPLAYED}")
    return got[entry]


def phase_dia_kernels(kept, check_err):
    """Both DIA entries at the largest shape the path gives them, and the
    small-product case (tridiagonal, n = 1,000,000) that a gate between
    kernel and plain path would be decided on."""
    rows = []
    for name, matrix in (("dia_multiply_dense", "banded128-1M"),
                         ("dia_multiply_pairs", "pairbands-500k")):
        a = kept[matrix]["a"]
        per_multiply = dia_steady_launches(a, name)
        rows.append(dia_kernel_row(name, matrix, kept[matrix], check_err,
                                   per_multiply))
    lib = kept[DENSE_LIBRARY_MATRIX]
    ms, ms_vo, _plain, _plain_vo = dia_times(
        lib["a"].bands, lib["offs"], lib["dc_list"], lib["idx_map"], "dense",
        n_plain=1)
    rows[0].update(
        library_ms=lib["library_ms"], library_matrix=DENSE_LIBRARY_MATRIX,
        library_kernel_ms=ms, library_kernel_values_only_ms=ms_vo,
        library_covers="torch.sparse.mm(A, A) in CSR at banded16-1M, beside "
                       "the kernel's time there (library_kernel_ms): "
                       "cuSPARSE refuses banded64-1M and banded128-1M")
    n = 1_000_000
    offs = (-1, 0, 1)
    a = make_bands(offs, n, n, seed=3, zero_frac=0.0)
    dc_list, idx_map = D._plan_maps(offs, offs)
    small = {}
    for mode in ("dense", "pairs"):
        ms, ms_vo, plain, plain_vo = dia_times(a, offs, dc_list, idx_map,
                                               mode, n_plain=20)
        small[mode] = {"ms": ms, "values_only_ms": ms_vo}
    small["plain"] = {"ms": plain, "values_only_ms": plain_vo}
    emit("dia_small_product", shape=[3, n], c_rows=len(dc_list), times=small)
    return rows


# --------------------------------------------------------------------------
# the cached DIA multiply as one CUDA graph

def dia_eager(plan, a):
    """One eager values-only multiply of a*a through the plan's kernel
    entry: what a cached plan's run launched before its graph."""
    return plan._multiply(a, a, values_only=True)[0]


def same_bits(got, want, what):
    if got.dtype != want.dtype or not torch.equal(
            got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"{what}: the replay differs from the eager "
                             "multiply")


def dia_graph_case(name, a, steady, n=50):
    """One DIA matrix's cached plan: the replayed values-only multiply
    against the eager one, bit for bit, before and after three rounds of
    band values changed in place and after two runs on other band stacks
    (the first multiplies eagerly, the second captures again); launches
    recorded at capture, none through a wrapper on a replay and those
    counted in ops.graphs.REPLAYED; peak memory and host-clock times of
    both, in turns; the device time of one replay and of the kernel alone,
    beside the harness's steady tier (``steady``, host-clock ms); and what
    the first and the second run on new band stacks cost, beside one eager
    multiply (host clock, synced, 3 rounds)."""
    what = f"{name} {str(a.bands.dtype).split('.')[-1]}"
    plan = D.make_dia_plan(a, a)
    c_nnz = int(plan.run(a, a)[2])          # eager, with counts: cached
    entry = f"dia_multiply_{plan.kernel_mode}" + (
        "_f64" if a.bands.dtype == torch.float64 else "")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager = dia_eager(plan, a)
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated() - base
    del eager
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    plan.run(a, a)                  # the eager warm-up, capture, replay
    captured = dict(dk.LAUNCHES)
    reset_launch_counts()
    c = plan.run(a, a)[0]
    torch.cuda.synchronize()
    if any(all_launches().values()):
        raise AssertionError(f"{what}: a replay went through a wrapper")
    peak_graph = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    launches = plan.launches
    if captured != {k: 2 * v for k, v in launches.items()} or \
            launches[entry] != 1 or sum(launches.values()) != 1 or \
            graphs.REPLAYED != nonzero(launches):
        raise AssertionError(f"{what}: capture launches {launches}, eager "
                             f"warm-up + capture {captured}, a replay "
                             f"counted {graphs.REPLAYED}")
    same_bits(c, dia_eager(plan, a), what)
    g = torch.Generator(device=DEV).manual_seed(7)
    for r in range(3):
        a.bands.mul_(torch.empty(a.bands.shape, dtype=a.bands.dtype,
                                 device=DEV).uniform_(0.5, 2.0, generator=g))
        c = plan.run(a, a)[0]
        same_bits(c, dia_eager(plan, a), f"{what}, changed {r}")

    def runs_on(x, tag):
        """Two runs on x: the first eager, the second captures again."""
        for k, want_new in ((0, False), (1, True)):
            before = plan._graph["captured"]
            c = plan.run(x, x)[0]
            if (plan._graph["captured"] is not before) != want_new:
                raise AssertionError(f"{what}, {tag}: run {k} captured "
                                     f"{'no' if want_new else 'a'} graph")
            same_bits(c, dia_eager(plan, x), f"{what}, {tag}, run {k}")

    # other band stacks (the same structure), and back
    other = dataclasses.replace(a, bands=a.bands * 0.75)
    runs_on(other, "other operands")
    del other
    runs_on(a, "operands back")
    times = turns_ms(
        [("eager", lambda: dia_eager(plan, a)[0, 0]),
         ("graph", lambda: plan.run(a, a)[0][0, 0]),
         ("graph", lambda: plan.run(a, a)[0][0, 0]),
         ("eager", lambda: dia_eager(plan, a)[0, 0])], n)
    replay_ms = time_ms(lambda: plan.run(a, a), n)
    kernel_ms = graph_ms(lambda: dia_eager(plan, a))
    graph_synced = min(t["synced_ms"] for t in times if t["path"] == "graph")
    eager_synced = min(t["synced_ms"] for t in times if t["path"] == "eager")
    # a run on new band stacks: the first multiplies eagerly, the second
    # multiplies eagerly under the sync check, captures and replays
    cost = {"eager_multiply": [], "first_run": [], "capture_run": []}
    for _ in range(3):
        fresh = dataclasses.replace(a, bands=a.bands.clone())
        for key, fn in (("eager_multiply", lambda: dia_eager(plan, fresh)),
                        ("first_run", lambda: plan.run(fresh, fresh)),
                        ("capture_run", lambda: plan.run(fresh, fresh))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            cost[key].append((time.perf_counter() - t0) * 1e3)
        del fresh
    emit("dia_graph_replay", matrix=name, dtype=what.split()[-1],
         c_nnz=c_nnz, entry=entry, bit_equal=True, changed_value_rounds=3,
         recaptured_on_other_operands=True, launches_per_multiply=launches,
         peak_mem_gb={"eager": peak_eager / 2**30,
                      "graph_capture_and_replay": peak_graph / 2**30,
                      "graph_held": held / 2**30},
         times=times, replay_faster=graph_synced < eager_synced,
         replay_device_ms=replay_ms, kernel_device_ms=kernel_ms,
         harness_steady_ms=steady,
         harness_steady_over_kernel_ms=steady - kernel_ms,
         new_operands_ms=cost)
    del plan
    torch.cuda.empty_cache()


def phase_dia_graph_replay(kept):
    """pairbands-500k (float32 and float64), banded16-1M and banded128-1M;
    ``kept`` the float32 matrices of phase dia_path and, under
    "pairbands-500k f64", the float64 run's steady time."""
    for name in ("pairbands-500k", "banded16-1M", "banded128-1M"):
        dia_graph_case(name, kept[name]["a"],
                       kept[name]["times"]["steady_state_time"])
    a64 = D.coo_to_dia(banded_device(**DIA_MATRICES["pairbands-500k"]),
                       dtype=torch.float64)
    dia_graph_case("pairbands-500k", a64, kept["pairbands-500k f64"])


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


def run_profile(matrix, no_pack, n, graph=False):
    """pack=True plan, or with no_pack the chunk-granular plan with the
    sort+dedup kernel route on.  With ``graph``: the eager multiply against
    its CUDA graph replay (vmem_sort on, as the harness's plan has it)."""
    if graph:
        return run_profile_graph(matrix, no_pack, n)
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
    reset_launch_counts()
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

    profile_device(matrix, multiply, n)


def run_profile_graph(matrix, no_pack, n):
    """Steady multiplies of one element matrix, eager and replayed as one
    CUDA graph, in turns in one process: host-clock synced and queued ms,
    peak device memory, and torch.profiler's device-busy time and idle
    share of each (eager, graph, graph, eager)."""
    from pem_spgemm_tpu_torch.ops.fixed import BinnedElementPlan
    coo = MATRICES[matrix]()
    a = coo_to_tiled(coo)
    b = coo_to_tiled(coo, with_tmasks=True)
    plan = binned.build_plan_device(a, b, pack=not no_pack)
    gp = BinnedElementPlan(plan=plan, vmem_sort=True)

    def eager():
        return binned.binned_multiply(plan, vmem_sort=True).c_nnz

    def replay():
        return gp.run(a, b)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    int(eager())
    peak_eager = (torch.cuda.max_memory_allocated() - base) / 2**30
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    c_nnz = int(replay())
    peak_graph = (torch.cuda.max_memory_allocated() - base) / 2**30
    emit("profile_graph_setup", matrix=matrix, pack=not no_pack,
         c_nnz=c_nnz, launches_per_multiply=gp.launches,
         peak_mem_gb={"eager": peak_eager, "graph": peak_graph},
         times=turns_ms([("eager", eager), ("graph", replay),
                         ("graph", replay), ("eager", eager)], n))
    for name, fn in (("eager", eager), ("graph", replay), ("graph", replay),
                     ("eager", eager)):
        profile_device(f"{matrix} {name}", fn, n)


def profile_device(matrix, multiply, n):
    """torch.profiler over n queued multiplies: device-busy time, the idle
    share of the wall time, device operations per multiply and the kernels
    that take most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            last = multiply()
        last.reshape(-1)[0].item()
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

    def per_multiply(pattern):
        return sum(c for k, c, _ in rows if re.search(pattern, k)) / n

    emit("profile_device", matrix=matrix, wall_ms=wall * 1e3,
         device_busy_ms=busy_us / 1e3 / n,
         idle_share=1.0 - busy_us / 1e6 / (wall * n),
         device_ops_per_multiply=sum(c for _, c, _ in rows) / n,
         int_fills_per_multiply=per_multiply(r"FillFunctor<int>"),
         int_adds_per_multiply=per_multiply(
             r"(CUDAFunctor_add|AddFunctor)<int>"),
         calls_by_kernel={k[:200]: c / n for k, c, _ in rows},
         top=[{"name": k[:80], "calls_per_multiply": c / n,
               "ms_per_multiply": t / 1e3 / n} for k, c, t in rows[:12]])


def run_profile_dia(matrix, n):
    """A DIA matrix's steady multiply: the cached plan's CUDA graph
    replayed (values-only kernel, the counts come from the plan's first
    run; the launches a multiply are those recorded at capture)."""
    coo = banded_device(**DIA_MATRICES[matrix])
    a = D.coo_to_dia(coo)
    del coo
    plan = D.make_dia_plan(a, a)
    out = plan.run(a, a)                    # values + counts, cached
    emit("profile_setup", matrix=matrix, mode=plan.kernel_mode,
         bands=a.nbands, c_bands=len(plan.dc_list), c_nnz=int(out[2]))
    del out
    plan.run(a, a)                          # captures the CUDA graph

    def multiply():
        return plan.run(a, a)[0]

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        multiply()
        torch.cuda.synchronize()
    synced = (time.perf_counter() - t0) / n
    if any(dk.LAUNCHES.values()):
        raise AssertionError(f"{matrix}: a replay went through a wrapper")
    t0 = time.perf_counter()
    for _ in range(n):
        last = multiply()
    torch.cuda.synchronize()
    queued = (time.perf_counter() - t0) / n
    del last
    emit("profile_steady", matrix=matrix, synced_ms=synced * 1e3,
         queued_ms=queued * 1e3, device_ms=time_ms(multiply, n),
         kernel_launches_per_multiply=plan.launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    profile_device(matrix, multiply, n)


# --------------------------------------------------------------------------
# the Macro128 engine end to end, and its kernel rows

def row_nnz_of_tiles(c_tile_row, c_flags, n_macro_rows):
    """Per-row nnz of C from its tile form, on the device."""
    per = (c_flags > 0).sum(dim=2, dtype=torch.int64)          # (cap, 128)
    live = c_tile_row.long() < n_macro_rows
    rows = (c_tile_row.long()[:, None] * 128
            + torch.arange(128, device=per.device)[None, :])
    out = torch.zeros(n_macro_rows * 128, dtype=torch.int64,
                      device=per.device)
    out.index_add_(0, rows[live].reshape(-1), per[live].reshape(-1))
    return out


def scipy_row_nnz(coo, rows):
    """Structural nnz of the rows ``rows`` of A@A from scipy: the product of
    the patterns, whose all-positive sums never cancel."""
    s = coo.to_scipy().tocsr()
    s.data = np.ones_like(s.data)
    return np.diff((s[rows] @ s).tocsr().indptr)


def bmm_at(precision):
    """(torch.bmm at ``precision``, what it is): full float32 at "highest";
    at "high" float32 operands with TF32 allowed (set here, inside the call,
    and restored: the port never sets it); at "default" bfloat16 operands
    with float32 output (``out_dtype``)."""
    if precision == "high":
        def fn(ad, bd):
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return torch.bmm(ad, bd)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old
        return fn, "torch.bmm, float32 operands, allow_tf32 set for the call"
    if precision == "default":
        return (lambda ad, bd: torch.bmm(ad.bfloat16(), bd.bfloat16(),
                                         out_dtype=torch.float32),
                "torch.bmm, bfloat16 operands, float32 output")
    M.require_full_fp32()
    return torch.bmm, "torch.bmm, float32"


def bmm_cast(dtype, precision):
    """The operands' dtype of the torch.bmm yardstick for tiles of
    ``dtype`` at ``precision``: float64 tiles keep float64 (the float64
    entries' rows name a float64 product), float32 tiles go bfloat16 at
    "default" and stay float32 otherwise."""
    if dtype == torch.float64:
        return torch.float64
    return torch.bfloat16 if precision == "default" else torch.float32


def bmm_ms(a_dense, b_dense, pa, pb, per=16_384, precision="highest"):
    """ms of torch.bmm over the pre-gathered (P, 128, 128) operands at
    ``precision`` (bmm_at; the operands are cast as bmm_cast says before
    the timing), the products only (no gather, no sum per C tile), taken
    ``per`` pairs at a time so the gathered copies fit beside the run's
    own tensors.  A yardstick: the port never calls it on this path."""
    fn, _what = bmm_at(precision)
    cast = bmm_cast(a_dense.dtype, precision)
    total = 0.0
    for lo in range(0, pa.numel(), per):
        ad = a_dense[pa[lo:lo + per].long()].to(cast)
        bd = b_dense[pb[lo:lo + per].long()].to(cast)
        total += time_ms(lambda: fn(ad, bd), 3)
        del ad, bd
    return total


def precision_bounds(a, pa, pb, n_pairs, c_rows, precision):
    """Bounds of an entry's work at "high" / "default": the larger of the
    operations (2 * 128^3 a pair, one pass at the TF32 or the bfloat16
    tensor-core rate) and the bytes (each distinct operand tile read once,
    every C row written once, values and flags)."""
    ops = TILE_FLOP * n_pairs
    rate = TF32_OPS_PER_S if precision == "high" else BF16_OPS_PER_S
    tiles = int(torch.unique(torch.cat([pa, pb])).numel())
    nbytes = tiles * 128 * 128 * a.dense.element_size() \
        + c_rows * 128 * 128 * 5
    b_o, b_b = ops / rate, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(b_o, b_b) * 1e3,
            "bound_by": "operations" if b_o >= b_b else "bytes",
            "bound_ops_ms": b_o * 1e3, "bound_bytes_ms": b_b * 1e3,
            "operations": ops, "bytes": nbytes, "operand_tiles": tiles,
            "rate": "TF32 495 TFLOP/s" if precision == "high"
                    else "bf16 989 TFLOP/s"}


def precision_row(kernel, name, replaces, matrix, fn, plain_fn, pa, pb, a,
                  n_pairs, c_rows, err, precision, extra):
    """A kernels-line row of an entry at "high" / "default" (kernel
    K4@high, ...; name entry@precision).  ``launches`` is filled in by
    phase precision_path, whose runs are the ones at this precision."""
    _fn, lib_what = bmm_at(precision)
    return {
        "name": prec_key(name, precision), "kernel": f"{kernel}@{precision}",
        "precision": precision, "route": "cuda", "source": MACRO_SOURCE,
        "replaces": replaces, "launches": None, "max_abs_err": err,
        "ms": time_ms(fn), "plain_ms": time_ms(plain_fn, 2),
        **precision_bounds(a, pa, pb, n_pairs, c_rows, precision),
        "library_ms": bmm_ms(a.dense, a.dense, pa, pb, precision=precision),
        "library_covers": lib_what + ", over the pre-gathered (P, 128, 128) "
                          "operands in chunks of 16,384 pairs: the products "
                          "only", "runs_on": "tensor cores, one wgmma a "
                                             "k-step", "matrix": matrix,
        "pairs": n_pairs, "c_rows": c_rows, **extra}


def class_pairs(plan):
    """(pa, pb) int32 on the card: every pair of the plan's class path."""
    pa, pb = [], []
    for (t, p, _ar, _br, a_offs, b_offs, _base), bases in zip(
            plan.classes, plan.class_bases):
        b2 = bases.reshape(-1, 2)
        pa.append((b2[:, :1] + torch.tensor(a_offs, dtype=torch.int32,
                                            device=DEV)[None, :]).reshape(-1))
        pb.append((b2[:, 1:] + torch.tensor(b_offs, dtype=torch.int32,
                                            device=DEV)[None, :]).reshape(-1))
    return torch.cat(pa), torch.cat(pb)


def macro_bounds(a, n_pairs, c_rows):
    """Bounds of a Macro128 entry's work.  Operations: 2 * 128^3 a pair,
    the values' product; the pattern is a bit operation per k-slab in the
    kernel and is not counted.  Bytes: the operand table read once (A @ A
    reads one table) and every C row written once, values and flags.
    bound_ms takes the operations at the FP32 rate; bound_tc_ms the same
    products as three tf32 products each at the TF32 tensor-core rate (the
    3xTF32 split every entry runs), or the bytes where those take longer."""
    ops = TILE_FLOP * n_pairs
    nbytes = a.dense.numel() * 4 + c_rows * 128 * 128 * 5
    b_o, b_b = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    b_tc = 3 * ops / TF32_OPS_PER_S
    return {"bound_ms": max(b_o, b_b) * 1e3,
            "bound_by": "operations" if b_o >= b_b else "bytes",
            "bound_tc_ms": max(b_tc, b_b) * 1e3,
            "bound_tc_by": "operations (3xTF32)" if b_tc >= b_b else "bytes",
            "operations": ops, "tf32_operations": 3 * ops, "bytes": nbytes}


def macro_row(name, replaces, matrix, fn, plain_fn, lib_pairs, a, n_pairs,
              c_rows, launches, per_multiply, err, extra):
    """One row of the kernels line, bounds as macro_bounds counts them."""
    bounds = macro_bounds(a, n_pairs, c_rows)
    ms = time_ms(fn)
    return {
        "name": name, "route": "cuda", "source": MACRO_SOURCE,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": time_ms(plain_fn, 2), **bounds,
        "library_ms": bmm_ms(a.dense, a.dense, *lib_pairs),
        "library_covers": "torch.bmm over the pre-gathered (P, 128, 128) "
                          "operands in chunks of 16,384 pairs: the products "
                          "only, without gather and sum per C tile",
        "runs_on": "tensor cores, 3xTF32", "matrix": matrix,
        "pairs": n_pairs, "c_rows": c_rows, "a_tiles": a.ntiles,
        "launches_per_multiply": per_multiply, "kernel_ms": ms, **extra}


def macro_plan_of(a, cfg):
    """(interactive result, steady plan) of A @ A, as the harness builds
    them."""
    res = SpGEMM(cfg)(a, a)
    plan = make_plan(res, cfg, a, a)
    return res, plan


def hold_macro_output(a, plan, out, what, precision="highest"):
    """The steady output's C tiles against the plain pair accumulation at
    ``precision`` on the card, in the plan's row order: flags equal, values
    in the float32 bound (the same rounded products on both sides).
    Returns the max abs error."""
    n_pairs, n_tiles, (_r, _c, a_idx, b_idx, seg) = macro_pairs(a, a)
    c_cap = -(-n_tiles // 256) * 256
    want = M.accumulate_macro(a.dense, a.dense, a_idx, b_idx, seg, c_cap, 256,
                              precision=precision)
    mag = M.accumulate_macro(a.dense.abs(), a.dense.abs(), a_idx, b_idx, seg,
                             c_cap, 256)[0]
    if isinstance(plan, StencilMacroPlan):
        order = torch.from_numpy(plan.plan.order).to(DEV)
    else:
        order = torch.arange(n_tiles, device=DEV)
    rows = order.numel()
    worst = 0.0
    for lo in range(0, rows, 8192):         # bounded gathers
        o = order[lo:lo + 8192]
        worst = max(worst, macro_hold(
            (out[2][lo:lo + o.numel()], out[3][lo:lo + o.numel()]),
            (want[0][o], want[1][o]), mag[o], what))
    if bool(out[3][rows:].any()):
        raise AssertionError(f"{what}: rows past the last real tile hold "
                             "flags")
    return worst, n_pairs, n_tiles


def pairs_point(a, name, n_pairs, n_tiles, precision="highest"):
    """The pair-stream entry (K4) at this matrix's own pair stream and
    ``precision``, the second point its row is timed at: held against the
    plain version at it (flags equal, values in the float32 bound), then
    kernel, plain version and the bounds as macro_row (precision_bounds
    below "highest") counts them."""
    _np, _nt, (_r, _c, a_idx, b_idx, seg) = macro_pairs(a, a)
    c_cap = -(-n_tiles // 256) * 256
    key = prec_key("macro_accumulate_pairs", precision)
    want = M.accumulate_macro(a.dense, a.dense, a_idx, b_idx, seg, c_cap, 256,
                              precision=precision)
    mag = M.accumulate_macro(a.dense.abs(), a.dense.abs(), a_idx, b_idx, seg,
                             c_cap, 256)[0]
    got = mk.accumulate_macro_pairs(a.dense, a.dense, a_idx, b_idx, seg,
                                    c_cap, precision=precision)
    torch.cuda.synchronize()
    err = 0.0
    for lo in range(0, c_cap, 8192):       # bounded temporaries
        sl = slice(lo, lo + 8192)
        err = max(err, macro_hold((got[0][sl], got[1][sl]),
                                  (want[0][sl], want[1][sl]), mag[sl],
                                  f"{name}: {key} on its pair stream",
                                  key=key))
    del want, mag, got
    torch.cuda.empty_cache()
    pa, pb = a_idx[:n_pairs], b_idx[:n_pairs]
    bounds = macro_bounds(a, n_pairs, c_cap) if precision == "highest" \
        else precision_bounds(a, pa, pb, n_pairs, c_cap, precision)
    return {
        "ms": time_ms(lambda: mk.accumulate_macro_pairs(
            a.dense, a.dense, a_idx, b_idx, seg, c_cap,
            precision=precision)),
        "plain_ms": time_ms(lambda: M.accumulate_macro(
            a.dense, a.dense, a_idx, b_idx, seg, c_cap, 256,
            precision=precision), 2),
        **bounds,
        "library_ms": bmm_ms(a.dense, a.dense, pa, pb, precision=precision),
        "max_abs_err": err, "pairs": n_pairs, "c_rows": c_cap}


def phase_macro_path(check_err, pairbands_ref, repeat=3):
    """wandering64-1M, banded64-1M and pairbands-500k through
    run_benchmark(engine="macro") at full size, and the three kernel rows,
    each timed at the matrix that reaches its entry."""
    cfg = SpGEMMConfig(engine="macro", repeat=repeat)
    rows_out = []
    k4_wandering = None
    for name, make in MACRO_MATRICES.items():
        want_type, want_planner, entry = MACRO_EXPECT[name]
        coo = make()
        n = coo.shape[0]
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rec, res = run_benchmark(coo, name, cfg, verbose=False)
        launches = path_launches(mk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if res.engine != "macro":
            raise AssertionError(f"{name}: engine {res.engine!r}")
        steady_nnz = int(res.cptr[-1])
        if steady_nnz != res.c_nnz:
            raise AssertionError(
                f"{name}: C_nnz {res.c_nnz} on the interactive path, "
                f"{steady_nnz} on the steady path")
        # interactive multiplies through the pair-stream entry, steady ones
        # through the plan's entry; the uniform class entry has no caller
        if (launches[entry] <= 0 or launches["macro_accumulate_pairs"] <= 0
                or launches["macro_class_uniform"] != 0):
            raise AssertionError(f"{name}: launches {launches}")
        info = dict(matrix=name, engine=res.engine, n=n, nnz=coo.nnz,
                    flop=rec.flop, c_nnz=res.c_nnz, steady_c_nnz=steady_nnz,
                    c_tiles=res.c_ntiles, pairs=res.n_pairs,
                    launches=launches, times_ms=record_times(rec),
                    peak_mem_gb=peak)
        if name in DIA_RECORDED:
            info["jax_recorded_c_nnz"] = DIA_RECORDED[name][0]
            if res.c_nnz != DIA_RECORDED[name][0]:
                raise AssertionError(f"{name}: C_nnz {res.c_nnz} != "
                                     f"{DIA_RECORDED[name][0]}")
        if name == "wandering64-1M":
            g = np.random.default_rng(20)
            sample = np.sort(g.choice(n, MACRO_SAMPLE_ROWS, replace=False))
            got = row_nnz_of_tiles(res.c_tile_row, res.c_counts,
                                   -(-n // 128))[
                torch.from_numpy(sample).to(DEV)].cpu().numpy()
            want = scipy_row_nnz(coo, sample)
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"{name}: per-row nnz differs from scipy's on "
                    f"{int((got != want).sum())} of {len(sample)} rows")
            info.update(sampled_rows=len(sample), row_nnz_equal=True,
                        sampled_nnz=int(want.sum()))
        if name == "pairbands-500k":
            c = res.to_coo()
            cancelled, ratio = check_coo(c.rows, c.cols, c.vals,
                                         pairbands_ref, f"{name} as macro")
            info.update(scipy_c_nnz=len(c.rows), coo_equal=True,
                        values_worst_over_bound=ratio,
                        values_outside_plain_rtol=cancelled)
            del c
        del res
        torch.cuda.empty_cache()

        # the plan again, outside the harness: what it is, what one steady
        # multiply launches, and its C tiles against the plain path
        a = coo_to_macro(coo)
        del coo
        reset_launch_counts()
        res = SpGEMM(cfg)(a, a)
        interactive = dict(mk.LAUNCHES)
        if interactive["macro_accumulate_pairs"] != 1 or \
                sum(interactive.values()) != 1:
            raise AssertionError(f"{name}: one interactive multiply "
                                 f"launched {interactive}")
        plan = make_plan(res, cfg, a, a)
        del res
        if not isinstance(plan, want_type) or \
                getattr(plan, "planner", None) != want_planner:
            raise AssertionError(
                f"{name}: plan {type(plan).__name__} from "
                f"{getattr(plan, 'planner', None)}, expected "
                f"{want_type.__name__} from {want_planner}")
        reset_launch_counts()
        out = plan.run(a, a)
        torch.cuda.synchronize()
        per_multiply = mk.LAUNCHES[entry]
        steady = dict(mk.LAUNCHES)
        err, n_pairs, n_tiles = hold_macro_output(
            a, plan, out, f"{name} steady output against the plain path")
        # the same plan at each lower mode: the entry the @p rows time, at
        # this matrix's own shapes, held against the plain path at the mode
        lower_err = {}
        for q in LOWER_PRECISIONS:
            out_q = dataclasses.replace(plan, precision=q).run(a, a)
            torch.cuda.synchronize()
            if int(out_q[5]) != int(out[5]):
                raise AssertionError(f"{name}: steady C_nnz {int(out_q[5])} "
                                     f"at {q}, {int(out[5])} at highest")
            lower_err[q] = hold_macro_output(
                a, plan, out_q, f"{name} steady output at {q} against the "
                f"plain path at {q}", precision=q)[0]
            del out_q
        info.update(plan=type(plan).__name__, a_tiles=a.ntiles,
                    plain_path_equal=True, max_abs_err=err,
                    max_abs_err_at=lower_err,
                    launches_per_multiply=per_multiply,
                    launches_steady_multiply=steady,
                    launches_interactive_multiply=interactive,
                    interactive_step3_entry="macro_accumulate_pairs",
                    interactive_step3_ms=info["times_ms"]["step3_time"])
        c_rows = int(out[2].shape[0])
        del out
        torch.cuda.empty_cache()
        if isinstance(plan, StencilMacroPlan):
            sp = plan.plan
            uniform = all(isinstance(c[1], int) for c in sp.classes)
            info.update(planner=plan.planner, coverage=sp.coverage,
                        classes=len(sp.classes), uniform_p=uniform,
                        residual_pairs=int(sp.res_pa.numel()),
                        residual_tiles=sp.n_res_tiles,
                        max_pairs_a_step=max(sum(st.p_list_of(c[0], c[1]))
                                             for c in sp.classes))
            slabs = (torch.empty((sp.c_cap, 128, 128), device=DEV),
                     torch.empty((sp.c_cap, 128, 128), dtype=torch.uint8,
                                 device=DEV))
            class_rows = sum(c[0] * (b.numel() // 2) for c, b in
                             zip(sp.classes, sp.class_bases))
            lib_pairs = class_pairs(sp)

            def classes_through(call, precision="highest"):
                # below "highest" the launches of one multiply share the
                # tables' masks, as stencil_accumulate's do
                def run():
                    masks = None if precision == "highest" else \
                        mk.TileMasks(a.dense, a.dense)
                    for cls, bases, tables in zip(sp.classes, sp.class_bases,
                                                  sp.class_tables):
                        call(cls, bases, tables, masks)
                return run

            def ragged(cls, bases, tables, masks, precision="highest"):
                mk.class_call2(*slabs, a.dense, a.dense, bases, *cls,
                               bases.numel() // 2, tables=tables,
                               precision=precision, tile_masks=masks)

            def uniform_entry(cls, bases, tables, masks, precision="highest"):
                mk.class_call(*slabs, a.dense, a.dense, bases, *cls,
                              tables=tables, precision=precision,
                              tile_masks=masks)

            def plain(cls, bases, tables, _masks, precision="highest"):
                st.class_call_plain(*slabs, a.dense, a.dense, bases, cls[0],
                                    cls[1], cls[4], cls[5], cls[6],
                                    precision)

            def at(call, precision):
                return lambda *x: call(*x, precision=precision)

            def lower_rows(kernel, entry, replaces, call):
                return [precision_row(
                    kernel, entry, replaces, name,
                    classes_through(at(call, q), q),
                    classes_through(at(plain, q)), *lib_pairs, a,
                    int(lib_pairs[0].numel()), class_rows,
                    max(lower_err[q], check_err[prec_key(entry, q)]), q,
                    {"classes": len(sp.classes), "timed": timed})
                    for q in LOWER_PRECISIONS]

            timed = ("the plan's class launches, one after another: the "
                     "class path of one steady multiply")
            if name == "wandering64-1M":
                k4_wandering = {q: pairs_point(a, name, n_pairs, n_tiles, q)
                                for q in ("highest",) + LOWER_PRECISIONS}
                rows_out.append(macro_row(
                    "macro_class_ragged",
                    "pem_spgemm_tpu/ops/pallas_stencil.py:309", name,
                    classes_through(ragged), classes_through(plain),
                    lib_pairs, a, int(lib_pairs[0].numel()), class_rows,
                    launches[entry], per_multiply,
                    max(err, check_err["macro_class_ragged"]),
                    dict(classes=len(sp.classes), timed=timed)))
                rows_out += lower_rows(
                    "K5", "macro_class_ragged",
                    "pem_spgemm_tpu/ops/pallas_stencil.py:309", ragged)
            elif uniform:
                # the uniform entry has no caller on the path: its rows are
                # timed on these classes beside the ragged entry, and both
                # write the same bits at every mode (the ragged entry's
                # output is held above, inside the plan's, at each mode)
                for q in ("highest",) + LOWER_PRECISIONS:
                    classes_through(at(uniform_entry, q), q)()
                    got_u = [x[:class_rows].clone() for x in slabs]
                    classes_through(at(ragged, q), q)()
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y[:class_rows])
                               for x, y in zip(got_u, slabs)):
                        raise AssertionError(f"{name}: the two class "
                                             f"entries disagree at {q}")
                    del got_u
                rows_out.append(macro_row(
                    "macro_class_uniform",
                    "pem_spgemm_tpu/ops/pallas_stencil.py:118", name,
                    classes_through(uniform_entry), classes_through(plain),
                    lib_pairs, a, int(lib_pairs[0].numel()), class_rows, 0, 0,
                    max(err, check_err["macro_class_uniform"]),
                    dict(classes=len(sp.classes), timed=timed,
                         ragged_entry_ms=time_ms(classes_through(ragged)),
                         bit_equal_to_ragged_entry=True,
                         caller="none on the path, as in the JAX package")))
                rows_out += lower_rows(
                    "K6", "macro_class_uniform",
                    "pem_spgemm_tpu/ops/pallas_stencil.py:118",
                    uniform_entry)
            del slabs, lib_pairs
        else:
            _np, _nt, (_r, _c, a_idx, b_idx, seg) = macro_pairs(a, a)
            rows_out.append(macro_row(
                "macro_accumulate_pairs",
                "pem_spgemm_tpu/ops/pallas_macro2.py:232", name,
                lambda: mk.accumulate_macro_pairs(a.dense, a.dense, a_idx,
                                                  b_idx, seg, plan.c_cap),
                lambda: M.accumulate_macro(a.dense, a.dense, a_idx, b_idx,
                                           seg, plan.c_cap, 256),
                (a_idx[:n_pairs], b_idx[:n_pairs]), a, n_pairs, plan.c_cap,
                launches[entry], per_multiply,
                max(err, check_err["macro_accumulate_pairs"],
                    k4_wandering["highest"]["max_abs_err"]),
                {"c_tiles": n_tiles, "p_cap": int(a_idx.numel()),
                 "at_wandering64-1M": k4_wandering["highest"]}))
            for q in LOWER_PRECISIONS:
                rows_out.append(precision_row(
                    "K4", "macro_accumulate_pairs",
                    "pem_spgemm_tpu/ops/pallas_macro2.py:232", name,
                    lambda q=q: mk.accumulate_macro_pairs(
                        a.dense, a.dense, a_idx, b_idx, seg, plan.c_cap,
                        precision=q),
                    lambda q=q: M.accumulate_macro(
                        a.dense, a.dense, a_idx, b_idx, seg, plan.c_cap, 256,
                        precision=q),
                    a_idx[:n_pairs], b_idx[:n_pairs], a, n_pairs, plan.c_cap,
                    max(lower_err[q],
                        check_err[prec_key("macro_accumulate_pairs", q)],
                        k4_wandering[q]["max_abs_err"]), q,
                    {"c_tiles": n_tiles, "p_cap": int(a_idx.numel()),
                     "at_wandering64-1M": k4_wandering[q]}))
            del a_idx, b_idx, seg
        emit("macro_path", **info)
        del a, plan
        torch.cuda.empty_cache()
    return rows_out


def phase_probe():
    """P1, the row-copy probe, at the JAX script's shapes: rows of a
    (500,000, W) int32 table, W = 128 and 256, copied to 100,000 permuted
    destination rows.  Held against the plain version and against numpy's
    table[src][argsort(dst)] (the JAX script's own check).  Returns its row
    of the kernels line (at W = 128; both widths under by_width)."""
    by_width = {}
    err = 0
    for w in pr.WIDTHS:
        table, src, dst = pr.probe_inputs(w, device=DEV)
        got = pr.row_copy(table, src, dst)
        want = pr.row_copy_plain(table, src, dst)
        err = max(err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"row_copy W={w}: differs from the plain "
                                 "version")
        host = table.cpu().numpy()[src.cpu().numpy()][
            np.argsort(dst.cpu().numpy())]
        if not np.array_equal(got.cpu().numpy(), host):
            raise AssertionError(f"row_copy W={w}: differs from numpy's "
                                 "table[src][argsort(dst)]")
        rows = src.numel()
        src_l, dst_l = src.long(), dst.long()
        out = torch.empty_like(got)
        ms = time_ms(lambda: pr.row_copy(table, src, dst))
        moved = 2 * rows * w * 4        # each row read once, written once
        by_width[w] = {
            "ms": ms,
            "plain_ms": time_ms(lambda: pr.row_copy_plain(table, src, dst)),
            "library_ms": time_ms(lambda: out.index_copy_(
                0, dst_l, table.index_select(0, src_l))),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "ns_per_row": ms * 1e6 / rows,
            "copied_gb_per_s": rows * w * 4 / (ms * 1e-3) / 1e9,
            "bytes": moved, "rows": rows, "table_rows": table.shape[0]}
        del table, src, dst, got, want, out
    first = by_width[pr.WIDTHS[0]]
    emit("probe", by_width=by_width)
    return {
        "name": "row_copy", "route": "cuda",
        "source": "pem_spgemm_tpu_torch/csrc/row_copy.cu",
        "replaces": "scripts/pallas_probe3.py:67",
        # counted over the path runs; no path calls it (the JAX package
        # runs it from scripts/ only), so the assertion in main exempts it
        "launches": PATH_LAUNCHES["row_copy"], "caller": "not on any path",
        "max_abs_err": float(err), "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": "bytes",
        "library_ms": first["library_ms"],
        "library_covers": "index_select + index_copy_ with int64 indices",
        "shape": [pr.TABLE_ROWS, pr.WIDTHS[0]], "kernel_ms": first["ms"],
        "by_width": by_width}


def run_profile_macro(matrix, n):
    """A Macro128 matrix's steady multiply: the cached plan replayed."""
    cfg = SpGEMMConfig(engine="macro")
    a = coo_to_macro(MACRO_MATRICES[matrix]())
    res, plan = macro_plan_of(a, cfg)
    info = dict(matrix=matrix, plan=type(plan).__name__, a_tiles=a.ntiles,
                pairs=res.n_pairs, c_tiles=res.c_ntiles, c_nnz=res.c_nnz)
    if isinstance(plan, StencilMacroPlan):
        info.update(planner=plan.planner, coverage=plan.plan.coverage,
                    classes=len(plan.plan.classes),
                    residual_pairs=int(plan.plan.res_pa.numel()))
    emit("profile_setup", **info)
    del res

    def multiply():
        return plan.run(a, a)[4]

    multiply()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        multiply()
        torch.cuda.synchronize()
    synced = (time.perf_counter() - t0) / n
    launches = {k: v / n for k, v in mk.LAUNCHES.items()}
    t0 = time.perf_counter()
    for _ in range(n):
        last = multiply()
    torch.cuda.synchronize()
    queued = (time.perf_counter() - t0) / n
    del last
    emit("profile_steady", matrix=matrix, synced_ms=synced * 1e3,
         queued_ms=queued * 1e3, device_ms=time_ms(multiply, n),
         kernel_launches_per_multiply=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    profile_device(matrix, multiply, n)

# --------------------------------------------------------------------------
# the steady element multiply as one CUDA graph (ops.fixed.BinnedElementPlan)

def plan_value_arrays(plan):
    """Every value array of a binned plan as a float32 view of its own
    memory: the B values (the chunk table's value bits, the element-window
    and fine tables' value halves, the packed classes' B bits) and the A
    values of each stream."""
    w = plan.w
    out = [plan.table[:, w:].view(torch.float32)]
    if plan.win is not None:
        out += [plan.wintab[:, binned.WIN:].view(torch.float32),
                plan.win[4].view(torch.float32)]
    if plan.coarse is not None:
        out.append(plan.coarse[1])
    for fs in plan.fine:
        out += [fs.table[:, fs.w:], fs.avals]
    for pk in plan.packed:
        out += [pk.bbits.view(torch.float32), pk.abits.view(torch.float32)]
    out += [bk.avals for bk in plan.buckets]
    out.append(plan.res_avals)
    return out


def perturb_plan_values(plan, seed):
    """Scale every value of the plan IN PLACE by factors in [0.5, 2): the
    graph must read the new values where they lie."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    for v in plan_value_arrays(plan):
        if v.dtype != torch.float32:
            raise AssertionError(f"a plan value array is {v.dtype}")
        v.mul_(torch.empty(v.shape, device=DEV).uniform_(0.5, 2.0,
                                                          generator=g))


def same_stream(got, want, what):
    """Keys, first-flags, rows, c_nnz and the values at first slots equal
    bit for bit (the values elsewhere are unspecified by the contract).
    Returns whether every value slot was equal too."""
    if int(got.c_nnz) != int(want.c_nnz):
        raise AssertionError(f"{what}: c_nnz {int(got.c_nnz)} != "
                             f"{int(want.c_nnz)}")
    all_equal = True
    gs = list(zip(got.bucket_keys, got.bucket_vals, got.bucket_first,
                  got.bucket_rows)) + [(got.res[1], got.res[2], got.res[3],
                                        got.res[0])]
    ws = list(zip(want.bucket_keys, want.bucket_vals, want.bucket_first,
                  want.bucket_rows)) + [(want.res[1], want.res[2],
                                         want.res[3], want.res[0])]
    if len(gs) != len(ws):
        raise AssertionError(f"{what}: {len(gs)} streams, eager {len(ws)}")
    for i, ((gk, gv, gf, gr), (wk, wv, wf, wr)) in enumerate(zip(gs, ws)):
        if not (torch.equal(gk, wk) and torch.equal(gf, wf)
                and torch.equal(gr, wr)):
            raise AssertionError(f"{what}: stream {i}: keys, flags or rows "
                                 "differ")
        gb, wb = gv.view(torch.int32), wv.view(torch.int32)
        if not torch.equal(gb[gf], wb[wf]):
            raise AssertionError(f"{what}: stream {i}: values differ")
        all_equal &= torch.equal(gb, wb)
    return all_equal


def same_coo(got, want, what):
    """The sorted COO of two streams equal bit for bit."""
    g, w = got.to_coo_arrays(), want.to_coo_arrays()
    if not all(np.array_equal(x.view(np.int32) if x.dtype == np.float32
                              else x, y.view(np.int32)
                              if y.dtype == np.float32 else y)
               for x, y in zip(g, w)):
        raise AssertionError(f"{what}: sorted COO differs")
    return len(g[0])


def turns_ms(fns, n):
    """Host-clock ms a multiply, each fn in turn as listed (e.g. eager,
    graph, graph, eager): synced (int() after each of the one-element
    device tensor fn returns, which the multiply writes: c_nnz or a C word)
    and queued (one int() after n)."""
    out = []
    for name, fn in fns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            int(fn())
        synced = (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for _ in range(n):
            last = fn()
        int(last)
        queued = (time.perf_counter() - t0) / n
        out.append({"path": name, "synced_ms": synced * 1e3,
                    "queued_ms": queued * 1e3})
    return out


def graph_case(name, coo, pack, n=20):
    """One element matrix's cached plan: the replayed multiply against the
    eager one, bit for bit, before and after three rounds of the plan's
    values changed in place; launches recorded at capture; peak memory and
    host-clock times of both, in turns."""
    from pem_spgemm_tpu_torch.ops.fixed import BinnedElementPlan
    a = coo_to_tiled(coo)
    b = coo_to_tiled(coo, with_tmasks=True)
    plan = binned.build_plan_device(a, b, pack=pack)
    torch.cuda.synchronize()
    what = f"{name} {'packed' if pack else 'pack=False'}"
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager = binned.binned_multiply(plan, vmem_sort=True)
    int(eager.c_nnz)
    peak_eager = torch.cuda.max_memory_allocated() - base
    del eager
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gp = BinnedElementPlan(plan=plan, vmem_sort=True)
    reset_launch_counts()
    gp.run(a, b)
    captured = dict(ss.LAUNCHES)        # the eager warm-up and the capture
    reset_launch_counts()
    c_nnz = int(gp.run(a, b)[0])
    if sum(ss.LAUNCHES.values()):
        raise AssertionError(f"{what}: a replay went through a wrapper")
    peak_graph = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    launches = gp.launches
    if captured != {k: 2 * v for k, v in launches.items()} or \
            graphs.REPLAYED != nonzero(launches):
        raise AssertionError(f"{what}: capture launches {launches}, "
                             f"eager warm-up + capture {captured}, a "
                             f"replay counted {graphs.REPLAYED}")
    entry = "segment_dedup" if pack else "segment_sort_dedup"
    if launches[entry] <= 0:
        raise AssertionError(f"{what}: the graph launches no {entry}")
    ref = binned.binned_multiply(plan, vmem_sort=True)
    all_slots = same_stream(gp.stream, ref, what)
    coo_n = same_coo(gp.stream, ref, what)
    del ref
    for r in range(3):
        perturb_plan_values(plan, seed=100 + r)
        gp.run(a, b)
        ref = binned.binned_multiply(plan, vmem_sort=True)
        all_slots &= same_stream(gp.stream, ref, f"{what}, changed {r}")
        if r == 2:
            same_coo(gp.stream, ref, f"{what}, changed {r}")
        del ref
    times = turns_ms(
        [("eager", lambda: binned.binned_multiply(plan,
                                                  vmem_sort=True).c_nnz),
         ("graph", lambda: gp.run(a, b)[0]),
         ("graph", lambda: gp.run(a, b)[0]),
         ("eager", lambda: binned.binned_multiply(plan,
                                                  vmem_sort=True).c_nnz)], n)
    emit("graph_replay", matrix=name, pack=pack, c_nnz=c_nnz,
         coo_entries=coo_n, stream_equal=True,
         every_value_slot_equal=all_slots, changed_value_rounds=3, launches_per_multiply=launches,
         peak_mem_gb={"eager": peak_eager / 2**30,
                      "graph_capture_and_replay": peak_graph / 2**30,
                      "graph_held": held / 2**30},
         times=times)
    return launches


def phase_graph_replay(coos):
    """powerlaw-1M, rmat-16 and uniform-1M packed, and powerlaw-1M with
    pack=False.  Returns {(matrix, pack): launches a replayed multiply}."""
    out = {}
    for name, pack in (("powerlaw-1M", True), ("powerlaw-1M", False),
                       ("rmat-16", True), ("uniform-1M", True)):
        out[name, pack] = graph_case(name, coos[name], pack)
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the f64 parity mode

F64_PATH = (    # matrix, engine, the kernel entry on its path, C_nnz
    ("powerlaw-1M", "auto", None, 43_282_438),
    ("pairbands-500k", "auto", "dia_multiply_pairs_f64", 14_962_177),
    ("banded64-1M", "auto", "dia_multiply_dense_f64", 126_995_967),
    ("wandering64-1M", "macro", "macro_accumulate_pairs_f64", 151_873_407),
)
# scipy's whole product where it is cheap; on the two wide matrices (4.1 G
# products each) scipy takes these rows of A, against all of A
F64_SAMPLE_ROWS = 20_000


def scipy_rows(coo, rows):
    """(rows, cols, vals, mag) of the rows ``rows`` (ascending) of A@A from
    scipy in float64, sorted, with sum|a*b| of each entry."""
    s = coo.to_scipy().tocsr().astype(np.float64)
    want = (s[rows] @ s).tocoo()
    mag = (abs(s[rows]) @ abs(s)).tocoo()
    want.sum_duplicates()
    mag.sum_duplicates()
    o, mo = (np.lexsort((x.col, x.row)) for x in (want, mag))
    if not (np.array_equal(want.row[o], mag.row[mo])
            and np.array_equal(want.col[o], mag.col[mo])):
        raise AssertionError("|A|@|A| and A@A differ in structure")
    return (np.asarray(rows)[want.row[o]], want.col[o], want.data[o],
            mag.data[mo])


def check_f64(c, want_r, want_c, want_v, mag, what):
    """Exact structure, float64 values within 1e-12 * sum|a*b|.  Returns
    the worst error over the bound."""
    if c.vals.dtype != np.float64:
        raise AssertionError(f"{what}: values are {c.vals.dtype}")
    if not (np.array_equal(c.rows, want_r) and np.array_equal(c.cols,
                                                                want_c)):
        raise AssertionError(f"{what}: sorted COO structure differs")
    over = float((np.abs(c.vals - want_v) / (F64_RTOL * mag + F64_ATOL))
                 .max()) if len(want_v) else 0.0
    if not over <= 1.0:
        raise AssertionError(f"{what}: values exceed the float64 "
                             f"dot-product bound by {over}x")
    return over


def f64_coo_rows(c, rows):
    """The entries of the sorted COO ``c`` in the rows ``rows``."""
    lo = np.searchsorted(c.rows, rows, side="left")
    hi = np.searchsorted(c.rows, rows, side="right")
    take = np.concatenate([np.arange(x, y) for x, y in zip(lo, hi)])
    return COOMatrix(c.rows[take], c.cols[take], c.vals[take], c.shape)


def phase_f64_path(coo_pl, want_pl):
    """The four f64 matrices through run_benchmark(dtype=float64) at full
    size, A*A, repeat 2.  Returns what the kernel rows need."""
    cfg = SpGEMMConfig(dtype=torch.float64, repeat=2)
    kept = {}
    for name, engine, entry, want_nnz in F64_PATH:
        if name == "powerlaw-1M":
            coo = coo_pl
        elif name == "wandering64-1M":
            coo = MACRO_MATRICES[name]()
        else:
            coo = banded_device(**DIA_MATRICES[name])
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rec, res = run_benchmark(coo, name, cfg.with_(engine=engine),
                                 verbose=False)
        launches = path_launches({**ss.LAUNCHES, **dk.LAUNCHES,
                                  **mk.LAUNCHES})
        peak = torch.cuda.max_memory_allocated() / 2**30
        if res.c_nnz != want_nnz:
            raise AssertionError(f"{name} f64: C_nnz {res.c_nnz} != "
                                 f"{want_nnz}")
        if res.vals.dtype != torch.float64:
            raise AssertionError(f"{name} f64: values {res.vals.dtype}")
        if entry is None:
            if res.engine != "element" or res.binned is not None \
                    or any(launches.values()):
                raise AssertionError(f"{name} f64: not the merge engine "
                                     f"({res.engine}, {launches})")
        elif launches[entry] <= 0 or any(
                v for k, v in launches.items() if k != entry):
            raise AssertionError(f"{name} f64: launches {launches}")
        c = res.to_coo()
        del res
        if name == "powerlaw-1M":
            want, order, mag = want_pl
            over = check_f64(c, want.row[order], want.col[order],
                             want.data[order], mag, name)
            checked = "scipy, every entry"
        elif name == "pairbands-500k":
            want, order, mag = scipy_square(coo, with_abs=True)
            over = check_f64(c, want.row[order], want.col[order],
                             want.data[order], mag, name)
            checked = "scipy, every entry"
            del want, order, mag
        else:
            g = np.random.default_rng(17)
            rows = np.sort(g.choice(coo.shape[0], F64_SAMPLE_ROWS,
                                    replace=False))
            over = check_f64(f64_coo_rows(c, rows), *scipy_rows(coo, rows),
                             f"{name} sampled rows")
            checked = f"scipy, {F64_SAMPLE_ROWS:,} sampled rows"
        emit("f64_path", matrix=name, engine=engine, entry=entry,
             flop=rec.flop, c_nnz=rec.c_nnz, expected_c_nnz=want_nnz,
             checked_against=checked, values_worst_over_bound=over,
             bound="|err| <= 1e-12 * sum|a*b|", launches=launches,
             times_ms=record_times(rec), peak_mem_gb=peak)
        del c
        if entry is not None:
            kept[entry] = dict(coo=coo, launches=launches[entry],
                               matrix=name, times=record_times(rec))
        torch.cuda.empty_cache()
    return kept


def f64_per_multiply(a, engine, entry):
    """One interactive and one steady float64 multiply of ``a``·``a``, each
    counted on its own: the launches of ``entry`` in each, which must be
    the only kernel launched (a DIA plan's steady multiply is a replay:
    its launches are those recorded at capture)."""
    cfg = SpGEMMConfig(dtype=torch.float64, engine=engine)
    counted = []
    reset_launch_counts()
    res = SpGEMM(cfg)(a, a)
    torch.cuda.synchronize()
    counted.append({**path_launches(ss.LAUNCHES), **dict(dk.LAUNCHES),
                    **dict(mk.LAUNCHES)})
    plan = make_plan(res, cfg, a, a)
    del res
    if engine == "dia":
        # a DIA plan replays a CUDA graph: its launches a multiply are
        # those recorded at capture (dia_steady_launches)
        del plan
        counted.append({entry: dia_steady_launches(a, entry)})
    else:
        reset_launch_counts()
        out = plan.run(a, a)
        torch.cuda.synchronize()
        del out, plan
        counted.append({**path_launches(ss.LAUNCHES), **dict(dk.LAUNCHES),
                        **dict(mk.LAUNCHES)})
    for what, got in zip(("interactive", "steady"), counted):
        if got[entry] <= 0 or any(v for k, v in got.items() if k != entry):
            raise AssertionError(f"{entry}: one {what} multiply launched "
                                 f"{got}")
    torch.cuda.empty_cache()
    return counted[0][entry], counted[1][entry]


def f64_dia_row(entry, info, check_err):
    """A float64 DIA entry at its f64 path matrix: kernel and plain version
    with counts and values-only, held against each other (bit for bit); the
    library call on the same matrix in float64 CSR (the dense entry's at
    banded16-1M, which cuSPARSE takes).  Its operations are bounded at the
    FP64 units' rate: each product is rounded on its own, a DMUL and a
    DADD, so no DMMA can carry it."""
    mode = entry.split("_")[2]
    name = info["matrix"]
    a = D.coo_to_dia(info["coo"], dtype=torch.float64)
    offs = a.offsets
    dc_list, idx_map = D._plan_maps(offs, offs)
    kw = dict(offs_a=offs, idx_map=idx_map, dc_count=len(dc_list), n_out=a.n)
    tables = dk.dia_tables(offs, offs, dc_list, mode, a.device)
    got = dk.dia_multiply(a.bands, a.bands, offs_a=offs, offs_b=offs,
                          dc_list=dc_list, n_out=a.n, mode=mode,
                          tables=tables)
    want = D._dia_multiply_torch(a.bands, a.bands, **kw)
    mag = D._dia_multiply_torch(a.bands.abs(), a.bands.abs(),
                                values_only=True, **kw)[0]
    err = dia_hold(got, want, F64_RTOL * mag + F64_ATOL, f"{entry} at {name}",
                   key=entry, label="float64")
    bit_equal = torch.equal(got[0], want[0])
    if not bit_equal:
        raise AssertionError(f"{entry} at {name}: not bit-equal to the plain "
                             "version")
    del got, want, mag
    interactive, steady = f64_per_multiply(a, "dia", entry)
    ms, ms_vo, plain, plain_vo = dia_times(a.bands, offs, dc_list, idx_map,
                                           mode, n_plain=2)
    wrapper = dia_wrapper_ms(a.bands, offs, dc_list, mode)
    flop = DIA_RECORDED[name][1]
    c_bytes = 8 * len(dc_list) * a.n
    in_bytes = 8 * a.bands.numel()

    def bound(with_counts):
        by = (in_bytes + c_bytes + (c_bytes // 2 if with_counts else 0)) \
            / HBM_BYTES_PER_S
        ops = 2 * flop / FP64_INSTR_PER_S + (
            2 * flop / FP32_OPS_PER_S if with_counts else 0.0)
        return max(by, ops) * 1e3, "bytes" if by >= ops else "operations"

    (b_ms, b_by), (bv_ms, bv_by) = bound(True), bound(False)
    lib_name = DENSE_LIBRARY_MATRIX if mode == "dense" else name
    lib_coo = banded_device(**DIA_MATRICES[lib_name]) \
        if lib_name != name else info["coo"]
    lib_coo = COOMatrix(lib_coo.rows, lib_coo.cols,
                        torch.as_tensor(lib_coo.vals).to(DEV,
                                                          torch.float64),
                        lib_coo.shape)
    library = sparse_mm_ms(lib_coo)
    row = {
        **(dense_staging_fields(offs, a.n, 8, a.device)
           if mode == "dense" else {}),
        "name": entry, "route": "cuda", "source": DIA_SOURCE,
        "replaces": "pem_spgemm_tpu/ops/pallas_dia.py:280",
        "launches": info["launches"],
        "max_abs_err": max(err, check_err[entry]),
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library,
        "library_covers": f"torch.sparse.mm(A, A) in float64 CSR at "
                          f"{lib_name}: another format",
        "values_only_ms": ms_vo, "values_only_plain_ms": plain_vo,
        "values_only_bound_ms": bv_ms, "values_only_bound_by": bv_by,
        "bound_rates": "a DMUL and a DADD a product at the FP64 units' 17 T "
                       "instructions/s (34 TFLOP/s of FMA; each product "
                       "and sum rounded on its own, as the plain version "
                       "does, so not on the DMMA tensor cores), counts at "
                       "FP32 67 TFLOP/s, HBM 3.35 TB/s",
        "runs_on": "FP64 units (DMUL, DADD)",
        "bit_equal_to_plain": bit_equal,
        "matrix": name, "shape": [len(offs), a.n], "c_rows": len(dc_list),
        "products": flop, "dtype": "float64", "kernel_ms": ms,
        "timed_by": "CUDA-graph replay of 20 wrapper calls",
        "wrapper_ms": wrapper[0], "values_only_wrapper_ms": wrapper[1],
        "launches_per_multiply": steady,
        "launches_interactive_multiply": interactive,
    }
    if lib_name != name:
        lib_a = D.coo_to_dia(lib_coo, dtype=torch.float64)
        lo, li = D._plan_maps(lib_a.offsets, lib_a.offsets)
        lk, lk_vo, _p, _pv = dia_times(lib_a.bands, lib_a.offsets, lo, li,
                                       mode, n_plain=1)
        row.update(library_matrix=lib_name, library_kernel_ms=lk,
                   library_kernel_values_only_ms=lk_vo)
    return row


def f64_macro_row(info, check_err):
    """The float64 pair-stream entry at wandering64-1M's stream, against
    the plain version; torch.bmm in float64 as the yardstick."""
    entry = "macro_accumulate_pairs_f64"
    a = coo_to_macro(info["coo"], dtype=torch.float64)
    n_pairs, n_tiles, (_r, _c, a_idx, b_idx, seg) = macro_pairs(a, a)
    c_cap = -(-n_tiles // 256) * 256
    fn = lambda: mk.accumulate_macro_pairs(a.dense, a.dense, a_idx, b_idx,
                                           seg, c_cap)
    plain = lambda: M.accumulate_macro(a.dense, a.dense, a_idx, b_idx, seg,
                                       c_cap, 256, torch.float64)
    got, want = fn(), plain()
    mag = M.accumulate_macro(a.dense.abs(), a.dense.abs(), a_idx, b_idx, seg,
                             c_cap, 256, torch.float64)[0]
    err = macro_hold(got, want, mag, f"{entry} at wandering64-1M", key=entry)
    del got, want, mag
    interactive, steady = f64_per_multiply(a, "macro", entry)
    ops = TILE_FLOP * n_pairs
    nbytes = a.dense.numel() * 8 + c_cap * 128 * 128 * 9
    b_o, b_b = ops / FP64_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    skipped = f64_skipped_share(a.dense, a.dense, a_idx[:n_pairs],
                                b_idx[:n_pairs])
    ms = time_ms(fn, 3)
    return {
        "name": entry, "route": "cuda", "source": MACRO_SOURCE,
        "replaces": "pem_spgemm_tpu/ops/pallas_macro2.py:232",
        "launches": info["launches"], "max_abs_err": max(err,
                                                         check_err[entry]),
        "ms": ms, "plain_ms": time_ms(plain, 1),
        "bound_ms": max(b_o, b_b) * 1e3,
        "bound_by": "operations" if b_o >= b_b else "bytes",
        "library_ms": bmm_ms(a.dense, a.dense, a_idx[:n_pairs],
                             b_idx[:n_pairs]),
        "library_covers": "torch.bmm in float64 over the pre-gathered "
                          "(P, 128, 128) operands in chunks of 16,384 "
                          "pairs: the products only",
        "bound_rates": "FP64 67 TFLOP/s (the tensor cores' DMMA), HBM "
                       "3.35 TB/s",
        "runs_on": "DMMA (mma.sync f64)", "matrix": "wandering64-1M",
        "skipped": skipped,
        "skipped_rule": "a 16 x 8 x 16 DMMA block whose A rows and B "
                        "columns share no k with non-zeros on both sides, "
                        "and hold no Inf or NaN, multiplies only zeros and "
                        "is not run; a slab none of whose blocks runs is "
                        "not copied; the bound counts every product",
        "pairs": n_pairs,
        "c_rows": c_cap, "operations": ops, "bytes": nbytes,
        "dtype": "float64", "kernel_ms": ms,
        "launches_per_multiply": steady,
        "launches_interactive_multiply": interactive,
    }


def phase_f64_kernels(kept, check_err):
    rows = [f64_dia_row(e, kept[e], check_err)
            for e in ("dia_multiply_dense_f64", "dia_multiply_pairs_f64")]
    torch.cuda.empty_cache()
    rows.append(f64_macro_row(kept["macro_accumulate_pairs_f64"], check_err))
    return rows



# --------------------------------------------------------------------------
# the Tile16 tier (fused and masks engines, the Tile16 kernel) and the
# persistence of converted operands

TILE16_MATRIX = "pairbands-500k"
TILE16_RUNS = (("fused", torch.float32), ("masks", torch.float32),
               ("fused", torch.float64), ("fused", torch.bfloat16))
TILE16_SYNCS = 3        # size feedbacks of an interactive Tile16 multiply
# each tile16_path run's kernel launches (wrapper and replayed; counts set
# to 0 just before the run, read just after), by run: the rows' counts
TILE16_RUN_LAUNCHES = {}


def tile16_run_entries(engine, dtype):
    """(the kernel entries a tile16_path run launches through wrappers,
    those its replays count): the steady plan's step is the accumulation's
    masks form and tile16_c_rowcol (with values) whatever the engine; the
    interactive fused multiply launches the same two, the masks engine's
    tile16_c_masks and the values-only form instead of the masks form."""
    steady = {TILE16_MASKS_ENTRY[dtype], "tile16_c_rowcol"}
    wrappers = set(steady)
    if engine == "masks":
        wrappers |= {"tile16_c_masks", TILE16_ENTRY[dtype]}
    return wrappers, steady | {"spgemm_fixed"}


def tile16_config(engine, dtype, **kw):
    acc = torch.float32 if dtype == torch.bfloat16 else None
    return SpGEMMConfig(engine=engine, dtype=dtype, acc_dtype=acc, **kw)


def count_syncs(fn):
    """Run fn() with torch's sync debug mode on "warn": (its result, the
    synchronizing operations it made).  An explicit device synchronise is
    not one of them (the timers' are off here)."""
    import warnings
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def tile16_sorted(out, n):
    """Sorted COO (numpy) of a Tile16 step's output tuple, values as
    float64."""
    from pem_spgemm_tpu_torch.ops.assemble import assemble_coo
    r, c, v = assemble_coo(out[0], out[1], out[4], out[5], out[6], n)
    return (r[:n].cpu().numpy(), c[:n].cpu().numpy(),
            v[:n].to(torch.float64).cpu().numpy())


def hold_bound(vals, want, mag, rtol, atol, what):
    """|vals - want| <= rtol * mag + atol everywhere; the worst ratio."""
    over = float((np.abs(vals - want) / (rtol * mag + atol)).max())
    if not over <= 1.0:
        raise AssertionError(f"{what}: values exceed the bound by {over}x")
    return over


def tile16_hold_replay(res, cfg, coo, ref, what, entry):
    """The steady plan of this run, on freshly converted operands: a replay
    of its CUDA graph against the eager spgemm_fixed, bit for bit, values
    too (the Tile16 kernel sums a C tile's pairs in stream order: the same
    bits at every launch); each replay counts one launch of ``entry`` (the
    accumulation's masks form) and one of tile16_c_rowcol.  Returns the
    plan's own check against scipy (its values are in the accumulation
    dtype), the replay's record and the eager step's device ms by share."""
    from pem_spgemm_tpu_torch.ops.fixed import SpGEMMPlan
    a = coo_to_tiled(coo, dtype=cfg.dtype)
    b = coo_to_tiled(coo, dtype=cfg.dtype, with_tmasks=True)
    plan = make_plan(res, cfg, a, b)
    if not isinstance(plan, SpGEMMPlan):
        raise AssertionError(f"{what}: plan {type(plan).__name__}")
    graphs.reset_replayed()
    rep = plan.run(a, b)
    rep_again = plan.run(a, b)
    if graphs.REPLAYED != {"spgemm_fixed": 2, entry: 2,
                           "tile16_c_rowcol": 2} \
            or rep_again[6] is not rep[6]:
        raise AssertionError(f"{what}: replays counted {graphs.REPLAYED}")
    eager = plan.multiply(a, b)
    if bool(rep[8]) or bool(eager[8]):
        raise AssertionError(f"{what}: the plan overflows")
    for i, field in enumerate(("c_tile_row", "c_tile_col", "cmask", "cptr",
                               "c_rowcol", "c_elem_tile", "c_vals",
                               "c_nnz")):
        x, y = rep[i], eager[i]
        if field == "c_vals":               # in the accumulation dtype
            x, y = int_view(x), int_view(y)
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: replay {field} differs from the "
                                 "eager step")
    n = int(rep[7])
    want, order, mag = ref
    wr, wc, wv = want.row[order], want.col[order], want.data[order]
    rr, rc, rv = tile16_sorted(rep, n)
    er, ec, ev = tile16_sorted(eager, n)
    if not (np.array_equal(rr, wr) and np.array_equal(rc, wc)
            and np.array_equal(er, wr) and np.array_equal(ec, wc)):
        raise AssertionError(f"{what}: the plan's sorted COO differs from "
                             "scipy's")
    wide = rep[6].dtype == torch.float64
    rtol, atol = (F64_RTOL, F64_ATOL) if wide else (COO_RTOL, COO_ATOL)
    info = dict(
        plan=dict(p_cap=plan.p_cap, c_cap=plan.c_cap,
                  c_nnz_cap=plan.c_nnz_cap),
        replay_structure_bit_equal=True,
        replay_values_bit_equal=True,
        replay_vs_eager_max_abs=float(np.abs(rv - ev).max()),
        replay_vs_eager_worst_over_bound=hold_bound(
            rv, ev, mag, rtol, atol, f"{what} replay against eager"),
        plan_values_dtype=str(rep[6].dtype),
        plan_values_worst_over_bound=hold_bound(
            rv, wv, mag, rtol, atol, f"{what} plan against scipy"))
    del rep, rep_again, eager
    info["steady_step_device_ms_by_share"] = tile16_split(
        lambda: plan.multiply(a, b), 3)
    del plan, a, b
    return info


def bf16_reference(coo):
    """(want, order, sum|a*b|) as scipy_square gives them, of the matrix
    with its values rounded to bfloat16 as the bfloat16 run converts them.
    Rounded values cancel exactly in places, and scipy drops an entry that
    sums to 0.0, so C's structure is taken from |A|@|A| and A@A's values
    read there (0.0 where scipy dropped the entry)."""
    import types
    v = torch.as_tensor(coo.vals).to(torch.bfloat16).to(
        torch.float64).cpu().numpy()
    s = COOMatrix(coo.rows, coo.cols, v, coo.shape).to_scipy().tocsr()
    sa = abs(s)
    mag = (sa @ sa).tocoo()
    mag.sum_duplicates()
    order = np.lexsort((mag.col, mag.row))
    data = np.asarray((s @ s).tocsr()[mag.row, mag.col]).ravel()
    want = types.SimpleNamespace(row=mag.row, col=mag.col, data=data,
                                 nnz=mag.nnz)
    return want, order, mag.data[order]


def phase_tile16_path(ref, ref_bf16, dia_steady_ms):
    """pairbands-500k through run_benchmark with engine fused and masks at
    float32, and fused at float64 and at bfloat16 (float32 accumulation),
    repeat 2, A*A at full size on one card.  Held: C_nnz as recorded, the
    sorted COO equal to scipy's, values within the dtype's bound (bfloat16:
    the float32 bound against scipy's product of the bfloat16-rounded
    operands for the plan's float32 values, plus half a bfloat16 ulp
    (2^-8 of the value) for the result, which is rounded to bfloat16 as in
    the JAX package); the
    steady tiers replay one CUDA graph (ops.graphs.REPLAYED moves, no
    kernel wrapper does); the replay against the eager step; exactly
    TILE16_SYNCS host syncs in an interactive multiply.  Beside each run,
    the DIA engine's steady time on the same matrix (phase dia_path).  Every
    run launches the Tile16 kernels of its engine (tile16_run_entries; the
    float64 run the float64 entry's forms) and nothing else of this
    package, and its replays count the kernels' launches recorded at
    capture; the replay's structure and values are bit-equal to the eager
    step's.  Step 1 / 2 / 3 ms of the interactive multiply from the
    harness's timers, of the steady step (the eager plan step) from the
    device time by share (tile16_split)."""
    from pem_spgemm_tpu_torch.utils.timing import PhaseTimers
    name = TILE16_MATRIX
    want_nnz = DIA_RECORDED[name][0]
    coo = banded_device(**DIA_MATRICES[name])
    out = {}
    for engine, dtype in TILE16_RUNS:
        what = f"{name} {engine} {str(dtype).split('.')[-1]}"
        cfg = tile16_config(engine, dtype, repeat=2)
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec, res = run_benchmark(coo, name, cfg, verbose=False)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        wrappers = nonzero(all_counts())
        replays = dict(graphs.REPLAYED)
        want_w, want_r = tile16_run_entries(engine, dtype)
        if set(wrappers) != want_w or set(replays) != want_r:
            raise AssertionError(f"{what}: kernel launches {wrappers}, "
                                 f"replays {replays}")
        TILE16_RUN_LAUNCHES[what] = wrappers
        if res.engine != engine or res.c_nnz != want_nnz \
                or rec.c_nnz != want_nnz:
            raise AssertionError(f"{what}: engine {res.engine}, C_nnz "
                                 f"{res.c_nnz} (recorded {want_nnz})")
        if res.vals.dtype != dtype:
            raise AssertionError(f"{what}: values {res.vals.dtype}")
        c = res.to_coo()
        r = ref_bf16 if dtype == torch.bfloat16 else ref
        want, order, mag = r
        if dtype == torch.float64:
            over = check_f64(c, want.row[order], want.col[order],
                             want.data[order], mag, what)
            bound = "|err| <= 1e-12 * sum|a*b|"
        elif dtype == torch.float32:
            _cancelled, over = check_coo(c.rows, c.cols, c.vals, r, what)
            bound = "|err| <= 1e-5 * sum|a*b| + 1e-6"
        else:
            if not (np.array_equal(c.rows, want.row[order])
                    and np.array_equal(c.cols, want.col[order])):
                raise AssertionError(f"{what}: sorted COO differs")
            # a value rounded to bfloat16 moves by at most half an ulp:
            # 2^-8 of the rounded value
            wv = want.data[order]
            over = float((np.abs(c.vals - wv) / (
                COO_RTOL * mag + COO_ATOL + np.abs(c.vals) * 2.0 ** -8))
                .max())
            if not over <= 1.0:
                raise AssertionError(f"{what}: values exceed the bound by "
                                     f"{over}x")
            bound = ("result (bfloat16): |err| <= 1e-5 * sum|a*b| + 1e-6 + "
                     "2^-8 |got|; plan (float32): |err| <= 1e-5 * "
                     "sum|a*b| + 1e-6; against the bfloat16-rounded "
                     "operands' product")
        del c
        a = coo_to_tiled(coo, dtype=dtype)
        b = coo_to_tiled(coo, dtype=dtype, with_tmasks=True)
        timers = PhaseTimers()
        timers.detail = False
        eng = SpGEMM(cfg)
        eng(a, b, timers)
        res2, syncs = count_syncs(lambda: eng(a, b, timers))
        if syncs != TILE16_SYNCS or res2.c_nnz != want_nnz:
            raise AssertionError(f"{what}: {syncs} host syncs in an "
                                 f"interactive multiply, expected "
                                 f"{TILE16_SYNCS}")
        del a, b, res2
        replay = tile16_hold_replay(res, cfg, coo, r, what,
                                    TILE16_MASKS_ENTRY[dtype])
        del res
        torch.cuda.empty_cache()
        out[what] = dict(times_ms=record_times(rec), peak_mem_gb=peak)
        emit("tile16_path", matrix=name, engine=engine,
             dtype=str(dtype).split(".")[-1], flop=rec.flop, c_nnz=rec.c_nnz,
             jax_recorded_c_nnz=want_nnz, checked_against="scipy, every entry",
             values_worst_over_bound=over, bound=bound,
             interactive_host_syncs=syncs, replays=replays,
             kernel_wrapper_launches=wrappers, replay_check=replay,
             times_ms=record_times(rec),
             a_conversion_ms=rec.a_conversion_kernel_time,
             steps_ms=dict(step1=rec.step1_time, step2=rec.step2_time,
                           step3=rec.step3_time),
             steady_ms=rec.steady_state_time,
             peak_mem_gb=peak, dia_steady_ms=dia_steady_ms,
             run_benchmark_s=run_s)
    return out


def phase_persist():
    """pairbands-500k's Tile16 and DIA forms saved to a temporary directory
    (git-ignored, under the package's build directory), loaded onto the
    card and multiplied: arrays equal, C_nnz as recorded."""
    import os
    import tempfile
    from pem_spgemm_tpu_torch.io import persist
    name = TILE16_MATRIX
    want_nnz = DIA_RECORDED[name][0]
    coo = banded_device(**DIA_MATRICES[name])
    t = coo_to_tiled(coo, with_tmasks=True)
    d = D.coo_to_dia(coo)
    del coo
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    info = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for form, obj, save, load, fields in (
                ("tile16", t, persist.save_tiled, persist.load_tiled,
                 ("tile_row", "tile_col", "ptr", "masks", "vals", "rowcol",
                  "elem_tile", "tile_rowptr", "tmasks")),
                ("dia", d, persist.save_dia, persist.load_dia, ("bands",))):
            path = os.path.join(tmp, f"{name}.{form}.npz")
            t0 = time.perf_counter()
            save(path, obj)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = load(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            for f in fields:
                if not torch.equal(getattr(got, f), getattr(obj, f)):
                    raise AssertionError(f"persist {form}: {f} differs")
            cfg = SpGEMMConfig(engine="fused") if form == "tile16" \
                else SpGEMMConfig()
            res = SpGEMM(cfg)(got, got)
            if res.engine != ("fused" if form == "tile16" else "dia") \
                    or res.c_nnz != want_nnz:
                raise AssertionError(f"persist {form}: {res.engine} C_nnz "
                                     f"{res.c_nnz} (recorded {want_nnz})")
            info[form] = dict(save_s=save_s, load_s=load_s,
                              archive_mb=os.path.getsize(path) / 2**20,
                              arrays_equal=True, c_nnz=res.c_nnz)
            del got, res
    emit("persist", matrix=name, **info, jax_recorded_c_nnz=want_nnz,
         macro128="not run here: Macro128 archives of the suite hold "
                  "several GB of dense tiles; the CPU tests "
                  "(tests/test_torch_persist.py) cover their round trip")


# --------------------------------------------------------------------------
# the Tile16 accumulation kernel (ops/tile16_kernels.py): both entries,
# every form, held on pairbands-500k's stream; its rows of the kernels line

TILE16_SOURCE = "pem_spgemm_tpu_torch/csrc/tile16_accumulate.cu"
TILE16_REPLACES = ("none: pem_spgemm_tpu/ops/numeric.py:58 "
                   "accumulate_fused_flat (and :103 accumulate_dense, "
                   "parallel/sharded.py:211 _local_numeric) run in XLA, "
                   "no Pallas kernel")
TILE16_FLOP = 2 * 16 ** 3       # operations of one 16x16x16 product
TILE16_ENTRY = {torch.float32: "tile16_accumulate_pairs",
                torch.bfloat16: "tile16_accumulate_pairs",
                torch.float64: "tile16_accumulate_pairs_f64"}
TILE16_MASKS_ENTRY = {k: v + "_masks" for k, v in TILE16_ENTRY.items()}
STRUCT_SOURCE = "pem_spgemm_tpu_torch/csrc/tile16_structure.cu"
STRUCT_REPLACES = {
    "tile16_c_masks": "none: pem_spgemm_tpu/ops/cstruct.py:54 c_masks (16 "
                      "bit-plane segment_max reductions) runs in XLA, no "
                      "Pallas kernel",
    "tile16_c_rowcol": "none: pem_spgemm_tpu/ops/cstruct.py:108 c_rowcol "
                       "and ops/numeric.py:201 extract_values run in XLA, "
                       "no Pallas kernel",
    "masks_form": "none: pem_spgemm_tpu/ops/numeric.py:60 "
                  "accumulate_fused_flat then :186 counts_to_masks "
                  "(ops/fixed.py:58-63) run in XLA, no Pallas kernel"}
STRUCT_FIELDS = ("c_tile_row", "c_tile_col", "cmask", "cptr", "pair_ptr")


def tile16_stream(coo, dtype=torch.float32, coords=False):
    """A @ A's Tile16 pair stream on the card as the fused engine builds it
    (SpGEMMConfig's defaults): (a, b, a_idx, b_idx, c_tile_id, c_cap,
    n_pairs), and with ``coords`` the pairs' C tile (c_row, c_col)."""
    from pem_spgemm_tpu_torch.config import round_up_bucket, round_up_pow2
    from pem_spgemm_tpu_torch.ops.scanops import can_pack
    a = coo_to_tiled(coo, dtype=dtype)
    b = coo_to_tiled(coo, dtype=dtype, with_tmasks=True)
    offsets = symbolic.pair_counts(a.tile_col, b.tile_rowptr, a.ntiles)
    n_pairs = int(offsets[-1])
    p_cap = max(SpGEMMConfig().numeric_chunk, round_up_pow2(n_pairs))
    c_row, c_col, a_idx, b_idx, seg, cnt = symbolic.expand_pairs(
        offsets, a.tile_row, a.tile_col, b.tile_rowptr, b.tile_col, n_pairs,
        p_cap, can_pack(a.n_tile_rows, b.n_tile_cols))
    out = (a, b, a_idx, b_idx, seg, round_up_bucket(int(cnt)), n_pairs)
    return out + (c_row, c_col) if coords else out


def tile16_hold(got, want, mag, what, tiles=1 << 16):
    """Values of the kernel against its plain version: the same positions
    NaN and +-Inf of the same sign, finite values within the dot-product
    bound of their dtype (dot_bound of sum|a*b|, ``mag``).  Returns the max
    abs error."""
    worst, err_max = 0.0, 0.0
    for lo in range(0, got.shape[0], tiles):
        g, w, m = got[lo:lo + tiles], want[lo:lo + tiles], mag[lo:lo + tiles]
        if not (torch.equal(torch.isnan(g), torch.isnan(w))
                and torch.equal(torch.isposinf(g), torch.isposinf(w))
                and torch.equal(torch.isneginf(g), torch.isneginf(w))):
            raise AssertionError(f"{what}: NaN / Inf positions differ from "
                                 "the plain version's")
        fin = torch.isfinite(w)
        err = torch.where(fin, (g - w).abs(), 0)
        bound, label = dot_bound(torch.where(fin, m, 0))
        over = float((err / bound).max()) if err.numel() else 0.0
        if not over <= 1.0:
            raise AssertionError(f"{what}: values exceed the {label} "
                                 f"dot-product bound by {over}x")
        worst = max(worst, over)
        err_max = max(err_max, float(err.max()) if err.numel() else 0.0)
    note_over(what.split(",")[0], worst)
    return err_max


def same_values(got, want):
    """Equal under == (NaN where NaN)."""
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want)))
                .all())


def tile16_prior(c_cap, dtype, seed):
    """A C (c_cap, 16, 16) on the card that a stage adds into: normal
    values with -0.0, +-Inf and NaN in every tile."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    c = torch.randn((c_cap, 16, 16), generator=g, device=DEV, dtype=dtype)
    flat = c.view(c_cap, 256)
    rows = torch.arange(c_cap, device=DEV)[:, None]
    pos = torch.randint(0, 64, (c_cap, 4), generator=g, device=DEV) \
        + torch.arange(4, device=DEV) * 64      # four distinct positions
    flat[rows, pos] = torch.tensor([-0.0, float("inf"), float("-inf"),
                                    float("nan")], dtype=dtype, device=DEV)
    return c


def hold_tile16_accumulate(got, fresh, prior, live, what):
    """The accumulate form (into a copy of ``prior``) against the parent's
    composition, the fresh form's output added by torch: the tiles without
    pairs bit for bit the prior's, the others old + partial under ==."""
    dead = ~live
    if not torch.equal(int_view(got[dead]), int_view(prior[dead])):
        raise AssertionError(f"{what}: a tile without pairs changed")
    comp = prior[live] + fresh[live]
    if not same_values(got[live], comp):
        raise AssertionError(f"{what}: values differ from old + partial")


def thinned(seg, keep_every=5, drop=3):
    """The stream with the pairs of every C tile t % keep_every == drop
    taken out (padding appended): interior tiles without pairs."""
    keep = (seg % keep_every != drop) & (seg < torch.iinfo(torch.int32).max)
    n = int(keep.sum())
    out = torch.full_like(seg, torch.iinfo(torch.int32).max)
    out[:n] = seg[keep]
    return keep, n, out


@contextlib.contextmanager
def torch_structure_ops_refused(what):
    """Inside: index_add_, scatter_reduce_ and numeric.counts_to_masks
    raise (the card's structure path must run none of them: only the
    plain versions, on the CPU, do)."""
    from pem_spgemm_tpu_torch.ops import numeric as N
    saved = (torch.Tensor.index_add_, torch.Tensor.scatter_reduce_,
             N.counts_to_masks)

    def refused(name):
        def run(*args, **kw):
            raise AssertionError(f"{what}: {name} ran on the card")
        return run

    torch.Tensor.index_add_ = refused("index_add_")
    torch.Tensor.scatter_reduce_ = refused("scatter_reduce_")
    N.counts_to_masks = refused("counts_to_masks")
    try:
        yield
    finally:
        (torch.Tensor.index_add_, torch.Tensor.scatter_reduce_,
         N.counts_to_masks) = saved


def hold_masks_form(got, again, counts_out, what):
    """The accumulation's masks form (c_dense, cmask, cptr), two launches,
    against the counts form's output on the same inputs: masks and nnz
    scan those of counts_to_masks of its counts (the plain version's,
    which the counts are held to bit for bit), values bit for bit its
    values."""
    from pem_spgemm_tpu_torch.ops import numeric as N
    cmask, cptr = N.counts_to_masks(counts_out[1])
    for g in (got, again):
        if not (torch.equal(g[1], cmask) and torch.equal(g[2], cptr)):
            raise AssertionError(f"{what}: masks or nnz scan differ from "
                                 "those of the counts")
        if not torch.equal(int_view(g[0]), int_view(counts_out[0])):
            raise AssertionError(f"{what}: values differ from the counts "
                                 "form's")


def hold_structure(a_masks, b_tmasks, ai, bi, seg, c_row, c_col, c_cap,
                   denses, caps, what):
    """tile16_c_masks and tile16_c_rowcol against their plain versions on
    the card, bit for bit, two launches of each: c_masks' five arrays
    (tile coordinates, masks, nnz scan, pair offsets), then c_rowcol at
    each c_nnz_cap of ``caps`` (of C_nnz) without values and with each
    value table of ``denses``, padding slots included.  Returns (cases,
    cmask, cptr)."""
    from pem_spgemm_tpu_torch.ops import numeric as N
    args = (a_masks, b_tmasks, ai, bi, seg, c_row, c_col, c_cap)
    want = cstruct.c_masks_plain(*args)
    for _ in range(2):
        with torch_structure_ops_refused(f"{what}, c_masks"):
            got = cstruct.c_masks(*args)
        for f, g, w in zip(STRUCT_FIELDS, got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: tile16_c_masks {f} differs "
                                     "from the plain version's")
    del want
    cmask, cptr = got[2], got[3]
    cases = 1
    for cap in caps(int(cptr[-1])):
        want = cstruct.c_rowcol_plain(cmask, cptr, cap)
        for _ in range(2):
            with torch_structure_ops_refused(f"{what}, c_rowcol"):
                got = cstruct.c_rowcol(cmask, cptr, cap)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{what}: tile16_c_rowcol differs from "
                                     f"the plain version's at c_nnz_cap "
                                     f"{cap}")
        for dense in denses:
            wv = N.extract_values(dense, *want)
            for _ in range(2):
                with torch_structure_ops_refused(f"{what}, c_rowcol_values"):
                    rc, et, cv = cstruct.c_rowcol_values(cmask, cptr, cap,
                                                         dense)
                if not (torch.equal(rc, want[0]) and torch.equal(et, want[1])
                        and torch.equal(int_view(cv), int_view(wv))):
                    raise AssertionError(
                        f"{what}: tile16_c_rowcol with {dense.dtype} values "
                        f"differs from the plain version's at c_nnz_cap "
                        f"{cap}")
        cases += 1 + len(denses)
    return cases, cmask, cptr


def engineered_structure_cases():
    """tile16_c_masks and tile16_c_rowcol on an engineered stream
    (hold_structure): tile 0 of all 256 bits (one pair of full masks),
    tile 1 without pairs, tile 2 of one pair, tile 3 of 40 (three batches
    of indices), the others 1-3, 10 tiles in a c_cap of 16; padding pairs
    at INT32_MAX (the one-card stream), then at c_cap (the ring's);
    c_nnz_cap above and below C_nnz; float32 and float64 values with -0.0,
    NaN and +-Inf.  Returns the count of cases."""
    g = torch.Generator(device=DEV).manual_seed(37)
    n_a, n_b, tiles, c_cap = 12, 10, 10, 16
    i32 = torch.int32

    def table(n):
        m = torch.randint(0, 1 << 16, (n + 1, 16), generator=g, device=DEV,
                          dtype=i32) & torch.randint(
            0, 1 << 16, (n + 1, 16), generator=g, device=DEV, dtype=i32)
        m[0], m[n] = 0xFFFF, 0          # full, and the padding pairs' tile
        return m

    a_m, b_t = table(n_a), table(n_b)
    counts = torch.tensor([1, 0, 1, 40, 2, 3, 1, 2, 3, 1], device=DEV)
    seg = torch.repeat_interleave(torch.arange(tiles, dtype=i32,
                                               device=DEV), counts)
    n = seg.numel()
    ai = torch.randint(1, n_a, (n,), generator=g, device=DEV, dtype=i32)
    bi = torch.randint(1, n_b, (n,), generator=g, device=DEV, dtype=i32)
    ai[0], bi[0] = 0, 0
    dense = torch.randn((c_cap, 256), generator=g, device=DEV)
    dense[0, :4] = torch.tensor([-0.0, float("nan"), float("inf"),
                                 float("-inf")], device=DEV)
    dense[c_cap - 1, 240] = -0.0        # the padding slots' entry
    cases = 0
    def full(v):
        return torch.full((256 - n,), v, dtype=i32, device=DEV)

    for fill in (symbolic.INT32_MAX, c_cap):
        s = torch.cat([seg, full(fill)])
        c_row = torch.where(s < c_cap, s // 4, symbolic.INT32_MAX)
        c_col = torch.where(s < c_cap, s % 4, symbolic.INT32_MAX)
        k, cmask, _cptr = hold_structure(
            a_m, b_t, torch.cat([ai, full(n_a)]), torch.cat([bi, full(n_b)]),
            s, c_row, c_col, c_cap, (dense, dense.double()),
            lambda nnz: (nnz + 100, nnz - 7), f"engineered, pad {fill}")
        if not (bool((cmask[0] == 0xFFFF).all())
                and not bool(cmask[1].any())
                and not bool(cmask[tiles:].any())):
            raise AssertionError("engineered: the full tile, the tile "
                                 "without pairs or the tiles past the "
                                 "stream's are wrong")
        cases += k
    return cases


def engineered_rowcol_cases():
    """tile16_c_rowcol on engineered row masks (not from a stream), bit for
    bit its plain version (c_rowcol_plain, and extract_values for float32
    and float64 values), two launches each: tiles of 0, 1, 2 and 256 bits,
    rows of 0, 1 and 16 bits, random tiles, the last tile's last row set
    (the padding slots' entry), 300 tiles; c_nnz_cap above (padding), at
    and below C_nnz.  Returns the count of cases."""
    from pem_spgemm_tpu_torch.ops import numeric as N
    g = torch.Generator(device=DEV).manual_seed(43)
    c_cap = 300
    m = torch.randint(0, 1 << 16, (c_cap, 16), generator=g, device=DEV,
                      dtype=torch.int32) & torch.randint(
        0, 1 << 16, (c_cap, 16), generator=g, device=DEV, dtype=torch.int32)
    m[torch.rand((c_cap, 16), generator=g, device=DEV) < 0.3] = 0
    m[0] = 0xFFFF                       # 256 bits: rows of 16
    m[1] = 0                            # no bits
    m[2] = 0
    m[2, 9] = 0x0400                    # one bit
    m[3] = 0
    m[3, 0], m[3, 15] = 0x8000, 0x0001  # two rows of one bit
    m[4, ::2] = 0                       # rows of 0 bits
    m[5, 1::2] = 0xFFFF                 # rows of 16 beside others
    m[c_cap - 1] = 0
    m[c_cap - 1, 15] = 0x8001
    nnz = torch.tensor([bin(int(x) & 0xFFFF).count("1")
                        for x in m.flatten().tolist()],
                       device=DEV).view(c_cap, 16).sum(1)
    cptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=DEV),
                      torch.cumsum(nnz, 0)]).to(torch.int32)
    dense = torch.randn((c_cap, 256), generator=g, device=DEV)
    dense[0, :4] = torch.tensor([-0.0, float("nan"), float("inf"),
                                 float("-inf")], device=DEV)
    dense[c_cap - 1, 240] = -0.0
    total = int(cptr[-1])
    cases = 0
    for cap in (total + 300, total, total - 37):
        want = cstruct.c_rowcol_plain(m, cptr, cap)
        for _ in range(2):
            got = cstruct.c_rowcol(m, cptr, cap)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"engineered rows: tile16_c_rowcol "
                                     f"differs at c_nnz_cap {cap}")
        for v in (dense, dense.double()):
            wv = N.extract_values(v, *want)
            for _ in range(2):
                rc, et, cv = cstruct.c_rowcol_values(m, cptr, cap, v)
                if not (torch.equal(rc, want[0]) and torch.equal(et, want[1])
                        and torch.equal(int_view(cv), int_view(wv))):
                    raise AssertionError(
                        f"engineered rows: tile16_c_rowcol with {v.dtype} "
                        f"values differs at c_nnz_cap {cap}")
        cases += 3
    return cases


def engineered_tile16_cases(worst):
    """Both entries on engineered tiles: +-Inf, NaN, -0.0 and subnormal
    operands (no value near the overflow threshold, where the order of a
    sum decides whether it overflows), C tiles of 3, 1, 0, 2 and 1 pairs
    in a c_cap of 7 (the last two and tile 2 without pairs), padding at
    INT32_MAX; the fresh form with counts and the accumulate form into a C
    with -0.0, +-Inf and NaN in every tile, against the plain version's
    NaN positions, Inf signs, counts bit for bit and the dot-product bound.
    Returns the count of cases."""
    from pem_spgemm_tpu_torch.ops import numeric as N
    g = torch.Generator(device=DEV).manual_seed(23)
    a = torch.randn((6, 256), generator=g, device=DEV)
    b = torch.randn((5, 256), generator=g, device=DEV)
    for t, x in ((a, 0), (b, 1)):
        u = torch.rand(t.shape, generator=g, device=DEV)
        t.masked_fill_(u < 0.3, 0.0)
        t.masked_fill_((u >= 0.3) & (u < 0.35), -0.0)
        t.masked_fill_((u >= 0.35) & (u < 0.38), 1e-40)     # subnormal
    a[1, 5], a[2, 17], b[3, 40] = float("inf"), float("-inf"), float("nan")
    a[4, 0:16] = 0.0                    # a row of A tile 4 all zeros
    a[0] = torch.rand(256, generator=g, device=DEV) + 0.5   # C tile 0's
    b[0] = torch.rand(256, generator=g, device=DEV) + 0.5   # 256 bits
    pairs = [(0, 0, 0), (1, 1, 0), (2, 2, 0), (3, 3, 1), (4, 4, 3),
             (5, 3, 3), (1, 2, 4)]
    pad = 256 - len(pairs)
    cols = torch.tensor(pairs, dtype=torch.int32, device=DEV).T
    ai, bi, seg = (torch.cat([x, torch.full((pad,), f, dtype=torch.int32,
                                            device=DEV)]).contiguous()
                   for x, f in zip(cols, (0, 0, symbolic.INT32_MAX)))
    live = stream_tiles(seg, 7)
    cases = 0
    for dtype in (torch.float32, torch.float64):
        key = TILE16_ENTRY[dtype]
        at, bt = a.to(dtype), b.to(dtype)
        args = (ai, bi, seg, 7, 256, dtype)
        got = tk.accumulate_fused_flat(at, bt, *args)
        want = N.fused_flat_plain(at, bt, *args)
        mag = N.fused_flat_plain(at.abs(), bt.abs(), *args)[0]
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"engineered, {key}: counts differ")
        worst[key] = max(worst[key], tile16_hold(
            got[0], want[0], mag, f"{key}, engineered"))
        if not bool((got[1][0] > 0).all()):
            raise AssertionError("engineered: C tile 0 is not full")
        hold_masks_form(tk.accumulate_fused_masks(at, bt, *args),
                        tk.accumulate_fused_masks(at, bt, *args), got,
                        f"{TILE16_MASKS_ENTRY[dtype]}, engineered")
        ad, bd = at.view(-1, 16, 16), bt.view(-1, 16, 16)
        prior = tile16_prior(7, dtype, 29)
        fresh = tk.accumulate_dense(ad, bd, *args)
        into = tk.accumulate_dense(ad, bd, *args, out=prior.clone())
        hold_tile16_accumulate(into, fresh, prior, live,
                               f"{key}_acc, engineered")
        plain = N.dense_plain(ad, bd, *args, out=prior.clone())
        worst[key + "_acc"] = max(worst[key + "_acc"], tile16_hold(
            into, plain, mag.view(-1, 16, 16)
            + torch.nan_to_num(prior.abs(), 0.0, 0.0),
            f"{key}_acc, engineered"))
        cases += 4
    # the masks form on bfloat16 tables and at "high" / "default": against
    # the counts form on the same tables at the same mode
    args = (ai, bi, seg, 7, 256, torch.float32)
    for at, bt, q in ((a.bfloat16(), b.bfloat16(), "highest"),
                      (a, b, "high"), (a, b, "default")):
        hold_masks_form(
            tk.accumulate_fused_masks(at, bt, *args, precision=q),
            tk.accumulate_fused_masks(at, bt, *args, precision=q),
            tk.accumulate_fused_flat(at, bt, *args, precision=q),
            f"tile16_accumulate_pairs_masks, engineered, {at.dtype}, {q}")
        cases += 1
    return cases + engineered_structure_cases() + engineered_rowcol_cases()


def phase_tile16_kernel_check():
    """The Tile16 kernel on engineered tiles (engineered_tile16_cases) and
    on pairbands-500k's stream (3.1 M pairs, c_cap 1,048,576 in the
    interactive multiply), against its plain version on the card: the fresh
    form with counts at float32, float64 and bfloat16 (values within the
    dtype's dot-product bound, counts bit for bit, two launches bit-equal),
    the masks form against it (hold_masks_form) at each dtype and mode, the
    structure entries against their plain versions (hold_structure, on the
    stream padded at INT32_MAX and at c_cap, and on engineered streams),
    the fresh values-only form bit-equal to the fused form's values, the
    accumulate form at float32 and float64 into a C with -0.0, +-Inf and
    NaN in every tile on a stream whose every fifth tile has no pairs (the
    tiles without pairs bit for bit, the others equal under == to the
    fresh form plus a torch add, and within the bound of the plain
    accumulate form), and at "high" / "default" the entry bit-equal to
    itself at "highest" on tables rounded beforehand, counts those of the
    raw tables, values within the bound of the plain version at the mode.
    Returns the max abs errors by entry."""
    from pem_spgemm_tpu_torch.ops import numeric as N
    t0 = time.perf_counter()
    coo = banded_device(**DIA_MATRICES[TILE16_MATRIX])
    chunk = SpGEMMConfig().numeric_chunk
    worst = {k: 0.0 for k in tk.LAUNCHES}
    worst.update({prec_key("tile16_accumulate_pairs", q): 0.0
                  for q in LOWER_PRECISIONS})
    info, cases = {}, engineered_tile16_cases(worst)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        key = TILE16_ENTRY[dtype]
        a, b, ai, bi, seg, c_cap, n_pairs, c_row, c_col = tile16_stream(
            coo, dtype, coords=True)
        af, bf = a.dense_flat(), b.dense_flat()
        args = (ai, bi, seg, c_cap, chunk, acc)
        got = tk.accumulate_fused_flat(af, bf, *args)
        again = tk.accumulate_fused_flat(af, bf, *args)
        torch.cuda.synchronize()
        if not (torch.equal(int_view(got[0]), int_view(again[0]))
                and torch.equal(got[1], again[1])):
            raise AssertionError(f"{name}: two launches differ")
        del again
        want = N.fused_flat_plain(af, bf, *args)
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"{name}: counts differ from the plain "
                                 "version's")
        mag = N.fused_flat_plain(af.abs(), bf.abs(), *args)[0]
        worst[key] = max(worst[key], tile16_hold(
            got[0], want[0], mag, f"{key}, fused, {name}"))
        del want
        if dtype == torch.bfloat16:
            # the tables read as they lie, widened in registers: bit for
            # bit the result of their float32 copies
            copy = tk.accumulate_fused_flat(af.float(), bf.float(), *args)
            if not (torch.equal(int_view(got[0]), int_view(copy[0]))
                    and torch.equal(got[1], copy[1])):
                raise AssertionError("bfloat16: the tables read directly "
                                     "differ from their float32 copies")
            del copy
            cases += 1
        mkey = TILE16_MASKS_ENTRY[dtype]
        with torch_structure_ops_refused(f"{mkey}, {name}"):
            masks_out = [N.accumulate_fused_masks(af, bf, *args)
                         for _ in range(2)]
        hold_masks_form(*masks_out, got, f"{mkey}, {name}")
        del masks_out
        worst[mkey] = max(worst[mkey], worst[key])  # the same values
        cases += 4
        if dtype == torch.float32:
            # the structure entries at the stream, padded as the one-card
            # stream pads it and as the ring pads it (c_cap), with C_nnz's
            # bucket (padding slots) and a c_nnz_cap below C_nnz
            denses = (got[0], got[0].double())
            for fill in ("int32_max", "c_cap"):
                s = seg if fill == "int32_max" else torch.where(
                    seg < c_cap, seg, c_cap)
                k, cmask, cptr = hold_structure(
                    a.masks, b.tmasks, ai, bi, s, c_row, c_col, c_cap,
                    denses,
                    lambda nnz: (round_up_bucket(nnz), nnz - 1001),
                    f"pairbands-500k, pad {fill}")
                cases += k
            info["structure"] = dict(c_nnz=int(cptr[-1]),
                                     c_nnz_cap=round_up_bucket(
                                         int(cptr[-1])))
            del cmask, cptr, s, denses
        # the values-only form on the masks engine's dense tables
        ad = N.densify_tiles(a.vals, a.rowcol, a.elem_tile, a.tile_cap)
        bd = N.densify_tiles(b.vals, b.rowcol, b.elem_tile, b.tile_cap)
        dense = tk.accumulate_dense(ad, bd, *args)
        if not torch.equal(int_view(dense.view(c_cap, 256)),
                           int_view(got[0])):
            raise AssertionError(f"{name}: the values-only form differs "
                                 "from the fused form's values")
        cases += 1
        info[name] = dict(pairs=n_pairs, p_cap=int(ai.numel()), c_cap=c_cap,
                          a_tiles=a.ntiles)
        if dtype == torch.float32:
            for q in LOWER_PRECISIONS:
                got_q = tk.accumulate_fused_flat(af, bf, *args, precision=q)
                pre = tk.accumulate_fused_flat(
                    M.round_operands(af, q), M.round_operands(bf, q), *args)
                if not (torch.equal(int_view(got_q[0]), int_view(pre[0]))
                        and torch.equal(got_q[1], got[1])):
                    raise AssertionError(f"{q}: the entry differs from "
                                         "itself at highest on rounded "
                                         "tables, or its counts from the "
                                         "raw tables'")
                del pre
                hold_masks_form(
                    tk.accumulate_fused_masks(af, bf, *args, precision=q),
                    tk.accumulate_fused_masks(af, bf, *args, precision=q),
                    got_q, f"{TILE16_MASKS_ENTRY[dtype]}, {q}")
                want_q = N.fused_flat_plain(af, bf, *args, precision=q)
                kq = prec_key("tile16_accumulate_pairs", q)
                worst[kq] = max(worst[kq], tile16_hold(
                    got_q[0], want_q[0], mag, f"{kq}, fused"))
                del got_q, want_q
                cases += 2
        del got, mag
        if dtype != torch.bfloat16:
            # the accumulate form on a stream with interior tiles without
            # pairs
            keep, n_keep, tseg = thinned(seg)
            tai = torch.zeros_like(ai)
            tbi = torch.zeros_like(bi)
            tai[:n_keep], tbi[:n_keep] = ai[keep], bi[keep]
            targs = (tai, tbi, tseg, c_cap, chunk, acc)
            live = stream_tiles(tseg, c_cap)
            prior = tile16_prior(c_cap, acc, 81)
            fresh = tk.accumulate_dense(ad, bd, *targs)
            into = tk.accumulate_dense(ad, bd, *targs, out=prior.clone())
            torch.cuda.synchronize()
            akey = key + "_acc"
            hold_tile16_accumulate(into, fresh, prior, live,
                                   f"{akey}, {name}")
            plain = N.dense_plain(ad, bd, *targs, out=prior.clone())
            tmag = N.dense_plain(ad.abs(), bd.abs(), *targs)
            tmag = tmag + torch.nan_to_num(prior.abs(), 0.0, 0.0)
            worst[akey] = max(worst[akey], tile16_hold(
                into, plain, tmag, f"{akey}, {name}"))
            info[name].update(acc_pairs=n_keep,
                              acc_tiles_with_pairs=int(live.sum()))
            del prior, fresh, into, plain, tmag, tai, tbi, tseg, live
            cases += 3
        del a, b, af, bf, ad, bd, dense, ai, bi, seg, c_row, c_col
        torch.cuda.empty_cache()
    worst["tile16_c_masks"] = worst["tile16_c_rowcol"] = 0.0   # bit for bit
    emit("tile16_kernel_check", matrix=TILE16_MATRIX, cases=cases,
         max_abs_err=worst, streams=info,
         worst_over_bound={k: WORST_OVER.get(k) for k in worst},
         bound="abs err <= 1e-5 * sum|a*b| + 1e-6 (float32 dot product), "
               "<= 1e-12 * sum|a*b| (float64); counts bit for bit; the "
               "masks form's masks and nnz scan those of the counts, its "
               "values bit for bit the counts form's; the structure "
               "entries bit for bit their plain versions; the accumulate "
               "form old + partial under ==, tiles without pairs bit for "
               "bit", seconds=time.perf_counter() - t0)
    return worst


def tile16_bounds(a_val, b_val, ai, bi, n_pairs, c_write, c_read, pattern,
                  precision="highest"):
    """Bounds of the kernel's work.  Operations: 2 * 16^3 a pair, the
    values' products at the FP32 rate (FP64 for float64 tiles: the card's
    peak, on the tensor cores, which DMMA runs at); the counts are not
    counted.  Beside it (``bound_tc_ops_ms``) the operations at the rate
    of the tensor cores that run the products: three TF32 products a
    product at "highest" (3xTF32), one at "high" / "default" and on
    bfloat16 tables, DMMA for float64.  Bytes: each distinct operand tile
    read once (A and B are two tables), ``c_write`` C tiles written once
    (values, and ``pattern`` bytes of structure a tile: 1,024 of float32
    counts, 68 of row masks and nnz scan, or 0), ``c_read`` read."""
    elem = a_val.element_size()
    ops = TILE16_FLOP * n_pairs
    operand_tiles = int(torch.unique(ai[:n_pairs]).numel()
                        + torch.unique(bi[:n_pairs]).numel())
    out_elem = 8 if elem == 8 else 4
    nbytes = 256 * (operand_tiles * elem + (c_write + c_read) * out_elem) \
        + c_write * pattern
    rate, rate_name = (FP64_OPS_PER_S, "FP64 67 TFLOP/s") \
        if elem == 8 else (FP32_OPS_PER_S, "FP32 67 TFLOP/s")
    b_o, b_b = ops / rate, nbytes / HBM_BYTES_PER_S
    if elem == 8:
        tc, tc_name = ops / FP64_OPS_PER_S, "DMMA 67 TFLOP/s"
    elif elem == 4 and precision == "highest":
        tc, tc_name = 3 * ops / TF32_OPS_PER_S, "3xTF32 at 495 TFLOP/s"
    else:
        tc, tc_name = ops / TF32_OPS_PER_S, "TF32 495 TFLOP/s"
    return {"bound_ms": max(b_o, b_b) * 1e3,
            "bound_by": "operations" if b_o >= b_b else "bytes",
            "bound_ops_ms": b_o * 1e3, "bound_bytes_ms": b_b * 1e3,
            "bound_tc_ops_ms": tc * 1e3, "tc_rate": tc_name,
            "operations": ops, "bytes": nbytes,
            "operand_tiles": operand_tiles, "rate": rate_name}


def bmm16_ms(a_val, b_val, ai, bi, per=1 << 20):
    """ms of torch.bmm over the pre-gathered (P, 16, 16) operands (the
    tiles' dtype), the products only (no gather, no sum per C tile), taken
    ``per`` pairs at a time.  A yardstick: the port never calls it on this
    path."""
    M.require_full_fp32()
    total = 0.0
    for lo in range(0, ai.numel(), per):
        ad = a_val[ai[lo:lo + per].long()].view(-1, 16, 16)
        bd = b_val[bi[lo:lo + per].long()].view(-1, 16, 16)
        total += time_ms(lambda: torch.bmm(ad, bd), 3)
        del ad, bd
    return total


def run_launches(name):
    """An entry's launches over phase tile16_path's runs (wrapper and
    replayed), and by run."""
    by_run = {k: v.get(name, 0) for k, v in TILE16_RUN_LAUNCHES.items()}
    return sum(by_run.values()), by_run


def bytes_bound(nbytes):
    """The bound of a function whose work is bit operations and moves:
    its bytes at the card's memory rate."""
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}


def tile16_rows(check_err):
    """The kernels-line rows of the Tile16 kernels at pairbands-500k's
    stream: the accumulation's fresh form with counts in float32 and
    float64 (the JAX package's contract; no path of the card runs it since
    the masks form: the values-only form, the masks engine's, and "high" /
    "default" timed beside it), its masks form in float32 and float64 (the
    fused engine's step: values, row masks and nnz scan), and the
    structure entries tile16_c_masks (the masks engine's step 2b, the
    ring's planner) and tile16_c_rowcol (step 2c: timed with the values,
    as the steady step gathers them, and without, as the interactive
    multiply and the planner call it), those two by CUDA-graph replay
    (``graph_ms``: a wrapper's host work outlasts their launches) beside
    their wrappers' time.  Launches: phase tile16_path's runs."""
    from pem_spgemm_tpu_torch.ops import numeric as N
    coo = banded_device(**DIA_MATRICES[TILE16_MATRIX])
    chunk = SpGEMMConfig().numeric_chunk
    rows = []
    for dtype in (torch.float32, torch.float64):
        acc = dtype
        name = TILE16_ENTRY[dtype]
        a, b, ai, bi, seg, c_cap, n_pairs, c_row, c_col = tile16_stream(
            coo, dtype, coords=True)
        af, bf = a.dense_flat(), b.dense_flat()
        args = (ai, bi, seg, c_cap, chunk, acc)
        ms = time_ms(lambda: tk.accumulate_fused_flat(af, bf, *args))
        launches, by_run = run_launches(name)
        lib_ms = bmm16_ms(af, bf, ai[:n_pairs], bi[:n_pairs])
        lib_covers = (f"torch.bmm in {str(dtype)[6:]} over the pre-gathered "
                      "(P, 16, 16) operands in chunks of 2^20 pairs: the "
                      "products only, without gather, structure and sum "
                      "per C tile")
        runs_on = "DMMA (mma.sync m16n8k8 f64)" \
            if dtype == torch.float64 else \
            "tf32 mma.sync m16n8k8 (3xTF32 at highest; FP32 FMA on " \
            "marked pairs)"
        shape = {"matrix": TILE16_MATRIX, "pairs": n_pairs,
                 "p_cap": int(ai.numel()), "c_cap": c_cap,
                 "a_tiles": a.ntiles}
        row = {
            "name": name, "kernel": "Tile16" + ("-f64" if dtype ==
                                                 torch.float64 else ""),
            "route": "cuda", "source": TILE16_SOURCE,
            "replaces": TILE16_REPLACES, "launches": launches,
            "max_abs_err": max(check_err.get(name, 0.0),
                               check_err.get(name + "_acc", 0.0)),
            "ms": ms,
            "plain_ms": time_ms(lambda: N.fused_flat_plain(af, bf, *args),
                                2),
            **tile16_bounds(af, bf, ai, bi, n_pairs, c_cap, 0, 1024),
            "library_ms": lib_ms, "library_covers": lib_covers,
            "runs_on": runs_on,
            "form": "timed: fresh, values and counts (the JAX package's "
                    "accumulate_fused_flat contract; no path of the card "
                    "runs it since the masks form); launches: the fresh "
                    "forms, i.e. the values-only form of the masks engine "
                    "(float32) and of a ring rank's first stage (the "
                    "sharded paths' launches are added to the row in main)",
            **shape, "launches_by_run": by_run}
        ad = N.densify_tiles(a.vals, a.rowcol, a.elem_tile, a.tile_cap)
        bd = N.densify_tiles(b.vals, b.rowcol, b.elem_tile, b.tile_cap)
        row["values_only_ms"] = time_ms(
            lambda: tk.accumulate_dense(ad, bd, *args))
        row["values_only_plain_ms"] = time_ms(
            lambda: N.dense_plain(ad, bd, *args), 2)
        del ad, bd
        if dtype == torch.float32:
            for q in LOWER_PRECISIONS:
                row[f"ms_at_{q}"] = time_ms(lambda: tk.accumulate_fused_flat(
                    af, bf, *args, precision=q))
                row[f"max_abs_err_at_{q}"] = check_err.get(
                    prec_key(name, q), 0.0)
        rows.append(row)
        mname = TILE16_MASKS_ENTRY[dtype]
        launches, by_run = run_launches(mname)
        mrow = {
            "name": mname, "kernel": "Tile16 masks form" + (
                "-f64" if dtype == torch.float64 else ""),
            "route": "cuda", "source": TILE16_SOURCE,
            "replaces": STRUCT_REPLACES["masks_form"],
            "launches": launches, "max_abs_err": check_err.get(mname, 0.0),
            "ms": time_ms(lambda: tk.accumulate_fused_masks(af, bf, *args)),
            "plain_ms": time_ms(lambda: N.fused_masks_plain(af, bf, *args),
                                2),
            **tile16_bounds(af, bf, ai, bi, n_pairs, c_cap, 0, 68),
            "library_ms": lib_ms,
            "library_covers": lib_covers + " (the counts form's row's "
                              "measurement: the same call)",
            "runs_on": runs_on,
            "form": "fresh, values, row masks and nnz scan (the fused "
                    "engine's step 3)",
            **shape, "launches_by_run": by_run}
        if dtype == torch.float32:
            for q in LOWER_PRECISIONS:
                mrow[f"ms_at_{q}"] = time_ms(
                    lambda: tk.accumulate_fused_masks(af, bf, *args,
                                                      precision=q))
                mrow[f"bound_tc_ops_ms_at_{q}"] = tile16_bounds(
                    af, bf, ai, bi, n_pairs, c_cap, 0, 68,
                    q)["bound_tc_ops_ms"]
            a16, b16 = af.bfloat16(), bf.bfloat16()
            mrow["ms_bf16_tables"] = time_ms(
                lambda: tk.accumulate_fused_masks(a16, b16, *args))
            mrow["bound_ms_bf16_tables"] = tile16_bounds(
                a16, b16, ai, bi, n_pairs, c_cap, 0, 68)["bound_ms"]
            del a16, b16
        rows.append(mrow)
        if dtype == torch.float32:
            dense = tk.accumulate_fused_masks(af, bf, *args)[0]
            rows += tile16_structure_rows(a, b, ai, bi, seg, c_row, c_col,
                                          c_cap, n_pairs, dense)
            del dense
        del a, b, af, bf, ai, bi, seg, c_row, c_col
        torch.cuda.empty_cache()
    return rows


def tile16_structure_rows(a, b, ai, bi, seg, c_row, c_col, c_cap, n_pairs,
                          dense):
    """The rows of tile16_c_masks and tile16_c_rowcol at a stream (the
    interactive multiply's), the latter with ``dense``'s values and
    without.  Bounds: bytes, each input read once and each output written
    once (c_masks: the stream's three index arrays, each distinct A and B
    mask tile, the masks, nnz scan and pair offsets; c_rowcol: the masks,
    the nnz scan, the C_nnz values it gathers, three words a slot)."""
    from pem_spgemm_tpu_torch.ops import numeric as N
    m_args = (a.masks, b.tmasks, ai, bi, seg, c_cap)
    cmask, cptr, _pp = tk.c_masks(*m_args)
    c_nnz = int(cptr[-1])
    cap = round_up_bucket(c_nnz)
    distinct = int(torch.unique(ai[:n_pairs]).numel()
                   + torch.unique(bi[:n_pairs]).numel())
    launches, by_run = run_launches("tile16_c_masks")
    shape = {"matrix": TILE16_MATRIX, "pairs": n_pairs, "c_cap": c_cap,
             "c_nnz": c_nnz}
    rows = [{
        "name": "tile16_c_masks", "kernel": "Tile16 structure (step 2b)",
        "route": "cuda", "source": STRUCT_SOURCE,
        "replaces": STRUCT_REPLACES["tile16_c_masks"], "launches": launches,
        "max_abs_err": 0.0,
        "ms": graph_ms(lambda: tk.c_masks(*m_args)),
        "wrapper_ms": time_ms(lambda: tk.c_masks(*m_args)),
        "plain_ms": time_ms(lambda: cstruct.c_masks_plain(
            a.masks, b.tmasks, ai, bi, seg, c_row, c_col, c_cap), 2),
        "plain_covers": "cstruct.c_masks_plain, its two tile-coordinate "
                        "scatters included",
        **bytes_bound(12 * n_pairs + 64 * distinct + 72 * c_cap + 8),
        "library_ms": None,
        "library_covers": "none: no one PyTorch call computes it",
        "runs_on": "integer AND / OR, shuffles", **shape,
        "launches_by_run": by_run}]
    rc, et = tk.c_rowcol(cmask, cptr, cap)
    flat = dense.reshape(-1)
    pos = et.long() * 256 + rc.long()
    launches, by_run = run_launches("tile16_c_rowcol")
    rows.append({
        "name": "tile16_c_rowcol", "kernel": "Tile16 structure (step 2c)",
        "route": "cuda", "source": STRUCT_SOURCE,
        "replaces": STRUCT_REPLACES["tile16_c_rowcol"], "launches": launches,
        "max_abs_err": 0.0,
        "ms": graph_ms(lambda: tk.c_rowcol(cmask, cptr, cap, dense)),
        "wrapper_ms": time_ms(lambda: tk.c_rowcol(cmask, cptr, cap, dense)),
        "ms_without_values": graph_ms(lambda: tk.c_rowcol(cmask, cptr, cap)),
        "plain_ms": time_ms(lambda: N.extract_values(
            dense, *cstruct.c_rowcol_plain(cmask, cptr, cap)), 2),
        "plain_ms_without_values": time_ms(
            lambda: cstruct.c_rowcol_plain(cmask, cptr, cap), 2),
        **bytes_bound(68 * c_cap + 4 + 4 * c_nnz + 12 * cap),
        "bound_ms_without_values": (68 * c_cap + 4 + 8 * cap)
        / HBM_BYTES_PER_S * 1e3,
        "library_ms": graph_ms(lambda: flat[pos]),
        "library_covers": "flat[pos]: the value gather alone, at the "
                          "kernel's slots (positions made beforehand)",
        "runs_on": "shuffle scan, slots to lanes in order (binary search "
                   "of the row, popc rank-select of the column)", **shape,
        "c_nnz_cap": cap,
        "launches_by_run": by_run})
    return rows


def tile16_acc_row(plans, plan1, check_err, acc=torch.float32):
    """The row of the float32 entry's accumulate form (of the float64
    entry's, for float64 plans with ``acc`` float64), timed on the 4-rank
    Tile16 ring's largest accumulating stage (sm.largest_accumulating_stage)
    into a C with -0.0, +-Inf and NaN in every tile, beside its plain
    version, the fresh
    form on the same stream and torch.bmm over the stage's pairs; and on
    the world-size-1 ring's stream (every C tile has pairs), into the same
    C as the fresh form writes."""
    from pem_spgemm_tpu_torch.ops import numeric as N
    from pem_spgemm_tpu_torch.parallel import sharded as sh
    f64 = acc == torch.float64
    name = "tile16_accumulate_pairs" + ("_f64" if f64 else "") + "_acc"
    d, s = sm.largest_accumulating_stage(plans)
    p = plans[d]
    b = list(sh.replay_chunks(plans, d))[s]
    args = (p.pairs_a[s], p.pairs_b[s], p.seg[s], p.c_cap,
            p.pairs_a.shape[1], acc)
    n_pairs = p.stage_pairs[s]
    live = stream_tiles(p.seg[s], p.c_cap)
    tiles = int(live.sum())
    prior = tile16_prior(p.c_cap, acc, 91)
    fresh = tk.accumulate_dense(p.a_dense, b, *args)
    into = tk.accumulate_dense(p.a_dense, b, *args, out=prior.clone())
    hold_tile16_accumulate(into, fresh, prior, live, f"{name}, ring stage")
    plain = N.dense_plain(p.a_dense, b, *args, out=prior.clone())
    mag = N.dense_plain(p.a_dense.abs(), b.abs(), *args) \
        + torch.nan_to_num(prior.abs(), 0.0, 0.0)
    err = tile16_hold(into, plain, mag, f"{name}, ring stage")
    del fresh, into, plain, mag
    c = prior.clone()
    # a launch this short is timed by graph replay (the wrapper's host work
    # outlasts it; its time through the wrapper beside)
    ms = graph_ms(lambda: tk.accumulate_dense(p.a_dense, b, *args, out=c))
    wrapper_ms = time_ms(lambda: tk.accumulate_dense(p.a_dense, b, *args,
                                                     out=c))
    ad = p.a_dense[p.pairs_a[s][:n_pairs].long()]
    bd = b[p.pairs_b[s][:n_pairs].long()]
    lib_graph_ms = graph_ms(lambda: torch.bmm(ad, bd))
    del ad, bd
    s1 = next(i for i, x in enumerate(plan1.stage_pairs) if x)
    args1 = (plan1.pairs_a[s1], plan1.pairs_b[s1], plan1.seg[s1],
             plan1.c_cap, plan1.pairs_a.shape[1], acc)
    c1 = tk.accumulate_dense(plan1.a_dense, plan1.b_dense, *args1)
    point = {"pairs": plan1.stage_pairs[s1], "c_cap": plan1.c_cap,
             "tiles_with_pairs": int(stream_tiles(plan1.seg[s1],
                                                  plan1.c_cap).sum()),
             "ms": time_ms(lambda: tk.accumulate_dense(
                 plan1.a_dense, plan1.b_dense, *args1, out=c1), 10),
             "fresh_form_ms": time_ms(lambda: tk.accumulate_dense(
                 plan1.a_dense, plan1.b_dense, *args1), 10)}
    row = {
        "name": name, "kernel": "Tile16 accumulate form"
        + ("-f64" if f64 else ""), "route": "cuda",
        "source": TILE16_SOURCE, "replaces": TILE16_REPLACES,
        "jax_ring_stage": "pem_spgemm_tpu/parallel/sharded.py:225 "
                          "(c_dense.at[sg].add(prod))",
        "launches": None, "max_abs_err": max(err, check_err.get(name, 0.0)),
        "ms": ms,
        "plain_ms": time_ms(lambda: N.dense_plain(p.a_dense, b, *args,
                                                  out=c), 2),
        **tile16_bounds(p.a_dense, b, p.pairs_a[s], p.pairs_b[s], n_pairs,
                        tiles, tiles, 0),
        "wrapper_ms": wrapper_ms,
        "library_ms": lib_graph_ms,
        "library_wrapper_ms": bmm16_ms(p.a_dense, b, p.pairs_a[s][:n_pairs],
                                       p.pairs_b[s][:n_pairs]),
        "library_covers": "torch.bmm" + (" in float64" if f64 else "")
                          + " over the stage's pre-gathered "
                          "(P, 16, 16) operands: the products only, by "
                          "graph replay as the kernel (library_wrapper_ms: "
                          "by CUDA events around eager calls)",
        "fresh_form_ms": time_ms(lambda: tk.accumulate_dense(
            p.a_dense, b, *args)),
        "matrix": TILE16_MATRIX, "ring": f"{len(plans)} ranks replayed",
        "rank": d, "stage": s, "pairs": n_pairs, "tiles_with_pairs": tiles,
        "c_cap": p.c_cap, "at_world_size_1_stream": point,
        "timed": "one launch into the rank's C (c_cap tiles), the stage's "
                 "stream as the ring hands it over, by graph replay "
                 "(wrapper_ms: eager calls); fresh_form_ms: the fresh "
                 "values-only form on the same stream (it writes all c_cap "
                 "tiles)"}
    del c, c1, prior
    torch.cuda.empty_cache()
    return row


# the Tile16 step's functions, as ops.fixed.spgemm_fixed calls them, by the
# share of a steady multiply they stand for in --profile
TILE16_SCOPES = {
    "symbolic": (("symbolic", "pair_counts"), ("symbolic", "expand_pairs")),
    "accumulate": (("numeric", "accumulate_fused_masks"),),
    "structure.c_tile_coords": (("cstruct", "c_tile_coords"),),
    "structure.c_rowcol_values": (("cstruct", "c_rowcol_values"),),
}
# kernels launched through ctypes, which the profiler ties to no scope: by
# name, with the share they are counted in
TILE16_NAMED_KERNELS = {"accumulate.tile16_kernel": r"tile16_kernel",
                        "structure.c_rowcol_kernel": r"c_rowcol_kernel"}
# kernels of the accumulation, by what launches them
ACCUMULATE_KERNELS = (("tile16_kernel", r"tile16_kernel"),
                      ("bmm", r"gemm|cutlass|xmma|Kernel2"),
                      ("index_add_", r"indexFunc|index_add"),
                      ("gathers", r"index|gather"))


def tile16_scoped(fn):
    """Run fn() with each function of TILE16_SCOPES inside a
    torch.profiler.record_function scope named after its share."""
    import contextlib
    import functools
    from torch.profiler import record_function
    from pem_spgemm_tpu_torch.ops import fixed
    saved = []

    def scoped(share, f):
        @functools.wraps(f)
        def g(*a, **kw):
            with record_function(f"tile16.{share}"):
                return f(*a, **kw)
        return g

    with contextlib.ExitStack() as stack:
        for share, names in TILE16_SCOPES.items():
            for mod, attr in names:
                m = getattr(fixed, mod)
                saved.append((m, attr, getattr(m, attr)))
                setattr(m, attr, scoped(share, getattr(m, attr)))
        stack.callback(lambda: [setattr(m, k, f) for m, k, f in saved])
        return fn()


def tile16_split(multiply, n):
    """Device ms a multiply by share (symbolic, accumulate split into
    the Tile16 kernel / other, structure), from torch.profiler over n eager
    multiplies with the shares' scopes.  The kernels are launched through
    ctypes, not by a torch op, so the profiler ties them to no scope: their
    shares are their device times by name (TILE16_NAMED_KERNELS); with a
    share's torch ops the step's shares sum to its device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tile16_scoped(lambda: [multiply() for _ in range(n)])
        torch.cuda.synchronize()
    split = {}

    def kernels(evt):
        for k in evt.kernels:
            yield k.name, k.duration
        for ch in evt.cpu_children:
            yield from kernels(ch)

    for evt in prof.events():
        if not evt.name.startswith("tile16."):
            continue
        share = evt.name.split(".", 1)[1]
        for kname, us in kernels(evt):
            key = share
            if share == "accumulate":
                key = next((f"accumulate.{k}" for k, pat in
                            ACCUMULATE_KERNELS if re.search(pat, kname)),
                           "accumulate.other")
            split[key] = split.get(key, 0.0) + us / 1e3 / n
    for key, pat in TILE16_NAMED_KERNELS.items():
        split[key] = sum(e.self_device_time_total
                         for e in prof.key_averages()
                         if re.search(pat, e.key)) / 1e3 / n
    return split


def run_profile_tile16(matrix, n, graph=False):
    """pairbands-500k's steady Tile16 multiply (engine fused): the plan's
    CUDA graph replayed (with ``graph``: the eager step and the replay in
    turns), host-clock synced and queued ms, device-busy time, idle share
    and device ops (torch.profiler), and the eager step's device time split
    by share."""
    coo = banded_device(**DIA_MATRICES[matrix])
    a = coo_to_tiled(coo)
    b = coo_to_tiled(coo, with_tmasks=True)
    del coo
    cfg = SpGEMMConfig(engine="fused")
    res = SpGEMM(cfg)(a, b)
    plan = make_plan(res, cfg, a, b)
    emit("profile_setup", matrix=matrix, engine="fused", c_nnz=res.c_nnz,
         n_pairs=res.n_pairs, c_ntiles=res.c_ntiles,
         plan=dict(p_cap=plan.p_cap, c_cap=plan.c_cap,
                   c_nnz_cap=plan.c_nnz_cap, chunk=plan.chunk))
    del res

    def eager():
        return plan.multiply(a, b)[6][:1]

    def replay():
        return plan.run(a, b)[6][:1]

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    int(replay() != 0)                     # captures
    peak_graph = (torch.cuda.max_memory_allocated() - base) / 2**30
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    int(eager() != 0)
    peak_eager = (torch.cuda.max_memory_allocated() - base) / 2**30
    turns = [("graph", replay), ("graph", replay)]
    if graph:
        turns = [("eager", eager)] + turns + [("eager", eager)]
    emit("profile_steady", matrix=matrix, engine="fused",
         peak_mem_gb={"eager": peak_eager, "graph": peak_graph},
         times=turns_ms(turns, n),
         device_ms_replay=time_ms(replay, n),
         device_split_ms_eager=tile16_split(eager, max(2, n // 4)))
    for name, fn in turns:
        profile_device(f"{matrix} fused {name}", fn, n)


# --------------------------------------------------------------------------
# bf16 on the element, DIA and Macro128 engines; the multi-GPU layer

# name, engine, C_nnz of the float32 run (recorded in the phases above)
BF16_RUNS = (("powerlaw-1M", "element", 43_282_438),
             ("banded64-1M", "dia", 126_995_967),
             ("wandering64-1M", "macro", 151_873_407))
HALF_BF16_ULP = 2.0 ** -8       # relative to the rounded value
# launches a kernel entry made on this slice's paths, by path (read just
# after each path run, with the counts set to 0 just before it)
NEW_PATH_LAUNCHES = {"bf16_path": {}, "sharded_path": {}, "sharded_ranks": {},
                     "aat_path": {}}
SHARDED_RANKS = 4


def add_path_launches(path, launches):
    into = NEW_PATH_LAUNCHES[path]
    for k, v in launches.items():
        into[k] = into.get(k, 0) + v


def all_counts():
    return path_launches({**ss.LAUNCHES, **dk.LAUNCHES, **mk.LAUNCHES,
                          **tk.LAUNCHES})


def product_rows(coo, rows=None, aat=False, bf16=False):
    """(rows, cols, want, mag) of A@A (A@A.T with ``aat``) in the rows
    ``rows`` (ascending; every row when None), sorted, on the host: C's
    structure from the product of |A| (scipy drops sums that cancel to 0.0,
    the engines keep them), the float64 product's values read there (0.0
    where scipy dropped the entry), and sum|a*b| of each entry.  With
    ``bf16``, of A's values rounded to bfloat16."""
    v = torch.as_tensor(coo.vals)
    if bf16:
        v = v.to(torch.bfloat16)
    s = COOMatrix(coo.rows, coo.cols, v.to(torch.float64).cpu().numpy(),
                  coo.shape).to_scipy().tocsr()
    right = s.T.tocsr() if aat else s
    left = s if rows is None else s[rows]
    mag = abs(left) @ abs(right)
    val = left @ right
    mag.sort_indices()
    val.sort_indices()
    r = np.repeat(np.arange(mag.shape[0]), np.diff(mag.indptr))
    c = mag.indices
    if val.nnz == mag.nnz:       # scipy dropped nothing: the same structure
        want = val.data
    else:
        key = r.astype(np.int64) * mag.shape[1] + c
        vr = np.repeat(np.arange(val.shape[0]), np.diff(val.indptr))
        want = np.zeros(len(key))
        want[np.searchsorted(key, vr.astype(np.int64) * val.shape[1]
                             + val.indices)] = val.data
    if rows is not None:
        r = np.asarray(rows)[r]
    return r, c, want, mag.data


def hold_product(rows, cols, vals, want, what, ulp=HALF_BF16_ULP):
    """Exact structure; |got - want| <= 1e-5 * sum|a*b| + 1e-6 + ulp |got|
    (the float32 bound against the product of the operands as converted,
    plus, where C is rounded to bfloat16, half a bfloat16 ulp of the
    rounded result; ``ulp=0`` where C stays float32).  The worst ratio."""
    wr, wc, wv, mag = want
    if not (np.array_equal(rows, wr) and np.array_equal(cols, wc)):
        raise AssertionError(f"{what}: sorted COO structure differs")
    if not np.all(np.isfinite(vals)):
        raise AssertionError(f"{what}: non-finite values")
    over = float((np.abs(vals - wv) / (COO_RTOL * mag + COO_ATOL
                                       + ulp * np.abs(vals)))
                 .max()) if len(wv) else 0.0
    if not over <= 1.0:
        raise AssertionError(f"{what}: values exceed the bound by {over}x")
    return over


def sample_rows(n_rows, seed=17):
    g = np.random.default_rng(seed)
    return np.sort(g.choice(n_rows, F64_SAMPLE_ROWS, replace=False))


def coo_rows(rows, cols, vals, pick):
    """The entries of sorted COO arrays (host) in the rows ``pick``."""
    lo = np.searchsorted(rows, pick, side="left")
    hi = np.searchsorted(rows, pick, side="right")
    take = np.concatenate([np.arange(x, y) for x, y in zip(lo, hi)])
    return rows[take], cols[take], vals[take]


def device_rows(rows, cols, vals, pick):
    """The entries of sorted COO tensors on the card in the rows ``pick``,
    copied to the host (float64 values as they are, others as float32)."""
    keep = torch.isin(rows, torch.as_tensor(pick, device=rows.device))
    vals = vals[keep]
    return (rows[keep].cpu().numpy(), cols[keep].cpu().numpy(),
            (vals if vals.dtype == torch.float64 else vals.float())
            .cpu().numpy())


def phase_bf16_path(coo_pl):
    """bfloat16 values (float32 accumulation) on one suite matrix an
    engine, through run_benchmark at full size, repeat 2: powerlaw-1M on
    the element engine (the merge engine), banded64-1M on the DIA engine
    (K2 on the bands' float32 copies), wandering64-1M on the Macro128
    engine (K4 interactive, K5 steady).  C_nnz equal to the float32 run's.
    C is rounded to bfloat16 on the first two, and its values are held to
    the bfloat16 bound (the Tile16 tier's); the Macro128 engine keeps C in
    float32, as the JAX package does, held to the float32 bound.
    powerlaw-1M against scipy, every entry; banded64-1M against the plain
    path on the card over the bands' float32 copies; wandering64-1M
    against scipy on sampled rows.  The structure is |A|@|A|'s, A's values
    rounded to bfloat16."""
    out = {}
    for name, engine, want_nnz in BF16_RUNS:
        if name == "powerlaw-1M":
            coo = coo_pl
        elif name == "wandering64-1M":
            coo = MACRO_MATRICES[name]()
        else:
            coo = banded_device(**DIA_MATRICES[name])
        cfg = SpGEMMConfig(engine=engine, dtype=torch.bfloat16,
                           acc_dtype=torch.float32, repeat=2)
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec, res = run_benchmark(coo, name, cfg, verbose=False)
        run_s = time.perf_counter() - t0
        launches = nonzero(all_counts())
        add_path_launches("bf16_path", launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        what = f"{name} bf16 {engine}"
        c_dtype = torch.float32 if engine == "macro" else torch.bfloat16
        if res.engine != engine or res.c_nnz != want_nnz \
                or rec.c_nnz != want_nnz or res.vals.dtype != c_dtype:
            raise AssertionError(f"{what}: engine {res.engine}, C_nnz "
                                 f"{res.c_nnz} (float32 {want_nnz}), "
                                 f"values {res.vals.dtype}")
        if engine == "element":
            if res.binned is not None or launches:
                raise AssertionError(f"{what}: not the merge engine "
                                     f"({launches})")
            c = res.to_coo()
            want, order, mag = bf16_reference(coo)
            over = hold_product(c.rows, c.cols, c.vals,
                             (want.row[order], want.col[order],
                              want.data[order], mag), what)
            checked = "scipy, every entry"
            del c, want
        elif engine == "dia":
            if launches.get("dia_multiply_dense", 0) <= 0:
                raise AssertionError(f"{what}: launches {launches}")
            a = D.coo_to_dia(coo, dtype=torch.bfloat16)
            wide = a.acc_bands()
            offs = a.offsets
            dc_list, idx_map = D._plan_maps(offs, offs)
            kw = dict(offs_a=offs, idx_map=idx_map, dc_count=len(dc_list),
                      n_out=a.shape[0])
            want = D._dia_multiply_torch(wide, wide, **kw)
            got = res.vals.float()
            bound = dia_bound(wide, wide, offs, idx_map, len(dc_list),
                              a.shape[0]) + HALF_BF16_ULP * got.abs()
            dia_hold((got, res.c_counts), want, bound, what, label="bfloat16")
            over = float(((got - want[0]).abs() / bound).max())
            checked = "plain path on the card over the bands' float32 copies"
            del a, wide, want, got, bound
        else:
            if launches.get("macro_accumulate_pairs", 0) <= 0 or \
                    launches.get("macro_class_ragged", 0) <= 0:
                raise AssertionError(f"{what}: launches {launches}")
            c = res.to_coo()
            pick = sample_rows(coo.shape[0])
            over = hold_product(*coo_rows(c.rows, c.cols, c.vals, pick),
                             product_rows(coo, pick, bf16=True),
                             f"{what} sampled rows",
                             ulp=0.0)
            checked = f"scipy, {F64_SAMPLE_ROWS:,} sampled rows"
            del c
        del res
        torch.cuda.empty_cache()
        out[name] = record_times(rec)
        emit("bf16_path", matrix=name, engine=engine, flop=rec.flop,
             c_nnz=rec.c_nnz, float32_c_nnz=want_nnz, checked_against=checked,
             values_worst_over_bound=over, c_dtype=str(c_dtype),
             bound=("|err| <= 1e-5 * sum|a*b| + 1e-6"
                    + (" + 2^-8 |got|" if engine != "macro" else "")
                    + ", against the bfloat16-rounded operands' product"),
             launches=launches, times_ms=record_times(rec), peak_mem_gb=peak,
             run_benchmark_s=run_s)
    return out


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def synced_ms(fn):
    """(fn()'s result, its ms with the card synchronised on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def balance(times):
    return max(times) / (sum(times) / len(times))


def union_sorted(parts):
    """The ranks' (rows, cols, vals) on the card, concatenated and sorted."""
    rows, cols, vals = (torch.cat([x[i] for x in parts]) for i in range(3))
    order = torch.sort((rows.long() << 32) | cols.long()).indices
    return rows[order].long(), cols[order].long(), vals[order]


def sharded_element_runs(coo, ref, mesh):
    """powerlaw-1M: world size 1 over NCCL, then the 4-rank replay."""
    from pem_spgemm_tpu_torch.parallel import sharded_element as se
    want_nnz = BF16_RUNS[0][2]
    a = coo_to_tiled(coo)
    a.element_csr()
    reset_launch_counts()
    plan, plan_ms = synced_ms(lambda: se.plan_sharded_element(a, a, 1, 0))
    se.sharded_element_multiply(plan, mesh)          # first: warms up
    (stream, c_nnz), mul_ms = synced_ms(
        lambda: se.sharded_element_multiply(plan, mesh))
    (rows, cols, vals), asm_ms = synced_ms(
        lambda: se.assemble_sharded_element(plan, stream, mesh))
    launches = nonzero(all_counts())
    add_path_launches("sharded_path", launches)
    if launches.get("segment_dedup", 0) <= 0 or c_nnz != want_nnz:
        raise AssertionError(f"sharded element: C_nnz {c_nnz}, launches "
                             f"{launches}")
    _cancelled, over = check_coo(rows, cols, vals, ref, "sharded element")
    emit("sharded_path", decomposition="element", matrix="powerlaw-1M",
         world_size=1, backend=torch.distributed.get_backend(), c_nnz=c_nnz,
         checked_against="scipy, every entry", values_worst_over_bound=over,
         launches=launches, plan_ms=plan_ms, multiply_ms=mul_ms,
         assemble_ms=asm_ms)
    del plan, stream, rows, cols, vals
    n = SHARDED_RANKS
    reset_launch_counts()
    plans, plan_ms = [], []
    for d in range(n):
        p, ms = synced_ms(lambda: se.plan_sharded_element(a, a, n, d))
        plans.append(p)
        plan_ms.append(ms)
    parts, times = [], []
    for p in plans:
        part, ms = synced_ms(lambda: se.local_coo(
            se.local_element_multiply(p), p.col_bounds.device))
        parts.append(part)
        times.append(ms)
    launches = nonzero(all_counts())
    add_path_launches("sharded_ranks", launches)
    rows, cols, vals = union_sorted(parts)
    if len(rows) != want_nnz or launches.get("segment_dedup", 0) <= 0:
        raise AssertionError(f"element replay: C_nnz {len(rows)}, launches "
                             f"{launches}")
    _cancelled, over = check_coo(rows.cpu().numpy(), cols.cpu().numpy(),
                                 vals.cpu().numpy(), ref, "element replay")
    emit("sharded_ranks", decomposition="element", matrix="powerlaw-1M",
         ranks=n, c_nnz=len(rows), checked_against="scipy, every entry",
         values_worst_over_bound=over, launches=launches,
         rank_products=[p.n_products for p in plans],
         rank_plan_ms=plan_ms, rank_ms=times, load_balance=balance(times))


def sharded_dia_runs(mesh):
    """banded64-1M: world size 1 over NCCL (K2), then the 4-rank replay;
    C against the plain path on the card within the float32 bound, counts
    exact."""
    from pem_spgemm_tpu_torch.parallel import sharded_dia as sd
    name = "banded64-1M"
    want_nnz = DIA_RECORDED[name][0]
    a = D.coo_to_dia(banded_device(**DIA_MATRICES[name]))
    offs = a.offsets
    dc_list, idx_map = D._plan_maps(offs, offs)
    kw = dict(offs_a=offs, idx_map=idx_map, dc_count=len(dc_list),
              n_out=a.shape[0])
    want = D._dia_multiply_torch(a.bands, a.bands, **kw)
    bound = dia_bound(a.bands, a.bands, offs, idx_map, len(dc_list),
                      a.shape[0])
    reset_launch_counts()
    sd.sharded_dia_multiply(a, a, mesh)              # first: warms up
    (c, cnt, dcs), ms = synced_ms(lambda: sd.sharded_dia_multiply(a, a, mesh))
    launches = nonzero(all_counts())
    add_path_launches("sharded_path", launches)
    c_nnz = int((cnt > 0).sum())
    if tuple(dcs) != dc_list or c_nnz != want_nnz \
            or launches.get("dia_multiply_dense", 0) != 2:
        raise AssertionError(f"sharded dia: C_nnz {c_nnz}, launches "
                             f"{launches}")
    err = dia_hold((c, cnt), want, bound, "sharded dia")
    emit("sharded_path", decomposition="dia", matrix=name, world_size=1,
         c_nnz=c_nnz, checked_against="plain path on the card",
         max_abs_err=err, launches=launches, multiply_ms=ms)
    del c, cnt
    n = SHARDED_RANKS
    geo = sd.dia_blocks(a, a, n)
    tables = dk.dia_tables(offs, offs, geo.dc_list, geo.mode, a.bands.device)
    reset_launch_counts()
    blocks, times = [], []
    for d in range(n):
        a_blk, b_halo = sd.replay_blocks(a, a, geo, d)
        out, ms = synced_ms(lambda: sd.local_dia(a_blk, b_halo, a, a, geo,
                                                 tables))
        blocks.append(out)
        times.append(ms)
    launches = nonzero(all_counts())
    add_path_launches("sharded_ranks", launches)
    c = torch.cat([b[0] for b in blocks], 1)[:, :a.shape[0]]
    cnt = torch.cat([b[1] for b in blocks], 1)[:, :a.shape[0]]
    c_nnz = int((cnt > 0).sum())
    if c_nnz != want_nnz or launches.get("dia_multiply_dense", 0) != n:
        raise AssertionError(f"dia replay: C_nnz {c_nnz}, launches "
                             f"{launches}")
    err = dia_hold((c, cnt), want, bound, "dia replay")
    emit("sharded_ranks", decomposition="dia", matrix=name, ranks=n,
         c_nnz=c_nnz, checked_against="plain path on the card",
         max_abs_err=err, launches=launches, halo=(geo.hl, geo.hr),
         block_columns=geo.l, rank_ms=times, load_balance=balance(times))


def ring_composition(p, chunks, precision="highest"):
    """(C, ms, peak GB, may_differ) of a rank's C composed from K4's fresh
    form: a zero C, each stage's fresh output added by torch and its flags
    ORed in (the script's reference for the ring, run after the path's
    counts are read), with its time and its peak device memory above what
    was allocated before it (bfloat16 tables as their float32 copies, as
    local_macro takes them).  ``may_differ``: (c_cap,) bool, the tiles that
    a stage after the rank's first with pairs may leave untouched in the
    accumulate form, so that a zero's sign may differ there: the tiles
    without pairs in that stage, and (a tile none of whose slabs runs is
    not stored) the tiles whose fresh output in that stage is all zeros
    with no flags.  Working
    out ``may_differ`` is left out of the time."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    aside = 0.0
    a = sm.acc_slice(p)
    num = torch.zeros((p.c_cap, 128, 128), dtype=a.dtype, device=DEV)
    flag = torch.zeros((p.c_cap, 128, 128), dtype=torch.uint8, device=DEV)
    may = torch.zeros(p.c_cap, dtype=torch.bool, device=DEV)
    first = True
    for s, b in enumerate(chunks):
        if p.stage_pairs[s]:
            part, part_f = mk.accumulate_macro_pairs(
                a, b.to(a.dtype), p.pairs_a[s], p.pairs_b[s], p.seg[s],
                p.c_cap, chunk=min(256, p.pairs_a.shape[1]),
                precision=precision)
            num += part
            flag |= part_f
            if not first:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                may |= ~stream_tiles(p.seg[s], p.c_cap)
                for lo in range(0, p.c_cap, 2048):
                    may[lo:lo + 2048] |= (
                        (part[lo:lo + 2048] == 0).flatten(1).all(1)
                        & (part_f[lo:lo + 2048] == 0).flatten(1).all(1))
                torch.cuda.synchronize()
                aside += time.perf_counter() - t1
            first = False
            del part, part_f
    torch.cuda.synchronize()
    return ((num, flag), (time.perf_counter() - t0 - aside) * 1e3,
            (torch.cuda.max_memory_allocated() - before) / 2**30, may)


def hold_composition(got, want, may_differ, what, tiles=4096):
    """A ring's C against ring_composition's: values equal under == (NaN
    where it has NaN), flags bit for bit; a zero's sign may differ only in
    the tiles ``may_differ`` marks.  Returns the count of zeros whose sign
    differs."""
    (gn, gf), (wn, wf) = got, want
    if not torch.equal(gf, wf):
        raise AssertionError(f"{what}: flags differ from the composition's")
    signs = 0
    for lo in range(0, gn.shape[0], tiles):
        g, w = gn[lo:lo + tiles], wn[lo:lo + tiles]
        if not bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all()):
            raise AssertionError(f"{what}: values differ from the "
                                 "composition's")
        flip = (g == 0) & (torch.signbit(g) != torch.signbit(w))
        if bool((flip & ~may_differ[lo:lo + tiles, None, None]).any()):
            raise AssertionError(f"{what}: a zero's sign differs from the "
                                 "composition's in a tile every later "
                                 "stage adds into")
        signs += int(flip.sum())
    return signs


def ring_stage_counts(plans):
    """(stages with pairs, of them the first of their rank: K4's fresh
    form; the others run its accumulate form)."""
    stages = sum(1 for p in plans for x in p.stage_pairs if x)
    first = sum(1 for p in plans if any(p.stage_pairs))
    return stages, first


def check_ring_launches(launches, plans, what, f64=False, runs=1,
                        masks=False):
    """One K4 launch a stage with pairs (``runs`` times): the first of each
    rank's in the fresh form, the others in the accumulate form; with
    ``masks`` (where K4 reads tile masks) one masks launch a table of each
    plan, A slice and B chunk, whatever ``runs``: made once a plan; and one
    walk list an accumulate launch."""
    stages, first = ring_stage_counts(plans)
    entry = "macro_accumulate_pairs_f64" if f64 else "macro_accumulate_pairs"
    masks_entry = "macro_tile_masks_f64" if f64 else "macro_tile_masks"
    got = (launches.get(entry, 0), launches.get(entry + "_acc", 0),
           launches.get(masks_entry, 0), launches.get("macro_stream_walk", 0))
    if got != (runs * first, runs * (stages - first),
               2 * len(plans) if masks else 0,
               runs * (stages - first) if masks else 0):
        raise AssertionError(f"{what}: launches {launches}, {stages} stages "
                             f"with pairs, {first} of them first")
    return stages


def check_carried_masks(plans, what):
    """Each plan's masks (plan_masks: made once, the chunk's carried with
    the chunk) against masks made anew from its A slice and its B chunk,
    word for word.  Returns the tables checked."""
    n = 0
    for p in plans:
        for have, table in zip(p.masks, (sm.acc_slice(p), p.b_dense)):
            if not (have.ready and have.matches(table) and torch.equal(
                    have.words, mk.TableMasks(table).make().words)):
                raise AssertionError(f"{what}: carried masks differ from "
                                     "the masks of their table")
            n += 1
    return n


RING_ROUNDS = 3         # timed replays of a ring plan (median reported)
RING_HIGHEST_LAUNCHES = {}  # phase sharded's float32 4-rank replay's counts


def ring_carries_masks(plans, precision):
    """Whether the ring's stages read tile masks (and its chunks carry
    them): sm.ring_reads_masks (float64 tables, float32 at "high" /
    "default", and at "highest" a ring of several ranks, whose accumulating
    stages read them)."""
    return sm.ring_reads_masks(plans[0], precision)


def warm_ring(plans, precision="highest"):
    """Each rank's local_macro once, its output dropped: the first launch
    of a kernel instance in a process loads it, and the first C of a size
    is a fresh allocation.  The plans' masks made for it are dropped, so
    that the counted run makes them."""
    masks = ring_carries_masks(plans, precision)
    for d, p in enumerate(plans):
        sm.local_macro(p, sm.replay_chunks(plans, d, masks), precision)
    torch.cuda.synchronize()
    for p in plans:
        p.masks = None


def replay_ring(plans, precision="highest"):
    """Each rank of a ring plan replayed on the card in turn, RING_ROUNDS
    times: its local_macro (the K4 launches) and its local_macro_coo timed
    apart (host clock, the card synchronised; the median of the rounds:
    both make host syncs and allocations, and single rounds spread by
    several ms), and the peak device memory of its local_macro above what
    was allocated before it.  The chunks carry their masks where K4 reads
    them (made once a plan, in the first round).  Returns (outs, parts,
    k4_ms, coo_ms, ring_peak_gb, rank_launches) with the last round's
    outputs and each rank's kernel launches in it."""
    n = len(plans)
    masks = ring_carries_masks(plans, precision)
    k4, coo, peaks = [[] for _ in plans], [[] for _ in plans], [0.0] * n
    rank_launches = [{} for _ in plans]
    for r in range(RING_ROUNDS):
        outs, parts = [], []
        for d, p in enumerate(plans):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            counted = dict(mk.LAUNCHES)
            out, ms = synced_ms(lambda: sm.local_macro(
                p, sm.replay_chunks(plans, d, masks), precision))
            if r == RING_ROUNDS - 1:
                rank_launches[d] = {k: v - counted[k] for k, v in
                                    mk.LAUNCHES.items() if v > counted[k]}
            peaks[d] = max(peaks[d], (torch.cuda.max_memory_allocated()
                                      - before) / 2**30)
            part, ms_coo = synced_ms(lambda: sm.local_macro_coo(p, *out))
            outs.append(out)
            parts.append(part)
            k4[d].append(ms)
            coo[d].append(ms_coo)
    return (outs, parts, [float(np.median(x)) for x in k4],
            [float(np.median(x)) for x in coo], peaks, rank_launches)


def hold_ring_compositions(plans, outs, precision, what):
    """Every rank's C against ring_composition's (hold_composition), with
    the composition's ms and peak memory.  Returns {"zero_signs_differing",
    "rank_composition_ms", "rank_composition_peak_mem_gb"}, a list each."""
    out = {"zero_signs_differing": [], "rank_composition_ms": [],
           "rank_composition_peak_mem_gb": []}
    for d, (p, got) in enumerate(zip(plans, outs)):
        want, ms, peak, may = ring_composition(
            p, sm.replay_chunks(plans, d), precision)
        out["zero_signs_differing"].append(
            hold_composition(got, want, may, f"{what}, rank {d}"))
        out["rank_composition_ms"].append(ms)
        out["rank_composition_peak_mem_gb"].append(peak)
        del want
    return out


def needed_slabs(a_dense, b_dense, pa, pb):
    """(slabs that run, slabs) over the pairs (pa, pb): the k-slabs (32
    wide in float32, 16 in float64, as the kernels take them) whose product
    can be non-zero by the tables' k-masks (tile_masks_plain): a k where
    A's column and B's row hold a non-zero, or a marked slab."""
    f64 = a_dense.dtype == torch.float64
    width, per = (16, 8) if f64 else (32, 4)
    ma = mk.tile_masks_plain(a_dense)[pa.long()].to(torch.int64) & 0xFFFFFFFF
    mb = mk.tile_masks_plain(b_dense)[pb.long()].to(torch.int64) & 0xFFFFFFFF
    both = ma[:, :4] & mb[:, 5:9]              # (P, 4): k bits, 32 a word
    marks = ma[:, 4] | mb[:, 9]
    run = 0
    for slab in range(per):
        word, shift = divmod(slab * width, 32)
        bits = (both[:, word] >> shift) & ((1 << width) - 1)
        run += int(((bits != 0) | ((marks >> slab) & 1 != 0)).sum())
    return run, per * pa.numel()


def acc_bounds(a_dense, b_dense, pa, pb, n_pairs, tiles, precision):
    """Bounds of a stage in K4's accumulate form: the operations (the
    slabs this stage's data needs, needed_slabs: 2 * 128^2 * the slab's
    depth each, at the rate of the precision's product: FP32 at "highest"
    with the 3xTF32 tensor-core bound beside it, TF32, bf16, FP64;
    ``operations_every_slab`` the 2 * 128^3 a pair of a dense product) and
    the bytes (each distinct operand tile read once, each C tile the stage
    has pairs for read and written once, values and flags; the other tiles
    not at all)."""
    elem = a_dense.element_size()
    slabs_run, slabs = needed_slabs(a_dense, b_dense, pa, pb)
    ops = TILE_FLOP * n_pairs * slabs_run // max(slabs, 1)
    operand_tiles = int(torch.unique(pa).numel() + torch.unique(pb).numel())
    nbytes = operand_tiles * 128 * 128 * elem \
        + 2 * tiles * 128 * 128 * (elem + 1)
    if a_dense.dtype == torch.float64:
        rate, rate_name = FP64_OPS_PER_S, "FP64 67 TFLOP/s (DMMA)"
    else:
        rate, rate_name = {
            "highest": (FP32_OPS_PER_S, "FP32 67 TFLOP/s"),
            "high": (TF32_OPS_PER_S, "TF32 495 TFLOP/s"),
            "default": (BF16_OPS_PER_S, "bf16 989 TFLOP/s")}[precision]
    b_o, b_b = ops / rate, nbytes / HBM_BYTES_PER_S
    out = {"bound_ms": max(b_o, b_b) * 1e3,
           "bound_by": "operations" if b_o >= b_b else "bytes",
           "bound_ops_ms": b_o * 1e3, "bound_bytes_ms": b_b * 1e3,
           "operations": ops, "operations_every_slab": TILE_FLOP * n_pairs,
           "slabs_run": slabs_run, "slabs": slabs, "bytes": nbytes,
           "operand_tiles": operand_tiles, "rate": rate_name}
    if precision == "highest" and a_dense.dtype == torch.float32:
        b_tc = 3 * ops / TF32_OPS_PER_S
        out.update(bound_tc_ms=max(b_tc, b_b) * 1e3,
                   bound_tc_by="operations (3xTF32)" if b_tc >= b_b
                   else "bytes")
    return out


def acc_row(plans, matrix, launches, check_err, precision="highest",
            extra=None):
    """The kernels-line row of K4's accumulate form at ``precision`` (or in
    float64, for float64 plans), timed on the ring stage that
    sm.largest_accumulating_stage picks: held first against the plain
    accumulate (accumulate_case's rule, into a prior C with -0.0, +-Inf and
    NaN in every tile), then the launch as the ring makes it (the A slice's
    and the chunk's masks ready, the walk list built by the wrapper) timed
    by CUDA-graph replay (``ms``) and through the wrapper's eager calls
    (``wrapper_ms``: its host time shows there), the masks launches the
    plans make once for the two tables (``masks_ms``), its plain version,
    K4's fresh form on the same stream, and torch.bmm over the stage's
    pre-gathered pairs by graph replay (``library_ms``; ``library_eager_ms``
    by CUDA events around eager calls)."""
    d, s = sm.largest_accumulating_stage(plans)
    p = plans[d]
    owner = plans[(d - s) % len(plans)]
    b = owner.b_dense
    pa, pb, sg = p.pairs_a[s], p.pairs_b[s], p.seg[s]
    n_pairs = p.stage_pairs[s]
    f64 = p.a_dense.dtype == torch.float64
    name = "macro_accumulate_pairs_f64_acc" if f64 else prec_key(
        "macro_accumulate_pairs_acc", precision)
    worst = {name: 0.0}
    accumulate_case(p.a_dense, b, pa, pb, sg, p.c_cap, f"{matrix} ring "
                    f"stage (rank {d}, stage {s})", worst, precision,
                    seed=71)
    tiles = int(stream_tiles(sg, p.c_cap).sum())
    visited = graph_stage_case(p.a_dense, b, pa, pb, sg, p.c_cap, precision,
                               f"{matrix} ring stage, {precision}")
    chunk = min(256, pa.numel())
    c = acc_prior(p.c_cap, p.a_dense.dtype, 72)
    reads = mk.reads_masks(b, precision, True)
    masks = mk.TileMasks(p.a_dense, b, a=sm.plan_masks(p)[0],
                         b=sm.plan_masks(owner)[1]) if reads else None
    fn = lambda: mk.accumulate_macro_pairs(p.a_dense, b, pa, pb, sg, p.c_cap,
                                           precision=precision,
                                           tile_masks=masks, out=c)
    plain = lambda: M.accumulate_macro(p.a_dense, b, pa, pb, sg, p.c_cap,
                                       chunk, p.a_dense.dtype, precision,
                                       out=c)
    fresh = lambda: mk.accumulate_macro_pairs(p.a_dense, b, pa, pb, sg,
                                              p.c_cap, precision=precision)
    tables = (mk.TableMasks(p.a_dense), mk.TableMasks(b))
    make_masks = lambda: [t.make() for t in tables]
    bmm, _what = bmm_at(precision)
    cast = bmm_cast(p.a_dense.dtype, precision)
    ad = p.a_dense[pa[:n_pairs].long()].to(cast)
    bd = b[pb[:n_pairs].long()].to(cast)
    row = {
        "name": name,
        "kernel": ("K4-f64" if f64 else "K4") + " accumulate form"
                  + ("" if precision == "highest" or f64
                     else f"@{precision}"),
        "route": "cuda", "source": MACRO_SOURCE,
        "replaces": "pem_spgemm_tpu/ops/pallas_macro2.py:232",
        "jax_ring_stage": "pem_spgemm_tpu/parallel/sharded_macro.py:248 "
                          "(c_dense.at[sg].add(prod))",
        "launches": launches, "max_abs_err": max(
            worst[name], check_err.get(name, 0.0)),
        "ms": graph_ms(fn), "wrapper_ms": time_ms(fn),
        "masks_ms": graph_ms(make_masks) if reads else None,
        "plain_ms": time_ms(plain, 2),
        **acc_bounds(p.a_dense, b, pa[:n_pairs], pb[:n_pairs], n_pairs, tiles,
                     precision),
        "library_ms": graph_ms(lambda: bmm(ad, bd)),
        "library_eager_ms": time_ms(lambda: bmm(ad, bd), 3),
        "library_covers": ("torch.bmm in float64" if f64 else
                           bmm_at(precision)[1]) + " over the stage's "
                          "pre-gathered (P, 128, 128) operands: the products "
                          "only",
        "fresh_form_ms": time_ms(fresh),
        "matrix": matrix, "ring": f"{len(plans)} ranks replayed",
        "rank": d, "stage": s, "pairs": n_pairs, "tiles_with_pairs": tiles,
        "tiles_visited": visited, "c_cap": p.c_cap,
        "precision": "float64" if f64 else precision,
        "dtype": str(p.a_dense.dtype).replace("torch.", ""),
        "timed": "one launch into the rank's C (c_cap tiles), the stage's "
                 "stream as the ring hands it over (masks ready, the walk "
                 "list built in the call), by CUDA-graph replay; masks_ms: "
                 "the masks entry over the A slice and the chunk, as a plan "
                 "makes them once; fresh_form_ms: K4's fresh form on the "
                 "same stream (it writes all c_cap tiles)", **(extra or {})}
    del c, ad, bd, tables
    torch.cuda.empty_cache()
    return row


def walk_row(plans, launches):
    """The kernels-line row of the walk entry (mk.stream_walk), timed on
    the ring stage sm.largest_accumulating_stage picks by CUDA-graph
    replay, against its plain version (bit for bit); its bound the bytes of
    the stream read once and the list written once."""
    d, s = sm.largest_accumulating_stage(plans)
    p = plans[d]
    sg = p.seg[s]
    cap = min(p.c_cap, sg.numel())
    got = mk.stream_walk(sg, p.c_cap, cap)
    if not torch.equal(got, mk.stream_walk_plain(sg, p.c_cap, cap)):
        raise AssertionError("stream walk at the ring stage: differs from "
                             "the plain version")
    nbytes = 4 * (sg.numel() + got.numel())
    return {"name": "macro_stream_walk", "kernel": "K4 accumulate form's "
            "walk list", "route": "cuda", "source": MACRO_SOURCE,
            "replaces": "pem_spgemm_tpu/ops/pallas_macro2.py:232 (K4's "
                        "accumulate form walks it: no Pallas counterpart "
                        "of its own)",
            "launches": launches, "max_abs_err": 0.0,
            "ms": graph_ms(lambda: mk.stream_walk(sg, p.c_cap, cap)),
            "plain_ms": time_ms(lambda: mk.stream_walk_plain(sg, p.c_cap,
                                                             cap), 5),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "library_ms": None,
            "library_covers": "none: no one PyTorch call lists a sorted "
                              "stream's tiles with their first pairs",
            "pairs": p.stage_pairs[s], "p_cap": sg.numel(), "c_cap": p.c_cap,
            "tiles_with_pairs": int(got[0]), "rank": d, "stage": s}


def masks_row(plans, launches, f64):
    """The kernels-line row of a masks entry (TableMasks.make:
    macro_tile_masks, float32, at "high" / "default"; _f64), timed over a
    4-rank plan's A slice and B chunk, the launches a plan makes once: each
    by CUDA-graph replay, the tiles read once and the words written once
    its bound; against the plain version, bit for bit."""
    p = plans[0]
    name = "macro_tile_masks_f64" if f64 else "macro_tile_masks"
    tables = (mk.TableMasks(p.a_dense), mk.TableMasks(p.b_dense))
    for t in tables:
        if not torch.equal(t.make().words, mk.tile_masks_plain(t.table)):
            raise AssertionError(f"{name}: words differ from the plain "
                                 "version's")
    n_tiles = sum(t.table.shape[0] for t in tables)
    nbytes = n_tiles * (128 * 128 * p.a_dense.element_size()
                        + 4 * mk.TM_WORDS)
    row = {"name": name, "kernel": "K4's tile masks"
           + (" (float64)" if f64 else ""), "route": "cuda",
           "source": MACRO_SOURCE,
           "replaces": "pem_spgemm_tpu/ops/pallas_macro2.py:232 (the slab "
                       "skip's pre-pass of K4's port: no Pallas counterpart "
                       "of its own)",
           "launches": launches, "max_abs_err": 0.0,
           "ms": graph_ms(lambda: [t.make() for t in tables]),
           "plain_ms": time_ms(lambda: [mk.tile_masks_plain(t.table)
                                        for t in tables], 2),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bytes": nbytes, "library_ms": None,
           "library_covers": "none: no one PyTorch call computes a tile's "
                             "k-masks and marked slabs",
           "tiles": n_tiles, "tables": "rank 0's A slice and B chunk",
           "dtype": str(p.a_dense.dtype).replace("torch.", "")}
    del tables
    return row


def world_size_1_point(plan, precision="highest"):
    """K4's accumulate form and its fresh form on the world-size-1 ring's
    one stream (every pair of the product; every C tile has pairs): ms of
    each, into the same C, the accumulate form with the plan's masks
    ready."""
    s = next(i for i, x in enumerate(plan.stage_pairs) if x)
    args = (plan.a_dense, plan.b_dense, plan.pairs_a[s], plan.pairs_b[s],
            plan.seg[s], plan.c_cap)
    c = mk.accumulate_macro_pairs(*args, precision=precision)
    masks = mk.TileMasks(plan.a_dense, plan.b_dense,
                         *sm.plan_masks(plan)) \
        if mk.reads_masks(plan.b_dense, precision, True) else None
    point = {"pairs": plan.stage_pairs[s], "c_cap": plan.c_cap,
             "tiles_with_pairs": int(stream_tiles(plan.seg[s], plan.c_cap)
                                     .sum()),
             "ms": time_ms(lambda: mk.accumulate_macro_pairs(
                 *args, precision=precision, tile_masks=masks, out=c), 10),
             "fresh_form_ms": time_ms(lambda: mk.accumulate_macro_pairs(
                 *args, precision=precision), 10)}
    del c
    torch.cuda.empty_cache()
    return point


def check_f64_rows(got, want, what):
    """Sampled rows: exact structure, values within the float64 bound."""
    gr, gc, gv = got
    wr, wc, wv, mag = want
    if not (np.array_equal(gr, wr) and np.array_equal(gc, wc)):
        raise AssertionError(f"{what}: sampled rows' structure differs")
    over = float((np.abs(gv - wv) / (F64_RTOL * mag + F64_ATOL)).max())
    if not over <= 1.0:
        raise AssertionError(f"{what}: values exceed the float64 bound by "
                             f"{over}x")
    return over


def macro_ring_world_size_1(md, mesh, want, pick, what):
    """The macro ring on ``md`` at world size 1 over NCCL (one K4 stage):
    C_nnz as recorded, sampled rows against ``want`` within the float32
    bound, C float32 (float64 for float64 tiles) and equal under == to the
    composition (ring_composition).  Emits the sharded_path line and
    returns the plan."""
    from pem_spgemm_tpu_torch.parallel import distributed as PD
    want_nnz = BF16_RUNS[2][2]
    reset_launch_counts()
    plan, plan_ms = synced_ms(lambda: sm.plan_sharded_macro(md, md, 1, 0))
    sm.sharded_macro_numeric(plan, mesh)             # first: warms up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out, mul_ms = synced_ms(lambda: sm.sharded_macro_numeric(plan, mesh))
    ring_peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    c_nnz = PD.plan_nnz_macro(plan, out, mesh)
    (rows, cols, vals), asm_ms = synced_ms(
        lambda: sm.assemble_sharded_macro(plan, *out, mesh, host=False))
    launches = nonzero(all_counts())
    add_path_launches("sharded_path", launches)
    stages = check_ring_launches(launches, [plan], what, runs=2)
    if c_nnz != want_nnz or len(rows) != want_nnz:
        raise AssertionError(f"{what}: C_nnz {c_nnz}, launches "
                             f"{launches}, stages {stages}")
    if out[0].dtype != sm.acc_slice(plan).dtype:
        raise AssertionError(f"{what}: C is {out[0].dtype}")
    over = check_f32_rows(device_rows(rows, cols, vals, pick), want, what)
    del rows, cols, vals
    _part, coo_ms = synced_ms(lambda: sm.local_macro_coo(plan, *out))
    del _part
    comp, comp_ms, comp_peak, may = ring_composition(plan, [plan.b_dense])
    signs = hold_composition(out, comp, may, what)
    del comp
    emit("sharded_path", decomposition="macro", matrix="wandering64-1M",
         world_size=1, dtype=str(md.dense.dtype).replace("torch.", ""),
         c_dtype=str(out[0].dtype).replace("torch.", ""), c_nnz=c_nnz,
         checked_against=f"scipy, {F64_SAMPLE_ROWS:,} sampled rows"
         + (" of the bfloat16-rounded operands' product"
            if md.dense.dtype == torch.bfloat16 else "")
         + "; the fresh-form-plus-torch-add composition under ==",
         values_worst_over_bound=over, launches=launches,
         stages_with_pairs=stages, plan_ms=plan_ms, multiply_ms=mul_ms,
         local_macro_coo_ms=coo_ms, ring_peak_mem_gb=ring_peak,
         composition_ms=comp_ms, composition_peak_mem_gb=comp_peak,
         zero_signs_differing=signs, assemble_ms=asm_ms)
    del out
    torch.cuda.empty_cache()
    return plan


def ring_widening(p):
    """What the bfloat16 macro ring's chunk costs a stage: the bytes it
    sends (the bfloat16 chunk and its masks) against those of a float32
    copy, and the ms of widening it into the float32 buffer K4 reads (one
    copy, by CUDA-graph replay, beside its bound: the chunk read and its
    copy written once), and of widening the A slice, once a plan."""
    tiles = p.b_dense.shape[0]
    masks = 4 * mk.TM_WORDS * tiles
    wide = torch.empty(p.b_dense.shape, dtype=torch.float32, device=DEV)
    moved = p.b_dense.numel() * (2 + 4)
    out = {"chunk_tiles": tiles,
           "stage_sends_bytes": p.b_dense.numel() * 2 + masks,
           "stage_sends_bytes_as_float32": p.b_dense.numel() * 4 + masks,
           "widen_ms": graph_ms(lambda: wide.copy_(p.b_dense)),
           "widen_bound_ms": moved / HBM_BYTES_PER_S * 1e3,
           "a_slice_tiles": p.a_dense.shape[0],
           "a_slice_widen_ms": time_ms(lambda: p.a_dense.to(torch.float32),
                                       3),
           "timed": "widen_ms: wide.copy_(chunk), as local_macro widens each "
                    "chunk, by CUDA-graph replay; a_slice_widen_ms: "
                    "acc_slice's copy, once a plan, by CUDA events"}
    del wide
    return out


def sharded_macro_runs(mesh, check_err):
    """wandering64-1M: the macro ring at world size 1 over NCCL (one K4
    stage), then the 4-rank replay (one K4 for each stage with pairs: a
    rank's first in the fresh form, the others in the accumulate form), in
    float32, float64 and bfloat16 (the chunks go round in bfloat16; K4
    reads their float32 copies and C is float32); C_nnz as recorded,
    sampled rows against scipy (the bfloat16-rounded operands' product for
    bfloat16), each rank's C against the composition the accumulate form
    replaces (ring_composition) under ==.  Returns the accumulate form's
    rows (at "highest" and in float64)."""
    name = "wandering64-1M"
    want_nnz = BF16_RUNS[2][2]
    coo = MACRO_MATRICES[name]()
    pick = sample_rows(coo.shape[0])
    want = scipy_rows(coo, pick)
    want16 = product_rows(coo, pick, bf16=True)
    m = coo_to_macro(coo)
    plan = macro_ring_world_size_1(m, mesh, want, pick, "macro ring")
    ws1 = world_size_1_point(plan)
    del plan
    torch.cuda.empty_cache()
    m16 = coo_to_macro(coo, dtype=torch.bfloat16)
    macro_ring_world_size_1(m16, mesh, want16, pick, "macro ring, bf16")
    torch.cuda.empty_cache()

    rows_out = []
    n = SHARDED_RANKS
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        f64 = dtype == torch.float64
        bf16 = dtype == torch.bfloat16
        what = "macro replay" + (", float64" if f64 else ", bf16" if bf16
                                 else "")
        md = m if dtype == torch.float32 else m16 if bf16 \
            else coo_to_macro(coo, dtype=torch.float64)
        plans, plan_ms = [], []
        for d in range(n):
            p, ms = synced_ms(lambda: sm.plan_sharded_macro(md, md, n, d))
            plans.append(p)
            plan_ms.append(ms)
        del md
        warm_ring(plans)
        reset_launch_counts()
        outs, parts, k4_ms, coo_ms, peaks, rank_launches = replay_ring(plans)
        launches = nonzero(all_counts())
        add_path_launches("sharded_ranks", launches)
        stages = check_ring_launches(launches, plans, what, f64,
                                     runs=RING_ROUNDS, masks=True)
        carried = check_carried_masks(plans, what)
        rows, cols, vals = union_sorted(parts)
        del parts
        if len(rows) != want_nnz:
            raise AssertionError(f"{what}: C_nnz {len(rows)}")
        if vals.dtype != (torch.float64 if f64 else torch.float32):
            raise AssertionError(f"{what}: C is {vals.dtype}")
        got = device_rows(rows, cols, vals, pick)
        over = (check_f64_rows if f64 else check_f32_rows)(
            got, want16 if bf16 else want, what)
        del rows, cols, vals
        held = hold_ring_compositions(plans, outs, "highest", what)
        del outs
        torch.cuda.empty_cache()
        times = [x + y for x, y in zip(k4_ms, coo_ms)]
        emit("sharded_ranks", decomposition="macro", matrix=name, ranks=n,
             dtype=str(dtype).replace("torch.", ""), c_nnz=want_nnz,
             checked_against=f"scipy, {F64_SAMPLE_ROWS:,} sampled rows"
             + (" of the bfloat16-rounded operands' product" if bf16
                else "") + "; each rank's C against the "
             "fresh-form-plus-torch-add composition under ==",
             values_worst_over_bound=over,
             launches=launches, stages_with_pairs=stages,
             rank_stage_pairs=[list(p.stage_pairs) for p in plans],
             rank_pairs=[int(sum(p.stage_pairs)) for p in plans],
             rank_c_cap=[p.c_cap for p in plans], rank_plan_ms=plan_ms,
             rank_ms=times, rank_k4_ms=k4_ms, rank_local_macro_coo_ms=coo_ms,
             rank_launches=rank_launches, carried_masks_checked=carried,
             rank_ring_peak_mem_gb=peaks, **held,
             **({"widening": ring_widening(plans[0])} if bf16 else {}),
             load_balance=balance(times))
        entry = "macro_accumulate_pairs_f64_acc" if f64 else \
            "macro_accumulate_pairs_acc"
        if not bf16:
            rows_out.append(acc_row(
                plans, name, launches.get(entry, 0), check_err,
                extra=None if f64 else {"at_world_size_1_stream": ws1}))
        if f64:
            rows_out.append(masks_row(
                plans, launches.get("macro_tile_masks_f64", 0), True))
        elif not bf16:
            RING_HIGHEST_LAUNCHES.update(launches)
        del plans
        torch.cuda.empty_cache()
    return rows_out


def check_f32_rows(got, want, what):
    """Sampled rows: exact structure, values within the float32 bound."""
    gr, gc, gv = got
    wr, wc, wv, mag = want
    if not (np.array_equal(gr, wr) and np.array_equal(gc, wc)):
        raise AssertionError(f"{what}: sampled rows' structure differs")
    over = float((np.abs(gv - wv) / (COO_RTOL * mag + COO_ATOL)).max())
    if not over <= 1.0:
        raise AssertionError(f"{what}: values exceed the float32 bound by "
                             f"{over}x")
    return over


def tile16_composition(p, chunks, acc_dtype=torch.float32):
    """(values (nnz_cap,), ms, peak GB) of a Tile16 ring rank composed as
    the parent composed it, from the kernel's fresh form: a zero C, each
    stage's fresh output added by torch, then the values at the rank's
    structure (the script's reference for the ring, run after the path's
    counts are read), with its time and its peak device memory above what
    was allocated before it."""
    from pem_spgemm_tpu_torch.ops import numeric as N
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    c = torch.zeros((p.c_cap, 16, 16), dtype=acc_dtype, device=DEV)
    for s, b in enumerate(chunks):
        if p.stage_pairs[s]:
            c += tk.accumulate_dense(p.a_dense, b, p.pairs_a[s],
                                     p.pairs_b[s], p.seg[s], p.c_cap,
                                     p.pairs_a.shape[1], acc_dtype)
    vals = N.extract_values(c, p.rowcol, p.elem_tile)
    torch.cuda.synchronize()
    return (vals, (time.perf_counter() - t0) * 1e3,
            (torch.cuda.max_memory_allocated() - before) / 2**30)


def check_tile16_ring_launches(launches, plans, what, runs=1, planned=0,
                               f64=False):
    """One kernel launch a stage with pairs (``runs`` times): the first of
    each rank's in the fresh form, the others in the accumulate form (the
    float64 entry's with ``f64``); one launch of each structure entry a
    plan made (``planned``); and no other kernel of this package."""
    stages, first = ring_stage_counts(plans)
    entry = "tile16_accumulate_pairs" + ("_f64" if f64 else "")
    want = nonzero({entry: runs * first,
                    entry + "_acc": runs * (stages - first),
                    "tile16_c_masks": planned, "tile16_c_rowcol": planned})
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, {stages} "
                             f"stages with pairs, {first} of them first")
    return stages


def ring_plan_split(a, b, c_nnz):
    """The Tile16 ring's world-size-1 plan split into the pair expansion
    and schedule, c_masks, c_rowcol and the rest (ms), its C_nnz held."""
    split, nnz = tiers_ab.ring_plan_split(a, b, 3)
    if nnz != c_nnz:
        raise AssertionError(f"tile16 ring plan: C_nnz {nnz}")
    return split


# the Tile16 ring's runs: (table dtype, acc_dtype)
TILE16_RING_DTYPES = ((torch.float32, torch.float32),
                      (torch.bfloat16, torch.float32),
                      (torch.float64, torch.float64))


def sharded_tile16_runs(ref, mesh, check_err):
    """pairbands-500k: the Tile16 ring at world size 1 over NCCL (one
    fresh kernel launch), then the 4-rank replay (one launch a stage with
    pairs: a rank's first in the fresh form, the others in the accumulate
    form), on float32 tables, on bfloat16 ones (accumulated in float32: the
    float32 entry reads them as they lie) and on float64 ones accumulated
    in float64 (the float64 entry, fresh and accumulate forms); scipy's
    sorted COO (of the bfloat16-rounded operands for bfloat16), values
    within the float32 bound (float64 bound in float64), and each rank's
    values equal under == to the composition the accumulate form replaces
    (tile16_composition), timed beside it in this call.  Returns the
    accumulate forms' rows, float32 and float64."""
    from pem_spgemm_tpu_torch.parallel import sharded as sh
    name = TILE16_MATRIX
    want_nnz = DIA_RECORDED[name][0]
    coo = banded_device(**DIA_MATRICES[name])
    rows_out = []
    for dtype, acc in TILE16_RING_DTYPES:
        f64 = acc == torch.float64
        label = {torch.float32: "", torch.bfloat16: ", bf16",
                 torch.float64: ", float64"}[dtype]
        dref = bf16_reference(coo) if dtype == torch.bfloat16 else ref
        a = coo_to_tiled(coo, dtype=dtype)
        b = coo_to_tiled(coo, dtype=dtype, with_tmasks=True)
        what = "tile16 ring" + label
        reset_launch_counts()
        plan, plan_ms = synced_ms(lambda: sh.plan_sharded_spgemm(a, b, 1, 0))
        sh.sharded_numeric(plan, mesh, acc_dtype=acc)    # first: warms up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        vals, mul_ms = synced_ms(lambda: sh.sharded_numeric(plan, mesh,
                                                            acc_dtype=acc))
        ring_peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        (rows, cols, vals_h), asm_ms = synced_ms(
            lambda: sh.assemble_sharded(plan, vals, mesh))
        launches = nonzero(all_counts())
        add_path_launches("sharded_path", launches)
        stages = check_tile16_ring_launches(launches, [plan], what, runs=2,
                                            planned=1, f64=f64)
        if plan.c_nnz != want_nnz or vals.dtype != acc:
            raise AssertionError(f"{what}: C_nnz {plan.c_nnz}, values "
                                 f"{vals.dtype}")
        _cancelled, over = check_coo(rows, cols, vals_h, dref, what, f64)
        comp, comp_ms, comp_peak = tile16_composition(plan, [plan.b_dense],
                                                      acc)
        if not same_values(vals, comp):
            raise AssertionError(f"{what}: values differ from the "
                                 "composition's")
        split = {} if dtype != torch.float32 else dict(
            plan_split_ms=ring_plan_split(a, b, plan.c_nnz),
            plan_split="median of 3 plans after one warm-up, synchronised "
                       "host clocks (bench/tiers_ab.py ring_plan_split)")
        emit("sharded_path", decomposition="tile16", matrix=name,
             world_size=1, dtype=str(dtype).replace("torch.", ""),
             acc_dtype=str(acc).replace("torch.", ""), c_nnz=plan.c_nnz,
             checked_against="scipy, every entry"
             + (" of the bfloat16-rounded operands' product"
                if dtype == torch.bfloat16 else "")
             + "; the fresh-form-plus-torch-add composition under ==",
             values_worst_over_bound=over, launches=launches,
             stages_with_pairs=stages, plan_ms=plan_ms, **split,
             multiply_ms=mul_ms, ring_peak_mem_gb=ring_peak,
             composition_ms=comp_ms, composition_peak_mem_gb=comp_peak,
             assemble_ms=asm_ms)
        del rows, cols, vals, vals_h, comp
        plan1 = plan
        torch.cuda.empty_cache()
        n = SHARDED_RANKS
        plans, plan_ms = [], []
        for d in range(n):
            p, ms = synced_ms(lambda: sh.plan_sharded_spgemm(a, b, n, d))
            plans.append(p)
            plan_ms.append(ms)
        del a, b
        for d in range(n):                          # warm-up, not counted
            sh.replay_numeric(plans, d, acc_dtype=acc)
        reset_launch_counts()
        parts, num_ms, coo_ms, outs = [], [], [], []
        for d, p in enumerate(plans):
            v, ms = synced_ms(lambda: sh.replay_numeric(plans, d,
                                                        acc_dtype=acc))
            part, ms_coo = synced_ms(lambda: sh.local_coo(p, v))
            outs.append(v)
            parts.append(part)
            num_ms.append(ms)
            coo_ms.append(ms_coo)
        launches = nonzero(all_counts())
        add_path_launches("sharded_ranks", launches)
        what = "tile16 replay" + label
        stages = check_tile16_ring_launches(launches, plans, what, f64=f64)
        rows, cols, vals = union_sorted(parts)
        del parts
        if len(rows) != want_nnz:
            raise AssertionError(f"{what}: C_nnz {len(rows)}")
        _cancelled, over = check_coo(rows.cpu().numpy(), cols.cpu().numpy(),
                                     vals.cpu().numpy(), dref, what, f64)
        del rows, cols, vals
        comp_ms, comp_peak = [], []
        for d, (p, got) in enumerate(zip(plans, outs)):
            want, ms, peak = tile16_composition(p, sh.replay_chunks(plans, d),
                                                acc)
            if not same_values(got, want):
                raise AssertionError(f"{what}, rank {d}: values differ from "
                                     "the composition's")
            comp_ms.append(ms)
            comp_peak.append(peak)
        del outs
        times = [x + y for x, y in zip(num_ms, coo_ms)]
        emit("sharded_ranks", decomposition="tile16", matrix=name, ranks=n,
             dtype=str(dtype).replace("torch.", ""),
             acc_dtype=str(acc).replace("torch.", ""), c_nnz=want_nnz,
             checked_against="scipy, every entry; each rank's values "
             "against the fresh-form-plus-torch-add composition under ==",
             values_worst_over_bound=over, launches=launches,
             stages_with_pairs=stages,
             rank_stage_pairs=[list(p.stage_pairs) for p in plans],
             rank_pairs=[int(sum(p.stage_pairs)) for p in plans],
             rank_c_cap=[p.c_cap for p in plans], rank_plan_ms=plan_ms,
             rank_ms=times, rank_numeric_ms=num_ms, rank_local_coo_ms=coo_ms,
             rank_composition_ms=comp_ms,
             rank_composition_peak_mem_gb=comp_peak,
             load_balance=balance(times))
        if dtype != torch.bfloat16:
            row = tile16_acc_row(plans, plan1, check_err, acc)
            row["launches"] = launches.get(row["name"], 0)
            rows_out.append(row)
        del plans, plan1
        torch.cuda.empty_cache()
    return rows_out


def phase_sharded(coo_pl, want_pl, pairbands_ref, check_err=None):
    """Phases sharded_path and sharded_ranks: the four decompositions of
    the multi-GPU layer at full size.  sharded_path runs each at world size
    1 over NCCL (a process group of this one card: no point-to-point op
    runs, and the c_nnz all_reduce and the gathers go through NCCL);
    sharded_ranks replays a 4-rank plan on the one card, each rank's local
    function in turn, its B chunks and halos read from the plan (two NCCL
    ranks cannot share one card; the exchange itself is carried by the
    gloo tests).  Returns the kernels-line rows of K4's accumulate form
    at "highest" and in float64, and of the Tile16 kernel's accumulate
    form in float32 and in float64."""
    from pem_spgemm_tpu_torch.parallel import distributed as PD
    t0 = time.perf_counter()
    PD.initialize(init_method=f"tcp://localhost:{free_port()}",
                  world_size=1, rank=0, device="cuda")
    try:
        mesh = PD.pod_mesh(device="cuda")
        if torch.distributed.get_backend() != "nccl" or mesh.group is None:
            raise AssertionError("the world-size-1 group is not NCCL")
        sharded_element_runs(coo_pl, want_pl, mesh)
        torch.cuda.empty_cache()
        sharded_dia_runs(mesh)
        torch.cuda.empty_cache()
        rows = sharded_macro_runs(mesh, check_err or {})
        torch.cuda.empty_cache()
        rows += sharded_tile16_runs(pairbands_ref, mesh, check_err or {})
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    emit("sharded_total", seconds=time.perf_counter() - t0)
    return rows


# phase precision_path: SpGEMMConfig.precision "high" and "default" beside
# "highest".  u is the unit roundoff of the rounded operands (0 at
# "highest"): tf32 keeps 11 significant bits (u = 2^-11), bfloat16 8
# (u = 2^-8), so a product of two rounded values lies within (2u + u^2)
# |a*b| of a*b
PRECISION_U = {"highest": 0.0, "high": 2.0 ** -11, "default": 2.0 ** -8}
# the kernels the phase's runs launched at each lower precision (counts set
# to 0 just before each run, read just after): the @precision rows' counts
PRECISION_LAUNCHES = {q: {} for q in LOWER_PRECISIONS}


def hold_rounded(rows, cols, vals, want, precision, what):
    """Exact structure (scipy's, from |A|.|A|); |got - want| <= (2u + u^2)
    sum|a*b| + 1e-5 sum|a*b| + 1e-6: the products of operands rounded to u
    (each within (2u + u^2) |a*b| of a*b) and the float32 bound.  Returns
    the worst ratio."""
    wr, wc, wv, mag = want
    if not (np.array_equal(rows, wr) and np.array_equal(cols, wc)):
        raise AssertionError(f"{what}: sorted COO structure differs from "
                             "scipy's")
    if not np.all(np.isfinite(vals)):
        raise AssertionError(f"{what}: non-finite values")
    u = PRECISION_U[precision]
    bound = (2 * u + u * u + COO_RTOL) * mag + COO_ATOL
    over = float((np.abs(vals - wv) / bound).max()) if len(wv) else 0.0
    if not over <= 1.0:
        raise AssertionError(f"{what}: values exceed the bound by {over}x")
    return over


def precision_runs(coo, name, cfg, check_values, want_entry):
    """run_benchmark at "highest", "high" and "default" (repeat 2): C_nnz and
    the structure (tile coordinates and flags, or the Tile16 arrays, on the
    card) of each lower precision equal to the "highest" run's, values held
    by ``check_values(res, precision)``, the kernel ``want_entry``
    launched at each."""
    ref = None
    for q in ("highest",) + LOWER_PRECISIONS:
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rec, res = run_benchmark(coo, name, cfg.with_(precision=q, repeat=2),
                                 verbose=False)
        launches = nonzero(all_counts())
        peak = torch.cuda.max_memory_allocated() / 2**30
        if q != "highest":
            for k, v in launches.items():
                PRECISION_LAUNCHES[q][k] = PRECISION_LAUNCHES[q].get(k, 0) + v
        if rec.precision != q or not launches.get(want_entry):
            raise AssertionError(f"{name} at {q}: record {rec.precision}, "
                                 f"launches {launches}")
        tile16 = res.rowcol is not None
        structure = [res.c_tile_row, res.c_tile_col, res.cptr] + (
            [res.cmask, res.rowcol[:res.c_nnz], res.elem_tile[:res.c_nnz]]
            if tile16 else [res.c_counts])
        if ref is None:
            ref = (res.c_nnz, [x.clone() for x in structure])
        elif res.c_nnz != ref[0] or not all(
                torch.equal(x, y) for x, y in zip(structure, ref[1])):
            raise AssertionError(f"{name} at {q}: C_nnz {res.c_nnz} or the "
                                 f"structure differs from highest's "
                                 f"{ref[0]}")
        over = check_values(res, q)
        emit("precision_path", matrix=name, engine=res.engine, precision=q,
             c_nnz=res.c_nnz, structure_equal_to_highest=True,
             values_worst_over_bound=over,
             bound=f"|err| <= (2u + u^2 + 1e-5) sum|a*b| + 1e-6, "
                   f"u = {PRECISION_U[q]}",
             launches=launches, times_ms=record_times(rec),
             peak_mem_gb=peak)
        del res
        torch.cuda.empty_cache()


def phase_precision_path(check_err=None):
    """SpGEMMConfig.precision "high" and "default" beside "highest" through
    run_benchmark: wandering64-1M as macro (K4 interactive, K5 steady),
    pairbands-500k as macro (MacroPlan, K4) and through engine="fused" (the
    Tile16 kernel at the precision), and the macro ring as a 4-rank plan of
    wandering64-1M replayed on the card (one K4 a stage with pairs, at the
    precision: a rank's first in the fresh form, the others in the
    accumulate form; each rank's C against the composition that form
    replaces, under ==).  C_nnz and structure equal the "highest" run's and
    scipy's |A|.|A| (every entry of pairbands-500k, 20,000 sampled rows of
    wandering64-1M), values within (2u + u^2) sum|a*b| plus the float32
    bound of scipy's float64 product.  Returns the accumulate form's rows
    at "high" and "default"."""
    check_err = check_err or {}
    t0 = time.perf_counter()
    name = "wandering64-1M"
    coo = MACRO_MATRICES[name]()
    pick = sample_rows(coo.shape[0])
    want = scipy_rows(coo, pick)

    def sampled(res, q):
        c = res.to_coo()
        return hold_rounded(*coo_rows(c.rows, c.cols, c.vals, pick), want, q,
                            f"{name} at {q}")

    precision_runs(coo, name, SpGEMMConfig(engine="macro"), sampled,
                   "macro_class_ragged")
    # the macro ring: one 4-rank plan, each rank replayed at each precision
    m = coo_to_macro(coo)
    n = SHARDED_RANKS
    plans = [sm.plan_sharded_macro(m, m, n, d) for d in range(n)]
    plan1 = sm.plan_sharded_macro(m, m, 1, 0)
    del m
    ref = None
    for q in ("highest",) + LOWER_PRECISIONS:
        warm_ring(plans, q)
        reset_launch_counts()
        outs, parts, k4_ms, coo_ms, peaks, rank_launches = replay_ring(
            plans, q)
        launches = nonzero(all_counts())
        if q != "highest":
            for k, v in launches.items():
                PRECISION_LAUNCHES[q][k] = PRECISION_LAUNCHES[q].get(k, 0) + v
        what = f"macro ring at {q}"
        stages = check_ring_launches(launches, plans, what, runs=RING_ROUNDS,
                                     masks=True)
        carried = check_carried_masks(plans, what)
        if q == "highest":
            highest_launches = launches
        rows, cols, vals = union_sorted(parts)
        del parts
        if ref is None:
            ref = (rows, cols)
        elif not (torch.equal(rows, ref[0]) and torch.equal(cols, ref[1])):
            raise AssertionError(f"{what}: structure differs from "
                                 "highest's")
        if len(rows) != BF16_RUNS[2][2]:
            raise AssertionError(f"{what}: C_nnz {len(rows)}")
        over = hold_rounded(*device_rows(rows, cols, vals, pick), want, q,
                            what)
        del rows, cols, vals
        held = hold_ring_compositions(plans, outs, q, what)
        del outs
        times = [x + y for x, y in zip(k4_ms, coo_ms)]
        emit("precision_path", matrix=name, engine="macro ring, 4 ranks "
             "replayed", precision=q, c_nnz=BF16_RUNS[2][2],
             structure_equal_to_highest=True, values_worst_over_bound=over,
             composition_equal=True, launches=launches,
             stages_with_pairs=stages, rank_ms=times, rank_k4_ms=k4_ms,
             rank_local_macro_coo_ms=coo_ms, rank_ring_peak_mem_gb=peaks,
             rank_launches=rank_launches, carried_masks_checked=carried,
             **held)
        torch.cuda.empty_cache()
    # K4's accumulate form at each lower mode on the same ring stage as the
    # "highest" row's (launches: filled in by fill_precision_launches), and
    # on the world-size-1 ring's stream
    rows_out = [acc_row(plans, name, None, check_err, q, extra={
        "at_world_size_1_stream": world_size_1_point(plan1, q)})
        for q in LOWER_PRECISIONS]
    # the masks and walk entries at every precision (at "highest" the
    # accumulating stages read them too): this phase's ring runs and the
    # float32 4-rank replay of phase sharded, where it ran
    rows_out.append(masks_row(plans, sum(
        PRECISION_LAUNCHES[q].get("macro_tile_masks", 0)
        for q in LOWER_PRECISIONS) + highest_launches.get(
            "macro_tile_masks", 0) + RING_HIGHEST_LAUNCHES.get(
            "macro_tile_masks", 0), False))
    rows_out.append(walk_row(plans, sum(
        PRECISION_LAUNCHES[q].get("macro_stream_walk", 0)
        for q in LOWER_PRECISIONS) + highest_launches.get(
            "macro_stream_walk", 0) + RING_HIGHEST_LAUNCHES.get(
            "macro_stream_walk", 0)))
    del plan1
    del plans, ref, coo, want
    torch.cuda.empty_cache()

    name = TILE16_MATRIX
    coo = banded_device(**DIA_MATRICES[name])
    want = product_rows(coo)

    def every(res, q):
        c = res.to_coo()
        return hold_rounded(c.rows, c.cols, c.vals, want, q, f"{name} at {q}")

    precision_runs(coo, name, SpGEMMConfig(engine="macro"), every,
                   "macro_accumulate_pairs")
    precision_runs(coo, name, SpGEMMConfig(engine="fused"), every,
                   "tile16_accumulate_pairs_masks")
    del coo, want
    torch.cuda.empty_cache()
    for q in LOWER_PRECISIONS:
        got = PRECISION_LAUNCHES[q]
        if not (got.get("macro_accumulate_pairs") and
                got.get("macro_class_ragged") and
                got.get("macro_accumulate_pairs_acc") and
                got.get("macro_tile_masks") and
                got.get("macro_stream_walk") and
                got.get("tile16_accumulate_pairs_masks")):
            raise AssertionError(f"precision_path at {q} launched {got}")
    emit("precision_total", seconds=time.perf_counter() - t0,
         launches=PRECISION_LAUNCHES)
    return rows_out


def fill_precision_launches(rows):
    """Each @precision row's launches: its entry's count over phase
    precision_path's runs at that precision."""
    for row in rows:
        if row.get("precision") in PRECISION_LAUNCHES:
            row["launches"] = PRECISION_LAUNCHES[row["precision"]].get(
                row["name"].split("@")[0], 0)


# A.A^T on the card (phase aat_path): (name, its generator, engine passed,
# engine expected, the entries that must launch (one of each tuple))
AAT_RUNS = (
    ("rmat-16", MATRICES["rmat-16"], "auto", "element",
     (("segment_dedup",),)),
    # rectangular: 1,000,000 x 500,000, so B = A^T is 500,000 x 1,000,000
    ("uniform-1Mx500k",
     lambda: uniform_random(1_000_000, 500_000, 4_000_000, seed=3),
     "auto", "element", (("segment_dedup",),)),
    ("banded16-1M", lambda: banded_device(**DIA_MATRICES["banded16-1M"]),
     "auto", "dia", (("dia_multiply_dense",),)),
    ("pairbands-500k",
     lambda: banded_device(**DIA_MATRICES["pairbands-500k"]),
     "auto", "dia", (("dia_multiply_pairs",),)),
    ("wandering64-1M", MACRO_MATRICES["wandering64-1M"], "macro", "macro",
     (("macro_accumulate_pairs",),
      ("macro_class_ragged", "macro_accumulate_pairs"))),
)
# the kernels A.A^T must reach on the card, over the whole phase
AAT_KERNELS = (("segment_dedup",), ("dia_multiply_dense",),
               ("dia_multiply_pairs",),
               ("macro_accumulate_pairs", "macro_class_ragged"))


def phase_aat_path(repeat=3):
    """C = A.A^T (run_benchmark(aat=True)) at full size through every
    engine with B = A^T != A: rmat-16 and a rectangular uniform matrix on
    the binned element engine (K1b), banded16-1M on the dense DIA kernel
    (K2), pairbands-500k on the pairs kernel (K3), wandering64-1M on the
    Macro128 engine (K4 interactive, the steady plan's entry after).  C_nnz
    and the sorted coordinates equal the structure of |A|.|A|^T from
    scipy (every entry; 20,000 sampled rows of wandering64-1M), values
    within the float32 bound; the steady path's C_nnz equals the
    interactive one."""
    for name, make, engine, want_engine, entries in AAT_RUNS:
        coo = make()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec, res = run_benchmark(coo, name, SpGEMMConfig(engine=engine,
                                                         repeat=repeat),
                                 aat=True, verbose=False)
        run_s = time.perf_counter() - t0
        launches = nonzero(all_counts())
        add_path_launches("aat_path", launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        what = f"{name} A.A^T"
        if res.engine != want_engine or rec.c_nnz != res.c_nnz:
            raise AssertionError(f"{what}: engine {res.engine}, C_nnz "
                                 f"{rec.c_nnz} / {res.c_nnz}")
        if not all(any(launches.get(k, 0) > 0 for k in one)
                   for one in entries):
            raise AssertionError(f"{what}: launches {launches}")
        n_rows = coo.shape[0]
        if tuple(res.shape) != (n_rows, n_rows):
            raise AssertionError(f"{what}: C is {res.shape}")
        info = dict(matrix=name, shape=list(coo.shape), nnz=coo.nnz,
                    engine_asked=engine, engine=res.engine, flop=rec.flop,
                    c_nnz=res.c_nnz, launches=launches,
                    times_ms=record_times(rec), peak_mem_gb=peak,
                    run_benchmark_s=run_s)
        c = res.to_coo()
        if res.engine == "macro":
            steady_nnz = int(res.cptr[-1])
            if steady_nnz != res.c_nnz:
                raise AssertionError(f"{what}: C_nnz {res.c_nnz} on the "
                                     f"interactive path, {steady_nnz} on "
                                     "the steady path")
            pick = sample_rows(n_rows)
            over = hold_product(*coo_rows(c.rows, c.cols, c.vals, pick),
                             product_rows(coo, pick, aat=True),
                             f"{what} sampled rows", ulp=0.0)
            info.update(steady_c_nnz=steady_nnz,
                        steady_entry=("macro_class_ragged" if launches.get(
                            "macro_class_ragged", 0) else
                            "macro_accumulate_pairs"),
                        checked_against=f"scipy, {len(pick):,} sampled rows")
        else:
            want = product_rows(coo, aat=True)
            if len(c.rows) != len(want[0]) or res.c_nnz != len(want[0]):
                raise AssertionError(f"{what}: C_nnz {res.c_nnz} != scipy "
                                     f"{len(want[0])}")
            over = hold_product(c.rows, c.cols, c.vals, want, what, ulp=0.0)
            info.update(scipy_c_nnz=len(want[0]),
                        checked_against="scipy, every entry")
            del want
        del c, res, coo
        torch.cuda.empty_cache()
        emit("aat_path", coo_equal=True, values_worst_over_bound=over,
             bound="|err| <= 1e-5 * sum|a*b| + 1e-6, structure |A|.|A|^T's",
             **info)
    got = NEW_PATH_LAUNCHES["aat_path"]
    if not all(any(got.get(k, 0) > 0 for k in one) for one in AAT_KERNELS):
        raise AssertionError(f"aat_path launched {got}")


SUITE_ROWS = 4          # one matrix an engine tier: element, pairs, dense,
                        # macro


def phase_suite(timeout_s=600):
    """The suite driver (bench/suite.py, the counterpart of the JAX
    package's bench.py) as a user runs it, in a child process that runs each
    matrix in a child of its own, cut to its first SUITE_ROWS rows: its
    summary line parses with bench.py's keys, n_matrices is SUITE_ROWS with
    no ``partial``, and each child's C_nnz (from the CSV rows the children
    wrote) is the one on record."""
    keys = {"metric", "value", "unit", "vs_baseline", "steady_gflops_geomean",
            "steady_vs_baseline", "pipelined_gflops_geomean",
            "pipelined_vs_baseline", "n_matrices"}
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "suite.csv")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "pem_spgemm_tpu_torch.bench.suite",
             "--first", str(SUITE_ROWS), "--csv", csv],
            stdout=subprocess.PIPE, text=True, cwd=root)
        try:
            out, _ = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGTERM)   # it kills its child and exits
            proc.communicate()
            raise AssertionError(f"suite: still running after {timeout_s} s")
        seconds = time.perf_counter() - t0
        with open(csv) as f:
            rows = [line.split(",") for line in f.read().splitlines()[1:]]
    lines = out.splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"suite: exit code {proc.returncode}, "
                             f"stdout {out!r}")
    summary = json.loads(lines[-1])
    if not keys <= set(summary) or summary["n_matrices"] != SUITE_ROWS \
            or "partial" in summary:
        raise AssertionError(f"suite: summary {summary}")
    c_nnz = {r[0]: int(r[2]) for r in rows}
    want = {name: nnz for name, *_r, nnz in suite.SUITE[:SUITE_ROWS]}
    if c_nnz != want:
        raise AssertionError(f"suite: C_nnz {c_nnz}, on record {want}")
    emit("suite", summary=summary, c_nnz=c_nnz, seconds=seconds)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernel_check", "f64_path",
                                       "dia_path", "tile16_path",
                                       "sharded", "aat_path", "suite",
                                       "precision_path"],
                    default=None,
                    help="kernel_check: build the kernels, check them, and "
                         "stop; f64_path: build them and run the f64 parity "
                         "phase alone; dia_path: the DIA kernel check, the "
                         "DIA path, its kernel rows and dia_graph_replay; "
                         "tile16_path: the Tile16 kernel check, "
                         "pairbands-500k's DIA run (for its steady time), "
                         "then phases tile16_path and persist and the "
                         "Tile16 kernel rows; "
                         "sharded: phases bf16_path, sharded_path and "
                         "sharded_ranks; aat_path: phase aat_path; suite: "
                         "phase suite; precision_path: the Macro128 kernel "
                         "check, phase macro_path and phase precision_path "
                         "with the Macro128 kernel rows")
    ap.add_argument("--profile",
                    choices=sorted(MATRICES) + sorted(DIA_MATRICES)
                    + ["wandering64-1M"],
                    default=None,
                    help="profile this matrix's steady multiply and stop")
    ap.add_argument("--no-pack", action="store_true",
                    help="with --profile: the chunk-granular plan "
                         "(pack=False) through the sort+dedup kernel")
    ap.add_argument("--iters", type=int, default=20,
                    help="with --profile: multiplies per measurement")
    ap.add_argument("--graph", action="store_true",
                    help="with --profile of an element matrix or with "
                         "--engine fused: the eager multiply and its CUDA "
                         "graph replay, in turns")
    ap.add_argument("--engine", choices=["fused"], default=None,
                    help="with --profile pairbands-500k: the Tile16 fused "
                         "engine's steady multiply instead of the DIA one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    build_s = _build.build_kernels(verbose=args.only is not None)
    emit("device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         kernel_build_s=build_s)

    if args.engine == "fused":
        if args.profile != TILE16_MATRIX:
            ap.error(f"--engine fused profiles {TILE16_MATRIX} only")
        run_profile_tile16(args.profile, args.iters, args.graph)
        return 0
    if args.profile == "wandering64-1M":
        run_profile_macro(args.profile, args.iters)
        return 0
    if args.profile in DIA_MATRICES:
        run_profile_dia(args.profile, args.iters)
        return 0
    if args.profile is not None:
        run_profile(args.profile, args.no_pack, args.iters, args.graph)
        return 0
    if args.only == "dia_path":
        check_err = phase_dia_kernel_check()
        kept = phase_dia_path()
        kept["pairbands-500k"].pop("ref")
        rows = phase_dia_kernels(kept, check_err)
        rec, _res = run_benchmark(
            banded_device(**DIA_MATRICES["pairbands-500k"]), "pairbands-500k",
            SpGEMMConfig(dtype=torch.float64, repeat=5), verbose=False)
        kept["pairbands-500k f64"] = rec.steady_state_time
        phase_dia_graph_replay(kept)
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if args.only == "tile16_path":
        check_err = phase_tile16_kernel_check()
        torch.cuda.empty_cache()
        coo = banded_device(**DIA_MATRICES[TILE16_MATRIX])
        rec, _res = run_benchmark(coo, TILE16_MATRIX,
                                  SpGEMMConfig(repeat=5), verbose=False)
        del _res
        phase_tile16_path(scipy_square(coo, with_abs=True),
                          bf16_reference(coo), rec.steady_state_time)
        phase_persist()
        rows = tile16_rows(check_err)
        emit("total", seconds=time.perf_counter() - t_start)
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if args.only == "sharded":
        coo_pl = MATRICES["powerlaw-1M"]()
        pairbands = banded_device(**DIA_MATRICES["pairbands-500k"])
        phase_bf16_path(coo_pl)
        rows = phase_sharded(coo_pl, scipy_square(coo_pl, with_abs=True),
                             scipy_square(pairbands, with_abs=True))
        print(json.dumps({"launches_by_path": NEW_PATH_LAUNCHES}),
              flush=True)
        emit("total", seconds=time.perf_counter() - t_start)
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if args.only == "aat_path":
        phase_aat_path()
        print(json.dumps({"launches_by_path": NEW_PATH_LAUNCHES}),
              flush=True)
        emit("total", seconds=time.perf_counter() - t_start)
        return 0
    if args.only == "suite":
        phase_suite()
        emit("total", seconds=time.perf_counter() - t_start)
        return 0
    if args.only == "precision_path":
        check_err = phase_macro_kernel_check()
        rows = phase_macro_path(check_err, scipy_square(
            banded_device(**DIA_MATRICES["pairbands-500k"]), with_abs=True))
        torch.cuda.empty_cache()
        rows += phase_precision_path(check_err)
        fill_precision_launches(rows)
        emit("total", seconds=time.perf_counter() - t_start)
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if args.only == "f64_path":
        coo_pl = MATRICES["powerlaw-1M"]()
        kept = phase_f64_path(coo_pl, scipy_square(coo_pl, with_abs=True))
        rows = phase_f64_kernels(kept, {k: 0.0 for k in kept})
        print(json.dumps({"kernels": rows}), flush=True)
        return 0

    check_err = phase_kernel_check()
    check_err.update(phase_dia_kernel_check())
    check_err.update(phase_macro_kernel_check())
    torch.cuda.empty_cache()
    check_err.update(phase_tile16_kernel_check())
    torch.cuda.empty_cache()
    if args.only == "kernel_check":
        phase_probe()
        return 0

    coo_pl = MATRICES["powerlaw-1M"]()
    want_pl = scipy_square(coo_pl, with_abs=True)
    dedup_launches, coos = phase_default_path(coo_pl, want_pl)
    replayed = phase_graph_replay(coos)
    del coos
    sort_launches, plan_cg, a, b = phase_kernel_sort_path(coo_pl, want_pl)
    kernels = phase_kernels(
        plan_cg, a, b,
        {"segment_dedup": dedup_launches,
         "segment_sort_dedup": sort_launches}, check_err, replayed)
    del plan_cg, a, b
    torch.cuda.empty_cache()
    kept = phase_f64_path(coo_pl, want_pl)
    f64_rows = phase_f64_kernels(kept, check_err)
    f64_pairs_steady = kept["dia_multiply_pairs_f64"]["times"][
        "steady_state_time"]
    del kept
    torch.cuda.empty_cache()
    kept = phase_dia_path()
    pairbands_ref = kept["pairbands-500k"].pop("ref")
    dia_pairbands_steady = kept["pairbands-500k"]["times"][
        "steady_state_time"]
    kernels += phase_dia_kernels(kept, check_err)
    kept["pairbands-500k f64"] = f64_pairs_steady
    phase_dia_graph_replay(kept)
    del kept
    torch.cuda.empty_cache()
    kernels += phase_macro_path(check_err, pairbands_ref)
    torch.cuda.empty_cache()
    phase_tile16_path(pairbands_ref, bf16_reference(
        banded_device(**DIA_MATRICES[TILE16_MATRIX])), dia_pairbands_steady)
    phase_persist()
    torch.cuda.empty_cache()
    kernels += tile16_rows(check_err)
    torch.cuda.empty_cache()
    phase_bf16_path(coo_pl)
    kernels += phase_sharded(coo_pl, want_pl, pairbands_ref, check_err)
    del coo_pl, want_pl, pairbands_ref
    torch.cuda.empty_cache()
    kernels += phase_precision_path(check_err)
    fill_precision_launches(kernels)
    torch.cuda.empty_cache()
    phase_aat_path()
    phase_suite()
    kernels += f64_rows
    kernels.append(phase_probe())
    for row in kernels:
        row["launches_by_path"] = {path: counts.get(row["name"], 0)
                                   for path, counts in
                                   NEW_PATH_LAUNCHES.items()}
        if row["name"] == "tile16_accumulate_pairs_f64":
            # its fresh form's one caller: a float64 Tile16 ring rank's
            # first stage (phases sharded_path and sharded_ranks)
            row["launches"] += sum(row["launches_by_path"].values())
    for row in kernels:
        # the uniform class entry has no caller on any path (nor has the
        # kernel it replaces in the JAX package), nor has the row-copy
        # probe: each is held against its plain version (the uniform entry
        # also against the ragged one) and reports its count from the path
        # runs as measured, 0 today
        if row["launches"] <= 0 and row["name"].split("@")[0] not in (
                "macro_class_uniform", "row_copy"):
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
