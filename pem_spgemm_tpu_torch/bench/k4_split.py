"""K4's time split, and the kernels against another version of their sources.

    python -m pem_spgemm_tpu_torch.bench.k4_split [--baseline-macro FILE]
        [--baseline-dia FILE]
        [--baseline-tile16 FILE] [--baseline-structure FILE]
        [--only k4|k5|k3|k3f64|k4f64|k2f64|library|k4acc|tile16|c_rowcol ...]

Builds csrc/macro_accumulate.cu and csrc/dia_multiply.cu as they are and,
with --baseline-macro / --baseline-dia, another version of each (for example
the parent commit's, ``git show <commit>:pem_spgemm_tpu_torch/csrc/<file>``)
as copies in the package's build directory, so that two versions run in one
process, on one card, on the same inputs.  A DIA baseline's
interface is read off its source (``dia_interface``): the pairs entries of
commit 2fdbfea or today's, the dense entries of commit 5b9f52f and before
(launched at their own rule, ``parent_dense_launch``) or today's.  A Macro128
baseline's float32 entries are read off its source (``macro_interface``):
no precision (commit 7303942 and before), a precision but class entries
without a grid and a ticket counter (666d068), pair-stream entries without
the accumulate argument (2abca3f), one masks_ready flag (2a6978f), or
today's.

  k4  the pair-stream entry at wandering64-1M's stream (70,308 pairs) and at
      pairbands-500k's (389,700 pairs): as it is (persistent, one block an
      SM), built as ONE_TILE (one block a C tile: the tensor-core tile
      product without the persistent stream), and the baseline's; each
      held against the plain version (flags equal, values within
      1e-5 * sum|a*b| + 1e-6), then timed by CUDA events in turns, beside
      the CUTS builds (one piece of the "highest" stage cut out each; timed
      only), the entry at precision "high" and "default" (the one-pass
      pipeline, each held against the plain version at its precision), the
      baseline's at both (where it takes a precision) and the WS_CUTS builds
      at both (one piece of the one-pass pipeline cut out; timed only);
  k5  the ragged class entry over wandering64-1M's class launches (one
      steady multiply's): this build's and the baseline's, their slabs
      bit for bit equal, the no_mark cut, this build and the baseline's at
      "high" and "default" (each held against the plain version at the
      precision, flags equal to "highest"'s) and the WS_CUTS builds at
      both, timed in turns;
  k3, k3f64  the DIA pairs entry, float32 and float64, at pairbands-500k,
      with counts and values only: this build's, the PAIR_COLS builds
      (other columns a thread), each also at the PAIR_GROUPS row groups,
      and the baseline's, each bit for bit equal to the baseline's
      (float32) or to the plain version (float64), timed in turns;
  k4acc  the pair-stream entries' accumulate form at wandering64-1M's
      stream (every C tile has pairs), float32 at each precision and
      float64: this build's fresh form, its accumulate form, the ACC_CUTS
      builds' (fewer of a row's pieces loaded ahead of their stores) and,
      with a baseline of this C interface (commit f8f1c89: its accumulate
      form at "highest" walks every c_cap tile and runs every slab), the
      baseline's two forms, the accumulate builds bit for bit equal, timed
      in turns; then, with that baseline, the 4-rank ring's largest
      accumulating stage (k4acc_ring: this build as the ring runs it,
      masks ready and the walk over the tiles with pairs, its launch
      alone, the walk alone, the masks entries, the fresh forms, the
      baseline's whole launch and, at "highest", the baseline split by its
      inputs: on the stream compacted onto its tiles with pairs, and so
      compacted with the pairs that run no slab dropped; torch.bmm; by
      graph replay, in turns);
  k4f64  the pair-stream entry's float64 entry (DMMA) at wandering64-1M's
      stream: this build's, the F64_CUTS builds (another ring depth or
      DMMA shape; the flags cut out, timed only) and the baseline's, each
      held against the plain version (flags equal, values within
      1e-12 * sum|a*b|), timed in turns;
  k2f64  the float64 dense DIA entry at banded64-1M (with counts and
      values only): this build's, the DENSE64 builds (other thread
      geometries), the count_select build (counts added by the compiler's
      select) and the baseline's (at its own launch rule), each bit for bit
      against the plain version, timed in turns; then the float32 dense
      entry at banded16/64/128-1M, this build's, the DENSE32 builds (512
      threads, plain C stores, count_select) and the baseline's, bit for
      bit equal, in turns;
  library  torch.sparse.mm(A, A) in CSR at banded16-1M, banded64-1M and
      banded128-1M: its time, or the error cuSPARSE raises;
  tile16  csrc/tile16_accumulate.cu at pairbands-500k's Tile16 stream
      (3.1 M pairs): every form of this build (masks at each precision and
      on bfloat16 tables, values only, counts, float64 masks, and the
      accumulate form on the 4-rank ring's largest accumulating stage) and,
      with --baseline-tile16 (a source of commit 33b3b17's interface), the
      baseline's, as their wrappers call them and the launch alone, held
      against each other and timed in turns, beside the baseline's cut
      builds (TILE16_PARENT_CUTS: loads only, products only, pattern only;
      timed only) and this build's (TILE16_CUTS: other depths of the
      walk's ring, held; TILE16_SPLIT_CUTS: loads only, no pattern, one
      pass at "highest", timed only);
  c_rowcol  csrc/tile16_structure.cu's tile16_c_rowcol at pairbands-500k's
      interactive stream (c_cap 1,048,576): this build's and, with
      --baseline-structure (a source of the same C interface, e.g. commit
      f8f1c89's, whose lanes enumerate a row each by __ffs), the
      baseline's, with float32 values and without, each bit for bit the
      plain version (c_rowcol_plain, extract_values), padding slots
      included, beside the baseline's ROWCOL_PARENT_CUTS builds (the
      rowcol stores alone, the padding loop alone; timed only), by
      CUDA-graph replay in turns.

Prints one JSON line a case, and last ptxas' registers and spills of each
build (this one's too), and whether ``ncu`` is on the machine.  Needs a
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import sys

import torch

from pem_spgemm_tpu_torch.config import SpGEMMConfig
from pem_spgemm_tpu_torch.models.synthetic import (banded_device,
                                                   wandering_device)
from pem_spgemm_tpu_torch.ops import _build, symbolic
from pem_spgemm_tpu_torch.ops import dia as D
from pem_spgemm_tpu_torch.ops import dia_kernels as dk
from pem_spgemm_tpu_torch.ops import macro as M
from pem_spgemm_tpu_torch.ops import macro_kernels as mk
from pem_spgemm_tpu_torch.ops import stencil as st
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro
from pem_spgemm_tpu_torch.ops.fixed import StencilMacroPlan, make_plan
from pem_spgemm_tpu_torch.ops.spgemm import SpGEMM

PAIRBANDS = (0, 1, 600, 601, -600, -601, 1200, 1201, -1200, -1201)
STREAMS = {             # chip_smoke.py's macro matrices that give K4 a stream
    "wandering64-1M": lambda: wandering_device(n=999_936, seed=4),
    "pairbands-500k": lambda: banded_device(n=500_000, seed=9,
                                            bands=PAIRBANDS),
}
STENCILS = {            # chip_smoke.py's dense DIA matrices: half-widths
    "banded16-1M": 8, "banded64-1M": 32, "banded128-1M": 64}
RTOL, ATOL = 1e-5, 1e-6
VP, LL, CI = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# Cut builds of csrc/macro_accumulate.cu: (text of the source, what replaces
# it), each text found once (a CPU test holds that).  Their results are
# wrong; they are timed only, to see what each piece of a stage costs.
_RUN = "    const bool run = !bad && (ag & bg & ANY_NZ) != 0u;\n"
CUTS = {
    # the tf32 split of each word at "highest" (the words are stored raw)
    "no_split": [("    hi = tf32_rna(v);\n"
                  "    lo = tf32_rna(v - __uint_as_float(hi));\n",
                  "    hi = __float_as_uint(v);\n"
                  "    lo = 0u;\n")],
    # the pattern (flags) of each stage
    "no_pattern": [("    if ((run || bad) && (m0 | m1) != 0u) {  // pattern "
                    "of this stage\n", "    if (false) {\n")],
    # the wait for the next stage's raw slabs
    "no_wait": [("        cp_async_wait1();\n        tc_fetch(regs, "
                 "sh.raw_a[cur ^ 1], sh.raw_b[cur ^ 1]);\n",
                 "        tc_fetch(regs, sh.raw_a[cur ^ 1], "
                 "sh.raw_b[cur ^ 1]);\n")],
    # the skip of empty slabs (every unmarked slab runs its wgmma)
    "no_skip": [(_RUN, "    const bool run = !bad;\n")],
    # the mark of non-finite and huge words (the repair's per-word cost)
    "no_mark": [("            mx = max_nan(mx, fabsf(v[e]));\n", ""),
                ("            mx = max_nan(mx, fabsf(v[c]));\n", "")],
}
# Cut builds of the one-pass pipeline ("high", "default"), as CUTS: timed
# only, at both precisions, to see where a one-pass stage's time goes.
WS_CUTS = {
    # the pattern (flags) of each stage
    "ws_no_pattern": [("        if (run || bad) ws_pattern(m, fr);\n", "")],
    # the rounding of the operands (tf32 words stored raw; bfloat16 by
    # truncation)
    "ws_no_round": [
        ("    return tf32_rna(x);\n", "    return __float_as_uint(x);\n"),
        ("    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);\n"
         "    return *reinterpret_cast<const unsigned*>(&h);\n",
         "    return (__float_as_uint(x) >> 16)\n"
         "         | (__float_as_uint(y) & 0xFFFF0000u);\n")],
    # the producer alone: the consumers release each stage unread (no
    # wgmma, no pattern, no C store)
    "ws_producer_only": [
        ("        const bool run = (ag & bg & ANY_NZ) != 0u && !bad;\n",
         "        const bool run = false;\n"),
        ("        if (run || bad) ws_pattern(m, fr);\n", ""),
        ("            if (!ACC || live) fr.store_cs<ACC>(c_num, c_flag, "
         "info.row);\n", "")],
    # the copies and the consumers alone: the producer rounds nothing and
    # marks every stage as holding non-zeros
    "ws_no_convert": [
        ("            ws_convert<P>(sh.raw[r], sh.op[s], sh.meta[s], t);\n",
         "            if (l == 0) sh.meta[s].a_any[warp] = ANY_NZ;\n"
         "            if (l == 0) sh.meta[s].b_any[warp] = ANY_NZ;\n")],
}
# The same entry with one block a C tile (grid = c_cap, each block the class
# entries' one-tile product of its tile): the tensor-core tile product
# without the persistent stream.  Its result is held like the entry's.
ONE_TILE = [
    ("    pair_stream(a_dense, b_dense, PairWalk{seg_ptr, a_idx, b_idx, next, "
     "c_cap},\n"
     "                c_num, c_flag, tc_shared());\n",
     "    const long long c = blockIdx.x;\n"
     "    const int lo = seg_ptr[c];\n"
     "    tile_product_tc(a_dense, b_dense, a_idx + lo, b_idx + lo, 0, 0,\n"
     "                    seg_ptr[c + 1] - lo, c_num + c * TILE_ELEMS,\n"
     "                    c_flag + c * TILE_ELEMS, tc_shared());\n"),
    ("    macro_pairs_kernel<<<grid < c_cap ? grid : c_cap,",
     "    macro_pairs_kernel<<<c_cap,"),
]
# the float32 entries' precisions below "highest" (their int argument is
# M.precision_code's)
LOWER = ("high", "default")
# Other builds of the pair-stream entries' accumulate form (``accumulate``
# 1), held bit for bit to this build's and timed beside it at the
# precisions of ACC_CUT_RUNS ("float64": the float64 entry).
ACC_CUTS = {
    # fewer of a row's pieces loaded ahead of their stores (1: each load,
    # then its store)
    **{f"loads{n}": [("constexpr int ACC_LOADS = 8;",
                      f"constexpr int ACC_LOADS = {n};")] for n in (1, 4)},
    **{f"f64_loads{n}": [("constexpr int F64_ACC_LOADS = 8;",
                          f"constexpr int F64_ACC_LOADS = {n};")]
       for n in (1, 4)},
}
ACC_CUT_RUNS = {**{f"loads{n}": ("highest", "high", "default")
                   for n in (1, 4)},
                **{f"f64_loads{n}": ("float64",) for n in (1, 4)}}
RING_RANKS = 4          # chip_smoke.py's replayed macro ring


# Other builds of the float64 pair-stream entry (held and timed like it, but
# "no_pattern", whose flags are wrong: timed only).
F64_CUTS = {
    "stages3": [("constexpr int F64_STAGES = 4;",
                 "constexpr int F64_STAGES = 3;")],
    "mma_k4": [("constexpr int F64_MMA_K = 8;",
                "constexpr int F64_MMA_K = 4;")],
    "no_pattern": [("        fr.pattern(sh.am[s & 1], sh.bm[s & 1], live);\n",
                    "")],
    # every DMMA block of a slab that runs is run
    "no_block_skip": [("        if (need == 0u) return 0u;\n",
                       "        need = 0xffffu;\n")],
    # every slab is copied and run (the pre-passes still run)
    "no_slab_skip": [("        const unsigned nb = need[lo + q];\n",
                      "        const unsigned nb = 0xffu;\n")],
    # C tiles stored as any other data (not evict-first)
    "plain_store": [("                    __stcs(p, v);\n",
                     "                    *p = v;\n")],
}
# Other thread geometries of the dense DIA entries: (rows, I, threads,
# blocks an SM), the .cu's Dense<float> / Dense<double> and dense_launch's
# DENSE_GEOMETRY changed together.
_DENSE64 = ("template <> struct Dense<double> {\n"
            "    static constexpr int ROWS = 8;\n"
            "    static constexpr int I = 2;\n"
            "    static constexpr int THREADS = 256;\n"
            "    static constexpr int MIN_BLOCKS = 1;\n")
DENSE64 = {
    "r4_i4_256x1": (4, 4, 256, 1),
    "r4_i4_512x1": (4, 4, 512, 1),
}
# the C and count stores as plain stores (not evict-first), both words
DENSE_PLAIN_STORE = [
    ("    __stcs(reinterpret_cast<float4*>(p), make_float4(w[0], w[1], w[2], "
     "w[3]));\n",
     "    *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], "
     "w[3]);\n"),
    ("    __stcs(reinterpret_cast<double2*>(p), make_double2(w[0], w[1]));\n",
     "    *reinterpret_cast<double2*>(p) = make_double2(w[0], w[1]);\n")]
_DENSE32 = ("template <> struct Dense<float> {\n"
            "    static constexpr int ROWS = 8;\n"
            "    static constexpr int I = 4;\n"
            "    static constexpr int THREADS = 256;\n"
            "    static constexpr int MIN_BLOCKS = 1;\n")
# the counts added by the compiler's select (n or n + inc), both words
DENSE_COUNT_SELECT = [
    ("                                    add_if_nonzero(num[r][i / 2], x, "
     "inc[i]);\n",
     "                                    num[r][i / 2] += x != T(0) ? inc[i] "
     ": 0u;\n")]
# the float32 entry's other builds: a geometry (rows, I, threads, blocks),
# or cuts of this source
DENSE32 = {
    "r8_i4_512x1": (8, 4, 512, 1),
    "plain_store": DENSE_PLAIN_STORE,
    "count_select": DENSE_COUNT_SELECT,
}


def dense64_cut(rows, i, threads, blocks, word=8):
    head = _DENSE64 if word == 8 else _DENSE32
    t = "double" if word == 8 else "float"
    return [(head, f"template <> struct Dense<{t}> {{\n"
             f"    static constexpr int ROWS = {rows};\n"
             f"    static constexpr int I = {i};\n"
             f"    static constexpr int THREADS = {threads};\n"
             f"    static constexpr int MIN_BLOCKS = {blocks};\n")]


# Other columns a thread of the pairs DIA entries, by word size: builds
# with the .cu's PAIR_COLS line (both entries' columns) changed, launched
# at pairs_variant's shape.
PAIR_COLS_LINE = "constexpr int PAIR_COLS = {};"
PAIR_COLS = {4: (2, 4), 8: (1, 2, 4)}
# row groups of a column range each pairs build is also timed at, beside
# pairs_launch's own
PAIR_GROUPS = (1, 2, 5, 10, 15, 30)


def pairs_variant(shape, cols, n_out):
    """pairs_launch's ``shape`` for a build with ``cols`` columns a thread:
    the kernel takes its columns a block from its build, and the row
    groups and staged tables of ``shape`` as they are."""
    L = dk.PAIR_THREADS * cols
    return dict(shape, cols=cols, L=L, grid_x=-(-n_out // L))


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(case, **kw):
    print(json.dumps({"case": case, **kw}), flush=True)


PTXAS = {}              # build name: ptxas' registers / spill lines


def build(stem: str, name: str, source: str, declare, cuts=()):
    """The library of ``source`` with the text substitutions ``cuts`` made,
    compiled as build/<stem>_<name>.cu (the build's text is hashed), with
    ptxas' register and spill lines kept in PTXAS."""
    with open(source) as f:
        text = f.read()
    for old, new in cuts:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer has one "
                               f"{old!r}")
        text = text.replace(old, new)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, f"{stem}_{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    so = _build.library_path(src)
    if not os.path.isfile(so):
        log = _build._finish(*_build._start(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v"], src,
            so), so)
        PTXAS[f"{stem}_{name}"] = [
            ln.strip() for ln in log.splitlines()
            if re.search(r"Compiling entry|registers|spill", ln)]
    return _build.load(so, declare)


def macro_interface(source: str) -> str:
    """The C interface of a macro_accumulate.cu: "v12" (no precision:
    commit 7303942 and before), "v13" (a precision; class entries without
    grid and ticket counter: 666d068), "v14" (pair-stream entries without
    the accumulate argument: 2abca3f), "v18" (one masks_ready flag an
    entry, no masks entries: 2a6978f) or "current"."""
    with open(source) as f:
        text = f.read()
    if "int precision" not in text:
        return "v12"
    head = text.split('extern "C" int macro_class_ragged_f32(')[1]
    if "int* next" not in head.split(")")[0]:
        return "v13"
    head = text.split('extern "C" int macro_accumulate_pairs_f32(')[1]
    head = head.split(")")[0]
    if "int accumulate" not in head:
        return "v14"
    return "v18" if "int masks_ready" in head else "current"


def _declare_v18(lib):
    """The four entries of interface "v18" (commit 2a6978f)."""
    masks = [VP, VP, CI, CI, CI]        # masks_a, masks_b, n_a, n_b, ready
    lib.macro_accumulate_pairs_f32.argtypes = [VP] * 7 + [CI, CI, VP, CI] \
        + masks + [CI, VP]
    lib.macro_class_ragged_f32.argtypes = [VP] * 6 + [CI, CI, LL, VP, VP,
                                                      CI, CI, VP] + masks \
        + [VP]
    lib.macro_class_uniform_f32.argtypes = [VP] * 5 + [CI, CI, CI, LL, VP,
                                                       VP, CI, CI, VP] \
        + masks + [VP]
    lib.macro_accumulate_pairs_f64.argtypes = [VP] * 7 + [CI] * 4 \
        + [VP] * 3 + [CI, VP]
    for fn in (lib.macro_accumulate_pairs_f32, lib.macro_class_ragged_f32,
               lib.macro_class_uniform_f32, lib.macro_accumulate_pairs_f64):
        fn.restype = CI


def declare_macro(kind: str):
    """mk._declare for a baseline of interface ``kind``."""
    def declare(lib):
        if kind == "current":
            mk._declare(lib)
            return
        _declare_v18(lib)
        if kind == "v18":
            return
        # the float64 entry without the accumulate argument
        lib.macro_accumulate_pairs_f64.argtypes = \
            lib.macro_accumulate_pairs_f64.argtypes[:-2] + [VP]
        if kind == "v14":
            lib.macro_accumulate_pairs_f32.argtypes = \
                lib.macro_accumulate_pairs_f32.argtypes[:-2] + [VP]
            return
        prec = [] if kind == "v12" else [CI]
        lib.macro_accumulate_pairs_f32.argtypes = [VP] * 7 + [CI, CI, VP] \
            + prec + [VP]
        lib.macro_class_ragged_f32.argtypes = [VP] * 6 + [CI, CI, LL, VP,
                                                          VP] + prec + [VP]
        lib.macro_class_uniform_f32.argtypes = [VP] * 5 + [CI, CI, CI, LL,
                                                           VP, VP] + prec \
            + [VP]
    return declare


def tail_args(kind: str, precision: str, masks):
    """The pair-stream entry's arguments after ``next`` in its fresh form,
    for interface ``kind``; ``masks``: the six mask arguments of the
    current one (mask_args: A = B, one ready flag for both before v19)."""
    if kind == "v12":
        return ()
    if kind == "v13":
        return (M.precision_code(precision),)
    if kind == "v14":
        return (M.precision_code(precision), *masks[:5])
    if kind == "v18":
        return (M.precision_code(precision), *masks[:5], 0)
    return (M.precision_code(precision), *masks, 0, None)   # no walk


def class_args(kind: str, precision: str, grid: int, ticket, masks):
    """A class entry's arguments after c_flag, for interface ``kind``."""
    if kind == "v12":
        return ()
    if kind == "v13":
        return (M.precision_code(precision),)
    return (M.precision_code(precision), grid, ticket,
            *(masks if kind == "current" else masks[:5]))


def mask_args(table, ready: bool):
    """The six mask arguments of the current entries for A = B =
    ``table`` (a (tiles, TM_WORDS) int32 buffer), computed by the launch
    unless ``ready``."""
    return (table.data_ptr(), table.data_ptr(), table.shape[0],
            table.shape[0], int(ready), int(ready))


def dia_interface(source: str) -> str:
    """The C interface of a dia_multiply.cu: "v8" (pairs entries of commit
    2fdbfea: the float32 one with d1n and stage_a, the float64 one without
    a launch shape; dense entries as below), "v21" (today's pairs entries;
    the dense entries of commit 5b9f52f and before, with a row-block grid
    and a window staged a chunk: ``parent_dense_launch``) or "current"."""
    with open(source) as f:
        text = f.read()
    if "int cw_log2" not in text:
        return "current"
    return "v8" if "int stage_a" in text else "v21"


def declare_baseline_dia(kind: str):
    """dk._declare for a baseline of ``kind`` (``dia_interface``)."""
    def declare(lib):
        dk._declare(lib)
        if kind == "current":
            return
        lib.dia_multiply_dense_f32.argtypes = [VP] * 5 + [CI] * 3 \
            + [LL] * 3 + [CI] * 7 + [VP]
        lib.dia_multiply_dense_f64.argtypes = \
            lib.dia_multiply_dense_f32.argtypes
        if kind == "v8":
            lib.dia_multiply_pairs_f32.argtypes = [VP] * 6 + [CI] * 5 \
                + [LL] * 3 + [CI] * 4 + [VP]
            lib.dia_multiply_pairs_f64.argtypes = [VP] * 6 + [CI, LL, LL,
                                                              LL, VP]
    return declare


# The dense entries' launch rule of commit 5b9f52f (and before): a block of
# (at most 8) row blocks x column blocks owns one column range of some C
# rows, grid_y blocks a range, and stages per chunk of at most kc bands the
# A chunk and a B window within 112 KB (two blocks an SM).
PARENT_DENSE_GEOMETRY = {4: dict(rows=8, cols=4, threads=256),
                         8: dict(rows=4, cols=4, threads=256)}


def parent_dense_launch(offs_a, d2n: int, dcn: int, word: int = 4):
    """The parent's dk.dense_launch (commit 5b9f52f), for a baseline of
    interface "v8" or "v21"."""
    offs_a = tuple(offs_a)
    geo = PARENT_DENSE_GEOMETRY[word]
    rows, cols, threads = geo["rows"], geo["cols"], geo["threads"]
    tr = min(8, threads // 32, dk._pow2_at_least(-(-dcn // rows)))
    tc_n = min(threads // tr, 64)
    L = tc_n * cols
    rb = rows * tr
    for kc in (128, 64, 32, 16, 8, 4, 2, 1):
        chunks = dk.dense_chunks(offs_a, kc)
        a_rows = max(ke - kb for kb, ke in chunks)
        span = max(offs_a[ke - 1] - offs_a[kb] for kb, ke in chunks)
        rows_cap = min(d2n, rb + span) + 2 * (rows - 1)
        cols_cap = L + span
        s = -(-max(cols_cap, rows_cap + 3) // 32) * 32
        b_off = a_rows * L
        stage = b_off + rows_cap * s
        if word * stage <= 112 * 1024:
            break
    else:
        raise ValueError("the parent's window does not fit")
    cw = min(32, dk._pow2_at_least(cols_cap))
    return dict(tr_log2=tr.bit_length() - 1, tc_n=tc_n, L=L, kc=kc, s=s,
                cw_log2=cw.bit_length() - 1, b_off=b_off, stage_words=stage,
                smem_bytes=word * stage, grid_y=-(-dcn // rb),
                rows_per_block=rb, chunks=len(chunks), rows=rows, cols=cols,
                threads=tr * tc_n)


def dense_launcher(lib, word, kind, a, offs, offs_dev, c, cnt, stream,
                   geometry=None):
    """(launch, shape): one dense DIA launch of ``lib`` (interface
    ``kind``) for A * A on the stencil ``a`` (bands, n) into c / cnt, at
    the launch shape of its own rule (``geometry`` in place of
    dk.DENSE_GEOMETRY[word] for the current rule)."""
    dcn, n = c.shape
    fn = lib.dia_multiply_dense_f64 if word == 8 \
        else lib.dia_multiply_dense_f32
    head = [a.data_ptr(), a.data_ptr(), offs_dev.data_ptr(), c.data_ptr(),
            None if cnt is None else cnt.data_ptr(), a.shape[0], a.shape[0],
            dcn, n, n, n]
    if kind == "current":
        keep = dk.DENSE_GEOMETRY[word]
        dk.DENSE_GEOMETRY[word] = geometry or keep
        try:
            shape = dk.dense_launch(offs, len(offs), dcn, word, n,
                                    dk.sm_count(a.device))
        finally:
            dk.DENSE_GEOMETRY[word] = keep
        tail = list(dk.dense_args(shape))
    else:
        shape = parent_dense_launch(offs, len(offs), dcn, word)
        tail = [shape[k] for k in ("tr_log2", "tc_n", "kc", "s", "cw_log2",
                                   "b_off", "stage_words")]
    args = head + tail
    return (lambda: checked(fn(*args, stream), "dense")), shape


def time_ms(fn, n):
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


def in_turns(fns, n, rounds=2):
    """{name: [ms, ...]}: each function timed once a round, the order
    reversed every other round."""
    out = {k: [] for k in fns}
    names = list(fns)
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            out[k].append(time_ms(fns[k], n))
    return out


def checked(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def pair_stream(a):
    """(n_pairs, n_tiles, a_idx, b_idx, seg) of a @ a, padded to 256."""
    offsets = symbolic.pair_counts(a.tile_col, a.tile_rowptr, a.ntiles)
    n_pairs = int(offsets[-1])
    p_cap = max(256, -(-n_pairs // 256) * 256)
    out = symbolic.expand_pairs(offsets, a.tile_row, a.tile_col,
                                a.tile_rowptr, a.tile_col, n_pairs, p_cap,
                                True)
    return n_pairs, int(out[5]), out[2], out[3], out[4]


def hold(got, want, mag, what):
    (gn, gf), (wn, wf) = got, want
    if not torch.equal(gf, wf):
        raise AssertionError(f"{what}: flags differ from the plain version")
    over = float(((gn - wn).abs() / (RTOL * mag + ATOL)).max())
    if not over <= 1.0:
        raise AssertionError(f"{what}: values {over}x the float32 bound")
    return over


def build_all(stem: str, source: str, declare, variants):
    """{name: library} of ``build`` for each (name, cuts) of ``variants``,
    the compilers started together."""
    with open(source) as f:
        text = f.read()
    started = {}
    for name, cuts in variants.items():
        src_text = text
        for old, new in cuts:
            if src_text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has one "
                                   f"{old!r}")
            src_text = src_text.replace(old, new)
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        src = os.path.join(_build.BUILD_DIR, f"{stem}_{name}.cu")
        with open(src, "w") as f:
            f.write(src_text)
        so = _build.library_path(src)
        if not os.path.isfile(so):
            started[name] = (so, _build._start(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v"],
                src, so))
        else:
            started[name] = (so, None)
    libs = {}
    for name, (so, proc) in started.items():
        if proc is not None:
            log = _build._finish(*proc, so)
            PTXAS[f"{stem}_{name}"] = [
                ln.strip() for ln in log.splitlines()
                if re.search(r"Compiling entry|registers|spill", ln)]
        libs[name] = _build.load(so, declare)
    return libs


def held_key(k: str) -> str | None:
    """The precision a timed build's result is held at ("highest" where the
    key names none), or None for a cut build (timed only)."""
    name, _, prec = k.partition("@")
    if name in CUTS or name in WS_CUTS:
        return None
    return prec or "highest"


def case_k4(base, n_time):
    base_lib, base_kind = base
    cur = mk._library()
    variants = {"one_tile_a_block": ONE_TILE, **CUTS, **WS_CUTS}
    libs = build_all("macro_accumulate", mk.SOURCE, mk._declare, variants)
    stream = torch.cuda.current_stream().cuda_stream
    sms = mk.persistent_grid(torch.device("cuda"))
    for name, make in STREAMS.items():
        a = coo_to_macro(make())
        n_pairs, n_tiles, a_idx, b_idx, seg = pair_stream(a)
        c_cap = -(-n_tiles // 256) * 256
        seg_ptr = mk.segment_offsets(seg, c_cap)
        mag = M.accumulate_macro(a.dense.abs(), a.dense.abs(), a_idx, b_idx,
                                 seg, c_cap, 256)[0]
        num = torch.empty((c_cap, 128, 128), device="cuda")
        flag = torch.empty((c_cap, 128, 128), dtype=torch.uint8,
                           device="cuda")
        next_tile = torch.zeros(1, dtype=torch.int32, device="cuda")
        ptrs = (a.dense.data_ptr(), a.dense.data_ptr(), a_idx.data_ptr(),
                b_idx.data_ptr(), seg_ptr.data_ptr(), num.data_ptr(),
                flag.data_ptr(), c_cap)
        # every launch computes the masks, as a stand-alone one does
        table = torch.empty((a.dense.shape[0], mk.TM_WORDS),
                            dtype=torch.int32, device="cuda")
        masks = mask_args(table, False)

        def launch(lib, what, p, kind="current"):
            extra = tail_args(kind, p, masks)
            return lambda: (next_tile.zero_(), checked(
                lib.macro_accumulate_pairs_f32(
                    *ptrs, sms, next_tile.data_ptr(), *extra, stream), what))

        fns = {"persistent": launch(cur, "current", "highest")}
        for p in LOWER:
            fns[f"persistent@{p}"] = launch(cur, p, p)
        for cut in ("one_tile_a_block", *CUTS):
            fns[cut] = launch(libs[cut], cut, "highest")
        for cut in WS_CUTS:
            for p in LOWER:
                fns[f"{cut}@{p}"] = launch(libs[cut], cut, p)
        if base_lib is not None:
            for p in ("highest",) if base_kind == "v12" else ("highest",
                                                              *LOWER):
                k = "baseline" if p == "highest" else f"baseline@{p}"
                fns[k] = launch(base_lib, k, p, base_kind)
        over = {}
        for p in ("highest", *LOWER):
            want = M.accumulate_macro(a.dense, a.dense, a_idx, b_idx, seg,
                                      c_cap, 256, precision=p)
            for k, fn in fns.items():
                if held_key(k) != p:
                    continue                # a cut build's result is wrong
                num.fill_(float("nan"))
                flag.fill_(7)
                fn()
                torch.cuda.synchronize()
                over[k] = hold((num, flag), want, mag, f"{name} {k}")
            del want
        del mag
        torch.cuda.empty_cache()
        times = in_turns(fns, n_time[name])
        emit("k4", matrix=name, pairs=n_pairs, c_tiles=n_tiles, c_cap=c_cap,
             grid=sms, ms=times, worst_over_bound=over,
             pairs_a_tile=n_pairs / n_tiles)
        del a, a_idx, b_idx, seg, seg_ptr, num, flag, next_tile, table
        torch.cuda.empty_cache()


def case_k5(base):
    base_lib, base_kind = base
    cur = mk._library()
    libs = build_all("macro_accumulate", mk.SOURCE, mk._declare,
                     {"no_mark": CUTS["no_mark"], **WS_CUTS})
    stream = torch.cuda.current_stream().cuda_stream
    sms = mk.persistent_grid(torch.device("cuda"))
    cfg = SpGEMMConfig(engine="macro")
    a = coo_to_macro(STREAMS["wandering64-1M"]())
    plan = make_plan(SpGEMM(cfg)(a, a), cfg, a, a)
    if not isinstance(plan, StencilMacroPlan):
        raise AssertionError(f"wandering64-1M: plan {type(plan).__name__}")
    sp = plan.plan
    rows = sum(c[0] * (b.numel() // 2)
               for c, b in zip(sp.classes, sp.class_bases))
    tickets = torch.zeros(len(sp.classes), dtype=torch.int32, device="cuda")
    # the first launch of a multiply computes the masks, the others read
    # them (as ops.stencil.stencil_accumulate runs them)
    table = torch.empty((a.dense.shape[0], mk.TM_WORDS), dtype=torch.int32,
                        device="cuda")
    slabs = {}

    def classes(lib, kind, key, precision, slab):
        if slab not in slabs:
            slabs[slab] = (
                torch.full((rows, 128, 128), float("nan"), device="cuda"),
                torch.full((rows, 128, 128), 7, dtype=torch.uint8,
                           device="cuda"))
        num, flag = slabs[slab]

        def run():
            tickets.zero_()
            for i, ((t, _p, _ar, _br, _ao, _bo, base), bases,
                    (p_ptr, ao, bo)) in enumerate(zip(
                        sp.classes, sp.class_bases, sp.class_tables)):
                checked(lib.macro_class_ragged_f32(
                    a.dense.data_ptr(), a.dense.data_ptr(), bases.data_ptr(),
                    p_ptr.data_ptr(), ao.data_ptr(), bo.data_ptr(), t,
                    bases.numel() // 2, base, num.data_ptr(),
                    flag.data_ptr(),
                    *class_args(kind, precision, sms, tickets[i].data_ptr(),
                                mask_args(table, i > 0)), stream), key)
        return run

    fns = {"current": classes(cur, "current", "current", "highest",
                              "current"),
           "no_mark": classes(libs["no_mark"], "current", "no_mark",
                              "highest", "cut")}
    for p in LOWER:
        fns[p] = classes(cur, "current", p, p, p)
        for cut in WS_CUTS:
            fns[f"{cut}@{p}"] = classes(libs[cut], "current", cut, p, "cut")
    if base_lib is not None:
        fns["baseline"] = classes(base_lib, base_kind, "baseline",
                                  "highest", "baseline")
        if base_kind != "v12":
            for p in LOWER:
                fns[f"baseline@{p}"] = classes(base_lib, base_kind,
                                               f"baseline@{p}", p,
                                               f"baseline@{p}")
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    equal = None
    if base_lib is not None:
        equal = all(torch.equal(x, y) for x, y in
                    zip(slabs["current"], slabs["baseline"]))
        if not equal:
            raise AssertionError("K5: the current and the baseline entry "
                                 "differ on wandering64-1M")
    held = [k for k in slabs if k in LOWER or k.startswith("baseline@")]
    flags_equal = {k: torch.equal(slabs[k][1], slabs["current"][1])
                   for k in held}
    if not all(flags_equal.values()):
        raise AssertionError(f"K5: flags differ across precisions "
                             f"{flags_equal}")
    # the lower precisions against the plain version at each
    mag = torch.zeros((rows, 128, 128), device="cuda")
    want = torch.empty((rows, 128, 128), device="cuda")
    pat = torch.empty((rows, 128, 128), dtype=torch.uint8, device="cuda")
    over = {}
    for i, (cls, bases) in enumerate(zip(sp.classes, sp.class_bases)):
        t, p, _ar, _br, ao, bo, base = cls
        st.class_call_plain(mag, pat, a.dense.abs(), a.dense.abs(), bases, t,
                            p, ao, bo, base)
    for prec in LOWER:
        for cls, bases in zip(sp.classes, sp.class_bases):
            t, p, _ar, _br, ao, bo, base = cls
            st.class_call_plain(want, pat, a.dense, a.dense, bases, t, p, ao,
                                bo, base, prec)
        for k in held:
            if k.endswith(prec):
                over[k] = hold(slabs[k], (want, pat), mag, f"K5 {k}")
    del mag, want, pat
    torch.cuda.empty_cache()
    times = in_turns(fns, 10, rounds=4)
    emit("k5", matrix="wandering64-1M", classes=len(sp.classes),
         c_rows=rows, grid=sms, ms=times, bit_equal_to_baseline=equal,
         flags_equal_across_precisions=True, worst_over_bound=over)


def case_pairs(word, base):
    """A pairs DIA entry at pairbands-500k (``word`` 4: K3, float32; 8:
    K3-f64), with counts and values only: this build, the PAIR_COLS builds,
    each also at the PAIR_GROUPS row groups, and the baseline (``base``:
    (library, interface); commit 2fdbfea's entry at its own launch shape,
    or today's at this build's), in turns.  Every run is held bit for bit:
    the float32 ones to the baseline's (to this build's without one), the
    float64 ones to the plain version."""
    base_lib, base_kind = base if base is not None else (None, None)
    case = "k3" if word == 4 else "k3f64"
    dtype = torch.float32 if word == 4 else torch.float64
    entry = "dia_multiply_pairs_f32" if word == 4 else "dia_multiply_pairs_f64"
    stream = torch.cuda.current_stream().cuda_stream
    builds = {"current": (dk._library(), dk.PAIR_COLS)}
    for cols in PAIR_COLS[word]:
        if cols != dk.PAIR_COLS:
            builds[f"cols{cols}"] = (
                build("dia_multiply", f"pairs_cols{cols}", dk.SOURCE,
                      dk._declare,
                      cuts=[(PAIR_COLS_LINE.format(dk.PAIR_COLS),
                             PAIR_COLS_LINE.format(cols))]),
                cols)
    a = D.coo_to_dia(STREAMS["pairbands-500k"](), dtype=dtype)
    offs = tuple(int(x) for x in a.offsets)
    dc_list, idx_map = D._plan_maps(offs, offs)
    row_ptr, trip = dk.dia_tables(offs, offs, dc_list, "pairs", a.device)
    n, dcn, d1n = a.n, len(dc_list), len(offs)
    n_pairs = d1n * d1n
    ptrs = (a.bands.data_ptr(), a.bands.data_ptr(), row_ptr.data_ptr(),
            trip.data_ptr())
    runs = {}                       # name: (launch(c, cnt), shape)
    shape = dk.pairs_launch(d1n, dcn, n_pairs, n, word)
    for name, (lib, cols) in builds.items():
        base = pairs_variant(shape, cols, n)
        for gy in (base["grid_y"],) + PAIR_GROUPS:
            key = name if gy == base["grid_y"] else f"{name}_gy{gy}"
            if key in runs:
                continue
            sh = dict(base, grid_y=gy)
            runs[key] = ((lambda fn, sh: lambda c, cnt: fn(
                *ptrs, c, cnt, dcn, n_pairs, offs[0], offs[-1], n, n, n,
                sh["grid_y"], int(sh["stage_tables"]), sh["smem_bytes"],
                stream))(getattr(lib, entry), sh), sh)
    if base_lib is not None and base_kind != "v8":
        sh = runs["current"][1]
        runs["baseline"] = ((lambda fn: lambda c, cnt: fn(
            *ptrs, c, cnt, dcn, n_pairs, offs[0], offs[-1], n, n, n,
            sh["grid_y"], int(sh["stage_tables"]), sh["smem_bytes"],
            stream))(getattr(base_lib, entry)), None)
    elif base_lib is not None:
        fn = getattr(base_lib, entry)
        if word == 4:               # every C row a block, A and tables staged
            t_bytes = 4 * (dcn + 1 + 3 * n_pairs)
            runs["baseline"] = (lambda c, cnt: fn(
                *ptrs, c, cnt, d1n, dcn, n_pairs, offs[0], offs[-1], n, n,
                n, 1, 1, 1, 4 * d1n * 1024 + t_bytes, stream), None)
        else:
            runs["baseline"] = (lambda c, cnt: fn(
                *ptrs, c, cnt, dcn, n, n, n, stream), None)
    for values_only in (False, True):
        want = D._dia_multiply_torch(a.bands, a.bands, offs_a=offs,
                                     idx_map=idx_map, dc_count=dcn, n_out=n,
                                     values_only=values_only)
        outs, fns = {}, {}
        for name, (launch, _sh) in runs.items():
            outs[name] = (
                torch.full((dcn, n), float("nan"), dtype=dtype,
                           device="cuda"),
                None if values_only else torch.empty((dcn, n),
                                                     device="cuda"))
            fns[name] = (lambda launch, name, c, cnt: lambda: checked(
                launch(c.data_ptr(), None if cnt is None else cnt.data_ptr()),
                name))(launch, name, *outs[name])
            fns[name]()
        torch.cuda.synchronize()
        ref = "baseline" if word == 4 and base_lib is not None else None
        equal = {}
        for name, (c, cnt) in outs.items():
            wc, wn = (outs[ref] if ref else
                      want if word == 8 else outs["current"])
            bits = torch.int32 if word == 4 else torch.int64
            equal[name] = torch.equal(c.view(bits), wc.view(bits)) and (
                values_only or torch.equal(cnt, wn))
        del want
        if not all(equal.values()):
            raise AssertionError(f"{case}: not bit-equal: {equal}")
        c_bytes = word * dcn * n
        emit(case, matrix="pairbands-500k", values_only=values_only,
             shape=[d1n, n], c_rows=dcn,
             launch={k: {x: v[x] for x in ("cols", "L", "grid_x", "grid_y",
                                           "smem_bytes")}
                     for k, (_f, v) in runs.items() if k in builds},
             ms=in_turns(fns, 20, rounds=2),
             bit_equal_to="baseline" if ref else
             "plain version" if word == 8 else "current",
             bit_equal=equal,
             bound_ms=(word * d1n * n + c_bytes
                       + (0 if values_only else 4 * dcn * n))
             / 3.35e12 * 1e3)
        del fns, outs
        torch.cuda.empty_cache()


def hold_f64(got, want, mag, what):
    """Flags equal, values within 1e-12 * sum|a*b|: the worst ratio."""
    (gn, gf), (wn, wf) = got, want
    if not torch.equal(gf, wf):
        raise AssertionError(f"{what}: flags differ from the plain version")
    over = float(((gn - wn).abs() / (1e-12 * mag + 1e-300)).max())
    if not over <= 1.0:
        raise AssertionError(f"{what}: values {over}x the float64 bound")
    return over


def acc_launch(lib, kind, a, b, pa, pb, seg_ptr, c_cap, c, precision,
               tables, ready, acc, walk=None, next_tile=None, need=None):
    """One launch of a pair-stream entry of a build of interface ``kind``
    ("v18": the parent's, or "current"): float32 at ``precision`` or, for
    float64 tables, the float64 entry; into ``c`` (c_cap tiles), the
    fresh form (``acc`` 0) or the accumulate form (1; the current build
    walks ``walk`` at "high" / "default" and in float64); the tables'
    masks ``tables`` (A's, B's) made unless ``ready``."""
    ptrs = (a.data_ptr(), b.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            seg_ptr.data_ptr(), c[0].data_ptr(), c[1].data_ptr(), c_cap)
    masks = (tables[0].data_ptr(), tables[1].data_ptr())
    walk = None if walk is None else walk.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    if a.dtype == torch.float64:
        ready_args = () if kind == "v18" else (int(ready), int(ready))
        tail = (need.data_ptr(), acc) if kind == "v18" \
            else (need.data_ptr(), acc, walk)
        return checked(lib.macro_accumulate_pairs_f64(
            *ptrs, a.shape[0], b.shape[0], pa.numel(), *masks, *ready_args,
            *tail, stream), f"{kind} float64 entry")
    ready_args = (int(ready),) if kind == "v18" else (int(ready),) * 2
    tail = (acc,) if kind == "v18" else (acc, walk)
    next_tile.zero_()
    return checked(lib.macro_accumulate_pairs_f32(
        *ptrs, mk.persistent_grid(a.device), next_tile.data_ptr(),
        M.precision_code(precision), *masks, a.shape[0], b.shape[0],
        *ready_args, *tail, stream), f"{kind} float32 entry")


def same_bits(fns, prior, what):
    """Each of ``fns`` (name: launch into a C given) once into a copy of
    ``prior``: every result bit for bit the first's."""
    ref = None
    for k, fn in fns.items():
        c = tuple(x.clone() for x in prior)
        fn(c)
        torch.cuda.synchronize()
        got = (c[0].view(torch.int64 if c[0].element_size() == 8
                         else torch.int32), c[1])
        if ref is None:
            ref = got
        elif not (torch.equal(got[0], ref[0]) and torch.equal(got[1],
                                                             ref[1])):
            raise AssertionError(f"{what}: {k} is not bit for bit "
                                 f"{next(iter(fns))}")
    return list(fns)


def case_k4acc(base, base_source, rounds=3, n=10):
    """K4's accumulate form.  At wandering64-1M's stream, where every C
    tile has pairs (the most C a stage reads), in float32 at each precision
    and in float64: this build's fresh form, its accumulate form into the C
    the fresh one wrote, the ACC_CUTS builds' (at the precisions of
    ACC_CUT_RUNS) and, with a baseline of this interface (the parent), its
    two forms,
    the accumulate builds bit for bit this build's from the same C, timed
    in turns (each launch computing the tables' masks, as a launch handed
    none does).  Then the ring stage (``k4acc_ring``).  ``c_bytes_ms``:
    the C the accumulate form also reads, at 3.35 TB/s."""
    cur = mk._library()
    libs = build_all("macro_accumulate", mk.SOURCE, mk._declare, ACC_CUTS)
    sms = mk.persistent_grid(torch.device("cuda"))
    parent = base[0] if base[1] == "current" else None
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        a = coo_to_macro(STREAMS["wandering64-1M"](), dtype=dtype)
        n_pairs, n_tiles, a_idx, b_idx, seg = pair_stream(a)
        c_cap = -(-n_tiles // 256) * 256
        seg_ptr = mk.segment_offsets(seg, c_cap)
        walk = mk.stream_walk(seg, c_cap, min(c_cap, a_idx.numel()))
        c = (torch.empty((c_cap, 128, 128), dtype=dtype, device="cuda"),
             torch.empty((c_cap, 128, 128), dtype=torch.uint8,
                         device="cuda"))
        next_tile = torch.zeros(1, dtype=torch.int32, device="cuda")
        table = torch.empty((a.dense.shape[0], mk.TM_WORDS),
                            dtype=torch.int32, device="cuda")
        need = torch.empty(a_idx.numel(), dtype=torch.uint8, device="cuda")

        def launch(lib, acc, p, kind="current"):
            return lambda out: acc_launch(
                lib, kind, a.dense, a.dense, a_idx, b_idx, seg_ptr, c_cap,
                out, p, (table, table), False, acc, walk, next_tile, need)

        for p in ("highest",) if f64 else ("highest", *LOWER):
            fns = {"fresh": launch(cur, 0, p),
                   "accumulate": launch(cur, 1, p)}
            fns.update({k: launch(lib, 1, p) for k, lib in libs.items()
                        if ("float64" if f64 else p) in ACC_CUT_RUNS[k]})
            if parent is not None:
                fns["parent_fresh"] = launch(parent, 0, p)
                fns["parent_accumulate"] = launch(parent, 1, p)
            fns["fresh"](c)
            same_bits({k: f for k, f in fns.items() if "fresh" not in k},
                      c, f"k4acc at {p}")
            same_bits({k: f for k, f in fns.items() if "fresh" in k},
                      c, f"k4acc fresh at {p}")
            ms = {k: [] for k in fns}
            for _ in range(rounds):
                for k, fn in fns.items():
                    ms[k].append(time_ms(lambda: fn(c), n))
            emit("k4acc", matrix="wandering64-1M", dtype=str(dtype)[6:],
                 precision=p, pairs=n_pairs, c_tiles=n_tiles, ms=ms,
                 c_bytes_ms=n_tiles * 128 * 128 * (dtype.itemsize + 1)
                 / 3.35e12 * 1e3)
        del a, c, table, need, walk
        torch.cuda.empty_cache()
    if base_source is not None and base[1] == "current":
        k4acc_ring(base_source, rounds=rounds, n=n)


def ring_stage(dtype):
    """The RING_RANKS-rank wandering64-1M ring's largest accumulating stage,
    as chip_smoke.py's accumulate rows take it: {a (the rank's A slice),
    b (the chunk it holds then), pa, pb, seg (the stage's tables), c_cap,
    pairs, tiles (the C tiles it has pairs for), rank, stage}."""
    from pem_spgemm_tpu_torch.parallel import sharded_macro as sm
    m = coo_to_macro(STREAMS["wandering64-1M"](), dtype=dtype)
    plans = [sm.plan_sharded_macro(m, m, RING_RANKS, d)
             for d in range(RING_RANKS)]
    del m
    d, s = sm.largest_accumulating_stage(plans)
    p = plans[d]
    seg = p.seg[s]
    return dict(a=p.a_dense, b=plans[(d - s) % RING_RANKS].b_dense,
                pa=p.pairs_a[s], pb=p.pairs_b[s], seg=seg, c_cap=p.c_cap,
                pairs=p.stage_pairs[s],
                tiles=int(torch.unique(seg[seg < p.c_cap]).numel()),
                rank=d, stage=s)


def compacted(seg, c_cap):
    """(seg', T): the stream's C tiles with pairs renumbered 0 .. T - 1 in
    order (padding kept): a launch over c_cap T visits only the tiles with
    pairs, into a C of T tiles (a cut of the walk, timed only)."""
    live = seg < c_cap
    first = live.clone()
    first[1:] &= seg[1:] != seg[:-1]
    new = torch.cumsum(first, 0, dtype=torch.int32) - 1
    return torch.where(live, new, seg).contiguous(), int(first.sum())


def bmm_graph_fn(a, b, pa, pb, precision):
    """torch.bmm over the stage's pre-gathered (P, 128, 128) operands at
    ``precision`` (float32; TF32 allowed at "high"; bfloat16 operands with
    float32 output at "default"; float64 tiles in float64): the products
    only, a yardstick the port never calls."""
    cast = a.dtype if a.dtype == torch.float64 or precision != "default" \
        else torch.bfloat16
    ad, bd = a[pa.long()].to(cast), b[pb.long()].to(cast)
    if cast == torch.bfloat16:
        return lambda: torch.bmm(ad, bd, out_dtype=torch.float32)
    if precision == "high" and a.dtype == torch.float32:
        def fn():
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return torch.bmm(ad, bd)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old
        return fn
    return lambda: torch.bmm(ad, bd)


def needed_slabs(a, b, pa, pb):
    """(P,) int32: the slabs each pair runs (the .cu's slabs_needed, from
    the tables' k-masks: mk.tile_masks_plain)."""
    ma = mk.tile_masks_plain(a)[pa.long()]
    mb = mk.tile_masks_plain(b)[pb.long()]
    need = (ma[:, 4] | mb[:, 9]) & 0xF
    for s_ in range(4):
        need |= ((ma[:, s_] & mb[:, 5 + s_]) != 0).to(torch.int32) << s_
    return need


def dropped(seg, pa, pb, keep, c_cap):
    """(seg', pa', pb', P'): the stream with the pairs ``keep`` marks
    False moved past its live pairs (INT32_MAX), still sorted."""
    live = (seg < c_cap) & keep
    order = torch.argsort((~live).to(torch.int8), stable=True)
    seg2 = torch.where(live, seg, symbolic.INT32_MAX)[order].contiguous()
    return (seg2, pa[order].contiguous(), pb[order].contiguous(),
            int(live.sum()))


def k4acc_ring(base_source, rounds=3, n=10):
    """K4's accumulate form at the ring stage (``ring_stage``), float32 at
    "high", "default" and "highest" and float64, by graph replay in turns:
    this build as the ring runs it (the wrapper: the walk list built, both
    tables' masks ready: ``this``), its launch alone (``this_launch``), the
    walk alone (``this_walk``), the masks entries over both tables
    (``this_masks``) and its fresh form, beside the parent's
    (``base_source``, this C interface: commit f8f1c89) whole launch as
    the ring made it and its fresh form and, at "highest", the parent
    split by its inputs (timed only): its launch on the stream compacted
    onto the tiles with pairs (the c_cap walk cut: ``parent_walked``), and
    so compacted with the pairs none of whose slabs runs dropped
    (``parent_walked_needed``: the slabs that multiply only zeros dropped
    as far as whole pairs go; the parent runs a pair's four slabs), and
    torch.bmm over the stage's pairs.  This build's accumulate form bit for
    bit the parent's from one prior C (no -0.0 in it: a tile none of whose
    slabs runs keeps its -0.0 here and not in the parent)."""
    kind = macro_interface(base_source)
    if kind != "current":
        raise ValueError(f"the ring stage takes a parent of this interface, "
                         f"not {kind}")
    cur = mk._library()
    parent = build("macro_accumulate_parent", "whole", base_source,
                   declare_macro(kind))
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        st = ring_stage(dtype)
        a, b, pa, pb, seg = st["a"], st["b"], st["pa"], st["pb"], st["seg"]
        c_cap, dev = st["c_cap"], a.device
        seg_ptr = mk.segment_offsets(seg, c_cap)
        cap = min(c_cap, pa.numel())
        walk = mk.stream_walk(seg, c_cap, cap)
        cseg, n_live = compacted(seg, c_cap)
        cseg_ptr = mk.segment_offsets(cseg, n_live)
        need = needed_slabs(a, b, pa, pb)
        live = seg < c_cap
        nseg, npa, npb, n_needed = dropped(cseg, pa, pb, need != 0, n_live)
        nseg_ptr = mk.segment_offsets(nseg, n_live)
        g = torch.Generator(device=dev).manual_seed(5)
        prior = (torch.randn((c_cap, 128, 128), generator=g, device=dev,
                             dtype=dtype),
                 (torch.rand((c_cap, 128, 128), generator=g, device=dev)
                  < 0.3).to(torch.uint8))
        c = tuple(x.clone() for x in prior)
        cc = tuple(torch.zeros((n_live, 128, 128), dtype=x, device=dev)
                   for x in (dtype, torch.uint8))
        tables = tuple(torch.zeros((x.shape[0], mk.TM_WORDS),
                                   dtype=torch.int32, device=dev)
                       for x in (a, b))
        masks = mk.TileMasks(a, b)
        masks.a.make()
        masks.b.make()
        next_tile = torch.zeros(1, dtype=torch.int32, device=dev)
        scratch = torch.empty(pa.numel(), dtype=torch.uint8, device=dev)
        for p in ("float64",) if f64 else (*LOWER, "highest"):
            def run(lib, acc=1, stream=None):
                sp, x, y, cap_, out = (seg_ptr, pa, pb, c_cap, c) \
                    if stream is None else stream
                return lambda into=None: acc_launch(
                    lib, "current", a, b, x, y, sp, cap_, into or out, p,
                    tables, False, acc, walk, next_tile, scratch)
            this = lambda into=None: mk.accumulate_macro_pairs(
                a, b, pa, pb, seg, c_cap, precision="highest" if f64 else p,
                tile_masks=masks, out=into or c)
            this_launch = lambda into=None: acc_launch(
                cur, "current", a, b, pa, pb, seg_ptr, c_cap, into or c, p,
                (masks.a.words, masks.b.words), True, 1, walk, next_tile,
                scratch)
            same_bits({"parent": run(parent), "this": this,
                       "this_launch": this_launch}, prior,
                      f"ring stage at {p}")
            fns = {"parent": run(parent), "this": this,
                   "this_launch": this_launch,
                   "this_walk": lambda: mk.stream_walk(seg, c_cap, cap,
                                                       next_tile),
                   "this_masks": lambda: (masks.a.make(), masks.b.make()),
                   "parent_fresh": run(parent, acc=0),
                   "this_fresh": run(cur, acc=0)}
            if p == "highest":
                fns["parent_walked"] = run(parent, stream=(
                    cseg_ptr, pa, pb, n_live, cc))
                fns["parent_walked_needed"] = run(parent, stream=(
                    nseg_ptr, npa, npb, n_live, cc))
            fns["bmm"] = bmm_graph_fn(a, b, pa[:st["pairs"]],
                                      pb[:st["pairs"]], p)
            slabs = int(torch.bitwise_and(
                need[live].unsqueeze(1) >> torch.arange(4, device=dev),
                1).sum())
            emit("k4acc_ring", dtype=str(dtype)[6:], precision=p,
                 rank=st["rank"], stage=st["stage"], pairs=st["pairs"],
                 tiles_with_pairs=st["tiles"], tiles_visited=int(walk[0]),
                 c_cap=c_cap, slabs_run=slabs, slabs=4 * st["pairs"],
                 pairs_running_a_slab=n_needed,
                 ms=graph_ms(fns, n, rounds), bit_equal_to_parent=True,
                 timed="graph replay of n launches, in turns; "
                       "parent_walked and parent_walked_needed: the parent "
                       "on cut streams (the walk, the pairs that run no "
                       "slab), timed only")
        del st, a, b, prior, c, cc, tables, masks, scratch
        torch.cuda.empty_cache()


def case_k4f64(base):
    """The float64 pair-stream entry at wandering64-1M's stream (its fresh
    form)."""
    base_lib, base_kind = base
    libs = {"current": mk._library()}
    libs.update({name: build("macro_accumulate", name, mk.SOURCE,
                             mk._declare, cuts=cuts)
                 for name, cuts in F64_CUTS.items()})
    if base_lib is not None:
        libs["baseline"] = base_lib
    stream = torch.cuda.current_stream().cuda_stream
    a = coo_to_macro(STREAMS["wandering64-1M"](), dtype=torch.float64)
    n_pairs, n_tiles, a_idx, b_idx, seg = pair_stream(a)
    c_cap = -(-n_tiles // 256) * 256
    seg_ptr = mk.segment_offsets(seg, c_cap)
    want = M.accumulate_macro(a.dense, a.dense, a_idx, b_idx, seg, c_cap,
                              256, torch.float64)
    mag = M.accumulate_macro(a.dense.abs(), a.dense.abs(), a_idx, b_idx,
                             seg, c_cap, 256, torch.float64)[0]
    num = torch.empty((c_cap, 128, 128), dtype=torch.float64, device="cuda")
    flag = torch.empty((c_cap, 128, 128), dtype=torch.uint8, device="cuda")
    ptrs = (a.dense.data_ptr(), a.dense.data_ptr(), a_idx.data_ptr(),
            b_idx.data_ptr(), seg_ptr.data_ptr(), num.data_ptr(),
            flag.data_ptr(), c_cap)
    n_t = a.dense.shape[0]
    masks = torch.empty((n_t, mk.F64_MASK_WORDS), dtype=torch.int32,
                        device="cuda")
    need = torch.empty(a_idx.numel(), dtype=torch.uint8, device="cuda")

    def launch(lib, k):
        kind = base_kind if k == "baseline" else "current"
        ready = (0, 0) if kind == "current" else ()
        fresh = (0, None) if kind == "current" else (0,) if kind == "v18" \
            else ()
        return lambda: checked(lib.macro_accumulate_pairs_f64(
            *ptrs, n_t, n_t, a_idx.numel(), masks.data_ptr(),
            masks.data_ptr(), *ready, need.data_ptr(), *fresh, stream), k)

    fns = {k: launch(lib, k) for k, lib in libs.items()}
    over = {}
    for k, fn in fns.items():
        num.fill_(float("nan"))
        flag.fill_(7)
        fn()
        torch.cuda.synchronize()
        if k != "no_pattern":           # its flags are wrong: timed only
            over[k] = hold_f64((num, flag), want, mag, f"K4-f64 {k}")
    del want, mag
    torch.cuda.empty_cache()
    emit("k4f64", matrix="wandering64-1M", pairs=n_pairs, c_tiles=n_tiles,
         c_cap=c_cap, ms=in_turns(fns, 5), worst_over_bound=over,
         bound_ms=2 * 128 ** 3 * n_pairs / 67e12 * 1e3,
         bound="2 * 128^3 operations a pair at FP64 67 TFLOP/s (DMMA)")


def case_k2f64(base):
    """The float64 dense entry at banded64-1M in this build, the DENSE64
    geometries and the baseline (``base``: (library, interface) or None;
    each at its own launch rule), each bit for bit against the plain
    version; then the float32 dense entry against the baseline's at the
    three stencils, bit for bit, in turns."""
    stream = torch.cuda.current_stream().cuda_stream
    base_lib, base_kind = base if base is not None else (None, None)
    build_all("dia_multiply", dk.SOURCE, dk._declare, {"current": ()})
    builds = {"current": (dk._library(), None)}
    for name, (rows, i, threads, blocks) in DENSE64.items():
        builds[name] = (build("dia_multiply", name, dk.SOURCE, dk._declare,
                              cuts=dense64_cut(rows, i, threads, blocks)),
                        dict(rows=rows, cols=i, threads=threads,
                             blocks=blocks))
    builds["count_select"] = (build("dia_multiply", "count_select",
                                    dk.SOURCE, dk._declare,
                                    cuts=DENSE_COUNT_SELECT), None)
    half = STENCILS["banded64-1M"]
    offs = tuple(range(-half, half))
    a = D.coo_to_dia(banded_device(n=1_000_000, seed=1, bands=offs),
                     dtype=torch.float64).bands
    dc_list, idx_map = D._plan_maps(offs, offs)
    dcn, n = len(dc_list), a.shape[1]
    offs_dev = torch.tensor(offs, dtype=torch.int32, device="cuda")
    runs = dict(builds)
    if base_lib is not None:
        runs["baseline"] = (base_lib, None)
    for values_only in (False, True):
        want = D._dia_multiply_torch(a, a, offs_a=offs, idx_map=idx_map,
                                     dc_count=dcn, n_out=n,
                                     values_only=values_only)
        fns, equal, shapes, outs = {}, {}, {}, {}
        for name, (lib, g) in runs.items():
            c = torch.full((dcn, n), float("nan"), dtype=torch.float64,
                           device="cuda")
            cnt = None if values_only else torch.empty(
                (dcn, n), device="cuda")
            outs[name] = (c, cnt)       # alive while fns[name] is
            fns[name], shapes[name] = dense_launcher(
                lib, 8, base_kind if name == "baseline" else "current", a,
                offs, offs_dev, c, cnt, stream, g)
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            c, cnt = outs[name]
            equal[name] = torch.equal(c, want[0]) and (
                values_only or torch.equal(cnt, want[1]))
        del want, c, cnt
        torch.cuda.empty_cache()
        if not all(equal.values()):
            raise AssertionError(f"K2-f64: not bit-equal to the plain "
                                 f"version: {equal}")
        emit("k2f64", matrix="banded64-1M", values_only=values_only,
             shape=[len(offs), n], c_rows=dcn,
             launch={k: {x: v.get(x) for x in ("rows", "cols", "threads",
                                              "kc", "chunks", "smem_bytes",
                                              "L", "strip", "grid_x",
                                              "grid_y")}
                     for k, v in shapes.items()},
             ms=in_turns(fns, 5, rounds=4), bit_equal_to_plain=equal)
        del fns, outs
        torch.cuda.empty_cache()
    del a
    torch.cuda.empty_cache()
    if base_lib is None:
        return
    # the float32 dense entry: this build's, the DENSE32 builds and the
    # baseline's
    libs = {"current": (dk._library(), "current", None),
            "baseline": (base_lib, base_kind, None)}
    for name, geo in DENSE32.items():
        if isinstance(geo, list):   # the current geometry, other cuts
            libs[name] = (build("dia_multiply", name, dk.SOURCE,
                                dk._declare, cuts=geo), "current", None)
            continue
        rows, i, threads, blocks = geo
        libs[name] = (build("dia_multiply", name, dk.SOURCE, dk._declare,
                            cuts=dense64_cut(rows, i, threads, blocks, 4)),
                      "current", dict(rows=rows, cols=i, threads=threads,
                                      blocks=blocks))
    for name, half in STENCILS.items():
        offs = tuple(range(-half, half))
        a = D.coo_to_dia(banded_device(n=1_000_000, seed=1,
                                       bands=offs)).bands
        dc_list, _ = D._plan_maps(offs, offs)
        dcn, n = len(dc_list), a.shape[1]
        offs_dev = torch.tensor(offs, dtype=torch.int32, device="cuda")
        for values_only in (False, True):
            outs, fns = {}, {}
            for k, (lib, kind, g) in libs.items():
                outs[k] = (torch.empty((dcn, n), device="cuda"),
                           None if values_only else torch.empty(
                               (dcn, n), device="cuda"))
                fns[k], _sh = dense_launcher(lib, 4, kind, a, offs,
                                             offs_dev, *outs[k], stream, g)
                fns[k]()
            torch.cuda.synchronize()
            c1, n1 = outs["baseline"]
            for k, (c0, n0) in outs.items():
                if not (torch.equal(c0.view(torch.int32),
                                    c1.view(torch.int32))
                        and (values_only or torch.equal(n0, n1))):
                    raise AssertionError(f"K2 at {name}: build {k} differs "
                                         "from the baseline's")
            emit("k2", matrix=name, values_only=values_only,
                 ms=in_turns(fns, 10, rounds=4), bit_equal_to_baseline=True)
            del fns, outs, c0, n0, c1, n1
        del a
        torch.cuda.empty_cache()


def case_library():
    """torch.sparse.mm(A, A) in CSR at the banded DIA matrices: its time, or
    the error cuSPARSE raises (a yardstick the port never calls)."""
    for name, half in (("banded16-1M", 8), ("banded64-1M", 32),
                       ("banded128-1M", 64)):
        coo = banded_device(n=1_000_000, seed=1, bands=tuple(range(-half,
                                                                   half)))
        n = coo.shape[0]
        m = torch.sparse_coo_tensor(
            torch.stack([coo.rows.long(), coo.cols.long()]), coo.vals,
            (n, n)).coalesce().to_sparse_csr()
        del coo
        try:
            emit("library", matrix=name,
                 sparse_mm_ms=time_ms(lambda: torch.sparse.mm(m, m), 3))
        except RuntimeError as e:           # cuSPARSE refuses: recorded
            emit("library", matrix=name, error=str(e).splitlines()[0])
        del m
        torch.cuda.empty_cache()


# The Tile16 kernel (csrc/tile16_accumulate.cu) against another version of
# its source: the C interface of commit 33b3b17 (one warp a C tile, FP32
# FMA, the pattern from two more tables at "high" / "default"), whose cut
# builds split its time.
TILE16_PARENT_ARGS = 16                 # its entries' argument count
# Cut builds of that version's source, as CUTS: timed only (their results
# are wrong), on the masks form at "highest".  "products_only" keeps the
# loads and the products, "pattern_only" the loads and the k-mask counts,
# "loads_only" the loads and the staging into shared memory alone.
_PARENT_PATTERN = ("            if constexpr (PAT) {\n"
                   "                uint32_t m = 0;\n")
_PARENT_PRODUCTS = "            for (int kq = 0; kq < 16; kq += 4) {\n"
TILE16_PARENT_CUTS = {
    "products_only": [(_PARENT_PATTERN, "            if constexpr (false) {\n"
                       "                uint32_t m = 0;\n")],
    "pattern_only": [(_PARENT_PRODUCTS,
                      "            for (int kq = 0; kq < 0; kq += 4) {\n")],
    "loads_only": [(_PARENT_PATTERN, "            if constexpr (false) {\n"
                    "                uint32_t m = 0;\n"),
                   (_PARENT_PRODUCTS,
                    "            for (int kq = 0; kq < 0; kq += 4) {\n")],
}


# Other builds of this version (held like it: masks equal to the parent's,
# values within twice the bound), timed beside it: other depths of the
# walk's ring of register buffers.
TILE16_CUTS = {
    **{f"ahead{n}": [("constexpr int AHEAD = 1;",
                      f"constexpr int AHEAD = {n};")] for n in (2, 3)},
    # registers capped for 5 or 6 blocks an SM (20 or 24 warps)
    **{f"blocks{n}": [("__global__ void __launch_bounds__(WARPS * 32)\n",
                       f"__global__ void __launch_bounds__(WARPS * 32, {n})"
                       "\n")] for n in (5, 6)},
    # the fresh forms' grids capped as the accumulate form's
    "fresh_capped": [("    if constexpr (F == Form::ACC) {\n"
                      "        const long long cap",
                      "    if constexpr (true) {\n"
                      "        const long long cap")],
    # every stream walked in spans of 64 pairs
    "span64": [("constexpr long long MIN_WARPS = 8192;",
                "constexpr long long MIN_WARPS = 0;"),
               ("    int span = F == Form::ACC ? SPAN_MIN : SPAN_MAX;",
                "    int span = SPAN_MAX;")],
    # B's fragments through L1 too
    "b_through_l1": [("    return __ldcg(reinterpret_cast<const W*>(p));",
                      "    return __ldg(reinterpret_cast<const W*>(p));")],
    # C stored as any other data (not evict-first)
    "plain_store": [("    __stcs(reinterpret_cast<float4*>(p), "
                     "make_float4(v[0], v[1], v[2], v[3]));",
                     "    *reinterpret_cast<float4*>(p) = "
                     "make_float4(v[0], v[1], v[2], v[3]);")],
}


# Cut builds of this version, as CUTS: timed only, to see where a pair's
# time goes.  "loads_only": the walk loads each pair's fragments and folds
# their words into one sum (no products, no pattern, no mark);
# "no_pattern": no structural pass; "one_pass": "highest" without the
# split (one tf32 product a block).
_T16_ANCHOR = ("// A warp's walk over its pairs: the index batches (the "
               "pairs [base,\n")
_T16_FOLD = """__device__ __forceinline__ unsigned fold(const Raw<float>& r) {
    unsigned x = 0u;
    for (int i = 0; i < 2; ++i) x ^= r.a[i].x ^ r.a[i].y ^ r.a[i].z ^ r.a[i].w;
    for (int i = 0; i < 4; ++i) x ^= r.b[i].x ^ r.b[i].y;
    return x;
}
__device__ __forceinline__ unsigned fold(const Raw<Bf16>& r) {
    unsigned x = 0u;
    for (int i = 0; i < 2; ++i) x ^= r.a[i].x ^ r.a[i].y;
    for (int i = 0; i < 4; ++i) x ^= r.b[i];
    return x;
}
__device__ __forceinline__ unsigned fold(const Raw<double>& r) {
    unsigned x = 0u;
    for (int i = 0; i < 4; ++i)
        x ^= r.a[i].x ^ r.a[i].y ^ r.a[i].z ^ r.a[i].w
           ^ r.b[i].x ^ r.b[i].y ^ r.b[i].z ^ r.b[i].w;
    return x;
}
"""
TILE16_SPLIT_CUTS = {
    "loads_only": [
        (_T16_ANCHOR, _T16_FOLD + _T16_ANCHOR),
        ("        product<T, P, PAT>(buf[J], a_val + (size_t)buf_a[J] * 256,\n"
         "                           b_val + (size_t)buf_b[J] * 256, g, t, "
         "acc, cnt);\n",
         "        acc[0][0] += (S)(fold(buf[J]) & 1u);\n")],
    # loads_only with the float32 B (A) fragments not loaded
    "loads_a_only": [],
    "loads_b_only": [],
    "no_pattern": [
        ("        if constexpr (PAT) pattern(cnt, v);\n"
         "        // the words a mode multiplies",
         "        // the words a mode multiplies"),
        ("        if constexpr (PAT) pattern(cnt, v);\n"
         "        pass<1>(acc, v.a, v.b, v.a, v.b);",
         "        pass<1>(acc, v.a, v.b, v.a, v.b);")],
    "one_pass": [("        constexpr bool SPLIT = P == Prec::HIGHEST && "
                  "sizeof(T) == 4;",
                  "        constexpr bool SPLIT = false;")],
}


TILE16_SPLIT_CUTS["loads_a_only"] = TILE16_SPLIT_CUTS["loads_only"] + [
    ("        r.b[i] = ldb<uint2>(B + (4 * t + i) * 16 + 2 * g);\n",
     "        r.b[i] = make_uint2(0u, (unsigned)i);\n")]
TILE16_SPLIT_CUTS["loads_b_only"] = TILE16_SPLIT_CUTS["loads_only"] + [
    ("        r.a[i] = lda<uint4>(A + (g + 8 * i) * 16 + 4 * t);\n",
     "        r.a[i] = make_uint4(0u, 0u, 0u, (unsigned)i);\n")]


def declare_tile16_parent(lib):
    """The accumulation entries of the parent interface: (a_val, b_val,
    a_pat, b_pat, n_a, n_b, a_idx, b_idx, seg_ptr, c_cap, c_val, c_cnt,
    c_mask, c_nnz, accumulate, stream)."""
    for fn in (lib.tile16_accumulate_pairs_f32,
               lib.tile16_accumulate_pairs_f64):
        fn.argtypes = [VP, VP, VP, VP, CI, CI, VP, VP, VP, CI, VP, VP, VP,
                       VP, CI, VP]
        fn.restype = CI


def tile16_stream(coo, dtype):
    """A @ A's Tile16 pair stream as the fused engine builds it (chip_smoke's
    tile16_stream): (a, b, a_idx, b_idx, c_tile_id, c_cap, n_pairs)."""
    from pem_spgemm_tpu_torch.config import round_up_bucket, round_up_pow2
    from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled
    from pem_spgemm_tpu_torch.ops.scanops import can_pack
    a = coo_to_tiled(coo, dtype=dtype)
    b = coo_to_tiled(coo, dtype=dtype, with_tmasks=True)
    offsets = symbolic.pair_counts(a.tile_col, b.tile_rowptr, a.ntiles)
    n_pairs = int(offsets[-1])
    p_cap = max(SpGEMMConfig().numeric_chunk, round_up_pow2(n_pairs))
    _r, _c, a_idx, b_idx, seg, cnt = symbolic.expand_pairs(
        offsets, a.tile_row, a.tile_col, b.tile_rowptr, b.tile_col, n_pairs,
        p_cap, can_pack(a.n_tile_rows, b.n_tile_cols))
    return a, b, a_idx, b_idx, seg, round_up_bucket(int(cnt)), n_pairs


def tile16_bound(a, b, ai, bi, n_pairs, c_write, c_read, pattern):
    """ms of the bytes bound (each distinct operand tile read once, C tiles
    written / read once, ``pattern`` bytes of structure a written tile) and
    of the FP32 / FP64 operations bound (2 * 16^3 a pair at 67 TFLOP/s),
    at 3.35 TB/s."""
    elem = a.element_size()
    tiles = int(torch.unique(ai[:n_pairs]).numel()
                + torch.unique(bi[:n_pairs]).numel())
    out_elem = 8 if elem == 8 else 4
    nbytes = 256 * (tiles * elem + (c_write + c_read) * out_elem) \
        + c_write * pattern
    return {"bytes_ms": nbytes / 3.35e12 * 1e3,
            "ops_ms": 2 * 16 ** 3 * n_pairs / 67e12 * 1e3}


def bmm16(a, b, ai, bi, per=1 << 20):
    """ms of torch.bmm over the pre-gathered operands in float32 (float64
    for float64 tables), 2^20 pairs at a time: the products alone."""
    dtype = torch.float64 if a.dtype == torch.float64 else torch.float32
    total = 0.0
    for lo in range(0, ai.numel(), per):
        x = a[ai[lo:lo + per].long()].view(-1, 16, 16).to(dtype)
        y = b[bi[lo:lo + per].long()].view(-1, 16, 16).to(dtype)
        total += time_ms(lambda: torch.bmm(x, y), 3)
        del x, y
    return total


def parent_call(lib, a, b, ai, bi, seg, c_cap, c_val, precision="highest",
                c_cnt=None, c_mask=None, c_nnz=None, accumulate=0,
                seg_ptr=None):
    """One call of the parent's wrapper: bfloat16 tables copied to float32,
    float32 tables rounded as ``precision`` says (round_operands) with the
    pattern from the raw ones, the pair offsets, the launch (and with masks
    the nnz scan).  ``seg_ptr`` given: the launch alone, on tables already
    rounded."""
    from pem_spgemm_tpu_torch.ops.cstruct import _exclusive_scan
    if seg_ptr is None:
        if a.dtype == torch.bfloat16:
            a = a.float()
            b = b.float()
            va, vb = a, b
        else:
            va = M.round_operands(a, precision)
            vb = M.round_operands(b, precision)
        seg_ptr = mk.segment_offsets(seg, c_cap)
    else:
        va, vb = a, b
    pa, pb = (a, b) if (c_cnt is not None or c_mask is not None) \
        else (va, vb)
    fn = lib.tile16_accumulate_pairs_f64 if a.dtype == torch.float64 \
        else lib.tile16_accumulate_pairs_f32
    checked(fn(va.data_ptr(), vb.data_ptr(), pa.data_ptr(), pb.data_ptr(),
               va.shape[0], vb.shape[0], ai.data_ptr(), bi.data_ptr(),
               seg_ptr.data_ptr(), c_cap, c_val.data_ptr(),
               None if c_cnt is None else c_cnt.data_ptr(),
               None if c_mask is None else c_mask.data_ptr(),
               None if c_nnz is None else c_nnz.data_ptr(), accumulate,
               torch.cuda.current_stream().cuda_stream), "parent tile16")
    if c_mask is not None:
        return _exclusive_scan(c_nnz)
    return None


def new_kernel(a, b, ai, bi, seg, seg_ptr, c_cap, c_val, precision,
               c_cnt=None, c_mask=None, c_nnz=None, accumulate=0, lib=None):
    """This build's launch alone (the pair offsets made beforehand), or
    that of ``lib``, a build of the same interface."""
    from pem_spgemm_tpu_torch.ops import tile16_kernels as tk
    lib = lib or tk._library()
    fn = lib.tile16_accumulate_pairs_f64 if a.dtype == torch.float64 \
        else lib.tile16_accumulate_pairs_f32
    checked(fn(a.data_ptr(), b.data_ptr(), a.shape[0], b.shape[0],
               int(a.dtype == torch.bfloat16), ai.data_ptr(), bi.data_ptr(),
               seg.data_ptr(), ai.numel(),
               None if accumulate else seg_ptr.data_ptr(), c_cap,
               c_val.data_ptr(), None if c_cnt is None else c_cnt.data_ptr(),
               None if c_mask is None else c_mask.data_ptr(),
               None if c_nnz is None else c_nnz.data_ptr(), accumulate,
               M.precision_code(precision),
               torch.cuda.current_stream().cuda_stream), "tile16")


def graph_ms(fns, n=20, rounds=2):
    """{name: [ms, ...]}: each function launched ``n`` times in one CUDA
    graph, the graphs replayed in turns (the order reversed every other
    round), the device time a launch: launches too short for a host
    clock's loop."""
    graphs = {}
    for k, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()
        graphs[k] = g
    out = {k: [] for k in fns}
    names = list(fns)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            graphs[k].replay()
            start.record()
            for _ in range(3):
                graphs[k].replay()
            stop.record()
            torch.cuda.synchronize()
            out[k].append(start.elapsed_time(stop) / (3 * n))
    return out


def tile16_hold(got, ref, mag, what, f64=False):
    """This build's values against the parent's: both within the
    dot-product bound of the exact sums, so within twice it of each other
    (NaN and Inf where the other has them)."""
    rtol, atol = (1e-12, 1e-300) if f64 else (RTOL, ATOL)
    if not (torch.equal(torch.isnan(got), torch.isnan(ref))
            and torch.equal(torch.isinf(got), torch.isinf(ref))):
        raise AssertionError(f"{what}: NaN / Inf positions differ")
    fin = torch.isfinite(ref)
    over = float((torch.where(fin, (got - ref).abs(), 0)
                  / (2 * (rtol * mag + atol))).max())
    if not over <= 1.0:
        raise AssertionError(f"{what}: values {over}x twice the bound")
    return over


def case_tile16(parent, rounds=3, n=5):
    """The Tile16 kernel at pairbands-500k's stream (3.1 M pairs): every
    form of this build and of the parent (``parent``: its library, the C
    interface of TILE16_PARENT_ARGS arguments), as their wrappers call them
    ("call": the parent's rounding and copy passes, the pair offsets and
    the nnz scan included) and the launch alone ("kernel"), held against
    each other (masks and counts equal, values within twice the float32 /
    float64 bound), timed by CUDA events in turns; the parent's cut builds
    (TILE16_PARENT_CUTS) beside its masks form at "highest", timed only;
    the accumulate form on the 4-rank Tile16 ring's largest accumulating
    stage (into a C of its c_cap tiles).  Each line gives the bytes and
    FP32 / FP64 bounds and torch.bmm's time over the pairs."""
    from pem_spgemm_tpu_torch.ops import numeric as N
    from pem_spgemm_tpu_torch.ops import tile16_kernels as tk
    from pem_spgemm_tpu_torch.parallel import sharded as sh
    from pem_spgemm_tpu_torch.parallel.sharded_macro import replay_chunks
    cuts = {} if parent is None else build_all(
        "tile16_accumulate", parent[1], declare_tile16_parent,
        TILE16_PARENT_CUTS)
    mine = build_all("tile16_accumulate", tk.SOURCE, tk._declare,
                     TILE16_CUTS)
    split = build_all("tile16_accumulate", tk.SOURCE, tk._declare,
                      TILE16_SPLIT_CUTS)
    base = None if parent is None else parent[0]
    coo = STREAMS["pairbands-500k"]()
    chunk = SpGEMMConfig().numeric_chunk
    # the 4-rank Tile16 ring's plans (the ring multiplies float32; the
    # float64 accumulate form runs on float64 copies of a stage's tiles)
    a32, b32 = tile16_stream(coo, torch.float32)[:2]
    plans = [sh.plan_sharded_spgemm(a32, b32, 4, d) for d in range(4)]
    del a32, b32
    for dtype in (torch.float32, torch.float64):
        a, b, ai, bi, seg, c_cap, n_pairs = tile16_stream(coo, dtype)
        af, bf = a.dense_flat(), b.dense_flat()
        dev = af.device
        seg_ptr = mk.segment_offsets(seg, c_cap)
        vals = torch.empty((c_cap, 256), dtype=dtype, device=dev)
        cmask = torch.empty((c_cap, 16), dtype=torch.int32, device=dev)
        nnz = torch.empty((c_cap,), dtype=torch.int32, device=dev)
        cnt = torch.empty((c_cap, 256), dtype=torch.float32, device=dev)
        mag = N.fused_flat_plain(af.abs(), bf.abs(), ai, bi, seg, c_cap,
                                 chunk, dtype)[0]
        lib_ms = bmm16(af, bf, ai[:n_pairs], bi[:n_pairs])
        f64 = dtype == torch.float64
        runs = [("masks", "highest", af, bf)]
        if not f64:
            runs += [("masks", "high", af, bf), ("masks", "default", af, bf),
                     ("masks", "highest", af.bfloat16(), bf.bfloat16()),
                     ("values", "highest", af, bf),
                     ("counts", "highest", af, bf)]
        for form, prec, x, y in runs:
            tables = str(x.dtype)[6:]
            if form == "masks":
                def call(x=x, y=y, prec=prec):
                    return tk.accumulate_fused_masks(x, y, ai, bi, seg,
                                                     c_cap, chunk, dtype,
                                                     prec)
                kw = dict(c_mask=cmask, c_nnz=nnz)
                pattern = 68
            elif form == "counts":
                def call(x=x, y=y, prec=prec):
                    return tk.accumulate_fused_flat(x, y, ai, bi, seg, c_cap,
                                                    chunk, dtype, prec)
                kw = dict(c_cnt=cnt)
                pattern = 1024
            else:
                def call(x=x, y=y, prec=prec):
                    return tk.accumulate_dense(x, y, ai, bi, seg, c_cap,
                                               chunk, dtype, prec)
                kw = {}
                pattern = 0
            fns = {"change_call": call,
                   "change_kernel": lambda x=x, y=y, prec=prec, kw=kw:
                   new_kernel(x, y, ai, bi, seg, seg_ptr, c_cap, vals, prec,
                              **kw)}
            got = call()
            over = None
            if base is not None:
                fns["parent_call"] = lambda x=x, y=y, prec=prec, kw=kw: \
                    parent_call(base, x, y, ai, bi, seg, c_cap, vals, prec,
                                **kw)
                if x.dtype == torch.bfloat16:
                    rx, ry = x.float(), y.float()
                else:
                    rx = M.round_operands(x, prec)
                    ry = M.round_operands(y, prec)
                if form == "values" or prec == "highest":
                    fns["parent_kernel"] = \
                        lambda rx=rx, ry=ry, prec=prec, kw=kw: parent_call(
                            base, rx, ry, ai, bi, seg, c_cap, vals, prec,
                            seg_ptr=seg_ptr, **kw)
                scan = parent_call(base, x, y, ai, bi, seg, c_cap, vals,
                                   prec, **kw)
                ref = vals.clone()
                what = f"tile16 {tables} {form} {prec}"
                if form == "masks":
                    if not (torch.equal(got[1], cmask)
                            and torch.equal(got[2], scan)):
                        raise AssertionError(f"{what}: masks differ")
                elif form == "counts" and not torch.equal(got[1], cnt):
                    raise AssertionError(f"{what}: counts differ")
                got_v = got if form == "values" else got[0]
                over = tile16_hold(got_v.reshape(c_cap, 256), ref, mag, what,
                                   f64)
                del rx, ry
                if prec == "highest" and x.dtype == dtype \
                        and form in ("masks", "values"):
                    for k, lib in mine.items():
                        fns[k] = lambda lib=lib, x=x, y=y, kw=kw: \
                            new_kernel(x, y, ai, bi, seg, seg_ptr, c_cap,
                                       vals, prec, lib=lib, **kw)
                        fns[k]()
                        if form == "masks" and not torch.equal(
                                cmask, got[1]):
                            raise AssertionError(f"{what} {k}: masks")
                        tile16_hold(vals, ref, mag, f"{what} {k}", f64)
                if form == "masks" and prec == "highest" \
                        and x.dtype == dtype:
                    for k, lib in split.items():
                        if not (f64 and k == "one_pass"):
                            fns[k] = lambda lib=lib, x=x, y=y, kw=kw: \
                                new_kernel(x, y, ai, bi, seg, seg_ptr, c_cap,
                                           vals, prec, lib=lib, **kw)
                if form == "masks" and prec == "highest" \
                        and x.dtype == torch.float32:
                    for k, lib in cuts.items():
                        fns[f"parent_{k}"] = lambda lib=lib, kw=kw: \
                            parent_call(lib, x, y, ai, bi, seg, c_cap, vals,
                                        prec, seg_ptr=seg_ptr, **kw)
            del got
            ref = None
            torch.cuda.synchronize()
            times = in_turns(fns, n, rounds)
            emit("tile16", matrix="pairbands-500k", form=form,
                 precision=prec, tables=tables, pairs=n_pairs,
                 p_cap=int(ai.numel()), c_cap=c_cap, ms=times,
                 worst_over_twice_the_bound=over, bmm_ms=lib_ms,
                 **tile16_bound(x, y, ai, bi, n_pairs, c_cap, 0, pattern))
        # the accumulate form on the 4-rank ring's largest accumulating
        # stage
        best = None
        for d, p in enumerate(plans):
            live = [s for s, x in enumerate(p.stage_pairs) if x]
            for s in live[1:]:
                if best is None or p.stage_pairs[s] > \
                        plans[best[0]].stage_pairs[best[1]]:
                    best = (d, s)
        d, s = best
        p = plans[d]
        chunk_b = list(replay_chunks(plans, d))[s].to(dtype)
        a_st = p.a_dense.to(dtype)
        pa, pb, pseg = p.pairs_a[s], p.pairs_b[s], p.seg[s]
        st_pairs = int(p.stage_pairs[s])
        tiles = int(torch.unique(pseg[:st_pairs]).numel())
        c0 = torch.randn((p.c_cap, 16, 16), device=dev, dtype=dtype)
        c_new, c_old = c0.clone(), c0.clone()
        tk.accumulate_dense(a_st, chunk_b, pa, pb, pseg, p.c_cap,
                            p.pairs_a.shape[1], dtype, out=c_new)
        fns = {"change_call": lambda: tk.accumulate_dense(
            a_st, chunk_b, pa, pb, pseg, p.c_cap, p.pairs_a.shape[1],
            dtype, out=c_new)}
        over = None
        if base is not None:
            parent_call(base, a_st, chunk_b, pa, pb, pseg, p.c_cap,
                        c_old, accumulate=1)
            amag = c0.abs() + N.dense_plain(
                a_st.abs(), chunk_b.abs(), pa, pb, pseg, p.c_cap,
                p.pairs_a.shape[1], dtype)
            over = tile16_hold(c_new.view(-1, 256), c_old.view(-1, 256),
                               amag.view(-1, 256), f"tile16 acc {dtype}",
                               f64)
            fns["parent_call"] = lambda: parent_call(
                base, a_st, chunk_b, pa, pb, pseg, p.c_cap, c_old,
                accumulate=1)
            del amag
        times = in_turns(fns, n, rounds)
        # the launches alone, by graph replay (a wrapper's host work
        # outlasts them)
        kernels = {"change_kernel": lambda: new_kernel(
            a_st, chunk_b, pa, pb, pseg, None, p.c_cap, c_new,
            "highest", accumulate=1)}
        if base is not None:
            pseg_ptr = mk.segment_offsets(pseg, p.c_cap)
            kernels["parent_kernel"] = lambda: parent_call(
                base, a_st, chunk_b, pa, pb, pseg, p.c_cap, c_old,
                accumulate=1, seg_ptr=pseg_ptr)
        for k in ("span64", "ahead2"):
            kernels[k] = lambda lib=mine[k]: new_kernel(
                a_st, chunk_b, pa, pb, pseg, None, p.c_cap, c_new,
                "highest", accumulate=1, lib=lib)
        times.update(graph_ms(kernels, 20, rounds))
        emit("tile16", matrix="pairbands-500k", form="accumulate",
             precision="highest", tables=str(dtype)[6:],
             ring="4 ranks", rank=d, stage=s, pairs=st_pairs,
             tiles_with_pairs=tiles, c_cap=p.c_cap, ms=times,
             worst_over_twice_the_bound=over,
             bmm_ms=bmm16(a_st, chunk_b, pa[:st_pairs], pb[:st_pairs]),
             **tile16_bound(a_st, chunk_b, pa, pb, st_pairs, tiles,
                            tiles, 0))
        del a, b, af, bf, ai, bi, seg, seg_ptr, vals, cmask, nnz, cnt, mag
        del p, chunk_b, a_st, c0, c_new, c_old
        torch.cuda.empty_cache()


# Cut builds of the baseline's csrc/tile16_structure.cu (commit f8f1c89: a
# half-warp a tile, lane r enumerating row r's bits by __ffs), as CUTS:
# timed only, at pairbands-500k's stream.  "rowcol_stores": the tiles'
# rowcol words alone (the tile ids cut; called without values);
# "padding_only": the tiles' slots cut, the padding loop alone.
ROWCOL_PARENT_CUTS = {
    "rowcol_stores": [("                elem_tile[slot] = c;\n", "")],
    "padding_only": [("    if (c < c_cap) {                                "
                      "// half-warp-uniform\n        const unsigned hm = "
                      "half_mask();\n        uint32_t m =",
                      "    if (false) {\n        const unsigned hm = "
                      "half_mask();\n        uint32_t m =")],
}


# Other builds of this version's tile16_c_rowcol, held bit for bit like it
# and timed beside it: other spans (C tiles a block) and other counts of
# slots a thread has in flight.
ROWCOL_CUTS = {
    **{f"span{k}": [("constexpr int SPAN = 64;", f"constexpr int SPAN = {k};")]
       for k in (32, 128)},
    **{f"ahead{k}": [("constexpr int AHEAD = 4;",
                      f"constexpr int AHEAD = {k};")] for k in (1, 2, 8)}}


def case_c_rowcol(base_source, rounds=3, n=20):
    """tile16_c_rowcol at pairbands-500k's interactive stream (the fused
    engine's: c_cap 1,048,576): this build's and the baseline's
    (``base_source``), each with float32 values (the steady step's call)
    and without (the interactive step's, the ring planner's), held bit for
    bit to the plain version (c_rowcol_plain, extract_values: three arrays,
    padding slots included), timed by CUDA-graph replay in turns beside
    this version's ROWCOL_CUTS builds (held too), the baseline's
    ROWCOL_PARENT_CUTS builds (timed only) and the value gather flat[pos]
    (a yardstick)."""
    from pem_spgemm_tpu_torch.config import round_up_bucket
    from pem_spgemm_tpu_torch.ops import cstruct
    from pem_spgemm_tpu_torch.ops import numeric as N
    from pem_spgemm_tpu_torch.ops import tile16_kernels as tk
    coo = STREAMS["pairbands-500k"]()
    a, b, ai, bi, seg, c_cap, n_pairs = tile16_stream(coo, torch.float32)
    del coo
    cmask, cptr, _pp = tk.c_masks(a.masks, b.tmasks, ai, bi, seg, c_cap)
    del a, b, ai, bi, seg, _pp
    c_nnz = int(cptr[-1])
    cap = round_up_bucket(c_nnz)
    g = torch.Generator(device="cuda").manual_seed(3)
    dense = torch.randn((c_cap, 256), generator=g, device="cuda")
    dense[-1, 240] = -0.0                   # the padding slots' entry
    want = cstruct.c_rowcol_plain(cmask, cptr, cap)
    want_v = N.extract_values(dense, *want)
    outs = [torch.empty(cap, dtype=torch.int32, device="cuda")
            for _ in range(2)] + [torch.empty(cap, device="cuda")]

    def call(lib, values):
        return lambda: checked(lib.tile16_c_rowcol(
            cmask.data_ptr(), cptr.data_ptr(), c_cap, cap,
            dense.data_ptr() if values else None, 4 if values else 0,
            outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if values else None,
            torch.cuda.current_stream().cuda_stream), "c_rowcol")

    libs = {"this": tk._structure_library()}
    libs.update({f"this_{k}": v for k, v in build_all(
        "tile16_structure", tk.STRUCT_SOURCE, tk._declare_structure,
        ROWCOL_CUTS).items()})
    if base_source is not None:
        libs.update({f"baseline_{k}" if k != "whole" else "baseline": v
                     for k, v in build_all(
                         "tile16_structure_baseline", base_source,
                         tk._declare_structure,
                         {"whole": (), **ROWCOL_PARENT_CUTS}).items()})
    for k in libs:
        if k.startswith("baseline_"):
            continue
        for values in (False, True):
            for x in outs:
                x.fill_(-1)
            call(libs[k], values)()
            torch.cuda.synchronize()
            ok = torch.equal(outs[0], want[0]) and torch.equal(outs[1],
                                                               want[1])
            if values:
                ok = ok and torch.equal(outs[2].view(torch.int32),
                                        want_v.view(torch.int32))
            if not ok:
                raise AssertionError(f"c_rowcol: {k} (values {values}) is "
                                     "not bit for bit the plain version")
    fns = {}
    for k, lib in libs.items():
        if not k.startswith("baseline_"):
            fns[f"{k}_values"] = call(lib, True)
        fns[k] = call(lib, False)
    pos = want[1].long() * 256 + want[0].long()
    flat = dense.reshape(-1)
    fns["gather_flat_pos"] = lambda: flat[pos]
    emit("c_rowcol", matrix="pairbands-500k", c_cap=c_cap, c_nnz=c_nnz,
         c_nnz_cap=cap, pairs=n_pairs, ms=graph_ms(fns, n, rounds),
         bound_ms=(68 * c_cap + 4 + 4 * c_nnz + 12 * cap) / 3.35e12 * 1e3,
         bound_ms_without_values=(68 * c_cap + 4 + 8 * cap) / 3.35e12 * 1e3,
         held="this, its ROWCOL_CUTS builds and the baseline, with and "
              "without values: bit for bit c_rowcol_plain / extract_values",
         timed="graph replay of n launches, in turns; keys without "
               "'_values' are called without values; baseline_* are the "
               "baseline's cut builds, timed only")
    del cmask, cptr, dense, outs, want, want_v, pos
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-macro", default=None)
    ap.add_argument("--baseline-dia", default=None)
    ap.add_argument("--baseline-tile16", default=None)
    ap.add_argument("--baseline-structure", default=None)
    ap.add_argument("--only", choices=["k4", "k5", "k3", "k3f64", "k4f64",
                                       "k2f64", "library", "k4acc",
                                       "tile16", "c_rowcol"],
                    action="append",
                    help="run this case (repeatable; default: every case)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_split: no CUDA device", file=sys.stderr)
        return 1
    M.require_full_fp32()
    emit("tools", ncu=shutil.which("ncu"),
         device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi())
    base_macro, base_dia = (None, None), None
    if args.baseline_macro:
        kind = macro_interface(args.baseline_macro)
        base_macro = (build("macro_accumulate", "baseline",
                            args.baseline_macro, declare_macro(kind)), kind)
    if args.baseline_dia:
        kind = dia_interface(args.baseline_dia)
        base_dia = (build("dia_multiply", "baseline", args.baseline_dia,
                          declare_baseline_dia(kind)), kind)
    if args.only is None or "k4" in args.only:
        case_k4(base_macro, {"wandering64-1M": 10, "pairbands-500k": 5})
    if args.only is None or "k5" in args.only:
        case_k5(base_macro)
    if args.only is None or "k3" in args.only:
        case_pairs(4, base_dia)
    if args.only is None or "k3f64" in args.only:
        case_pairs(8, base_dia)
    if args.only is None or "k4f64" in args.only:
        case_k4f64(base_macro)
    if args.only is None or "k4acc" in args.only:
        case_k4acc(base_macro, args.baseline_macro)
    if args.only is None or "k2f64" in args.only:
        case_k2f64(base_dia)
    if args.only is None or "library" in args.only:
        case_library()
    if args.only is None or "tile16" in args.only:
        parent = None
        if args.baseline_tile16:
            parent = (build("tile16_accumulate", "baseline",
                            args.baseline_tile16, declare_tile16_parent),
                      args.baseline_tile16)
        case_tile16(parent)
        from pem_spgemm_tpu_torch.ops import tile16_kernels as tk
        build_all("tile16_accumulate", tk.SOURCE, tk._declare,
                  {"current": ()})
    if args.only is None or "c_rowcol" in args.only:
        case_c_rowcol(args.baseline_structure)
    # this build's registers and spills too (the package's own build keeps
    # no compiler log)
    build_all("macro_accumulate", mk.SOURCE, mk._declare, {"current": ()})
    emit("ptxas", builds=PTXAS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
