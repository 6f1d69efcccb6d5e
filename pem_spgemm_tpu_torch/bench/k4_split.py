"""K4's time split, and K3 / K4 / K5 against another version of their sources.

    python -m pem_spgemm_tpu_torch.bench.k4_split [--baseline-macro FILE]
        [--baseline-dia FILE] [--only k4|k5|k3|library]

Builds csrc/macro_accumulate.cu and csrc/dia_multiply.cu as they are and,
with --baseline-macro / --baseline-dia, another version of each (for example
the parent commit's, ``git show <commit>:pem_spgemm_tpu_torch/csrc/<file>``)
as copies in the package's build directory, so that two versions run in one
process, on one card, on the same inputs.  A baseline has the C interfaces
of the version before the persistent pair-stream entry: no grid argument for
``macro_accumulate_pairs_f32``, no launch shape for ``dia_multiply_pairs_f32``.

  k4  the pair-stream entry at wandering64-1M's stream (70,308 pairs) and at
      pairbands-500k's (389,700 pairs): as it is (persistent, one block an
      SM), built as ONE_TILE (one block a C tile: the tensor-core tile
      product without the persistent stream), and the baseline's; each
      held against the plain version (flags equal, values within
      1e-5 * sum|a*b| + 1e-6), then timed by CUDA events in turns, beside
      the CUTS builds (one piece of a stage cut out each; timed only);
  k5  the ragged class entry over wandering64-1M's class launches (one
      steady multiply's): this build's and the baseline's, their slabs
      bit for bit equal, and the no_mark cut, timed in turns;
  k3  the DIA pairs entry at pairbands-500k, with counts and values only:
      this build's and the baseline's, bit for bit equal, timed in turns;
  library  torch.sparse.mm(A, A) in CSR at banded16-1M, banded64-1M and
      banded128-1M: its time, or the error cuSPARSE raises.

Prints one JSON line a case, and whether ``ncu`` is on the machine.  Needs a
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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
from pem_spgemm_tpu_torch.ops.convert import coo_to_macro
from pem_spgemm_tpu_torch.ops.fixed import StencilMacroPlan, make_plan
from pem_spgemm_tpu_torch.ops.spgemm import SpGEMM

PAIRBANDS = (0, 1, 600, 601, -600, -601, 1200, 1201, -1200, -1201)
STREAMS = {             # chip_smoke.py's macro matrices that give K4 a stream
    "wandering64-1M": lambda: wandering_device(n=999_936, seed=4),
    "pairbands-500k": lambda: banded_device(n=500_000, seed=9,
                                            bands=PAIRBANDS),
}
RTOL, ATOL = 1e-5, 1e-6
VP, LL, CI = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# Cut builds of csrc/macro_accumulate.cu: (text of the source, what replaces
# it), each text found once (a CPU test holds that).  Their results are
# wrong; they are timed only, to see what each piece of a stage costs.
_SPLIT_A = ("            hi[e] = tf32_rna(v[e]);\n"
            "            lo[e] = tf32_rna(v[e] - __uint_as_float(hi[e]));\n")
_SPLIT_B = ("            const unsigned hi = tf32_rna(v[c]);\n"
            "            const unsigned lo = tf32_rna(v[c] - "
            "__uint_as_float(hi));\n")
_RUN = "    const bool run = !bad && (ag & bg & ANY_NZ) != 0u;\n"
CUTS = {
    # the tf32 split of each word (the words are stored raw)
    "no_split": [(_SPLIT_A, "            hi[e] = __float_as_uint(v[e]);\n"
                            "            lo[e] = 0u;\n"),
                 (_SPLIT_B, "            const unsigned hi = "
                            "__float_as_uint(v[c]);\n"
                            "            const unsigned lo = 0u;\n")],
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
# The same entry with one block a C tile (grid = c_cap, each block the class
# entries' one-tile product of its tile): the tensor-core tile product
# without the persistent stream.  Its result is held like the entry's.
ONE_TILE = [
    ("    pair_stream(a_dense, b_dense, PairWalk{seg_ptr, a_idx, b_idx, next, "
     "c_cap},\n                c_num, c_flag, tc_shared());\n",
     "    const long long c = blockIdx.x;\n"
     "    const int lo = seg_ptr[c];\n"
     "    tile_product_tc(a_dense, b_dense, a_idx + lo, b_idx + lo, 0, 0,\n"
     "                    seg_ptr[c + 1] - lo, c_num + c * TILE_ELEMS,\n"
     "                    c_flag + c * TILE_ELEMS, tc_shared());\n"),
    ("    macro_pairs_kernel<<<grid < c_cap ? grid : c_cap,",
     "    macro_pairs_kernel<<<c_cap,"),
]


def emit(case, **kw):
    print(json.dumps({"case": case, **kw}), flush=True)


def build(stem: str, name: str, source: str, declare, cuts=()):
    """The library of ``source`` with the text substitutions ``cuts`` made,
    compiled as build/<stem>_<name>.cu (the build's text is hashed)."""
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
    so = _build.compile_shared([_build.find_nvcc(), *_build.NVCC_FLAGS], src)
    return _build.load(so, declare)


def declare_baseline_macro(lib):
    lib.macro_accumulate_pairs_f32.argtypes = [VP] * 7 + [CI, VP]
    lib.macro_class_ragged_f32.argtypes = [VP] * 6 + [CI, CI, LL, VP, VP, VP]
    for fn in (lib.macro_accumulate_pairs_f32, lib.macro_class_ragged_f32):
        fn.restype = CI


def declare_baseline_dia(lib):
    lib.dia_multiply_pairs_f32.argtypes = [VP] * 6 + [CI, LL, LL, LL, VP]
    lib.dia_multiply_pairs_f32.restype = CI


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


def case_k4(base_lib, n_time):
    cur = mk._library()
    cut_libs = {"one_tile_a_block": build(
        "macro_accumulate", "one_tile", mk.SOURCE, mk._declare,
        cuts=ONE_TILE)}
    cut_libs.update({name: build("macro_accumulate", name, mk.SOURCE,
                                 mk._declare, cuts=cuts)
                     for name, cuts in CUTS.items()})
    stream = torch.cuda.current_stream().cuda_stream
    sms = mk.persistent_grid(torch.device("cuda"))
    for name, make in STREAMS.items():
        a = coo_to_macro(make())
        n_pairs, n_tiles, a_idx, b_idx, seg = pair_stream(a)
        c_cap = -(-n_tiles // 256) * 256
        seg_ptr = mk.segment_offsets(seg, c_cap)
        want = M.accumulate_macro(a.dense, a.dense, a_idx, b_idx, seg, c_cap,
                                  256)
        mag = M.accumulate_macro(a.dense.abs(), a.dense.abs(), a_idx, b_idx,
                                 seg, c_cap, 256)[0]
        num = torch.empty((c_cap, 128, 128), device="cuda")
        flag = torch.empty((c_cap, 128, 128), dtype=torch.uint8,
                           device="cuda")
        next_tile = torch.zeros(1, dtype=torch.int32, device="cuda")
        ptrs = (a.dense.data_ptr(), a.dense.data_ptr(), a_idx.data_ptr(),
                b_idx.data_ptr(), seg_ptr.data_ptr(), num.data_ptr(),
                flag.data_ptr(), c_cap)

        def persistent():
            next_tile.zero_()
            checked(cur.macro_accumulate_pairs_f32(
                *ptrs, sms, next_tile.data_ptr(), stream), "current")

        fns = {"persistent": persistent}
        for cut, lib in cut_libs.items():
            fns[cut] = (lambda lib: lambda: (next_tile.zero_(), checked(
                lib.macro_accumulate_pairs_f32(
                    *ptrs, sms, next_tile.data_ptr(), stream), cut)))(lib)
        if base_lib is not None:
            fns["baseline"] = lambda: checked(
                base_lib.macro_accumulate_pairs_f32(*ptrs, stream),
                "baseline")
        over = {}
        for k, fn in fns.items():
            num.fill_(float("nan"))
            flag.fill_(7)
            fn()
            torch.cuda.synchronize()
            if k not in CUTS:               # a cut build's result is wrong
                over[k] = hold((num, flag), want, mag, f"{name} {k}")
        del want, mag
        torch.cuda.empty_cache()
        times = in_turns(fns, n_time[name])
        emit("k4", matrix=name, pairs=n_pairs, c_tiles=n_tiles, c_cap=c_cap,
             grid=sms, ms=times, worst_over_bound=over,
             pairs_a_tile=n_pairs / n_tiles)
        del a, a_idx, b_idx, seg, seg_ptr, num, flag, next_tile
        torch.cuda.empty_cache()


def case_k5(base_lib):
    cur = mk._library()
    no_mark = build("macro_accumulate", "no_mark", mk.SOURCE, mk._declare,
                    cuts=CUTS["no_mark"])
    stream = torch.cuda.current_stream().cuda_stream
    cfg = SpGEMMConfig(engine="macro")
    a = coo_to_macro(STREAMS["wandering64-1M"]())
    plan = make_plan(SpGEMM(cfg)(a, a), cfg, a, a)
    if not isinstance(plan, StencilMacroPlan):
        raise AssertionError(f"wandering64-1M: plan {type(plan).__name__}")
    sp = plan.plan
    rows = sum(c[0] * (b.numel() // 2)
               for c, b in zip(sp.classes, sp.class_bases))
    slabs = {k: (torch.full((rows, 128, 128), float("nan"), device="cuda"),
                 torch.full((rows, 128, 128), 7, dtype=torch.uint8,
                            device="cuda"))
             for k in ("current", "baseline", "no_mark")}

    def classes(lib, key):
        num, flag = slabs[key]

        def run():
            for (t, _p, _ar, _br, _ao, _bo, base), bases, (p_ptr, ao, bo) in \
                    zip(sp.classes, sp.class_bases, sp.class_tables):
                checked(lib.macro_class_ragged_f32(
                    a.dense.data_ptr(), a.dense.data_ptr(), bases.data_ptr(),
                    p_ptr.data_ptr(), ao.data_ptr(), bo.data_ptr(), t,
                    bases.numel() // 2, base, num.data_ptr(),
                    flag.data_ptr(), stream), key)
        return run

    fns = {"current": classes(cur, "current"),
           "no_mark": classes(no_mark, "no_mark")}
    if base_lib is not None:
        fns["baseline"] = classes(base_lib, "baseline")
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
    times = in_turns(fns, 10, rounds=4)
    emit("k5", matrix="wandering64-1M", classes=len(sp.classes),
         c_rows=rows, ms=times, bit_equal_to_baseline=equal)


def case_k3(base_lib):
    libs = {"current": dk._library()}
    stream = torch.cuda.current_stream().cuda_stream
    a = D.coo_to_dia(STREAMS["pairbands-500k"]())
    offs = tuple(int(x) for x in a.offsets)
    dc_list, _ = D._plan_maps(offs, offs)
    row_ptr, trip = dk.dia_tables(offs, offs, dc_list, "pairs", a.device)
    n, dcn, d1n = a.n, len(dc_list), len(offs)
    n_pairs = d1n * d1n
    shape = dk.pairs_launch(d1n, dcn, n_pairs, n)
    out = {k: (torch.empty((dcn, n), device="cuda"),
               torch.empty((dcn, n), device="cuda"))
           for k in (*libs, "baseline")}
    bands = a.bands.data_ptr()

    def current(values_only, name="current"):
        c, cnt = out[name]
        lib = libs[name]
        return lambda: checked(lib.dia_multiply_pairs_f32(
            bands, bands, row_ptr.data_ptr(), trip.data_ptr(), c.data_ptr(),
            None if values_only else cnt.data_ptr(), d1n, dcn, n_pairs,
            offs[0], offs[-1], n, n, n, shape["grid_y"],
            int(shape["stage_a"]), int(shape["stage_tables"]),
            shape["smem_bytes"], stream), name)

    def baseline(values_only):
        c, cnt = out["baseline"]
        return lambda: checked(base_lib.dia_multiply_pairs_f32(
            bands, bands, row_ptr.data_ptr(), trip.data_ptr(), c.data_ptr(),
            None if values_only else cnt.data_ptr(), dcn, n, n, n, stream),
            "baseline")

    for values_only in (False, True):
        fns = {name: current(values_only, name) for name in libs}
        if base_lib is not None:
            fns["baseline"] = baseline(values_only)
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        equal = None
        ref = "baseline" if base_lib is not None else "current"
        for name in fns:
            same = torch.equal(out[name][0], out[ref][0]) and (
                values_only or torch.equal(out[name][1], out[ref][1]))
            if not same:
                raise AssertionError(f"K3: {name} and {ref} differ at "
                                     "pairbands-500k")
        if base_lib is not None:
            equal = True
        emit("k3", matrix="pairbands-500k", values_only=values_only,
             shape=[d1n, n], c_rows=dcn, launch=shape,
             ms=in_turns(fns, 20), bit_equal_to_baseline=equal)


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-macro", default=None)
    ap.add_argument("--baseline-dia", default=None)
    ap.add_argument("--only", choices=["k4", "k5", "k3", "library"],
                    default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_split: no CUDA device", file=sys.stderr)
        return 1
    M.require_full_fp32()
    emit("tools", ncu=shutil.which("ncu"),
         device=torch.cuda.get_device_name(0))
    base_macro = base_dia = None
    if args.baseline_macro:
        base_macro = build("macro_accumulate", "baseline",
                           args.baseline_macro, declare_baseline_macro)
    if args.baseline_dia:
        base_dia = build("dia_multiply", "baseline", args.baseline_dia,
                         declare_baseline_dia)
    if args.only in (None, "k4"):
        case_k4(base_macro, {"wandering64-1M": 10, "pairbands-500k": 5})
    if args.only in (None, "k5"):
        case_k5(base_macro)
    if args.only in (None, "k3"):
        case_k3(base_dia)
    if args.only in (None, "library"):
        case_library()
    return 0


if __name__ == "__main__":
    sys.exit(main())
