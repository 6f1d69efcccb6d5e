"""Where the dense DIA kernel's time goes: stage-only and compute-only builds.

    python -m pem_spgemm_tpu_torch.bench.k2_split [--parent FILE]
        [banded128-1M banded64-1M ...]

Builds csrc/dia_multiply.cu three ways into the package's build directory:
as it is, with the band loop cut out (it only stages the A words and the
ring's B columns and stores zeros), and with the staging copies cut out (it
runs the band loop over whatever shared memory holds).  With --parent,
another version of the source (for example the parent commit's, ``git show
<commit>:pem_spgemm_tpu_torch/csrc/dia_multiply.cu``) is built the same
three ways with its own cuts (``PARENT_CUTS``, the source of commit 5b9f52f)
and launched at its own rule (``k4_split.parent_dense_launch``).  Times the
float32 dense entry of each build at the stencil's launch shape, with and
without counts, by CUDA events in turns, and prints one JSON line a matrix
with the words each launch stages (``dia_kernels.dense_staging``, and the
parent's rule's count).  The cut builds give wrong values and are timed
only; the whole builds are held against the plain version first, and
against each other bit for bit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from pem_spgemm_tpu_torch.bench import k4_split
from pem_spgemm_tpu_torch.models.synthetic import banded_device
from pem_spgemm_tpu_torch.ops import _build, dia_kernels as dk
from pem_spgemm_tpu_torch.ops import dia as D

MATRICES = {        # the stencils of chip_smoke.py's DIA_MATRICES
    "banded64-1M": dict(n=1_000_000, seed=1, bands=tuple(range(-32, 32))),
    "banded128-1M": dict(n=1_000_000, seed=1, bands=tuple(range(-64, 64))),
    "banded16-1M": dict(n=1_000_000, seed=1, bands=tuple(range(-8, 8))),
}
# (build, text of the source, what replaces it)
CUTS = {
    "compute_only": ("        if (nrows == 0) return;         // the group's "
                     "rows reach no B row\n",
                     "        if (nrows == 0 || d1n > 0) return;\n"),
    "stage_only": ("                    while (k < k_end) {\n",
                   "                    while (d1n < 0 && k < k_end) {\n"),
}
# the same cuts of the parent's source (commit 5b9f52f)
PARENT_CUTS = {
    "compute_only": ("        T* bw = smem + b_off;\n",
                     "        T* bw = smem + b_off;\n"
                     "        if (d1n > 0) return;\n"),
    "stage_only": ("        while (k < ke) {\n",
                   "        while (d1n < 0 && k < ke) {\n"),
}


def build(name: str, source: str, cuts, declare):
    """The library of one build of ``source`` (``whole``: as it is)."""
    with open(source) as f:
        text = f.read()
    stem = name.split("/")[-1]
    if stem != "whole":
        old, new = cuts[stem]
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer has one {old!r}")
        text = text.replace(old, new)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR,
                       f"dia_multiply_{name.replace('/', '_')}.cu")
    with open(src, "w") as f:
        f.write(text)
    so = _build.compile_shared([_build.find_nvcc(), *_build.NVCC_FLAGS], src)
    return _build.load(so, declare)


def parent_staging(offs, d2n, dcn, n_out, shape) -> dict:
    """The words the parent's launch (``k4_split.parent_dense_launch``)
    copies into shared memory: every block, every chunk whose window its
    rows reach, the chunk's A rows and its whole window, pad rows
    included."""
    L, rb, pad = shape["L"], shape["rows_per_block"], shape["rows"] - 1
    n_ranges = -(-n_out // L)
    per_range = 0
    for by in range(shape["grid_y"]):
        rc0 = by * rb
        for kb, ke in dk.dense_chunks(offs, shape["kc"]):
            dlo, dhi = offs[kb] - offs[0], offs[ke - 1] - offs[0]
            wr0, wr1 = max(0, rc0 - dhi), min(d2n, rc0 + rb - dlo)
            if wr1 > wr0:
                per_range += (ke - kb) * L \
                    + (wr1 - wr0 + 2 * pad) * (L + dhi - dlo)
    useful = (len(offs) + d2n) * L
    return dict(staged_words=per_range * n_ranges, per_range=per_range,
                useful_per_range=useful, factor=per_range / useful)


def split(matrix: str, libs, rounds=4, n_time=10) -> dict:
    a = D.coo_to_dia(banded_device(**MATRICES[matrix])).bands
    offs = MATRICES[matrix]["bands"]
    dc_list, idx_map = D._plan_maps(offs, offs)
    dcn, n = len(dc_list), a.shape[1]
    offs_dev = torch.tensor(offs, dtype=torch.int32, device=a.device)
    c = torch.empty((dcn, n), device=a.device)
    cnt = torch.empty_like(c)
    stream = torch.cuda.current_stream().cuda_stream
    shapes = {}

    def launch(name, counts, out=(c, cnt)):
        lib, kind = libs[name]
        fn, shapes[kind] = k4_split.dense_launcher(
            lib, 4, kind, a, offs, offs_dev, out[0],
            out[1] if counts else None, stream)
        return fn

    want_c, want_n = D._dia_multiply_torch(a, a, offs_a=offs, idx_map=idx_map,
                                           dc_count=dcn, n_out=n)
    mag, _ = D._dia_multiply_torch(a.abs(), a.abs(), offs_a=offs,
                                   idx_map=idx_map, dc_count=dcn, n_out=n,
                                   values_only=True)
    whole = [k for k in libs if k.endswith("whole")]
    for k in whole:
        launch(k, True)()
        torch.cuda.synchronize()
        if not (torch.equal(cnt, want_n)
                and bool(((c - want_c).abs() <= 1e-5 * mag + 1e-6).all())):
            raise AssertionError(f"{matrix}: build {k} disagrees with the "
                                 "plain version")
        if k != whole[0] and not torch.equal(c.view(torch.int32),
                                             keep.view(torch.int32)):
            raise AssertionError(f"{matrix}: build {k} differs from "
                                 f"{whole[0]} bit for bit")
        keep = c.clone()
    del want_c, want_n, mag, keep
    out = {"matrix": matrix, "whole_builds_bit_equal": len(whole) > 1}
    fns = {}
    for name in libs:
        fns[name] = launch(name, True)
        fns[name + "/values_only"] = launch(name, False)
    out["ms"] = k4_split.in_turns(fns, n_time, rounds)
    sh = shapes["current"]
    out["shape"] = {k: sh[k] for k in ("threads", "L", "passes", "grid_y",
                                       "kc", "chunks", "strip", "grid_x",
                                       "smem_bytes", "blocks_per_sm")}
    out["staging"] = dk.dense_staging(offs, len(offs), dcn, sh)
    ps = k4_split.parent_dense_launch(offs, len(offs), dcn)
    out["parent_shape"] = {k: ps[k] for k in ("threads", "L", "kc",
                                              "chunks", "grid_y",
                                              "smem_bytes")}
    out["parent_staging"] = parent_staging(offs, len(offs), dcn, n, ps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another dia_multiply.cu, built beside this one")
    ap.add_argument("matrices", nargs="*", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_split: no CUDA device", file=sys.stderr)
        return 1
    libs = {name: (build(name, dk.SOURCE, CUTS, dk._declare), "current")
            for name in ("whole", *CUTS)}
    if args.parent:
        kind = k4_split.dia_interface(args.parent)
        cuts = CUTS if kind == "current" else PARENT_CUTS
        for name in ("whole", *cuts):
            libs[f"parent/{name}"] = (
                build(f"parent/{name}", args.parent, cuts,
                      k4_split.declare_baseline_dia(kind)), kind)
    k4_split.emit("tools", device=torch.cuda.get_device_name(0),
                  nvidia_smi=k4_split.nvidia_smi())
    for matrix in args.matrices or ["banded128-1M", "banded64-1M"]:
        print(json.dumps(split(matrix, libs)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
