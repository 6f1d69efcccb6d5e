"""Where the dense DIA kernel's time goes: stage-only and compute-only builds.

    python -m pem_spgemm_tpu_torch.bench.k2_split [banded128-1M banded64-1M]

Builds csrc/dia_multiply.cu three ways into the package's build directory:
as it is, with the band loop cut out (it only stages the A chunks and B
windows and stores zeros), and with the staging copies cut out (it runs the
band loop over whatever shared memory holds).  Times the dense entry of each
build at the stencil's own launch shape (``dia_kernels.dense_launch``), with
and without counts, by CUDA events, and prints one JSON line a matrix.  The
two cut builds give wrong values and are timed only; the whole build is held
against the plain version first.  Needs a GPU.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from pem_spgemm_tpu_torch.models.synthetic import banded_device
from pem_spgemm_tpu_torch.ops import _build, dia_kernels as dk
from pem_spgemm_tpu_torch.ops import dia as D

MATRICES = {        # the stencils of chip_smoke.py's DIA_MATRICES
    "banded64-1M": dict(n=1_000_000, seed=1, bands=tuple(range(-32, 32))),
    "banded128-1M": dict(n=1_000_000, seed=1, bands=tuple(range(-64, 64))),
}
# (build, text of the source, what replaces it)
CUTS = {
    "compute_only": ("        T* bw = smem + b_off;\n",
                     "        T* bw = smem + b_off;\n"
                     "        if (d1n > 0) return;\n"),
    "stage_only": ("        while (k < ke) {\n",
                   "        while (d1n < 0 && k < ke) {\n"),
}


def build(name: str):
    """The library of one build of the source (``whole``: as it is)."""
    with open(dk.SOURCE) as f:
        text = f.read()
    if name != "whole":
        old, new = CUTS[name]
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer has one {old!r}")
        text = text.replace(old, new)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, f"dia_multiply_{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    so = _build.compile_shared([_build.find_nvcc(), *_build.NVCC_FLAGS], src)
    return _build.load(so, dk._declare)


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


def split(matrix: str, libs) -> dict:
    a = D.coo_to_dia(banded_device(**MATRICES[matrix])).bands
    offs = MATRICES[matrix]["bands"]
    dc_list, idx_map = D._plan_maps(offs, offs)
    dcn, n = len(dc_list), a.shape[1]
    sh = dk.dense_launch(offs, len(offs), dcn)
    offs_dev = torch.tensor(offs, dtype=torch.int32, device=a.device)
    c = torch.empty((dcn, n), device=a.device)
    cnt = torch.empty_like(c)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, counts):
        def run():
            err = lib.dia_multiply_dense_f32(
                a.data_ptr(), a.data_ptr(), offs_dev.data_ptr(), c.data_ptr(),
                cnt.data_ptr() if counts else None, len(offs), len(offs),
                dcn, n, n, n, sh["tr_log2"], sh["tc_n"], sh["kc"], sh["s"],
                sh["cw_log2"], sh["b_off"], sh["stage_words"], stream)
            if err:
                raise RuntimeError(f"launch failed with error {err}")
        return run

    launch(libs["whole"], True)()
    want_c, want_n = D._dia_multiply_torch(a, a, offs_a=offs, idx_map=idx_map,
                                           dc_count=dcn, n_out=n)
    mag, _ = D._dia_multiply_torch(a.abs(), a.abs(), offs_a=offs,
                                   idx_map=idx_map, dc_count=dcn, n_out=n,
                                   values_only=True)
    if not (torch.equal(cnt, want_n)
            and bool(((c - want_c).abs() <= 1e-5 * mag + 1e-6).all())):
        raise AssertionError(f"{matrix}: the whole build disagrees with the "
                             "plain version")
    del want_c, want_n, mag
    out = {"matrix": matrix, "kc": sh["kc"], "L": sh["L"],
           "rows_per_block": sh["rows_per_block"],
           "smem_bytes": sh["smem_bytes"]}
    for name, lib in libs.items():
        out[name] = {"ms": time_ms(launch(lib, True)),
                     "values_only_ms": time_ms(launch(lib, False))}
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("k2_split: no CUDA device", file=sys.stderr)
        return 1
    libs = {name: build(name) for name in ("whole", *CUTS)}
    for matrix in argv or list(MATRICES):
        print(json.dumps(split(matrix, libs)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
