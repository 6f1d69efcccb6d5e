"""Command line: the analog of the reference's ./pemspgemm binary.

Counterpart of the JAX package's bench/cli.py.  Reference usage:
pemspgemm <path.mtx> <0|1 save> [1=A*At].  This one keeps those positionals
and adds flags for the knobs the reference bakes in at compile time:

  python -m pem_spgemm_tpu_torch.bench.cli <matrix> <0|1 save> [1]
         [--repeat N] [--warmup N] [--fastest] [--dtype f32|f64]
         [--engine auto|element|dia|macro] [--device DEVICE]
         [--csv PATH] [--no-csv] [--outdir DIR]

<matrix> is a .mtx path or a synthetic spec like
'power_law:n=1000000,nnz=3000000' (see models/synthetic.by_name).  With
save=1 the sorted COO result is dumped in the reference's four-file layout
(default: the current directory).  The multiply runs on the GPU unless
--device says otherwise.  ``--dtype f64`` is the f64 parity mode (the
reference computes in double): the merge element engine, and the float64
entries of the DIA and Macro128 kernels.
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None):
    p = argparse.ArgumentParser(prog="pem-spgemm-torch", description=__doc__)
    p.add_argument("matrix", help=".mtx path or synthetic spec family:k=v,...")
    p.add_argument("save", type=int, choices=(0, 1),
                   help="1 = dump COO result files")
    p.add_argument("aat", nargs="?", type=int, default=0, choices=(0, 1),
                   help="1 = compute A@A.T instead of A@A")
    p.add_argument("--repeat", type=int, default=10)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--fastest", action="store_true",
                   help="report min across repeats (reference -DFASTEST)")
    p.add_argument("--dtype", default="f32", choices=("f32", "f64", "bf16"))
    p.add_argument("--csv", default="pemspgemm_benchmark_result.csv")
    p.add_argument("--no-csv", action="store_true")
    p.add_argument("--outdir", default=".",
                   help="directory for result dumps with save=1")
    p.add_argument("--save-converted", metavar="PATH",
                   help="persist the converted A operand (not ported yet)")
    p.add_argument("--engine", default="auto",
                   choices=("auto", "element", "dia", "macro"))
    p.add_argument("--device", default=None,
                   help="torch device of the multiply (default: the GPU)")
    args = p.parse_args(argv)

    from pem_spgemm_tpu_torch.config import SpGEMMConfig
    from pem_spgemm_tpu_torch.bench.harness import run_benchmark
    from pem_spgemm_tpu_torch.io.mtx import (read_matrix_market,
                                             save_result_files)
    from pem_spgemm_tpu_torch.models.synthetic import by_name

    if args.dtype == "bf16":
        raise NotImplementedError(
            "--dtype bf16 is not ported yet: bf16 belongs to the Tile16 "
            "tier, ROADMAP slice 4")
    dtype = {"f32": torch.float32, "f64": torch.float64}[args.dtype]
    if args.save_converted:
        raise NotImplementedError(
            "--save-converted is not ported yet: persistence of the "
            "converted formats is ROADMAP slice 6")

    if args.matrix.endswith(".mtx"):
        coo = read_matrix_market(args.matrix).sum_duplicates()
    else:
        coo = by_name(args.matrix, device=args.device)
    if args.aat == 0 and coo.shape[0] != coo.shape[1]:
        p.error("A@A needs a square matrix; rectangular inputs are only "
                "allowed in A@A.T mode (pass trailing 1)")

    cfg = SpGEMMConfig(dtype=dtype, warmup=args.warmup,
                       repeat=args.repeat, fastest=args.fastest,
                       engine=args.engine)
    record, result = run_benchmark(
        coo, args.matrix, cfg, aat=bool(args.aat),
        csv_path=None if args.no_csv else args.csv, device=args.device)

    if args.save:
        paths = save_result_files(args.outdir, result.to_coo())
        print(f"result dumped to {paths['NNZ'].rsplit('_', 1)[0]}_*.txt")
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
