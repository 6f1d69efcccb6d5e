"""Command line: the analog of the reference's ./pemspgemm binary.

Counterpart of the JAX package's bench/cli.py.  Reference usage:
pemspgemm <path.mtx> <0|1 save> [1=A*At].  This one keeps those positionals
and adds flags for the knobs the reference bakes in at compile time:

  python -m pem_spgemm_tpu_torch.bench.cli <matrix> <0|1 save> [1]
         [--repeat N] [--warmup N] [--fastest] [--dtype f32|f64|bf16]
         [--engine auto|element|fused|masks|dia|macro] [--device DEVICE]
         [--csv PATH] [--no-csv] [--outdir DIR] [--save-converted PATH]

<matrix> is a .mtx path or a synthetic spec like
'power_law:n=1000000,nnz=3000000' (see models/synthetic.by_name).  With
save=1 the sorted COO result is dumped in the reference's four-file layout
(default: the current directory).  The multiply runs on the GPU unless
--device says otherwise.  ``--dtype f64`` is the f64 parity mode (the
reference computes in double): the merge element engine, the float64
entries of the DIA and Macro128 kernels, and the Tile16 engines in float64.
``--dtype bf16`` runs on every engine with float32 accumulation and C
rounded to bfloat16.
``--save-converted PATH`` writes the converted A operand (Tile16, Macro128
or DIA by the engine that ran) to an .npz archive that io/persist.py, or
the JAX package's, loads.
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
                   help="persist the converted A operand (.npz; Tile16, "
                        "Macro128 or DIA by engine) for instant reload")
    p.add_argument("--engine", default="auto",
                   choices=("auto", "element", "fused", "masks", "dia",
                            "macro"))
    p.add_argument("--device", default=None,
                   help="torch device of the multiply (default: the GPU)")
    args = p.parse_args(argv)

    from pem_spgemm_tpu_torch.config import SpGEMMConfig
    from pem_spgemm_tpu_torch.bench.harness import run_benchmark
    from pem_spgemm_tpu_torch.io.mtx import (read_matrix_market,
                                             save_result_files)
    from pem_spgemm_tpu_torch.models.synthetic import by_name

    dtype = {"f32": torch.float32, "f64": torch.float64,
             "bf16": torch.bfloat16}[args.dtype]
    # bfloat16 values accumulate in float32 (numpy has no bfloat16, and a
    # bfloat16 sum loses the exactness the pattern counts need)
    acc_dtype = torch.float32 if dtype == torch.bfloat16 else None

    if args.matrix.endswith(".mtx"):
        coo = read_matrix_market(args.matrix).sum_duplicates()
    else:
        coo = by_name(args.matrix, device=args.device)
    if args.aat == 0 and coo.shape[0] != coo.shape[1]:
        p.error("A@A needs a square matrix; rectangular inputs are only "
                "allowed in A@A.T mode (pass trailing 1)")

    cfg = SpGEMMConfig(dtype=dtype, acc_dtype=acc_dtype,
                       warmup=args.warmup, repeat=args.repeat,
                       fastest=args.fastest, engine=args.engine)
    record, result = run_benchmark(
        coo, args.matrix, cfg, aat=bool(args.aat),
        csv_path=None if args.no_csv else args.csv, device=args.device)

    if args.save_converted:
        # the converted operand as an archive: reload with
        # io.persist.load_tiled / load_macro / load_dia
        from pem_spgemm_tpu_torch.io import persist
        from pem_spgemm_tpu_torch.ops.convert import (coo_to_macro,
                                                      coo_to_tiled)
        kw = dict(dtype=dtype, device=args.device)
        if result.engine == "dia":
            from pem_spgemm_tpu_torch.ops.dia import coo_to_dia
            persist.save_dia(args.save_converted, coo_to_dia(coo, **kw))
        elif result.engine == "macro":
            persist.save_macro(args.save_converted, coo_to_macro(coo, **kw))
        else:
            persist.save_tiled(args.save_converted,
                               coo_to_tiled(coo, with_tmasks=True, **kw))
        print(f"converted operand persisted to {args.save_converted}")

    if args.save:
        paths = save_result_files(args.outdir, result.to_coo())
        print(f"result dumped to {paths['NNZ'].rsplit('_', 1)[0]}_*.txt")
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
