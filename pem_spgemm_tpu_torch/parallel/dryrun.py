"""All four sharded decompositions, one real multiply each, C_nnz exact.

    torchrun --nproc_per_node=N -m pem_spgemm_tpu_torch.parallel.dryrun

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``, on
the same problems: the Tile16 ring and the column-sharded element engine on
a power-law matrix, the Macro128 ring on a banded one and the DIA halo
exchange on a three-diagonal one; then the two rings again on bfloat16
values and the Tile16 ring on float64 values.  Every rank runs every
decomposition on its own GPU (NCCL); C_nnz must equal scipy's exactly and
the values agree within 1e-3 relative (the JAX dry run's check).
``--device cpu`` runs the ranks on gloo.  Rank 0 prints a line a
decomposition and exits non-zero on a failed check.

``rank_cases`` is what one rank runs for the tests (which spawn gloo ranks
through ``parallel.launch.spawn``): each case is a decomposition and its
operands as numpy triplets, and the result holds the rank's plan arrays and
the assembled C as numpy.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.parallel import distributed as D


def _coo(t):
    rows, cols, vals, shape = t
    return COOMatrix(np.asarray(rows), np.asarray(cols), np.asarray(vals),
                     tuple(shape))


def _host(table):
    """A value table as numpy takes it: bfloat16 as its float32 copy."""
    return table.float() if table.dtype == torch.bfloat16 else table


def run_case(case: dict, mesh: D.RankGroup) -> dict:
    """One decomposition on this rank: its plan arrays and the assembled
    global COO, as numpy.  ``case``: ``kind`` ('element' | 'dia' | 'macro'
    | 'tile16' | 'scaling' | 'ring_masks'), ``coo`` (rows, cols, vals,
    shape) and, for A@B, ``b_coo``; ``dtype`` (default float32) is the
    operands' value dtype of 'element', 'macro' and 'tile16', and
    ``acc_dtype`` (default float32) the Tile16 ring's accumulation;
    'element' also returns the rank's own C entries (``local``, sorted);
    'scaling' takes ``engine`` and ``max_devices``; 'ring_masks' passes the
    macro plan's B chunk round the ring with its tile masks and returns,
    for each stage, whether the masks it holds are those of the chunk it
    holds.  Tables of bfloat16 come back as their float32 copies (numpy
    has no bfloat16)."""
    from pem_spgemm_tpu_torch.ops.convert import coo_to_macro, coo_to_tiled
    from pem_spgemm_tpu_torch.ops.dia import coo_to_dia, dia_to_coo
    from pem_spgemm_tpu_torch.parallel import (sharded, sharded_dia,
                                               sharded_element, sharded_macro)
    kind = case["kind"]
    coo = _coo(case["coo"])
    b_coo = _coo(case["b_coo"]) if case.get("b_coo") is not None else None
    n, d, dev = mesh.world_size, mesh.rank, mesh.device
    f32 = dict(dtype=torch.float32, device=dev)
    typed = dict(dtype=case.get("dtype", torch.float32), device=dev)
    if kind == "ring_masks":
        from pem_spgemm_tpu_torch.ops import macro_kernels as mk
        a = coo_to_macro(coo, **f32)
        plan = sharded_macro.plan_sharded_macro(a, a, n, d)
        held = []
        for s, (b, m) in enumerate(sharded_macro.ring_chunks(
                plan.b_dense, n, mesh, sharded_macro.plan_masks(plan)[1])):
            want = mk.tile_masks_plain(b)
            owner = sharded_macro.plan_sharded_macro(a, a, n, (d - s) % n)
            held.append(dict(ready=m.ready, of_buffer=m.matches(b),
                             chunk=bool(torch.equal(b, owner.b_dense)),
                             masks=bool(torch.equal(m.words, want)),
                             set_words=int(torch.count_nonzero(want))))
        return dict(held=held)
    if kind == "scaling":
        pts = D.scaling_efficiency(coo, engine=case["engine"],
                                   max_devices=case["max_devices"],
                                   repeats=1, verbose=False, device=dev)
        return dict(points=[(p.n_devices, p.c_nnz, p.seconds, p.efficiency)
                            for p in pts])
    if kind == "element":
        a = coo_to_tiled(coo, **typed)
        b = a if b_coo is None else coo_to_tiled(b_coo, **typed)
        plan = sharded_element.plan_sharded_element(a, b, n, d)
        stream, c_nnz = sharded_element.sharded_element_multiply(plan, mesh)
        rows, cols, vals = sharded_element.assemble_sharded_element(
            plan, stream, mesh)
        local = sharded_element.local_coo(stream, dev)
        order = torch.sort((local[0].long() << 32) | local[1].long()).indices
        out = dict(col_bounds=plan.col_bounds, w=plan.w,
                   n_products=plan.n_products,
                   local=[x[order] for x in local])
    elif kind == "dia":
        a = coo_to_dia(coo, **f32)
        c, cnt, dc_list = sharded_dia.sharded_dia_multiply(a, a, mesh)
        rows, cols, vals = dia_to_coo(c, cnt, dc_list, coo.shape)
        c_nnz = len(rows)
        out = dict(c=c, cnt=cnt, dc_list=np.asarray(dc_list))
    elif kind == "macro":
        a = coo_to_macro(coo, **typed)
        b = a if b_coo is None else coo_to_macro(b_coo, **typed)
        plan = sharded_macro.plan_sharded_macro(a, b, n, d)
        c_dense, c_flags = sharded_macro.sharded_macro_numeric(plan, mesh)
        c_nnz = D.plan_nnz_macro(plan, (c_dense, c_flags), mesh)
        rows, cols, vals = sharded_macro.assemble_sharded_macro(
            plan, c_dense, c_flags, mesh)
        out = dict(pairs_a=plan.pairs_a, pairs_b=plan.pairs_b, seg=plan.seg,
                   c_tile_row=plan.c_tile_row, c_tile_col=plan.c_tile_col,
                   a_dense=_host(plan.a_dense), b_dense=_host(plan.b_dense),
                   c_cap=plan.c_cap, c_counts_dev=plan.c_counts_dev,
                   stage_pairs=np.asarray(plan.stage_pairs),
                   n_pairs=plan.n_pairs)
    elif kind == "tile16":
        a = coo_to_tiled(coo, **typed)
        b = coo_to_tiled(coo if b_coo is None else b_coo, with_tmasks=True,
                         **typed)
        plan = sharded.plan_sharded_spgemm(a, b, n, d)
        vals = sharded.sharded_numeric(
            plan, mesh, acc_dtype=case.get("acc_dtype", torch.float32))
        rows, cols, vals = sharded.assemble_sharded(plan, vals, mesh)
        c_nnz = plan.c_nnz
        out = dict(pairs_a=plan.pairs_a, pairs_b=plan.pairs_b, seg=plan.seg,
                   rowcol=plan.rowcol, elem_tile=plan.elem_tile,
                   c_tile_row=plan.c_tile_row, c_tile_col=plan.c_tile_col,
                   a_dense=_host(plan.a_dense), b_dense=_host(plan.b_dense),
                   c_cap=plan.c_cap, c_nnz_per_dev=plan.c_nnz_per_dev,
                   n_pairs=plan.n_pairs)
    else:
        raise ValueError(f"unknown decomposition {kind!r}")
    out.update(c_nnz=int(c_nnz), rows=rows, cols=cols, vals=vals)
    return D.to_numpy_tree(out)


def rank_cases(cases, device=None) -> list:
    """What one rank runs for a list of cases (``run_case`` each), on the
    group of every rank.  ``device=None`` means the GPU, as everywhere in
    the package: gloo ranks pass ``device="cpu"``."""
    mesh = D.pod_mesh(device=device)
    return [run_case(c, mesh) for c in cases]


def problems():
    """The JAX dry run's four problems, then the two rings on bfloat16
    values (float32 C) and the Tile16 ring on float64 values accumulated in
    float64, as (label, kind, COO, run_case's dtype options)."""
    import scipy.sparse as sp
    from pem_spgemm_tpu_torch.models.synthetic import banded, power_law
    pl = power_law(n=2048, nnz=16384, seed=3)
    bd = banded(n=1024, bands=(0, 2, -2, 70, -70), seed=5)
    dmat = sp.diags([np.arange(1, 2047.), np.full(2048, 2.0),
                     np.full(1948, -0.5)], [-1, 0, 100], format="coo")
    bf16 = dict(dtype=torch.bfloat16)
    return [("tile16", "tile16", pl, {}), ("macro", "macro", bd, {}),
            ("element", "element", pl, {}),
            ("dia", "dia", COOMatrix.from_scipy(dmat), {}),
            ("macro bf16", "macro", bd, bf16),
            ("tile16 bf16", "tile16", pl, bf16),
            ("tile16 f64", "tile16", pl, dict(dtype=torch.float64,
                                              acc_dtype=torch.float64))]


def dryrun(device=None) -> bool:
    """Every decomposition once on the group of all ranks; True when every
    check held.  The reference is scipy's float64 product of the values as
    the run takes them (rounded to bfloat16 for a bfloat16 run), C_nnz that
    of |A|@|A| (the structure: rounded values may cancel exactly)."""
    import scipy.sparse as sp
    mesh = D.pod_mesh(device=device)
    ok = True
    for label, kind, coo, opts in problems():
        out = run_case(dict(kind=kind, coo=(coo.rows, coo.cols, coo.vals,
                                            coo.shape), **opts), mesh)
        vals = torch.as_tensor(np.asarray(coo.vals, np.float64))
        if opts.get("dtype") == torch.bfloat16:
            vals = vals.to(torch.bfloat16).to(torch.float64)
        s = sp.csr_matrix((vals.numpy(), (np.asarray(coo.rows),
                                          np.asarray(coo.cols))),
                          shape=coo.shape)
        want = (s @ s).toarray()
        nnz = (abs(s) @ abs(s)).nnz
        got = want[out["rows"], out["cols"]]
        err = float((np.abs(out["vals"] - got)
                     / np.maximum(np.abs(got), 1e-3)).max())
        good = out["c_nnz"] == nnz == len(out["rows"]) and err < 1e-3
        ok &= good
        if mesh.rank == 0:
            print(f"dryrun({mesh.world_size}): {label} "
                  f"{'ok' if good else 'FAILED'}: C_nnz={out['c_nnz']} "
                  f"(scipy {nnz}), max relative error {err:.3g}",
                  flush=True)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo ranks; default: this rank's GPU")
    args = p.parse_args(argv)
    D.initialize(device=args.device)
    try:
        ok = dryrun(args.device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
