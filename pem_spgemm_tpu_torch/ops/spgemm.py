"""The SpGEMM orchestrator: structural dispatch + the timed phases.

Phase naming follows the reference for benchmark parity (step1 / step2 /
step3).  The binned element engine, the DIA engine and the Macro128 engine
are ported; the Tile16 engines raise NotImplementedError naming the ROADMAP
slice that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pem_spgemm_tpu_torch.config import SpGEMMConfig, DEFAULT_CONFIG
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.formats.dia import DiaMatrix
from pem_spgemm_tpu_torch.formats.macro import MacroMatrix, macro_operands
from pem_spgemm_tpu_torch.formats.tiled import TiledMatrix
from pem_spgemm_tpu_torch.utils.timing import PhaseTimers

_NOT_PORTED = {
    "fused": "the Tile16 tier is ROADMAP slice 4",
    "masks": "the Tile16 tier is ROADMAP slice 4",
}


def not_ported(engine: str) -> NotImplementedError:
    why = _NOT_PORTED.get(engine, "unknown engine")
    return NotImplementedError(
        f"engine {engine!r} is not ported yet ({why}); the binned element "
        "engine, the DIA engine and the Macro128 engine run in this package "
        "so far")


@dataclasses.dataclass
class SpGEMMResult:
    """C = A@B.  The element engine fills the stream form (or direct COO
    coordinates for the empty product); the DIA engine the band form; the
    Macro128 engine the dense-tile form."""

    vals: torch.Tensor      # (cap,) value dtype
    shape: tuple
    c_nnz: int              # true C nnz (structural, exact)
    n_pairs: int            # intermediate products
    engine: str
    # direct COO form, (row, col)-sorted (the empty product)
    rows: Optional[torch.Tensor] = None
    cols: Optional[torch.Tensor] = None
    first: Optional[torch.Tensor] = None
    # bucketed stream form (ops/binned.BinnedStream): padded per-C-row
    # segments with group totals at first-flagged slots
    binned: Optional[object] = None
    # dia form (engine == "dia"): vals = (dc, n) C band stack, c_counts =
    # (dc, n) structural counts, dia_dc = the C diagonal offsets
    c_counts: Optional[torch.Tensor] = None
    dia_dc: Optional[tuple] = None
    # macro form (engine == "macro"): vals = (c_cap, 128, 128) dense C tiles,
    # c_counts = (c_cap, 128, 128) uint8 structural flags, with the tiles'
    # coordinates and the exact nnz scan
    c_tile_row: Optional[torch.Tensor] = None    # (c_cap,) i32
    c_tile_col: Optional[torch.Tensor] = None    # (c_cap,) i32
    cptr: Optional[torch.Tensor] = None          # (c_cap+1,) i32
    c_ntiles: int = 0                            # true C tile count

    def to_coo(self) -> COOMatrix:
        """Assemble + sort to canonical global COO (host)."""
        if self.dia_dc is not None:
            from pem_spgemm_tpu_torch.ops.dia import dia_to_coo
            rows, cols, vals = dia_to_coo(self.vals, self.c_counts,
                                          self.dia_dc, self.shape, self.c_nnz)
            return COOMatrix(rows, cols, vals, self.shape)
        if self.binned is not None:
            rows, cols, vals = self.binned.to_coo_arrays()
            return COOMatrix(rows, cols, vals, self.shape)
        if self.c_tile_row is not None:
            from pem_spgemm_tpu_torch.ops.macro import assemble_macro_coo
            rows, cols, vals = assemble_macro_coo(
                self.c_tile_row, self.c_tile_col, self.vals, self.c_counts,
                self.c_nnz)
            return COOMatrix(rows, cols, vals, self.shape)
        n = self.c_nnz
        return COOMatrix(self.rows.cpu().numpy()[:n],
                         self.cols.cpu().numpy()[:n],
                         self.vals.cpu().numpy()[:n], self.shape)


def _empty_result(shape, engine: str, device) -> "SpGEMMResult":
    """A structurally empty C: an empty product is a result, not an
    error (the reference still reports and benchmarks it)."""
    z32 = torch.zeros(0, dtype=torch.int32, device=device)
    return SpGEMMResult(
        vals=torch.zeros(0, dtype=torch.float32, device=device),
        shape=shape, c_nnz=0, n_pairs=0, engine=engine, rows=z32, cols=z32)


class SpGEMM:
    """C = A@B (or A@A.T) on Tile16, DIA or Macro128 operands."""

    def __init__(self, config: SpGEMMConfig = DEFAULT_CONFIG):
        self.config = config

    def pick_engine(self, a: TiledMatrix, b: TiledMatrix) -> str:
        """Three-tier structural dispatch: macro (dense 128x128) /
        fused (Tile16) / element."""
        cfg = self.config
        if cfg.engine != "auto":
            return cfg.engine
        fill_m = 0.5 * (a.macro_stats()[1] + b.macro_stats()[1])
        if fill_m >= cfg.macro_threshold:
            return "macro"
        fill = 0.5 * (a.fill_ratio() + b.fill_ratio())
        return "element" if fill < cfg.element_threshold else "fused"

    def __call__(self, a: TiledMatrix, b: TiledMatrix,
                 timers: Optional[PhaseTimers] = None) -> SpGEMMResult:
        timers = timers if timers is not None else PhaseTimers()
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
        if isinstance(a, DiaMatrix):
            return self._dia(a, b, timers)
        if isinstance(a, MacroMatrix):
            return self._macro(a, b, timers)
        engine = self.pick_engine(a, b)
        if engine == "dia":
            raise TypeError(
                "engine='dia' takes DiaMatrix operands (ops.dia.coo_to_dia); "
                "bench.harness.run_benchmark converts a COO matrix to them")
        if engine == "macro":
            return self._macro(a, b, timers)
        if engine != "element":
            raise not_ported(engine)
        cfg = self.config
        if cfg.element_impl != "binned" or cfg.dtype != torch.float32:
            raise NotImplementedError(
                f"element_impl={cfg.element_impl!r} with dtype={cfg.dtype} "
                "needs the merge-sort element engine (f64 parity, ROADMAP "
                "slice 5), which is not ported yet")
        return self._element_binned(a, b, timers)

    def _macro(self, a, b, timers: PhaseTimers) -> SpGEMMResult:
        """Macro128 engine (ops/macro.py): dense 128x128 tile products.
        step1 = pair expansion sorted by C tile (two size feedbacks);
        step3 = fused numeric + structural accumulation through
        ``macro_kernels.accumulate_macro_pairs`` (the pair-stream kernel
        for CUDA tiles, the plain chunked batched product and scatter-add
        for CPU tiles); step2 = tile coordinates + the exact-nnz scan and
        its size feedback."""
        from pem_spgemm_tpu_torch.ops import cstruct, macro as M, symbolic
        from pem_spgemm_tpu_torch.ops.macro_kernels import \
            accumulate_macro_pairs
        from pem_spgemm_tpu_torch.ops.scanops import can_pack
        cfg = self.config
        if cfg.precision != "highest":
            raise NotImplementedError(
                f"precision={cfg.precision!r}: the Macro128 engine of this "
                "package accumulates in full float32 only")
        am, bm = macro_operands(a, b)
        shape = (a.shape[0], b.shape[1])

        with timers.phase("step1") as box:
            offsets = symbolic.pair_counts(am.tile_col, bm.tile_rowptr,
                                           am.ntiles)
            n_pairs = int(offsets[-1])        # size feedback #1
            if n_pairs == 0:
                return _empty_result(shape, "macro", am.device)
            chunk = cfg.macro_chunk
            p_cap = max(chunk, -(-n_pairs // chunk) * chunk)
            assert can_pack(am.n_macro_rows, bm.n_macro_cols)
            c_row, c_col, a_idx, b_idx, c_tile_id, cnt_c_dev = \
                symbolic.expand_pairs(
                    offsets, am.tile_row, am.tile_col, bm.tile_rowptr,
                    bm.tile_col, n_pairs, p_cap, True)
            c_ntiles = int(cnt_c_dev)         # size feedback #2
            box["sync"] = c_tile_id

        c_cap = max(256, -(-c_ntiles // 256) * 256)
        with timers.phase("step3") as box:
            c_dense, c_flags = accumulate_macro_pairs(
                am.dense, bm.dense, a_idx, b_idx, c_tile_id, c_cap,
                chunk=chunk, acc_dtype=cfg.acc())
            box["sync"] = c_dense

        with timers.phase("step2") as box:
            c_tile_row, c_tile_col = cstruct.c_tile_coords(
                c_tile_id, c_row, c_col, c_cap,
                am.n_macro_rows < (1 << 15))
            cptr = M.macro_structure(c_flags)
            c_nnz = int(cptr[-1])             # size feedback #3
            box["sync"] = cptr

        return SpGEMMResult(
            vals=c_dense, shape=shape, c_nnz=c_nnz, n_pairs=n_pairs,
            engine="macro", c_tile_row=c_tile_row, c_tile_col=c_tile_col,
            cptr=cptr, c_counts=c_flags, c_ntiles=c_ntiles)

    def _dia(self, a: DiaMatrix, b: DiaMatrix,
             timers: PhaseTimers) -> SpGEMMResult:
        """DIA engine (ops/dia.py).  step1 = the offset-pair plan (host);
        step3 = the shifted multiply of values AND 0/1 masks; step2 = the
        exact-nnz reduce + its one device-to-host copy."""
        from pem_spgemm_tpu_torch.ops import dia as D

        with timers.phase("step1"):
            plan = D.make_dia_plan(a, b)
            if not plan.dc_list:
                return _empty_result((a.shape[0], b.shape[1]), "dia",
                                     a.device)

        with timers.phase("step3") as box:
            out = plan.run(a, b)
            box["sync"] = out[1]

        with timers.phase("step2"):
            c_nnz = int(out[2])               # the one D2H feedback

        return SpGEMMResult(
            vals=out[0], shape=(a.shape[0], b.shape[1]), c_nnz=c_nnz,
            n_pairs=len(plan.offs_a) * len(plan.offs_b), engine="dia",
            c_counts=out[1], dia_dc=plan.dc_list)

    def _element_binned(self, a: TiledMatrix, b: TiledMatrix,
                        timers: PhaseTimers) -> SpGEMMResult:
        """Binned element engine (ops/binned.py).  Phase mapping:
        step1 = chunk binning plan; step3 = expansion + segment sorts +
        group reduction (fused numeric+structural); step2 = exact-nnz
        reduce + its device-to-host copy."""
        from pem_spgemm_tpu_torch.ops import binned

        with timers.phase("step1") as box:
            plan = binned.build_plan_device(a, b)
            if plan.n_products == 0:
                return _empty_result((a.shape[0], b.shape[1]), "element",
                                     a.device)
            box["sync"] = plan.res_src

        with timers.phase("step3") as box:
            kernel_sort = self.config.element_vmem_sort and a.vals.is_cuda
            stream = binned.binned_multiply(plan, vmem_sort=kernel_sort)
            box["sync"] = (stream.bucket_vals[-1] if stream.bucket_vals
                           else stream.res[2])

        with timers.phase("step2"):
            c_nnz = int(stream.c_nnz)             # the one D2H feedback
            stream.c_nnz = c_nnz

        return SpGEMMResult(
            vals=stream.res[2], shape=(a.shape[0], b.shape[1]),
            c_nnz=c_nnz, n_pairs=plan.n_products, engine="element",
            binned=stream)
