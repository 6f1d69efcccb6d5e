"""The SpGEMM orchestrator: structural dispatch + the timed phases.

Counterpart of the JAX package's ops/spgemm.py.  Host-side code that
chains the phases with the two-pass allocation protocol: each
data-dependent size crosses to the host once (the reference's three size
feedbacks) and the next phase runs at a capacity bucketed from it.

Phase naming follows the reference for benchmark parity:
  step1 = symbolic pair expansion + C tile structure
  step2 = C masks / exact nnz / intra-tile coordinates
  step3 = numeric accumulation + value extraction
Engines: the Tile16 engines (``fused``: one pass gives values and the 0/1
pattern; ``masks``: the bitmask structure phase, then the values), the
element engines (binned for float32, the merge engine for
``element_impl="merge"`` and every other dtype), the DIA engine and the
Macro128 engine.  bfloat16 values run on every engine with bfloat16
operands and float32 accumulation (the element engines take them through
the merge engine, the DIA and Macro128 engines through their float32
kernels on operands widened once, cached on them).  C is rounded to
bfloat16 on every engine but the Macro128 one, which keeps C in
``acc_dtype`` (float32), as the JAX package's does and as its steady plans
emit it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pem_spgemm_tpu_torch.config import SpGEMMConfig, DEFAULT_CONFIG
from pem_spgemm_tpu_torch.formats.coo import COOMatrix, _to_numpy
from pem_spgemm_tpu_torch.formats.dia import DiaMatrix
from pem_spgemm_tpu_torch.formats.macro import MacroMatrix, macro_operands
from pem_spgemm_tpu_torch.formats.tiled import TiledMatrix
from pem_spgemm_tpu_torch.utils.timing import PhaseTimers

TILE16_ENGINES = ("fused", "masks")


@dataclasses.dataclass
class SpGEMMResult:
    """C = A@B.  The Tile16 engines fill the compressed tile form; the
    binned element engine the bucketed stream form, the merge engine the
    flagged stream (``first`` set) or, for wide dtypes and the empty
    product, direct COO coordinates; the DIA engine the band form; the
    Macro128 engine the dense-tile form."""

    vals: torch.Tensor      # (cap,) value dtype
    shape: tuple
    c_nnz: int              # true C nnz (structural, exact)
    n_pairs: int            # intermediate products
    engine: str
    # direct COO / stream form (the merge engine, the empty product),
    # (row, col)-sorted; with ``first`` set the arrays are the flagged group
    # stream and to_coo compacts them
    rows: Optional[torch.Tensor] = None
    cols: Optional[torch.Tensor] = None
    first: Optional[torch.Tensor] = None     # (cap,) i32 group-start flags
    # bucketed stream form (ops/binned.BinnedStream): padded per-C-row
    # segments with group totals at first-flagged slots
    binned: Optional[object] = None
    # dia form (engine == "dia"): vals = (dc, n) C band stack, c_counts =
    # (dc, n) structural counts, dia_dc = the C diagonal offsets
    c_counts: Optional[torch.Tensor] = None
    dia_dc: Optional[tuple] = None
    # tiled form (engine in {"fused", "masks"}): vals = (c_nnz_cap,)
    # tile-major compressed values, with the tiles' coordinates, masks,
    # exact nnz scan and per-element intra-tile coordinates and tiles;
    # macro form (engine == "macro"): vals = (c_cap, 128, 128) dense C tiles,
    # c_counts = (c_cap, 128, 128) uint8 structural flags, with the tiles'
    # coordinates and the exact nnz scan
    c_tile_row: Optional[torch.Tensor] = None    # (c_cap,) i32
    c_tile_col: Optional[torch.Tensor] = None    # (c_cap,) i32
    cmask: Optional[torch.Tensor] = None         # (c_cap, 16) i32, tiled
    cptr: Optional[torch.Tensor] = None          # (c_cap+1,) i32
    rowcol: Optional[torch.Tensor] = None        # (c_nnz_cap,) i32, tiled
    elem_tile: Optional[torch.Tensor] = None     # (c_nnz_cap,) i32, tiled
    c_ntiles: int = 0                            # true C tile count

    def to_coo(self) -> COOMatrix:
        """Assemble + sort to canonical global COO (host).  bfloat16 values
        come back as float32 (numpy has no bfloat16)."""
        if self.rowcol is not None:
            from pem_spgemm_tpu_torch.ops.assemble import assemble_coo
            n = self.c_nnz
            rows, cols, vals = assemble_coo(
                self.c_tile_row, self.c_tile_col, self.rowcol,
                self.elem_tile, self.vals, n)
            return COOMatrix(rows[:n].cpu().numpy(), cols[:n].cpu().numpy(),
                             _to_numpy(vals[:n]), self.shape)
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
        rows, cols, vals = self.rows, self.cols, self.vals
        if self.first is not None:
            from pem_spgemm_tpu_torch.ops.element import compact_stream
            rows, cols, vals = compact_stream(rows, cols, vals, self.first)
        return COOMatrix(rows[:n].cpu().numpy(), cols[:n].cpu().numpy(),
                         _to_numpy(vals[:n]), self.shape)


def _empty_result(shape, engine: str, device,
                  dtype=torch.float32) -> "SpGEMMResult":
    """A structurally empty C: an empty product is a result, not an
    error (the reference still reports and benchmarks it).  Its values
    have the configured dtype."""
    z32 = torch.zeros(0, dtype=torch.int32, device=device)
    return SpGEMMResult(
        vals=torch.zeros(0, dtype=dtype, device=device),
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
        if engine == "element":
            return self._element(a, b, timers)
        if engine not in TILE16_ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        return self._tiled(a, b, engine, timers)

    def _tiled(self, a: TiledMatrix, b: TiledMatrix, engine: str,
               timers: PhaseTimers) -> SpGEMMResult:
        """The Tile16 engines.  step1 = pair expansion + C tile structure
        (size feedbacks #1, pairs, and #2, C tiles).  "fused": step3 first,
        one pass over the dense tiles gives the values, C's masks from the
        0/1 pattern and their nnz scan, then step2 the tile coordinates
        and C nnz (#3).  "masks":
        step2 first, the bitmask structure phase (#3), then step3 the
        values.  Then step2 enumerates C's intra-tile coordinates and step3
        gathers the compressed values, as the reference's timers split
        them.  These three are the only device-to-host copies.  On the
        card the accumulation, the masks and the enumeration are the Tile16
        kernels (``ops.tile16_kernels``)."""
        from pem_spgemm_tpu_torch.config import round_up_bucket, \
            round_up_pow2
        from pem_spgemm_tpu_torch.ops import cstruct, numeric, symbolic
        from pem_spgemm_tpu_torch.ops.convert import transpose_masks
        from pem_spgemm_tpu_torch.ops.scanops import can_pack
        cfg = self.config
        shape = (a.shape[0], b.shape[1])
        if engine == "masks":
            b_tmasks = b.tmasks if b.tmasks is not None \
                else transpose_masks(b.masks)

        with timers.phase("step1") as box:
            offsets = symbolic.pair_counts(a.tile_col, b.tile_rowptr,
                                           a.ntiles)
            n_pairs = int(offsets[-1])            # size feedback #1
            if n_pairs == 0:
                return _empty_result(shape, "fused", a.device, cfg.dtype)
            p_cap = max(cfg.numeric_chunk, round_up_pow2(n_pairs))
            packed = can_pack(a.n_tile_rows, b.n_tile_cols)
            c_row, c_col, a_idx, b_idx, c_tile_id, cnt_c_dev = \
                symbolic.expand_pairs(
                    offsets, a.tile_row, a.tile_col, b.tile_rowptr,
                    b.tile_col, n_pairs, p_cap, packed)
            c_ntiles = int(cnt_c_dev)             # size feedback #2
            box["sync"] = c_tile_id

        c_cap = round_up_bucket(c_ntiles)
        if engine == "fused":
            with timers.phase("step3") as box:
                a_flat = a.dense_flat()           # cached conversion product
                b_flat = a_flat if b is a else b.dense_flat()
                c_dense, cmask, cptr = numeric.accumulate_fused_masks(
                    a_flat, b_flat, a_idx, b_idx, c_tile_id, c_cap,
                    cfg.numeric_chunk, cfg.acc(), cfg.precision)
                box["sync"] = c_dense

            with timers.phase("step2") as box:
                c_tile_row, c_tile_col = cstruct.c_tile_coords(
                    c_tile_id, c_row, c_col, c_cap,
                    packed and a.n_tile_rows < (1 << 15))
                c_nnz = int(cptr[-1])             # size feedback #3
                box["sync"] = cmask
        else:
            with timers.phase("step2") as box:
                c_tile_row, c_tile_col, cmask, cptr, _pair_ptr = \
                    cstruct.c_masks(a.masks, b_tmasks, a_idx, b_idx,
                                    c_tile_id, c_row, c_col, c_cap)
                c_nnz = int(cptr[-1])             # size feedback #3
                box["sync"] = cmask

            with timers.phase("step3") as box:
                a_dense = numeric.densify_tiles(
                    a.vals, a.rowcol, a.elem_tile, a.tile_cap)
                b_dense = a_dense if b is a else numeric.densify_tiles(
                    b.vals, b.rowcol, b.elem_tile, b.tile_cap)
                c_dense = numeric.accumulate_dense(
                    a_dense, b_dense, a_idx, b_idx, c_tile_id, c_cap,
                    cfg.numeric_chunk, cfg.acc(), cfg.precision)
                del a_dense, b_dense
                box["sync"] = c_dense
        del c_row, c_col, a_idx, b_idx, c_tile_id

        # the per-nnz derivation is timed, as the reference times its
        # step 2c and its compressed value writes
        c_nnz_cap = round_up_bucket(c_nnz)
        with timers.phase("step2") as box:        # ref step 2c
            c_rowcol, c_elem_tile = cstruct.c_rowcol(cmask, cptr, c_nnz_cap)
            box["sync"] = c_rowcol
        with timers.phase("step3") as box:        # ref step 3's compressed emit
            c_vals = numeric.extract_values(
                c_dense, c_rowcol, c_elem_tile).to(cfg.dtype)
            box["sync"] = c_vals

        return SpGEMMResult(
            vals=c_vals, shape=shape, c_nnz=c_nnz, n_pairs=n_pairs,
            engine=engine, c_tile_row=c_tile_row, c_tile_col=c_tile_col,
            cmask=cmask, cptr=cptr, rowcol=c_rowcol, elem_tile=c_elem_tile,
            c_ntiles=c_ntiles)

    def _macro(self, a, b, timers: PhaseTimers) -> SpGEMMResult:
        """Macro128 engine (ops/macro.py): dense 128x128 tile products.
        step1 = pair expansion sorted by C tile (two size feedbacks);
        step3 = fused numeric + structural accumulation through
        ``macro_kernels.accumulate_macro_pairs`` (the pair-stream kernel
        for CUDA tiles, the plain chunked batched product and scatter-add
        for CPU tiles); step2 = tile coordinates + the exact-nnz scan and
        its size feedback."""
        from pem_spgemm_tpu_torch.ops import cstruct, macro as M, symbolic
        from pem_spgemm_tpu_torch.ops.macro_kernels import (
            accumulate_macro_pairs, operand_masks)
        from pem_spgemm_tpu_torch.ops.scanops import can_pack
        cfg = self.config
        am, bm = macro_operands(a, b)
        if am.dense.dtype == torch.bfloat16 and cfg.acc() != torch.float32:
            raise NotImplementedError(
                "bfloat16 tiles on the Macro128 engine accumulate in float32: "
                "pass acc_dtype=torch.float32")
        shape = (a.shape[0], b.shape[1])

        with timers.phase("step1") as box:
            offsets = symbolic.pair_counts(am.tile_col, bm.tile_rowptr,
                                           am.ntiles)
            n_pairs = int(offsets[-1])        # size feedback #1
            if n_pairs == 0:
                return _empty_result(shape, "macro", am.device,
                                     cfg.acc())
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
            # bfloat16 tiles run as their float32 copies (made once, cached
            # on the operands); C stays in the accumulation dtype.  The
            # tables' masks are made here, once an operand, and kept with
            # it for the steady plan's multiplies
            c_dense, c_flags = accumulate_macro_pairs(
                am.acc_dense(), bm.acc_dense(), a_idx, b_idx, c_tile_id,
                c_cap, chunk=chunk, acc_dtype=cfg.acc(),
                precision=cfg.precision, tile_masks=operand_masks(am, bm))
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
                                     a.device, self.config.dtype)

        with timers.phase("step3") as box:
            out = plan.run(a, b)
            box["sync"] = out[1]

        with timers.phase("step2"):
            c_nnz = int(out[2])               # the one D2H feedback

        # bfloat16 bands multiply as float32 (ops.dia.DiaPlan): C is rounded
        # to the bands' dtype here
        return SpGEMMResult(
            vals=out[0].to(a.bands.dtype), shape=(a.shape[0], b.shape[1]),
            c_nnz=c_nnz,
            n_pairs=len(plan.offs_a) * len(plan.offs_b), engine="dia",
            c_counts=out[1], dia_dc=plan.dc_list)

    def _element(self, a: TiledMatrix, b: TiledMatrix,
                 timers: PhaseTimers) -> SpGEMMResult:
        """Element-level engine: flop-proportional.

        The float32 production path is the binned engine
        (``_element_binned``).  ``element_impl="merge"`` and every other
        dtype (the f64 parity mode) take the merge engine
        (ops/element.py): float32 through the gather-free merge pipeline,
        wider dtypes through the gather-based expansion, which keeps the
        native dtype end to end (double accumulation, as the reference's
        ValueType=double).  step1 = product offsets and the count's
        device-to-host copy; step3 = expansion, sort and (float32)
        reduction; step2 = the distinct count's copy and (wide) the
        reduction."""
        from pem_spgemm_tpu_torch.config import round_up_bucket
        from pem_spgemm_tpu_torch.ops import element
        cfg = self.config
        if cfg.element_impl == "binned" and cfg.dtype == torch.float32:
            return self._element_binned(a, b, timers)
        if cfg.element_impl not in ("binned", "merge"):
            raise ValueError(f"unknown element_impl {cfg.element_impl!r}")
        shape = (a.shape[0], b.shape[1])

        with timers.phase("step1") as box:
            b_rowptr, _b_rows, b_cols, b_vals = b.element_csr()
            a_rows, a_cols = a.element_coords()
            offsets = element.product_offsets(a_cols,
                                              b_rowptr[1:] - b_rowptr[:-1])
            n_products = int(offsets[-1])         # size feedback #1
            if n_products == 0:
                return _empty_result(shape, "element", a.device, cfg.dtype)
            box["sync"] = offsets

        wide = cfg.dtype.itemsize > 4
        with timers.phase("step3") as box:
            # chunk-granular capacity: a pow2 bucket would pad every
            # stream pass by up to 2x
            chunk = cfg.numeric_chunk
            p_cap = max(chunk, -(-n_products // chunk) * chunk)
            if wide:
                ci, cj, cv, out_id, c_nnz_dev = \
                    element.expand_sorted_products(
                        offsets, a_rows, a_cols, a.vals, b_rowptr, b_cols,
                        b_vals, n_products, p_cap)
                box["sync"] = cv
            else:
                rows, cols, vals, first, c_nnz_dev = \
                    element.expand_reduce_products(
                        offsets, a_rows, a_cols, a.vals, b_rowptr, b_cols,
                        b_vals, n_products, p_cap)
                box["sync"] = vals

        with timers.phase("step2") as box:
            c_nnz = int(c_nnz_dev)                # size feedback #2
            if wide:
                rows, cols, vals = element.reduce_products(
                    ci, cj, cv, out_id, round_up_bucket(max(1, c_nnz)))
                first = None
                box["sync"] = vals

        return SpGEMMResult(
            vals=vals.to(cfg.dtype), shape=shape, c_nnz=c_nnz,
            n_pairs=n_products, engine="element", rows=rows, cols=cols,
            first=first)

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
                                     a.device, self.config.dtype)
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
