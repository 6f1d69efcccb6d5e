"""Benchmark harness: WARMUP + REPEAT protocol with per-phase timing.

Mirrors the reference's measurement protocol:
  * conversion timed separately from the SpGEMM pipeline;
  * WARMUP iterations discarded, REPEAT iterations aggregated by mean
    (or min with fastest=True, the reference's -DFASTEST);
  * flop / GFlops / compression_ratio definitions identical (utils/flops.py);
  * kernel vs malloc split: kernel time is the in-phase (device + sync)
    time, malloc time is the residual host orchestration.

Three tiers are reported: interactive (plan + multiply + c_nnz feedback per
iteration, the CSV's pem_spgemm_time), steady (the cached plan replayed, one
sync per iteration) and pipelined (replays queued back to back, one sync at
the end).  The element, dia, macro and auto branches are ported, in
float32 and in float64 (the f64 parity mode: the merge element engine and
the kernels' float64 entries).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from pem_spgemm_tpu_torch.config import (SpGEMMConfig, DEFAULT_CONFIG,
                                         resolve_device)
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops.convert import coo_to_tiled
from pem_spgemm_tpu_torch.ops.spgemm import SpGEMM, SpGEMMResult, not_ported
from pem_spgemm_tpu_torch.utils.flops import (spgemm_flops, gflops,
                                              compression_ratio)
from pem_spgemm_tpu_torch.utils.timing import PhaseTimers, force_sync
from pem_spgemm_tpu_torch.utils.csv_report import (BenchmarkRecord,
                                                   append_csv, matrix_name,
                                                   report_stdout)


def _inflight_bound(gen_bytes: int, device: torch.device) -> int:
    """How many queued multiplies may hold their outputs at once: half of
    what the device reports free (plus what the caching allocator holds
    but has not handed out) divided by one generation's outputs, within
    [1, 16].  The CPU runs synchronously, so the bound is 1 there."""
    if device.type != "cuda":
        return 1
    free, _total = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    return max(1, min(16, int((free // 2) // max(1, gen_bytes))))


def run_benchmark(coo: COOMatrix, name: str,
                  config: SpGEMMConfig = DEFAULT_CONFIG,
                  aat: bool = False,
                  csv_path: Optional[str] = None,
                  verbose: bool = True,
                  device=None):
    """Benchmark C = A@A (or A@A.T with aat=True) on one matrix.

    ``device=None`` means the GPU and raises without one.
    Returns (BenchmarkRecord, SpGEMMResult of the last iteration).
    """
    cfg = config
    dev = resolve_device(device)
    if cfg.engine not in ("auto", "element", "dia", "macro"):
        raise not_ported(cfg.engine)

    # --- conversion (timed once, like the reference) ---
    # The host-to-device copy of the triplets is timed apart from the
    # conversion itself: it lands in the total overhead, not in the
    # A/B_conversion columns.
    t_conv0 = time.perf_counter()
    b_coo = coo.transpose() if aat else coo

    def _to_device(c):
        d = COOMatrix(
            torch.as_tensor(c.rows).to(device=dev, dtype=torch.int32),
            torch.as_tensor(c.cols).to(device=dev, dtype=torch.int32),
            torch.as_tensor(c.vals).to(device=dev, dtype=cfg.dtype),
            c.shape)
        force_sync(d.vals)
        return d

    coo_dev = _to_device(coo)
    b_coo_dev = coo_dev if not aat else _to_device(b_coo)

    # Structural dispatch at the conversion layer (the DIA census operates
    # on COO, before any tiling): explicit engine "dia", or "auto" when the
    # distinct-diagonal census qualifies.
    from pem_spgemm_tpu_torch.ops.dia import detect_dia, coo_to_dia
    dia_offs = dia_offs_b = None
    if cfg.engine in ("dia", "auto"):
        dia_offs = detect_dia(coo_dev, max_bands=cfg.dia_max_bands)
        if dia_offs is not None and aat:
            dia_offs_b = detect_dia(b_coo_dev, max_bands=cfg.dia_max_bands)
            if dia_offs_b is None:
                dia_offs = None
        if cfg.engine == "dia" and dia_offs is None:
            raise ValueError(
                "engine='dia' but the matrix does not qualify (diagonal "
                "census exceeds dia_max_bands, or explicit zeros present)")

    # Conversion runs twice; the kernel columns report the SECOND run, so
    # one-time costs (allocator growth, lazy CUDA initialisation) stay out
    # of the columns.  The first run's cost is still visible in
    # total_conversion_overhead_time.
    element_f32 = cfg.engine == "element" and cfg.dtype == torch.float32
    t_a = t_b = None
    a = b = None
    for _rep in range(2):
        # release the previous rep's converted operands first
        a = b = None
        if dia_offs is not None:
            t0 = time.perf_counter()
            a = coo_to_dia(coo_dev, dtype=cfg.dtype, offsets=dia_offs)
            force_sync(a.bands)
            t_a = time.perf_counter() - t0
            t0 = time.perf_counter()
            b = a if not aat else coo_to_dia(b_coo_dev, dtype=cfg.dtype,
                                             offsets=dia_offs_b)
            force_sync(b.bands)
            t_b = time.perf_counter() - t0
            continue
        if cfg.engine == "macro":
            # macro-dispatched workloads convert straight to Macro128 (the
            # Tile16 form would only hold the operand a second time)
            from pem_spgemm_tpu_torch.ops.convert import coo_to_macro
            t0 = time.perf_counter()
            a = coo_to_macro(coo_dev, dtype=cfg.dtype)
            force_sync(a.dense)
            t_a = time.perf_counter() - t0
            t0 = time.perf_counter()
            b = a if not aat else coo_to_macro(b_coo_dev, dtype=cfg.dtype)
            force_sync(b.dense)
            t_b = time.perf_counter() - t0
            continue
        t0 = time.perf_counter()
        a = coo_to_tiled(coo_dev, dtype=cfg.dtype)
        if element_f32:
            force_sync(a.element_csr()[2])   # row-sorted element CSR
        force_sync(a.vals)
        t_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = coo_to_tiled(b_coo_dev, dtype=cfg.dtype, with_tmasks=True)
        if element_f32:
            # the B chunk table is a converted-format product
            from pem_spgemm_tpu_torch.ops.binned import chunk_b
            force_sync(chunk_b(b).table)
        force_sync(b.vals)
        t_b = time.perf_counter() - t0
    t_conv_total = time.perf_counter() - t_conv0
    # Free the device COO triplets: nothing after conversion reads them.
    coo_dev = b_coo_dev = None

    # --- flop count (host) ---
    flop = spgemm_flops(coo.cols, b_coo.rows, b_coo.shape[0])

    engine = SpGEMM(cfg)

    # --- WARMUP + REPEAT ---
    for _ in range(cfg.warmup):
        result = engine(a, b)
        force_sync(result.vals)

    timers = PhaseTimers()
    wall_iters = []
    result: SpGEMMResult = None
    for i in range(cfg.repeat):
        # per-phase syncs are instrumentation the reference's device
        # events don't pay: record phase detail on the first timed
        # repeat only (see PhaseTimers.detail)
        timers.detail = i == 0
        t0 = time.perf_counter()
        result = engine(a, b, timers)
        force_sync(result.vals)
        wall_iters.append(time.perf_counter() - t0)
    timers.detail = True

    # HEADLINE methodology matches the reference: pem_spgemm_time is the
    # per-iteration wall time of the full pipeline INCLUDING host-side
    # allocation and the size feedbacks.  GFlops derives from this time.
    interactive = min(wall_iters) if cfg.fastest else \
        sum(wall_iters) / len(wall_iters)
    # phase columns come from the detailed repeat (one iteration)
    s1 = timers.pick("step1", cfg.fastest, 1)
    s2 = timers.pick("step2", cfg.fastest, 1)
    s3 = timers.pick("step3", cfg.fastest, 1)
    kernel = s1 + s2 + s3
    malloc = max(0.0, interactive - kernel)

    # the steady tiers replay a plan; an empty product has none
    steady = pipelined = 0.0
    if result.n_pairs > 0:
        steady, pipelined = _steady_tiers(result, cfg, a, b, dev)

    record = BenchmarkRecord(
        matrix=matrix_name(name),
        flop=flop,
        c_nnz=result.c_nnz,
        compression_ratio=compression_ratio(flop, result.c_nnz),
        a_conversion_kernel_time=t_a * 1e3,
        b_conversion_kernel_time=t_b * 1e3,
        total_conversion_overhead_time=t_conv_total * 1e3,
        step1_time=s1 * 1e3,
        step2_time=s2 * 1e3,
        step3_time=s3 * 1e3,
        pem_spgemm_time=interactive * 1e3,
        pem_spgemm_kernel_time=kernel * 1e3,
        pem_spgemm_malloc_time=malloc * 1e3,
        gflops=gflops(flop, interactive),
        steady_state_time=steady * 1e3,
        steady_gflops=gflops(flop, steady),
        pipelined_time=pipelined * 1e3,
        pipelined_gflops=gflops(flop, pipelined),
    )
    if verbose:
        print(report_stdout(record))
    if csv_path:
        append_csv(csv_path, record)
    return record, result


def _steady_tiers(result, cfg, a, b, dev):
    """(steady, pipelined) seconds per multiply with the plan cached.

    Steady: one replay and one sync per iteration.  Pipelined: replays
    queued back to back with a sync every ``inflight`` replays and one at
    the end; the device executes them in order, so wall / replays is the
    per-multiply device time when the host keeps ahead."""
    from pem_spgemm_tpu_torch.ops.fixed import make_plan
    plan = make_plan(result, cfg, a, b)
    is_dia = result.engine == "dia"
    is_macro = result.engine == "macro"
    if is_dia or is_macro:
        # the dense C band stacks (DIA) and the multi-GB dense C tiles
        # (macro) are the big allocation: release the interactive result's
        # for the timing loops and refresh them from the last planned output
        # below
        result.vals = None
        result.c_counts = None
    out = plan.run(a, b)
    force_sync(plan.fence(out))              # warm
    for _ in range(4):
        if not bool(out[-1]):                # overflow flag
            break
        plan = plan.grown()
        out = plan.run(a, b)
        force_sync(plan.fence(out))
    else:
        raise RuntimeError("fixed-capacity plan still overflows after "
                           "4 growth steps")
    fast_iters = []
    for _ in range(cfg.repeat):
        t0 = time.perf_counter()
        out = None
        out = plan.run(a, b)
        force_sync(plan.fence(out))
        fast_iters.append(time.perf_counter() - t0)
    steady = min(fast_iters) if cfg.fastest else \
        sum(fast_iters) / len(fast_iters)

    def _probe(o):
        # a tiny reduction that depends on the multiply; holding it lets
        # the generation's large outputs go back to the allocator
        return plan.fence(o).reshape(-1)[:256].to(torch.float32).sum()

    warm_out = plan.run(a, b)
    force_sync(_probe(warm_out))
    gen_bytes = sum(x.numel() * x.element_size() for x in warm_out
                    if isinstance(x, torch.Tensor))
    inflight = _inflight_bound(gen_bytes, dev)
    reps = max(cfg.repeat, 8) if inflight >= 8 else cfg.repeat
    warm_out = None
    if not (is_dia or is_macro):
        out = None
    last = None
    t0 = time.perf_counter()
    for i in range(reps):
        last = _probe(plan.run(a, b))
        if (i + 1) % inflight == 0:
            force_sync(last)
    force_sync(last)
    pipelined = (time.perf_counter() - t0) / reps
    if is_dia:
        result.vals = out[0]
        result.c_counts = out[1]
    if is_macro:
        # a macro plan may emit another order and capacity than the
        # interactive run (the stencil plan emits slab order): the
        # coordinates are refreshed together with the values
        (result.c_tile_row, result.c_tile_col, result.vals,
         result.c_counts, result.cptr) = out[:5]
    return steady, pipelined
