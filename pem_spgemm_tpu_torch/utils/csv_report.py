"""Benchmark CSV reporting with reference schema parity.

The reference appends one row per run to pemspgemm_benchmark_result.csv with
exactly these 14 columns (README.md:52-53, writer at spgemm.cu:1424-1450):

matrix,flop,C_nnz,compression_ratio,A_conversion_kernel_time,
B_conversion_kernel_time,total_conversion_overhead_time,step1_time,
step2_time,step3_time,pem_spgemm_time,pem_spgemm_kernel_time,
pem_spgemm_malloc_time,Gflops

Times are in milliseconds (the reference reports ms).  The matrix name is
the file's basename without extension (the reference regex-extracts it at
spgemm.cu:1427-1431).
"""

from __future__ import annotations

import dataclasses
import os
import re

CSV_HEADER = ("matrix,flop,C_nnz,compression_ratio,A_conversion_kernel_time,"
              "B_conversion_kernel_time,total_conversion_overhead_time,"
              "step1_time,step2_time,step3_time,pem_spgemm_time,"
              "pem_spgemm_kernel_time,pem_spgemm_malloc_time,Gflops")


def matrix_name(path_or_name: str) -> str:
    base = os.path.basename(path_or_name)
    m = re.match(r"(.+?)(\.mtx)?$", base)
    return m.group(1) if m else base


@dataclasses.dataclass
class BenchmarkRecord:
    """One benchmark row; time fields in milliseconds."""

    matrix: str
    flop: int
    c_nnz: int
    compression_ratio: float
    a_conversion_kernel_time: float
    b_conversion_kernel_time: float
    total_conversion_overhead_time: float
    step1_time: float
    step2_time: float
    step3_time: float
    pem_spgemm_time: float
    pem_spgemm_kernel_time: float
    pem_spgemm_malloc_time: float
    gflops: float
    # Extensions beyond the reference's 14 columns (NOT written to the CSV,
    # reported on stdout): steady-state fixed-capacity replay time — the
    # production serving path with cached plans (ops/fixed.py).  The
    # reference has no such mode (it re-runs cudaMallocAsync + 3 D2H size
    # feedbacks every repeat, spgemm.cu:1135-1357), so the CSV keeps the
    # reference's per-iteration methodology for pem_spgemm_time/Gflops.
    steady_state_time: float = 0.0
    steady_gflops: float = 0.0
    # Pipelined steady state: repeat dispatches queued back-to-back with
    # ONE final sync, wall / repeats.  A per-iteration sync idles the
    # device while the host catches up; the pipelined measure amortizes
    # that across the batch, which is closer to the reference's timing
    # with DEVICE events (cudaEvent pairs, spgemm.cu:730-755).
    pipelined_time: float = 0.0
    pipelined_gflops: float = 0.0
    # The run's SpGEMMConfig.precision (not in the CSV; on stdout where it
    # is not "highest").
    precision: str = "highest"

    def csv_row(self) -> str:
        return (f"{self.matrix},{self.flop},{self.c_nnz},"
                f"{self.compression_ratio:.6g},"
                f"{self.a_conversion_kernel_time:.6g},"
                f"{self.b_conversion_kernel_time:.6g},"
                f"{self.total_conversion_overhead_time:.6g},"
                f"{self.step1_time:.6g},{self.step2_time:.6g},"
                f"{self.step3_time:.6g},{self.pem_spgemm_time:.6g},"
                f"{self.pem_spgemm_kernel_time:.6g},"
                f"{self.pem_spgemm_malloc_time:.6g},{self.gflops:.6g}")


def append_csv(path: str, record: BenchmarkRecord) -> None:
    """Append a row, writing the header if the file is new (reference
    appends unconditionally; we add the header for usability)."""
    new = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a") as f:
        if new:
            f.write(CSV_HEADER + "\n")
        f.write(record.csv_row() + "\n")


def report_stdout(record: BenchmarkRecord) -> str:
    """Human-readable per-run report (reference stdout block,
    spgemm.cu:1406-1422)."""
    r = record
    lines = [
        f"matrix                      : {r.matrix}",
        f"flop                        : {r.flop}",
        f"C nnz                       : {r.c_nnz}",
        f"compression ratio           : {r.compression_ratio:.4f}",
        f"A conversion kernel time    : {r.a_conversion_kernel_time:.4f} ms",
        f"B conversion kernel time    : {r.b_conversion_kernel_time:.4f} ms",
        f"total conversion overhead   : "
        f"{r.total_conversion_overhead_time:.4f} ms",
        f"step1 time                  : {r.step1_time:.4f} ms",
        f"step2 time                  : {r.step2_time:.4f} ms",
        f"step3 time                  : {r.step3_time:.4f} ms",
        f"pem_spgemm time             : {r.pem_spgemm_time:.4f} ms",
        f"pem_spgemm kernel time      : {r.pem_spgemm_kernel_time:.4f} ms",
        f"pem_spgemm malloc time      : {r.pem_spgemm_malloc_time:.4f} ms",
        f"GFlops                      : {r.gflops:.4f}",
    ]
    if r.steady_state_time:
        lines += [
            f"steady-state time (plan)    : {r.steady_state_time:.4f} ms",
            f"steady-state GFlops         : {r.steady_gflops:.4f}",
        ]
    if r.pipelined_time:
        lines += [
            f"pipelined time (plan)       : {r.pipelined_time:.4f} ms",
            f"pipelined GFlops            : {r.pipelined_gflops:.4f}",
        ]
    if r.precision != "highest":
        lines.append(f"precision                   : {r.precision}")
    return "\n".join(lines)
