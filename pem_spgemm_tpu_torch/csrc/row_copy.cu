// Row copy at dynamic source and destination rows:
//
//     out[dst[k]] = table[src[k]]      for k in [0, n_rows)
//
// Hopper counterpart of the JAX package's DMA issue-rate probe
// scripts/pallas_probe3.py (probe_hbm2hbm / kernel): there each grid step
// starts 256 row copies HBM -> HBM at scalar-prefetched indices and waits on
// 256 DMA semaphores.  It is a probe of the memory system, not part of the
// SpGEMM path, and no path of the port launches it.
//
// On the card a copy is not a DMA: one warp moves one row, 16 bytes a lane
// (a row of W int32 is W / 4 int4 words, lanes on neighbouring words), so a
// warp's loads and stores are whole 512-byte segments.  What bounds it on an
// H100: device memory, each row read once and written once (2 * n_rows * W
// * 4 bytes at 3.35 TB/s); the indices add 8 bytes a row.
//
// Plain C interface, no PyTorch headers: the wrapper
// (bench/probe.py) allocates the output, passes raw pointers and the
// current stream, and raises if the returned cudaError_t is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;    // 8 rows a block

__global__ void __launch_bounds__(THREADS)
row_copy_kernel(const int4* __restrict__ table, const int* __restrict__ src,
                const int* __restrict__ dst, int4* __restrict__ out,
                long long n_rows, int w4) {
    const long long row = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= n_rows) return;
    const long long s = (long long)__ldg(src + row) * w4;
    const long long d = (long long)__ldg(dst + row) * w4;
    for (int c = lane; c < w4; c += 32) out[d + c] = __ldg(table + s + c);
}

}  // namespace

// table (n_table, w) and out (n_out, w) int32, row-major, contiguous, 16-byte
// aligned, w a multiple of 4 (the wrapper checks these); src and dst
// (n_rows) int32 rows of table and out (the caller's duty).
extern "C" int row_copy_i32(const void* table, const void* src,
                            const void* dst, void* out, long long n_rows,
                            int w, void* stream) {
    if (n_rows <= 0) return (int)cudaSuccess;
    const long long blocks = (n_rows * 32 + THREADS - 1) / THREADS;
    row_copy_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)table, (const int*)src, (const int*)dst, (int4*)out,
        n_rows, w / 4);
    return (int)cudaGetLastError();
}
