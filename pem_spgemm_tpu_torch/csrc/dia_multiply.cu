// DIA SpGEMM over diagonal-band operands:
//
//     C[d1 + d2][i]  +=  A[d1][i] * B[d2][i + d1]
//
// and the same sum over the bands' 0/1 masks (the exact structural counts).
// Hopper counterpart of the JAX package's ops/pallas_dia.py
// (dia_multiply_pallas): entry `dia_multiply_dense_f32` replaces its
// mode="dense" kernels (_kernel, _kernel_values) and `dia_multiply_pairs_f32`
// its mode="pairs" kernels (_kernel_pairs, _kernel_pairs_values).
//
// Both entries are GATHERS: a thread owns output elements C[row][i], loops
// over the band pairs that land there in ascending A-band order, and writes
// the value (and the count) once.  No atomics, no zero-fill pass, and the
// band offsets are run-time data (small int32 tables), so one compiled
// kernel serves every matrix.  A B column outside [0, n_k) contributes
// zero through a bounds test; the operands are never padded.
//
// What bounds them on an H100: device memory needs A and B read once and C
// (and the counts) written once; the arithmetic needs 2 operations a
// product (4 with counts).  Only the widest stencil (128 x 128 bands) has
// enough products per byte for the fp32 rate to be the larger bound.  In
// these kernels the cost is neither: every product loads its B element (and,
// in the pairs entry, its A element) again through L1, so the load pipe and
// the latency of its misses set the time, several times the bound at the
// wide stencils (PERF.md has the measurements).  What the dense entry does
// about it: each thread owns ROWS consecutive C rows of one column, so the A
// element is loaded once for ROWS products, and a warp's B loads at one A
// band are ROWS coalesced row segments of which ROWS-1 were touched at the
// previous band, so they hit in L1; where all ROWS bands exist (most steps
// of a wide stencil) the inner loop has no test and steps one pointer.
// Staging the B window in shared memory is the next step and is not done
// here.  The pairs entry makes no assumption about the offsets (a gapped set
// has an unbounded span), so it keeps to one C row per thread and the
// caches.
//
// Plain C interface, no PyTorch headers: the wrapper
// (ops/dia_kernels.py) allocates the outputs, passes raw pointers and the
// current stream, and raises if the returned cudaError_t is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;    // columns per block
constexpr int ROWS = 8;         // C rows per thread in the dense entry

// Dense entry.  B's offsets are the integer range [min_b, min_b + d2) and
// the C rows are the dense sum range starting at dc0 = offs_a[0] + min_b,
// so the B band of product (k1, C row r) is arithmetic:
//     k2 = (dc0 + r) - offs_a[k1] - min_b.
// offs_a is any ascending set whose sums with B's range leave no gap.
template <bool COUNTS>
__global__ void __launch_bounds__(THREADS)
dia_dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const int* __restrict__ offs_a, float* __restrict__ c,
                 float* __restrict__ cnt, int d1n, int d2n, int dcn,
                 long long n_i, long long n_k, long long n_out) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    const int r0 = blockIdx.y * ROWS;
    if (i >= n_out) return;
    const int a0 = offs_a[0];
    float acc[ROWS];
    float num[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) { acc[r] = 0.f; num[r] = 0.f; }
    for (int k1 = 0; k1 < d1n; ++k1) {
        const int d1 = offs_a[k1];
        // B band of this block's first row; uniform over the block
        const int k2lo = r0 - (d1 - a0);
        if (k2lo + ROWS <= 0 || k2lo >= d2n) continue;
        const long long j = i + d1;
        if (j < 0 || j >= n_k) continue;
        const float av = a[(long long)k1 * n_i + i];
        const float am = av != 0.f ? 1.f : 0.f;
        if (k2lo >= 0 && k2lo + ROWS <= d2n) {
            // all ROWS bands exist (most steps of a wide stencil): no test
            // a row, one pointer stepped by the band stride
            const float* bp = b + (long long)k2lo * n_k + j;
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const float bv = *bp;
                bp += n_k;
                acc[r] = fmaf(av, bv, acc[r]);
                if (COUNTS) num[r] += bv != 0.f ? am : 0.f;
            }
        } else {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const int k2 = k2lo + r;
                if (k2 >= 0 && k2 < d2n) {
                    const float bv = b[(long long)k2 * n_k + j];
                    acc[r] = fmaf(av, bv, acc[r]);
                    if (COUNTS) num[r] += bv != 0.f ? am : 0.f;
                }
            }
        }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        if (r0 + r < dcn) {
            c[(long long)(r0 + r) * n_out + i] = acc[r];
            if (COUNTS) cnt[(long long)(r0 + r) * n_out + i] = num[r];
        }
    }
}

// Pairs entry.  Any offset sets: the products of C row r are the triples
// trip[3 * p + {0, 1, 2}] = (k1, k2, d1) for p in [row_ptr[r], row_ptr[r+1]),
// in ascending k1.
template <bool COUNTS>
__global__ void __launch_bounds__(THREADS)
dia_pairs_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const int* __restrict__ row_ptr,
                 const int* __restrict__ trip, float* __restrict__ c,
                 float* __restrict__ cnt, int dcn, long long n_i,
                 long long n_k, long long n_out) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n_out) return;
    for (int r = blockIdx.y; r < dcn; r += gridDim.y) {
        float acc = 0.f;
        float num = 0.f;
        const int p1 = row_ptr[r + 1];
        for (int p = row_ptr[r]; p < p1; ++p) {
            const int k1 = trip[3 * p];
            const int k2 = trip[3 * p + 1];
            const long long j = i + trip[3 * p + 2];
            if (j < 0 || j >= n_k) continue;
            const float av = a[(long long)k1 * n_i + i];
            const float bv = b[(long long)k2 * n_k + j];
            acc = fmaf(av, bv, acc);
            if (COUNTS) num += (av != 0.f && bv != 0.f) ? 1.f : 0.f;
        }
        c[(long long)r * n_out + i] = acc;
        if (COUNTS) cnt[(long long)r * n_out + i] = num;
    }
}

}  // namespace

// a (d1n, n_i), b (d2n, n_k), c and cnt (dcn, n_out) float32, row-major and
// contiguous; offs_a (d1n) int32 ascending.  cnt == nullptr selects the
// values-only kernel.  Requires n_out <= n_i, and (dcn + ROWS - 1) / ROWS
// <= 65535 (the wrapper checks both).
extern "C" int dia_multiply_dense_f32(const void* a, const void* b,
                                      const void* offs_a, void* c, void* cnt,
                                      int d1n, int d2n, int dcn,
                                      long long n_i, long long n_k,
                                      long long n_out, void* stream) {
    dim3 grid((unsigned)((n_out + THREADS - 1) / THREADS),
              (unsigned)((dcn + ROWS - 1) / ROWS));
    cudaStream_t s = (cudaStream_t)stream;
    if (cnt != nullptr) {
        dia_dense_kernel<true><<<grid, THREADS, 0, s>>>(
            (const float*)a, (const float*)b, (const int*)offs_a, (float*)c,
            (float*)cnt, d1n, d2n, dcn, n_i, n_k, n_out);
    } else {
        dia_dense_kernel<false><<<grid, THREADS, 0, s>>>(
            (const float*)a, (const float*)b, (const int*)offs_a, (float*)c,
            nullptr, d1n, d2n, dcn, n_i, n_k, n_out);
    }
    return (int)cudaGetLastError();
}

// row_ptr (dcn + 1) int32, trip (3 * row_ptr[dcn]) int32; the rest as above.
extern "C" int dia_multiply_pairs_f32(const void* a, const void* b,
                                      const void* row_ptr, const void* trip,
                                      void* c, void* cnt, int dcn,
                                      long long n_i, long long n_k,
                                      long long n_out, void* stream) {
    dim3 grid((unsigned)((n_out + THREADS - 1) / THREADS),
              (unsigned)(dcn < 65535 ? dcn : 65535));
    cudaStream_t s = (cudaStream_t)stream;
    if (cnt != nullptr) {
        dia_pairs_kernel<true><<<grid, THREADS, 0, s>>>(
            (const float*)a, (const float*)b, (const int*)row_ptr,
            (const int*)trip, (float*)c, (float*)cnt, dcn, n_i, n_k, n_out);
    } else {
        dia_pairs_kernel<false><<<grid, THREADS, 0, s>>>(
            (const float*)a, (const float*)b, (const int*)row_ptr,
            (const int*)trip, (float*)c, nullptr, dcn, n_i, n_k, n_out);
    }
    return (int)cudaGetLastError();
}
