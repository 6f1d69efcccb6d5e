// Macro128 accumulation: C tiles as sums of 128x128x128 tile products.
//
//     C[row] = sum over the row's pairs q of  A[a0 + a_tab[q]] @ B[b0 + b_tab[q]]
//     F[row] = 1 where any product of two stored (non-zero) entries lands
//
// Hopper counterparts of the JAX package's Macro128 kernels:
//   * `macro_accumulate_pairs_f32` replaces ops/pallas_macro2.py
//     (accumulate_macro_pipelined / _kernel): a pair stream sorted by C tile,
//     one C tile a thread block, its pairs found from segment offsets;
//   * `macro_class_ragged_f32` replaces ops/pallas_stencil.py class_call2 /
//     _kernel2: one signature class, tile (step s, tt) = the pairs
//     [p_ptr[tt], p_ptr[tt+1]) of the class's offset tables at the step's
//     bases ab_bases[2s], ab_bases[2s+1];
//   * `macro_class_uniform_f32` replaces class_call / _kernel of the same
//     file: the same with p pairs for every tile, so no p_ptr table.
//
// The TPU kernels run their grid in order on one core and so chain state from
// step to step (a spill carry, windows of the pair stream in scalar memory,
// double-buffered window copies, one compiled kernel a class because every
// offset is a compile-time constant).  Here blocks run in parallel and in no
// order, and OWNERSHIP does the work: a block owns one C tile, walks that
// tile's pairs in stream order with the tile's 128x128 sums in registers
// (8x8 a thread, 256 threads), and stores values and flags once.  No atomics,
// no zero-fill pass, no carry; a tile without pairs is stored as zeros.  All
// offsets are run-time int32 tables, so one build serves every plan, and
// every tile address is 64-bit (113k C tiles are 1.85e9 floats).
//
// The product is a shared-memory tiled SGEMM in FP32 FMA (the reference
// accumulates at precision "highest"; no TF32, no tensor cores): per pair,
// eight k-slabs of 16; the A slab is staged transposed, the B slab as it
// lies, and a thread multiplies an 8-row by 8-column register tile.  The
// structural pattern costs no second accumulator: per k-slab each (k, 8-row
// group) of A and (k, 8-column group) of B is reduced once to an 8-bit
// non-zero mask, and a thread ORs the 8x8 outer product of its two masks into
// 64 bits with two integer multiplies (the A mask is stored with one bit a
// byte, so mask_a * mask_b has no carries between bytes).
//
// What bounds them on an H100: 2 * 128^3 operations a pair against 64 KB of
// operand tile a pair at most (fewer where tiles repeat) and 80 KB of C tile
// written once: operations, at the FP32 rate outside the tensor cores.  A
// plain SGEMM of this shape reaches a fraction of that rate (PERF.md has the
// measurements); wgmma with a 3xTF32 split, TMA staging and skipping of empty
// k-slabs are later work.
//
// Plain C interface, no PyTorch headers: the wrappers
// (ops/macro_kernels.py) allocate the outputs, pass raw pointers and the
// current stream, and raise if the returned cudaError_t is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr long long TILE_ELEMS = (long long)TILE * TILE;
constexpr int THREADS = 256;    // 16 x 16 threads, an 8 x 8 register tile each
constexpr int KB = 16;          // k-slab depth
constexpr int A_LD = TILE + 4;  // padded row of the transposed A slab

struct alignas(16) Slab {       // rows are read as float4
    alignas(16) float a[KB][A_LD];  // a[k][i] = A[i][k0 + k]
    alignas(16) float b[KB][TILE];  // b[k][j] = B[k0 + k][j]
    uint2 am[KB][16];           // non-zero mask of 8 A rows, one bit a byte
    unsigned bm[KB][16];        // non-zero mask of 8 B columns, bits 0..7
};

__device__ __forceinline__ unsigned nz(float x) { return x != 0.f ? 1u : 0u; }

// Thread (ty, tx) owns C rows 4*ty + {0..3} and 64 + 4*ty + {0..3}, columns
// 4*tx + {0..3} and 64 + 4*tx + {0..3}.  Its pattern bits: byte i of `lo`
// is row 4*ty + i, byte i of `hi` row 64 + 4*ty + i; bit j of a byte is
// column 4*tx + j (j < 4) or 64 + 4*tx + j - 4.
__device__ void tile_product(const float* __restrict__ a_dense,
                             const float* __restrict__ b_dense,
                             const int* __restrict__ a_tab,
                             const int* __restrict__ b_tab,
                             long long a0, long long b0, int n_pairs,
                             float* __restrict__ c_num,
                             unsigned char* __restrict__ c_flag, Slab& s) {
    const int t = threadIdx.x;
    const int tx = t & 15, ty = t >> 4;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    unsigned plo = 0u, phi = 0u;

    for (int q = 0; q < n_pairs; ++q) {
        const float* ap = a_dense + (a0 + a_tab[q]) * TILE_ELEMS;
        const float* bp = b_dense + (b0 + b_tab[q]) * TILE_ELEMS;
        for (int k0 = 0; k0 < TILE; k0 += KB) {
            // stage: 128 rows x 16 k of A (transposed), 16 k x 128 of B
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = (t >> 2) + 64 * h, q4 = t & 3;
                const float4 v = *reinterpret_cast<const float4*>(
                    ap + row * TILE + k0 + 4 * q4);
                s.a[4 * q4 + 0][row] = v.x;
                s.a[4 * q4 + 1][row] = v.y;
                s.a[4 * q4 + 2][row] = v.z;
                s.a[4 * q4 + 3][row] = v.w;
                const int kk = (t >> 5) + 8 * h, c4 = t & 31;
                *reinterpret_cast<float4*>(&s.b[kk][4 * c4]) =
                    *reinterpret_cast<const float4*>(
                        bp + (k0 + kk) * TILE + 4 * c4);
            }
            __syncthreads();
            {   // one (k, group) mask of each operand a thread
                const int kk = t >> 4, g = t & 15;
                float4 x = *reinterpret_cast<const float4*>(&s.a[kk][4 * g]);
                float4 y = *reinterpret_cast<const float4*>(
                    &s.a[kk][64 + 4 * g]);
                s.am[kk][g] = make_uint2(
                    nz(x.x) | nz(x.y) << 8 | nz(x.z) << 16 | nz(x.w) << 24,
                    nz(y.x) | nz(y.y) << 8 | nz(y.z) << 16 | nz(y.w) << 24);
                x = *reinterpret_cast<const float4*>(&s.b[kk][4 * g]);
                y = *reinterpret_cast<const float4*>(&s.b[kk][64 + 4 * g]);
                s.bm[kk][g] =
                    nz(x.x) | nz(x.y) << 1 | nz(x.z) << 2 | nz(x.w) << 3 |
                    nz(y.x) << 4 | nz(y.y) << 5 | nz(y.z) << 6 | nz(y.w) << 7;
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < KB; ++kk) {
                const float4 a_lo =
                    *reinterpret_cast<const float4*>(&s.a[kk][4 * ty]);
                const float4 a_hi =
                    *reinterpret_cast<const float4*>(&s.a[kk][64 + 4 * ty]);
                const float4 b_lo =
                    *reinterpret_cast<const float4*>(&s.b[kk][4 * tx]);
                const float4 b_hi =
                    *reinterpret_cast<const float4*>(&s.b[kk][64 + 4 * tx]);
                const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                                     a_hi.x, a_hi.y, a_hi.z, a_hi.w};
                const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                                     b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
                const uint2 ma = s.am[kk][ty];
                const unsigned mb = s.bm[kk][tx];
                plo |= ma.x * mb;
                phi |= ma.y * mb;
            }
            __syncthreads();
        }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int row = (i < 4 ? 4 * ty + i : 64 + 4 * ty + (i - 4));
        const unsigned bits = ((i < 4 ? plo : phi) >> (8 * (i & 3))) & 0xFFu;
        float* cr = c_num + row * TILE;
        unsigned char* fr = c_flag + row * TILE;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int col = 64 * h + 4 * tx;
            *reinterpret_cast<float4*>(cr + col) = make_float4(
                acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                acc[i][4 * h + 3]);
            const unsigned x = (bits >> (4 * h)) & 0xFu;
            *reinterpret_cast<unsigned*>(fr + col) =
                (x & 1u) | (x & 2u) << 7 | (x & 4u) << 14 | (x & 8u) << 21;
        }
    }
}

// One block a C tile of a pair stream sorted by C tile: tile c owns the
// pairs [seg_ptr[c], seg_ptr[c + 1]).  Padding pairs lie past seg_ptr[c_cap]
// and are never read.
__global__ void __launch_bounds__(THREADS, 2)
macro_pairs_kernel(const float* __restrict__ a_dense,
                   const float* __restrict__ b_dense,
                   const int* __restrict__ a_idx,
                   const int* __restrict__ b_idx,
                   const int* __restrict__ seg_ptr,
                   float* __restrict__ c_num,
                   unsigned char* __restrict__ c_flag) {
    __shared__ Slab s;
    const long long c = blockIdx.x;
    const int lo = seg_ptr[c], hi = seg_ptr[c + 1];
    tile_product(a_dense, b_dense, a_idx + lo, b_idx + lo, 0, 0, hi - lo,
                 c_num + c * TILE_ELEMS, c_flag + c * TILE_ELEMS, s);
}

// One block a (step, tile) of a signature class.  RAGGED: the tile's pairs
// are [p_ptr[tt], p_ptr[tt + 1]) of the offset tables; else p pairs a tile.
template <bool RAGGED>
__global__ void __launch_bounds__(THREADS, 2)
macro_class_kernel(const float* __restrict__ a_dense,
                   const float* __restrict__ b_dense,
                   const int* __restrict__ ab_bases,
                   const int* __restrict__ p_ptr,
                   const int* __restrict__ a_offs,
                   const int* __restrict__ b_offs, int t, int p,
                   long long base, float* __restrict__ c_num,
                   unsigned char* __restrict__ c_flag) {
    __shared__ Slab s;
    const int step = blockIdx.x / t, tt = blockIdx.x % t;
    const int lo = RAGGED ? p_ptr[tt] : tt * p;
    const int n = RAGGED ? p_ptr[tt + 1] - lo : p;
    const long long row = base + (long long)blockIdx.x;
    tile_product(a_dense, b_dense, a_offs + lo, b_offs + lo,
                 ab_bases[2 * step], ab_bases[2 * step + 1], n,
                 c_num + row * TILE_ELEMS, c_flag + row * TILE_ELEMS, s);
}

}  // namespace

// c_num (c_cap, 128, 128) f32 and c_flag (c_cap, 128, 128) u8 are written
// whole; seg_ptr has c_cap + 1 entries.
extern "C" int macro_accumulate_pairs_f32(
        const float* a_dense, const float* b_dense, const int* a_idx,
        const int* b_idx, const int* seg_ptr, float* c_num,
        unsigned char* c_flag, int c_cap, cudaStream_t stream) {
    if (c_cap <= 0) return (int)cudaSuccess;
    macro_pairs_kernel<<<c_cap, THREADS, 0, stream>>>(
        a_dense, b_dense, a_idx, b_idx, seg_ptr, c_num, c_flag);
    return (int)cudaGetLastError();
}

// Slab rows [base, base + n_steps * t) of c_num / c_flag are written whole.
extern "C" int macro_class_ragged_f32(
        const float* a_dense, const float* b_dense, const int* ab_bases,
        const int* p_ptr, const int* a_offs, const int* b_offs, int t,
        int n_steps, long long base, float* c_num, unsigned char* c_flag,
        cudaStream_t stream) {
    if (n_steps <= 0 || t <= 0) return (int)cudaSuccess;
    macro_class_kernel<true><<<n_steps * t, THREADS, 0, stream>>>(
        a_dense, b_dense, ab_bases, p_ptr, a_offs, b_offs, t, 0, base,
        c_num, c_flag);
    return (int)cudaGetLastError();
}

extern "C" int macro_class_uniform_f32(
        const float* a_dense, const float* b_dense, const int* ab_bases,
        const int* a_offs, const int* b_offs, int t, int p, int n_steps,
        long long base, float* c_num, unsigned char* c_flag,
        cudaStream_t stream) {
    if (n_steps <= 0 || t <= 0) return (int)cudaSuccess;
    macro_class_kernel<false><<<n_steps * t, THREADS, 0, stream>>>(
        a_dense, b_dense, ab_bases, nullptr, a_offs, b_offs, t, p, base,
        c_num, c_flag);
    return (int)cudaGetLastError();
}
