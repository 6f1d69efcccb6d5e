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
// What bounds them on an H100: 2 * 128^3 operations a pair against 128 KB of
// operand tile a pair at most (fewer where tiles repeat) and 80 KB of C tile
// written once: operations.
//
// The pair-stream entry (tile_product) is a shared-memory tiled SGEMM in FP32
// FMA: per pair, eight k-slabs of 16; the A slab is staged transposed, the B
// slab as it lies, and a thread multiplies an 8-row by 8-column register
// tile.  Its pattern costs no second accumulator: per k-slab each (k, 8-row
// group) of A and (k, 8-column group) of B is reduced once to an 8-bit
// non-zero mask, and a thread ORs the 8x8 outer product of its two masks into
// 64 bits with two integer multiplies (the A mask is stored with one bit a
// byte, so mask_a * mask_b has no carries between bytes).
//
// The class entries (tile_product_tc) run on the tensor cores: wgmma on tf32
// operands with a 3xTF32 split, which keeps the reference's precision
// "highest" (one tf32 product keeps 11 bits of each operand; plain TF32 is not
// allowed).  Every operand x is split as hi = tf32_rna(x), lo = tf32_rna(x -
// hi), and C accumulates hi*hi + hi*lo + lo*hi: each product is then exact to
// about 2^-22 of |a*b|.  A tile's pairs are one stream of (pair, 32-deep
// k-slab) stages.  wgmma takes tf32 operands K-major only: A's tiles lie so
// (row i, contiguous k), B's do not (row k, contiguous j), so every slab
// passes through registers once: 256 threads copy it raw with cp.async two
// stages ahead (a ring of two raw 32 KB slabs), read it back, split it, and
// write A as it lies and B transposed, each into the 128-byte swizzle that
// the shared-memory descriptors name, over a ring of two split stages (4 x
// 16 KB a stage) while the tensor cores work on the other one.  Two
// warpgroups each own a 64 x 128 half of the C tile (64 f32
// registers a thread) and issue 3 x 4 wgmma.m64n128k8 a stage; the stage's
// partial is added to a second register sum in FP32 (round to nearest), so
// the tensor cores' accumulation rounds over one 32-deep slab only.  The
// pattern comes from the raw f32 values (x != 0; the tf32 hi of a subnormal
// can be 0): per stage a 32-bit k-mask of each A row and of each B column,
// and a thread ORs (mask_row & mask_col) != 0 into the 64 bits of the
// accumulator elements it owns, so values and flags are stored together.
// A slab in which a warpgroup's 64 A rows or the B slab hold no non-zero
// adds exact zeros, and the warpgroup skips it (wandering64's tiles are
// about 1/6 full); ptxas then serializes the stage's wgmma chain (warning
// C7518), which costs less than the skipped slabs save (PERF.md).  The
// skip is exact for finite tiles: an Inf or NaN that meets only zeros gives
// 0 here where a dense product gives NaN.
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

// ---------------------------------------------------------------------------
// the tensor-core tile product of the class entries

constexpr int KS = 32;                      // k-slab depth: one 128-byte row
constexpr int OPERAND = TILE * KS * 4;      // bytes of one split operand slab
constexpr int SLABS_PER_PAIR = TILE / KS;

struct alignas(1024) TcStage {              // 1024: the swizzle atom
    unsigned char a_hi[OPERAND];            // [i][k], 128-byte swizzle
    unsigned char a_lo[OPERAND];
    unsigned char b_hi[OPERAND];            // [j][k] (B transposed), the same
    unsigned char b_lo[OPERAND];
};
struct TcShared {
    TcStage stage[2];
    float raw_a[2][TILE * KS];              // raw slabs in flight: A [i][k]
    float raw_b[2][KS * TILE];              // and B [k][j]
    unsigned am[2][TILE];                   // k-mask of each A row
    unsigned bm[2][TILE];                   // k-mask of each B column
    unsigned a_any[2][8];                   // warp w's A rows: any non-zero
    unsigned b_any[2][8];                   // warp w's B columns: the same
};
constexpr int TC_SMEM = (int)sizeof(TcShared) + 1024;   // + alignment slack

__device__ __forceinline__ unsigned tf32_rna(float x) {
    unsigned r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// Byte offset of element (row, k) in a 128-row x 32-k slab with 128-byte rows
// and the 128-byte swizzle: 16-byte chunk c of row r lies at chunk
// c ^ (r % 8).
__device__ __forceinline__ unsigned swz(int row, int k) {
    return (unsigned)(row * 128 + ((((k >> 2) ^ row) & 7) << 4) + (k & 3) * 4);
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address >> 4, leading offset 1 (unused by this layout),
// stride 1024 bytes between 8-row groups, layout type 1 (128-byte swizzle).
__device__ __forceinline__ unsigned long long smem_desc(const void* p) {
    const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
    return (unsigned long long)((addr & 0x3FFFF) >> 4)
         | (1ull << 16) | ((unsigned long long)(1024 >> 4) << 32)
         | (1ull << 62);
}

// d (+)= A(64 x 8, tf32) @ B(8 x 128, tf32); scale_d = 0 ignores d's input.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           unsigned long long da,
                                           unsigned long long db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// Ties the accumulator registers to the preceding asm, so no read or write of
// them is moved across a wgmma fence or wait.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One stage's raw operands as a thread handles them: A rows 16w + l/8 + 4h,
// k-chunk l%8; B k-rows l/4 + 8h, column quad 4w + l%4 (w = warp, l = lane,
// h = 0..3).  A thread copies its 16-byte pieces into the raw slabs with
// cp.async two stages ahead and reads back exactly those pieces, so the raw
// ring needs no barrier of its own.
struct TcRegs {
    float4 a[4];
    float4 b[4];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void tc_issue(float* ra, float* rb,
                                         const float* ap, const float* bp,
                                         int k0) {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
        const int row = 16 * w + (l >> 3) + 4 * h, k = (l >> 2) + 8 * h;
        const int cq = 4 * (4 * w + (l & 3));
        cp_async16(ra + row * KS + 4 * (l & 7),
                   ap + row * TILE + k0 + 4 * (l & 7));
        cp_async16(rb + k * TILE + cq, bp + (k0 + k) * TILE + cq);
    }
}

__device__ __forceinline__ void tc_fetch(TcRegs& r, const float* ra,
                                         const float* rb) {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
        const int row = 16 * w + (l >> 3) + 4 * h, k = (l >> 2) + 8 * h;
        r.a[h] = *reinterpret_cast<const float4*>(ra + row * KS + 4 * (l & 7));
        r.b[h] = *reinterpret_cast<const float4*>(
            rb + k * TILE + 4 * (4 * w + (l & 3)));
    }
}

// Split the stage into hi / lo, write it swizzled, and write its k-masks.
__device__ __forceinline__ void tc_store(const TcRegs& r, TcStage& s,
                                         unsigned* am, unsigned* bm,
                                         unsigned* a_any, unsigned* b_any) {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    unsigned a_nz = 0u;
#pragma unroll
    for (int h = 0; h < 4; ++h) {           // A: one 16-byte chunk a row
        const int row = 16 * w + (l >> 3) + 4 * h;
        const float v[4] = {r.a[h].x, r.a[h].y, r.a[h].z, r.a[h].w};
        unsigned hi[4], lo[4], nzb = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            hi[e] = tf32_rna(v[e]);
            lo[e] = tf32_rna(v[e] - __uint_as_float(hi[e]));
            nzb |= (v[e] != 0.f ? 1u : 0u) << e;
        }
        const unsigned off = swz(row, 4 * (l & 7));
        *reinterpret_cast<uint4*>(s.a_hi + off) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(s.a_lo + off) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
        unsigned m = nzb << (4 * (l & 7));  // the row's 8 lanes hold its 32 k
        m |= __shfl_xor_sync(0xFFFFFFFFu, m, 1);
        m |= __shfl_xor_sync(0xFFFFFFFFu, m, 2);
        m |= __shfl_xor_sync(0xFFFFFFFFu, m, 4);
        if ((l & 7) == 0) am[row] = m;
        a_nz |= m;
    }
    unsigned cm[4] = {0u, 0u, 0u, 0u};      // k-masks of this lane's columns
#pragma unroll
    for (int h = 0; h < 4; ++h) {           // B: transposed, word by word
        const int k = (l >> 2) + 8 * h;
        const float v[4] = {r.b[h].x, r.b[h].y, r.b[h].z, r.b[h].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int n = 4 * (4 * w + (l & 3)) + c;
            const unsigned hi = tf32_rna(v[c]);
            const unsigned lo = tf32_rna(v[c] - __uint_as_float(hi));
            const unsigned off = swz(n, k);
            *reinterpret_cast<unsigned*>(s.b_hi + off) = hi;
            *reinterpret_cast<unsigned*>(s.b_lo + off) = lo;
            cm[c] |= (v[c] != 0.f ? 1u : 0u) << k;
        }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {           // lanes l%4 equal: the column's k
        cm[c] |= __shfl_xor_sync(0xFFFFFFFFu, cm[c], 4);
        cm[c] |= __shfl_xor_sync(0xFFFFFFFFu, cm[c], 8);
        cm[c] |= __shfl_xor_sync(0xFFFFFFFFu, cm[c], 16);
    }
    if ((l >> 2) == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) bm[4 * (4 * w + l) + c] = cm[c];
    }
    const bool b_nz = (cm[0] | cm[1] | cm[2] | cm[3]) != 0u;
    const unsigned a_w = __any_sync(0xFFFFFFFFu, a_nz != 0u);
    const unsigned b_w = __any_sync(0xFFFFFFFFu, b_nz);
    if (l == 0) {
        a_any[w] = a_w;
        b_any[w] = b_w;
    }
    // the generic-proxy writes above are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Warpgroup g = warp / 4 owns C rows 64g .. 64g + 63.  In the accumulator
// fragment, warp w of the group and lane l own rows r0 = 64g + 16(w % 4) +
// l/4 and r0 + 8, columns 8j + 2(l % 4) + {0, 1} (j = 0..15): d[4j + e] is
// row r0 + 8 * (e / 2), column 8j + 2(l % 4) + e % 2.  Flag bit 2j + e % 2
// of f[e / 2] is the same element.
__device__ void tile_product_tc(const float* __restrict__ a_dense,
                                const float* __restrict__ b_dense,
                                const int* __restrict__ a_tab,
                                const int* __restrict__ b_tab,
                                long long a0, long long b0, int n_pairs,
                                float* __restrict__ c_num,
                                unsigned char* __restrict__ c_flag,
                                TcShared& sh) {
    const int t = threadIdx.x, l = t & 31, g = t >> 7;
    const int r0 = 64 * g + 16 * ((t >> 5) & 3) + (l >> 2);
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) { acc[i] = 0.f; sum[i] = 0.f; }
    unsigned f[2] = {0u, 0u};
    const int n_stages = n_pairs * SLABS_PER_PAIR;
    TcRegs regs;
    auto operands = [&](int st, const float*& ap, const float*& bp) {
        const int q = st / SLABS_PER_PAIR;
        ap = a_dense + (a0 + a_tab[q]) * TILE_ELEMS;
        bp = b_dense + (b0 + b_tab[q]) * TILE_ELEMS;
    };
    auto issue = [&](int st) {              // stage st's raw slabs, in flight
        const float *ap, *bp;
        operands(st, ap, bp);
        tc_issue(sh.raw_a[st & 1], sh.raw_b[st & 1], ap, bp,
                 KS * (st % SLABS_PER_PAIR));
    };
    if (n_stages > 0) issue(0);
    cp_async_commit();
    if (n_stages > 1) issue(1);
    cp_async_commit();
    if (n_stages > 0) {
        cp_async_wait1();
        tc_fetch(regs, sh.raw_a[0], sh.raw_b[0]);
        tc_store(regs, sh.stage[0], sh.am[0], sh.bm[0], sh.a_any[0],
                 sh.b_any[0]);
    }
    __syncthreads();
    for (int st = 0; st < n_stages; ++st) {
        const int cur = st & 1;
        const bool next = st + 1 < n_stages;
        if (st + 2 < n_stages) issue(st + 2);   // into the raw slab of st
        cp_async_commit();
        const TcStage& s = sh.stage[cur];
        // a k-slab whose 64 A rows or whose B slab hold no non-zero adds
        // exact zeros to values and flags: the warpgroup skips it
        const bool run =
            (sh.a_any[cur][4 * g] | sh.a_any[cur][4 * g + 1] |
             sh.a_any[cur][4 * g + 2] | sh.a_any[cur][4 * g + 3]) != 0u &&
            (sh.b_any[cur][0] | sh.b_any[cur][1] | sh.b_any[cur][2] |
             sh.b_any[cur][3] | sh.b_any[cur][4] | sh.b_any[cur][5] |
             sh.b_any[cur][6] | sh.b_any[cur][7]) != 0u;
        if (run) {
            const unsigned long long a_hi = smem_desc(s.a_hi + 64 * g * 128);
            const unsigned long long a_lo = smem_desc(s.a_lo + 64 * g * 128);
            const unsigned long long b_hi = smem_desc(s.b_hi);
            const unsigned long long b_lo = smem_desc(s.b_lo);
            fence_regs(acc);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int kk = 0; kk < KS / 8; ++kk) {   // 8 tf32 = 32 bytes
                const unsigned long long dk = (unsigned long long)(kk * 2);
                wgmma_tf32(acc, a_lo + dk, b_hi + dk, kk);
                wgmma_tf32(acc, a_hi + dk, b_lo + dk, 1);
                wgmma_tf32(acc, a_hi + dk, b_hi + dk, 1);
            }
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        }
        if (next) {                          // split stage st + 1
            cp_async_wait1();
            tc_fetch(regs, sh.raw_a[cur ^ 1], sh.raw_b[cur ^ 1]);
            tc_store(regs, sh.stage[cur ^ 1], sh.am[cur ^ 1], sh.bm[cur ^ 1],
                     sh.a_any[cur ^ 1], sh.b_any[cur ^ 1]);
        }
        const unsigned m0 = sh.am[cur][r0], m1 = sh.am[cur][r0 + 8];
        if (run && (m0 | m1) != 0u) {        // pattern of this stage
#pragma unroll
            for (int j = 0; j < 16; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const unsigned mb = sh.bm[cur][8 * j + 2 * (l & 3) + e];
                    f[0] |= ((m0 & mb) != 0u ? 1u : 0u) << (2 * j + e);
                    f[1] |= ((m1 & mb) != 0u ? 1u : 0u) << (2 * j + e);
                }
            }
        }
        if (run) {
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            fence_regs(acc);
#pragma unroll
            for (int i = 0; i < 64; ++i) sum[i] += acc[i];
        }
        __syncthreads();
    }

#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
        const int row = r0 + 8 * e2;
        float* cr = c_num + row * TILE;
        unsigned char* fr = c_flag + row * TILE;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int col = 8 * j + 2 * (l & 3);
            *reinterpret_cast<float2*>(cr + col) =
                make_float2(sum[4 * j + 2 * e2], sum[4 * j + 2 * e2 + 1]);
            const unsigned bits = (f[e2] >> (2 * j)) & 3u;
            *reinterpret_cast<unsigned short*>(fr + col) =
                (unsigned short)((bits & 1u) | (bits & 2u) << 7);
        }
    }
}

constexpr int TC_THREADS = 256;             // two consumer warpgroups

// One block a (step, tile) of a signature class.  RAGGED: the tile's pairs
// are [p_ptr[tt], p_ptr[tt + 1]) of the offset tables; else p pairs a tile.
template <bool RAGGED>
__global__ void __launch_bounds__(TC_THREADS, 1)
macro_class_kernel(const float* __restrict__ a_dense,
                   const float* __restrict__ b_dense,
                   const int* __restrict__ ab_bases,
                   const int* __restrict__ p_ptr,
                   const int* __restrict__ a_offs,
                   const int* __restrict__ b_offs, int t, int p,
                   long long base, float* __restrict__ c_num,
                   unsigned char* __restrict__ c_flag) {
    extern __shared__ unsigned char smem_raw[];
    const unsigned raw = (unsigned)__cvta_generic_to_shared(smem_raw);
    TcShared& sh = *reinterpret_cast<TcShared*>(
        smem_raw + (((raw + 1023u) & ~1023u) - raw));
    const int step = blockIdx.x / t, tt = blockIdx.x % t;
    const int lo = RAGGED ? p_ptr[tt] : tt * p;
    const int n = RAGGED ? p_ptr[tt + 1] - lo : p;
    const long long row = base + (long long)blockIdx.x;
    tile_product_tc(a_dense, b_dense, a_offs + lo, b_offs + lo,
                    ab_bases[2 * step], ab_bases[2 * step + 1], n,
                    c_num + row * TILE_ELEMS, c_flag + row * TILE_ELEMS, sh);
}

template <bool RAGGED>
cudaError_t launch_class(const float* a_dense, const float* b_dense,
                         const int* ab_bases, const int* p_ptr,
                         const int* a_offs, const int* b_offs, int t, int p,
                         int n_steps, long long base, float* c_num,
                         unsigned char* c_flag, cudaStream_t stream) {
    // per launch: the attribute belongs to the current device
    const cudaError_t attr = cudaFuncSetAttribute(
        macro_class_kernel<RAGGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (attr != cudaSuccess) return attr;
    macro_class_kernel<RAGGED><<<n_steps * t, TC_THREADS, TC_SMEM, stream>>>(
        a_dense, b_dense, ab_bases, p_ptr, a_offs, b_offs, t, p, base,
        c_num, c_flag);
    return cudaGetLastError();
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
    return (int)launch_class<true>(a_dense, b_dense, ab_bases, p_ptr, a_offs,
                                   b_offs, t, 0, n_steps, base, c_num,
                                   c_flag, stream);
}

extern "C" int macro_class_uniform_f32(
        const float* a_dense, const float* b_dense, const int* ab_bases,
        const int* a_offs, const int* b_offs, int t, int p, int n_steps,
        long long base, float* c_num, unsigned char* c_flag,
        cudaStream_t stream) {
    if (n_steps <= 0 || t <= 0) return (int)cudaSuccess;
    return (int)launch_class<false>(a_dense, b_dense, ab_bases, nullptr,
                                    a_offs, b_offs, t, p, n_steps, base,
                                    c_num, c_flag, stream);
}
