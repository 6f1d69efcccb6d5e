// Macro128 accumulation: C tiles as sums of 128x128x128 tile products.
//
//     C[row] = sum over the row's pairs q of  A[a0 + a_tab[q]] @ B[b0 + b_tab[q]]
//     F[row] = 1 where any product of two stored (non-zero) entries lands
//
// Hopper counterparts of the JAX package's Macro128 kernels:
//   * `macro_accumulate_pairs_f32` replaces ops/pallas_macro2.py
//     (accumulate_macro_pipelined / _kernel): a pair stream sorted by C tile,
//     its tiles' pairs found from segment offsets;
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
// order, and OWNERSHIP does the work: every C tile has one owner block, which
// walks that tile's pairs in stream order with the tile's 128x128 sums in
// registers and stores values and flags once.  No atomics on C (the
// persistent entry takes its tiles from one atomic counter), no zero-fill
// pass, no carry; a tile without pairs is stored as zeros.  All offsets are
// run-time int32 tables, so one build serves every plan, and every tile
// address is 64-bit (113k C tiles are 1.85e9 floats).
//
// What bounds them on an H100: 2 * 128^3 operations a pair against 128 KB of
// operand tile a pair at most (fewer where tiles repeat) and 80 KB of C tile
// written once: operations, on the tensor cores 3 tf32 products a product.
//
// Each block runs a STREAM of (tile, pair, 32-deep k-slab) stages over a
// two-stage ring; one stage's work (tc_stage) is the same in all three
// entries.  The class entries run one C tile a block (tile_product_tc, their
// launch shape).  The pair-stream entry is PERSISTENT (pair_stream): one
// block an SM takes C tiles in stream order from an atomic counter, so the
// tiles in flight stay neighbours in the C-sorted stream and share operand
// tiles in L2 (a fixed round robin lets the blocks drift apart and loses
// that); a tile has few pairs (1.6-3.3 on the suite's streams, 7-13
// stages), and the stream runs across tile boundaries: the next tile's
// first raw slabs are in flight while the current one runs its last
// products and stores its sums, and no tile fills or drains the ring on its
// own.
//
// The tile product runs on the tensor cores: wgmma on tf32 operands with a
// 3xTF32 split, which keeps the reference's precision "highest" (one tf32
// product keeps 11 bits of each operand; plain TF32 is not allowed).  Every
// operand x is split as hi = tf32_rna(x), lo = tf32_rna(x - hi), and C
// accumulates hi*hi + hi*lo + lo*hi: each product is then exact to about
// 2^-22 of |a*b|.  wgmma takes tf32 operands K-major only: A's tiles lie so
// (row i, contiguous k), B's do not (row k, contiguous j), so every slab
// passes through registers once: 256 threads copy it raw with cp.async two
// stages ahead (a ring of two raw 32 KB slabs), read it back, split it, and
// write A as it lies and B transposed, each into the 128-byte swizzle that
// the shared-memory descriptors name, over a ring of two split stages (4 x
// 16 KB a stage) while the tensor cores work on the other one.  Two
// warpgroups each own a 64 x 128 half of the C tile (64 f32 registers a
// thread) and issue 3 x 4 wgmma.m64n128k8 a stage; the stage's partial is
// added to a second register sum in FP32 (round to nearest), so the tensor
// cores' accumulation rounds over one 32-deep slab only.  The pattern comes
// from the raw f32 values (x != 0; the tf32 hi of a subnormal can be 0):
// per stage a 32-bit k-mask of each A row and of each B column, and a
// thread ORs (mask_row & mask_col) != 0 into the 64 bits of the accumulator
// elements it owns, so values and flags are stored together.  A slab in
// which a warpgroup's 64 A rows or the B slab hold no non-zero adds exact
// zeros, and the warpgroup skips it (wandering64's tiles are about 1/6
// full); ptxas then serializes the stage's wgmma chain (warning C7518),
// which costs less than the skipped slabs save (PERF.md).
//
// Non-finite operands keep IEEE results.  A stage that holds a value with
// |x| >= 2^63, an Inf or a NaN is MARKED (the warps that split it vote):
// both warpgroups skip its wgmma (a marked stage is never skipped as empty)
// and form the slab's partial in FP32 FMA on the raw operands, read again
// from device memory, then add it to the sum as a wgmma partial would be.
// So an Inf or NaN gives the NaNs and the signed Infs of a dense product,
// also where it meets only zeros, and a finite value near FLT_MAX (whose
// tf32 rounding would be Inf), or a subnormal against it (whose split
// misses it by up to 2^-137), gives the float32 product.  Below 2^63 no
// product of the split can overflow and a subnormal's split error stays
// under 2^-74 of its partner's scale: unmarked stages run exactly as
// before.
//
// The float64 entry `macro_accumulate_pairs_f64` serves the f64 parity mode
// (the JAX package runs float64 tiles through accumulate_macro_pipelined
// too).  It keeps the float32 entry's contract: a stream sorted by C tile,
// padding pairs never read, tiles without pairs stored as zeros, uint8
// flags from the raw values (x != 0, so NaN and Inf count), every tile
// written once by its owner.  Its tile product runs on the FP64 tensor
// cores: mma.sync m16n8k8 on f64 operands (DMMA; Hopper has no wgmma for
// f64, and DMMA is the only way to the card's FP64 peak).  One block of
// 8 warps a C tile; warp w owns a 32 x 64 block of it (rows 32 (w % 4),
// columns 64 (w / 4)) as 2 x 8 DMMA blocks, 64 FP64 accumulators a lane.
// The tile's pairs run as one stream of 16-deep k-slabs (8 a pair) through
// a ring of 4 stages in dynamic shared memory (A [i][k] and B [k][j], 37 KB
// a stage), each slab copied by 16-byte cp.async 3 slabs ahead of the
// tensor cores.  The rows are padded to 20 and 132 words (4 mod 16), so a
// half warp's 8-byte fragment loads meet no bank twice.
//
// Most of a banded tile pair's products are zeros, and at these sizes the
// entry is bound by the bytes it moves, not by DMMA, so it skips work at
// two levels, and never where an Inf or a NaN is among the operands (whose
// products with zeros are NaN).  First, two small kernels record every
// tile's k-masks (which columns, as an A operand, and rows, as a B operand,
// hold a non-zero; which 16-wide k-slabs hold an Inf or a NaN) and, from
// them, each pair's slabs that can hold a non-zero product: the others
// are never copied (wandering64's stream copies about a quarter of its
// slabs).  Then, in a slab that runs, a DMMA block (16 x 8, one slab deep)
// whose rows and columns share no k with non-zeros on both sides adds only
// +-0 to its sums and is skipped (from per-slab masks of the rows and
// columns and their ORs over the blocks' 16-row and 8-column groups,
// written one step before the slab runs).  chip_smoke.py reports both
// shares; the bound counts every product.  The pattern: each lane ORs
// (mask_row & mask_col) != 0 over the slab's k into the 64 flags of its
// accumulator fragment, for the blocks with a non-zero product.  C tiles
// are stored evict-first (st.global.cs), so that the 144 KB each does not
// push the operand tiles out of L2.  The block holds 64 accumulators and a
// k-step's fragments a thread (one block an SM).  A persistent form (one
// block an SM taking tiles from a counter, the ring running across tile
// boundaries) was no faster than one block a tile (PERF.md), and is not
// kept.
//
// Plain C interface, no PyTorch headers: the wrappers
// (ops/macro_kernels.py) allocate the outputs (and the float64 entry's
// k-mask and per-pair scratch), pass raw pointers, the grid of the
// persistent entry and the current stream, and raise if the returned
// cudaError_t is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr long long TILE_ELEMS = (long long)TILE * TILE;
constexpr int KS = 32;                      // k-slab depth: one 128-byte row
constexpr int OPERAND = TILE * KS * 4;      // bytes of one split operand slab
constexpr int SLABS_PER_PAIR = TILE / KS;
constexpr int TC_THREADS = 256;             // two consumer warpgroups
constexpr unsigned ANY_NZ = 1u;             // a_any / b_any bits
constexpr unsigned ANY_BAD = 2u;
constexpr int CLAIMS = 8;                   // slots of the claim ring
constexpr int AHEAD = 3;                    // claims ahead of the issue cursor

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
    unsigned a_any[2][8];                   // warp w's A rows: ANY_NZ if any
    unsigned b_any[2][8];                   // non-zero; b_any: ANY_BAD if the
                                            // warp's A or B words mark it
    long long q_row[CLAIMS];                // claimed tiles: C row (-1: none
    int q_lo[CLAIMS];                       // left) and pairs [lo, hi)
    int q_hi[CLAIMS];
};
constexpr int TC_SMEM = (int)sizeof(TcShared) + 1024;   // + alignment slack

__device__ __forceinline__ unsigned tf32_rna(float x) {
    unsigned r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// A stage with a value at or above BIG in magnitude, an Inf or a NaN is
// marked (see the head of the file).
constexpr float BIG = 0x1p63f;

__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
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

// Split the stage into hi / lo, write it swizzled, and write its k-masks and
// the warp's ANY_NZ / ANY_BAD bits.
__device__ __forceinline__ void tc_store(const TcRegs& r, TcStage& s,
                                         unsigned* am, unsigned* bm,
                                         unsigned* a_any, unsigned* b_any) {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    unsigned a_nz = 0u;
    float mx = 0.f;                         // max |x|, NaN if any x is
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
            mx = max_nan(mx, fabsf(v[e]));
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
            mx = max_nan(mx, fabsf(v[c]));
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
    const unsigned bad = __any_sync(0xFFFFFFFFu, !(mx < BIG)) ? ANY_BAD : 0u;
    const unsigned a_w = __any_sync(0xFFFFFFFFu, a_nz != 0u) ? ANY_NZ : 0u;
    const unsigned b_w = __any_sync(0xFFFFFFFFu, b_nz) ? ANY_NZ : 0u;
    if (l == 0) {
        a_any[w] = a_w;
        b_any[w] = b_w | bad;
    }
    // the generic-proxy writes above are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A marked stage's partial in FP32 FMA on its raw values, read again from
// device memory (ap, bp: the pair's tiles; k0: the slab's first k), into the
// wgmma accumulator's registers in the fragment layout (rows r0, r0 + 8;
// see Frag).  No shared memory is touched, so no barrier is needed.
__device__ __forceinline__ void fma_stage(float (&acc)[64],
                                          const float* __restrict__ ap,
                                          const float* __restrict__ bp,
                                          int k0, int r0, int l) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int n0 = 8 * j + 2 * (l & 3);
        acc[4 * j] = acc[4 * j + 1] = acc[4 * j + 2] = acc[4 * j + 3] = 0.f;
#pragma unroll 1
        for (int k = k0; k < k0 + KS; ++k) {
            const float a0 = __ldg(ap + r0 * TILE + k);
            const float a1 = __ldg(ap + (r0 + 8) * TILE + k);
            const float b0 = __ldg(bp + k * TILE + n0);
            const float b1 = __ldg(bp + k * TILE + n0 + 1);
            acc[4 * j] = fmaf(a0, b0, acc[4 * j]);
            acc[4 * j + 1] = fmaf(a0, b1, acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(a1, b0, acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(a1, b1, acc[4 * j + 3]);
        }
    }
}

// Warpgroup g = warp / 4 owns C rows 64g .. 64g + 63.  In the accumulator
// fragment, warp w of the group and lane l own rows r0 = 64g + 16(w % 4) +
// l/4 and r0 + 8, columns 8j + 2(l % 4) + {0, 1} (j = 0..15): d[4j + e] is
// row r0 + 8 * (e / 2), column 8j + 2(l % 4) + e % 2.  Flag bit 2j + e % 2
// of f[e / 2] is the same element.
struct Frag {
    float acc[64];                          // the stage's wgmma partial
    float sum[64];                          // the tile's sums
    unsigned f[2];                          // the tile's flags
    int g, r0, l;
    __device__ __forceinline__ Frag() {
        const int t = threadIdx.x;
        l = t & 31;
        g = t >> 7;
        r0 = 64 * g + 16 * ((t >> 5) & 3) + (l >> 2);
#pragma unroll
        for (int i = 0; i < 64; ++i) { acc[i] = 0.f; sum[i] = 0.f; }
        f[0] = f[1] = 0u;
    }
    __device__ __forceinline__ void store(float* c_num, unsigned char* c_flag,
                                          long long row) const {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
            const int r = r0 + 8 * e2;
            float* cr = c_num + row * TILE_ELEMS + r * TILE;
            unsigned char* fr = c_flag + row * TILE_ELEMS + r * TILE;
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
    __device__ __forceinline__ void reset() {
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] = 0.f;
        f[0] = f[1] = 0u;
    }
};

// One stage of the tile product on split slot cur, and the split of the
// next stage's raw slabs into slot cur ^ 1 (when `next`) while the tensor
// cores run: a marked stage runs in FP32 FMA on the raw operands that
// operands(ap, bp, k0) names; else a k-slab whose 64 A rows or whose B slab
// hold no non-zero adds exact zeros to values and flags, and the warpgroup
// skips it.  The caller's barrier follows.
template <class Operands>
__device__ __forceinline__ void tc_stage(TcShared& sh, int cur, bool next,
                                         Operands operands, TcRegs& regs,
                                         Frag& fr) {
    const int g = fr.g, l = fr.l, r0 = fr.r0;
    const TcStage& s = sh.stage[cur];
    const unsigned ag = sh.a_any[cur][4 * g] | sh.a_any[cur][4 * g + 1] |
                        sh.a_any[cur][4 * g + 2] | sh.a_any[cur][4 * g + 3];
    const unsigned bg = sh.b_any[cur][0] | sh.b_any[cur][1] |
                        sh.b_any[cur][2] | sh.b_any[cur][3] |
                        sh.b_any[cur][4] | sh.b_any[cur][5] |
                        sh.b_any[cur][6] | sh.b_any[cur][7];
    const bool bad = (bg & ANY_BAD) != 0u;
    const bool run = !bad && (ag & bg & ANY_NZ) != 0u;
    if (run) {
        const unsigned long long a_hi = smem_desc(s.a_hi + 64 * g * 128);
        const unsigned long long a_lo = smem_desc(s.a_lo + 64 * g * 128);
        const unsigned long long b_hi = smem_desc(s.b_hi);
        const unsigned long long b_lo = smem_desc(s.b_lo);
        fence_regs(fr.acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < KS / 8; ++kk) {   // 8 tf32 = 32 bytes
            const unsigned long long dk = (unsigned long long)(kk * 2);
            wgmma_tf32(fr.acc, a_lo + dk, b_hi + dk, kk);
            wgmma_tf32(fr.acc, a_hi + dk, b_lo + dk, 1);
            wgmma_tf32(fr.acc, a_hi + dk, b_hi + dk, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    if (next) {
        cp_async_wait1();
        tc_fetch(regs, sh.raw_a[cur ^ 1], sh.raw_b[cur ^ 1]);
        tc_store(regs, sh.stage[cur ^ 1], sh.am[cur ^ 1], sh.bm[cur ^ 1],
                 sh.a_any[cur ^ 1], sh.b_any[cur ^ 1]);
    }
    const unsigned m0 = sh.am[cur][r0], m1 = sh.am[cur][r0 + 8];
    if ((run || bad) && (m0 | m1) != 0u) {  // pattern of this stage
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const unsigned mb = sh.bm[cur][8 * j + 2 * (l & 3) + e];
                fr.f[0] |= ((m0 & mb) != 0u ? 1u : 0u) << (2 * j + e);
                fr.f[1] |= ((m1 & mb) != 0u ? 1u : 0u) << (2 * j + e);
            }
        }
    }
    if (run) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(fr.acc);
    } else if (bad) {
        const float *ap, *bp;
        int k0;
        operands(ap, bp, k0);
        fma_stage(fr.acc, ap, bp, k0, r0, l);
    }
    if (run || bad) {
#pragma unroll
        for (int i = 0; i < 64; ++i) fr.sum[i] += fr.acc[i];
    }
}

// One C tile a block (the class entries): the tile's pairs q < n_pairs,
// operands A[a0 + a_tab[q]], B[b0 + b_tab[q]], as a stream of (pair, k-slab)
// stages over a two-stage ring, stored at c_num / c_flag.
__device__ __forceinline__ void tile_product_tc(
        const float* __restrict__ a_dense, const float* __restrict__ b_dense,
        const int* __restrict__ a_tab, const int* __restrict__ b_tab,
        long long a0, long long b0, int n_pairs, float* __restrict__ c_num,
        unsigned char* __restrict__ c_flag, TcShared& sh) {
    Frag fr;
    const int n_stages = n_pairs * SLABS_PER_PAIR;
    TcRegs regs;
    auto issue = [&](int st) {              // stage st's raw slabs, in flight
        const int q = st / SLABS_PER_PAIR;
        tc_issue(sh.raw_a[st & 1], sh.raw_b[st & 1],
                 a_dense + (a0 + a_tab[q]) * TILE_ELEMS,
                 b_dense + (b0 + b_tab[q]) * TILE_ELEMS,
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
        if (st + 2 < n_stages) issue(st + 2);   // into the raw slab of st
        cp_async_commit();
        const int q = st / SLABS_PER_PAIR;
        tc_stage(sh, st & 1, st + 1 < n_stages,
                 [&](const float*& ap, const float*& bp, int& k0) {
                     ap = a_dense + (a0 + a_tab[q]) * TILE_ELEMS;
                     bp = b_dense + (b0 + b_tab[q]) * TILE_ELEMS;
                     k0 = KS * (st % SLABS_PER_PAIR);
                 }, regs, fr);
        __syncthreads();
    }
    fr.store(c_num, c_flag, 0);
}

// The persistent entry's tiles: thread 0 takes tickets (atomicAdd on
// `next`, zero at the launch), in stream order; the tiles without pairs are
// stored as zeros before the stream, round robin, by single threads.
struct PairWalk {
    const int* seg_ptr;
    const int* a_tab;
    const int* b_tab;
    int* next;
    int c_cap;
};

// The block's tiles with pairs come through a ring of CLAIMS slots in shared
// memory, which thread 0 keeps AHEAD claims in front of the issue cursor.
// A claim takes two iterations, so that no thread waits on it: a ticket
// (the atomic) is taken at the top of one iteration, its pair range read
// from seg_ptr at the top of the next, and the slot written at that
// iteration's end, before the barrier that precedes the slot's first read.
// Two cursors read the ring in order: the ISSUE cursor (pair iq of [iq,
// iq_end), slab is) two stages ahead of the compute, and the COMPUTE
// cursor (the tile at C row c_row, `left` stages to go), which stores a
// tile's sums and flags after its last stage and resets them.
// Stage st's raw slabs sit in raw slot st % 2, its split in stage slot
// st % 2, whatever tile it belongs to; `issued` counts the stages issued, so
// stage st + 1 exists when st + 1 < issued.  The issue cursor is at most
// one tile ahead of the compute (a tile has 4 stages or more), so at most
// AHEAD + 3 < CLAIMS slots are in use at once.
__device__ __forceinline__ void pair_stream(
        const float* __restrict__ a_dense, const float* __restrict__ b_dense,
        const PairWalk& w, float* __restrict__ c_num,
        unsigned char* __restrict__ c_flag, TcShared& sh) {
    const int t = threadIdx.x;
    for (long long c = blockIdx.x + (long long)t * gridDim.x; c < w.c_cap;
         c += (long long)TC_THREADS * gridDim.x) {
        if (w.seg_ptr[c] != w.seg_ptr[c + 1]) continue;
        float4* cv = reinterpret_cast<float4*>(c_num + c * TILE_ELEMS);
        uint4* cf = reinterpret_cast<uint4*>(c_flag + c * TILE_ELEMS);
        for (int i = 0; i < TILE_ELEMS / 4; ++i)
            cv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = 0; i < TILE_ELEMS / 16; ++i)
            cf[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    // thread 0: slot n <- the first tile with pairs from ticket tk on, whose
    // pairs [lo, hi) were read already (row -1: none left)
    auto publish = [&](int n, int tk, int lo, int hi) {
        while (tk < w.c_cap && hi == lo) {  // a tile without pairs: rare
            tk = atomicAdd(w.next, 1);
            if (tk < w.c_cap) {
                lo = w.seg_ptr[tk];
                hi = w.seg_ptr[tk + 1];
            }
        }
        const int slot = n % CLAIMS;
        sh.q_row[slot] = tk < w.c_cap ? tk : -1;
        sh.q_lo[slot] = lo;
        sh.q_hi[slot] = hi;
    };
    auto read_range = [&](int tk, int& lo, int& hi) {
        lo = hi = 0;
        if (tk < w.c_cap) {
            lo = w.seg_ptr[tk];
            hi = w.seg_ptr[tk + 1];
        }
    };
    if (t == 0) {
        for (int n = 0; n <= AHEAD; ++n) {
            int lo, hi;
            const int tk = atomicAdd(w.next, 1);
            read_range(tk, lo, hi);
            publish(n, tk, lo, hi);
        }
    }
    int n_claimed = AHEAD + 1, n_used = 0;
    bool pending = false;                   // a ticket taken, not published
    int tk_pend = 0;                        // thread 0: its ticket
    __syncthreads();

    Frag fr;
    TcRegs regs;
    int iq = 0, iq_end = 0, is = 0, issued = 0;
    bool i_live = true;
    auto take = [&]() {                     // the issue cursor's next tile
        const int slot = n_used++ % CLAIMS;
        i_live = sh.q_row[slot] >= 0;
        iq = sh.q_lo[slot];
        iq_end = sh.q_hi[slot];
    };
    auto issue = [&]() {                    // the next stage's raw slabs
        if (!i_live) return;
        tc_issue(sh.raw_a[issued & 1], sh.raw_b[issued & 1],
                 a_dense + (long long)w.a_tab[iq] * TILE_ELEMS,
                 b_dense + (long long)w.b_tab[iq] * TILE_ELEMS, KS * is);
        ++issued;
        if (++is == SLABS_PER_PAIR) {
            is = 0;
            if (++iq == iq_end) take();
        }
    };
    int c_used = 0, left = 0, cq = 0, cs = 0;
    long long c_row = 0;
    auto advance = [&]() {                  // the compute cursor's next tile
        const int slot = c_used++ % CLAIMS;
        c_row = sh.q_row[slot];
        cq = sh.q_lo[slot];
        cs = 0;
        left = c_row >= 0 ? (sh.q_hi[slot] - cq) * SLABS_PER_PAIR : 0;
    };

    take();
    issue();
    cp_async_commit();
    issue();
    cp_async_commit();
    advance();
    if (issued > 0) {
        cp_async_wait1();
        tc_fetch(regs, sh.raw_a[0], sh.raw_b[0]);
        tc_store(regs, sh.stage[0], sh.am[0], sh.bm[0], sh.a_any[0],
                 sh.b_any[0]);
    }
    __syncthreads();
    for (int st = 0; st < issued; ++st) {
        // the claim pipeline: the pending ticket's range, a new ticket
        const bool publish_now = pending;
        int lo_p = 0, hi_p = 0;
        if (publish_now && t == 0) read_range(tk_pend, lo_p, hi_p);
        const bool fresh = i_live && n_claimed + (pending ? 1 : 0) <
                                         n_used + AHEAD;
        int tk_new = 0;
        if (fresh && t == 0) tk_new = atomicAdd(w.next, 1);
        issue();                            // stage st + 2, into raw slot
        cp_async_commit();                  // st % 2
        tc_stage(sh, st & 1, st + 1 < issued,
                 [&](const float*& ap, const float*& bp, int& k0) {
                     ap = a_dense + (long long)w.a_tab[cq] * TILE_ELEMS;
                     bp = b_dense + (long long)w.b_tab[cq] * TILE_ELEMS;
                     k0 = KS * cs;
                 }, regs, fr);
        if (++cs == SLABS_PER_PAIR) {       // the compute cursor's pair
            cs = 0;
            ++cq;
        }
        if (--left == 0) {                  // the tile's last stage
            fr.store(c_num, c_flag, c_row);
            fr.reset();
            advance();
        }
        if (publish_now) {
            if (t == 0) publish(n_claimed, tk_pend, lo_p, hi_p);
            ++n_claimed;
        }
        pending = fresh;
        tk_pend = tk_new;
        __syncthreads();
    }
}

// Aligns the dynamic shared memory to the swizzle atom.
__device__ __forceinline__ TcShared& tc_shared() {
    extern __shared__ unsigned char smem_raw[];
    const unsigned raw = (unsigned)__cvta_generic_to_shared(smem_raw);
    return *reinterpret_cast<TcShared*>(
        smem_raw + (((raw + 1023u) & ~1023u) - raw));
}

// Persistent: the blocks take the C tiles of a pair stream sorted by C tile
// in stream order, one at a time, from the counter `next`; tile c's pairs
// are [seg_ptr[c], seg_ptr[c + 1]).  Padding pairs lie past seg_ptr[c_cap]
// and are never read.
__global__ void __launch_bounds__(TC_THREADS, 1)
macro_pairs_kernel(const float* __restrict__ a_dense,
                   const float* __restrict__ b_dense,
                   const int* __restrict__ a_idx,
                   const int* __restrict__ b_idx,
                   const int* __restrict__ seg_ptr, int* next, int c_cap,
                   float* __restrict__ c_num,
                   unsigned char* __restrict__ c_flag) {
    pair_stream(a_dense, b_dense, PairWalk{seg_ptr, a_idx, b_idx, next, c_cap},
                c_num, c_flag, tc_shared());
}

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
    const int step = blockIdx.x / t, tt = blockIdx.x % t;
    const int lo = RAGGED ? p_ptr[tt] : tt * p;
    const int n = RAGGED ? p_ptr[tt + 1] - lo : p;
    const long long row = base + (long long)blockIdx.x;
    tile_product_tc(a_dense, b_dense, a_offs + lo, b_offs + lo,
                    ab_bases[2 * step], ab_bases[2 * step + 1], n,
                    c_num + row * TILE_ELEMS, c_flag + row * TILE_ELEMS,
                    tc_shared());
}

// The float64 entry (see the head of the file): one block of 8 warps a C
// tile, warp w owning rows 32 (w % 4) .. + 31 and columns 64 (w / 4) .. + 63
// as 2 x 8 DMMA blocks of 16 x 8; k-slabs of F64_KS staged by cp.async over
// a ring of F64_STAGES.
constexpr int F64_KS = 16;                  // k-slab depth
constexpr int F64_STAGES = 4;               // slabs in the ring
constexpr int F64_NEED_CAP = 1024;          // a tile's pairs staged below
constexpr int F64_MASK_WORDS = 10;          // tile_masks words a tile
constexpr int F64_MMA_K = 8;                // k of one mma.sync (4 or 8)
constexpr int F64_THREADS = 256;
constexpr int F64_AS = F64_KS + 4;          // A row stride, 4 mod 16 words
constexpr int F64_BS = TILE + 4;            // B row stride, 4 mod 16 words
constexpr int F64_SLABS_PER_PAIR = TILE / F64_KS;
constexpr unsigned F64_KBITS = (1u << F64_KS) - 1u;  // mask bits: k != 0
constexpr unsigned F64_BAD = 1u << F64_KS;  // mask bit: an Inf or a NaN
static_assert(F64_KS <= 16 && F64_STAGES >= 3, "16-bit masks, ring of 3+");

struct F64Stage {
    double a[TILE][F64_AS];                 // A [i][k]
    double b[F64_KS][F64_BS];               // B [k][j]
};
// The masks of two slabs: bit k of am[i] is A[i][k0 + k] != 0, of bm[j]
// B[k0 + k][j] != 0, F64_BAD set where the row or column holds an Inf or a
// NaN; ag / bg OR them over the 16-row / 8-column groups of the DMMA blocks.
// need[q]: the slabs of the tile's pair q that run (f64_pair_need), staged
// for its first F64_NEED_CAP pairs; n_slabs their count over the tile.
struct F64Shared {
    F64Stage st[F64_STAGES];
    unsigned am[2][TILE];
    unsigned bm[2][TILE];
    unsigned ag[2][TILE / 16];
    unsigned bg[2][TILE / 8];
    unsigned char need[F64_NEED_CAP];
    int n_slabs;
};
constexpr int F64_SMEM = (int)sizeof(F64Shared);

// d += a @ b on one 16 x 8 x MK DMMA block.  Fragments (g = lane / 4,
// t = lane % 4): a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)], b[i] = B[t + 4 i][g],
// d[q] = C[g + 8 (q / 2)][2 t + q % 2].
template <int MK>
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[MK / 2],
                                     const double (&b)[MK / 4]) {
    static_assert(MK == 4 || MK == 8, "m16n8k4 or m16n8k8");
    if constexpr (MK == 4) {
        asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
            : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
            : "d"(a[0]), "d"(a[1]), "d"(b[0]));
    } else {
        asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
              "d"(b[1]));
    }
}

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Slab k0 of the pair (at, bt) into stage `st`: 16-byte cp.async copies,
// 4 of A and 4 of B a thread; 8 lanes copy one 128-byte row of the A slab,
// 64 lanes one row of the B slab.
__device__ __forceinline__ void f64_issue(F64Stage& st,
                                          const double* __restrict__ at,
                                          const double* __restrict__ bt,
                                          int k0, int t) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int e = t + F64_THREADS * q;
        const int ar = e >> 3, ac = 2 * (e & 7);
        cp_async16(&st.a[ar][ac], at + ar * TILE + k0 + ac);
        const int br = e >> 6, bc = 2 * (e & 63);
        cp_async16(&st.b[br][bc], bt + (k0 + br) * TILE + bc);
    }
}

// The slab's masks from the raw values (x != 0: NaN and Inf count; x - x
// != 0: an Inf or a NaN): warps 0-3 those of the A rows and their 16-row
// groups, warps 4-7 those of the B columns and their 8-column groups.
__device__ __forceinline__ void f64_masks(const F64Stage& st, unsigned* am,
                                          unsigned* bm, unsigned* ag,
                                          unsigned* bg, int t) {
    unsigned m = 0u;
    bool bad = false;
    if (t < TILE) {
#pragma unroll
        for (int k = 0; k < F64_KS; k += 2) {
            const double2 x = *reinterpret_cast<const double2*>(&st.a[t][k]);
            m |= (x.x != 0.0 ? 1u : 0u) << k;
            m |= (x.y != 0.0 ? 1u : 0u) << (k + 1);
            bad |= (x.x - x.x != 0.0) | (x.y - x.y != 0.0);
        }
        m |= bad ? F64_BAD : 0u;
        am[t] = m;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) m |= __shfl_xor_sync(~0u, m, o);
        if ((t & 15) == 0) ag[t >> 4] = m;
    } else {
        const int c = t - TILE;
#pragma unroll
        for (int k = 0; k < F64_KS; ++k) {
            const double x = st.b[k][c];
            m |= (x != 0.0 ? 1u : 0u) << k;
            bad |= x - x != 0.0;
        }
        m |= bad ? F64_BAD : 0u;
        bm[c] = m;
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) m |= __shfl_xor_sync(~0u, m, o);
        if ((c & 7) == 0) bg[c >> 3] = m;
    }
}

// A lane's C elements: acc[mi][ni][q] is row r0 + 16 mi + 8 (q / 2),
// column c0 + 8 ni + q % 2, with r0 = 32 (w % 4) + g, c0 = 64 (w / 4) + 2 t;
// flag bit 4 ni + q of f[mi] is the same element
// (tests/test_torch_macro_f64.py mirrors this map in numpy).
struct F64Frag {
    double acc[2][8][4];
    unsigned f[2];
    int wm, wn, r0, c0, g, t;
    __device__ __forceinline__ F64Frag() {
        const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
        g = l >> 2;
        t = l & 3;
        wm = w & 3;
        wn = w >> 2;
        r0 = 32 * wm + g;
        c0 = 64 * wn + 2 * t;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0;
        f[0] = f[1] = 0u;
    }
    // One slab on the tensor cores.  DMMA block (mi, ni) is run where its
    // 16 A rows and 8 B columns share a k with non-zeros on both sides, or
    // where either holds an Inf or a NaN; every other block's products are
    // exact zeros (+-0), and adding them changes no sum, so it is skipped.
    // The decision is the warp's (its lanes read the same masks).  Returns
    // the blocks with a non-zero product (bit 8 mi + ni), whose flags
    // `pattern` sets.
    __device__ __forceinline__ unsigned slab(const F64Stage& st,
                                             const unsigned* ag,
                                             const unsigned* bg) {
        const unsigned gr[2] = {ag[2 * wm], ag[2 * wm + 1]};
        unsigned need = 0u, live = 0u;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
            const unsigned gc = bg[8 * wn + ni];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const unsigned bit = 1u << (8 * mi + ni);
                const bool nz = (gr[mi] & gc & F64_KBITS) != 0u;
                live |= nz ? bit : 0u;
                need |= nz || ((gr[mi] | gc) & F64_BAD) != 0u ? bit : 0u;
            }
        }
        if (need == 0u) return 0u;
#pragma unroll
        for (int kk = 0; kk < F64_KS; kk += F64_MMA_K) {
            double a[2][F64_MMA_K / 2], b[8][F64_MMA_K / 4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int i = 0; i < F64_MMA_K / 2; ++i)
                    a[mi][i] = (need >> (8 * mi)) & 0xffu
                        ? st.a[r0 + 16 * mi + 8 * (i % 2)]
                              [kk + t + 4 * (i / 2)]
                        : 0.0;
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                for (int i = 0; i < F64_MMA_K / 4; ++i)
                    b[ni][i] = (need >> ni) & 0x101u
                        ? st.b[kk + t + 4 * i][c0 - 2 * t + 8 * ni + g]
                        : 0.0;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 8; ++ni)
                    if ((need >> (8 * mi + ni)) & 1u)
                        dmma<F64_MMA_K>(acc[mi][ni], a[mi], b[ni]);
        }
        return live;
    }
    // OR the pattern of the `live` blocks into the flags: (mask_row &
    // mask_col) != 0 over the k bits
    __device__ __forceinline__ void pattern(const unsigned* am,
                                            const unsigned* bm,
                                            unsigned live) {
        if (live == 0u) return;
        unsigned ra[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                ra[mi][h] = am[r0 + 16 * mi + 8 * h] & F64_KBITS;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
            if (((live >> ni) & 0x101u) == 0u) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const unsigned cb = bm[c0 + 8 * ni + e];
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        f[mi] |= ((ra[mi][h] & cb) != 0u ? 1u : 0u)
                                 << (4 * ni + 2 * h + e);
            }
        }
    }
    __device__ __forceinline__ void store(double* __restrict__ cn,
                                          unsigned char* __restrict__ cf)
                                          const {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r0 + 16 * mi + 8 * h;
#pragma unroll
                for (int ni = 0; ni < 8; ++ni) {
                    const int col = c0 + 8 * ni;
                    __stcs(reinterpret_cast<double2*>(cn + r * TILE + col),
                           make_double2(acc[mi][ni][2 * h],
                                        acc[mi][ni][2 * h + 1]));
                    const unsigned bits = (f[mi] >> (4 * ni + 2 * h)) & 3u;
                    __stcs(reinterpret_cast<unsigned short*>(
                               cf + r * TILE + col),
                           (unsigned short)((bits & 1u) | (bits & 2u) << 7));
                }
            }
    }
};

// The k-masks of every tile of a table, before the pair stream runs: words
// 0-3 bit k: column k holds a non-zero (the tile as an A operand), word 4
// bit s: columns 16 s .. 16 s + 15 hold an Inf or a NaN; words 5-8 and 9
// the same of the rows (the tile as a B operand).  One block a tile; a
// warp reads whole rows, its lanes neighbouring columns.
__global__ void __launch_bounds__(F64_THREADS)
f64_tile_masks(const double* __restrict__ tiles, unsigned* __restrict__ masks) {
    __shared__ unsigned m[F64_MASK_WORDS];
    const int t = threadIdx.x, w = t >> 5, l = t & 31;
    if (t < F64_MASK_WORDS) m[t] = 0u;
    __syncthreads();
    const double* x = tiles + (long long)blockIdx.x * TILE_ELEMS;
    bool cnz[4] = {false, false, false, false};
    bool cbad[4] = {false, false, false, false};
    for (int r = w; r < TILE; r += F64_THREADS / 32) {
        bool rnz = false, rbad = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const double v = x[r * TILE + l + 32 * j];
            cnz[j] |= v != 0.0;
            cbad[j] |= v - v != 0.0;
            rnz |= v != 0.0;
            rbad |= v - v != 0.0;
        }
        rnz = __any_sync(~0u, rnz);
        rbad = __any_sync(~0u, rbad);
        if (l == 0 && rnz) atomicOr(&m[5 + (r >> 5)], 1u << (r & 31));
        if (l == 0 && rbad) atomicOr(&m[9], 1u << (r >> 4));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const unsigned nz = __ballot_sync(~0u, cnz[j]);
        const unsigned bad = __ballot_sync(~0u, cbad[j]);
        if (l == 0) {
            if (nz) atomicOr(&m[j], nz);
            const unsigned sb = ((bad & 0xffffu) ? 1u : 0u) << (2 * j)
                              | ((bad >> 16) ? 1u : 0u) << (2 * j + 1);
            if (sb) atomicOr(&m[4], sb);
        }
    }
    __syncthreads();
    if (t < F64_MASK_WORDS)
        masks[(long long)blockIdx.x * F64_MASK_WORDS + t] = m[t];
}

// need[p] bit s: slab s of pair p runs, because a k of it has a non-zero
// column of A[a_idx[p]] and a non-zero row of B[b_idx[p]], or either holds
// an Inf or a NaN there.  Every other slab multiplies only zeros and is
// neither copied nor run.
__global__ void __launch_bounds__(F64_THREADS)
f64_pair_need(const int* __restrict__ a_idx, const int* __restrict__ b_idx,
              const unsigned* __restrict__ masks_a,
              const unsigned* __restrict__ masks_b,
              unsigned char* __restrict__ need, int p_cap) {
    const int p = blockIdx.x * F64_THREADS + threadIdx.x;
    if (p >= p_cap) return;
    const unsigned* ma = masks_a + (long long)a_idx[p] * F64_MASK_WORDS;
    const unsigned* mb = masks_b + (long long)b_idx[p] * F64_MASK_WORDS;
    unsigned n = (ma[4] | mb[9]) & 0xffu;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
        const unsigned k = ma[h] & mb[5 + h];
        n |= ((k & 0xffffu) ? 1u : 0u) << (2 * h)
           | ((k >> 16) ? 1u : 0u) << (2 * h + 1);
    }
    need[p] = (unsigned char)n;
}

// One block a C tile: the needed slabs of the tile's pairs [seg_ptr[tile],
// seg_ptr[tile + 1]), in stream order, as a stream over the ring (every
// thread walks them alike: pair wq, its slabs still to issue wbits).  Slab
// s is issued F64_STAGES - 1 slabs ahead into stage s % F64_STAGES, and its
// masks are written one step ahead: at step s, after the barrier that makes
// slab s + 1 and the masks of slab s visible (and ends every read of slab
// s - 1 and of the masks of slab s - 1), the block issues slab s +
// F64_STAGES - 1 into the stage of slab s - 1, writes the masks of slab
// s + 1, runs slab s's blocks on the tensor cores and ORs its pattern into
// the flags.  A tile no slab of which runs is stored as zeros.
__global__ void __launch_bounds__(F64_THREADS, 1)
macro_pairs_f64_kernel(const double* __restrict__ a_dense,
                       const double* __restrict__ b_dense,
                       const int* __restrict__ a_idx,
                       const int* __restrict__ b_idx,
                       const int* __restrict__ seg_ptr,
                       const unsigned char* __restrict__ need,
                       double* __restrict__ c_num,
                       unsigned char* __restrict__ c_flag) {
    extern __shared__ __align__(16) unsigned char f64_smem[];
    F64Shared& sh = *reinterpret_cast<F64Shared*>(f64_smem);
    const int t = threadIdx.x;
    const long long tile = blockIdx.x;
    const int lo = seg_ptr[tile], n_pairs = seg_ptr[tile + 1] - lo;
    if (t == 0) sh.n_slabs = 0;
    __syncthreads();
    for (int q = t; q < n_pairs; q += F64_THREADS) {
        const unsigned nb = need[lo + q];
        if (q < F64_NEED_CAP) sh.need[q] = (unsigned char)nb;
        if (nb != 0u) atomicAdd(&sh.n_slabs, __popc(nb));
    }
    __syncthreads();
    const int n_slabs = sh.n_slabs;
    int wq = -1;
    unsigned wbits = 0u;
    auto issue = [&](int s) {
        if (s >= n_slabs) return;
        while (wbits == 0u) {
            ++wq;
            wbits = wq < F64_NEED_CAP ? sh.need[wq] : need[lo + wq];
        }
        const int ks = __ffs(wbits) - 1;
        wbits &= wbits - 1u;
        const int q = lo + wq;
        f64_issue(sh.st[s % F64_STAGES],
                  a_dense + (long long)a_idx[q] * TILE_ELEMS,
                  b_dense + (long long)b_idx[q] * TILE_ELEMS, F64_KS * ks, t);
    };
    auto masks = [&](int s) {
        f64_masks(sh.st[s % F64_STAGES], sh.am[s & 1], sh.bm[s & 1],
                  sh.ag[s & 1], sh.bg[s & 1], t);
    };
    F64Frag fr;
#pragma unroll
    for (int s = 0; s < F64_STAGES - 1; ++s) {
        issue(s);
        cp_async_commit();
    }
    if (n_slabs > 0) {
        cp_async_wait_n<F64_STAGES - 2>();  // slab 0
        __syncthreads();
        masks(0);
    }
    for (int s = 0; s < n_slabs; ++s) {
        cp_async_wait_n<F64_STAGES - 3>();  // slab s + 1
        __syncthreads();
        issue(s + F64_STAGES - 1);
        cp_async_commit();
        if (s + 1 < n_slabs) masks(s + 1);
        const unsigned live = fr.slab(sh.st[s % F64_STAGES], sh.ag[s & 1],
                                      sh.bg[s & 1]);
        fr.pattern(sh.am[s & 1], sh.bm[s & 1], live);
    }
    fr.store(c_num + tile * TILE_ELEMS, c_flag + tile * TILE_ELEMS);
}

// per launch: the attribute belongs to the current device
template <class Kernel>
cudaError_t allow_tc_smem(Kernel kernel) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
}

template <bool RAGGED>
cudaError_t launch_class(const float* a_dense, const float* b_dense,
                         const int* ab_bases, const int* p_ptr,
                         const int* a_offs, const int* b_offs, int t, int p,
                         int n_steps, long long base, float* c_num,
                         unsigned char* c_flag, cudaStream_t stream) {
    const cudaError_t attr = allow_tc_smem(macro_class_kernel<RAGGED>);
    if (attr != cudaSuccess) return attr;
    macro_class_kernel<RAGGED><<<n_steps * t, TC_THREADS, TC_SMEM, stream>>>(
        a_dense, b_dense, ab_bases, p_ptr, a_offs, b_offs, t, p, base,
        c_num, c_flag);
    return cudaGetLastError();
}

}  // namespace

// c_num (c_cap, 128, 128) f32 and c_flag (c_cap, 128, 128) u8 are written
// whole; seg_ptr has c_cap + 1 entries; next is one int, 0 at the launch.
// grid: blocks of the persistent kernel (the wrapper passes the SM count;
// at most c_cap are launched).
extern "C" int macro_accumulate_pairs_f32(
        const float* a_dense, const float* b_dense, const int* a_idx,
        const int* b_idx, const int* seg_ptr, float* c_num,
        unsigned char* c_flag, int c_cap, int grid, int* next,
        cudaStream_t stream) {
    if (c_cap <= 0) return (int)cudaSuccess;
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
    const cudaError_t attr = allow_tc_smem(macro_pairs_kernel);
    if (attr != cudaSuccess) return (int)attr;
    macro_pairs_kernel<<<grid < c_cap ? grid : c_cap, TC_THREADS, TC_SMEM,
                         stream>>>(a_dense, b_dense, a_idx, b_idx, seg_ptr,
                                   next, c_cap, c_num, c_flag);
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

// The float64 pair stream: c_num (c_cap, 128, 128) f64 and c_flag
// (c_cap, 128, 128) u8 are written whole, one block a C tile; seg_ptr has
// c_cap + 1 entries.  First the k-masks of the n_a A tiles and the n_b B
// tiles (masks_a / masks_b, F64_MASK_WORDS words a tile; the same buffer,
// computed once, where both operands are one table) and the slabs that
// run of each of the p_cap pairs (need, a byte a pair).
extern "C" int macro_accumulate_pairs_f64(
        const double* a_dense, const double* b_dense, const int* a_idx,
        const int* b_idx, const int* seg_ptr, double* c_num,
        unsigned char* c_flag, int c_cap, int n_a, int n_b, int p_cap,
        unsigned* masks_a, unsigned* masks_b, unsigned char* need,
        cudaStream_t stream) {
    if (c_cap <= 0) return (int)cudaSuccess;
    if (n_a <= 0 || n_b <= 0 || p_cap < 0) return (int)cudaErrorInvalidValue;
    f64_tile_masks<<<n_a, F64_THREADS, 0, stream>>>(a_dense, masks_a);
    if (masks_b != masks_a)
        f64_tile_masks<<<n_b, F64_THREADS, 0, stream>>>(b_dense, masks_b);
    if (p_cap > 0)
        f64_pair_need<<<(p_cap + F64_THREADS - 1) / F64_THREADS, F64_THREADS,
                        0, stream>>>(a_idx, b_idx, masks_a, masks_b, need,
                                     p_cap);
    // per launch: the attribute belongs to the current device
    const cudaError_t attr = cudaFuncSetAttribute(
        macro_pairs_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        F64_SMEM);
    if (attr != cudaSuccess) return (int)attr;
    macro_pairs_f64_kernel<<<c_cap, F64_THREADS, F64_SMEM, stream>>>(
        a_dense, b_dense, a_idx, b_idx, seg_ptr, need, c_num, c_flag);
    return (int)cudaGetLastError();
}
