// Tile16 accumulation: C tiles as sums of 16x16x16 tile products over a
// pair stream sorted by C tile.
//
//     C[c]   = sum over the pairs p with c_tile[p] = c of
//              A[a_idx[p]] @ B[b_idx[p]]
//     CNT[c] = sum over the same p of (A[a_idx[p]] != 0) @ (B[b_idx[p]] != 0)
//     MSK[c] = the row bitmasks of CNT[c] > 0, and their popc sum
//
// This kernel replaces no Pallas kernel: the JAX package computes the Tile16
// tier's numeric phase in XLA (ops/numeric.py accumulate_fused_flat,
// accumulate_dense: a batched einsum of gathered tiles, then a sorted
// scatter-add), and the multi-GPU ring's stage the same way
// (parallel/sharded.py _local_numeric: c_dense.at[sg].add).  Every C tile
// has one owner, a warp, that sums the tile's pairs in stream order in
// registers and writes the tile once: no atomics, no zero-fill pass, the
// same sums in the same order at every launch.
//
// Four forms, template arguments of one kernel:
//   * fresh with masks (MASKS): the fused engine on the card.  Only
//     count > 0 is used, so the lanes turn the counts they hold into C's
//     (c_cap, 16) int32 row masks (a row's four lanes OR their bits by
//     shuffles) and the tile's nnz (popc sum); no count table is written.
//   * fresh with counts (COUNTS): the JAX package's contract
//     (accumulate_fused_flat), the counts stored as float32: exact
//     integers, bit for bit the 0/1 float product's.  No path of the card
//     calls it; it is held against the masks form in the kernel check.
//   * fresh, values only (VALUES): the masks engine, and a ring rank's first
//     stage.
//   * accumulate (ACC), values only: a ring rank's later stages add into the
//     rank's C.  A tile's stage partial is summed in registers from zero, as
//     in the fresh forms, and at the store the old values are loaded and
//     old + partial stored: the fresh form's output added by a torch add,
//     under ==.  A tile without pairs is neither read nor written.
//
// What bounds it on an H100: a pair is 2 * 16^3 operations against 2 KB
// (4 KB) of operand tiles, and each distinct tile is met by ~3 pairs, so
// the card is bound by the bytes if the products run on the tensor cores
// and by instruction issue if they do not (the first design, 128 FFMA and
// 24 shared-memory loads a lane a pair, reached 21% of the bytes bound).
// This design:
//   * products on the tensor cores, mma.sync m16n8k8, four a pass over a
//     pair (two k-steps of 8, two column blocks of 8).  float32 tables run
//     tf32: at precision "highest" a 3xTF32 split (x = hi + lo, hi =
//     tf32_rna(x), lo = tf32_rna(x - hi); lo*hi + hi*lo + hi*hi), at "high"
//     one pass on tf32_rna(x), at "default" one pass on x rounded to
//     bfloat16 (nearest even), exact in tf32.  bfloat16 tables are widened
//     in registers (exact in tf32) and run one pass at every precision:
//     their values are what each mode rounds to.  float64 tables run DMMA
//     (m16n8k8 f64), whose fragments have the same shape as tf32's.  Every
//     product of two values a mode keeps is exact in the accumulator, so a
//     mode is "round, then compute at 'highest'", bit for bit;
//   * the structural counts on the tensor cores too: one tf32 pass on the
//     0/1 words of the raw values (x != 0: NaN counts, -0.0 does not, a
//     subnormal counts), exact small integers in float32;
//   * no shared memory: each lane loads its fragments straight from the
//     tile tables, A's through L1 (a warp's C row meets each of its A tiles
//     about nine times at pairbands-500k), B's through L2 alone (a B tile
//     returns only C rows later, and through L1 it would evict A's), and
//     stores C evict-first.  One permutation of k, shared by A and B (the mma's k
//     column t of k-step s, and t + 4, are the tile's k 4t + 2s and
//     4t + 2s + 1), makes a lane's A values of a row four consecutive
//     elements (one 16-byte load of a float32 row); one permutation of n,
//     shared by B's columns and C's (column n of column block nb is the
//     tile's column 2n + nb), makes a lane's B values two consecutive
//     elements of a row and its accumulators four consecutive columns of
//     rows g and g + 8 (g = lane / 4, t = lane % 4): lane (g, t) loads
//     A[g][4t..4t+3], A[g+8][4t..4t+3] and B[4t+i][2g..2g+1] (i < 4), and
//     owns C[g][4t..4t+3] and C[g+8][4t..4t+3];
//   * non-finite operands stay exact: a pair whose values (as the mode
//     multiplies them) hold an Inf, a NaN or a magnitude of 2^63 or more is
//     marked by a warp vote, and the warp forms its product in FP32 FMA
//     from the tables instead (ascending k, the partial added to the sum),
//     so NaN and +-Inf land where the plain version puts them.  Below 2^63
//     no product of the split overflows.  DMMA follows IEEE, so float64
//     needs no mark;
//   * the walk: the stream is cut into spans of S pairs (S = 64, down to 8
//     for a short stream and in the accumulate form, see SPAN_MAX), and the
//     W warps of the grid take spans w, w + W, ... until one starts in the
//     stream's padding (a warp a span, but in the accumulate form at most
//     32 warps an SM).  A warp owns every C tile whose
//     first pair lies in its span, follows its last tile past the span's
//     end, keeps the next AHEAD pairs' loads in flight (a ring of register
//     buffers) across tile boundaries while it multiplies the current
//     pair, and stores a tile when the stream leaves it.  The pairs'
//     indices come 32 at a time, one a lane, the next 32 in flight.  In
//     the fresh forms the warps also take the ranges of 32 tiles of c_cap
//     and write the empty ones (seg_ptr[c] == seg_ptr[c + 1]): values 0,
//     counts 0, masks 0, nnz 0.  The accumulate form has no such ranges:
//     its work follows the stage's pairs, not c_cap.  Spans are static (no
//     ticket counter);
//   * each lane stores its outputs as 16-byte pieces; tile offsets are
//     64-bit (c_cap * 256 passes 2^31 at full size).
// No host sync, no allocation, no atomics: a launch can be captured in a
// CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                // warps a block
// pairs a warp's span of the stream: SPAN_MAX, halved (down to SPAN_MIN)
// while the grid would have fewer than MIN_WARPS warps, so that a short
// stream (a ring stage's few thousand pairs) is not walked by a few warps
// one pair after another
constexpr int SPAN_MAX = 64;
constexpr int SPAN_MIN = 8;
constexpr long long MIN_WARPS = 8192;
constexpr int ZT = 32;                  // tiles a warp's range of c_cap
// the accumulate form's grid: at most ACC_WARPS_PER_SM warps an SM, which
// stride over the spans (a ring stage's stream is padded to the largest
// stage's: most of its spans start in the padding, and a warp stops at
// the first); the fresh forms take a warp a span or range
constexpr long long ACC_WARPS_PER_SM = 32;
constexpr int AHEAD = 1;                // pairs in flight beyond the one
                                        // multiplied (1 to 3)
static_assert(AHEAD >= 1 && AHEAD <= 3, "a ring of 2 to 4 buffers");
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ONE = 0x3F800000u;   // 1.0f, a 0/1 word of the pattern
constexpr int NO_TILE = 0x7FFFFFFF;
constexpr float BIG = 0x1p63f;          // a pair with |x| >= BIG is marked

enum class Form : int { VALUES, COUNTS, MASKS, ACC };
// the float32 entry's precision (SpGEMMConfig.precision: 0 "highest",
// 1 "high", 2 "default"); bfloat16 and float64 tables take HIGHEST
enum class Prec : int { HIGHEST = 0, HIGH = 1, DEFAULT = 2 };

struct Bf16 {                           // a bfloat16 table's element
    unsigned short bits;
};

// a table's element type -> the type C is summed and stored in
template <typename T> struct Sum { using type = float; };
template <> struct Sum<double> { using type = double; };

// The lane's raw fragments of one pair, as loaded: A rows g and g + 8 at
// k 4t..4t+3, B rows 4t + i at columns 2g, 2g + 1.
template <typename T> struct Raw;
template <> struct Raw<float> {
    uint4 a[2];                         // a[i]: A[g + 8i][4t..4t+3]
    uint2 b[4];                         // b[i]: B[4t + i][2g..2g+1]
};
template <> struct Raw<Bf16> {
    uint2 a[2];
    unsigned b[4];
};
template <> struct Raw<double> {
    uint4 a[4];                         // a[2i + h]: A[g + 8i][4t+2h..+1]
    uint4 b[4];
};

// A's fragments through L1 (a warp meets each A tile of its C row again
// and again), B's through L2 alone (a B tile comes back only in C rows far
// down the stream, and would push A's tiles out of L1)
template <typename W>
__device__ __forceinline__ W lda(const void* p) {
    return __ldg(reinterpret_cast<const W*>(p));
}
template <typename W>
__device__ __forceinline__ W ldb(const void* p) {
    return __ldcg(reinterpret_cast<const W*>(p));
}

__device__ __forceinline__ void fetch(const float* __restrict__ A,
                                      const float* __restrict__ B, int g,
                                      int t, Raw<float>& r) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
        r.a[i] = lda<uint4>(A + (g + 8 * i) * 16 + 4 * t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
        r.b[i] = ldb<uint2>(B + (4 * t + i) * 16 + 2 * g);
}
__device__ __forceinline__ void fetch(const Bf16* __restrict__ A,
                                      const Bf16* __restrict__ B, int g,
                                      int t, Raw<Bf16>& r) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
        r.a[i] = lda<uint2>(A + (g + 8 * i) * 16 + 4 * t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
        r.b[i] = ldb<unsigned>(B + (4 * t + i) * 16 + 2 * g);
}
__device__ __forceinline__ void fetch(const double* __restrict__ A,
                                      const double* __restrict__ B, int g,
                                      int t, Raw<double>& r) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            r.a[2 * i + h] = lda<uint4>(A + (g + 8 * i) * 16 + 4 * t
                                        + 2 * h);
#pragma unroll
    for (int i = 0; i < 4; ++i)
        r.b[i] = ldb<uint4>(B + (4 * t + i) * 16 + 2 * g);
}

// The fragments as values: a[i][j] = A[g + 8i][4t + j], b[i][n] =
// B[4t + i][2g + n] (bfloat16 widened exactly: its bits are float32's high
// half).
template <typename V> struct Vals {
    V a[2][4];
    V b[4][2];
};

__device__ __forceinline__ float lo_bf16(unsigned w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
    return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ void widen(const Raw<float>& r, Vals<float>& v) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        v.a[i][0] = __uint_as_float(r.a[i].x);
        v.a[i][1] = __uint_as_float(r.a[i].y);
        v.a[i][2] = __uint_as_float(r.a[i].z);
        v.a[i][3] = __uint_as_float(r.a[i].w);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v.b[i][0] = __uint_as_float(r.b[i].x);
        v.b[i][1] = __uint_as_float(r.b[i].y);
    }
}
__device__ __forceinline__ void widen(const Raw<Bf16>& r, Vals<float>& v) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        v.a[i][0] = lo_bf16(r.a[i].x);
        v.a[i][1] = hi_bf16(r.a[i].x);
        v.a[i][2] = lo_bf16(r.a[i].y);
        v.a[i][3] = hi_bf16(r.a[i].y);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v.b[i][0] = lo_bf16(r.b[i]);
        v.b[i][1] = hi_bf16(r.b[i]);
    }
}
__device__ __forceinline__ double as_double(unsigned lo, unsigned hi) {
    return __hiloint2double((int)hi, (int)lo);
}
__device__ __forceinline__ void widen(const Raw<double>& r,
                                      Vals<double>& v) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint4 q = r.a[2 * i + h];
            v.a[i][2 * h] = as_double(q.x, q.y);
            v.a[i][2 * h + 1] = as_double(q.z, q.w);
        }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v.b[i][0] = as_double(r.b[i].x, r.b[i].y);
        v.b[i][1] = as_double(r.b[i].z, r.b[i].w);
    }
}

__device__ __forceinline__ unsigned tf32_rna(float x) {
    unsigned r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x as the marked path multiplies it: raw at HIGHEST, else rounded as the
// mode rounds it (HIGH: cvt.rna.tf32's rounding done on the bits, a NaN
// kept; DEFAULT: bfloat16, nearest even), as ops/macro.round_operands.
template <Prec P>
__device__ __forceinline__ float rounded(float x) {
    if constexpr (P == Prec::HIGHEST) {
        return x;
    } else if constexpr (P == Prec::HIGH) {
        const unsigned b = __float_as_uint(x);
        return (b & 0x7FFFFFFFu) > 0x7F800000u
            ? x : __uint_as_float((b + 0x1000u) & 0xFFFFE000u);
    } else {
        return __bfloat162float(__float2bfloat16_rn(x));
    }
}

__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// d += a @ b on one 16 x 8 x 8 block.  Fragments (g = lane / 4,
// t = lane % 4): a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)], b[i] = B[t + 4 i][g],
// d[q] = C[g + 8 (q / 2)][2 t + q % 2], for tf32 and for f64 alike.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}
__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[4],
                                    const double (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
          "d"(b[1]));
}

// One pass over a pair: for k-step s and column block nb, the mma's A
// fragment is the lane's a[.][2s], a[.][2s + 1] (the tile's k 4t + 2s,
// 4t + 2s + 1), its B fragment b[2s][nb], b[2s + 1][nb] (the tile's column
// 2g + nb), its accumulators acc[0][nb], acc[0][2 + nb], acc[1][nb],
// acc[1][2 + nb] (columns 4t + nb, 4t + 2 + nb of rows g, g + 8).  TERMS 3
// is the split (lo*hi, hi*lo, hi*hi a block), 1 one product.
template <int TERMS, typename D, typename W>
__device__ __forceinline__ void pass(D (&acc)[2][4], const W (&ah)[2][4],
                                     const W (&bh)[4][2], const W (&al)[2][4],
                                     const W (&bl)[4][2]) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
            D d[4] = {acc[0][nb], acc[0][2 + nb], acc[1][nb],
                      acc[1][2 + nb]};
            const W a[4] = {ah[0][2 * s], ah[1][2 * s], ah[0][2 * s + 1],
                            ah[1][2 * s + 1]};
            const W b[2] = {bh[2 * s][nb], bh[2 * s + 1][nb]};
            if constexpr (TERMS == 3) {
                const W a_lo[4] = {al[0][2 * s], al[1][2 * s],
                                   al[0][2 * s + 1], al[1][2 * s + 1]};
                const W b_lo[2] = {bl[2 * s][nb], bl[2 * s + 1][nb]};
                mma(d, a_lo, b);
                mma(d, a, b_lo);
            }
            mma(d, a, b);
            acc[0][nb] = d[0];
            acc[0][2 + nb] = d[1];
            acc[1][nb] = d[2];
            acc[1][2 + nb] = d[3];
        }
}

// the structural counts of a pair: one tf32 pass on the 0/1 words
template <typename V>
__device__ __forceinline__ void pattern(float (&cnt)[2][4],
                                        const Vals<V>& v) {
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = v.a[i][j] != V(0) ? ONE : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) b[i][n] = v.b[i][n] != V(0) ? ONE : 0u;
    pass<1>(cnt, a, b, a, b);
}

__device__ __forceinline__ float element(const float* p, int i) {
    return p[i];
}
__device__ __forceinline__ float element(const Bf16* p, int i) {
    return __uint_as_float((unsigned)p[i].bits << 16);
}

// A marked pair's product in FP32 FMA, the operands read again from the
// tables and rounded as the mode rounds them, k ascending; the partial is
// added to the sum as a pass's would be.
template <Prec P, typename T>
__device__ __forceinline__ void exact_pair(const T* __restrict__ A,
                                        const T* __restrict__ B, int g,
                                        int t, float (&acc)[2][4]) {
    float part[2][4] = {};
#pragma unroll 1
    for (int k = 0; k < 16; ++k) {
        const float a0 = rounded<P>(element(A, g * 16 + k));
        const float a1 = rounded<P>(element(A, (g + 8) * 16 + k));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float b = rounded<P>(element(B, k * 16 + 4 * t + j));
            part[0][j] = fmaf(a0, b, part[0][j]);
            part[1][j] = fmaf(a1, b, part[1][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
}

// One pair into the lane's sums (and counts).
template <typename T, Prec P, bool PAT>
__device__ __forceinline__ void product(const Raw<T>& r,
                                        const T* __restrict__ A,
                                        const T* __restrict__ B, int g,
                                        int t,
                                        typename Sum<T>::type (&acc)[2][4],
                                        float (&cnt)[2][4]) {
    if constexpr (sizeof(T) == 8) {
        Vals<double> v;
        widen(r, v);
        if constexpr (PAT) pattern(cnt, v);
        pass<1>(acc, v.a, v.b, v.a, v.b);
    } else {
        Vals<float> v;
        widen(r, v);
        if constexpr (PAT) pattern(cnt, v);
        // the words a mode multiplies (hi), and the split's lo at HIGHEST
        constexpr bool SPLIT = P == Prec::HIGHEST && sizeof(T) == 4;
        unsigned ah[2][4], bh[4][2], al[2][4], bl[4][2];
        float mx = 0.0f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float x = v.a[i][j];
                if constexpr (SPLIT) {
                    ah[i][j] = tf32_rna(x);
                    al[i][j] = tf32_rna(x - __uint_as_float(ah[i][j]));
                    mx = max_nan(mx, fabsf(x));
                } else {
                    ah[i][j] = P == Prec::HIGH ? tf32_rna(x)
                             : __float_as_uint(rounded<P>(x));
                    mx = max_nan(mx, fabsf(__uint_as_float(ah[i][j])));
                }
            }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                const float x = v.b[i][n];
                if constexpr (SPLIT) {
                    bh[i][n] = tf32_rna(x);
                    bl[i][n] = tf32_rna(x - __uint_as_float(bh[i][n]));
                    mx = max_nan(mx, fabsf(x));
                } else {
                    bh[i][n] = P == Prec::HIGH ? tf32_rna(x)
                             : __float_as_uint(rounded<P>(x));
                    mx = max_nan(mx, fabsf(__uint_as_float(bh[i][n])));
                }
            }
        if (__any_sync(FULL, !(mx < BIG))) {    // marked (warp-uniform)
            exact_pair<P>(A, B, g, t, acc);
        } else if constexpr (SPLIT) {
            pass<3>(acc, ah, bh, al, bl);
        } else {
            pass<1>(acc, ah, bh, ah, bh);
        }
    }
}

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
    const double2 q0 = *reinterpret_cast<const double2*>(p);
    const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
    v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}
// C is written once and read by the next phase: evict-first, so that it
// does not push the operand tiles out of L2
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
    __stcs(reinterpret_cast<double2*>(p + 2), make_double2(v[2], v[3]));
}

// The warp's store of C tile c (the lanes' rows g, g + 8, columns
// 4t..4t+3).  MASKS: bit 4t + j of row g + 8i where the count is > 0; the
// four lanes of a row (lanes 4g..4g+3) OR theirs by __shfl_xor_sync at 1
// and 2, lane 4g stores row g and lane 4g + 1 row g + 8; the quads' first
// lanes' popc, summed by __shfl_xor_sync at 4, 8, 16, is the nnz lane 0
// stores.
template <Form F, typename S>
__device__ __forceinline__ void store_tile(long long c, int lane,
                                           const S (&acc)[2][4],
                                           const float (&cnt)[2][4],
                                           S* __restrict__ c_val,
                                           float* __restrict__ c_cnt,
                                           int* __restrict__ c_mask,
                                           int* __restrict__ c_nnz) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long off = c * 256 + (g + 8 * i) * 16 + 4 * t;
        S out[4];
        if constexpr (F == Form::ACC) {
            S old[4];
            ld4(c_val + off, old);
#pragma unroll
            for (int j = 0; j < 4; ++j) out[j] = old[j] + acc[i][j];
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) out[j] = acc[i][j];
        }
        st4(c_val + off, out);
        if constexpr (F == Form::COUNTS) st4(c_cnt + off, cnt[i]);
    }
    if constexpr (F == Form::MASKS) {
        unsigned w[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            w[i] = 0u;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                w[i] |= (unsigned)(cnt[i][j] > 0.0f) << (4 * t + j);
            w[i] |= __shfl_xor_sync(FULL, w[i], 1);
            w[i] |= __shfl_xor_sync(FULL, w[i], 2);
        }
        if (t < 2)
            __stcs(c_mask + c * 16 + g + 8 * t, (int)(t == 0 ? w[0] : w[1]));
        int pc = t == 0 ? __popc(w[0]) + __popc(w[1]) : 0;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
            pc += __shfl_xor_sync(FULL, pc, off);
        if (lane == 0) c_nnz[c] = pc;
    }
}

// the pairs [base, base + 32) of the stream, one a lane (past p_cap: no
// tile)
__device__ __forceinline__ void load_batch(const int* __restrict__ c_tile,
                                           const int* __restrict__ a_idx,
                                           const int* __restrict__ b_idx,
                                           int p_cap, long long base,
                                           int lane, int& tc, int& ta,
                                           int& tb) {
    const long long q = base + lane;
    if (q < p_cap) {
        tc = c_tile[q];
        ta = a_idx[q];
        tb = b_idx[q];
    } else {
        tc = NO_TILE;
        ta = tb = 0;
    }
}

// A warp's walk over its pairs: the index batches (the pairs [base,
// base + 32) and the next 32, one a lane), the ring of register buffers
// whose loads are in flight, the open tile and its sums.  step<J>()
// multiplies pair p from buffer J while it issues pair p + AHEAD's loads
// into the buffer pair p - 1 spent; the walk unrolls over the ring, so
// every buffer index is a constant and the ring stays in registers.
template <typename T, Form F, Prec P>
struct Walk {
    using S = typename Sum<T>::type;
    static constexpr bool PAT = F == Form::COUNTS || F == Form::MASKS;
    static constexpr int RING = AHEAD + 1;
    const T* __restrict__ a_val;
    const T* __restrict__ b_val;
    const int* __restrict__ a_idx;
    const int* __restrict__ b_idx;
    const int* __restrict__ c_tile;
    S* __restrict__ c_val;
    float* __restrict__ c_cnt;
    int* __restrict__ c_mask;
    int* __restrict__ c_nnz;
    int n_a, n_b, p_cap, c_cap, lane, g, t;
    long long p, base, end;
    int tc, ta, tb, nc, na, nb;
    int tile;
    Raw<T> buf[RING];
    int buf_a[RING], buf_b[RING];
    S acc[2][4];
    float cnt[2][4];

    // pair q's C tile (q - base < 64: this batch or the next)
    __device__ __forceinline__ int tile_at(long long q) const {
        const int off = (int)(q - base);
        return __shfl_sync(FULL, off >= 32 ? nc : tc, off & 31);
    }
    // pair q's operand tiles into r (loads of valid tiles past the walk's
    // last pair are never used)
    __device__ __forceinline__ void issue(long long q, Raw<T>& r, int& qa,
                                          int& qb) const {
        const int off = (int)(q - base);
        qa = min(max(__shfl_sync(FULL, off >= 32 ? na : ta, off & 31), 0),
                 n_a - 1);
        qb = min(max(__shfl_sync(FULL, off >= 32 ? nb : tb, off & 31), 0),
                 n_b - 1);
        fetch(a_val + (size_t)qa * 256, b_val + (size_t)qb * 256, g, t, r);
    }
    template <int J>
    __device__ __forceinline__ bool step() {
        constexpr int SPARE = (J + AHEAD) % RING;
        issue(p + AHEAD, buf[SPARE], buf_a[SPARE], buf_b[SPARE]);
        const int q_tile = tile_at(p + 1);
        const bool same = q_tile == tile;
        const bool more = same || (p + 1 < end && q_tile < c_cap);
        product<T, P, PAT>(buf[J], a_val + (size_t)buf_a[J] * 256,
                           b_val + (size_t)buf_b[J] * 256, g, t, acc, cnt);
        if (!same) {
            store_tile<F>(tile, lane, acc, cnt, c_val, c_cnt, c_mask, c_nnz);
            if (!more) return true;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    acc[i][k] = S(0);
                    cnt[i][k] = 0.0f;
                }
            tile = q_tile;
        }
        if (++p - base == 32) {                 // warp-uniform
            base += 32;
            tc = nc;
            ta = na;
            tb = nb;
            load_batch(c_tile, a_idx, b_idx, p_cap, base + 32, lane, nc, na,
                       nb);
        }
        return false;
    }
};

// A warp's walk of the span [p0, p0 + span): false where the span
// starts in the stream's padding (and so do all later spans).
template <typename T, Form F, Prec P>
__device__ __forceinline__ bool walk_span(
    const T* __restrict__ a_val, const T* __restrict__ b_val, int n_a,
    int n_b, const int* __restrict__ a_idx, const int* __restrict__ b_idx,
    const int* __restrict__ c_tile, int p_cap, int c_cap,
    typename Sum<T>::type* __restrict__ c_val, float* __restrict__ c_cnt,
    int* __restrict__ c_mask, int* __restrict__ c_nnz, int lane,
    long long p0, int span) {
    using S = typename Sum<T>::type;
    if (c_tile[p0] >= c_cap) return false;      // one word, warp-uniform
    // the first tile that starts in the span
    const long long end = p0 + span;
    int prev = p0 > 0 ? c_tile[p0 - 1] : -1;
    Walk<T, F, P> wk;
    wk.base = p0;
    load_batch(c_tile, a_idx, b_idx, p_cap, wk.base, lane, wk.tc, wk.ta,
               wk.tb);
    for (;;) {
        int up = __shfl_up_sync(FULL, wk.tc, 1);
        if (lane == 0) up = prev;
        const unsigned starts = __ballot_sync(
            FULL, wk.tc < c_cap && wk.tc != up && wk.base + lane < end);
        if (starts) {
            wk.p = wk.base + __ffs(starts) - 1;
            break;
        }
        prev = __shfl_sync(FULL, wk.tc, 31);
        wk.base += 32;
        if (wk.base >= end) return true;        // inside an earlier tile
        // the padding starts inside this span: later spans are all padding
        if (prev >= c_cap || wk.base >= p_cap) return false;
        load_batch(c_tile, a_idx, b_idx, p_cap, wk.base, lane, wk.tc, wk.ta,
                   wk.tb);
    }

    // the walk: pair p multiplied while the tiles of pairs p + 1 .. p + AHEAD
    // are loaded
    wk.a_val = a_val;
    wk.b_val = b_val;
    wk.a_idx = a_idx;
    wk.b_idx = b_idx;
    wk.c_tile = c_tile;
    wk.c_val = c_val;
    wk.c_cnt = c_cnt;
    wk.c_mask = c_mask;
    wk.c_nnz = c_nnz;
    wk.n_a = n_a;
    wk.n_b = n_b;
    wk.p_cap = p_cap;
    wk.c_cap = c_cap;
    wk.lane = lane;
    wk.g = lane >> 2;
    wk.t = lane & 3;
    wk.end = end;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            wk.acc[i][j] = S(0);
            wk.cnt[i][j] = 0.0f;
        }
    load_batch(c_tile, a_idx, b_idx, p_cap, wk.base + 32, lane, wk.nc, wk.na,
               wk.nb);
    wk.tile = wk.tile_at(wk.p);
#pragma unroll
    for (int j = 0; j < AHEAD; ++j)
        wk.issue(wk.p + j, wk.buf[j], wk.buf_a[j], wk.buf_b[j]);
    for (;;) {
        if (wk.template step<0>()) return true;
        if (wk.template step<1>()) return true;
        if constexpr (AHEAD >= 2) {
            if (wk.template step<2>()) return true;
        }
        if constexpr (AHEAD >= 3) {
            if (wk.template step<3>()) return true;
        }
    }
}

// Warp w takes the ranges of c_cap (fresh forms) and the spans of the
// stream numbered w, w + W, w + 2W, ... (W warps in the grid), the spans
// until one starts in the padding.
template <typename T, Form F, Prec P>
__global__ void __launch_bounds__(WARPS * 32)
tile16_kernel(const T* __restrict__ a_val, const T* __restrict__ b_val,
              int n_a, int n_b, const int* __restrict__ a_idx,
              const int* __restrict__ b_idx, const int* __restrict__ c_tile,
              int p_cap, int span, const int* __restrict__ seg_ptr,
              int c_cap, typename Sum<T>::type* __restrict__ c_val,
              float* __restrict__ c_cnt, int* __restrict__ c_mask,
              int* __restrict__ c_nnz) {
    using S = typename Sum<T>::type;
    const int lane = threadIdx.x & 31;
    const long long w0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
    const long long n_warps = (long long)gridDim.x * WARPS;

    if constexpr (F != Form::ACC) {
        // the empty tiles of the warp's ranges of c_cap
        const S zero[2][4] = {};
        const float no_count[2][4] = {};
        for (long long w = w0; w * ZT < c_cap; w += n_warps) {
            const long long c = w * ZT + lane;
            const bool empty = c < c_cap && seg_ptr[c] == seg_ptr[c + 1];
            unsigned m = __ballot_sync(FULL, empty);
            while (m) {
                const int bit = __ffs(m) - 1;
                m &= m - 1;
                store_tile<F>(w * ZT + bit, lane, zero, no_count, c_val,
                              c_cnt, c_mask, c_nnz);
            }
        }
    }
    for (long long w = w0; w * span < p_cap; w += n_warps)
        if (!walk_span<T, F, P>(a_val, b_val, n_a, n_b, a_idx, b_idx,
                                c_tile, p_cap, c_cap, c_val, c_cnt, c_mask,
                                c_nnz, lane, w * span, span))
            return;
}

// the device's SMs (the grid's cap is a multiple of them)
int sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess || n <= 0)
        return 132;
    return n;
}

template <typename T, Form F, Prec P>
int launch(const void* a_val, const void* b_val, int n_a, int n_b,
           const int* a_idx, const int* b_idx, const int* c_tile, int p_cap,
           const int* seg_ptr, int c_cap, void* c_val, float* c_cnt,
           int* c_mask, int* c_nnz, cudaStream_t stream) {
    // the accumulate form's streams are a ring stage's, padded to the
    // largest stage: its valid pairs may be few whatever p_cap is
    int span = F == Form::ACC ? SPAN_MIN : SPAN_MAX;
    while (span > SPAN_MIN && (long long)p_cap < span * MIN_WARPS) span /= 2;
    const long long span_warps = ((long long)p_cap + span - 1) / span;
    const long long range_warps =
        F == Form::ACC ? 0 : ((long long)c_cap + ZT - 1) / ZT;
    long long warps = span_warps > range_warps ? span_warps : range_warps;
    if (warps == 0) return (int)cudaSuccess;
    if constexpr (F == Form::ACC) {
        const long long cap = (long long)sm_count() * ACC_WARPS_PER_SM;
        if (warps > cap) warps = cap;
    }
    const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
    tile16_kernel<T, F, P><<<blocks, WARPS * 32, 0, stream>>>(
        (const T*)a_val, (const T*)b_val, n_a, n_b, a_idx, b_idx, c_tile,
        p_cap, span, seg_ptr, c_cap, (typename Sum<T>::type*)c_val, c_cnt,
        c_mask, c_nnz);
    return (int)cudaGetLastError();
}

template <typename T, Form F>
int launch_prec(int precision, const void* a_val, const void* b_val,
                int n_a, int n_b, const int* a_idx, const int* b_idx,
                const int* c_tile, int p_cap, const int* seg_ptr, int c_cap,
                void* c_val, float* c_cnt, int* c_mask, int* c_nnz,
                cudaStream_t stream) {
    if constexpr (sizeof(T) == 4) {
        if (precision == (int)Prec::HIGH)
            return launch<T, F, Prec::HIGH>(a_val, b_val, n_a, n_b, a_idx,
                                            b_idx, c_tile, p_cap, seg_ptr,
                                            c_cap, c_val, c_cnt, c_mask,
                                            c_nnz, stream);
        if (precision == (int)Prec::DEFAULT)
            return launch<T, F, Prec::DEFAULT>(a_val, b_val, n_a, n_b,
                                               a_idx, b_idx, c_tile, p_cap,
                                               seg_ptr, c_cap, c_val, c_cnt,
                                               c_mask, c_nnz, stream);
    }
    return launch<T, F, Prec::HIGHEST>(a_val, b_val, n_a, n_b, a_idx, b_idx,
                                       c_tile, p_cap, seg_ptr, c_cap, c_val,
                                       c_cnt, c_mask, c_nnz, stream);
}

template <typename T>
int entry(const void* a_val, const void* b_val, int n_a, int n_b,
          const int* a_idx, const int* b_idx, const int* c_tile, int p_cap,
          const int* seg_ptr, int c_cap, void* c_val, float* c_cnt,
          int* c_mask, int* c_nnz, int accumulate, int precision,
          cudaStream_t stream) {
    if (c_cap <= 0) return (int)cudaSuccess;
    const bool masks = c_mask != nullptr;
    if (n_a <= 0 || n_b <= 0 || p_cap < 0 || precision < 0 || precision > 2
        || masks != (c_nnz != nullptr) || (masks && c_cnt != nullptr)
        || (accumulate && (c_cnt != nullptr || masks))
        || (!accumulate && seg_ptr == nullptr))
        return (int)cudaErrorInvalidValue;
    if (accumulate)
        return launch_prec<T, Form::ACC>(precision, a_val, b_val, n_a, n_b,
                                         a_idx, b_idx, c_tile, p_cap, seg_ptr,
                                         c_cap, c_val, nullptr, nullptr,
                                         nullptr, stream);
    if (masks)
        return launch_prec<T, Form::MASKS>(precision, a_val, b_val, n_a, n_b,
                                           a_idx, b_idx, c_tile, p_cap,
                                           seg_ptr, c_cap, c_val, nullptr,
                                           c_mask, c_nnz, stream);
    if (c_cnt != nullptr)
        return launch_prec<T, Form::COUNTS>(precision, a_val, b_val, n_a,
                                            n_b, a_idx, b_idx, c_tile, p_cap,
                                            seg_ptr, c_cap, c_val, c_cnt,
                                            nullptr, nullptr, stream);
    return launch_prec<T, Form::VALUES>(precision, a_val, b_val, n_a, n_b,
                                        a_idx, b_idx, c_tile, p_cap, seg_ptr,
                                        c_cap, c_val, nullptr, nullptr,
                                        nullptr, stream);
}

}  // namespace

// a_val / b_val: (n_a, 256), (n_b, 256) tiles, 16-byte aligned, float32
// (bf16 0) or bfloat16 (bf16 1, widened in registers); a_idx, b_idx,
// c_tile: the pair stream (p_cap int32 each), c_tile ascending, padding
// and pairs of tiles >= c_cap at the end (never read); seg_ptr: (c_cap + 1,)
// int32 pair offsets of the tiles (the fresh forms read it to find the
// tiles without pairs; null in the accumulate form); c_val: (c_cap, 256)
// float32 values; c_cnt: (c_cap, 256) float32 counts, or null; c_mask,
// c_nnz: (c_cap, 16) int32 row masks and (c_cap,) int32 nnz of the
// pattern, or both null; at most one of the two pattern forms; none for
// values only; accumulate: 1 adds into c_val (no pattern); precision: 0
// "highest", 1 "high", 2 "default" (bfloat16 tables: the same one pass at
// each).  Returns the launch's cudaError_t.
extern "C" int tile16_accumulate_pairs_f32(
    const void* a_val, const void* b_val, int n_a, int n_b, int bf16,
    const void* a_idx, const void* b_idx, const void* c_tile, int p_cap,
    const void* seg_ptr, int c_cap, void* c_val, void* c_cnt, void* c_mask,
    void* c_nnz, int accumulate, int precision, void* stream) {
    if (bf16)
        return entry<Bf16>(a_val, b_val, n_a, n_b, (const int*)a_idx,
                           (const int*)b_idx, (const int*)c_tile, p_cap,
                           (const int*)seg_ptr, c_cap, c_val, (float*)c_cnt,
                           (int*)c_mask, (int*)c_nnz, accumulate, 0,
                           (cudaStream_t)stream);
    return entry<float>(a_val, b_val, n_a, n_b, (const int*)a_idx,
                        (const int*)b_idx, (const int*)c_tile, p_cap,
                        (const int*)seg_ptr, c_cap, c_val, (float*)c_cnt,
                        (int*)c_mask, (int*)c_nnz, accumulate, precision,
                        (cudaStream_t)stream);
}

// the same for float64 tiles (DMMA), C in float64; counts stay float32;
// bf16 must be 0 and the precision is ignored (float64 has one)
extern "C" int tile16_accumulate_pairs_f64(
    const void* a_val, const void* b_val, int n_a, int n_b, int bf16,
    const void* a_idx, const void* b_idx, const void* c_tile, int p_cap,
    const void* seg_ptr, int c_cap, void* c_val, void* c_cnt, void* c_mask,
    void* c_nnz, int accumulate, int precision, void* stream) {
    if (bf16) return (int)cudaErrorInvalidValue;
    (void)precision;
    return entry<double>(a_val, b_val, n_a, n_b, (const int*)a_idx,
                         (const int*)b_idx, (const int*)c_tile, p_cap,
                         (const int*)seg_ptr, c_cap, c_val, (float*)c_cnt,
                         (int*)c_mask, (int*)c_nnz, accumulate, 0,
                         (cudaStream_t)stream);
}
