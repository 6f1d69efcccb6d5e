// Tile16 accumulation: C tiles as sums of 16x16x16 tile products over a
// pair stream sorted by C tile.
//
//     C[c]   = sum over p in [seg_ptr[c], seg_ptr[c+1]) of
//              A[a_idx[p]] @ B[b_idx[p]]
//     CNT[c] = sum over the same p of (A[a_idx[p]] != 0) @ (B[b_idx[p]] != 0)
//     MSK[c] = the row bitmasks of CNT[c] > 0, and their popc sum
//
// This kernel replaces no Pallas kernel: the JAX package computes the Tile16
// tier's numeric phase in XLA (ops/numeric.py accumulate_fused_flat,
// accumulate_dense: a batched einsum of gathered tiles, then a sorted
// scatter-add), and the multi-GPU ring's stage the same way
// (parallel/sharded.py _local_numeric: c_dense.at[sg].add).  On the H100 the
// torch-op version of that (gathers, 0/1 casts, two torch.bmm, index_add_)
// spent 42 of a 48 ms steady multiply at pairbands-500k, against a bound of
// about 0.4 ms, and index_add_ adds with atomics, so its values changed from
// run to run.  Here every C tile has one owner, a warp, that walks its
// pairs in stream order with its sums in registers and writes the tile
// once: no atomics, no zero-fill pass, the same sums in the same order at
// every launch.
//
// Four forms, template arguments of one kernel:
//   * fresh with masks (MASKS): the fused engine on the card.  The
//     structural counts are formed without float products: per pair, the A
//     tile's 16 row masks and the B tile's 16 column masks (16 bits over k,
//     from the raw values: x != 0, so NaN counts and -0.0 does not), and
//     popc(row & col) an entry, in int32.  Only count > 0 is ever used, so
//     this form stores C's structure straight from the counts the lanes
//     hold: each lane ORs its 2 x 4 block's count > 0 bits into its two row
//     words, the four lanes of a row OR theirs together by shuffles, and one
//     lane a row stores the (c_cap, 16) int32 row masks; lane 0 stores the
//     tile's nnz (popc sum).  No (c_cap, 256) count table is written (0.96 GB
//     at pairbands-500k) nor read back.  SEP_PAT: the pattern comes from two
//     other tables (the raw ones, where the values were rounded to tf32 or
//     bfloat16 by the caller), copied beside the values.
//   * fresh with counts (COUNTS): the JAX package's contract
//     (accumulate_fused_flat), the counts stored as float32: exact
//     integers, bit for bit the 0/1 float product's.  No path of the card
//     calls it; it is held against the masks form in the kernel check.
//   * fresh, values only: the masks engine, and a ring rank's first stage.
//   * accumulate (ACC), values only: a ring rank's later stages add into the
//     rank's C.  A tile's stage partial is summed in registers from zero, as
//     in the fresh form, and at the store the old values are loaded and
//     old + partial stored: the fresh form's output added by a torch add,
//     under ==.  A tile without pairs is neither read nor written.
//
// What bounds it on an H100: 2 * 16^3 operations a pair at the FP32 (or
// FP64) rate outside the tensor cores, against 2 KB (4 KB) of operand tiles
// a pair at most and 1-3 KB of C a tile.  This first design is simple:
//   * one warp a C tile, WARPS consecutive tiles a block (neighbours share
//     operand tiles in L1 and L2);
//   * each lane owns a 2 x 4 block of the tile's 256 outputs: rows
//     r0 = 2 * (lane / 4), r0 + 1, columns c0 = 4 * (lane % 4) .. c0 + 3;
//   * a pair's two tiles are copied into the warp's shared-memory slot as
//     16-byte loads through the read-only path, the next pair's loads in
//     flight in registers while the current pair is multiplied; the pairs'
//     indices are loaded 32 at a time, one a lane, and passed by shuffles;
//   * the slot's rows are padded (20 floats, 18 doubles), so the 16-byte
//     row reads of a phase's lanes (two rows), and the mask reads of the
//     16 A lanes and of the 16 B lanes, meet no bank twice;
//   * 128 FMA a lane a pair, in ascending k (DFMA for float64);
//   * each lane stores its outputs as 16-byte pieces; tile offsets are
//     64-bit (c_cap * 256 passes 2^31 at full size).
// No host sync, no allocation, no atomics: a launch can be captured in a
// CUDA graph.  Tensor cores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                // C tiles (warps) a block
constexpr unsigned FULL = 0xffffffffu;

template <typename W>
struct Geo {
    static constexpr int EPC = 16 / (int)sizeof(W);   // elements a piece
    static constexpr int RS = 16 + EPC;               // padded row (elements)
    static constexpr int SLOT = 16 * RS;              // a tile in the slot
    static constexpr int CPR = 16 / EPC;              // 16-byte pieces a row
    static constexpr int PER_LANE = 256 / EPC / 32;   // pieces a lane copies
};

__device__ __forceinline__ float madd(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
    return fma(a, b, c);
}

// four consecutive elements, 16-byte aligned
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
    const double2 t0 = *reinterpret_cast<const double2*>(p);
    const double2 t1 = *reinterpret_cast<const double2*>(p + 2);
    v[0] = t0.x; v[1] = t0.y; v[2] = t1.x; v[3] = t1.y;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// a lane's pieces of one tile (tile-major, 256 elements) into registers
template <typename W>
__device__ __forceinline__ void fetch(const W* __restrict__ table, int idx,
                                      int lane,
                                      uint4 (&reg)[Geo<W>::PER_LANE]) {
    const uint4* g = reinterpret_cast<const uint4*>(table + (size_t)idx * 256);
#pragma unroll
    for (int i = 0; i < Geo<W>::PER_LANE; ++i)
        reg[i] = __ldg(g + lane + 32 * i);
}

// ... and from registers into a padded shared-memory slot
template <typename W>
__device__ __forceinline__ void stage(W* slot, int lane,
                                      const uint4 (&reg)[Geo<W>::PER_LANE]) {
    using G = Geo<W>;
#pragma unroll
    for (int i = 0; i < G::PER_LANE; ++i) {
        const int c = lane + 32 * i;
        *reinterpret_cast<uint4*>(slot + (c / G::CPR) * G::RS
                                  + (c % G::CPR) * G::EPC) = reg[i];
    }
}

template <typename W, bool COUNTS, bool MASKS, bool SEP_PAT, bool ACC>
__global__ void __launch_bounds__(WARPS * 32)
tile16_kernel(const W* __restrict__ a_val, const W* __restrict__ b_val,
              const W* __restrict__ a_pat, const W* __restrict__ b_pat,
              int n_a, int n_b, const int* __restrict__ a_idx,
              const int* __restrict__ b_idx, const int* __restrict__ seg_ptr,
              int c_cap, W* __restrict__ c_val, float* __restrict__ c_cnt,
              int* __restrict__ c_mask, int* __restrict__ c_nnz) {
    using G = Geo<W>;
    constexpr bool PAT = COUNTS || MASKS;               // the 0/1 pattern
    constexpr int NT = (PAT && SEP_PAT) ? 4 : 2;        // tiles a slot
    __shared__ __align__(16) W s_tiles[WARPS][NT][G::SLOT];
    __shared__ __align__(16) uint32_t s_mask[WARPS][32];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c = blockIdx.x * WARPS + warp;
    if (c >= c_cap) return;                             // warp-uniform
    const int lo = seg_ptr[c], hi = seg_ptr[c + 1];
    if (ACC && lo >= hi) return;                        // never touched

    W* sA = s_tiles[warp][0];
    W* sB = s_tiles[warp][1];
    W* mA = s_tiles[warp][NT - 2];      // the pattern's tiles: sA, sB unless
    W* mB = s_tiles[warp][NT - 1];      // SEP_PAT
    const int r0 = 2 * (lane >> 2), c0 = 4 * (lane & 3);

    W acc[2][4];
    int cnt[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) { acc[i][j] = W(0); cnt[i][j] = 0; }

    // the mask a lane forms: lanes 0-15 the k-mask of A row `lane`, lanes
    // 16-31 that of B column `lane - 16`; the A lanes start their k at
    // lane / 8 so that rows 8 apart meet no bank together
    const bool a_lane = lane < 16;
    const W* m_ptr = a_lane ? mA + lane * G::RS : mB + (lane - 16);
    const int m_step = a_lane ? 1 : G::RS;
    const int m_rot = a_lane ? (lane >> 3) : 0;

    if (lo < hi) {
        uint4 ra[G::PER_LANE], rb[G::PER_LANE], pa[G::PER_LANE],
            pb[G::PER_LANE];
        int bat_a = 0, bat_b = 0;
        // the pair p's two tiles (and pattern tiles) into registers; its
        // indices come from the batch of 32 loaded one a lane
        auto issue = [&](int p) {
            const int off = (p - lo) & 31;
            if (off == 0) {                             // warp-uniform
                const int q = p + lane;
                bat_a = q < hi ? a_idx[q] : 0;
                bat_b = q < hi ? b_idx[q] : 0;
            }
            int ai = __shfl_sync(FULL, bat_a, off);
            int bi = __shfl_sync(FULL, bat_b, off);
            ai = min(max(ai, 0), n_a - 1);
            bi = min(max(bi, 0), n_b - 1);
            fetch(a_val, ai, lane, ra);
            fetch(b_val, bi, lane, rb);
            if constexpr (PAT && SEP_PAT) {
                fetch(a_pat, ai, lane, pa);
                fetch(b_pat, bi, lane, pb);
            }
        };
        issue(lo);
        for (int p = lo; p < hi; ++p) {
            __syncwarp();                   // the last pair's reads are done
            stage(sA, lane, ra);
            stage(sB, lane, rb);
            if constexpr (PAT && SEP_PAT) {
                stage(mA, lane, pa);
                stage(mB, lane, pb);
            }
            __syncwarp();
            if (p + 1 < hi) issue(p + 1);   // in flight during the products

            if constexpr (PAT) {
                uint32_t m = 0;
#pragma unroll
                for (int k = 0; k < 16; ++k) {
                    const int kk = (k + m_rot) & 15;
                    m |= (uint32_t)(m_ptr[kk * m_step] != W(0)) << kk;
                }
                s_mask[warp][lane] = m;
                __syncwarp();
                const uint2 ar = *reinterpret_cast<const uint2*>(
                    &s_mask[warp][r0]);
                const uint4 bc = *reinterpret_cast<const uint4*>(
                    &s_mask[warp][16 + c0]);
                const uint32_t rows[2] = {ar.x, ar.y};
                const uint32_t cols[4] = {bc.x, bc.y, bc.z, bc.w};
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        cnt[i][j] += __popc(rows[i] & cols[j]);
            }

#pragma unroll
            for (int kq = 0; kq < 16; kq += 4) {
                W a0[4], a1[4];
                ld4(sA + r0 * G::RS + kq, a0);
                ld4(sA + (r0 + 1) * G::RS + kq, a1);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    W b[4];
                    ld4(sB + (kq + kk) * G::RS + c0, b);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        acc[0][j] = madd(a0[kk], b[j], acc[0][j]);
                        acc[1][j] = madd(a1[kk], b[j], acc[1][j]);
                    }
                }
            }
        }
    }

    const size_t base = (size_t)c * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        W* dst = c_val + base + (r0 + i) * 16 + c0;
        W out[4];
        if constexpr (ACC) {
            W old[4];
            ld4(dst, old);
#pragma unroll
            for (int j = 0; j < 4; ++j) out[j] = old[j] + acc[i][j];
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) out[j] = acc[i][j];
        }
        st4(dst, out);
        if constexpr (COUNTS) {
            const float f[4] = {(float)cnt[i][0], (float)cnt[i][1],
                                (float)cnt[i][2], (float)cnt[i][3]};
            st4(c_cnt + base + (r0 + i) * 16 + c0, f);
        }
    }
    if constexpr (MASKS) {
        // row r0 + i, bits c0 .. c0 + 3 from this lane, the rest of the
        // row from the three other lanes of the quad (lanes 4q .. 4q + 3
        // share r0)
        uint32_t w[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            w[i] = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                w[i] |= (uint32_t)(cnt[i][j] > 0) << (c0 + j);
            w[i] |= __shfl_xor_sync(FULL, w[i], 1);
            w[i] |= __shfl_xor_sync(FULL, w[i], 2);
        }
        if ((lane & 3) == 0)
            *reinterpret_cast<int2*>(c_mask + (size_t)c * 16 + r0) =
                make_int2((int)w[0], (int)w[1]);
        // every lane of a quad now holds its two rows whole: the quad's
        // first lane counts them, and the eight quads' counts are summed
        int pc = ((lane & 3) == 0) ? __popc(w[0]) + __popc(w[1]) : 0;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
            pc += __shfl_xor_sync(FULL, pc, off);
        if (lane == 0) c_nnz[c] = pc;
    }
}

template <typename W, bool COUNTS, bool MASKS, bool SEP_PAT, bool ACC>
int launch(const W* a_val, const W* b_val, const W* a_pat, const W* b_pat,
           int n_a, int n_b, const int* a_idx, const int* b_idx,
           const int* seg_ptr, int c_cap, W* c_val, float* c_cnt,
           int* c_mask, int* c_nnz, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((c_cap + WARPS - 1) / WARPS);
    tile16_kernel<W, COUNTS, MASKS, SEP_PAT, ACC>
        <<<blocks, WARPS * 32, 0, stream>>>(a_val, b_val, a_pat, b_pat, n_a,
                                           n_b, a_idx, b_idx, seg_ptr, c_cap,
                                           c_val, c_cnt, c_mask, c_nnz);
    return (int)cudaGetLastError();
}

// the fresh forms with a pattern (counts or masks), from the value tables
// or from separate pattern tables
template <typename W, bool COUNTS, bool MASKS>
int launch_pattern(const W* a_val, const W* b_val, const W* a_pat,
                   const W* b_pat, int n_a, int n_b, const int* a_idx,
                   const int* b_idx, const int* seg_ptr, int c_cap, W* c_val,
                   float* c_cnt, int* c_mask, int* c_nnz,
                   cudaStream_t stream) {
    if (a_pat == a_val && b_pat == b_val)
        return launch<W, COUNTS, MASKS, false, false>(
            a_val, b_val, a_val, b_val, n_a, n_b, a_idx, b_idx, seg_ptr,
            c_cap, c_val, c_cnt, c_mask, c_nnz, stream);
    if constexpr (sizeof(W) == 8) {
        // float64 ignores the precision: its pattern is its values
        return (int)cudaErrorInvalidValue;
    } else {
        return launch<W, COUNTS, MASKS, true, false>(
            a_val, b_val, a_pat, b_pat, n_a, n_b, a_idx, b_idx, seg_ptr,
            c_cap, c_val, c_cnt, c_mask, c_nnz, stream);
    }
}

template <typename W>
int entry(const W* a_val, const W* b_val, const W* a_pat, const W* b_pat,
          int n_a, int n_b, const int* a_idx, const int* b_idx,
          const int* seg_ptr, int c_cap, W* c_val, float* c_cnt,
          int* c_mask, int* c_nnz, int accumulate, cudaStream_t stream) {
    if (c_cap <= 0) return (int)cudaSuccess;
    const bool masks = c_mask != nullptr;
    if (n_a <= 0 || n_b <= 0 || masks != (c_nnz != nullptr)
        || (masks && c_cnt != nullptr)
        || (accumulate && (c_cnt != nullptr || masks)))
        return (int)cudaErrorInvalidValue;
    if (accumulate)
        return launch<W, false, false, false, true>(
            a_val, b_val, a_val, b_val, n_a, n_b, a_idx, b_idx, seg_ptr,
            c_cap, c_val, nullptr, nullptr, nullptr, stream);
    if (masks)
        return launch_pattern<W, false, true>(
            a_val, b_val, a_pat, b_pat, n_a, n_b, a_idx, b_idx, seg_ptr,
            c_cap, c_val, nullptr, c_mask, c_nnz, stream);
    if (c_cnt != nullptr)
        return launch_pattern<W, true, false>(
            a_val, b_val, a_pat, b_pat, n_a, n_b, a_idx, b_idx, seg_ptr,
            c_cap, c_val, c_cnt, nullptr, nullptr, stream);
    return launch<W, false, false, false, false>(
        a_val, b_val, a_val, b_val, n_a, n_b, a_idx, b_idx, seg_ptr, c_cap,
        c_val, nullptr, nullptr, nullptr, stream);
}

}  // namespace

// a_val / b_val: (n_a, 256), (n_b, 256) value tiles, 16-byte aligned;
// a_pat / b_pat: the tables the pattern is read from (the value tables
// themselves where they are the same pointers); a_idx, b_idx: the pair
// stream (int32); seg_ptr: (c_cap + 1,) int32, tile c owns the pairs
// [seg_ptr[c], seg_ptr[c + 1]); c_val: (c_cap, 256) values; c_cnt: (c_cap,
// 256) float32 counts, or null; c_mask, c_nnz: (c_cap, 16) int32 row masks
// (8-byte aligned) and (c_cap,) int32 nnz of the pattern, or both null; at
// most one of the two pattern forms; none for values only; accumulate: 1
// adds into c_val (no pattern).  Returns the launch's cudaError_t.
extern "C" int tile16_accumulate_pairs_f32(
    const void* a_val, const void* b_val, const void* a_pat,
    const void* b_pat, int n_a, int n_b, const void* a_idx,
    const void* b_idx, const void* seg_ptr, int c_cap, void* c_val,
    void* c_cnt, void* c_mask, void* c_nnz, int accumulate, void* stream) {
    return entry<float>((const float*)a_val, (const float*)b_val,
                        (const float*)a_pat, (const float*)b_pat, n_a, n_b,
                        (const int*)a_idx, (const int*)b_idx,
                        (const int*)seg_ptr, c_cap, (float*)c_val,
                        (float*)c_cnt, (int*)c_mask, (int*)c_nnz, accumulate,
                        (cudaStream_t)stream);
}

// the same for float64 tiles (DFMA); counts stay float32
extern "C" int tile16_accumulate_pairs_f64(
    const void* a_val, const void* b_val, const void* a_pat,
    const void* b_pat, int n_a, int n_b, const void* a_idx,
    const void* b_idx, const void* seg_ptr, int c_cap, void* c_val,
    void* c_cnt, void* c_mask, void* c_nnz, int accumulate, void* stream) {
    return entry<double>((const double*)a_val, (const double*)b_val,
                         (const double*)a_pat, (const double*)b_pat, n_a, n_b,
                         (const int*)a_idx, (const int*)b_idx,
                         (const int*)seg_ptr, c_cap, (double*)c_val,
                         (float*)c_cnt, (int*)c_mask, (int*)c_nnz, accumulate,
                         (cudaStream_t)stream);
}
