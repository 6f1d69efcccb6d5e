// Tile16 structure: the C tiles' row bitmasks and their set bits, over a
// pair stream sorted by C tile.
//
//     cmask[c][r] bit j = OR over p in [seg_ptr[c], seg_ptr[c+1]) of
//                         (a_masks[a_idx[p]][r] & b_tmasks[b_idx[p]][j]) != 0
//     nnz[c]            = popc of the tile's 16 row words
//
// and, from cmask and its nnz scan cptr, every set bit of C in tile-major,
// row-major order: slot cptr[c] + k holds rowcol = (r << 4) | col, the
// owning tile c and, with a value table, c_dense[c][r][col].
//
// These kernels replace no Pallas kernel: the JAX package computes the
// structure phase in XLA (ops/cstruct.py c_masks: 16 bit-plane
// segment_max reductions; c_rowcol: a per-slot gather with a bit-rank
// select; ops/numeric.py extract_values), because scatters are slow on the
// TPU.  On the H100 the torch-op version of c_masks (a 16-step loop of
// (pairs, 16) temporaries, 16 scatter_reduce_ planes with atomics, an
// index_add_) took 82 ms of the masks engine's 88 ms interactive multiply
// at pairbands-500k, and c_rowcol plus extract_values 3.7 of a 9.6 ms
// steady replay.  Both kernels follow the reference system's steps 2b and
// 2c (pem_spgemm_step2_compute_CMasksAndOffsets, _CrowColIdx): every C
// tile has one owner, so no atomics, and each output word is written once.
//
//   * tile16_c_masks: a half-warp a C tile, lane r its row r.  Per pair,
//     lane r loads A's row mask r and B's transposed column mask r; the 16
//     column masks reach every lane by shuffles, and lane r ORs bit j in
//     where its row meets column j.  The pairs' indices are loaded 16 at a
//     time, one a lane, and passed by shuffles.  Lane r writes its row
//     word once, and lane 0 the tile's popc sum.
//   * tile16_c_rowcol: a block takes SPAN C tiles and gives their output
//     slots to its threads IN ORDER (slot-major, as the JAX package's
//     c_rowcol): thread t writes the span's slots first + t, + THREADS,
//     ..., AHEAD of them at a time, their value loads in flight together.
//     The span's row words, each tile's bits above each row (a quad of
//     threads a tile, 4 rows a thread, shuffle scan) and its tiles' first
//     slots are staged in shared memory; a slot finds its tile (the last
//     whose first slot is <= it: 6 steps), its row (the last whose bits
//     above are <= its rank: 4 steps) and its column (a 4-step popc
//     rank-select in the row word).  So each of the three arrays is
//     stored in whole runs of consecutive words, every lane busy, and the
//     values are read in order from each tile's 1 KB (2 KB).  (Lane r
//     enumerating its row's bits by __ffs stored 16 rows' slots at once,
//     48 partial sectors a step, and read 16 rows: 0.3157 ms with values
//     at pairbands-500k against 0.0992 of bytes; a half-warp a tile with
//     its slots in order 0.2733; PERF.md.)  The
//     slots past C_nnz are padding: they take the last row of the last
//     tile, column 0 (and its value), as the JAX package's gather gives
//     them.  Value offsets are 64-bit (c_cap * 256 passes 2^31 at full
//     size); values are copied as words (4 or 8 bytes), bit for bit.
//
// What bounds them on an H100: bytes.  c_masks reads 64 + 64 bytes of
// masks and 8 bytes of indices a pair (the mask tables are small and stay
// in L2) and writes 68 bytes a C tile; c_rowcol reads 68 bytes a tile and
// writes 8 (12 with values, plus a value sector read) a slot.  No host
// sync, no allocation, no atomics: a launch can be captured in a CUDA
// graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILES = 16;               // C tiles (half-warps) a block
constexpr int THREADS = TILES * 16;
constexpr int SPAN = 64;                // c_rowcol: C tiles a block
constexpr int AHEAD = 4;                // c_rowcol: slots a thread has in
                                        // flight (their value loads)

// the shuffle mask of the half-warp that holds this lane
__device__ __forceinline__ unsigned half_mask() {
    return (threadIdx.x & 16) ? 0xffff0000u : 0x0000ffffu;
}

__global__ void __launch_bounds__(THREADS)
c_masks_kernel(const int* __restrict__ a_masks,
               const int* __restrict__ b_tmasks, int n_a, int n_b,
               const int* __restrict__ a_idx, const int* __restrict__ b_idx,
               const int* __restrict__ seg_ptr, int c_cap,
               int* __restrict__ cmask, int* __restrict__ nnz) {
    const int r = threadIdx.x & 15;
    const int c = blockIdx.x * TILES + (threadIdx.x >> 4);
    if (c >= c_cap) return;                         // half-warp-uniform
    const unsigned hm = half_mask();
    const int lo = seg_ptr[c], hi = seg_ptr[c + 1];
    uint32_t row = 0;
    for (int base = lo; base < hi; base += 16) {    // half-warp-uniform
        const int q = base + r;
        const int bat_a = q < hi ? a_idx[q] : 0;
        const int bat_b = q < hi ? b_idx[q] : 0;
        const int n = min(16, hi - base);
        for (int k = 0; k < n; ++k) {
            int ai = __shfl_sync(hm, bat_a, k, 16);
            int bi = __shfl_sync(hm, bat_b, k, 16);
            ai = min(max(ai, 0), n_a - 1);
            bi = min(max(bi, 0), n_b - 1);
            const uint32_t am =
                (uint32_t)__ldg(a_masks + (size_t)ai * 16 + r);
            const uint32_t bt =
                (uint32_t)__ldg(b_tmasks + (size_t)bi * 16 + r);
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const uint32_t col = __shfl_sync(hm, bt, j, 16);
                row |= (uint32_t)((am & col) != 0) << j;
            }
        }
    }
    cmask[(size_t)c * 16 + r] = (int)row;
    int pc = __popc(row);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        pc += __shfl_xor_sync(hm, pc, off, 16);
    if (r == 0) nnz[c] = pc;
}

// The j-th set bit of a 16-bit row word: a 4-step popc rank-select.
__device__ __forceinline__ int select_bit(uint32_t w, int j) {
    int col = 0;
#pragma unroll
    for (int step = 8; step > 0; step >>= 1) {
        const int low = __popc(w & ((1u << step) - 1u));
        if (low <= j) {
            j -= low;
            w >>= step;
            col += step;
        }
    }
    return col;
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
c_rowcol_kernel(const int* __restrict__ cmask, const int* __restrict__ cptr,
                int c_cap, int c_nnz_cap, const V* __restrict__ c_dense,
                int* __restrict__ rowcol, int* __restrict__ elem_tile,
                V* __restrict__ c_vals) {
    __shared__ uint32_t rows[SPAN][16];     // the span's row words
    __shared__ int before[SPAN][16];        // bits of a tile's rows above r
    __shared__ int first[SPAN + 1];         // cptr of the span's tiles
    const int t = threadIdx.x;
    const long long c0 = (long long)blockIdx.x * SPAN;
    const int n_t = (int)min((long long)SPAN, c_cap - c0);
    const int pad0 = cptr[c_cap];
    for (int e = t; e < SPAN * 16; e += THREADS)
        rows[e >> 4][e & 15] = (e >> 4) < n_t
            ? (uint32_t)cmask[c0 * 16 + e] & 0xffffu : 0u;
    if (t <= SPAN) first[t] = cptr[c0 + min(t, n_t)];
    __syncthreads();
    for (int q = t; q < SPAN * 4; q += THREADS) {   // 4 rows a thread
        const int tt = q >> 2, r0 = 4 * (q & 3);
        int cnt[4], sum = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            cnt[j] = __popc(rows[tt][r0 + j]);
            sum += cnt[j];
        }
        int incl = sum;                             // over the tile's quad
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            const int x = __shfl_up_sync(0xffffffffu, incl, off, 4);
            if ((q & 3) >= off) incl += x;
        }
        int run = incl - sum;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            before[tt][r0 + j] = run;
            run += cnt[j];
        }
    }
    __syncthreads();
    // the span's slots, in order over the threads: slot s's tile (the last
    // whose first slot is <= s: 6 steps), row (4 steps) and column
    const int s0 = first[0];
    const int s_end = min(first[n_t], c_nnz_cap);
    for (int base = s0 + t; base < s_end; base += THREADS * AHEAD) {
        int rc[AHEAD], tile[AHEAD];
        V v[AHEAD];
#pragma unroll
        for (int a = 0; a < AHEAD; ++a) {           // value loads in flight
            const int slot = base + a * THREADS;
            if (slot >= s_end) continue;
            int tt = 0;
#pragma unroll
            for (int step = SPAN / 2; step > 0; step >>= 1)
                if (tt + step < n_t && first[tt + step] <= slot) tt += step;
            const int k = slot - first[tt];
            int r = 0;                              // the last row whose
#pragma unroll                                      // bits above are <= k
            for (int step = 8; step > 0; step >>= 1)
                if (before[tt][r + step] <= k) r += step;
            rc[a] = (r << 4) | select_bit(rows[tt][r], k - before[tt][r]);
            tile[a] = tt;
            if (c_vals != nullptr) v[a] = c_dense[(c0 + tt) * 256 + rc[a]];
        }
#pragma unroll
        for (int a = 0; a < AHEAD; ++a) {
            const int slot = base + a * THREADS;
            if (slot >= s_end) continue;
            rowcol[slot] = rc[a];
            elem_tile[slot] = (int)(c0 + tile[a]);
            if (c_vals != nullptr) c_vals[slot] = v[a];
        }
    }
    // the padding slots [cptr[c_cap], c_nnz_cap), grid-stride
    const int pad_rc = (15 << 4) | 0, pad_t = c_cap - 1;
    const size_t pad_pos = (size_t)pad_t * 256 + pad_rc;
    const int stride = gridDim.x * THREADS;
    for (int s = pad0 + blockIdx.x * THREADS + threadIdx.x;
         s < c_nnz_cap; s += stride) {
        rowcol[s] = pad_rc;
        elem_tile[s] = pad_t;
        if (c_vals != nullptr) c_vals[s] = c_dense[pad_pos];
    }
}

unsigned blocks_of(int c_cap, int tiles = TILES) {
    return (unsigned)((c_cap + tiles - 1) / tiles);
}

}  // namespace

// a_masks: (n_a, 16) int32 row bitmaps over k of A's tiles; b_tmasks:
// (n_b, 16) int32 column bitmaps over k of B's tiles; a_idx, b_idx: the
// pair stream (int32); seg_ptr: (c_cap + 1,) int32, tile c owns the pairs
// [seg_ptr[c], seg_ptr[c + 1]); cmask: (c_cap, 16) int32 out; nnz:
// (c_cap,) int32 out.  Returns the launch's cudaError_t.
extern "C" int tile16_c_masks(const void* a_masks, const void* b_tmasks,
                              int n_a, int n_b, const void* a_idx,
                              const void* b_idx, const void* seg_ptr,
                              int c_cap, void* cmask, void* nnz,
                              void* stream) {
    if (c_cap <= 0) return (int)cudaSuccess;
    if (n_a <= 0 || n_b <= 0) return (int)cudaErrorInvalidValue;
    c_masks_kernel<<<blocks_of(c_cap), THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)a_masks, (const int*)b_tmasks, n_a, n_b,
        (const int*)a_idx, (const int*)b_idx, (const int*)seg_ptr, c_cap,
        (int*)cmask, (int*)nnz);
    return (int)cudaGetLastError();
}

// cmask: (c_cap, 16) int32; cptr: (c_cap + 1,) int32 exclusive scan of the
// tiles' nnz; rowcol, elem_tile: (c_nnz_cap,) int32 out; c_dense: the
// (c_cap, 256) value tiles and c_vals (c_nnz_cap,) out, words of ``word``
// bytes (4 or 8), or both null and word 0 for the structure alone.
// Returns the launch's cudaError_t.
extern "C" int tile16_c_rowcol(const void* cmask, const void* cptr,
                               int c_cap, int c_nnz_cap, const void* c_dense,
                               int word, void* rowcol, void* elem_tile,
                               void* c_vals, void* stream) {
    if (c_cap <= 0) return (int)cudaErrorInvalidValue;
    if (c_nnz_cap <= 0) return (int)cudaSuccess;
    const bool vals = c_vals != nullptr;
    if (vals != (c_dense != nullptr) || (vals ? (word != 4 && word != 8)
                                               : word != 0))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (word == 8)
        c_rowcol_kernel<uint64_t><<<blocks_of(c_cap, SPAN),
                                    THREADS, 0, s>>>(
            (const int*)cmask, (const int*)cptr, c_cap, c_nnz_cap,
            (const uint64_t*)c_dense, (int*)rowcol, (int*)elem_tile,
            (uint64_t*)c_vals);
    else
        c_rowcol_kernel<uint32_t><<<blocks_of(c_cap, SPAN),
                                    THREADS, 0, s>>>(
            (const int*)cmask, (const int*)cptr, c_cap, c_nnz_cap,
            (const uint32_t*)c_dense, (int*)rowcol, (int*)elem_tile,
            (uint32_t*)c_vals);
    return (int)cudaGetLastError();
}
