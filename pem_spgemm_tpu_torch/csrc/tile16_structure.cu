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
//   * tile16_c_rowcol: a half-warp a C tile, lane r its row r.  An
//     exclusive shuffle scan of the 16 rows' popcounts gives each row's
//     first slot after cptr[c]; lane r enumerates its bits in ascending
//     column (__ffs) and writes its slots.  The slots past C_nnz are
//     padding: they take the last row of the last tile, column 0 (and its
//     value), as the JAX package's gather gives them.  Value offsets are
//     64-bit (c_cap * 256 passes 2^31 at full size); values are copied as
//     words (4 or 8 bytes), bit for bit.
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

template <typename V>
__global__ void __launch_bounds__(THREADS)
c_rowcol_kernel(const int* __restrict__ cmask, const int* __restrict__ cptr,
                int c_cap, int c_nnz_cap, const V* __restrict__ c_dense,
                int* __restrict__ rowcol, int* __restrict__ elem_tile,
                V* __restrict__ c_vals) {
    const int r = threadIdx.x & 15;
    const int c = blockIdx.x * TILES + (threadIdx.x >> 4);
    if (c < c_cap) {                                // half-warp-uniform
        const unsigned hm = half_mask();
        uint32_t m = (uint32_t)cmask[(size_t)c * 16 + r] & 0xffffu;
        const int pc = __popc(m);
        int incl = pc;                              // inclusive scan
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) {
            const int x = __shfl_up_sync(hm, incl, off, 16);
            if (r >= off) incl += x;
        }
        int slot = cptr[c] + incl - pc;
        const size_t row0 = (size_t)c * 256 + r * 16;
        while (m) {
            const int col = __ffs(m) - 1;
            m &= m - 1;
            if (slot < c_nnz_cap) {
                rowcol[slot] = (r << 4) | col;
                elem_tile[slot] = c;
                if (c_vals != nullptr) c_vals[slot] = c_dense[row0 + col];
            }
            ++slot;
        }
    }
    // the padding slots [cptr[c_cap], c_nnz_cap), grid-stride
    const int pad_rc = (15 << 4) | 0, pad_t = c_cap - 1;
    const size_t pad_pos = (size_t)pad_t * 256 + pad_rc;
    const int stride = gridDim.x * THREADS;
    for (int s = cptr[c_cap] + blockIdx.x * THREADS + threadIdx.x;
         s < c_nnz_cap; s += stride) {
        rowcol[s] = pad_rc;
        elem_tile[s] = pad_t;
        if (c_vals != nullptr) c_vals[s] = c_dense[pad_pos];
    }
}

unsigned blocks_of(int c_cap) {
    return (unsigned)((c_cap + TILES - 1) / TILES);
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
        c_rowcol_kernel<uint64_t><<<blocks_of(c_cap), THREADS, 0, s>>>(
            (const int*)cmask, (const int*)cptr, c_cap, c_nnz_cap,
            (const uint64_t*)c_dense, (int*)rowcol, (int*)elem_tile,
            (uint64_t*)c_vals);
    else
        c_rowcol_kernel<uint32_t><<<blocks_of(c_cap), THREADS, 0, s>>>(
            (const int*)cmask, (const int*)cptr, c_cap, c_nnz_cap,
            (const uint32_t*)c_dense, (int*)rowcol, (int*)elem_tile,
            (uint32_t*)c_vals);
    return (int)cudaGetLastError();
}
