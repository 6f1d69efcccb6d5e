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
// zero (a bounds test in the pairs entry, a zero-filled window in the dense
// one); the operands are never padded.
//
// What bounds them on an H100: device memory needs A and B read once and C
// (and the counts) written once; the arithmetic needs 2 operations a
// product (4 with counts).  Only the widest stencils have enough products
// per byte for the fp32 rate to be the larger bound.
//
// The dense entry stages a B WINDOW in shared memory and reuses it from
// registers.  A block owns C columns [i0, i0 + L) and a range of RB = 8 * TR
// C rows (TR <= 8, so L >= 128 and the lanes of a warp are column blocks of
// the same rows: a band that misses those rows skips the whole warp); it
// walks the A bands in chunks (at most KC bands whose offsets span less
// than KC), and per chunk stages the chunk's A rows [i0, i0 + L) and the B
// window (the B rows the block's C rows reach at these bands, 7 zero rows on
// each side, the columns [i0 + d1_first, i0 + L + d1_last)) into shared
// memory by 4-byte cp.async copies, all of a thread's in flight at once;
// columns outside [0, n_k) and B rows outside [0, d2n) are zero-filled, so
// they add exact zeros.  Two blocks an SM overlap one block's staging with
// the other's products.  A thread owns an 8 x I register block of C (rows
// r0.., columns c0.., I = 4).  C (r, i) at band k reads B[r - d][i + o_k]
// (d = o_k - o_0), whose window row plus window column does not depend on k:
// so each window row is stored ROTATED by its row index (word (w, cc) at
// w * s + (cc + w + sh) mod s, s a multiple of 32), and then the words a
// thread ever reads from a row are 8 + I - 1 consecutive ones, at the same
// positions in every row and every band of the chunk.  One band to the next
// consecutive one, the thread's rows move down one window row: it loads one
// new row (three aligned 16-byte loads, 12 words) and its A words (one
// 16-byte load) for 8 * I FMAs, and keeps the last 8 rows in registers
// named by anti-diagonal and slot (row mod 8), so the shift costs no move in
// a group of up to 8 bands unrolled; a group that runs whole hands its
// registers on to the next one.  At a gap in the A offsets (allowed in the
// dense mode) or where the thread's rows enter or leave B's range, a group
// ends and the next one reloads all 8 rows.  A warp's 16-byte loads of one
// row are 512 consecutive bytes (mod s), so no two lanes meet on a bank.
// The counts variant keeps two counts to a register (16 bits each), which
// leaves it fewer registers to spill.  What it costs on an H100, staging
// against products, is what bench/k2_split.py measures (PERF.md).
// Every C element still sums its products in ascending A-band order with
// fmaf, so the dense and pairs entries agree bit for bit.  The pairs entry
// makes no assumption about the offsets (a gapped set has an unbounded
// span), keeps to one C row per thread and the caches.
//
// Plain C interface, no PyTorch headers: the wrapper
// (ops/dia_kernels.py) allocates the outputs, computes the dense entry's
// launch shape (dense_launch), passes raw pointers and the current stream,
// and raises if the returned cudaError_t is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;    // columns per block of the pairs entry
constexpr int ROWS = 8;         // C rows a thread of the dense entry
constexpr int PADR = ROWS - 1;  // zero rows on each side of the B window
constexpr int MAX_SMEM = 227 * 1024;

// Asynchronous copy of one word from global to shared memory; ok == false
// writes a zero and reads nothing (src must still be a valid address).
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// The chunk of A bands that starts at kb: at most kc bands whose offsets
// span less than kc (ops/dia_kernels.dense_chunks is the same rule).
__device__ __forceinline__ int chunk_end(const int* __restrict__ offs,
                                         int kb, int d1n, int kc) {
    const int o = __ldg(offs + kb);
    int ke = kb + 1;
    while (ke < d1n && ke - kb < kc && __ldg(offs + ke) - o < kc) ++ke;
    return ke;
}

// Dense entry.  B's offsets are the integer range [min_b, min_b + d2n) and
// the C rows are the dense sum range starting at dc0 = offs_a[0] + min_b, so
// the B band of product (k1, C row r) is arithmetic:
//     k2 = r - (offs_a[k1] - offs_a[0]),  column j = i + offs_a[k1].
// offs_a is any ascending set whose sums with B's range leave no gap.
// Thread t: column block tc = t % tc_n, row block tr = t / tc_n, so the
// lanes of a warp share their rows, and a band that misses them skips the
// whole warp.  Shared memory: the A chunk (its bands x L) and, from word
// b_off, the B window, rows of s words, each rotated by its row index.
template <bool COUNTS, int I>
__global__ void __launch_bounds__(256, 2)
dia_dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const int* __restrict__ offs, float* __restrict__ c,
                 float* __restrict__ cnt, int d1n, int d2n, int dcn,
                 long long n_i, long long n_k, long long n_out, int tr_log2,
                 int kc, int s, int cw_log2, int b_off) {
    extern __shared__ __align__(16) float smem[];
    const int t = threadIdx.x, nthreads = blockDim.x;
    const int tc_n = nthreads >> tr_log2;
    const int tc = t & (tc_n - 1), tr = t >> (31 - __clz(tc_n));
    const int L = tc_n * I;
    const int rb = ROWS << tr_log2;
    // the row blocks of one column range are neighbours in the grid, so
    // they run together and find each other's A and B words in L2
    const int gy = (dcn + rb - 1) / rb;
    const long long i0 = (long long)(blockIdx.x / gy) * L;
    const int rc0 = (blockIdx.x % gy) * rb;
    const int a0 = __ldg(offs);

    // the chunk [kb, ke)'s B window: first B row, rows with pads (0: the
    // block's rows reach no B row at these bands), first offset
    auto window = [&](int kb, int ke, int& wr0, int& nrows, int& dlo) {
        dlo = __ldg(offs + kb) - a0;
        const int dhi = __ldg(offs + ke - 1) - a0;
        wr0 = max(0, rc0 - dhi);
        const int wr1 = min(d2n, rc0 + rb - dlo);
        nrows = wr1 > wr0 ? wr1 - wr0 + 2 * PADR : 0;
        return dhi;
    };
    // the rotation's extra shift: window row w, column cc sits at position
    // cc + w + sh, and a thread's first word at 4 tc + P + sh with
    // P = rc0 + 8 tr - dlo - wr0 + PADR, a multiple of 4 with this sh
    auto shift = [&](int wr0, int dlo) {
        return (dlo + wr0 - rc0 - PADR) & 3;
    };
    // stage the chunk [kb, ke): its A rows, then the B window.  Every word
    // is an asynchronous 4-byte copy (zero-filled where it lies outside A or
    // B), so a thread has all of its copies in flight at once; neighbouring
    // lanes copy neighbouring words
    const int l_log2 = 31 - __clz(L);
    auto stage = [&](int kb, int ke, int wr0, int nrows, int dlo, int dhi) {
        float* bw = smem + b_off;
        for (int e = t; e < (ke - kb) << l_log2; e += nthreads) {
            const int kk = e >> l_log2, cc = e & (L - 1);
            const long long i = i0 + cc;
            const bool ok = i < n_i;
            copy4(smem + e, ok ? a + (long long)(kb + kk) * n_i + i : a, ok);
        }
        const int ncols = L + dhi - dlo;
        const long long wc0 = i0 + a0 + dlo;
        const int sh = shift(wr0, dlo);
        const int cw = 1 << cw_log2, rows_per_pass = nthreads >> cw_log2;
        for (int cc = t & (cw - 1); cc < ncols; cc += cw) {
            const long long j = wc0 + cc;
            const bool jok = j >= 0 && j < n_k;
            // (cc + w + sh) mod s, kept below s by one subtraction: the
            // launch shape keeps cc + w + sh below 2 s
            for (int w = t >> cw_log2; w < nrows; w += rows_per_pass) {
                const int k2 = wr0 - PADR + w;
                const bool ok = jok && k2 >= 0 && k2 < d2n;
                const int p = cc + w + sh;
                copy4(bw + w * s + (p < s ? p : p - s),
                      ok ? b + (long long)k2 * n_k + j : b, ok);
            }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    };

    float acc[ROWS][I];
    // counts, two to a register (16 bits each: a count is at most d1n,
    // which dense_launch keeps below 2^16)
    unsigned num[ROWS][I / 2];
    // B registers by anti-diagonal d = rho + iota and slot (rho - step) % ROWS
    float bv[ROWS + I - 1][ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int i = 0; i < I; ++i) {
            acc[r][i] = 0.f;
            if (i % 2 == 0) num[r][i / 2] = 0u;
        }

    for (int kb = 0, ke; kb < d1n; kb = ke) {
        ke = chunk_end(offs, kb, d1n, kc);
        int wr0, nrows, dlo;
        const int dhi = window(kb, ke, wr0, nrows, dlo);
        if (nrows == 0) continue;       // the block's rows reach no B row
        stage(kb, ke, wr0, nrows, dlo, dhi);
        __syncthreads();
        const float* as = smem;
        const float* bw = smem + b_off;
        // a chunk of consecutive offsets (every chunk of a stencil) needs no
        // offset load in the band loop
        const bool consecutive = dhi - dlo == ke - 1 - kb;
        // the positions of the thread's words in every window row: NV
        // 16-byte pieces from 4 tc + P + sh (mod s)
        constexpr int NV = (ROWS + I - 1 + 3) / 4;
        int pos[NV];
        {
            const int p0 = I * tc + rc0 + (tr << 3) - dlo - wr0 + PADR
                + shift(wr0, dlo);
#pragma unroll
            for (int v = 0; v < NV; ++v) pos[v] = ((p0 + 4 * v) % s + s) % s;
        }
        // window row w into register slot `slot`: its words at anti-
        // diagonals 0 .. ROWS + I - 2
        auto load_row = [&](const int w, const int slot) {
            const float* row = bw + w * s;
#pragma unroll
            for (int v = 0; v < NV; ++v) {
                const float4 x =
                    *reinterpret_cast<const float4*>(row + pos[v]);
                const float y[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (4 * v + e < ROWS + I - 1) bv[4 * v + e][slot] = y[e];
            }
        };
        // one band: the thread's B registers (all 8 rows where `fresh`, else
        // the one new row at slot phase u), its A words, its 8 x I FMAs
        auto band = [&](const int u, const bool fresh, const int k2l,
                        const int k) {
            const int wb = k2l - wr0 + PADR;
            if (fresh) {
#pragma unroll
                for (int r = 0; r < ROWS; ++r)
                    load_row(wb + r, (r - u) & (ROWS - 1));
            } else {
                load_row(wb, (0 - u) & (ROWS - 1));
            }
            float av[I];
#pragma unroll
            for (int i = 0; i < I; i += 4) {
                const float4 v = *reinterpret_cast<const float4*>(
                    as + (k - kb) * L + tc * I + i);
                av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z; av[i + 3] = v.w;
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
                for (int i = 0; i < I; ++i) {
                    const float x = bv[r + i][(r - u) & (ROWS - 1)];
                    acc[r][i] = fmaf(av[i], x, acc[r][i]);
                    if (COUNTS && av[i] != 0.f && x != 0.f)
                        num[r][i / 2] += 1u << (16 * (i % 2));
                }
        };
        // groups of up to ROWS consecutive bands: the first loads all 8
        // rows unless it continues the previous group, the others one new
        // row each.  A group
        // of ROWS bands that all reach the thread's rows runs without a
        // branch (its loads can be issued ahead of the FMAs); elsewhere
        // a gap in the offsets or rows leaving B's range end a group
        // early, and the next one reloads
        bool have = false;
        int dprev = 0;
        int k = kb;
        while (k < ke) {
            int dl = consecutive ? dlo + (k - kb) : __ldg(offs + k) - a0;
            int k2lo = rc0 + (tr << 3) - dl;
            if (k2lo + ROWS <= 0 || k2lo >= d2n) {
                have = false;
                ++k;
                continue;
            }
            const bool fresh = !(have && dl == dprev + 1);
            if (consecutive && k + ROWS <= ke && k2lo >= 0) {
#pragma unroll
                for (int u = 0; u < ROWS; ++u)
                    band(u, u == 0 && fresh, k2lo - u, k + u);
                k += ROWS;
                dprev = dl + ROWS - 1;
                have = true;
                continue;
            }
            bool whole = true;
#pragma unroll
            for (int u = 0; u < ROWS; ++u) {
                if (u > 0) {
                    if (k >= ke) { whole = false; break; }
                    dl = consecutive ? dlo + (k - kb)
                                     : __ldg(offs + k) - a0;
                    k2lo = rc0 + (tr << 3) - dl;
                    if (k2lo + ROWS <= 0 || k2lo >= d2n
                            || dl != dprev + 1) {
                        whole = false;
                        break;
                    }
                }
                band(u, u == 0 && fresh, k2lo, k);
                dprev = dl;
                ++k;
            }
            have = whole;
        }
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int row = rc0 + (tr << 3) + r;
        if (row >= dcn) continue;
        float nf[I];
#pragma unroll
        for (int i = 0; i < I; ++i)
            nf[i] = (float)((num[r][i / 2] >> (16 * (i % 2))) & 0xffffu);
        const long long col0 = i0 + tc * I;
        const long long at = (long long)row * n_out + col0;
        if ((n_out & 3) == 0 && col0 + I <= n_out) {
            // whole 16-byte pieces: a warp's lanes store whole rows' spans
#pragma unroll
            for (int i = 0; i < I; i += 4) {
                *reinterpret_cast<float4*>(c + at + i) = make_float4(
                    acc[r][i], acc[r][i + 1], acc[r][i + 2], acc[r][i + 3]);
                if (COUNTS)
                    *reinterpret_cast<float4*>(cnt + at + i) = make_float4(
                        nf[i], nf[i + 1], nf[i + 2], nf[i + 3]);
            }
            continue;
        }
#pragma unroll
        for (int i = 0; i < I; ++i) {
            if (col0 + i < n_out) {
                c[at + i] = acc[r][i];
                if (COUNTS) cnt[at + i] = nf[i];
            }
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

template <bool COUNTS, int I>
cudaError_t launch_dense(const float* a, const float* b, const int* offs,
                         float* c, float* cnt, int d1n, int d2n, int dcn,
                         long long n_i, long long n_k, long long n_out,
                         int tr_log2, int tc_n, int kc, int s, int cw_log2,
                         int b_off, int stage_floats, cudaStream_t stream) {
    // per launch: the attribute belongs to the current device
    const cudaError_t attr = cudaFuncSetAttribute(
        dia_dense_kernel<COUNTS, I>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (attr != cudaSuccess) return attr;
    const long long L = (long long)tc_n * I;
    const int rb = ROWS << tr_log2;
    const long long grid = (n_out + L - 1) / L * ((dcn + rb - 1) / rb);
    if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    dia_dense_kernel<COUNTS, I><<<(unsigned)grid, tc_n << tr_log2,
                                  stage_floats * (int)sizeof(float),
                                  stream>>>(
        a, b, offs, c, cnt, d1n, d2n, dcn, n_i, n_k, n_out, tr_log2, kc, s,
        cw_log2, b_off);
    return cudaGetLastError();
}

}  // namespace

// a (d1n, n_i), b (d2n, n_k), c and cnt (dcn, n_out) float32, row-major and
// contiguous; offs_a (d1n) int32 ascending.  cnt == nullptr selects the
// values-only kernel; both run two blocks an SM.  The launch
// shape (2^tr_log2 row blocks x tc_n column blocks a block, chunk depth kc,
// window row stride s, copy width 2^cw_log2, the window's first word, the
// block's words of shared memory) is
// ops/dia_kernels.dense_launch's, which checks the grid and the shared
// memory.
extern "C" int dia_multiply_dense_f32(const void* a, const void* b,
                                      const void* offs_a, void* c, void* cnt,
                                      int d1n, int d2n, int dcn,
                                      long long n_i, long long n_k,
                                      long long n_out, int tr_log2, int tc_n,
                                      int kc, int s, int cw_log2, int b_off,
                                      int stage_floats, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (cnt != nullptr)
        return (int)launch_dense<true, 4>(
            (const float*)a, (const float*)b, (const int*)offs_a, (float*)c,
            (float*)cnt, d1n, d2n, dcn, n_i, n_k, n_out, tr_log2, tc_n, kc, s,
            cw_log2, b_off, stage_floats, st);
    return (int)launch_dense<false, 4>(
        (const float*)a, (const float*)b, (const int*)offs_a, (float*)c,
        nullptr, d1n, d2n, dcn, n_i, n_k, n_out, tr_log2, tc_n, kc, s,
        cw_log2, b_off, stage_floats, st);
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
