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
// span, so no B window is staged): a block owns a range of 1,024 columns
// of a group of 3 consecutive C rows, and the groups of one column range
// run together, so the words of A and the shifted words of B that their
// pairs read meet in L1 and L2 and come from device memory about once; it
// stages only the pair tables in shared memory, and writes each C row (and
// count row) once, coalesced.  Staging the block's A words in shared
// memory, with one block for every C row of its columns, measured slower:
// the stage took the L1 that the B reads hit in, and the columns in flight
// spread over most of the matrix.
//
// The float64 entries (`dia_multiply_dense_f64`, `dia_multiply_pairs_f64`)
// serve the f64 parity mode, which the JAX package runs through the same
// two kernels (pallas_dia_mode does not test the dtype).  Each product and
// each sum is rounded on its own (__dmul_rn, __dadd_rn, no contraction into
// an FMA: `madd`), in ascending A band, so they agree bit for bit with the
// plain PyTorch version, which multiplies and then adds.  The dense entry
// is the float32 dense kernel above, templated on the word (Dense<T>): the
// same staged window, rotation, register naming and reloads, with 8-byte
// cp.async copies and 16-byte pieces of 2 words.  Its geometry is its own:
// a thread owns 4 x 4 C elements (not 8 x 4), which keeps a thread's live
// window words, sums and counts within 128 registers, so that two blocks of
// 256 threads share an SM and one block's staging overlaps the other's
// products, as in float32; the window budget is the same 112 KB, so the
// chunks hold fewer bands.  A lane's I = 4 words are 32 bytes, so a quarter
// warp's 16-byte loads of one row span 256 bytes and meet each bank twice.
// Against 8 x 2 a thread (207 registers, so one block of 256 an SM, or two
// of 128), 4 x 4 measured 3% and 14% faster with counts, and values-only
// 8% slower than one block of 256 and 6% faster than two of 128
// (bench/k4_split.py, PERF.md).  Its arithmetic costs two FP64
// instructions a product (DMUL, DADD).  The pairs entry is likewise the
// float32 pairs kernel templated on the word (pair_rows): the same
// geometry (PAIR_THREADS, PAIR_COLS), row groups, tables and unchecked
// interior blocks, two pairs' loads in flight a step.  4 columns a thread
// measured fastest for both words: for float64 1-4% faster than 2 and
// 10-40% faster than 1 (bench/k4_split.py, PERF.md).
//
// Plain C interface, no PyTorch headers: the wrapper
// (ops/dia_kernels.py) allocates the outputs, computes the launch shapes
// (dense_launch, pairs_launch), passes raw pointers and the current stream,
// and raises if the returned cudaError_t is not 0.

#include <cuda_runtime.h>

namespace {

// The pairs entries' geometry, both words (ops/dia_kernels.py's
// PAIR_THREADS, PAIR_COLS): a block owns PAIR_THREADS * PAIR_COLS columns.
constexpr int PAIR_THREADS = 256;   // threads a block of the pairs entries
constexpr int PAIR_COLS = 4;        // columns a thread
constexpr int MAX_SMEM = 227 * 1024;

// The dense entry's geometry for its word type (ops/dia_kernels.py's
// DENSE_GEOMETRY): a thread owns ROWS x I C elements (I consecutive
// columns), a block has at most THREADS threads, and MIN_BLOCKS of them
// share an SM (which caps the registers a thread).
template <class T> struct Dense;
template <> struct Dense<float> {
    static constexpr int ROWS = 8;
    static constexpr int I = 4;
    static constexpr int THREADS = 256;
    static constexpr int MIN_BLOCKS = 2;
};
template <> struct Dense<double> {
    static constexpr int ROWS = 4;
    static constexpr int I = 4;
    static constexpr int THREADS = 256;
    static constexpr int MIN_BLOCKS = 2;
};

// Asynchronous copy of one word (4 or 8 bytes) from global to shared
// memory; ok == false writes a zero and reads nothing (src must still be a
// valid address).
__device__ __forceinline__ void copy_word(float* dst, const float* src,
                                          bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void copy_word(double* dst, const double* src,
                                          bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 8 : 0) : "memory");
}

// 16-byte pieces: 4 floats or 2 doubles, loaded and stored whole.
__device__ __forceinline__ void load16(const float* p, float (&w)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
}
__device__ __forceinline__ void load16(const double* p, double (&w)[2]) {
    const double2 x = *reinterpret_cast<const double2*>(p);
    w[0] = x.x; w[1] = x.y;
}
__device__ __forceinline__ void store16(float* p, const float* w) {
    *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store16(double* p, const double* w) {
    *reinterpret_cast<double2*>(p) = make_double2(w[0], w[1]);
}

// acc + a * b: one fused rounding in float32 (the float32 entries' order);
// in float64 the product and the sum each rounded on their own, as the
// plain version multiplies and then adds (no contraction into an FMA).
__device__ __forceinline__ float madd(float acc, float a, float b) {
    return fmaf(a, b, acc);
}
__device__ __forceinline__ double madd(double acc, double a, double b) {
    return __dadd_rn(acc, __dmul_rn(a, b));
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
// One template serves both word types (Dense<T>, madd).
template <class T, bool COUNTS>
__global__ void __launch_bounds__(Dense<T>::THREADS, Dense<T>::MIN_BLOCKS)
dia_dense_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const int* __restrict__ offs, T* __restrict__ c,
                 float* __restrict__ cnt, int d1n, int d2n, int dcn,
                 long long n_i, long long n_k, long long n_out, int tr_log2,
                 int kc, int s, int cw_log2, int b_off) {
    constexpr int ROWS = Dense<T>::ROWS, I = Dense<T>::I;
    constexpr int PADR = ROWS - 1;  // zero rows on each side of the window
    constexpr int VW = 16 / (int)sizeof(T);     // words a 16-byte piece
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
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
    // cc + w + sh, and a thread's first word at I tc + P + sh with
    // P = rc0 + ROWS tr - dlo - wr0 + PADR, a multiple of VW with this sh
    auto shift = [&](int wr0, int dlo) {
        return (dlo + wr0 - rc0 - PADR) & (VW - 1);
    };
    // stage the chunk [kb, ke): its A rows, then the B window.  Every word
    // is an asynchronous copy of its own (zero-filled where it lies outside
    // A or B), so a thread has all of its copies in flight at once;
    // neighbouring lanes copy neighbouring words
    const int l_log2 = 31 - __clz(L);
    auto stage = [&](int kb, int ke, int wr0, int nrows, int dlo, int dhi) {
        T* bw = smem + b_off;
        for (int e = t; e < (ke - kb) << l_log2; e += nthreads) {
            const int kk = e >> l_log2, cc = e & (L - 1);
            const long long i = i0 + cc;
            const bool ok = i < n_i;
            copy_word(smem + e, ok ? a + (long long)(kb + kk) * n_i + i : a,
                      ok);
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
                copy_word(bw + w * s + (p < s ? p : p - s),
                          ok ? b + (long long)k2 * n_k + j : b, ok);
            }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    };

    T acc[ROWS][I];
    // counts, two to a register (16 bits each: a count is at most d1n,
    // which dense_launch keeps below 2^16)
    unsigned num[ROWS][I / 2];
    // B registers by anti-diagonal d = rho + iota and slot (rho - step) % ROWS
    T bv[ROWS + I - 1][ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int i = 0; i < I; ++i) {
            acc[r][i] = T(0);
            if (i % 2 == 0) num[r][i / 2] = 0u;
        }

    for (int kb = 0, ke; kb < d1n; kb = ke) {
        ke = chunk_end(offs, kb, d1n, kc);
        int wr0, nrows, dlo;
        const int dhi = window(kb, ke, wr0, nrows, dlo);
        if (nrows == 0) continue;       // the block's rows reach no B row
        stage(kb, ke, wr0, nrows, dlo, dhi);
        __syncthreads();
        const T* as = smem;
        const T* bw = smem + b_off;
        // a chunk of consecutive offsets (every chunk of a stencil) needs no
        // offset load in the band loop
        const bool consecutive = dhi - dlo == ke - 1 - kb;
        // the positions of the thread's words in every window row: NV
        // 16-byte pieces from I tc + P + sh (mod s)
        constexpr int NV = (ROWS + I - 1 + VW - 1) / VW;
        int pos[NV];
        {
            const int p0 = I * tc + rc0 + tr * ROWS - dlo - wr0 + PADR
                + shift(wr0, dlo);
#pragma unroll
            for (int v = 0; v < NV; ++v) pos[v] = ((p0 + VW * v) % s + s) % s;
        }
        // window row w into register slot `slot`: its words at anti-
        // diagonals 0 .. ROWS + I - 2
        auto load_row = [&](const int w, const int slot) {
            const T* row = bw + w * s;
#pragma unroll
            for (int v = 0; v < NV; ++v) {
                T y[VW];
                load16(row + pos[v], y);
#pragma unroll
                for (int e = 0; e < VW; ++e)
                    if (VW * v + e < ROWS + I - 1) bv[VW * v + e][slot] = y[e];
            }
        };
        // one band: the thread's B registers (all ROWS rows where `fresh`,
        // else the one new row at slot phase u), its A words, its ROWS x I
        // products
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
            T av[I];
#pragma unroll
            for (int i = 0; i < I; i += VW) {
                T y[VW];
                load16(as + (k - kb) * L + tc * I + i, y);
#pragma unroll
                for (int e = 0; e < VW; ++e) av[i + e] = y[e];
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
                for (int i = 0; i < I; ++i) {
                    const T x = bv[r + i][(r - u) & (ROWS - 1)];
                    acc[r][i] = madd(acc[r][i], av[i], x);
                    if (COUNTS && av[i] != T(0) && x != T(0))
                        num[r][i / 2] += 1u << (16 * (i % 2));
                }
        };
        // groups of up to ROWS consecutive bands: the first loads all ROWS
        // rows unless it continues the previous group, the others one new
        // row each.  A group
        // of ROWS bands that all reach the thread's rows runs without a
        // branch (its loads can be issued ahead of the products); elsewhere
        // a gap in the offsets or rows leaving B's range end a group
        // early, and the next one reloads
        bool have = false;
        int dprev = 0;
        int k = kb;
        while (k < ke) {
            int dl = consecutive ? dlo + (k - kb) : __ldg(offs + k) - a0;
            int k2lo = rc0 + tr * ROWS - dl;
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
                    k2lo = rc0 + tr * ROWS - dl;
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
        const int row = rc0 + tr * ROWS + r;
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
            for (int i = 0; i < I; i += VW) store16(c + at + i, &acc[r][i]);
            if constexpr (COUNTS && I % 4 == 0) {
#pragma unroll
                for (int i = 0; i < I; i += 4)
                    *reinterpret_cast<float4*>(cnt + at + i) = make_float4(
                        nf[i], nf[i + 1], nf[i + 2], nf[i + 3]);
            } else if constexpr (COUNTS) {
#pragma unroll
                for (int i = 0; i < I; i += 2)
                    *reinterpret_cast<float2*>(cnt + at + i) =
                        make_float2(nf[i], nf[i + 1]);
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

// The pairs entries' C rows [r0, r1) at the block's columns
// i0 + t + PAIR_THREADS * e (e < PAIR_COLS).
// CHECK false: an interior block, all of whose columns lie below n_out and
// all of whose shifted B columns lie in [0, n_k), so nothing is tested; else
// a product outside B adds nothing (no madd with a zero, which would turn an
// acc of -0.0 into +0.0 in float32: the dense entry's order) and columns
// past n_out are not stored.  Two pairs a step: their loads in flight
// together, their products added in ascending k1.  One template serves both
// word types (madd).
template <class T, bool COUNTS, bool CHECK>
__device__ __forceinline__ void pair_rows(
        const T* __restrict__ a, const T* __restrict__ b, const int* rp,
        const int* tp, T* __restrict__ c, float* __restrict__ cnt, int r0,
        int r1, long long i0, long long n_i, long long n_k,
        long long n_out) {
    constexpr int E = PAIR_COLS;
    const int t = threadIdx.x;
    const long long jlo = -i0, jhi = n_k - i0;  // B columns jj of the block
    bool col[E];
#pragma unroll
    for (int e = 0; e < E; ++e)
        col[e] = !CHECK || i0 + t + PAIR_THREADS * e < n_out;
    auto inside = [&](int e, int d1) {
        const long long jj = t + PAIR_THREADS * e + d1;
        return !CHECK || (col[e] && jj >= jlo && jj < jhi);
    };
    // pair p's A and B words at this thread's columns (0 outside B); its
    // shift
    auto load = [&](int p, T (&av)[E], T (&bv)[E]) {
        const int k1 = tp[3 * p];
        const int k2 = tp[3 * p + 1];
        const int d1 = tp[3 * p + 2];
        const T* ak = a + (long long)k1 * n_i + i0 + t;
        const T* bk = b + i0 + (long long)k2 * n_k + d1 + t;
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const bool ok = inside(e, d1);
            av[e] = ok ? __ldg(ak + PAIR_THREADS * e) : T(0);
            bv[e] = ok ? __ldg(bk + PAIR_THREADS * e) : T(0);
        }
        return d1;
    };
#pragma unroll 1
    for (int r = r0; r < r1; ++r) {
        T acc[E];
        float num[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
            acc[e] = T(0);
            num[e] = 0.f;
        }
        auto add = [&](int d1, const T (&av)[E], const T (&bv)[E]) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                if (!inside(e, d1)) continue;
                acc[e] = madd(acc[e], av[e], bv[e]);
                if (COUNTS)
                    num[e] += (av[e] != T(0) && bv[e] != T(0)) ? 1.f : 0.f;
            }
        };
        int p = rp[r];
        const int p1 = rp[r + 1];
        for (; p + 1 < p1; p += 2) {
            T a0[E], b0[E], a1[E], b1[E];
            const int d0 = load(p, a0, b0);
            const int d1 = load(p + 1, a1, b1);
            add(d0, a0, b0);
            add(d1, a1, b1);
        }
        if (p < p1) {
            T a0[E], b0[E];
            const int d0 = load(p, a0, b0);
            add(d0, a0, b0);
        }
        T* cr = c + (long long)r * n_out + i0 + t;
        float* nr = COUNTS ? cnt + (long long)r * n_out + i0 + t : nullptr;
#pragma unroll
        for (int e = 0; e < E; ++e) {
            if (!col[e]) continue;
            cr[PAIR_THREADS * e] = acc[e];
            if (COUNTS) nr[PAIR_THREADS * e] = num[e];
        }
    }
}

// Pairs entries.  Any offset sets: the products of C row r are the triples
// trip[3 * p + {0, 1, 2}] = (k1, k2, d1) for p in [row_ptr[r], row_ptr[r+1]),
// in ascending k1.  A block owns the C columns [i0, i0 + L) (L = PAIR_THREADS
// * PAIR_COLS) of one row group's C rows, a few consecutive ones
// (grid_y groups a column range); thread t the columns i0 + t + PAIR_THREADS
// * e, so a warp's loads and stores of one e are 32 consecutive words.  The
// row groups of one column range are neighbours in the 1-D grid, so they
// run together: their reads of the same A words and of the same B words at
// neighbouring shifts meet in L1 and L2, and the column span in flight is
// small enough for the A and B words it reads to stay in L2.  A and B are
// read through L1 at each pair's shift (a group of a few rows reads an A
// word about once, so staging A in shared memory would cost more than it
// saves, and the L1 it would take is what the B reads hit in); the block
// stages only the two tables in shared memory where they fit (stage_tables,
// ops/dia_kernels.pairs_launch).  Each C row is written once, coalesced.  A
// block whose columns and shifted B columns all lie inside (every block but
// the few at the ends, d1_min / d1_max being the extreme A offsets) runs its
// rows with no bounds test at all (pair_rows).
template <class T, bool COUNTS>
__global__ void __launch_bounds__(PAIR_THREADS)
dia_pairs_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const int* __restrict__ row_ptr,
                 const int* __restrict__ trip, T* __restrict__ c,
                 float* __restrict__ cnt, int dcn, int n_pairs, int d1_min,
                 int d1_max, long long n_i, long long n_k, long long n_out,
                 int grid_y, int stage_tables) {
    constexpr int L = PAIR_THREADS * PAIR_COLS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int t = threadIdx.x;
    const long long i0 = (long long)(blockIdx.x / grid_y) * L;
    const int by = blockIdx.x % grid_y;
    const int r0 = (int)((long long)by * dcn / grid_y);
    const int r1 = (int)((long long)(by + 1) * dcn / grid_y);
    const int* rp = row_ptr;
    const int* tp = trip;
    if (stage_tables) {
        int* st = reinterpret_cast<int*>(smem_raw);
        for (int x = t; x <= dcn; x += PAIR_THREADS) st[x] = __ldg(row_ptr + x);
        for (int x = t; x < 3 * n_pairs; x += PAIR_THREADS)
            st[dcn + 1 + x] = __ldg(trip + x);
        rp = st;
        tp = st + dcn + 1;
        __syncthreads();
    }
    const bool interior = i0 + L <= n_out && i0 + d1_min >= 0 &&
                          i0 + L - 1 + d1_max < n_k;
    if (interior)
        pair_rows<T, COUNTS, false>(a, b, rp, tp, c, cnt, r0, r1, i0, n_i,
                                    n_k, n_out);
    else
        pair_rows<T, COUNTS, true>(a, b, rp, tp, c, cnt, r0, r1, i0, n_i,
                                   n_k, n_out);
}

template <class T, bool COUNTS>
cudaError_t launch_dense(const T* a, const T* b, const int* offs, T* c,
                         float* cnt, int d1n, int d2n, int dcn,
                         long long n_i, long long n_k, long long n_out,
                         int tr_log2, int tc_n, int kc, int s, int cw_log2,
                         int b_off, int stage_words, cudaStream_t stream) {
    // per launch: the attribute belongs to the current device
    const cudaError_t attr = cudaFuncSetAttribute(
        dia_dense_kernel<T, COUNTS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (attr != cudaSuccess) return attr;
    const long long L = (long long)tc_n * Dense<T>::I;
    const int rb = Dense<T>::ROWS << tr_log2;
    const int threads = tc_n << tr_log2;
    if (threads > Dense<T>::THREADS) return cudaErrorInvalidConfiguration;
    const long long grid = (n_out + L - 1) / L * ((dcn + rb - 1) / rb);
    if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    dia_dense_kernel<T, COUNTS><<<(unsigned)grid, threads,
                                  stage_words * (int)sizeof(T), stream>>>(
        a, b, offs, c, cnt, d1n, d2n, dcn, n_i, n_k, n_out, tr_log2, kc, s,
        cw_log2, b_off);
    return cudaGetLastError();
}

// Both dense entries: the word type's kernel with or without counts.
template <class T>
int dense_entry(const void* a, const void* b, const void* offs_a, void* c,
                void* cnt, int d1n, int d2n, int dcn, long long n_i,
                long long n_k, long long n_out, int tr_log2, int tc_n, int kc,
                int s, int cw_log2, int b_off, int stage_words,
                void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (cnt != nullptr)
        return (int)launch_dense<T, true>(
            (const T*)a, (const T*)b, (const int*)offs_a, (T*)c,
            (float*)cnt, d1n, d2n, dcn, n_i, n_k, n_out, tr_log2, tc_n, kc, s,
            cw_log2, b_off, stage_words, st);
    return (int)launch_dense<T, false>(
        (const T*)a, (const T*)b, (const int*)offs_a, (T*)c, nullptr, d1n,
        d2n, dcn, n_i, n_k, n_out, tr_log2, tc_n, kc, s, cw_log2, b_off,
        stage_words, st);
}

// Both pairs entries: the word type's kernel with or without counts, on a
// 1-D grid of grid_y row groups for each column range of PAIR_THREADS *
// PAIR_COLS columns.
template <class T>
int pairs_entry(const void* a, const void* b, const void* row_ptr,
                const void* trip, void* c, void* cnt, int dcn, int n_pairs,
                int d1_min, int d1_max, long long n_i, long long n_k,
                long long n_out, int grid_y, int stage_tables,
                int smem_bytes, void* stream) {
    constexpr long long L = (long long)PAIR_THREADS * PAIR_COLS;
    const long long grid = (n_out + L - 1) / L * grid_y;
    if (grid > 0x7fffffffLL || grid_y <= 0 || grid_y > dcn)
        return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = (cudaStream_t)stream;
    if (cnt != nullptr) {
        dia_pairs_kernel<T, true><<<(unsigned)grid, PAIR_THREADS, smem_bytes,
                                    s>>>(
            (const T*)a, (const T*)b, (const int*)row_ptr, (const int*)trip,
            (T*)c, (float*)cnt, dcn, n_pairs, d1_min, d1_max, n_i, n_k,
            n_out, grid_y, stage_tables);
    } else {
        dia_pairs_kernel<T, false><<<(unsigned)grid, PAIR_THREADS,
                                     smem_bytes, s>>>(
            (const T*)a, (const T*)b, (const int*)row_ptr, (const int*)trip,
            (T*)c, nullptr, dcn, n_pairs, d1_min, d1_max, n_i, n_k, n_out,
            grid_y, stage_tables);
    }
    return (int)cudaGetLastError();
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
    return dense_entry<float>(a, b, offs_a, c, cnt, d1n, d2n, dcn, n_i, n_k,
                              n_out, tr_log2, tc_n, kc, s, cw_log2, b_off,
                              stage_floats, stream);
}

// row_ptr (dcn + 1) int32, trip (3 * n_pairs) int32, d1_min / d1_max the
// least and the greatest A offset; the rest as above.  The launch shape
// (grid_y row groups, whether the tables are staged, the block's bytes of
// shared memory) is ops/dia_kernels.pairs_launch's.
extern "C" int dia_multiply_pairs_f32(const void* a, const void* b,
                                      const void* row_ptr, const void* trip,
                                      void* c, void* cnt, int dcn,
                                      int n_pairs, int d1_min, int d1_max,
                                      long long n_i, long long n_k,
                                      long long n_out, int grid_y,
                                      int stage_tables, int smem_bytes,
                                      void* stream) {
    return pairs_entry<float>(a, b, row_ptr, trip, c, cnt, dcn, n_pairs,
                              d1_min, d1_max, n_i, n_k, n_out, grid_y,
                              stage_tables, smem_bytes, stream);
}

// The float64 entries: a, b and c float64, cnt float32 (nullptr: values
// only), the tables and the launch shapes as for the float32 entries, at
// word size 8 (dense_launch's and pairs_launch's): the float32 entries'
// kernels on 8-byte words.
extern "C" int dia_multiply_dense_f64(const void* a, const void* b,
                                      const void* offs_a, void* c, void* cnt,
                                      int d1n, int d2n, int dcn,
                                      long long n_i, long long n_k,
                                      long long n_out, int tr_log2, int tc_n,
                                      int kc, int s, int cw_log2, int b_off,
                                      int stage_words, void* stream) {
    return dense_entry<double>(a, b, offs_a, c, cnt, d1n, d2n, dcn, n_i, n_k,
                               n_out, tr_log2, tc_n, kc, s, cw_log2, b_off,
                               stage_words, stream);
}

extern "C" int dia_multiply_pairs_f64(const void* a, const void* b,
                                      const void* row_ptr, const void* trip,
                                      void* c, void* cnt, int dcn,
                                      int n_pairs, int d1_min, int d1_max,
                                      long long n_i, long long n_k,
                                      long long n_out, int grid_y,
                                      int stage_tables, int smem_bytes,
                                      void* stream) {
    return pairs_entry<double>(a, b, row_ptr, trip, c, cnt, dcn, n_pairs,
                               d1_min, d1_max, n_i, n_k, n_out, grid_y,
                               stage_tables, smem_bytes, stream);
}
