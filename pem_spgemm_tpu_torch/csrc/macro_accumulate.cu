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
// float32 entries' persistent blocks take their tiles from one atomic
// counter), no zero-fill pass, no carry; in the fresh form a tile without
// pairs is stored as zeros.  All offsets are run-time int32 tables, so one
// build serves every plan, and every tile address is 64-bit (113k C tiles
// are 1.85e9 floats).
//
// The two pair-stream entries also have an ACCUMULATE form (the `accumulate`
// argument; a template argument ACC of the kernels, so that the fresh
// instances and the class entries compile without it): the multi-GPU ring
// adds each stage's products into the rank's C, as the JAX ring's
// c_dense.at[sg].add does.  A tile's sums run from zero as in the fresh form;
// at its store the owner loads the tile's values and flags in the pieces it
// stores (ld.global.cs), adds old + partial (one float add an element) and
// ORs the flags.  A tile without pairs (the padding tiles up to c_cap among
// them), or whose slabs all multiply only zeros (a store-only tile), is
// neither read nor written.  Bound: the bytes of the tiles with pairs read
// and written once and each distinct operand tile read once, against the
// fresh form's whole C written once.  A ring stage has pairs for a few
// percent of the rank's C tiles, so the accumulate form walks a LIST of the
// tiles with pairs (ListTiles; built from seg_ptr by the wrapper on the
// device, no host sync) at every precision: the float32 kernels' tickets
// and the float64 kernel's blocks index the list, and no tile without pairs
// takes either; and the tables' k-masks come made (each table's once, by
// its own launch macro_tile_masks_*, read with its ready flag set), so a
// stage reads neither table whole.
//
// What bounds them on an H100: 2 * 128^3 operations a pair against 128 KB of
// operand tile a pair at most (fewer where tiles repeat) and 80 KB of C tile
// written once: operations, on the tensor cores 3 tf32 products a product
// at "highest"; at one pass ("high", "default") the bytes (C written once
// and each distinct operand tile read once).
//
// Every float32 launch is PERSISTENT: one block an SM takes C tiles in
// order from a ticket counter (`next`, zeroed by the wrapper), so the tiles
// in flight stay neighbours and share operand tiles in L2 (a fixed round
// robin lets the blocks drift apart and loses that).  The tiles are a
// launch's WALK: a pair stream's c_cap tiles in stream order (StreamTiles),
// a class launch's tile tk = (step tk / t, tile tk % t) (ClassTiles), or
// the accumulate form's list of the tiles with pairs (ListTiles).  A tile
// has few pairs (1.6-3.3 on the suite's streams), so a block runs one
// STREAM of (tile, pair, 32-deep k-slab) stages across tile boundaries: the
// next tile's first slabs are in flight while the current one runs its last
// products and stores its sums, and no tile fills or drains a ring on its
// own.  An ISSUER (one warp: the Issuer below) claims tiles four ahead
// (ticket, then range, then the first pairs' tiles, then their masks, one
// step a tile) and publishes only the slabs that can hold a non-zero
// product: the tables' k-masks (f32_tile_masks; made once a multiply where
// ops/stencil.py hands one set to all of a plan's launches) give each
// tile's non-zero columns and rows and its marked slabs, and a pair's slab
// runs where a k has a non-zero A column and a non-zero B row, or either
// tile marks it (slabs_needed; wandering64's stream needs 28% of its slabs:
// PERF.md).  A slab it skips holds only products with a zero factor: +-0,
// which change no sum (a sum starts at +0 and so never becomes -0) and set
// no flag, so the result is the bits of running every slab.  After a
// tile's last slab that runs (at once for a tile none of whose slabs runs,
// or without pairs) comes a stage without copies, at which the tile is
// stored evict-first in 16-byte pieces (Frag::store_cs: +0.0 and flags 0
// where no slab ran; the accumulate form adds it into C, and leaves a tile
// none of whose slabs ran); a DONE stage ends the block.
//
// At HIGHEST every launch runs macro_tc_kernel, whose 256 threads stage, split
// and multiply each published slab (tc_stage) behind one barrier a stage.  The
// tile product runs on the tensor cores: wgmma on tf32 operands with a 3xTF32
// split, which keeps the reference's precision "highest" (one tf32 product
// keeps 11 bits of each operand; plain TF32 is not allowed).  Every operand x
// is split as hi = tf32_rna(x), lo = tf32_rna(x - hi), and C accumulates hi*hi
// + hi*lo + lo*hi: each product is then exact to about 2^-22 of |a*b|.  wgmma
// takes tf32 operands K-major only: A's tiles lie so (row i, contiguous k),
// B's do not (row k, contiguous j), so every slab passes through registers
// once: 256 threads copy it raw with cp.async two stages ahead (a ring of two
// raw 32 KB slabs), read it back, split it, and write A as it lies and B
// transposed, each into the 128-byte swizzle that the shared-memory
// descriptors name, over a ring of two split stages (4 x 16 KB a stage) while
// the tensor cores work on the other one.  Two warpgroups each own a 64 x 128
// half of the C tile (64 f32 registers a thread) and issue 3 x 4
// wgmma.m64n128k8 a stage; the stage's partial is added to a second register
// sum in FP32 (round to nearest), so the tensor cores' accumulation rounds
// over one 32-deep slab only.  The pattern comes from the raw f32 values (x !=
// 0; the tf32 hi of a subnormal can be 0): per stage a 32-bit k-mask of each A
// row and of each B column, and a thread ORs (mask_row & mask_col) != 0 into
// the 64 bits of the accumulator elements it owns, so values and flags are
// stored together.  A slab in which a warpgroup's 64 A rows or the B slab hold
// no non-zero adds exact zeros, and the warpgroup skips it (wandering64's
// tiles are about 1/6 full); ptxas then serializes the stage's wgmma chain
// (warning C7518), which costs less than the skipped slabs save (PERF.md).
//
// The precision (SpGEMMConfig.precision, JAX's matmul precision names) is a
// template argument of the three float32 entries, chosen once a launch; the
// k-loop holds no branch on it.  HIGHEST is the 3xTF32 split above, on the
// 256-thread stage.  HIGH and DEFAULT multiply each operand's rounding
// once: HIGH's is tf32_rna(x) (as JAX runs "high" on an NVIDIA card; the
// TPU's "high" is three bf16 passes), DEFAULT's the bfloat16 rounding of x,
// nearest-even.  Both products are then exact in float32 (11 x 11 and 8 x 8
// bits), so a mode is "round both operands, then compute at HIGHEST": its
// plain version (ops/macro.round_operands) and per-product error ((2u +
// u^2) |a*b|, u = 2^-11 in tf32, 2^-8 in bfloat16).
//
// One pass leaves the tensor cores a third of the work, and the 256-thread
// stage's register path (wait on the raw slab, read it back, round, write it
// swizzled, OR the pattern, all behind one barrier a stage) then sets the
// pace, so HIGH and DEFAULT run the ONE-PASS PIPELINE instead, in all three
// entries: over the same walks and the same Issuer, but warp-specialised, with
// no block-wide barrier after its set-up.  A PRODUCER warpgroup (120 registers
// a thread after setmaxnreg) runs the Issuer in its warp 0, which publishes
// each stage (its tiles and slab) once its raw slot is free; the 128 threads
// copy the stage's raw slabs with 16-byte cp.async (rows padded by 16 bytes)
// into a ring of RAW stages, the slot's mbarrier counting each thread's copies
// as landed (cp.async.mbarrier.arrive; one cp.async.bulk a 128-byte row was
// 2.5x slower than the parent: PERF.md); the four warps round each stage into
// a ring of OPS operand stages with its k-masks and ANY_NZ / ANY_BAD bits
// beside it and arrive on its `full` mbarrier.  HIGH writes tf32 words, A as it
// lies and B transposed by a 4 x 4 exchange among a quad's lanes (one 16-byte
// store a lane); DEFAULT writes bfloat16, A K-major in the 64-byte swizzle and
// B as it lies (MN-major, wgmma's transpose immediate), so no transpose.  Two
// CONSUMER warpgroups (192 registers) each wait on `full`, issue the stage's
// wgmma (m64n128k8.tf32 x 4 or m64n128k16.bf16 x 2), OR its pattern, wait,
// release the slot on its `empty` mbarrier and add the partial to the FP32
// sums; at a tile's store-only stage they store it, and the DONE stage ends
// both roles.  Stages stay 32 deep at DEFAULT too, so that both modes share
// the masks, the empty-slab skip and the raw ring (a 64-deep bf16 stage's
// raw slabs would leave room for two raw stages).
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
// before.  At HIGH and DEFAULT the FMA rounds each raw operand as the mode
// does (`rounded`): tf32_rna(3.4028235e38) is Inf, and so is its bfloat16
// rounding, so such a value gives the plain version's Inf there.
//
// The float64 entry `macro_accumulate_pairs_f64` serves the f64 parity mode
// (the JAX package runs float64 tiles through accumulate_macro_pipelined
// too).  It keeps the float32 entry's contract: a stream sorted by C tile,
// padding pairs never read, tiles without pairs stored as zeros (the fresh
// form; the accumulate form leaves them), uint8 flags from the raw values
// (x != 0, so NaN and Inf count), every tile written once by its owner.  Its tile product runs on the FP64 tensor
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

#include <cuda_bf16.h>
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
constexpr int ACC_LOADS = 8;                // C pieces of a row that an
                                            // accumulate store loads ahead
                                            // (Frag::store_cs; 1, 2, 4, 8)

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
};
constexpr int TC_SMEM = (int)sizeof(TcShared) + 1024;   // + alignment slack

__device__ __forceinline__ unsigned tf32_rna(float x) {
    unsigned r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// The float32 entries' precision (SpGEMMConfig.precision: 0 "highest",
// 1 "high", 2 "default").
enum class Prec : int { HIGHEST = 0, HIGH = 1, DEFAULT = 2 };

// x as two words of the tensor-core operands (HIGHEST, the 256-thread
// stage): hi = tf32_rna(x), lo = tf32_rna(x - hi).
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
    hi = tf32_rna(v);
    lo = tf32_rna(v - __uint_as_float(hi));
}

// x as a marked stage's FMA multiplies it: raw at HIGHEST, else rounded as
// the mode rounds it (HIGH: cvt.rna.tf32's rounding, done on the bits so
// that the low 13 bits are 0, a NaN kept as it is).
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

// Split the stage into hi / lo, write it swizzled, and write its k-masks
// and the warp's ANY_NZ / ANY_BAD bits.
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
            split(v[e], hi[e], lo[e]);
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
            unsigned hi, lo;
            split(v[c], hi, lo);
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
// see Frag), each operand rounded as the precision rounds it.  No shared
// memory is touched, so no barrier is needed.
template <Prec P>
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
            const float a0 = rounded<P>(__ldg(ap + r0 * TILE + k));
            const float a1 = rounded<P>(__ldg(ap + (r0 + 8) * TILE + k));
            const float b0 = rounded<P>(__ldg(bp + k * TILE + n0));
            const float b1 = rounded<P>(__ldg(bp + k * TILE + n0 + 1));
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
    // t: the thread among the two warpgroups (the one-pass pipeline's
    // consumers count from the first consumer)
    __device__ __forceinline__ explicit Frag(int t) {
        l = t & 31;
        g = t >> 7;
        r0 = 64 * g + 16 * ((t >> 5) & 3) + (l >> 2);
#pragma unroll
        for (int i = 0; i < 64; ++i) { acc[i] = 0.f; sum[i] = 0.f; }
        f[0] = f[1] = 0u;
    }
    // store, evict-first (st.global.cs), so that C does not push the
    // operand tiles out of L2, in 16-byte pieces: lanes 2p, 2p + 1 of a quad
    // swap halves so that each writes 4 consecutive values (8-column group
    // j + (l & 1), columns 4p ..), and the quad's flag words are exchanged
    // so that lane q writes flag bytes 32q .. 32q + 31 of each of its rows
    // (2-byte pieces cost a third of the one-pass kernels' time: PERF.md).
    // ACC (the accumulate form): each piece is loaded first (ld.global.cs,
    // the same 16-byte pieces) and the sums added to its values, old +
    // partial, one float add an element, its flags ORed in.  A load and its
    // store run in program order, so a row's value pieces are loaded
    // ACC_LOADS at a time ahead of their stores, into `acc` (the stage
    // partial, spent at a tile's last stage: no registers of their own),
    // and its flag pieces before its flag words are formed.
    template <bool ACC = false>
    __device__ __forceinline__ void store_cs(float* c_num,
                                             unsigned char* c_flag,
                                             long long row) {
        const int q = l & 3, odd = l & 1;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
            const int r = r0 + 8 * e2;
            float* cr = c_num + row * TILE_ELEMS + r * TILE;
            unsigned char* fr = c_flag + row * TILE_ELEMS + r * TILE;
#pragma unroll
            for (int j = 0; j < 16; j += 2) {   // groups j, j + 1
                float4* p = reinterpret_cast<float4*>(cr + 8 * (j + odd)
                                                      + 4 * (q >> 1));
                const int k = 4 * (8 * e2 + j / 2);     // acc[k ..]: old
                if constexpr (ACC) {
                    if ((j / 2) % ACC_LOADS == 0) {
#pragma unroll
                        for (int i = 0; i < ACC_LOADS; ++i) {
                            const float4 o = __ldcs(p + 4 * i);
                            acc[k + 4 * i] = o.x;
                            acc[k + 4 * i + 1] = o.y;
                            acc[k + 4 * i + 2] = o.z;
                            acc[k + 4 * i + 3] = o.w;
                        }
                    }
                }
                const float a0 = sum[4 * j + 2 * e2];
                const float a1 = sum[4 * j + 2 * e2 + 1];
                const float c0 = sum[4 * j + 4 + 2 * e2];
                const float c1 = sum[4 * j + 4 + 2 * e2 + 1];
                const float s0 = __shfl_xor_sync(0xFFFFFFFFu,
                                                 odd ? a0 : c0, 1);
                const float s1 = __shfl_xor_sync(0xFFFFFFFFu,
                                                 odd ? a1 : c1, 1);
                float4 v = odd ? make_float4(s0, s1, c0, c1)
                               : make_float4(a0, a1, s0, s1);
                if constexpr (ACC)
                    v = make_float4(__fadd_rn(acc[k], v.x),
                                    __fadd_rn(acc[k + 1], v.y),
                                    __fadd_rn(acc[k + 2], v.z),
                                    __fadd_rn(acc[k + 3], v.w));
                __stcs(p, v);
            }
            uint4* fp = reinterpret_cast<uint4*>(fr + 32 * q);
            uint4 o0, o1;
            if constexpr (ACC) {
                o0 = __ldcs(fp);
                o1 = __ldcs(fp + 1);
            }
            unsigned b[4];                  // byte q of quad lane s's word
#pragma unroll
            for (int s = 0; s < 4; ++s)
                b[s] = (__shfl_sync(0xFFFFFFFFu, f[e2], (l & ~3) | s)
                        >> (8 * q)) & 0xFFu;
            unsigned w[8];                  // columns 32q + 4ww ..: 0 or 1
#pragma unroll
            for (int ww = 0; ww < 8; ++ww) {
                const int jj = ww >> 1, s0 = 2 * (ww & 1);
                const unsigned nib = ((b[s0] >> (2 * jj)) & 3u)
                                   | ((b[s0 + 1] >> (2 * jj)) & 3u) << 2;
                w[ww] = (nib * 0x00204081u) & 0x01010101u;
            }
            uint4 w0 = make_uint4(w[0], w[1], w[2], w[3]);
            uint4 w1 = make_uint4(w[4], w[5], w[6], w[7]);
            if constexpr (ACC) {
                w0 = make_uint4(w0.x | o0.x, w0.y | o0.y, w0.z | o0.z,
                                w0.w | o0.w);
                w1 = make_uint4(w1.x | o1.x, w1.y | o1.y, w1.z | o1.z,
                                w1.w | o1.w);
            }
            __stcs(fp, w0);
            __stcs(fp + 1, w1);
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
// skips it.  during() runs once the stage's wgmma are issued (the issue
// cursor of macro_tc_kernel).  The caller's barrier follows.  Three wgmma
// a k-step (lo*hi, hi*lo, hi*hi).
template <class Operands, class During>
__device__ __forceinline__ void tc_stage(TcShared& sh, int cur, bool next,
                                         Operands operands, TcRegs& regs,
                                         Frag& fr, During during) {
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
    during();
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
        fma_stage<Prec::HIGHEST>(fr.acc, ap, bp, k0, r0, l);
    }
    if (run || bad) {
#pragma unroll
        for (int i = 0; i < 64; ++i) fr.sum[i] += fr.acc[i];
    }
}

// Aligns the dynamic shared memory to the swizzle atom.
__device__ __forceinline__ TcShared& tc_shared() {
    extern __shared__ unsigned char smem_raw[];
    const unsigned raw = (unsigned)__cvta_generic_to_shared(smem_raw);
    return *reinterpret_cast<TcShared*>(
        smem_raw + (((raw + 1023u) & ~1023u) - raw));
}

// --------------------------------------------------------------------------
// The one-pass pipeline (HIGH and DEFAULT; see the head of the file).

constexpr int WS_THREADS = 384;             // producer WG + 2 consumer WGs
// setmaxnreg moves registers within the block's launch allocation, 168 a
// thread at 384 threads (65,536 / 384, rounded down to 8): 120 + 2 x 192 =
// 3 x 168.  An increase beyond it would wait for ever.  88 / 208 spilled in
// the producer and was 8% slower (PERF.md).
constexpr int WS_PRODUCER_REGS = 120;
constexpr int WS_CONSUMER_REGS = 192;
static_assert(WS_PRODUCER_REGS + 2 * WS_CONSUMER_REGS <= 3 * 168,
              "setmaxnreg: more registers than the launch allocates");
constexpr int RAW_A_STRIDE = KS * 4 + 16;   // raw A row: 128 bytes + 16
constexpr int RAW_B_STRIDE = TILE * 4 + 16; // raw B row: 512 bytes + 16
constexpr unsigned ST_DATA = 1u;            // stage flags: slabs copied
constexpr unsigned ST_LAST = 2u;            // the C tile's last stage
constexpr unsigned ST_DONE = 4u;            // no tile left

// Ring depths and operand bytes a stage: HIGH stores tf32 words (A [i][k]
// and B transposed, [j][k], 128-byte rows), DEFAULT bfloat16 (A [i][k],
// 64-byte rows in the 64-byte swizzle; B as it lies, [k][j], in two
// 64-column halves of 128-byte rows in the 128-byte swizzle).
template <Prec P> struct Ws;
template <> struct Ws<Prec::HIGH> {
    static constexpr int RAW = 3, OPS = 3;
    static constexpr int OP_BYTES = TILE * KS * 4;
};
template <> struct Ws<Prec::DEFAULT> {
    static constexpr int RAW = 4, OPS = 4;
    static constexpr int OP_BYTES = TILE * KS * 2;
};

struct StageInfo {
    const float* ap;                        // the pair's tiles (a marked
    const float* bp;                        // stage reads them again)
    long long row;                          // C row
    int k0;                                 // the slab's first k
    unsigned flags;
};
struct RawStage {                           // the raw slabs, copied as they lie
    unsigned char a[TILE * RAW_A_STRIDE];   // A [i][k]
    unsigned char b[KS * RAW_B_STRIDE];     // B [k][j]
};
struct OpMeta {                             // beside each operand stage
    unsigned am[TILE];                      // k-mask of each A row
    unsigned bm[TILE];                      // k-mask of each B column
    unsigned a_any[4];                      // producer warp w's A rows
    unsigned b_any[4];                      // and B columns: ANY_NZ, ANY_BAD
    StageInfo info;
};
template <Prec P>
struct WsShared {
    struct alignas(1024) Op {               // 1024: the swizzle atom
        unsigned char a[Ws<P>::OP_BYTES];
        unsigned char b[Ws<P>::OP_BYTES];
    } op[Ws<P>::OPS];
    RawStage raw[Ws<P>::RAW];
    OpMeta meta[Ws<P>::OPS];
    StageInfo raw_info[Ws<P>::RAW];
    unsigned long long info_full[Ws<P>::RAW];   // raw_info written
    unsigned long long raw_full[Ws<P>::RAW];    // 128 threads' copies landed
    unsigned long long raw_empty[Ws<P>::RAW];   // 4 producer warps read it
    unsigned long long op_full[Ws<P>::OPS];     // 4 producer warps wrote it
    unsigned long long op_empty[Ws<P>::OPS];    // 8 consumer warps done
};
template <Prec P>
constexpr int WS_SMEM = (int)sizeof(WsShared<P>) + 1024;

template <Prec P>
__device__ __forceinline__ WsShared<P>& ws_shared() {
    extern __shared__ unsigned char smem_raw[];
    const unsigned raw = (unsigned)__cvta_generic_to_shared(smem_raw);
    return *reinterpret_cast<WsShared<P>*>(
        smem_raw + (((raw + 1023u) & ~1023u) - raw));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}
// an arrival on bar once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}
// until the phase of the given parity has completed (parity 1 on a fresh
// barrier: at once)
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
    const unsigned a = smem_addr(bar);
    unsigned done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(a), "r"(parity) : "memory");
    } while (!done);
}

// wgmma shared-memory descriptor: start >> 4, leading and stride byte
// offsets >> 4, layout type (1: 128-byte swizzle, 2: 64-byte swizzle).
__device__ __forceinline__ unsigned long long op_desc(const void* p,
                                                      unsigned lbo,
                                                      unsigned sbo,
                                                      unsigned layout) {
    return (unsigned long long)((smem_addr(p) & 0x3FFFF) >> 4)
         | ((unsigned long long)(lbo >> 4) << 16)
         | ((unsigned long long)(sbo >> 4) << 32)
         | ((unsigned long long)layout << 62);
}

// d (+)= A(64 x 16, bf16, K-major) @ B(16 x 128, bf16, MN-major: the
// transpose immediate is 1); scale_d = 0 ignores d's input.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64],
                                           unsigned long long da,
                                           unsigned long long db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
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

// HIGH's operand word: tf32_rna(x), as split<HIGH> (loading the raw word
// and letting the tensor cores truncate would double u).
__device__ __forceinline__ unsigned op_tf32(float x) {
    return tf32_rna(x);
}
// DEFAULT's operand pair: x and y rounded to bfloat16, nearest-even, x in
// the low half (the lower address).
__device__ __forceinline__ unsigned op_bf16x2(float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const unsigned*>(&h);
}

// The raw B slab's rows among a warp's lanes: lane l holds row k = 4 KQ(l /
// 4) + l % 4, so that the 8 lanes of a shared-memory phase (two quads, KQ 0
// and 5, 1 and 4, ...) read rows 8 apart mod 8 and, transposed, store 16-
// byte chunks that the swizzle spreads over 8 bank groups.  A k-mask bit is
// then the LANE of its k (bit 4 QOF(k / 4) + k % 4), for A and B alike, so
// that a ballot over a B column is its mask.
__device__ __forceinline__ constexpr int kq_of_quad(int q) {
    return (q >> 1) ^ (5 * (q & 1));
}
__device__ __forceinline__ constexpr int quad_of_kq(int c) {
    return c < 4 ? 2 * c : 2 * (c ^ 5) + 1;
}
__device__ __forceinline__ unsigned nz4(float4 x) {
    return (x.x != 0.f ? 1u : 0u) | (x.y != 0.f ? 2u : 0u)
         | (x.z != 0.f ? 4u : 0u) | (x.w != 0.f ? 8u : 0u);
}
__device__ __forceinline__ float max4(float m, float4 x) {
    return max_nan(max_nan(m, fabsf(x.x)), max_nan(max_nan(fabsf(x.y),
                   fabsf(x.z)), fabsf(x.w)));
}

// v: row e (= lane % 4) of a 4 x 4 block held by the lanes of a quad ->
// column e of it: two butterfly steps, each swapping one bit of the row
// and the column index.
__device__ __forceinline__ void quad_transpose(unsigned (&v)[4], int e) {
    const bool o1 = (e & 1) != 0, o2 = (e & 2) != 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const unsigned got = __shfl_xor_sync(0xFFFFFFFFu,
                                             o1 ? v[2 * h] : v[2 * h + 1], 1);
        if (o1) v[2 * h] = got; else v[2 * h + 1] = got;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const unsigned got = __shfl_xor_sync(0xFFFFFFFFu,
                                             o2 ? v[h] : v[2 + h], 2);
        if (o2) v[h] = got; else v[2 + h] = got;
    }
}

// One stage's raw slabs into operand stage `op` and its masks, by the 128
// producer threads (t): thread t rounds A row t (its k-mask in the thread);
// warp w B columns 32w .. 32w + 31, lane l raw row k of them (see
// kq_of_quad; a column's k-mask is a ballot).  The raw rows lie 16 bytes
// more than their length apart, so every read and write below meets 8
// different bank groups in each phase.
template <Prec P>
__device__ __forceinline__ void ws_convert(const RawStage& raw,
                                           typename WsShared<P>::Op& op,
                                           OpMeta& m, int t) {
    const int w = t >> 5, l = t & 31;
    const unsigned char* ra = raw.a + t * RAW_A_STRIDE;
    float mx = 0.f;                         // max |x|, NaN if any x is
    unsigned am = 0u;
    if constexpr (P == Prec::HIGH) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float4 x = *reinterpret_cast<const float4*>(ra + 16 * c);
            am |= nz4(x) << (4 * quad_of_kq(c));
            mx = max4(mx, x);
            *reinterpret_cast<uint4*>(op.a + t * 128 + ((c ^ (t & 7)) << 4)) =
                make_uint4(op_tf32(x.x), op_tf32(x.y), op_tf32(x.z),
                           op_tf32(x.w));
        }
    } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const float4 x = *reinterpret_cast<const float4*>(ra + 32 * c);
            const float4 y = *reinterpret_cast<const float4*>(ra + 32 * c
                                                              + 16);
            am |= nz4(x) << (4 * quad_of_kq(2 * c))
                | nz4(y) << (4 * quad_of_kq(2 * c + 1));
            mx = max4(max4(mx, x), y);
            *reinterpret_cast<uint4*>(op.a + t * 64
                                      + ((c ^ ((t >> 1) & 3)) << 4)) =
                make_uint4(op_bf16x2(x.x, x.y), op_bf16x2(x.z, x.w),
                           op_bf16x2(y.x, y.y), op_bf16x2(y.z, y.w));
        }
    }
    m.am[t] = am;
    const int kq = kq_of_quad(l >> 2), k = 4 * kq + (l & 3);
    const unsigned char* rb = raw.b + k * RAW_B_STRIDE;
    unsigned b_nz = 0u;
    if constexpr (P == Prec::HIGH) {
        const int e = l & 3;                // 4 columns a quad, transposed
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int c = 8 * w + r;        // columns 4c .. 4c + 3
            const float4 x = *reinterpret_cast<const float4*>(rb + 16 * c);
            mx = max4(mx, x);
            const unsigned m0 = __ballot_sync(0xFFFFFFFFu, x.x != 0.f);
            const unsigned m1 = __ballot_sync(0xFFFFFFFFu, x.y != 0.f);
            const unsigned m2 = __ballot_sync(0xFFFFFFFFu, x.z != 0.f);
            const unsigned m3 = __ballot_sync(0xFFFFFFFFu, x.w != 0.f);
            if (l == 0)
                *reinterpret_cast<uint4*>(&m.bm[4 * c]) =
                    make_uint4(m0, m1, m2, m3);
            b_nz |= m0 | m1 | m2 | m3;
            unsigned v[4] = {op_tf32(x.x), op_tf32(x.y), op_tf32(x.z),
                             op_tf32(x.w)};
            quad_transpose(v, e);           // column 4c + e, k = 4kq ..
            const int j = 4 * c + e;
            *reinterpret_cast<uint4*>(op.b + j * 128 + (((kq ^ j) & 7) << 4))
                = make_uint4(v[0], v[1], v[2], v[3]);
        }
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int cc = 4 * w + i;       // columns 8cc .. 8cc + 7
            const float4 x = *reinterpret_cast<const float4*>(rb + 32 * cc);
            const float4 y = *reinterpret_cast<const float4*>(rb + 32 * cc
                                                              + 16);
            mx = max4(max4(mx, x), y);
            const float vs[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
            unsigned mb[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                mb[u] = __ballot_sync(0xFFFFFFFFu, vs[u] != 0.f);
            if (l == 0) {
                *reinterpret_cast<uint4*>(&m.bm[8 * cc]) =
                    make_uint4(mb[0], mb[1], mb[2], mb[3]);
                *reinterpret_cast<uint4*>(&m.bm[8 * cc + 4]) =
                    make_uint4(mb[4], mb[5], mb[6], mb[7]);
            }
            b_nz |= mb[0] | mb[1] | mb[2] | mb[3] | mb[4] | mb[5] | mb[6]
                  | mb[7];
            *reinterpret_cast<uint4*>(op.b + (cc >> 3) * (KS * 128) + k * 128
                                      + (((cc & 7) ^ (k & 7)) << 4)) =
                make_uint4(op_bf16x2(x.x, x.y), op_bf16x2(x.z, x.w),
                           op_bf16x2(y.x, y.y), op_bf16x2(y.z, y.w));
        }
    }
    const unsigned bad = __any_sync(0xFFFFFFFFu, !(mx < BIG)) ? ANY_BAD : 0u;
    const unsigned a_w = __any_sync(0xFFFFFFFFu, am != 0u) ? ANY_NZ : 0u;
    if (l == 0) {
        m.a_any[w] = a_w;
        m.b_any[w] = (b_nz != 0u ? ANY_NZ : 0u) | bad;
    }
}

// The one-pass pipeline's k-masks of every tile of a float32 table, once a
// multiply, before the tiles run: words 0-3 bit k: column k holds a
// non-zero (the tile as an A operand), word 4 bit s: columns 32s .. 32s +
// 31 hold a value a stage is marked for (|x| >= BIG, an Inf, a NaN); words
// 5-8 and 9 the same of the rows (the tile as a B operand).  One block a
// tile; warp w reads rows w, w + 8, ..., lane l columns 4l .. 4l + 3.
constexpr int TM_WORDS = 10;

__global__ void __launch_bounds__(256)
f32_tile_masks(const float* __restrict__ tiles,
               unsigned* __restrict__ masks) {
    __shared__ unsigned m[TM_WORDS];
    const int t = threadIdx.x, w = t >> 5, l = t & 31;
    if (t < TM_WORDS) m[t] = 0u;
    __syncthreads();
    const float4* x = reinterpret_cast<const float4*>(
        tiles + (long long)blockIdx.x * TILE_ELEMS);
    unsigned cnz = 0u;                      // columns 4l + e: bit e
    bool cbad = false;
    for (int r = w; r < TILE; r += 8) {
        const float4 v = __ldg(x + r * (TILE / 4) + l);
        const unsigned nz = nz4(v);
        const bool bad = !(max4(0.f, v) < BIG);
        cnz |= nz;
        cbad |= bad;
        const bool rnz = __any_sync(0xFFFFFFFFu, nz != 0u);
        const bool rbad = __any_sync(0xFFFFFFFFu, bad);
        if (l == 0 && rnz) atomicOr(&m[5 + (r >> 5)], 1u << (r & 31));
        if (l == 0 && rbad) atomicOr(&m[9], 1u << (r >> 5));
    }
    unsigned bits = cnz << ((4 * l) & 31);  // lanes 8j .. 8j + 7: word j
    bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 1);
    bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 2);
    bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 4);
    if ((l & 7) == 0 && bits != 0u) atomicOr(&m[l >> 3], bits);
    const unsigned sb = __ballot_sync(0xFFFFFFFFu, cbad);
    if (l == 0) {
        unsigned slabs = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            slabs |= ((sb >> (8 * j)) & 0xFFu) != 0u ? 1u << j : 0u;
        if (slabs != 0u) atomicOr(&m[4], slabs);
    }
    __syncthreads();
    if (t < TM_WORDS) masks[(long long)blockIdx.x * TM_WORDS + t] = m[t];
}

// The slabs of a pair that run (bit s: slab s), from its tiles' masks: a k
// of the slab where A's column and B's row both hold a non-zero, or a
// marked value in either.  Every other slab multiplies only zeros (+-0,
// which change no sum and set no flag) and is neither copied nor run.
__device__ __forceinline__ unsigned slabs_needed(const unsigned (&mw)[10]) {
    unsigned n = (mw[4] | mw[9]) & 0xFu;
#pragma unroll
    for (int s = 0; s < SLABS_PER_PAIR; ++s)
        n |= (mw[s] & mw[5 + s]) != 0u ? 1u << s : 0u;
    return n;
}

// The tiles of the pair-stream entry: tile tk is C row tk, its pairs
// [seg_ptr[tk], seg_ptr[tk + 1]) of (a_idx, b_idx).  Every Tiles gives
// `resolved()`, the copy the producer walks with (PlanTiles is walked in
// place: WalkOf), and LISTED, whether the
// C row of a ticket is read from memory (the Issuer then reads it a tile
// ahead).
struct StreamTiles {
    static constexpr bool LISTED = false;
    const int* seg_ptr;
    const int* a_idx;
    const int* b_idx;
    const unsigned* masks_a;                // f32_tile_masks of each table
    const unsigned* masks_b;
    int* next;
    int n_tiles;
    __device__ __forceinline__ void range(int tk, int& lo, int& hi, int& a0,
                                          int& b0) const {
        lo = hi = a0 = b0 = 0;
        if (tk < n_tiles) {
            lo = seg_ptr[tk];
            hi = seg_ptr[tk + 1];
        }
    }
    __device__ __forceinline__ void tiles(int q, int& ta, int& tb) const {
        ta = a_idx[q];
        tb = b_idx[q];
    }
    __device__ __forceinline__ long long row(int tk) const { return tk; }
    __device__ __forceinline__ StreamTiles resolved() const { return *this; }
};

// The tiles of the pair-stream entry's accumulate form: only the C tiles
// with pairs, in stream order, from the walk list (stream_walk_kernel:
// walk[0] their count, walk[1 + 2i] the C row of the i-th, walk[2 + 2i]
// its first pair; entry `count` holds the stream's end).
// Ticket tk is the tk-th of them, its pairs [walk[2 + 2tk], walk[4 + 2tk]);
// n_tiles is c_cap at the launch (it bounds the grid) and the count once
// resolved (read once a block): a ticket past it ends the walk, so no tile
// without pairs takes a ticket.
struct ListTiles {
    static constexpr bool LISTED = true;
    const int* walk;
    const int* a_idx;
    const int* b_idx;
    const unsigned* masks_a;
    const unsigned* masks_b;
    int* next;
    int n_tiles;
    __device__ __forceinline__ void range(int tk, int& lo, int& hi, int& a0,
                                          int& b0) const {
        lo = hi = a0 = b0 = 0;
        if (tk < n_tiles) {
            lo = walk[2 + 2 * tk];
            hi = walk[4 + 2 * tk];
        }
    }
    __device__ __forceinline__ void tiles(int q, int& ta, int& tb) const {
        ta = a_idx[q];
        tb = b_idx[q];
    }
    __device__ __forceinline__ long long row(int tk) const {
        return tk < n_tiles ? walk[1 + 2 * tk] : 0;
    }
    __device__ __forceinline__ ListTiles resolved() const {
        ListTiles w = *this;
        w.n_tiles = walk[0];
        return w;
    }
};

// The tiles of a class launch: tile tk = (step tk / t, tt = tk % t) is C row
// base + tk, its pairs [p_ptr[tt], p_ptr[tt + 1]) (RAGGED) or [tt p, tt p +
// p) of the offset tables, at the step's bases.
template <bool RAGGED>
struct ClassTiles {
    static constexpr bool LISTED = false;
    const int* ab_bases;
    const int* p_ptr;
    const int* a_offs;
    const int* b_offs;
    const unsigned* masks_a;
    const unsigned* masks_b;
    int t, p;
    long long base;
    int* next;
    int n_tiles;
    __device__ __forceinline__ void range(int tk, int& lo, int& hi, int& a0,
                                          int& b0) const {
        lo = hi = a0 = b0 = 0;
        if (tk < n_tiles) {
            const int step = tk / t, tt = tk - step * t;
            lo = RAGGED ? p_ptr[tt] : tt * p;
            hi = RAGGED ? p_ptr[tt + 1] : lo + p;
            a0 = ab_bases[2 * step];
            b0 = ab_bases[2 * step + 1];
        }
    }
    __device__ __forceinline__ void tiles(int q, int& ta, int& tb) const {
        ta = a_offs[q];
        tb = b_offs[q];
    }
    __device__ __forceinline__ long long row(int tk) const {
        return base + tk;
    }
    __device__ __forceinline__ ClassTiles resolved() const { return *this; }
};

// The tiles of a whole plan's classes in one launch: the planners lay the
// classes' slab rows back to back from row 0 (ops/stencil.py
// _finish_plan), so ticket tk is slab row tk.  Its class is the last whose
// first ticket is at most tk (a binary search over the descriptors, which
// the launch carries by value, so that no claim waits on a global load
// for them); within the class it is ClassTiles' tile (step, tt) of the
// plan's concatenated tables: the class's steps from `step` in ab_bases,
// its p_ptr from `ptr`, rebased so that it indexes the concatenated
// a_offs / b_offs directly.  Uniform classes come as ragged ones.
constexpr int PLAN_MAX_CLASSES = 32;        // ops/stencil.py MAX_CLASSES_R

struct PlanClass {
    int first, t, step, ptr;
};

struct PlanTiles {
    static constexpr bool LISTED = false;
    const int* ab_bases;
    const int* p_ptr;
    const int* a_offs;
    const int* b_offs;
    const unsigned* masks_a;
    const unsigned* masks_b;
    int* next;
    int n_tiles;
    int n_classes;
    PlanClass cls[PLAN_MAX_CLASSES];
    __device__ __forceinline__ void range(int tk, int& lo, int& hi, int& a0,
                                          int& b0) const {
        lo = hi = a0 = b0 = 0;
        if (tk < n_tiles) {
            int c = 0;
#pragma unroll
            for (int s = PLAN_MAX_CLASSES / 2; s > 0; s >>= 1)
                if (c + s < n_classes && cls[c + s].first <= tk) c += s;
            const PlanClass pc = cls[c];
            const int k = tk - pc.first, step = k / pc.t, tt = k - step * pc.t;
            lo = p_ptr[pc.ptr + tt];
            hi = p_ptr[pc.ptr + tt + 1];
            a0 = ab_bases[2 * (pc.step + step)];
            b0 = ab_bases[2 * (pc.step + step) + 1];
        }
    }
    __device__ __forceinline__ void tiles(int q, int& ta, int& tb) const {
        ta = a_offs[q];
        tb = b_offs[q];
    }
    __device__ __forceinline__ long long row(int tk) const { return tk; }
};

// The walk a block runs: `launched.resolved()`, a copy; PlanTiles is read
// where the launch put it (its descriptors, indexed at run time, would make
// a copy live in local memory), so it needs no resolved().
template <class Tiles>
struct WalkOf {
    const Tiles w;
    __device__ __forceinline__ explicit WalkOf(const Tiles& launched)
        : w(launched.resolved()) {}
};
template <>
struct WalkOf<PlanTiles> {
    const PlanTiles& w;
    __device__ __forceinline__ explicit WalkOf(const PlanTiles& launched)
        : w(launched) {}
};

// The issue cursor, in producer warp 0 (its lanes hold the same scalars):
// the tile it issues (ticket tk, pairs [lo, hi), lane i the operand tiles
// and needed slabs of pair win + i) and four tiles claimed ahead, each a
// step further along the claim (ticket taken; its range read; its first
// pairs' tiles read; their masks read), one step a tile, so that no load it
// issues is waited for before a tile's time has passed.  A LISTED walk's C
// rows are read a step ahead too (row0, beside the masks).
template <class Tiles>
struct Issuer {
    int tk, lo, hi, a0, b0, ia, ib, win, q, slab;
    long long row, row0;                    // LISTED: the C rows of tk, tk0
    unsigned nd;                            // lane i: slabs of pair win + i
    int tk0, lo0, hi0, a00, b00, ia0, ib0;  // next: every field read
    unsigned mw[10];                        // its lanes' mask words
    int tk1, lo1, hi1, a01, b01, ia1, ib1;  // after it: its tiles read
    int tk2, lo2, hi2, a02, b02;            // then: its range read
    int tk3;                                // then: its ticket (lane 0)
    bool done;

    __device__ __forceinline__ void load_tiles(const Tiles& w, int from,
                                               int to, int& ta, int& tb) {
        const int qq = from + (threadIdx.x & 31);
        ta = tb = 0;
        if (qq < to) w.tiles(qq, ta, tb);
    }
    // lane i: the mask words of pair from + i into m (zeros past `to`)
    __device__ __forceinline__ void load_masks(const Tiles& w, int from,
                                               int to, int ta, int tb,
                                               unsigned (&m)[10]) {
#pragma unroll
        for (int i = 0; i < 10; ++i) m[i] = 0u;
        if (from + (threadIdx.x & 31) < to) {
            const unsigned* ma = w.masks_a + (long long)ta * TM_WORDS;
            const unsigned* mb = w.masks_b + (long long)tb * TM_WORDS;
#pragma unroll
            for (int i = 0; i < 5; ++i) {
                m[i] = ma[i];
                m[5 + i] = mb[5 + i];
            }
        }
    }
    __device__ __forceinline__ void advance(const Tiles& w) {
        tk = tk0; lo = lo0; hi = hi0; a0 = a00; b0 = b00; ia = ia0; ib = ib0;
        if constexpr (Tiles::LISTED) row = row0;
        nd = slabs_needed(mw);
        win = q = lo;
        slab = 0;
        tk0 = tk1; lo0 = lo1; hi0 = hi1; a00 = a01; b00 = b01; ia0 = ia1;
        ib0 = ib1;
        if constexpr (Tiles::LISTED) row0 = w.row(tk0);
        load_masks(w, lo0, hi0, a00 + ia0, b00 + ib0, mw);
        tk1 = tk2; lo1 = lo2; hi1 = hi2; a01 = a02; b01 = b02;
        load_tiles(w, lo1, hi1, ia1, ib1);
        tk2 = __shfl_sync(0xFFFFFFFFu, tk3, 0);
        w.range(tk2, lo2, hi2, a02, b02);
        tk3 = w.n_tiles;
        if ((threadIdx.x & 31) == 0 && tk2 < w.n_tiles)
            tk3 = atomicAdd(w.next, 1);
    }
    __device__ __forceinline__ void start(const Tiles& w) {
        tk0 = tk1 = tk2 = w.n_tiles;
        lo0 = hi0 = a00 = b00 = ia0 = ib0 = 0;
        lo1 = hi1 = a01 = b01 = ia1 = ib1 = 0;
        lo2 = hi2 = a02 = b02 = 0;
        row0 = 0;
#pragma unroll
        for (int i = 0; i < 10; ++i) mw[i] = 0u;
        tk3 = (threadIdx.x & 31) == 0 ? atomicAdd(w.next, 1) : w.n_tiles;
        done = false;
#pragma unroll 1
        for (int i = 0; i < 4; ++i) advance(w);
    }
    // the next stage's StageInfo into `info_out`, then an arrival on its
    // barrier `ready` (ARRIVE; macro_tc_kernel's barrier is the block's):
    // the tile's next slab that runs; after its last one (or at once, for a
    // tile none of whose slabs runs) a stage without copies that stores the
    // tile; or the end
    template <bool ARRIVE = true>
    __device__ __forceinline__ void publish(const Tiles& w,
                                            const float* a_dense,
                                            const float* b_dense,
                                            StageInfo& info_out,
                                            unsigned long long* ready) {
        StageInfo info{nullptr, nullptr, 0, 0, 0u};
        unsigned bits = 0u;
        if (tk >= w.n_tiles) {
            info.flags = ST_DONE;
            done = true;
        } else {
            while (q < hi) {                // the next slab that runs
                if (q - win == 32) {        // a tile of more than 32 pairs
                    win = q;        // (mw holds the next tile's masks)
                    load_tiles(w, q, hi, ia, ib);
                    unsigned m[10];
                    load_masks(w, q, hi, a0 + ia, b0 + ib, m);
                    nd = slabs_needed(m);
                }
                bits = __shfl_sync(0xFFFFFFFFu, nd, q - win)
                     & (0xFu << slab);
                if (bits != 0u) break;
                ++q;
                slab = 0;
            }
            info.row = Tiles::LISTED ? row : w.row(tk);
            if (q == hi) {
                info.flags = ST_LAST;
                advance(w);
            } else {
                slab = __ffs(bits) - 1;
                const int ta = __shfl_sync(0xFFFFFFFFu, ia, q - win);
                const int tb = __shfl_sync(0xFFFFFFFFu, ib, q - win);
                info.ap = a_dense + (long long)(a0 + ta) * TILE_ELEMS;
                info.bp = b_dense + (long long)(b0 + tb) * TILE_ELEMS;
                info.k0 = KS * slab;
                info.flags = ST_DATA;
                if (++slab == SLABS_PER_PAIR) {
                    slab = 0;
                    ++q;
                }
            }
        }
        if ((threadIdx.x & 31) == 0) {
            info_out = info;
            if constexpr (ARRIVE) mbar_arrive(ready);
        }
    }
};

// Producer thread t's share of stage n's raw slabs, once warp 0 has
// published the stage: 8 16-byte cp.async of A (8 lanes a 128-byte row)
// and 8 of B (32 lanes a 512-byte row), then an arrival on the slot's
// `full` barrier when they have landed (at once for a stage without
// copies).  Returns false at the DONE stage: nothing is issued after it.
template <Prec P>
__device__ __forceinline__ bool ws_issue(WsShared<P>& sh, int n, int t) {
    constexpr int R = Ws<P>::RAW;
    const int r = n % R;
    mbar_wait(&sh.info_full[r], (n / R) & 1);
    const StageInfo info = sh.raw_info[r];
    if (info.flags & ST_DATA) {
        RawStage& raw = sh.raw[r];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int e = t + 128 * i;
            const int ar = e >> 3, ac = e & 7;      // A row, 16-byte chunk
            cp_async16(raw.a + ar * RAW_A_STRIDE + 16 * ac,
                       info.ap + ar * TILE + info.k0 + 4 * ac);
            const int br = e >> 5, bc = e & 31;     // B row, 16-byte chunk
            cp_async16(raw.b + br * RAW_B_STRIDE + 16 * bc,
                       info.bp + (info.k0 + br) * TILE + 4 * bc);
        }
        cp_async_arrive(&sh.raw_full[r]);
    } else {
        mbar_arrive(&sh.raw_full[r]);
    }
    return (info.flags & ST_DONE) == 0u;
}

// The producer warpgroup: stage n's raw slabs in raw slot n % RAW, its
// operands in operand slot n % OPS.  Once the four warps have read stage
// n's raw slabs, warp 0 publishes stage n + RAW and the 128 threads issue
// its copies into the same slot.
template <Prec P, class Tiles>
__device__ __forceinline__ void ws_producer(WsShared<P>& sh,
                                            const float* a_dense,
                                            const float* b_dense,
                                            const Tiles& launched) {
    constexpr int R = Ws<P>::RAW, S = Ws<P>::OPS;
    const int t = threadIdx.x, warp = t >> 5, l = t & 31;
    const WalkOf<Tiles> walk(launched);
    const Tiles& w = walk.w;
    Issuer<Tiles> is;
    if (warp == 0) {
        is.start(w);
#pragma unroll 1
        for (int n = 0; n < R && !is.done; ++n)
            is.publish(w, a_dense, b_dense, sh.raw_info[n], &sh.info_full[n]);
    }
    bool issuing = true;                    // the DONE stage not issued yet
#pragma unroll 1
    for (int n = 0; n < R && issuing; ++n) issuing = ws_issue<P>(sh, n, t);
#pragma unroll 1
    for (int n = 0;; ++n) {
        const int r = n % R, s = n % S;
        mbar_wait(&sh.raw_full[r], (n / R) & 1);
        const StageInfo info = sh.raw_info[r];
        mbar_wait(&sh.op_empty[s], ((n / S) & 1) ^ 1);
        if (info.flags & ST_DATA) {
            ws_convert<P>(sh.raw[r], sh.op[s], sh.meta[s], t);
            // the generic-proxy writes above are read by wgmma
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        } else if (l == 0) {
            sh.meta[s].a_any[warp] = 0u;
            sh.meta[s].b_any[warp] = 0u;
        }
        if (t == 0) sh.meta[s].info = info;
        __syncwarp();
        if (l == 0) {
            mbar_arrive(&sh.op_full[s]);
            mbar_arrive(&sh.raw_empty[r]);
        }
        if (info.flags & ST_DONE) return;
        if (issuing) {
            if (warp == 0) {
                mbar_wait(&sh.raw_empty[r], (n / R) & 1);
                is.publish(w, a_dense, b_dense, sh.raw_info[r],
                           &sh.info_full[r]);
            }
            issuing = ws_issue<P>(sh, n + R, t);
        }
    }
}

// d = the stage's product for consumer warpgroup g (A rows 64g ..), issued
template <Prec P>
__device__ __forceinline__ void ws_mma(const typename WsShared<P>::Op& op,
                                       int g, float (&d)[64]) {
    fence_regs(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if constexpr (P == Prec::HIGH) {
        const unsigned long long da = op_desc(op.a + 64 * g * 128, 16, 1024, 1);
        const unsigned long long db = op_desc(op.b, 16, 1024, 1);
#pragma unroll
        for (int kk = 0; kk < KS / 8; ++kk)     // 8 tf32 = 32 bytes
            wgmma_tf32(d, da + 2 * kk, db + 2 * kk, kk);
    } else {
        const unsigned long long da = op_desc(op.a + 64 * g * 64, 16, 512, 2);
        // B: 64-column halves 32 x 128 bytes apart, 8-row groups 1024
        const unsigned long long db = op_desc(op.b, KS * 128, 1024, 1);
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)    // A: 32 bytes; B: 16 rows
            wgmma_bf16(d, da + 2 * kk, db + 128 * kk, kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// OR the stage's pattern into the flags: (mask_row & mask_col) != 0
__device__ __forceinline__ void ws_pattern(const OpMeta& m, Frag& fr) {
    const unsigned m0 = m.am[fr.r0], m1 = m.am[fr.r0 + 8];
    if ((m0 | m1) == 0u) return;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const uint2 mb = *reinterpret_cast<const uint2*>(
            &m.bm[8 * j + 2 * (fr.l & 3)]);
        fr.f[0] |= ((m0 & mb.x) != 0u ? 1u : 0u) << (2 * j)
                 | ((m0 & mb.y) != 0u ? 2u : 0u) << (2 * j);
        fr.f[1] |= ((m1 & mb.x) != 0u ? 1u : 0u) << (2 * j)
                 | ((m1 & mb.y) != 0u ? 2u : 0u) << (2 * j);
    }
}

// A consumer warpgroup (g = 0, 1: C rows 64g ..): per stage the wgmma
// partial (skipped where its 64 A rows or the B slab hold no non-zero; a
// marked stage in FP32 FMA on the raw operands instead) added to the sums,
// the pattern ORed into the flags, the operand slot released as soon as it
// is read; at a tile's last stage its sums and flags stored.  ACC (the
// accumulate form): added into C instead, and only where a slab of the tile
// ran (`live`): a store-only tile, none of whose slabs ran, is left as it
// is (its walk visits no tile without pairs: ListTiles).  The consumers'
// sums and stage partial sit at the edge of their 192 registers, so the
// accumulate instances spill 80 bytes around that store (ptxas; PERF.md).
template <Prec P, bool ACC>
__device__ __forceinline__ void ws_consumer(WsShared<P>& sh,
                                            float* __restrict__ c_num,
                                            unsigned char* __restrict__ c_flag) {
    constexpr int S = Ws<P>::OPS;
    Frag fr(threadIdx.x - 128);
    bool live = false;
#pragma unroll 1
    for (int n = 0;; ++n) {
        const int s = n % S;
        mbar_wait(&sh.op_full[s], (n / S) & 1);
        const OpMeta& m = sh.meta[s];
        const StageInfo info = m.info;
        if (info.flags & ST_DONE) return;
        if constexpr (ACC) live |= (info.flags & ST_DATA) != 0u;
        const unsigned ag = m.a_any[2 * fr.g] | m.a_any[2 * fr.g + 1];
        const unsigned bg = m.b_any[0] | m.b_any[1] | m.b_any[2] | m.b_any[3];
        const bool bad = (bg & ANY_BAD) != 0u;
        const bool run = (ag & bg & ANY_NZ) != 0u && !bad;
        if (run) ws_mma<P>(sh.op[s], fr.g, fr.acc);
        if (run || bad) ws_pattern(m, fr);
        if (run) {
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            fence_regs(fr.acc);
        }
        __syncwarp();
        if (fr.l == 0) mbar_arrive(&sh.op_empty[s]);
        if (bad) fma_stage<P>(fr.acc, info.ap, info.bp, info.k0, fr.r0, fr.l);
        if (run || bad) {
#pragma unroll
            for (int i = 0; i < 64; ++i) fr.sum[i] += fr.acc[i];
        }
        if (info.flags & ST_LAST) {
            if (!ACC || live) fr.store_cs<ACC>(c_num, c_flag, info.row);
            fr.reset();
            live = false;
        }
    }
}

// Persistent: one block an SM takes the tiles of `w` from its ticket
// counter (zero at the launch) in order.  One producer warpgroup, two
// consumer warpgroups; no block-wide barrier after the barriers' set-up.
// ACC: the accumulate form (ws_consumer).
template <Prec P, class Tiles, bool ACC = false>
__global__ void __launch_bounds__(WS_THREADS, 1)
macro_ws_kernel(const float* __restrict__ a_dense,
                const float* __restrict__ b_dense,
                const __grid_constant__ Tiles w,
                float* __restrict__ c_num,
                unsigned char* __restrict__ c_flag) {
    constexpr int R = Ws<P>::RAW, S = Ws<P>::OPS;
    WsShared<P>& sh = ws_shared<P>();
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
            mbar_init(&sh.info_full[i], 1);
            mbar_init(&sh.raw_full[i], 128);
            mbar_init(&sh.raw_empty[i], 4);
        }
#pragma unroll
        for (int i = 0; i < S; ++i) {
            mbar_init(&sh.op_full[i], 4);
            mbar_init(&sh.op_empty[i], 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < 128) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(WS_PRODUCER_REGS));
        ws_producer<P>(sh, a_dense, b_dense, w);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(WS_CONSUMER_REGS));
        ws_consumer<P, ACC>(sh, c_num, c_flag);
    }
}

// "highest": every float32 launch at the reference's precision, fresh or
// accumulating (ACC), over the tiles of `launched` (StreamTiles: a pair
// stream's c_cap tiles; ClassTiles: a class launch's; ListTiles: the
// accumulate form's tiles with pairs).  The 256-thread 3xTF32 stage
// (tc_stage: the split, the marked-stage FMA, the empty-slab skip of a
// warpgroup) runs the STAGES that the one-pass pipeline's Issuer publishes:
// only a pair's slabs that can hold a non-zero product (slabs_needed: its
// tiles' k-masks call a k non-zero in A's column and B's row, or either
// marks the slab), then a store-only stage a tile.  Warp 0 runs the Issuer
// (its claims a tile ahead each, as in the producer) and publishes stage
// n + 3 into a ring of TC_INFO StageInfo slots while the block computes
// stage n; every thread issues stage n + 2's copies from its slot (raw slot
// n % 2), splits stage n + 1 into split slot (n + 1) % 2, and the block's
// barrier ends the iteration.  At a tile's store-only stage (ST_LAST) the
// fresh form stores the tile whole, evict-first in 16-byte pieces (+0.0
// and flags 0 where no slab of it ran, among them the tiles without
// pairs); the accumulate form adds its sums into C where a slab of it ran,
// and leaves a tile none of whose slabs ran.  The DONE stage ends the
// block.  A stage without copies commits an empty cp.async group, so stage
// n's copies are always group n.
constexpr int TC_INFO = 4;                  // stages n .. n + 3 in flight

template <class Tiles, bool ACC>
__global__ void __launch_bounds__(TC_THREADS, 1)
macro_tc_kernel(const float* __restrict__ a_dense,
                const float* __restrict__ b_dense,
                const __grid_constant__ Tiles launched,
                float* __restrict__ c_num,
                unsigned char* __restrict__ c_flag) {
    __shared__ StageInfo info[TC_INFO];
    TcShared& sh = tc_shared();
    const bool issuer = threadIdx.x < 32;
    const WalkOf<Tiles> walk(launched);
    const Tiles& w = walk.w;
    Issuer<Tiles> is;
    if (issuer) {
        is.start(w);
#pragma unroll 1
        for (int n = 0; n < TC_INFO - 1; ++n)
            is.template publish<false>(w, a_dense, b_dense, info[n],
                                       nullptr);
    }
    __syncthreads();
    auto issue = [&](int n) {               // stage n's raw slabs, in flight
        const StageInfo& in = info[n % TC_INFO];
        if (in.flags & ST_DATA)
            tc_issue(sh.raw_a[n & 1], sh.raw_b[n & 1], in.ap, in.bp, in.k0);
        cp_async_commit();
    };
    auto split = [&](int n, TcRegs& regs) { // stage n, landed, split
        cp_async_wait1();
        tc_fetch(regs, sh.raw_a[n & 1], sh.raw_b[n & 1]);
        tc_store(regs, sh.stage[n & 1], sh.am[n & 1], sh.bm[n & 1],
                 sh.a_any[n & 1], sh.b_any[n & 1]);
    };
    Frag fr(threadIdx.x);
    TcRegs regs;
    bool live = false;                      // ACC: a slab of the tile ran
    issue(0);
    issue(1);
    if (info[0].flags & ST_DATA) split(0, regs);
    __syncthreads();
#pragma unroll 1
    for (int n = 0;; ++n) {
        const StageInfo in = info[n % TC_INFO];
        if (in.flags & ST_DONE) break;
        const bool next = (info[(n + 1) % TC_INFO].flags & ST_DATA) != 0u;
        issue(n + 2);                       // into raw slot n % 2
        // stage n + 3 into the slot of stage n - 1, while the tensor cores
        // run stage n
        auto publish = [&]() {
            if (issuer)
                is.template publish<false>(w, a_dense, b_dense,
                                           info[(n + 3) % TC_INFO], nullptr);
        };
        if (in.flags & ST_DATA) {
            live = true;
            tc_stage(sh, n & 1, next,
                     [&](const float*& ap, const float*& bp, int& k0) {
                         ap = in.ap;
                         bp = in.bp;
                         k0 = in.k0;
                     }, regs, fr, publish);
        } else {
            publish();
            if (next) split(n + 1, regs);
        }
        if (in.flags & ST_LAST) {
            if (!ACC || live) fr.store_cs<ACC>(c_num, c_flag, in.row);
            fr.reset();
            live = false;
        }
        __syncthreads();
    }
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
constexpr int F64_ACC_LOADS = 8;            // C pieces of a row that an
                                            // accumulate store loads ahead
                                            // (F64Frag::store; 1, 2, 4, 8)
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
    // ACC (the accumulate form): each piece is loaded first (ld.global.cs,
    // the same pieces), the sums added to its values (old + partial, one
    // double add an element) and its flags ORed in; a row's pieces are
    // loaded F64_ACC_LOADS at a time ahead of their stores (a load and its
    // store run in program order).
    template <bool ACC = false>
    __device__ __forceinline__ void store(double* __restrict__ cn,
                                          unsigned char* __restrict__ cf)
                                          const {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r0 + 16 * mi + 8 * h;
                double2 o[F64_ACC_LOADS];
                unsigned short fo[F64_ACC_LOADS];
#pragma unroll
                for (int ni = 0; ni < 8; ++ni) {
                    const int col = c0 + 8 * ni;
                    double2* p = reinterpret_cast<double2*>(cn + r * TILE
                                                            + col);
                    unsigned short* fp =
                        reinterpret_cast<unsigned short*>(cf + r * TILE + col);
                    if constexpr (ACC) {
                        if (ni % F64_ACC_LOADS == 0) {
#pragma unroll
                            for (int i = 0; i < F64_ACC_LOADS; ++i) {
                                o[i] = __ldcs(p + 4 * i);
                                fo[i] = __ldcs(fp + 4 * i);
                            }
                        }
                    }
                    double2 v = make_double2(acc[mi][ni][2 * h],
                                             acc[mi][ni][2 * h + 1]);
                    const unsigned bits = (f[mi] >> (4 * ni + 2 * h)) & 3u;
                    unsigned short fb =
                        (unsigned short)((bits & 1u) | (bits & 2u) << 7);
                    if constexpr (ACC) {
                        const int i = ni % F64_ACC_LOADS;
                        v = make_double2(__dadd_rn(o[i].x, v.x),
                                         __dadd_rn(o[i].y, v.y));
                        fb |= fo[i];
                    }
                    __stcs(p, v);
                    __stcs(fp, fb);
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
// the flags.  A tile no slab of which runs is stored as zeros; in the
// accumulate form (ACC) it is left as it is, and every other tile's sums
// and flags are added into C.  The fresh form runs tile blockIdx.x; the
// accumulate form the blockIdx.x-th C tile with pairs of the walk list
// (ListTiles' layout), and a block past their count returns at once.
template <bool ACC>
__global__ void __launch_bounds__(F64_THREADS, 1)
macro_pairs_f64_kernel(const double* __restrict__ a_dense,
                       const double* __restrict__ b_dense,
                       const int* __restrict__ a_idx,
                       const int* __restrict__ b_idx,
                       const int* __restrict__ seg_ptr,
                       const int* __restrict__ walk,
                       const unsigned char* __restrict__ need,
                       double* __restrict__ c_num,
                       unsigned char* __restrict__ c_flag) {
    extern __shared__ __align__(16) unsigned char f64_smem[];
    F64Shared& sh = *reinterpret_cast<F64Shared*>(f64_smem);
    const int t = threadIdx.x;
    long long tile = blockIdx.x;
    int lo, n_pairs;
    if constexpr (ACC) {
        const int i = blockIdx.x;
        if (i >= walk[0]) return;           // the block's threads alike
        tile = walk[1 + 2 * i];
        lo = walk[2 + 2 * i];
        n_pairs = walk[4 + 2 * i] - lo;
    } else {
        lo = seg_ptr[tile];
        n_pairs = seg_ptr[tile + 1] - lo;
    }
    if (t == 0) sh.n_slabs = 0;
    __syncthreads();
    for (int q = t; q < n_pairs; q += F64_THREADS) {
        const unsigned nb = need[lo + q];
        if (q < F64_NEED_CAP) sh.need[q] = (unsigned char)nb;
        if (nb != 0u) atomicAdd(&sh.n_slabs, __popc(nb));
    }
    __syncthreads();
    const int n_slabs = sh.n_slabs;
    if (ACC && n_slabs == 0) return;        // the block's threads alike
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
    fr.store<ACC>(c_num + tile * TILE_ELEMS, c_flag + tile * TILE_ELEMS);
}

// f(PrecTag<P>{}) for the Prec of `precision`: the instance of each
// float32 entry is chosen once, at the launch.
template <Prec P>
struct PrecTag {
    static constexpr Prec value = P;
};
template <class F>
cudaError_t with_prec(int precision, F f) {
    switch (precision) {
        case (int)Prec::HIGHEST: return f(PrecTag<Prec::HIGHEST>{});
        case (int)Prec::HIGH: return f(PrecTag<Prec::HIGH>{});
        case (int)Prec::DEFAULT: return f(PrecTag<Prec::DEFAULT>{});
        default: return cudaErrorInvalidValue;
    }
}

// The walk list of a sorted pair stream (ListTiles' layout), for i <= cap:
// the C tiles that have pairs (seg < c_cap), in stream order, each with its
// first pair; past their count the tile c_cap and the stream's end (the
// pairs with seg < c_cap, which lead a sorted stream); walk[0] the count.
// One block: WALK_PAIRS pairs a thread a step, WALK_THREADS * WALK_PAIRS a
// step; a pair that starts a tile is found against its left neighbour,
// its place in the list by a shuffle scan of the threads' counts in each
// warp and a sum of the warps' before it, carried from step to step.  The
// live pairs lead the stream, so the walk stops after the first step that
// is not all live: a ring stage's stream (about a thousand live pairs,
// padded to the largest stage's) takes one step.  Thread 0 also zeroes
// `next` (the one-pass pipeline's ticket counter) where it is given.
constexpr int WALK_THREADS = 1024;
constexpr int WALK_PAIRS = 4;

__global__ void __launch_bounds__(WALK_THREADS)
stream_walk_kernel(const int* __restrict__ seg, int p_cap, int c_cap,
                   int cap, int* __restrict__ walk, int* __restrict__ next) {
    __shared__ int warp_n[WALK_THREADS / 32];
    __shared__ int warp_live[WALK_THREADS / 32];
    const int t = threadIdx.x, w = t >> 5, l = t & 31;
    if (t == 0 && next != nullptr) *next = 0;
    int count = 0, live_pairs = 0;          // carried, alike in every thread
    for (int base = 0; base < p_cap; base += WALK_THREADS * WALK_PAIRS) {
        const int q0 = base + WALK_PAIRS * t;
        int prev = q0 > 0 && q0 <= p_cap ? seg[q0 - 1] : -1;
        int v[WALK_PAIRS];
        unsigned firsts = 0u;
        int n = 0, live = 0;
#pragma unroll
        for (int e = 0; e < WALK_PAIRS; ++e)
            v[e] = q0 + e < p_cap ? seg[q0 + e] : c_cap;
#pragma unroll
        for (int e = 0; e < WALK_PAIRS; ++e) {
            const bool is_live = v[e] < c_cap;
            const bool first = is_live && v[e] != prev;
            firsts |= first ? 1u << e : 0u;
            n += first ? 1 : 0;
            live += is_live ? 1 : 0;
            prev = v[e];
        }
        int incl = n;                       // inclusive scan over the warp
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
            incl += l >= o ? up : 0;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            live += __shfl_xor_sync(0xFFFFFFFFu, live, o);
        if (l == 31) warp_n[w] = incl;
        if (l == 0) warp_live[w] = live;
        __syncthreads();
        int before = 0, total = 0, live_total = 0;  // warps before w; all
#pragma unroll 8
        for (int i = 0; i < WALK_THREADS / 32; ++i) {
            before += i < w ? warp_n[i] : 0;
            total += warp_n[i];
            live_total += warp_live[i];
        }
        int idx = count + before + incl - n;
#pragma unroll
        for (int e = 0; e < WALK_PAIRS; ++e) {
            if ((firsts >> e & 1u) && idx <= cap) {
                walk[1 + 2 * idx] = v[e];
                walk[2 + 2 * idx] = q0 + e;
            }
            idx += firsts >> e & 1u;
        }
        count += total;
        live_pairs += live_total;
        __syncthreads();                    // the counts are read
        if (live_total < WALK_THREADS * WALK_PAIRS) break;
    }
    for (int i = count + t; i <= cap; i += WALK_THREADS) {
        walk[1 + 2 * i] = c_cap;
        walk[2 + 2 * i] = live_pairs;
    }
    if (t == 0) walk[0] = count < cap ? count : cap;
}

// The tables' k-masks that are not ready (`kernel`: f32_tile_masks or
// f64_tile_masks, `threads` a block), one pass a table, one pass where the
// two are one buffer.
template <class T>
void masks_not_ready(void (*kernel)(const T*, unsigned*), int threads,
                     const T* a_dense, const T* b_dense, unsigned* masks_a,
                     unsigned* masks_b, int n_a, int n_b, int ready_a,
                     int ready_b, cudaStream_t stream) {
    const bool same = masks_b == masks_a;
    if (!ready_a || (same && !ready_b))
        kernel<<<n_a, threads, 0, stream>>>(a_dense, masks_a);
    if (!same && !ready_b)
        kernel<<<n_b, threads, 0, stream>>>(b_dense, masks_b);
}

// Every float32 launch over the tiles of `w`: one persistent block an SM (at
// most one a tile) taking tiles from w.next, macro_tc_kernel at HIGHEST and
// the one-pass pipeline below it; first the masks of a table whose ready
// flag is 0.  ACC: the accumulate form.
template <Prec P, class Tiles, bool ACC>
cudaError_t launch_tiles(const float* a_dense, const float* b_dense,
                         const Tiles& w, int grid, int n_a, int n_b,
                         int ready_a, int ready_b, float* c_num,
                         unsigned char* c_flag, cudaStream_t stream) {
    if (grid <= 0) return cudaErrorInvalidConfiguration;
    if (w.masks_a == nullptr || w.masks_b == nullptr || n_a <= 0 || n_b <= 0)
        return cudaErrorInvalidValue;
    masks_not_ready<float>(f32_tile_masks, 256, a_dense, b_dense,
                           const_cast<unsigned*>(w.masks_a),
                           const_cast<unsigned*>(w.masks_b), n_a, n_b,
                           ready_a, ready_b, stream);
    const int blocks = grid < w.n_tiles ? grid : w.n_tiles;
    // per launch: the attribute belongs to the current device
    if constexpr (P == Prec::HIGHEST) {
        const cudaError_t attr = cudaFuncSetAttribute(
            macro_tc_kernel<Tiles, ACC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
        if (attr != cudaSuccess) return attr;
        macro_tc_kernel<Tiles, ACC><<<blocks, TC_THREADS, TC_SMEM, stream>>>(
            a_dense, b_dense, w, c_num, c_flag);
    } else {
        const cudaError_t attr = cudaFuncSetAttribute(
            macro_ws_kernel<P, Tiles, ACC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, WS_SMEM<P>);
        if (attr != cudaSuccess) return attr;
        macro_ws_kernel<P, Tiles, ACC><<<blocks, WS_THREADS, WS_SMEM<P>,
                                         stream>>>(a_dense, b_dense, w, c_num,
                                                   c_flag);
    }
    return cudaGetLastError();
}

// The float32 pair-stream entry at precision P, fresh (the stream's c_cap
// tiles) or accumulating (the walk list `walk` of its tiles with pairs).
template <Prec P, bool ACC>
cudaError_t launch_pair_entry(const float* a_dense, const float* b_dense,
                              const int* a_idx, const int* b_idx,
                              const int* seg_ptr, float* c_num,
                              unsigned char* c_flag, int c_cap, int grid,
                              int* next, unsigned* masks_a, unsigned* masks_b,
                              int n_a, int n_b, int ready_a, int ready_b,
                              const int* walk, cudaStream_t stream) {
    if constexpr (ACC) {
        if (walk == nullptr) return cudaErrorInvalidValue;
        const ListTiles w{walk, a_idx, b_idx, masks_a, masks_b, next, c_cap};
        return launch_tiles<P, ListTiles, true>(a_dense, b_dense, w, grid,
                                                n_a, n_b, ready_a, ready_b,
                                                c_num, c_flag, stream);
    } else {
        const StreamTiles w{seg_ptr, a_idx, b_idx, masks_a, masks_b, next,
                            c_cap};
        return launch_tiles<P, StreamTiles, false>(a_dense, b_dense, w, grid,
                                                   n_a, n_b, ready_a, ready_b,
                                                   c_num, c_flag, stream);
    }
}

}  // namespace

// The k-masks of the n tiles of one float32 table (TM_WORDS words a tile,
// the one-pass pipeline's) or float64 table (F64_MASK_WORDS, the float64
// entry's), one block a tile: the launch that makes a table's masks once
// (ops/macro_kernels.TableMasks), so that the entries' launches read them
// with their ready flag set.
extern "C" int macro_tile_masks_f32(const float* tiles, int n,
                                    unsigned* masks, cudaStream_t stream) {
    if (n <= 0) return (int)cudaSuccess;
    f32_tile_masks<<<n, 256, 0, stream>>>(tiles, masks);
    return (int)cudaGetLastError();
}

extern "C" int macro_tile_masks_f64(const double* tiles, int n,
                                    unsigned* masks, cudaStream_t stream) {
    if (n <= 0) return (int)cudaSuccess;
    f64_tile_masks<<<n, F64_THREADS, 0, stream>>>(tiles, masks);
    return (int)cudaGetLastError();
}

// The walk list (ListTiles' layout, 2 cap + 3 ints) of a pair stream sorted
// by C tile, seg (p_cap,), padded with INT32_MAX: its tiles below c_cap
// that have pairs, for the accumulate form (ops/macro_kernels.stream_walk).
// cap >= their count (min(c_cap, p_cap) is).  Zeroes *next too where next
// is not null.
extern "C" int macro_stream_walk(const int* seg, int p_cap, int c_cap,
                                 int cap, int* walk, int* next,
                                 cudaStream_t stream) {
    if (p_cap < 0 || c_cap < 0 || cap < 0) return (int)cudaErrorInvalidValue;
    stream_walk_kernel<<<1, WALK_THREADS, 0, stream>>>(seg, p_cap, c_cap, cap,
                                                       walk, next);
    return (int)cudaGetLastError();
}

// c_num (c_cap, 128, 128) f32 and c_flag (c_cap, 128, 128) u8: with
// accumulate 0 (the fresh form) written whole; with accumulate 1 the
// stream's tiles are added into them (values old + partial, flags ORed),
// and a tile without pairs, or none of whose slabs runs, is neither read
// nor written.  seg_ptr has c_cap + 1 entries;
// next is one int, 0 at the launch.  grid: blocks of the persistent kernel
// (the wrapper passes the SM count; at most c_cap are launched).
// precision: 0 "highest", 1 "high", 2 "default" (another value:
// cudaErrorInvalidValue), in all three float32 entries; "highest" runs
// macro_tc_kernel, the others the one-pass pipeline.  Every form reads
// masks_a / masks_b (TM_WORDS words a tile of the n_a A tiles and n_b B
// tiles; one buffer where the tables are one), each computed first unless
// its ready flag is set, and the accumulate form `walk`, the list of the C
// tiles with pairs (macro_stream_walk; it also zeroes next), in place of
// seg_ptr, which that form does not read (the fresh form reads seg_ptr and
// no walk: nullptr).
extern "C" int macro_accumulate_pairs_f32(
        const float* a_dense, const float* b_dense, const int* a_idx,
        const int* b_idx, const int* seg_ptr, float* c_num,
        unsigned char* c_flag, int c_cap, int grid, int* next, int precision,
        unsigned* masks_a, unsigned* masks_b, int n_a, int n_b, int ready_a,
        int ready_b, int accumulate, const int* walk, cudaStream_t stream) {
    if (c_cap <= 0) return (int)cudaSuccess;
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
    return (int)with_prec(precision, [&](auto tag) {
        constexpr Prec P = decltype(tag)::value;
        return accumulate
            ? launch_pair_entry<P, true>(a_dense, b_dense, a_idx, b_idx,
                                         seg_ptr, c_num, c_flag, c_cap, grid,
                                         next, masks_a, masks_b, n_a, n_b,
                                         ready_a, ready_b, walk, stream)
            : launch_pair_entry<P, false>(a_dense, b_dense, a_idx, b_idx,
                                          seg_ptr, c_num, c_flag, c_cap, grid,
                                          next, masks_a, masks_b, n_a, n_b,
                                          ready_a, ready_b, walk, stream);
    });
}

// Slab rows [base, base + n_steps * t) of c_num / c_flag are written whole.
// grid, next and the masks as in the pair-stream entry: at every precision
// the class's tiles are taken in order by at most grid persistent blocks.
template <bool RAGGED>
cudaError_t class_entry(const float* a_dense, const float* b_dense,
                        const int* ab_bases, const int* p_ptr,
                        const int* a_offs, const int* b_offs, int t, int p,
                        int n_steps, long long base, float* c_num,
                        unsigned char* c_flag, int precision, int grid,
                        int* next, unsigned* masks_a, unsigned* masks_b,
                        int n_a, int n_b, int ready_a, int ready_b,
                        cudaStream_t stream) {
    if (n_steps <= 0 || t <= 0) return cudaSuccess;
    return with_prec(precision, [&](auto tag) {
        constexpr Prec P = decltype(tag)::value;
        const ClassTiles<RAGGED> w{ab_bases, p_ptr, a_offs, b_offs, masks_a,
                                   masks_b, t, p, base, next, n_steps * t};
        return launch_tiles<P, ClassTiles<RAGGED>, false>(
            a_dense, b_dense, w, grid, n_a, n_b, ready_a, ready_b, c_num,
            c_flag, stream);
    });
}

extern "C" int macro_class_ragged_f32(
        const float* a_dense, const float* b_dense, const int* ab_bases,
        const int* p_ptr, const int* a_offs, const int* b_offs, int t,
        int n_steps, long long base, float* c_num, unsigned char* c_flag,
        int precision, int grid, int* next, unsigned* masks_a,
        unsigned* masks_b, int n_a, int n_b, int ready_a, int ready_b,
        cudaStream_t stream) {
    return (int)class_entry<true>(a_dense, b_dense, ab_bases, p_ptr, a_offs,
                                  b_offs, t, 0, n_steps, base, c_num, c_flag,
                                  precision, grid, next, masks_a, masks_b,
                                  n_a, n_b, ready_a, ready_b, stream);
}

extern "C" int macro_class_uniform_f32(
        const float* a_dense, const float* b_dense, const int* ab_bases,
        const int* a_offs, const int* b_offs, int t, int p, int n_steps,
        long long base, float* c_num, unsigned char* c_flag, int precision,
        int grid, int* next, unsigned* masks_a, unsigned* masks_b, int n_a,
        int n_b, int ready_a, int ready_b, cudaStream_t stream) {
    return (int)class_entry<false>(a_dense, b_dense, ab_bases, nullptr,
                                   a_offs, b_offs, t, p, n_steps, base, c_num,
                                   c_flag, precision, grid, next, masks_a,
                                   masks_b, n_a, n_b, ready_a, ready_b,
                                   stream);
}

// Every class of a plan in one launch (PlanTiles): slab rows [0, n_tiles)
// of c_num / c_flag are written whole, row tk by the class whose rows hold
// it.  `classes` is a host array of 4 ints a class, in slab order: its
// first slab row (ascending, the first 0), its tiles a step t, its first
// step in ab_bases (2 ints a step) and its first entry in p_ptr (t + 1
// entries a class, each giving positions in the concatenated a_offs /
// b_offs).  At most PLAN_MAX_CLASSES classes.  grid, next and the masks as
// in the pair-stream entry.
extern "C" int macro_classes_f32(
        const float* a_dense, const float* b_dense, const int* ab_bases,
        const int* p_ptr, const int* a_offs, const int* b_offs,
        int n_classes, const int* classes, int n_tiles, float* c_num,
        unsigned char* c_flag, int precision, int grid, int* next,
        unsigned* masks_a, unsigned* masks_b, int n_a, int n_b, int ready_a,
        int ready_b, cudaStream_t stream) {
    if (n_tiles <= 0) return (int)cudaSuccess;
    if (n_classes <= 0 || n_classes > PLAN_MAX_CLASSES || classes == nullptr)
        return (int)cudaErrorInvalidValue;
    PlanTiles w{ab_bases, p_ptr, a_offs, b_offs, masks_a, masks_b, next,
                n_tiles, n_classes, {}};
    for (int c = 0; c < n_classes; ++c) {
        w.cls[c] = PlanClass{classes[4 * c], classes[4 * c + 1],
                             classes[4 * c + 2], classes[4 * c + 3]};
        if (w.cls[c].t <= 0 || (c == 0 && w.cls[c].first != 0)
                || (c > 0 && w.cls[c].first < w.cls[c - 1].first)
                || w.cls[c].first >= n_tiles)
            return (int)cudaErrorInvalidValue;
    }
    return (int)with_prec(precision, [&](auto tag) {
        constexpr Prec P = decltype(tag)::value;
        return launch_tiles<P, PlanTiles, false>(
            a_dense, b_dense, w, grid, n_a, n_b, ready_a, ready_b, c_num,
            c_flag, stream);
    });
}

// The float64 pair stream: c_num (c_cap, 128, 128) f64 and c_flag
// (c_cap, 128, 128) u8, written whole with accumulate 0 (the fresh form:
// one block a C tile); with accumulate 1 the stream's tiles are added into
// them, one block a C tile of the walk list (ListTiles' layout), min(c_cap,
// p_cap) blocks, those past its count returning at once, and a tile without
// pairs, or none of whose slabs runs, is neither read nor written.  seg_ptr
// has c_cap + 1 entries (the fresh form's; the accumulate form reads the
// walk instead).  First the k-masks of the n_a A tiles and the n_b
// B tiles whose ready flag is 0 (masks_a / masks_b, F64_MASK_WORDS words a
// tile; one buffer where both operands are one table) and the slabs that
// run of each of the p_cap pairs (need, a byte a pair).
extern "C" int macro_accumulate_pairs_f64(
        const double* a_dense, const double* b_dense, const int* a_idx,
        const int* b_idx, const int* seg_ptr, double* c_num,
        unsigned char* c_flag, int c_cap, int n_a, int n_b, int p_cap,
        unsigned* masks_a, unsigned* masks_b, int ready_a, int ready_b,
        unsigned char* need, int accumulate, const int* walk,
        cudaStream_t stream) {
    if (c_cap <= 0) return (int)cudaSuccess;
    if (n_a <= 0 || n_b <= 0 || p_cap < 0) return (int)cudaErrorInvalidValue;
    if (accumulate && walk == nullptr) return (int)cudaErrorInvalidValue;
    masks_not_ready<double>(f64_tile_masks, F64_THREADS, a_dense, b_dense,
                            masks_a, masks_b, n_a, n_b, ready_a, ready_b,
                            stream);
    if (p_cap > 0)
        f64_pair_need<<<(p_cap + F64_THREADS - 1) / F64_THREADS, F64_THREADS,
                        0, stream>>>(a_idx, b_idx, masks_a, masks_b, need,
                                     p_cap);
    // per launch: the attribute belongs to the current device
    const auto kernel = accumulate ? macro_pairs_f64_kernel<true>
                                   : macro_pairs_f64_kernel<false>;
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F64_SMEM);
    if (attr != cudaSuccess) return (int)attr;
    const int blocks = accumulate ? (c_cap < p_cap ? c_cap : p_cap) : c_cap;
    if (blocks > 0)
        kernel<<<blocks, F64_THREADS, F64_SMEM, stream>>>(
            a_dense, b_dense, a_idx, b_idx, seg_ptr, walk, need, c_num,
            c_flag);
    return (int)cudaGetLastError();
}
