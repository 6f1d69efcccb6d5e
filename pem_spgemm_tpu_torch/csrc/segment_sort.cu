// Segment sort + dedup for the binned element engine, written for Hopper
// (sm_90a).  Replaces the TPU kernel pem_spgemm_tpu/ops/pallas_sort.py::
// _kernel (reached through segment_sort_dedup) and, with its second entry,
// the dedup scan that the packed path runs on every multiply
// (pem_spgemm_tpu/ops/binned.py::_dedup_tail).
//
// What it computes.  Every row of a (R, L) array is one independent
// segment of int32 column keys with a float32 value payload; 0x7FFFFFFF is
// padding and sorts last.
//   segment_sort_dedup_f32: ascending sort of each row by key, then each
//     equal-key group's sum at the group's first slot, and first-flags.
//   segment_dedup_f32: the second half alone, over rows that are already
//     sorted; it also counts the first-flags.  Given a second bit-pattern
//     operand it forms the value as the product of the two on the fly
//     (the packed path's B-value * A-value step).
// Values at slots that are not a group's first are unspecified (each such
// slot gets a partial sum of its group).
//
// What bounds it.  Bytes, not arithmetic: a slot is 8 B in (key + value,
// 12 B with the fused product) and 9 B out (key, value, one flag byte; 5 B
// for the dedup entry, whose keys are not rewritten), against a handful of
// integer compares.  So each slot moves through device memory once, in
// 16-byte loads and stores, and nothing serialises on run length or on one
// address:
//   * the dedup is a reversed segmented scan.  A thread holds a strip of
//     consecutive slots in registers; the group total at a first slot is
//     the sum from that slot to its run's end.  Run ends come from the
//     neighbouring keys and the row ends.  The scan runs in the strip, then
//     across the warp by shuffles over (partial, run-end) pairs, then
//     across the block through shared memory.  The block's count of
//     first-flags is added to the output with one atomic a block.
//   * dedup entry: a block owns a tile of consecutive slots of the flat
//     rows x L array (tiles are not rows, so one code serves L = 2 and the
//     residual's one row of every slot).  A run that goes on past the tile
//     is finished by the block that holds its first slot: its last warp
//     reads ahead 256 slots from the next tile, and if the run goes on past
//     those, the whole block reads on a tile's width a step (a block whose
//     tile holds no run start reads nothing).  Each continuation is read by
//     one block only, and every sum is taken in a fixed order: results do
//     not change from run to run.  No scratch memory and no order among
//     blocks is needed; the price is that a long run's continuation is
//     read twice.
//   * sort entry: a block owns whole segments (at most 4096 slots).  Each
//     thread holds E consecutive slots (key and value) in registers through
//     the bitonic network: exchanges between slots less than E apart run in
//     registers, less than 32 E apart by warp shuffles, and only the wider
//     ones go through shared memory, in a transposed layout where a thread
//     holds E slots 256 apart: two barriers for each such stage (6 at
//     p2 = 2048, presorted_w = 64, where one barrier a substep made 45).
//     presorted_w (every presorted_w-slot run sorted, odd runs descending:
//     the invariant after the network's first stages) skips those stages;
//     a warp whose slots are padding alone skips a stage's narrow substeps.
//     The dedup scan then runs on the sorted strips as they lie.
//
// K1_SPLIT_NO_COUNT and K1_SPLIT_NO_RUNS cut the count or the group sums
// out of the dedup entry, for bench/k1_split.py's timing builds only; the
// path's build defines neither.
//
// Plain C interface, no PyTorch headers: every function launches on the
// stream it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7FFFFFFF;
constexpr int kMaxSegment = 4096;   // widest segment of the sort entry
constexpr int kThreads = 256;       // threads a block, both entries
constexpr int kWarps = kThreads / 32;
constexpr int kDedupItems = 8;      // slots a thread, dedup entry
constexpr int kDedupTile = kThreads * kDedupItems;
constexpr unsigned kAll = 0xFFFFFFFFu;

// One element of the reversed segmented scan: the sum from a strip's first
// slot up to the first run end at or after it, and whether a run ends in
// the strip.  combine(x, y): x lies before y.
struct Seg {
  float s;
  bool f;
};

__device__ __forceinline__ Seg combine(Seg x, Seg y) {
  return {x.f ? x.s : x.s + y.s, x.f || y.f};
}

// bit e (0 <= e <= E) set where slot e of a strip starts a row; pos0 is the
// strip's first slot's position in its row of length l
template <int E>
__device__ __forceinline__ unsigned row_starts(long long pos0, long long l) {
  unsigned m = 0;
  for (long long o = pos0 == 0 ? 0 : l - pos0; o <= E; o += l) m |= 1u << o;
  return m;
}

// first: a live key that starts its run; last: its run ends here
template <int E>
__device__ __forceinline__ void strip_flags(const int (&k)[E], int prev,
                                            int next, unsigned rs,
                                            unsigned& first, unsigned& last,
                                            unsigned& head) {
  first = last = head = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = e ? k[e - 1] : prev;
    const int n = e < E - 1 ? k[e + 1] : next;
    const bool h = ((rs >> e) & 1u) || k[e] != p;
    head |= static_cast<unsigned>(h) << e;
    first |= static_cast<unsigned>(h && k[e] != kSentinel) << e;
    last |= static_cast<unsigned>(((rs >> (e + 1)) & 1u) || k[e] != n) << e;
  }
}

// in the strip: v[e] += v[e+1] unless a run ends at e
template <int E>
__device__ __forceinline__ Seg scan_strip(float (&v)[E], unsigned last) {
#pragma unroll
  for (int e = E - 2; e >= 0; --e) {
    if (!((last >> e) & 1u)) v[e] += v[e + 1];
  }
  return {v[0], last != 0};
}

// the strip's slots after its last run end take the carry from the right
template <int E>
__device__ __forceinline__ void add_carry(float (&v)[E], unsigned last,
                                          float x) {
  const int open = last ? 32 - __clz(last) : 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e >= open) v[e] += x;
  }
}

// Across the warp: (exclusive, inclusive) reversed scan, the exclusive one
// being what flows into this lane's strip from the lanes after it.
__device__ __forceinline__ void warp_scan(Seg mine, Seg& exc, Seg& inc) {
  const int lane = threadIdx.x & 31;
  inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float s = __shfl_down_sync(kAll, inc.s, d);
    const bool f = __shfl_down_sync(kAll, static_cast<int>(inc.f), d);
    if (lane + d < 32) inc = combine(inc, Seg{s, f});
  }
  const float s = __shfl_down_sync(kAll, inc.s, 1);
  const bool f = __shfl_down_sync(kAll, static_cast<int>(inc.f), 1);
  exc = lane < 31 ? Seg{s, f} : Seg{0.0f, false};
}

// What flows into this thread's strip from the rest of the block and from
// after the tile (tile_carry), in a fixed order; agg holds each warp's
// inclusive pair.
__device__ __forceinline__ float block_carry(const Seg* agg, Seg exc,
                                             float tile_carry) {
  Seg acc{tile_carry, true};
  for (int w = kWarps - 1; w > static_cast<int>(threadIdx.x >> 5); --w) {
    acc = combine(agg[w], acc);
  }
  return combine(exc, acc).s;
}

__device__ __forceinline__ uint32_t flag_bytes(unsigned bits) {
  return (bits & 1u) | ((bits & 2u) << 7) | ((bits & 4u) << 14) |
         ((bits & 8u) << 21);
}

// --------------------------------------------------------------------------
// dedup entry

template <bool FUSED>
__device__ __forceinline__ float value_of(const void* vals, const int* abits,
                                          long long q) {
  if (FUSED) {
    return __int_as_float(static_cast<const int*>(vals)[q]) *
           __int_as_float(abits[q]);
  }
  return static_cast<const float*>(vals)[q];
}

// One thread's part of a read-ahead step: slots q .. q + E - 1 against the
// run's key kt.  brk is the first slot not in the run (E if all are); the
// result is the sum of the run's values before it.
template <bool FUSED, int E>
__device__ __forceinline__ float run_part(const int* keys, const void* vals,
                                          const int* abits, int kt,
                                          long long q, long long limit,
                                          int& brk) {
  brk = E;
  float part = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool in = q + e < limit && keys[q + e] == kt;
    if (brk == E && !in) brk = e;
    if (brk == E) part += value_of<FUSED>(vals, abits, q + e);
  }
  return part;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kAll, x, d);
  return x;
}

// A block: one tile of kDedupTile consecutive slots of the flat array.
// VEC: every pointer is 16-byte aligned, so whole strips move as int4.
template <bool FUSED, bool VEC>
__global__ void __launch_bounds__(kThreads) segment_dedup_kernel(
    const int* __restrict__ keys, const void* __restrict__ vals,
    const int* __restrict__ abits, float* __restrict__ vals_out,
    uint8_t* __restrict__ first_out, int* __restrict__ count,
    long long total, long long l) {
  constexpr int E = kDedupItems;
  __shared__ Seg agg[kWarps];
  __shared__ int warp_count[kWarps];
  __shared__ int warp_head[kWarps];
  __shared__ int warp_stop[kWarps];
  __shared__ float warp_part[kWarps];
  __shared__ int tail_key;
  __shared__ int goes_on;
  __shared__ float tile_carry;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kDedupTile;
  const long long start = base + static_cast<long long>(threadIdx.x) * E;
  const bool full = start + E <= total;

  int k[E];
  float v[E];
  if (VEC && full) {
#pragma unroll
    for (int h = 0; h < E; h += 4) {
      const int4 kk = *reinterpret_cast<const int4*>(keys + start + h);
      k[h] = kk.x; k[h + 1] = kk.y; k[h + 2] = kk.z; k[h + 3] = kk.w;
      if (FUSED) {
        const int4 b = *reinterpret_cast<const int4*>(
            static_cast<const int*>(vals) + start + h);
        const int4 a = *reinterpret_cast<const int4*>(abits + start + h);
        v[h] = __int_as_float(b.x) * __int_as_float(a.x);
        v[h + 1] = __int_as_float(b.y) * __int_as_float(a.y);
        v[h + 2] = __int_as_float(b.z) * __int_as_float(a.z);
        v[h + 3] = __int_as_float(b.w) * __int_as_float(a.w);
      } else {
        const float4 f = *reinterpret_cast<const float4*>(
            static_cast<const float*>(vals) + start + h);
        v[h] = f.x; v[h + 1] = f.y; v[h + 2] = f.z; v[h + 3] = f.w;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long q = start + e;
      k[e] = q < total ? keys[q] : kSentinel;
      v[e] = q < total ? value_of<FUSED>(vals, abits, q) : 0.0f;
    }
  }

  // neighbours of the strip: the lanes beside it, or device memory at the
  // warp's edges (lines the neighbouring warps have just loaded)
  int prev = __shfl_up_sync(kAll, k[E - 1], 1);
  int next = __shfl_down_sync(kAll, k[0], 1);
  if (lane == 0) prev = start > 0 && start <= total ? keys[start - 1] : 0;
  if (lane == 31) next = start + E < total ? keys[start + E] : kSentinel;
  const unsigned rs = row_starts<E>(start % l, l);
  unsigned first, last, head;
  strip_flags<E>(k, prev, next, rs, first, last, head);

#ifndef K1_SPLIT_NO_RUNS
  Seg exc, inc;
  warp_scan(scan_strip<E>(v, last), exc, inc);
  if (lane == 0) agg[warp] = inc;
#endif
  const int any_head = __any_sync(kAll, head != 0);
  int c = __reduce_add_sync(kAll, __popc(first));
  if (lane == 0) {
    warp_count[warp] = c;
    warp_head[warp] = any_head;
  }
  if (threadIdx.x == kThreads - 1) {
    // the tile's last slot: does a live run go on past the tile?
    tail_key = ((last >> (E - 1)) & 1u) || k[E - 1] == kSentinel
                   ? kSentinel : k[E - 1];
  }
  __syncthreads();

#ifndef K1_SPLIT_NO_COUNT
  if (threadIdx.x == 0) {
    c = 0;
    for (int w = 0; w < kWarps; ++w) c += warp_count[w];
    if (c) atomicAdd(count, c);
  }
#endif

#ifndef K1_SPLIT_NO_RUNS
  int starts_run = 0;
  for (int w = 0; w < kWarps; ++w) starts_run |= warp_head[w];
  float carry = 0.0f;
  const int kt = tail_key;
  if (kt != kSentinel && starts_run) {
    // the tile's last run starts in it and goes on: its continuation is
    // summed up to the run's end or the row's.  The last warp reads the
    // first 32 E slots (most runs end there); a run that still goes on is
    // read by the whole block, a tile's width a step.
    const long long end_row = ((base + kDedupTile - 1) / l + 1) * l;
    const long long limit = end_row < total ? end_row : total;
    long long q0 = base + kDedupTile;
    if (warp == kWarps - 1) {
      int brk;
      float part = run_part<FUSED, E>(keys, vals, abits, kt, q0 + lane * E,
                                      limit, brk);
      const unsigned ended = __ballot_sync(kAll, brk < E);
      if (ended && lane > __ffs(ended) - 1) part = 0.0f;
      part = warp_sum(part);
      if (lane == 0) {
        tile_carry = part;
        goes_on = !ended && q0 + 32 * E < limit;
      }
    }
    __syncthreads();
    carry = tile_carry;
    q0 += 32 * E;
    if (goes_on) {
      for (;; q0 += kDedupTile) {
        int brk;
        float part = run_part<FUSED, E>(keys, vals, abits, kt, start - base
                                        + q0, limit, brk);
        const unsigned ended = __ballot_sync(kAll, brk < E);
        if (lane == 0) warp_stop[warp] = ended ? __ffs(ended) - 1 : 32;
        __syncthreads();
        int stop = kThreads;            // the first thread that sees the end
        for (int w = kWarps - 1; w >= 0; --w) {
          if (warp_stop[w] < 32) stop = w * 32 + warp_stop[w];
        }
        if (static_cast<int>(threadIdx.x) > stop) part = 0.0f;
        part = warp_sum(part);
        if (lane == 0) warp_part[warp] = part;
        __syncthreads();
        for (int w = 0; w < kWarps; ++w) carry += warp_part[w];
        const bool more = stop == kThreads && q0 + kDedupTile < limit;
        __syncthreads();                // warp_stop, warp_part are reused
        if (!more) break;
      }
    }
  }
  add_carry<E>(v, last, block_carry(agg, exc, carry));
#endif

  if (VEC && full) {
#pragma unroll
    for (int h = 0; h < E; h += 4) {
      *reinterpret_cast<float4*>(vals_out + start + h) =
          make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
    }
    *reinterpret_cast<uint2*>(first_out + start) =
        make_uint2(flag_bytes(first), flag_bytes(first >> 4));
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (start + e < total) {
        vals_out[start + e] = v[e];
        first_out[start + e] = (first >> e) & 1u;
      }
    }
  }
}

// --------------------------------------------------------------------------
// sort entry

// compare-exchange of two slots held by one thread (a before b)
__device__ __forceinline__ void exchange(int& ka, int& kb, float& va,
                                         float& vb, bool up) {
  const bool sw = (ka > kb) == up && ka != kb;
  const int k0 = ka;
  const float v0 = va;
  ka = sw ? kb : ka;
  kb = sw ? k0 : kb;
  va = sw ? vb : va;
  vb = sw ? v0 : vb;
}

// shared-memory index of tile slot i: one word of padding every 32 keeps
// both layouts' accesses free of bank conflicts
__device__ __forceinline__ int spad(int i) { return i + (i >> 5); }

// A block: TILE = 256 E slots, whole segments of p2 slots (sentinel-padded
// from mw).  In layout A thread t holds tile slots t E .. t E + E - 1; in
// layout B it holds slots r 256 + t, r < E.
template <int E>
__global__ void __launch_bounds__(kThreads, E == 8 ? 5 : 3)
    segment_sort_dedup_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    int* __restrict__ keys_out, float* __restrict__ vals_out,
    uint8_t* __restrict__ first_out, long long rows, int mw, int p2,
    int first_k, bool vec) {
  constexpr int TILE = kThreads * E;
  constexpr int kLogE = E == 8 ? 3 : 4;
  static_assert(E == 8 || E == 16, "8 or 16 slots a thread");
  // substeps with slots >= 32 E apart: TILE / 2 down to 32 E
  constexpr int kWideSteps = 3;
  static_assert(TILE / 2 == (32 * E) << (kWideSteps - 1), "256 threads");
  __shared__ int sk[TILE + TILE / 32];
  __shared__ float sv[TILE + TILE / 32];
  __shared__ Seg agg[kWarps];
  __shared__ int edge_first[kWarps];
  __shared__ int edge_last[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int lg = __ffs(p2) - 1;
  const int mask = p2 - 1;
  const long long row0 = static_cast<long long>(blockIdx.x) * (TILE >> lg);
  const int i0 = t * E;                 // tile index of the strip's first slot

  int k[E];
  float v[E];
  if (vec) {                            // mw % E == 0: a strip is all in or
    const int local = i0 & mask;        // all padding
    const long long row = row0 + (i0 >> lg);
    const bool live = row < rows && local < mw;
    const long long g = live ? row * mw + local : 0;
#pragma unroll
    for (int h = 0; h < E; h += 4) {
      const int4 kk = live ? *reinterpret_cast<const int4*>(cols + g + h)
                           : make_int4(kSentinel, kSentinel, kSentinel,
                                       kSentinel);
      const float4 f = live ? *reinterpret_cast<const float4*>(vals + g + h)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      k[h] = kk.x; k[h + 1] = kk.y; k[h + 2] = kk.z; k[h + 3] = kk.w;
      v[h] = f.x; v[h + 1] = f.y; v[h + 2] = f.z; v[h + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int local = (i0 + e) & mask;
      const long long row = row0 + ((i0 + e) >> lg);
      const bool live = row < rows && local < mw;
      k[e] = live ? cols[row * mw + local] : kSentinel;
      v[e] = live ? vals[row * mw + local] : 0.0f;
    }
  }

  // bitonic network, ascending per segment: stage k merges runs of k / 2;
  // its substep j exchanges slots j apart, the lower one keeping the
  // smaller key where the slot's bit k is clear (always at k = p2)
  for (int k_st = first_k; k_st <= p2; k_st <<= 1) {
    const bool last_stage = k_st == p2;
    if ((k_st >> 1) >= 32 * E) {
      // wide substeps: transpose to layout B, exchange in registers, back
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sk[spad(i0 + e)] = k[e];
        sv[spad(i0 + e)] = v[e];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < E; ++r) {
        k[r] = sk[spad(r * kThreads + t)];
        v[r] = sv[spad(r * kThreads + t)];
      }
#pragma unroll
      for (int s = 0; s < kWideSteps; ++s) {   // j = TILE / 2 .. 32 E
        const int j = (TILE / 2) >> s;
        if (j < k_st) {
#pragma unroll
          for (int r = 0; r < E; ++r) {
            const int rj = j / kThreads;
            if (!(r & rj)) {
              const bool up = last_stage || !((r * kThreads + t) & k_st);
              exchange(k[r], k[r | rj], v[r], v[r | rj], up);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < E; ++r) {
        sk[spad(r * kThreads + t)] = k[r];
        sv[spad(r * kThreads + t)] = v[r];
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e) {
        k[e] = sk[spad(i0 + e)];
        v[e] = sv[spad(i0 + e)];
      }
    }
    // A warp whose slots lie in a k-block of padding alone (sentinels,
    // sorted either way) skips the stage's narrow substeps.  Warp-uniform.
    const int local0 = (warp * 32 * E) & mask;
    if ((local0 & ~(k_st - 1)) >= mw) continue;
    // substeps within the warp: the partner slot is in lane ^ (j / E)
    {
      const bool up = last_stage || !(i0 & k_st);
#pragma unroll
      for (int s = 0; s < 5; ++s) {            // j = 16 E .. E
        const int j = (16 * E) >> s;
        if (j < k_st) {
          const int lm = j / E;
          const bool keep_min = ((lane & lm) == 0) == up;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int pk = __shfl_xor_sync(kAll, k[e], lm);
            const float pv = __shfl_xor_sync(kAll, v[e], lm);
            const bool take = keep_min ? pk < k[e] : pk > k[e];
            k[e] = take ? pk : k[e];
            v[e] = take ? pv : v[e];
          }
        }
      }
    }
    // substeps within the thread
#pragma unroll
    for (int s = 0; s < kLogE; ++s) {          // j = E / 2 .. 1
      const int j = (E / 2) >> s;
      if (j < k_st) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (!(e & j)) {
            const bool up = last_stage || !((i0 + e) & k_st);
            exchange(k[e], k[e | j], v[e], v[e | j], up);
          }
        }
      }
    }
  }

  // dedup of the sorted strips; a tile ends with a segment, so nothing
  // flows in from after it
  if (lane == 0) edge_first[warp] = k[0];
  if (lane == 31) edge_last[warp] = k[E - 1];
  __syncthreads();
  int prev = __shfl_up_sync(kAll, k[E - 1], 1);
  int next = __shfl_down_sync(kAll, k[0], 1);
  if (lane == 0) prev = warp ? edge_last[warp - 1] : kSentinel;
  if (lane == 31) next = warp < kWarps - 1 ? edge_first[warp + 1] : kSentinel;
  const unsigned rs = row_starts<E>(i0 & mask, p2);
  unsigned first, last, head;
  strip_flags<E>(k, prev, next, rs, first, last, head);
  Seg exc, inc;
  warp_scan(scan_strip<E>(v, last), exc, inc);
  if (lane == 0) agg[warp] = inc;
  __syncthreads();
  add_carry<E>(v, last, block_carry(agg, exc, 0.0f));

  if (vec) {
    const int local = i0 & mask;
    const long long row = row0 + (i0 >> lg);
    if (row < rows && local < mw) {
      const long long g = row * mw + local;
#pragma unroll
      for (int h = 0; h < E; h += 4) {
        *reinterpret_cast<int4*>(keys_out + g + h) =
            make_int4(k[h], k[h + 1], k[h + 2], k[h + 3]);
        *reinterpret_cast<float4*>(vals_out + g + h) =
            make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
        *reinterpret_cast<uint32_t*>(first_out + g + h) =
            flag_bytes(first >> h);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int local = (i0 + e) & mask;
      const long long row = row0 + ((i0 + e) >> lg);
      if (row < rows && local < mw) {
        const long long g = row * mw + local;
        keys_out[g] = k[e];
        vals_out[g] = v[e];
        first_out[g] = (first >> e) & 1u;
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int E>
int launch_sort(const void* cols, const void* vals, void* keys_out,
                void* vals_out, void* first_out, long long rows, int mw,
                int p2, int first_k, cudaStream_t s) {
  const int segs = kThreads * E / p2;
  const long long blocks = (rows + segs - 1) / segs;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = mw % E == 0 && aligned16(cols) && aligned16(vals) &&
                   aligned16(keys_out) && aligned16(vals_out) &&
                   (reinterpret_cast<uintptr_t>(first_out) & 3u) == 0;
  segment_sort_dedup_kernel<E><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<int*>(keys_out), static_cast<float*>(vals_out),
      static_cast<uint8_t*>(first_out), rows, mw, p2, first_k, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool FUSED, bool VEC>
void launch_dedup(const void* keys, const void* vals, const void* abits,
                  void* vals_out, void* first_out, void* count,
                  long long total, long long l, long long blocks,
                  cudaStream_t s) {
  segment_dedup_kernel<FUSED, VEC><<<static_cast<unsigned>(blocks), kThreads,
                                     0, s>>>(
      static_cast<const int*>(keys), vals, static_cast<const int*>(abits),
      static_cast<float*>(vals_out), static_cast<uint8_t*>(first_out),
      static_cast<int*>(count), total, l);
}

}  // namespace

extern "C" {

// cols/vals (rows, mw) -> keys_out/vals_out (rows, mw), first_out bytes.
// p2 is the power of two >= mw (<= 4096); presorted_w is 0 or a power of
// two that divides mw.
int segment_sort_dedup_f32(const void* cols, const void* vals,
                           void* keys_out, void* vals_out, void* first_out,
                           long long rows, int mw, int p2, int presorted_w,
                           void* stream) {
  if (rows <= 0 || mw <= 0) return static_cast<int>(cudaSuccess);
  if (p2 < mw || p2 < 2 || p2 > kMaxSegment || (p2 & (p2 - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int first_k = presorted_w > 1 ? presorted_w * 2 : 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p2 <= kThreads * 8) {
    return launch_sort<8>(cols, vals, keys_out, vals_out, first_out, rows,
                          mw, p2, first_k, s);
  }
  return launch_sort<16>(cols, vals, keys_out, vals_out, first_out, rows, mw,
                         p2, first_k, s);
}

// keys (rows, l) sorted per row; vals float32, or (abits != null) int32 bit
// patterns whose product with abits is the value.  count must be zeroed by
// the caller; the number of first-flags is added to it.
int segment_dedup_f32(const void* keys, const void* vals, const void* abits,
                      void* vals_out, void* first_out, void* count,
                      long long rows, long long l, void* stream) {
  const long long total = rows * l;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (total + kDedupTile - 1) / kDedupTile;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(keys) && aligned16(vals) &&
                   (abits == nullptr || aligned16(abits)) &&
                   aligned16(vals_out) &&
                   (reinterpret_cast<uintptr_t>(first_out) & 7u) == 0;
  if (abits != nullptr) {
    if (vec) {
      launch_dedup<true, true>(keys, vals, abits, vals_out, first_out, count,
                               total, l, blocks, s);
    } else {
      launch_dedup<true, false>(keys, vals, abits, vals_out, first_out,
                                count, total, l, blocks, s);
    }
  } else if (vec) {
    launch_dedup<false, true>(keys, vals, abits, vals_out, first_out, count,
                              total, l, blocks, s);
  } else {
    launch_dedup<false, false>(keys, vals, abits, vals_out, first_out, count,
                               total, l, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
