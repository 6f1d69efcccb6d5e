// Segment sort + dedup for the binned element engine, written for Hopper
// (sm_90a).  Replaces the TPU kernel pem_spgemm_tpu/ops/pallas_sort.py::
// _kernel (reached through segment_sort_dedup) and, with its second entry,
// the dedup scan that the packed path runs on every multiply
// (pem_spgemm_tpu/ops/binned.py::_dedup_tail).
//
// What it computes.  Every row of a (R, MW) array is one independent
// segment of int32 column keys with a float32 value payload; 0x7FFFFFFF is
// padding and sorts last.
//   segment_sort_dedup_f32: ascending sort of each row by key, then each
//     equal-key group's sum at the group's first slot, and first-flags.
//   segment_dedup_f32: the second half alone, over rows that are already
//     sorted; it also counts the first-flags.  Given a second bit-pattern
//     operand it forms the value as the product of the two on the fly
//     (the packed path's B-value * A-value step).
// Values at slots that are not a group's first are unspecified (each such
// slot gets its own input value back).
//
// What bounds it.  Bytes, not arithmetic: a slot is 8 B in (key + value,
// 12 B with the fused product) and 9 B out (key, value, one flag byte; 5 B
// for the dedup entry, whose keys are not rewritten), against a handful of
// integer compares.  So the design moves each slot through device memory
// once:
//   * sort entry: one thread block owns whole segments in shared memory
//     (a segment is at most 4096 slots = 32 KB of keys and values; short
//     segments share a block so a block always holds >= 1024 slots).  The
//     load pads MW up to the next power of two with the sentinel in shared
//     memory, never in device memory.  The compare-exchange network runs in
//     shared memory with one __syncthreads() per substep, then the dedup
//     reads the sorted segment from shared memory and each slot is written
//     out once.  Blocks are independent.
//   * presorted_w (every presorted_w-slot run of the input already sorted,
//     odd runs descending) IS used: the network starts at the stage that
//     merges runs of that width and skips the intra-run stages.
//   * dedup: a thread that holds a group's first slot walks its run and
//     sums it.  Duplicate runs are short (the plan measures them; 2-4 is
//     typical), so this needs no scan, no shared memory and no width limit,
//     and reads hit lines the neighbouring threads have just loaded.  The
//     `rounds` bound of the TPU scan is therefore not needed here.
//
// Plain C interface, no PyTorch headers: every function launches on the
// stream it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7FFFFFFF;
constexpr int kMaxSegment = 4096;   // widest segment of the sort entry
constexpr int kMinTile = 1024;      // slots a sort block holds at least

__global__ void segment_sort_dedup_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    int* __restrict__ keys_out, float* __restrict__ vals_out,
    uint8_t* __restrict__ first_out, long long rows, int mw, int p2,
    int tile, int first_k) {
  extern __shared__ int smem[];
  int* sk = smem;
  float* sv = reinterpret_cast<float*>(smem + tile);

  const int segs = tile / p2;                       // segments per block
  const long long row0 = static_cast<long long>(blockIdx.x) * segs;
  const int mask = p2 - 1;
  const int lg = __ffs(p2) - 1;

  // load: pad each segment to p2 with the sentinel, in shared memory only
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int local = e & mask;
    const long long row = row0 + (e >> lg);
    int k = kSentinel;
    float v = 0.0f;
    if (local < mw && row < rows) {
      const long long g = row * mw + local;
      k = cols[g];
      v = vals[g];
    }
    sk[e] = k;
    sv[e] = v;
  }
  __syncthreads();

  // bitonic network, ascending per segment.  first_k = 2 runs all of it;
  // first_k = 2 * presorted_w runs the merge stages only.
  const int pairs = tile >> 1;
  for (int k = first_k; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
        const int i = ((t / j) * (j << 1)) + (t % j);
        const int p = i + j;
        const bool asc = ((i & mask) & k) == 0;     // k == p2: always true
        const int ki = sk[i];
        const int kp = sk[p];
        if ((ki > kp) == asc && ki != kp) {
          sk[i] = kp;
          sk[p] = ki;
          const float vi = sv[i];
          sv[i] = sv[p];
          sv[p] = vi;
        }
      }
      __syncthreads();
    }
  }

  // dedup from shared memory; every live slot is written once
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int local = e & mask;
    const long long row = row0 + (e >> lg);
    if (local >= mw || row >= rows) continue;
    const int k = sk[e];
    const bool first =
        k != kSentinel && (local == 0 || sk[e - 1] != k);
    float s = sv[e];
    if (first) {
      const int end = e - local + p2;
      for (int q = e + 1; q < end && sk[q] == k; ++q) s += sv[q];
    }
    const long long g = row * mw + local;
    keys_out[g] = k;
    vals_out[g] = s;
    first_out[g] = first ? 1 : 0;
  }
}

// One thread per slot over rows that are already sorted.  FUSED: the value
// is the product of two float bit patterns.
template <bool FUSED>
__global__ void segment_dedup_kernel(
    const int* __restrict__ keys, const void* __restrict__ vals,
    const int* __restrict__ abits, float* __restrict__ vals_out,
    uint8_t* __restrict__ first_out, int* __restrict__ count,
    long long total, long long l) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool first = false;
  if (i < total) {
    const long long pos = i % l;
    const int k = keys[i];
    first = k != kSentinel && (pos == 0 || keys[i - 1] != k);
    auto value = [&](long long q) -> float {
      if (FUSED) {
        return __int_as_float(static_cast<const int*>(vals)[q]) *
               __int_as_float(abits[q]);
      }
      return static_cast<const float*>(vals)[q];
    };
    float s = value(i);
    if (first) {
      const long long end = i - pos + l;
      for (long long q = i + 1; q < end && keys[q] == k; ++q) s += value(q);
    }
    vals_out[i] = s;
    first_out[i] = first ? 1 : 0;
  }
  // count of first-flags: warp ballot, one atomic per warp that has any
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, first);
  if ((threadIdx.x & 31) == 0 && ballot != 0) {
    atomicAdd(count, __popc(ballot));
  }
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
  if (p2 < mw || p2 > kMaxSegment || (p2 & (p2 - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = p2 > kMinTile ? p2 : kMinTile;
  const int segs = tile / p2;
  const long long blocks = (rows + segs - 1) / segs;
  const int threads = 512;                      // tile / 2 pairs, looped
  const size_t shmem = static_cast<size_t>(tile) * 8;
  int first_k = 2;
  if (presorted_w > 1) first_k = presorted_w * 2;
  segment_sort_dedup_kernel<<<static_cast<unsigned>(blocks), threads, shmem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<int*>(keys_out), static_cast<float*>(vals_out),
      static_cast<uint8_t*>(first_out), rows, mw, p2, tile, first_k);
  return static_cast<int>(cudaGetLastError());
}

// keys (rows, l) sorted per row; vals float32, or (abits != null) int32 bit
// patterns whose product with abits is the value.  count must be zeroed by
// the caller; the number of first-flags is added to it.
int segment_dedup_f32(const void* keys, const void* vals, const void* abits,
                      void* vals_out, void* first_out, void* count,
                      long long rows, long long l, void* stream) {
  const long long total = rows * l;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (abits != nullptr) {
    segment_dedup_kernel<true><<<static_cast<unsigned>(blocks), threads, 0,
                                 s>>>(
        static_cast<const int*>(keys), vals, static_cast<const int*>(abits),
        static_cast<float*>(vals_out), static_cast<uint8_t*>(first_out),
        static_cast<int*>(count), total, l);
  } else {
    segment_dedup_kernel<false><<<static_cast<unsigned>(blocks), threads, 0,
                                  s>>>(
        static_cast<const int*>(keys), vals, nullptr,
        static_cast<float*>(vals_out), static_cast<uint8_t*>(first_out),
        static_cast<int*>(count), total, l);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
