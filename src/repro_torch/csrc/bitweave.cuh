// Shared pieces of the BitWeaving-H kernels for Hopper (sm_90a):
// field masks, the GE/EQ word predicate, the per-thread accumulator of
// [sum, count, min, max], and its reduction across the grid.
//
// Layout (as in the reference, repro/kernels/scan_filter/ref.py): codes of
// BITS bits packed little-endian into 32-bit words, 32 / BITS fields a word,
// the top bit of each field (the delimiter) kept 0 in the data. A mask word
// has the delimiter bit of each selected field set.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bitweave {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;  // 8 x 256 threads fill an SM's 2048

__host__ __device__ constexpr uint32_t delim_mask(int bits) {
  uint32_t m = 0;
  for (int i = 0; i < 32 / bits; ++i) m |= 1u << (i * bits + bits - 1);
  return m;
}

__host__ __device__ constexpr uint32_t low_mask(int bits) {
  uint32_t m = 0;
  for (int i = 0; i < 32 / bits; ++i) m |= 1u << (i * bits);
  return m;
}

// GE: ((X | H) - C) & H       the borrow clears the delimiter where X < C
// EQ: ~(((X ^ C) | H) - L) & H   a zero field borrows its delimiter away
// Exact in uint32: each field of X | H is >= 2^(BITS-1) > C's field, so no
// borrow crosses a field boundary.
template <int BITS>
__device__ __forceinline__ uint32_t predicate(uint32_t x, uint32_t c,
                                              bool is_eq, bool invert) {
  constexpr uint32_t H = delim_mask(BITS);
  constexpr uint32_t L = low_mask(BITS);
  const uint32_t m = is_eq ? (~(((x ^ c) | H) - L) & H)
                           : (((x | H) - c) & H);
  return invert ? (m ^ H) : m;
}

struct Acc {
  unsigned long long sum;
  unsigned long long count;
  uint32_t min;
  uint32_t max;
};

template <int BITS>
__device__ __forceinline__ Acc acc_identity() {
  return Acc{0ull, 0ull, (1u << (BITS - 1)) - 1u, 0u};
}

// Fold one packed word `a` under mask word `m` into the accumulator. The
// field loop unrolls with constant shifts; a word's sum fits 32 bits.
template <int BITS>
__device__ __forceinline__ void accumulate(uint32_t a, uint32_t m, Acc& acc) {
  constexpr int N = 32 / BITS;
  constexpr uint32_t V = (1u << (BITS - 1)) - 1u;
  constexpr uint32_t H = delim_mask(BITS);
  uint32_t s = 0;
#pragma unroll
  for (int f = 0; f < N; ++f) {
    const uint32_t v = (a >> (f * BITS)) & V;
    const bool sel = (m >> (f * BITS + BITS - 1)) & 1u;
    s += sel ? v : 0u;
    acc.min = sel ? min(acc.min, v) : acc.min;
    acc.max = sel ? max(acc.max, v) : acc.max;
  }
  acc.sum += s;
  acc.count += __popc(m & H);
}

// Reduce the block's accumulators (warp shuffles, then shared memory) and
// commit them to `scratch` with integer atomics, which are exact in any
// order. scratch (zeroed by the launcher) holds [sum, count, V - min, max,
// blocks done]: min is kept as V - min and max-reduced so that zero is its
// identity. The last block to finish writes the int32[5] output row
// [sum & 0xFFFF, sum >> 16, count, min, max], the reference's contract.
template <int BITS>
__device__ void commit(Acc acc, unsigned long long* scratch, int32_t* out) {
  constexpr uint32_t V = (1u << (BITS - 1)) - 1u;
  constexpr int kWarps = kThreads / 32;
  __shared__ unsigned long long sh_sum[kWarps];
  __shared__ unsigned long long sh_cnt[kWarps];
  __shared__ uint32_t sh_min[kWarps];
  __shared__ uint32_t sh_max[kWarps];

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc.sum += __shfl_down_sync(0xffffffffu, acc.sum, off);
    acc.count += __shfl_down_sync(0xffffffffu, acc.count, off);
    acc.min = min(acc.min, __shfl_down_sync(0xffffffffu, acc.min, off));
    acc.max = max(acc.max, __shfl_down_sync(0xffffffffu, acc.max, off));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sh_sum[warp] = acc.sum;
    sh_cnt[warp] = acc.count;
    sh_min[warp] = acc.min;
    sh_max[warp] = acc.max;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    acc.sum += sh_sum[w];
    acc.count += sh_cnt[w];
    acc.min = min(acc.min, sh_min[w]);
    acc.max = max(acc.max, sh_max[w]);
  }
  atomicAdd(&scratch[0], acc.sum);
  atomicAdd(&scratch[1], acc.count);
  atomicMax(&scratch[2], (unsigned long long)(V - acc.min));
  atomicMax(&scratch[3], (unsigned long long)acc.max);
  __threadfence();
  const unsigned long long done = atomicAdd(&scratch[4], 1ull);
  if (done != gridDim.x - 1) return;
  // every other block fenced its atomics before counting itself done
  const unsigned long long s = atomicAdd(&scratch[0], 0ull);
  const unsigned long long n = atomicAdd(&scratch[1], 0ull);
  const unsigned long long inv_min = atomicAdd(&scratch[2], 0ull);
  const unsigned long long mx = atomicAdd(&scratch[3], 0ull);
  out[0] = (int32_t)(s & 0xFFFFull);
  out[1] = (int32_t)(s >> 16);
  out[2] = (int32_t)n;
  out[3] = (int32_t)(V - (uint32_t)inv_min);
  out[4] = (int32_t)mx;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Grid-stride launch size: enough blocks to cover `items`, at most
// kBlocksPerSM per SM (the loop inside each thread does the rest).
inline int grid_blocks(long long items) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSM;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace bitweave

// One definition per shared library: each .cu is built into its own .so.
extern "C" const char* bitweave_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
