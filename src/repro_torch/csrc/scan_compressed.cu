// Scan-over-compressed: fused predicate + aggregate directly on RLE runs,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/scan_compressed/kernel.py::rle_scan_aggregate_batched_packed
// (body _rle_batched_kernel) and, launched through its own entry point with
// one chunk, repro/kernels/scan_compressed/kernel.py::rle_scan_aggregate_packed
// (body _rle_kernel). Run values are decoded codes, so every predicate is a
// plain int32 compare: a selected run (value v, length n > 0) adds n to the
// count, n * v to the sum and v to min/max; zero-length runs are padding and
// select nothing. Output: one int32[5] row [sum_lo, sum_hi, count, min, max]
// per chunk.
//
// Bound: memory. Each run costs 8 bytes read (value + length) for about
// seven integer operations; a sorted or low-cardinality column has so few
// runs that a launch moves kilobytes and is bound by launch latency
// instead. One body, two routes, chosen by the caller (kernels/
// scan_compressed/kernel.py::route) from the run count:
// - block: one 256-thread block per chunk, block reduction (shuffles, then
//   shared memory). For long chunks, whose runs fill the block.
// - warp: one warp per chunk, eight chunks a block (a block of
//   32 * n_chunks threads below eight), reduced by shuffles alone: no
//   shared memory, no barrier. For short chunks, where a block would idle
//   most of its threads and pay a block reduction for a few runs.
// Both read their runs with 16-byte loads when the row stride allows them,
// keep a 64-bit sum and count per thread (the store bounds a chunk's sum
// below 2^31; only the output row splits it) and signed min/max as the
// reference's int32 compares, and write each chunk's row directly.
#include "bitweave.cuh"

using namespace bitweave;

namespace {

enum Op { kLt = 0, kLe = 1, kGt = 2, kGe = 3, kEq = 4, kNe = 5 };
// route codes of the C entries (kernel.py ROUTES is indexed by them)
enum Route { kBlock = 0, kWarp = 1 };
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ bool compare(int32_t v, int32_t c, int op) {
  switch (op) {
    case kLt: return v < c;
    case kLe: return v <= c;
    case kGt: return v > c;
    case kGe: return v >= c;
    case kEq: return v == c;
    default: return v != c;
  }
}

struct RunAcc {
  unsigned long long sum;
  unsigned long long count;
  int32_t min;
  int32_t max;
};

__device__ __forceinline__ void add_run(int32_t v, int32_t n, int32_t c,
                                        int op, RunAcc& acc) {
  const bool sel = compare(v, c, op) && n > 0;
  acc.sum += sel ? (unsigned long long)((long long)v * n) : 0ull;
  acc.count += sel ? (unsigned long long)n : 0ull;
  acc.min = sel ? min(acc.min, v) : acc.min;
  acc.max = sel ? max(acc.max, v) : acc.max;
}

// Fold runs first, first + stride, ... of one chunk's (n_runs,) planes:
// with `vec`, the 16-byte body by int4 (thread t takes int4s t, t +
// stride, ...) and then the scalar tail past it; without, all scalar.
__device__ __forceinline__ void scan_runs(const int32_t* v, const int32_t* l,
                                          long long n_runs, int first,
                                          int stride, bool vec, int32_t c,
                                          int op, RunAcc& acc) {
  long long head = 0;
  if (vec) {
    const long long n4 = n_runs / 4;
    const int4* v4 = reinterpret_cast<const int4*>(v);
    const int4* l4 = reinterpret_cast<const int4*>(l);
    for (long long i = first; i < n4; i += stride) {
      const int4 a = __ldcs(&v4[i]);
      const int4 b = __ldcs(&l4[i]);
      add_run(a.x, b.x, c, op, acc);
      add_run(a.y, b.y, c, op, acc);
      add_run(a.z, b.z, c, op, acc);
      add_run(a.w, b.w, c, op, acc);
    }
    head = n4 * 4;
  }
  for (long long i = head + first; i < n_runs; i += stride)
    add_run(v[i], l[i], c, op, acc);
}

// The warp's total in every lane, by an xor-shuffle tree.
__device__ __forceinline__ void warp_reduce(RunAcc& acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc.sum += __shfl_xor_sync(0xffffffffu, acc.sum, off);
    acc.count += __shfl_xor_sync(0xffffffffu, acc.count, off);
    acc.min = min(acc.min, __shfl_xor_sync(0xffffffffu, acc.min, off));
    acc.max = max(acc.max, __shfl_xor_sync(0xffffffffu, acc.max, off));
  }
}

}  // namespace

template <int kRoute>
__global__ void __launch_bounds__(kThreads)
rle_scan_aggregate_kernel(const int32_t* __restrict__ values,
                          const int32_t* __restrict__ lengths,
                          long long n_chunks, long long n_runs, int32_t c,
                          int op, int32_t vmax, int32_t* out, bool vec) {
  RunAcc acc{0ull, 0ull, vmax, 0};
  if constexpr (kRoute == kWarp) {
    // a warp-uniform chunk: a warp past the last returns whole, and the
    // shuffles of the others keep all 32 lanes
    const long long chunk =
        (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
    if (chunk >= n_chunks) return;
    const long long row = chunk * n_runs;
    scan_runs(values + row, lengths + row, n_runs, threadIdx.x % 32, 32,
              vec, c, op, acc);
    warp_reduce(acc);
    if (threadIdx.x % 32 == 0)
      write_row(acc.sum, acc.count, acc.min, acc.max, out + 5 * chunk);
  } else {
    const long long row = (long long)blockIdx.x * n_runs;
    scan_runs(values + row, lengths + row, n_runs, threadIdx.x, blockDim.x,
              vec, c, op, acc);
    block_reduce(acc.sum, acc.count, acc.min, acc.max);
    if (threadIdx.x == 0)
      write_row(acc.sum, acc.count, acc.min, acc.max,
                out + 5 * (long long)blockIdx.x);
  }
}

static int launch(const void* values, const void* lengths, void* out,
                  long long n_chunks, long long n_runs, int constant, int op,
                  int code_bits, int route, void* stream) {
  if (n_chunks < 1 || n_chunks > 0x7fffffffLL || n_runs < 0 || op < kLt
      || op > kNe || code_bits < 2 || code_bits > 16
      || (route != kBlock && route != kWarp))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const int32_t*>(values);
  const auto* l = static_cast<const int32_t*>(lengths);
  auto* o = static_cast<int32_t*>(out);
  const bool vec = aligned16(values) && aligned16(lengths) && n_runs % 4 == 0;
  const int32_t vmax = (1 << (code_bits - 1)) - 1;
  if (route == kWarp) {
    const long long blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const int threads =
        32 * (int)(n_chunks < kWarpsPerBlock ? n_chunks : kWarpsPerBlock);
    rle_scan_aggregate_kernel<kWarp><<<dim3((unsigned)blocks), threads, 0,
                                       s>>>(v, l, n_chunks, n_runs, constant,
                                            op, vmax, o, vec);
  } else {
    rle_scan_aggregate_kernel<kBlock><<<dim3((unsigned)n_chunks), kThreads,
                                        0, s>>>(v, l, n_chunks, n_runs,
                                                constant, op, vmax, o, vec);
  }
  return (int)cudaGetLastError();
}

// One chunk: (n_runs,) planes -> int32[1, 5].
extern "C" int rle_scan_aggregate_launch(const void* values,
                                         const void* lengths, void* out,
                                         long long n_runs, int constant,
                                         int op, int code_bits, int route,
                                         void* stream) {
  return launch(values, lengths, out, 1, n_runs, constant, op, code_bits,
                route, stream);
}

// Every chunk in one launch: (n_chunks, n_runs) planes -> int32[n_chunks, 5].
extern "C" int rle_scan_aggregate_batched_launch(
    const void* values, const void* lengths, void* out, long long n_chunks,
    long long n_runs, int constant, int op, int code_bits, int route,
    void* stream) {
  return launch(values, lengths, out, n_chunks, n_runs, constant, op,
                code_bits, route, stream);
}
