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
// instead. Design: one block per chunk over its (n_runs,) slice of the
// (n_chunks, n_runs) planes, 16-byte loads when the row stride allows them,
// 64-bit sum and count per thread (the store bounds a chunk's sum below
// 2^31; only the output row splits it), signed min/max as the reference's
// int32 compares, block reduction and a direct write of the chunk's row.
#include "bitweave.cuh"

using namespace bitweave;

namespace {

enum Op { kLt = 0, kLe = 1, kGt = 2, kGe = 3, kEq = 4, kNe = 5 };

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

}  // namespace

__global__ void __launch_bounds__(kThreads)
rle_scan_aggregate_kernel(const int32_t* __restrict__ values,
                          const int32_t* __restrict__ lengths,
                          long long n_runs, int32_t c, int op, int32_t vmax,
                          int32_t* out, bool vec) {
  RunAcc acc{0ull, 0ull, vmax, 0};
  const long long row = (long long)blockIdx.x * n_runs;
  const int32_t* v = values + row;
  const int32_t* l = lengths + row;
  long long head = 0;
  if (vec) {
    const long long n4 = n_runs / 4;
    const int4* v4 = reinterpret_cast<const int4*>(v);
    const int4* l4 = reinterpret_cast<const int4*>(l);
    for (long long i = threadIdx.x; i < n4; i += blockDim.x) {
      const int4 a = __ldcs(&v4[i]);
      const int4 b = __ldcs(&l4[i]);
      add_run(a.x, b.x, c, op, acc);
      add_run(a.y, b.y, c, op, acc);
      add_run(a.z, b.z, c, op, acc);
      add_run(a.w, b.w, c, op, acc);
    }
    head = n4 * 4;
  }
  for (long long i = head + threadIdx.x; i < n_runs; i += blockDim.x)
    add_run(v[i], l[i], c, op, acc);
  block_reduce(acc.sum, acc.count, acc.min, acc.max);
  if (threadIdx.x == 0)
    write_row(acc.sum, acc.count, acc.min, acc.max,
              out + 5 * (long long)blockIdx.x);
}

static int launch(const void* values, const void* lengths, void* out,
                  long long n_chunks, long long n_runs, int constant, int op,
                  int code_bits, void* stream) {
  if (n_chunks < 1 || n_chunks > 0x7fffffffLL || n_runs < 0 || op < kLt
      || op > kNe || code_bits < 2 || code_bits > 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const int32_t*>(values);
  const auto* l = static_cast<const int32_t*>(lengths);
  const bool vec = aligned16(values) && aligned16(lengths) && n_runs % 4 == 0;
  const int32_t vmax = (1 << (code_bits - 1)) - 1;
  rle_scan_aggregate_kernel<<<dim3((unsigned)n_chunks), kThreads, 0, s>>>(
      v, l, n_runs, constant, op, vmax, static_cast<int32_t*>(out), vec);
  return (int)cudaGetLastError();
}

// One chunk: (n_runs,) planes -> int32[1, 5].
extern "C" int rle_scan_aggregate_launch(const void* values,
                                         const void* lengths, void* out,
                                         long long n_runs, int constant,
                                         int op, int code_bits,
                                         void* stream) {
  return launch(values, lengths, out, 1, n_runs, constant, op, code_bits,
                stream);
}

// Every chunk in one launch: (n_chunks, n_runs) planes -> int32[n_chunks, 5].
extern "C" int rle_scan_aggregate_batched_launch(
    const void* values, const void* lengths, void* out, long long n_chunks,
    long long n_runs, int constant, int op, int code_bits, void* stream) {
  return launch(values, lengths, out, n_chunks, n_runs, constant, op,
                code_bits, stream);
}
