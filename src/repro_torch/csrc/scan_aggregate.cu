// Fused BitWeaving scan + masked aggregate for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/scan_aggregate/kernel.py::scan_aggregate_packed (body
// _fused_kernel): the predicate column is compared against the constant
// (GE or EQ primitive, optional complement), ANDed with the validity mask,
// and the aggregate column is reduced under that mask in the same pass, so
// the mask never leaves registers. Output: one int32[5] row
// [sum_lo, sum_hi, count, min, max].
//
// Bound: memory. Each word costs 12 bytes read (predicate, aggregate and
// validity words) and nothing written but the row, against 16 bytes and a
// mask round trip for the scan -> aggregate pair. Design as aggregate.cu:
// grid-stride 16-byte loads, per-thread 64-bit accumulators, warp-shuffle
// and shared-memory block reduction, one integer atomic per field and
// block, the last block writes the row (bitweave.cuh: commit).
//
// Also replaces the TPU kernel
// repro/kernels/scan_aggregate/kernel.py::scan_aggregate_batched_packed
// (body _fused_batched_kernel): (n_chunks, n_words) predicate, aggregate
// and validity planes plus each chunk's packed constant and flags (bit0 eq,
// bit1 invert) as int32[n_chunks] arrays, one row per chunk out. The TPU
// kernel scalar-prefetches the per-chunk constant; here the chunk's block
// loads its own. Bound: memory, 12 bytes a word. Design: one block per
// chunk, as aggregate.cu's batched kernel.
#include "bitweave.cuh"

using namespace bitweave;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
scan_aggregate_kernel(const uint32_t* __restrict__ pred,
                      const uint32_t* __restrict__ agg,
                      const uint32_t* __restrict__ valid, long long n,
                      uint32_t c, bool is_eq, bool invert,
                      unsigned long long* scratch, int32_t* out, bool vec) {
  Acc acc = acc_identity<BITS>();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if (vec) {
    const long long n4 = n / 4;
    const uint4* p4 = reinterpret_cast<const uint4*>(pred);
    const uint4* a4 = reinterpret_cast<const uint4*>(agg);
    const uint4* v4 = reinterpret_cast<const uint4*>(valid);
    for (long long i = tid; i < n4; i += stride) {
      const uint4 p = __ldcs(&p4[i]);
      const uint4 a = __ldcs(&a4[i]);
      const uint4 v = __ldcs(&v4[i]);
      accumulate<BITS>(a.x, predicate<BITS>(p.x, c, is_eq, invert) & v.x,
                       acc);
      accumulate<BITS>(a.y, predicate<BITS>(p.y, c, is_eq, invert) & v.y,
                       acc);
      accumulate<BITS>(a.z, predicate<BITS>(p.z, c, is_eq, invert) & v.z,
                       acc);
      accumulate<BITS>(a.w, predicate<BITS>(p.w, c, is_eq, invert) & v.w,
                       acc);
    }
    head = n4 * 4;
  }
  for (long long i = head + tid; i < n; i += stride)
    accumulate<BITS>(agg[i], predicate<BITS>(pred[i], c, is_eq, invert)
                     & valid[i], acc);
  commit<BITS>(acc, scratch, out);
}

extern "C" int scan_aggregate_launch(const void* pred, const void* agg,
                                     const void* valid, void* scratch,
                                     void* out, long long n, int code_bits,
                                     int is_eq, unsigned int const_packed,
                                     int invert, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(pred);
  const auto* a = static_cast<const uint32_t*>(agg);
  const auto* v = static_cast<const uint32_t*>(valid);
  auto* sc = static_cast<unsigned long long*>(scratch);
  auto* o = static_cast<int32_t*>(out);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 5 * sizeof(*sc), s);
  if (err != cudaSuccess) return (int)err;
  const bool vec = aligned16(pred) && aligned16(agg) && aligned16(valid);
  const int blocks = grid_blocks(vec ? (n + 3) / 4 : n);
  switch (code_bits) {
    case 2:
      scan_aggregate_kernel<2><<<blocks, kThreads, 0, s>>>(
          p, a, v, n, const_packed, is_eq, invert, sc, o, vec);
      break;
    case 4:
      scan_aggregate_kernel<4><<<blocks, kThreads, 0, s>>>(
          p, a, v, n, const_packed, is_eq, invert, sc, o, vec);
      break;
    case 8:
      scan_aggregate_kernel<8><<<blocks, kThreads, 0, s>>>(
          p, a, v, n, const_packed, is_eq, invert, sc, o, vec);
      break;
    case 16:
      scan_aggregate_kernel<16><<<blocks, kThreads, 0, s>>>(
          p, a, v, n, const_packed, is_eq, invert, sc, o, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
scan_aggregate_batched_kernel(const int32_t* __restrict__ consts,
                              const int32_t* __restrict__ flags,
                              const uint32_t* __restrict__ pred,
                              const uint32_t* __restrict__ agg,
                              const uint32_t* __restrict__ valid,
                              long long n_words, int32_t* out, bool vec) {
  Acc acc = acc_identity<BITS>();
  const uint32_t c = (uint32_t)consts[blockIdx.x];
  const int f = flags[blockIdx.x];
  const bool is_eq = f & 1, invert = f & 2;
  const long long row = (long long)blockIdx.x * n_words;
  const uint32_t* p = pred + row;
  const uint32_t* a = agg + row;
  const uint32_t* v = valid + row;
  long long head = 0;
  if (vec) {
    const long long n4 = n_words / 4;
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* v4 = reinterpret_cast<const uint4*>(v);
    for (long long i = threadIdx.x; i < n4; i += blockDim.x) {
      const uint4 x = __ldcs(&p4[i]);
      const uint4 y = __ldcs(&a4[i]);
      const uint4 z = __ldcs(&v4[i]);
      accumulate<BITS>(y.x, predicate<BITS>(x.x, c, is_eq, invert) & z.x,
                       acc);
      accumulate<BITS>(y.y, predicate<BITS>(x.y, c, is_eq, invert) & z.y,
                       acc);
      accumulate<BITS>(y.z, predicate<BITS>(x.z, c, is_eq, invert) & z.z,
                       acc);
      accumulate<BITS>(y.w, predicate<BITS>(x.w, c, is_eq, invert) & z.w,
                       acc);
    }
    head = n4 * 4;
  }
  for (long long i = head + threadIdx.x; i < n_words; i += blockDim.x)
    accumulate<BITS>(a[i], predicate<BITS>(p[i], c, is_eq, invert) & v[i],
                     acc);
  commit_row<BITS>(acc, out + 5 * (long long)blockIdx.x);
}

extern "C" int scan_aggregate_batched_launch(
    const void* consts, const void* flags, const void* pred, const void* agg,
    const void* valid, void* out, long long n_chunks, long long n_words,
    int code_bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* cs = static_cast<const int32_t*>(consts);
  const auto* fl = static_cast<const int32_t*>(flags);
  const auto* p = static_cast<const uint32_t*>(pred);
  const auto* a = static_cast<const uint32_t*>(agg);
  const auto* v = static_cast<const uint32_t*>(valid);
  auto* o = static_cast<int32_t*>(out);
  if (n_chunks < 1 || n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(pred) && aligned16(agg) && aligned16(valid)
                   && n_words % 4 == 0;
  const dim3 grid((unsigned)n_chunks);
  switch (code_bits) {
    case 2:
      scan_aggregate_batched_kernel<2><<<grid, kThreads, 0, s>>>(
          cs, fl, p, a, v, n_words, o, vec);
      break;
    case 4:
      scan_aggregate_batched_kernel<4><<<grid, kThreads, 0, s>>>(
          cs, fl, p, a, v, n_words, o, vec);
      break;
    case 8:
      scan_aggregate_batched_kernel<8><<<grid, kThreads, 0, s>>>(
          cs, fl, p, a, v, n_words, o, vec);
      break;
    case 16:
      scan_aggregate_batched_kernel<16><<<grid, kThreads, 0, s>>>(
          cs, fl, p, a, v, n_words, o, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
