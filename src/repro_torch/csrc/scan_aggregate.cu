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
