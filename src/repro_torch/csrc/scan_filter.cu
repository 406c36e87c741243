// BitWeaving-H predicate scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/scan_filter/kernel.py::scan_packed
// (body _scan_kernel): one packed delimiter-bit mask word out per packed
// code word in, with the predicate primitive (GE or EQ), the constant
// replicated into every field, and an optional complement (for the composed
// lt/le/ne) as runtime arguments.
//
// Bound: memory. Each word costs 4 bytes read and 4 written for about four
// integer operations, far below the card's operations-per-byte balance.
// Design: a grid-stride loop over 16-byte vectors (uint4, four words a
// thread per step, neighbouring threads on neighbouring addresses), so
// every load and store is a full 128-byte line per warp; the ragged tail
// (and any operand not 16-byte aligned) takes a scalar loop. No host-side
// padding, no shared memory, nothing carried between blocks.
#include "bitweave.cuh"

using namespace bitweave;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
            long long n, uint32_t c, bool is_eq, bool invert, bool vec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if (vec) {
    const long long n4 = n / 4;
    const uint4* in4 = reinterpret_cast<const uint4*>(in);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const uint4 x = __ldcs(&in4[i]);
      uint4 r;
      r.x = predicate<BITS>(x.x, c, is_eq, invert);
      r.y = predicate<BITS>(x.y, c, is_eq, invert);
      r.z = predicate<BITS>(x.z, c, is_eq, invert);
      r.w = predicate<BITS>(x.w, c, is_eq, invert);
      __stcs(&out4[i], r);
    }
    head = n4 * 4;
  }
  for (long long i = head + tid; i < n; i += stride)
    out[i] = predicate<BITS>(in[i], c, is_eq, invert);
}

extern "C" int scan_filter_launch(const void* words, void* out, long long n,
                                  int code_bits, int is_eq,
                                  unsigned int const_packed, int invert,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  const bool vec = aligned16(words) && aligned16(out);
  const int blocks = grid_blocks(vec ? (n + 3) / 4 : n);
  switch (code_bits) {
    case 2:
      scan_kernel<2><<<blocks, kThreads, 0, s>>>(in, o, n, const_packed,
                                                 is_eq, invert, vec);
      break;
    case 4:
      scan_kernel<4><<<blocks, kThreads, 0, s>>>(in, o, n, const_packed,
                                                 is_eq, invert, vec);
      break;
    case 8:
      scan_kernel<8><<<blocks, kThreads, 0, s>>>(in, o, n, const_packed,
                                                 is_eq, invert, vec);
      break;
    case 16:
      scan_kernel<16><<<blocks, kThreads, 0, s>>>(in, o, n, const_packed,
                                                  is_eq, invert, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
