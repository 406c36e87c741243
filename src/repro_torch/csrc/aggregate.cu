// Masked aggregate (sum, count, min, max) over packed codes for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/aggregate/kernel.py::aggregate_packed
// (body _agg_kernel): packed code words plus packed delimiter-bit mask words
// in, one int32[5] row [sum_lo, sum_hi, count, min, max] out, with
// sum = sum_hi * 65536 + sum_lo.
//
// Bound: memory. Each word costs 8 bytes read (code word + mask word) for a
// few integer operations per field. Design: the TPU kernel walks a
// sequential grid and carries its sums in VMEM from step to step; here
// blocks run in parallel in no order, so each thread streams a grid-stride
// share of the words in 16-byte vectors and keeps its own 64-bit sum and
// count (H100 has native int64, so the reference's 16/16 split is needed
// only at the output). Threads reduce by warp shuffles and shared memory,
// blocks by one integer atomic per field into a scratch buffer, exact in any
// order; the last block writes the row (bitweave.cuh: commit).
//
// Also replaces the TPU kernel
// repro/kernels/aggregate/kernel.py::aggregate_batched_packed (body
// _agg_batched_kernel): (n_chunks, n_words) words + masks in, one row per
// chunk out. Bound: memory, 8 bytes a word as above. Design: one block per
// chunk (a chunk holds at most 65536 rows, 32768 words), 16-byte loads when
// the row stride allows them; the block reduces and thread 0 writes the
// chunk's row itself (bitweave.cuh: commit_row), so nothing crosses blocks.
#include "bitweave.cuh"

using namespace bitweave;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ mask, long long n,
                 unsigned long long* scratch, int32_t* out, bool vec) {
  Acc acc = acc_identity<BITS>();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if (vec) {
    const long long n4 = n / 4;
    const uint4* w4 = reinterpret_cast<const uint4*>(words);
    const uint4* m4 = reinterpret_cast<const uint4*>(mask);
    for (long long i = tid; i < n4; i += stride) {
      const uint4 w = __ldcs(&w4[i]);
      const uint4 m = __ldcs(&m4[i]);
      accumulate<BITS>(w.x, m.x, acc);
      accumulate<BITS>(w.y, m.y, acc);
      accumulate<BITS>(w.z, m.z, acc);
      accumulate<BITS>(w.w, m.w, acc);
    }
    head = n4 * 4;
  }
  for (long long i = head + tid; i < n; i += stride)
    accumulate<BITS>(words[i], mask[i], acc);
  commit<BITS>(acc, scratch, out);
}

extern "C" int aggregate_launch(const void* words, const void* mask,
                                void* scratch, void* out, long long n,
                                int code_bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* m = static_cast<const uint32_t*>(mask);
  auto* sc = static_cast<unsigned long long*>(scratch);
  auto* o = static_cast<int32_t*>(out);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 5 * sizeof(*sc), s);
  if (err != cudaSuccess) return (int)err;
  const bool vec = aligned16(words) && aligned16(mask);
  const int blocks = grid_blocks(vec ? (n + 3) / 4 : n);
  switch (code_bits) {
    case 2:
      aggregate_kernel<2><<<blocks, kThreads, 0, s>>>(w, m, n, sc, o, vec);
      break;
    case 4:
      aggregate_kernel<4><<<blocks, kThreads, 0, s>>>(w, m, n, sc, o, vec);
      break;
    case 8:
      aggregate_kernel<8><<<blocks, kThreads, 0, s>>>(w, m, n, sc, o, vec);
      break;
    case 16:
      aggregate_kernel<16><<<blocks, kThreads, 0, s>>>(w, m, n, sc, o, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
aggregate_batched_kernel(const uint32_t* __restrict__ words,
                         const uint32_t* __restrict__ mask, long long n_words,
                         int32_t* out, bool vec) {
  Acc acc = acc_identity<BITS>();
  const long long row = (long long)blockIdx.x * n_words;
  const uint32_t* w = words + row;
  const uint32_t* m = mask + row;
  long long head = 0;
  if (vec) {
    const long long n4 = n_words / 4;
    const uint4* w4 = reinterpret_cast<const uint4*>(w);
    const uint4* m4 = reinterpret_cast<const uint4*>(m);
    for (long long i = threadIdx.x; i < n4; i += blockDim.x) {
      const uint4 a = __ldcs(&w4[i]);
      const uint4 b = __ldcs(&m4[i]);
      accumulate<BITS>(a.x, b.x, acc);
      accumulate<BITS>(a.y, b.y, acc);
      accumulate<BITS>(a.z, b.z, acc);
      accumulate<BITS>(a.w, b.w, acc);
    }
    head = n4 * 4;
  }
  for (long long i = head + threadIdx.x; i < n_words; i += blockDim.x)
    accumulate<BITS>(w[i], m[i], acc);
  commit_row<BITS>(acc, out + 5 * (long long)blockIdx.x);
}

extern "C" int aggregate_batched_launch(const void* words, const void* mask,
                                        void* out, long long n_chunks,
                                        long long n_words, int code_bits,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* m = static_cast<const uint32_t*>(mask);
  auto* o = static_cast<int32_t*>(out);
  if (n_chunks < 1 || n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // every row starts 16-byte aligned when the base is and n_words % 4 == 0
  const bool vec = aligned16(words) && aligned16(mask) && n_words % 4 == 0;
  const dim3 grid((unsigned)n_chunks);
  switch (code_bits) {
    case 2:
      aggregate_batched_kernel<2><<<grid, kThreads, 0, s>>>(w, m, n_words, o,
                                                            vec);
      break;
    case 4:
      aggregate_batched_kernel<4><<<grid, kThreads, 0, s>>>(w, m, n_words, o,
                                                            vec);
      break;
    case 8:
      aggregate_batched_kernel<8><<<grid, kThreads, 0, s>>>(w, m, n_words, o,
                                                            vec);
      break;
    case 16:
      aggregate_batched_kernel<16><<<grid, kThreads, 0, s>>>(w, m, n_words,
                                                             o, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
