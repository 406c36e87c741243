// Grouped aggregation (GROUP BY key: count(*), sum(value)) over int32 code
// planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/group_aggregate/kernel.py::group_sum_count_batched_planes
// (body _dense_batched_kernel): (n_chunks, rows, 128) int32 key, value and
// select planes plus sorted (G,) int32 group keys in, int32 (n_chunks, G, 3)
// planes of normalized [sum_lo, sum_hi, count] out. A row counts where
// sel > 0 and its key is one of the G keys; values are codes or FOR deltas
// below 2^16.
//
// Bound: memory. Each row costs 12 bytes read (key, value, select) for a
// slot lookup and two shared-memory adds. Design: the TPU kernel matches a
// block of group keys against each tile (a dense compare plane); here each
// block holds all G <= 1024 keys in shared memory and maps a key to its
// slot directly when the keys are contiguous (a GROUP BY's arange) and by
// binary search otherwise (a join's distinct build keys). Blocks split a
// chunk's rows (one chunk of 2^30 rows on a plain table, thousands of 65536-
// row chunks on the store), so the card fills either way. Each warp adds
// into its own 32-bit sub-histogram (sum, count) in shared memory, so
// contention stays inside a warp, and a warp sees at most 65536 rows, so
// the 32-bit sums stay exact. At the end the block folds its warps' sums in
// 64 bits; a chunk covered by one block writes its rows directly, otherwise
// blocks add into a 64-bit (n_chunks, G, 2) scratch with integer atomics
// (exact in any order) and a second small launch normalizes it.
//
// Also replaces the TPU kernel
// repro/kernels/group_aggregate/kernel.py::rle_group_accumulate_batched_planes
// (body _rle_batched_kernel): (n_chunks, n_runs) int32 run values and
// lengths plus the same keys in, the same planes out; run (v, n) with n > 0
// that passes an optional (ge | eq, const, invert) predicate on v adds n to
// group v's count and n * v to its sum. Bound: memory, 8 bytes a run; a
// sorted column has so few runs that a launch is bound by its latency and
// by writing its G output rows a chunk. Two routes, chosen by the caller
// (kernels/group_aggregate/kernel.py::route) from the chunk and run counts
// and G:
// - block: one 256-thread block per chunk, the same shared keys and warp
//   sub-histograms as the dense kernel, folded across the eight warps
//   after a __syncthreads. For long chunks, whose runs fill the block.
// - warp: one warp per chunk, eight chunks a block (a block of
//   32 * n_chunks threads below eight). Each warp zeroes, fills and writes
//   its own sub-histogram, synchronising with __syncwarp only, reads the
//   keys through the read-only data path (a contiguous domain needs only
//   the first and last key) and writes the chunk's 3G output words in
//   order. For short chunks, where a block would idle most of its threads
//   and zero and fold eight sub-histograms for a few runs.
// Both read the runs with 16-byte loads where the row stride allows them,
// then a scalar tail. Sums and counts are taken modulo 2^32 in unsigned
// arithmetic, as the reference's int32 sums wrap (signed overflow is
// undefined in C++), so the order of the adds does not change a bit, and
// the sum is split as the reference splits its int32: lo = s & 0xFFFF,
// hi = s >> 16 arithmetic.
#include <atomic>

#include "bitweave.cuh"

using namespace bitweave;

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 1024;
// rows a block covers at most: 2048 a thread, 65536 a warp, so a warp's
// 32-bit sum of values below 2^16 cannot wrap
constexpr long long kBlockRowsMax = (long long)kThreads * 2048;
constexpr long long kBlockRowsMin = 4096;  // below this, fewer blocks
constexpr int kGroupBlocksPerSM = 8;
// route codes of the RLE entry (kernel.py ROUTES is indexed by them)
enum Route { kBlock = 0, kWarp = 1 };

// The sorted group keys in shared memory and how to find a key's slot.
struct Groups {
  const int32_t* keys;
  int g;
  int32_t k0;
  bool contiguous;  // keys == k0 .. k0 + g - 1
};

// Dynamic shared memory: int32 keys[g], then uint32 sum[kWarps][g] and
// uint32 cnt[kWarps][g], the warps' sub-histograms, zeroed here.
__device__ __forceinline__ Groups setup(const int32_t* __restrict__ gkeys,
                                        int g, uint32_t*& sum,
                                        uint32_t*& cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* keys = reinterpret_cast<int32_t*>(smem);
  sum = reinterpret_cast<uint32_t*>(keys + g);
  cnt = sum + kWarps * g;
  for (int i = threadIdx.x; i < g; i += blockDim.x) keys[i] = gkeys[i];
  for (int i = threadIdx.x; i < 2 * kWarps * g; i += blockDim.x) sum[i] = 0u;
  __syncthreads();
  // sorted keys span g - 1 exactly when they are distinct and contiguous
  const bool contiguous = (long long)keys[g - 1] - keys[0] == g - 1;
  return Groups{keys, g, keys[0], contiguous};
}

// Key i of the sorted keys: from shared memory, or with kLdg from device
// memory through the read-only data path.
template <bool kLdg>
__device__ __forceinline__ int32_t key_at(const Groups& gr, int i) {
  if constexpr (kLdg) return __ldg(gr.keys + i);
  else return gr.keys[i];
}

// Slot of key k (the index of the first key >= k, as searchsorted), or -1
// when k is no key.
template <bool kLdg = false>
__device__ __forceinline__ int slot_of(int32_t k, const Groups& gr) {
  if (gr.contiguous) {
    const uint32_t d = (uint32_t)k - (uint32_t)gr.k0;
    return d < (uint32_t)gr.g ? (int)d : -1;
  }
  int lo = 0, hi = gr.g;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_at<kLdg>(gr, mid) < k) lo = mid + 1; else hi = mid;
  }
  return (lo < gr.g && key_at<kLdg>(gr, lo) == k) ? lo : -1;
}

__device__ __forceinline__ void add_row(int32_t k, int32_t v, int32_t s,
                                        const Groups& gr, uint32_t* wsum,
                                        uint32_t* wcnt) {
  if (s <= 0) return;
  const int j = slot_of(k, gr);
  if (j < 0) return;
  atomicAdd(&wsum[j], (uint32_t)v);
  atomicAdd(&wcnt[j], 1u);
}

// The reference's normalized row of an exact 64-bit sum and count.
__device__ __forceinline__ void write_group(unsigned long long s,
                                            unsigned long long c,
                                            int32_t* o) {
  o[0] = (int32_t)(s & 0xFFFFull);
  o[1] = (int32_t)(s >> 16);
  o[2] = (int32_t)c;
}

struct RunPred {
  bool on;
  bool eq;      // primitive: v == c, else v >= c
  int32_t c;
  bool invert;
};

template <bool kLdg>
__device__ __forceinline__ void add_run(int32_t v, int32_t n,
                                        const RunPred& p, const Groups& gr,
                                        uint32_t* wsum, uint32_t* wcnt) {
  if (n <= 0) return;
  if (p.on && ((p.eq ? v == p.c : v >= p.c) == p.invert)) return;
  const int j = slot_of<kLdg>(v, gr);
  if (j < 0) return;
  atomicAdd(&wsum[j], (uint32_t)n * (uint32_t)v);
  atomicAdd(&wcnt[j], (uint32_t)n);
}

// Add runs first, first + stride, ... of one chunk's (n_runs,) planes into
// one sub-histogram: with `vec`, the 16-byte body by int4 (thread t takes
// int4s t, t + stride, ...) and then the scalar tail past it; without, all
// scalar.
template <bool kLdg>
__device__ __forceinline__ void add_runs(const int32_t* v, const int32_t* l,
                                         long long n_runs, int first,
                                         int stride, bool vec,
                                         const RunPred& p, const Groups& gr,
                                         uint32_t* wsum, uint32_t* wcnt) {
  long long head = 0;
  if (vec) {
    const long long n4 = n_runs / 4;
    const int4* v4 = reinterpret_cast<const int4*>(v);
    const int4* l4 = reinterpret_cast<const int4*>(l);
    for (long long i = first; i < n4; i += stride) {
      const int4 a = __ldcs(&v4[i]);
      const int4 b = __ldcs(&l4[i]);
      add_run<kLdg>(a.x, b.x, p, gr, wsum, wcnt);
      add_run<kLdg>(a.y, b.y, p, gr, wsum, wcnt);
      add_run<kLdg>(a.z, b.z, p, gr, wsum, wcnt);
      add_run<kLdg>(a.w, b.w, p, gr, wsum, wcnt);
    }
    head = n4 * 4;
  }
  for (long long i = head + first; i < n_runs; i += stride)
    add_run<kLdg>(v[i], l[i], p, gr, wsum, wcnt);
}

// Raise a kernel's dynamic shared memory limit to `most` bytes (what
// kMaxGroups needs) once per device and process; a launch of at most 48
// KiB needs nothing. `done` holds a bit per device already raised.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t most,
                       std::atomic<unsigned long long>& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)most);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

std::atomic<unsigned long long> dense_smem_raised{0};
std::atomic<unsigned long long> block_smem_raised{0};
std::atomic<unsigned long long> warp_smem_raised{0};

}  // namespace

// One block covers rows [part * span, part * span + span) of one chunk;
// blockIdx.x = chunk * blocks_per_chunk + part.
__global__ void __launch_bounds__(kThreads)
group_sum_count_kernel(const int32_t* __restrict__ keys,
                       const int32_t* __restrict__ vals,
                       const int32_t* __restrict__ sel,
                       const int32_t* __restrict__ gkeys, int g,
                       long long per_chunk, long long blocks_per_chunk,
                       long long span, unsigned long long* scratch,
                       int32_t* out, bool vec) {
  uint32_t* sum;
  uint32_t* cnt;
  const Groups gr = setup(gkeys, g, sum, cnt);
  const long long chunk = blockIdx.x / blocks_per_chunk;
  const long long part = blockIdx.x % blocks_per_chunk;
  const long long lo = part * span;
  const long long hi = lo + span < per_chunk ? lo + span : per_chunk;
  const long long row = chunk * per_chunk;
  uint32_t* wsum = sum + (threadIdx.x / 32) * g;
  uint32_t* wcnt = cnt + (threadIdx.x / 32) * g;
  if (vec) {  // lo, hi and row are multiples of 4
    const int4* k4 = reinterpret_cast<const int4*>(keys + row);
    const int4* v4 = reinterpret_cast<const int4*>(vals + row);
    const int4* s4 = reinterpret_cast<const int4*>(sel + row);
    for (long long i = lo / 4 + threadIdx.x; i < hi / 4; i += blockDim.x) {
      const int4 a = __ldcs(&k4[i]);
      const int4 b = __ldcs(&v4[i]);
      const int4 c = __ldcs(&s4[i]);
      add_row(a.x, b.x, c.x, gr, wsum, wcnt);
      add_row(a.y, b.y, c.y, gr, wsum, wcnt);
      add_row(a.z, b.z, c.z, gr, wsum, wcnt);
      add_row(a.w, b.w, c.w, gr, wsum, wcnt);
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
      add_row(keys[row + i], vals[row + i], sel[row + i], gr, wsum, wcnt);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < g; j += blockDim.x) {
    unsigned long long s = 0ull, c = 0ull;
    for (int w = 0; w < kWarps; ++w) {
      s += sum[w * g + j];
      c += cnt[w * g + j];
    }
    const long long at = chunk * g + j;
    if (blocks_per_chunk == 1) {
      write_group(s, c, out + 3 * at);
    } else if (c) {
      atomicAdd(&scratch[2 * at], s);
      atomicAdd(&scratch[2 * at + 1], c);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
group_finalize_kernel(const unsigned long long* __restrict__ scratch,
                      long long n, int32_t* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    write_group(scratch[2 * i], scratch[2 * i + 1], out + 3 * i);
}

// One block per chunk over its (n_runs,) slice of the run planes.
__global__ void __launch_bounds__(kThreads)
rle_group_accumulate_kernel(const int32_t* __restrict__ values,
                            const int32_t* __restrict__ lengths,
                            const int32_t* __restrict__ gkeys, int g,
                            long long n_runs, RunPred p, int32_t* out,
                            bool vec) {
  uint32_t* sum;
  uint32_t* cnt;
  const Groups gr = setup(gkeys, g, sum, cnt);
  const long long row = (long long)blockIdx.x * n_runs;
  const int32_t* v = values + row;
  const int32_t* l = lengths + row;
  uint32_t* wsum = sum + (threadIdx.x / 32) * g;
  uint32_t* wcnt = cnt + (threadIdx.x / 32) * g;
  add_runs<false>(v, l, n_runs, threadIdx.x, blockDim.x, vec, p, gr, wsum,
                  wcnt);
  __syncthreads();
  for (int j = threadIdx.x; j < g; j += blockDim.x) {
    uint32_t s = 0u, c = 0u;  // modulo 2^32, as the reference's int32
    for (int w = 0; w < kWarps; ++w) {
      s += sum[w * g + j];
      c += cnt[w * g + j];
    }
    int32_t* o = out + 3 * ((long long)blockIdx.x * g + j);
    o[0] = (int32_t)(s & 0xFFFFu);
    o[1] = (int32_t)((s >> 16) | ((s & 0x80000000u) ? 0xFFFF0000u : 0u));
    o[2] = (int32_t)c;
  }
}

// The warp route: warp w of the block takes chunk blockIdx.x * kWarps + w,
// its runs i, i + 32, ... in lane i % 32, and its own uint32 [sum[g],
// cnt[g]] slice of dynamic shared memory.
__global__ void __launch_bounds__(kThreads)
rle_group_accumulate_warp_kernel(const int32_t* __restrict__ values,
                                 const int32_t* __restrict__ lengths,
                                 const int32_t* __restrict__ gkeys, int g,
                                 long long n_chunks, long long n_runs,
                                 RunPred p, int32_t* out, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  // a warp-uniform chunk: a warp past the last returns whole
  const long long chunk =
      (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (chunk >= n_chunks) return;
  const int lane = threadIdx.x % 32;
  uint32_t* sum =
      reinterpret_cast<uint32_t*>(smem) + (threadIdx.x / 32) * 2 * g;
  uint32_t* cnt = sum + g;
  for (int i = lane; i < 2 * g; i += 32) sum[i] = 0u;
  const int32_t k0 = __ldg(gkeys);
  // sorted keys span g - 1 exactly when they are distinct and contiguous
  const Groups gr{gkeys, g, k0,
                  (long long)__ldg(gkeys + g - 1) - k0 == g - 1};
  __syncwarp();
  const long long row = chunk * n_runs;
  add_runs<true>(values + row, lengths + row, n_runs, lane, 32, vec, p, gr,
                 sum, cnt);
  __syncwarp();
  // the chunk's rows [lo, hi, count] as 3g consecutive words
  int32_t* o = out + 3 * chunk * g;
  for (int i = lane; i < 3 * g; i += 32) {
    const int j = i / 3;
    const uint32_t s = sum[j];
    switch (i - 3 * j) {
      case 0: o[i] = (int32_t)(s & 0xFFFFu); break;
      case 1:
        o[i] = (int32_t)((s >> 16) | ((s & 0x80000000u) ? 0xFFFF0000u : 0u));
        break;
      default: o[i] = (int32_t)cnt[j];
    }
  }
}

static size_t smem_bytes(int g) { return (size_t)g * 4 * (1 + 2 * kWarps); }
static size_t warp_smem_bytes(int warps, int g) {
  return (size_t)warps * 2 * g * 4;
}

// (n_chunks, per_chunk) key/value/select planes -> int32[n_chunks, g, 3].
// scratch: int64[n_chunks, g, 2], used (and zeroed here) only when a chunk
// spans several blocks.
extern "C" int group_sum_count_launch(const void* keys, const void* vals,
                                      const void* sel, const void* gkeys,
                                      void* scratch, void* out,
                                      long long n_chunks, long long per_chunk,
                                      int g, void* stream) {
  if (n_chunks < 1 || per_chunk < 1 || per_chunk % 4 || g < 1
      || g > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (per_chunk + kBlockRowsMax - 1) / kBlockRowsMax;
  const long long most = (per_chunk + kBlockRowsMin - 1) / kBlockRowsMin;
  const long long fill =
      ((long long)sms * kGroupBlocksPerSM + n_chunks - 1) / n_chunks;
  long long bpc = fill < most ? fill : most;
  bpc = bpc > need ? bpc : need;
  long long span = (per_chunk + bpc - 1) / bpc;
  span = (span + 3) / 4 * 4;
  bpc = (per_chunk + span - 1) / span;
  if (bpc * n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(g);
  cudaError_t err = allow_smem(group_sum_count_kernel, bytes,
                               smem_bytes(kMaxGroups), dense_smem_raised);
  if (err != cudaSuccess) return (int)err;
  auto* sc = static_cast<unsigned long long*>(scratch);
  auto* o = static_cast<int32_t*>(out);
  if (bpc > 1) {
    err = cudaMemsetAsync(scratch, 0, (size_t)n_chunks * g * 2 * sizeof(*sc),
                          s);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = aligned16(keys) && aligned16(vals) && aligned16(sel);
  group_sum_count_kernel<<<(unsigned)(bpc * n_chunks), kThreads, bytes, s>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals),
      static_cast<const int32_t*>(sel), static_cast<const int32_t*>(gkeys), g,
      per_chunk, bpc, span, sc, o, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || bpc == 1) return (int)err;
  group_finalize_kernel<<<grid_blocks(n_chunks * g), kThreads, 0, s>>>(
      sc, n_chunks * g, o);
  return (int)cudaGetLastError();
}

// (n_chunks, n_runs) run planes -> int32[n_chunks, g, 3]. has_pred = 0
// counts every run of length > 0; prim 0 is ge, 1 is eq; route is kBlock
// or kWarp.
extern "C" int rle_group_accumulate_launch(const void* values,
                                           const void* lengths,
                                           const void* gkeys, void* out,
                                           long long n_chunks,
                                           long long n_runs, int g,
                                           int has_pred, int prim,
                                           int constant, int invert,
                                           int route, void* stream) {
  if (n_chunks < 1 || n_chunks > 0x7fffffffLL || n_runs < 1 || g < 1
      || g > kMaxGroups || prim < 0 || prim > 1
      || (route != kBlock && route != kWarp))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const int32_t*>(values);
  const auto* l = static_cast<const int32_t*>(lengths);
  const auto* k = static_cast<const int32_t*>(gkeys);
  auto* o = static_cast<int32_t*>(out);
  const bool vec = aligned16(values) && aligned16(lengths) && n_runs % 4 == 0;
  const RunPred p{has_pred != 0, prim == 1, constant, invert != 0};
  cudaError_t err;
  if (route == kWarp) {
    const int warps = n_chunks < kWarps ? (int)n_chunks : kWarps;
    const size_t bytes = warp_smem_bytes(warps, g);
    err = allow_smem(rle_group_accumulate_warp_kernel, bytes,
                     warp_smem_bytes(kWarps, kMaxGroups), warp_smem_raised);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (n_chunks + kWarps - 1) / kWarps;
    rle_group_accumulate_warp_kernel<<<(unsigned)blocks, 32 * warps, bytes,
                                       s>>>(v, l, k, g, n_chunks, n_runs, p,
                                            o, vec);
  } else {
    const size_t bytes = smem_bytes(g);
    err = allow_smem(rle_group_accumulate_kernel, bytes,
                     smem_bytes(kMaxGroups), block_smem_raised);
    if (err != cudaSuccess) return (int)err;
    rle_group_accumulate_kernel<<<(unsigned)n_chunks, kThreads, bytes, s>>>(
        v, l, k, g, n_runs, p, o, vec);
  }
  return (int)cudaGetLastError();
}
