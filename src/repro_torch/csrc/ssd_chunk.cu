// Mamba-2 SSD chunk scan (state-space duality, arXiv:2405.21060 §6) for
// Hopper (sm_90a), fp32 or bf16 inputs, every product in fp32.
//
// Replaces the TPU kernel repro/kernels/ssd_chunk/kernel.py::ssd_scan
// (body _ssd_kernel). For one (batch, head) row, chunk after chunk from
// the state h = h_in (zeros when absent):
//   cum   = running sum of la = dt * A inside the chunk, A = -exp(a_log)
//   y_i   = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
//           + exp(cum_i) (C_i . h)
//   h    <- exp(cum_Q) h + sum_j exp(cum_Q - cum_j) dt_j B_j^T x_j
// and h_out is the last h. Unlike the Pallas kernel this takes the model's
// layout as it is: x (B, S, H, P) and y in x's dtype, dt (B, S, H) fp32,
// a_log (H,) fp32, b / c (B, S, N) shared by every head (the reference's
// adapter broadcasts them to each head, 64x their bytes at mamba2-1.3b's
// widths), an optional h_in and h_out (B, H, N, P) fp32; it forms la
// itself.
//
// Bound: at the path's shape (one 4096-token row, H 64, P 64, N 128,
// Q 256) the function reads and writes ~73 MB and does ~13 GFLOP on the
// causal pairs (C . B^T once a chunk, the decayed products with x and the
// two state products a head and chunk): operations, on the CUDA cores in
// fp32 (67 TFLOP/s), ~0.19 ms.
//
// Design. The Pallas kernel walks the chunks in order, the state in VMEM.
// Here the only sequential part, the state recurrence, is split out, so
// every chunk of every head runs in parallel (B * NC * H blocks, 1024 at
// the path's shape) in four launches on one stream:
//  1. ssd_cb_kernel: C_i . B_j once a chunk for every head (64 x 64 tiles
//     of the lower triangle) into a (B, NC, Q, Q) scratch that stays in L2.
//  2. ssd_state_kernel, a block per (chunk, head, 64 columns of P): the
//     chunk's own state sum_j B_j^T (exp(cum_Q - cum_j) dt_j x_j), an
//     (N, P) product, into a (B, NC, H, N, P) fp32 scratch, and cum_Q.
//  3. ssd_pass_kernel, a thread per (batch, head, state element): walks
//     the chunks in order, h <- exp(cum_Q) h + S_k, and overwrites each
//     chunk's S_k with the state entering it; the last h is h_out.
//  4. ssd_scan_kernel, a block per (chunk, head, 64 columns of P):
//     y = exp(cum_i) (C . h_in(chunk)) + W . x, W_ij = exp(cum_i - cum_j)
//     CB_ij dt_j for j <= i and 0 above the diagonal (so exp never sees a
//     masked argument and no inf * 0 arises), formed tile by tile in
//     shared memory from the CB scratch.
// Products 2 and 4 are register-tiled on the CUDA cores (8 x 4 and 8 x 8
// outputs a thread, k-major tiles in shared memory read as float4); a warp
// skips the key tiles wholly above its rows. Blocks 2 and 4 each form the
// chunk's cum with the same warp scan (8 steps a lane, then the lanes),
// so both see the same exponents. A ragged chunk (Q not a multiple of 32,
// as a 100-token prompt's one chunk) and P or N short of a tile are masked
// at the edge. Tensor cores (TF32 or bf16 products) and a fused pipeline
// are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "error.cuh"

namespace {

constexpr int kQMax = 256;         // the longest chunk
constexpr int kNMax = 128;         // the largest state size
constexpr int kPT = 64;            // columns of P a block of 2 or 4 owns
constexpr int kKT = 32;            // the k (step or state) depth of a tile
constexpr int kThreads = 256;
constexpr int kCbT = 64;           // CB tile
constexpr int kCbLD = kNMax + 1;   // CB staging row stride (floats)
constexpr int kLDA = kQMax + 4;    // k-major A tile row stride (floats)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// cum[j] = sum_{t<=j} dt[t] * a_neg and dts[j] = dt[t] for the chunk's q
// steps of head hh (dt rows at stride h_len from row0); warp 0 works,
// every thread must call it. Each lane sums 8 consecutive steps, a warp
// scan adds the lanes before it.
__device__ __forceinline__ void chunk_cum(const float* __restrict__ dt,
                                          size_t row0, int h_len, int hh,
                                          float a_neg, int q, float* cum,
                                          float* dts) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    float part[8], run = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = tid * 8 + e;
      const float d = j < q ? dt[(row0 + j) * h_len + hh] : 0.f;
      if (j < q) dts[j] = d;
      run += d * a_neg;
      part[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += t;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = tid * 8 + e;
      if (j < q) cum[j] = excl + part[e];
    }
  }
  __syncthreads();
}

// ---- 1. C . B^T once a chunk ---------------------------------------------

// rows [row0, row0 + kCbT) of a chunk's (Q, N) plane -> fp32 shared memory
// at row stride kCbLD; rows at or past q are zeros
template <typename T>
__device__ __forceinline__ void stage_cb(const T* __restrict__ src, int row0,
                                         int q, int n, float* dst) {
  for (int e = threadIdx.x; e < kCbT * n; e += kThreads) {
    const int r = e / n, k = e - r * n;
    dst[r * kCbLD + k] =
        row0 + r < q ? to_f(src[(size_t)(row0 + r) * n + k]) : 0.f;
  }
}

// grid (B * NC, ceil(Q / 64), ceil(Q / 64)), upper tiles return at once;
// each thread owns rows ty + 16 a and columns tx + 16 b of the tile
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_cb_kernel(const T* __restrict__ b, const T* __restrict__ c,
                  float* __restrict__ cb, int s, int n, int q) {
  const int it = blockIdx.y, jt = blockIdx.z;
  if (jt > it) return;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                      // kCbT x kCbLD
  float* bs = smem + kCbT * kCbLD;
  const long long bc = blockIdx.x;       // bi * NC + ci
  const int nc = s / q;
  const size_t row = (size_t)(bc / nc) * s + (size_t)(bc % nc) * q;
  stage_cb<T>(c + row * n, it * kCbT, q, n, cs);
  stage_cb<T>(b + row * n, jt * kCbT, q, n, bs);
  __syncthreads();
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4] = {};
  for (int k = 0; k < n; ++k) {
    float cv[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * kCbLD + k];
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = bs[(tx + 16 * e) * kCbLD + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(cv[a], bv[e], acc[a][e]);
  }
  float* out = cb + (size_t)bc * q * q;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = it * kCbT + ty + 16 * a;
    if (i >= q) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = jt * kCbT + tx + 16 * e;
      if (j < q) out[(size_t)i * q + j] = acc[a][e];
    }
  }
}

// ---- 2. each chunk's own state -------------------------------------------

// shared memory of ssd_state_kernel, in floats
constexpr int kStBs = 3 * kQMax;                 // cum, dts, d2e
constexpr int kStXs = kStBs + kKT * kNMax;       // B tile, k-major
constexpr int kStFloats = kStXs + kKT * kPT;     // weighted x tile

// grid (B * NC, H, ceil(P / 64)); thread t owns state rows 8 (t / 16) ..
// + 7 and columns 4 (t % 16) .. + 3 of the block's 64
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const T* __restrict__ bmat, float* __restrict__ states,
                     float* __restrict__ total, int h_len, int s, int p,
                     int n, int q) {
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;
  float* dts = smem + kQMax;
  float* d2e = smem + 2 * kQMax;     // exp(cum_last - cum_j) dt_j
  float* bs = smem + kStBs;          // kKT x kNMax
  float* xs = smem + kStXs;          // kKT x kPT
  const int bc = blockIdx.x, hh = blockIdx.y, p0 = blockIdx.z * kPT;
  const int nc = s / q;
  const size_t row0 = (size_t)(bc / nc) * s + (size_t)(bc % nc) * q;
  const int tid = threadIdx.x;
  chunk_cum(dt, row0, h_len, hh, -expf(a_log[hh]), q, cum, dts);
  const float clast = cum[q - 1];
  for (int j = tid; j < q; j += kThreads)
    d2e[j] = expf(clast - cum[j]) * dts[j];
  if (tid == 0 && blockIdx.z == 0) total[(size_t)bc * h_len + hh] = clast;

  const int tn = (tid >> 4) * 8, tp = (tid & 15) * 4;
  float acc[8][4] = {};
  for (int j0 = 0; j0 < q; j0 += kKT) {
    __syncthreads();                 // d2e written; the last tiles read
    for (int e = tid; e < kKT * n; e += kThreads) {
      const int jj = e / n, k = e - jj * n;
      bs[jj * kNMax + k] =
          j0 + jj < q ? to_f(bmat[(row0 + j0 + jj) * n + k]) : 0.f;
    }
    for (int e = tid; e < kKT * kPT; e += kThreads) {
      const int jj = e / kPT, col = e - jj * kPT;
      const int j = j0 + jj;
      xs[e] = j < q && p0 + col < p
                  ? to_f(x[((row0 + j) * h_len + hh) * p + p0 + col]) *
                        d2e[j]
                  : 0.f;
    }
    __syncthreads();
    const int jn = min(kKT, q - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(bs + jj * kNMax + tn);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + jj * kNMax + tn + 4);
      const float4 xv = *reinterpret_cast<const float4*>(xs + jj * kPT + tp);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc[r][0] = fmaf(bv[r], xv.x, acc[r][0]);
        acc[r][1] = fmaf(bv[r], xv.y, acc[r][1]);
        acc[r][2] = fmaf(bv[r], xv.z, acc[r][2]);
        acc[r][3] = fmaf(bv[r], xv.w, acc[r][3]);
      }
    }
  }
  float* out = states + ((size_t)bc * h_len + hh) * n * p;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (tn + r >= n) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p0 + tp + e < p) out[(size_t)(tn + r) * p + p0 + tp + e] = acc[r][e];
  }
}

// ---- 3. the state recurrence over the chunks -----------------------------

// grid (B * H, ceil(N * P / 256)); one thread a state element. The chunk
// sums are read kPassBatch at a time, so their loads are in flight
// together instead of one after each store.
constexpr int kPassBatch = 8;

__global__ void __launch_bounds__(kThreads)
    ssd_pass_kernel(float* __restrict__ states,
                    const float* __restrict__ total,
                    const float* __restrict__ h_in, float* __restrict__ h_out,
                    int h_len, int nc, int np) {
  const int bh = blockIdx.x;
  const int bi = bh / h_len, hh = bh - bi * h_len;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= np) return;
  float hv = h_in ? h_in[(size_t)bh * np + e] : 0.f;
  // chunk c's sums of this (batch, head) at base + c * stride
  float* base = states + (size_t)(bi * nc) * h_len * np + (size_t)hh * np + e;
  const size_t stride = (size_t)h_len * np;
  const float* tot = total + (size_t)(bi * nc) * h_len + hh;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float sk[kPassBatch], dec[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      const bool in = c0 + u < nc;
      sk[u] = in ? base[(c0 + u) * stride] : 0.f;
      dec[u] = in ? expf(tot[(size_t)(c0 + u) * h_len]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c0 + u >= nc) break;
      base[(c0 + u) * stride] = hv;  // the state entering chunk c0 + u
      hv = fmaf(dec[u], hv, sk[u]);
    }
  }
  h_out[(size_t)bh * np + e] = hv;
}

// ---- 4. the output of each chunk -----------------------------------------

// shared memory of ssd_scan_kernel, in floats
constexpr int kScA = 3 * kQMax;                  // cum, dts, ecum
constexpr int kScB = kScA + kKT * kLDA;          // A tile (C^T or W^T)
constexpr int kScFloats = kScB + kKT * kPT;      // B tile (h or x)

// grid (B * NC, H, ceil(P / 64)); thread t owns rows 8 (t / 8) .. + 7 of
// the chunk and columns 8 (t % 8) .. + 7 of the block's 64, so warp w owns
// rows 32 w .. 32 w + 31
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_log,
                    const T* __restrict__ cmat, const float* __restrict__ cb,
                    const float* __restrict__ states, T* __restrict__ y,
                    int h_len, int s, int p, int n, int q) {
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;
  float* dts = smem + kQMax;
  float* ecum = smem + 2 * kQMax;    // exp(cum_i)
  float* as = smem + kScA;           // kKT x kLDA, k-major
  float* bs = smem + kScB;           // kKT x kPT
  const int bc = blockIdx.x, hh = blockIdx.y, p0 = blockIdx.z * kPT;
  const int nc = s / q;
  const size_t row0 = (size_t)(bc / nc) * s + (size_t)(bc % nc) * q;
  const int tid = threadIdx.x;
  chunk_cum(dt, row0, h_len, hh, -expf(a_log[hh]), q, cum, dts);
  for (int i = tid; i < q; i += kThreads) ecum[i] = expf(cum[i]);

  const int ti = (tid >> 3) * 8, tp = (tid & 7) * 8;
  const int warp_last = (tid >> 5) * 32 + 31;   // the warp's last row
  float acc[8][8] = {};
  auto mma_tile = [&](int kn) {
    for (int kk = 0; kk < kn; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kLDA + ti);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * kLDA + ti + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kPT + tp);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * kPT + tp + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(av[r], bv[e], acc[r][e]);
    }
  };

  // the inbound state: exp(cum_i) (C_i . h)
  const float* hb = states + ((size_t)bc * h_len + hh) * n * p;
  for (int k0 = 0; k0 < n; k0 += kKT) {
    __syncthreads();                 // ecum written; the last tiles read
    for (int e = tid; e < kQMax * kKT; e += kThreads) {
      const int i = e / kKT, kk = e - i * kKT;
      as[kk * kLDA + i] = i < q && k0 + kk < n
                              ? to_f(cmat[(row0 + i) * n + k0 + kk])
                              : 0.f;
    }
    for (int e = tid; e < kKT * kPT; e += kThreads) {
      const int kk = e / kPT, col = e - kk * kPT;
      bs[e] = k0 + kk < n && p0 + col < p
                  ? hb[(size_t)(k0 + kk) * p + p0 + col]
                  : 0.f;
    }
    __syncthreads();
    mma_tile(min(kKT, n - k0));
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float sc = ti + r < q ? ecum[ti + r] : 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] *= sc;
  }

  // the chunk's own steps: W . x, key tiles up to the diagonal
  const float* cbc = cb + (size_t)bc * q * q;
  for (int j0 = 0; j0 < q; j0 += kKT) {
    __syncthreads();
    for (int e = tid; e < kQMax * kKT; e += kThreads) {
      const int i = e / kKT, jj = e - i * kKT;
      const int j = j0 + jj;
      float w = 0.f;
      if (i < q && j <= i)
        w = cbc[(size_t)i * q + j] * expf(cum[i] - cum[j]) * dts[j];
      as[jj * kLDA + i] = w;
    }
    for (int e = tid; e < kKT * kPT; e += kThreads) {
      const int jj = e / kPT, col = e - jj * kPT;
      const int j = j0 + jj;
      bs[e] = j < q && p0 + col < p
                  ? to_f(x[((row0 + j) * h_len + hh) * p + p0 + col])
                  : 0.f;
    }
    __syncthreads();
    if (warp_last >= j0) mma_tile(min(kKT, q - j0));
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (ti + r >= q) continue;
    T* yo = y + ((row0 + ti + r) * h_len + hh) * p + p0 + tp;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (p0 + tp + e < p) store(yo + e, acc[r][e]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a_log,
                   const void* b, const void* c, const void* h_in, void* cb,
                   void* states, void* total, void* y, void* h_out, int bsz,
                   int s, int h, int p, int n, int q, cudaStream_t st) {
  const int nc = s / q;
  const int cb_bytes = 2 * kCbT * kCbLD * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      cb_bytes);
  if (err != cudaSuccess) return err;
  const int nt = (q + kCbT - 1) / kCbT;
  ssd_cb_kernel<T><<<dim3((unsigned)(bsz * nc), nt, nt), kThreads, cb_bytes,
                     st>>>(static_cast<const T*>(b),
                           static_cast<const T*>(c),
                           static_cast<float*>(cb), s, n, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 grid((unsigned)(bsz * nc), (unsigned)h,
                  (unsigned)((p + kPT - 1) / kPT));
  const int st_bytes = kStFloats * (int)sizeof(float);
  ssd_state_kernel<T><<<grid, kThreads, st_bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<float*>(states), static_cast<float*>(total), h, s, p, n,
      q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int np = n * p;
  ssd_pass_kernel<<<dim3((unsigned)(bsz * h),
                         (unsigned)((np + kThreads - 1) / kThreads)),
                    kThreads, 0, st>>>(
      static_cast<float*>(states), static_cast<const float*>(total),
      static_cast<const float*>(h_in), static_cast<float*>(h_out), h, nc,
      np);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int sc_bytes = kScFloats * (int)sizeof(float);
  err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sc_bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<grid, kThreads, sc_bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(c),
      static_cast<const float*>(cb), static_cast<const float*>(states),
      static_cast<T*>(y), h, s, p, n, q);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (x, b, c, y); h_in may be null (zeros);
// scratch: cb (B, S / Q, Q, Q), states (B, S / Q, H, N, P), total
// (B, S / Q, H), all fp32. 1 <= q <= 256, s % q == 0, 1 <= p <= 128,
// 1 <= n <= 128.
extern "C" int ssd_chunk_launch(const void* x, const void* dt,
                                const void* a_log, const void* b,
                                const void* c, const void* h_in, void* cb,
                                void* states, void* total, void* y,
                                void* h_out, int dtype, int bsz, int s, int h,
                                int p, int n, int q, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q < 1 || q > kQMax || s % q || p < 1 || p > 2 * kPT || n < 1 ||
      n > kNMax)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, dt, a_log, b, c, h_in, cb, states, total, y,
                              h_out, bsz, s, h, p, n, q, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, a_log, b, c, h_in, cb, states,
                                      total, y, h_out, bsz, s, h, p, n, q,
                                      st);
  return (int)cudaErrorInvalidValue;
}
