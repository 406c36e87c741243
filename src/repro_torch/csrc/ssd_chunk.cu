// Mamba-2 SSD chunk scan (state-space duality, arXiv:2405.21060 §6) for
// Hopper (sm_90a), fp32 or bf16 inputs.
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
// Q 256) the function reads and writes ~74 MB, 0.022 ms at 3.35 TB/s, and
// needs ~13 GFLOP on the causal pairs (C . B^T once a chunk, the decayed
// product with x and the two state products a head and chunk): 0.013 ms
// on the bf16 tensor cores, so bytes bound it; the same operations take
// 0.19 ms on the fp32 CUDA cores. The caller picks one of two routes
// (kernel.py::route):
//
// ssd_wgmma_kernel, bf16 with P <= 64 and P, N multiples of 8 (TMA's
// 16-byte strides): the serving path's route, one launch, every product on
// the tensor cores by wgmma. A block owns one (batch, head) and walks its
// chunks in order; the state h (N x P, fp32) stays in its consumers'
// accumulator registers from the first chunk to the last, so no state
// goes through device memory (B * H blocks: 64 of the 132 SMs at the
// path's shape). Three warpgroups. The producer's first thread issues TMA
// loads (128-byte swizzle) of each 64-step tile's C, B and x (a head's x
// rows lie H * P apart; the tensor map strides over them) into two
// mbarrier rings: C tiles in three stages, each released when its row
// tile is done, and B / x tiles in five, a chunk's four and one of the
// next, released at the chunk's end. Its second warp loads dt (a 4-byte
// box a head, which TMA cannot copy) and forms cum, exp(cum_i), the state
// weights d2e_j = exp(cum_Q - cum_j) dt_j, exp(cum_Q) and ej_j = exp(cum_r
// - cum_j) dt_j (r the last step of j's tile) in a two-slot ring a chunk
// ahead (the CUDA-core route's scan order). The two consumers take a
// chunk's row tiles 0 and 3, and 1 and 2, the same causal work each. A row
// tile: y = C . h (h from shared memory), scaled by exp(cum_i); then for
// each key tile on or below the diagonal, C . B^T (m64n64, both operands
// K-major) in an accumulator where W = C . B^T exp(cum_i - cum_j) dt_j is
// formed once for all of P, and y += W . x with W from registers and x an
// MN-major operand, in flash_wgmma_kernel's order (C . B^T of tile j
// issued with tile j - 1's W . x, W of tile j formed under it). Below the
// diagonal W takes exp(cum_i - cum_r) ej_j, two exp2 a thread and tile;
// on it exp2 of each masked difference (0 above the diagonal, where exp
// never sees a positive argument). Then each consumer's 64 state rows:
// h <- exp(cum_Q) h + (d2e B)^T x, B^T read from its tile by
// ldmatrix.trans and scaled in registers; past a named barrier the new h
// goes to shared memory for the next chunk's C . h. Precision: the bf16
// products are exact and every sum is fp32; an operand that is fp32 goes
// in as bf16 terms, each the rounding of what the ones before leave, one
// wgmma a term. W takes three (2^-24): with two (2^-16), y's bf16 rounding
// flipped often enough to double its distance from the plain version
// (PERF.md). d2e B^T and h take two, which move y a hundredth as
// much.
// A ragged chunk (Q not a multiple of 64) reads the next chunk's first
// steps into its last tile and weighs them 0 (the inputs are finite).
//
// The CUDA-core route, for fp32 (x, B and C are not exact in bf16 or TF32;
// a split of every operand would triple every product) and the bf16 shapes
// the tensor-core route does not take (P over 64, P or N not a multiple of
// 8): every chunk of every head in parallel (B * NC * H blocks) in four
// launches on one stream, every product in fp32:
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
// at the edge.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "error.cuh"
#include "hopper.cuh"

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
  cudaError_t err = set_smem_once<ssd_cb_kernel<T>>(cb_bytes);
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
  err = set_smem_once<ssd_scan_kernel<T>>(sc_bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<grid, kThreads, sc_bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(c),
      static_cast<const float*>(cb), static_cast<const float*>(states),
      static_cast<T*>(y), h, s, p, n, q);
  return cudaGetLastError();
}

// ---- the tensor-core route: bf16, P <= 64 -------------------------------

namespace tc {

constexpr int kWG = 128;                    // threads a warpgroup
constexpr int kThreads = 3 * kWG;           // the producer and two consumers
constexpr int kRows = 64;                   // steps a tile (wgmma's M)
constexpr int kPanel = 64;                  // bf16 columns a 128-byte panel
constexpr int kPanelBytes = kRows * 128;    // one panel of a 64-row tile
constexpr int kNBytes = 2 * kPanelBytes;    // a C or B tile, N <= 128
constexpr int kXBytes = kPanelBytes;        // an x tile, P <= 64
constexpr int kBXBytes = kNBytes + kXBytes;
constexpr int kHBytes = kNMax * 128;        // the state, N x 64 bf16
constexpr int kCStages = 3;
constexpr int kBXStages = 5;                // a chunk's four and one ahead
// a chunk's cum, dt, d2e_j = exp(cum_Q - cum_j) dt_j, exp(cum_i) and
// ej_j = exp(cum_r - cum_j) dt_j, r the last step of j's 64-step tile
constexpr int kCumFloats = 5 * kQMax;
constexpr int kOffBX = kCStages * kNBytes;
constexpr int kOffH = kOffBX + kBXStages * kBXBytes;   // h hi, then h lo
constexpr int kOffCum = kOffH + 2 * kHBytes;
constexpr int kSmem = kOffCum + 2 * kCumFloats * (int)sizeof(float);
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBXStages >= kQMax / kRows, "a chunk's B / x tiles must fit");

struct Params {
  const float* dt;
  const float* a_log;
  const float* h_in;      // null: zeros
  __nv_bfloat16* y;
  float* h_out;
  int h_len, s, p, n, q;
  int nc;                 // chunks a row
  int rt;                 // 64-step tiles a chunk
};

// v = (a, b) as T bf16 pairs, each the rounding of what the ones before
// leave (the residuals are exact in fp32): their sum is v to 2^(-8 T)
template <int T>
__device__ __forceinline__ void split(float a, float b, uint32_t (&out)[T]) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    out[t] = *reinterpret_cast<const uint32_t*>(&h);
    a -= f.x;
    b -= f.y;
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// the two consumer warpgroups meet (named barrier `id`)
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(2 * kWG) : "memory");
}

// a tile of 64 rows and N columns in 128-byte panels, read K-major (k-step
// kk: columns 16 kk ..)
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 16,
                   8 * 128, 1);
}

// a tile of 64 columns, one 128-byte panel of `bytes`, read MN-major (k-step
// kk: rows 16 kk ..)
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk,
                                            uint32_t bytes) {
  return make_desc(tile + kk * 16 * 128, bytes, 8 * 128, 1);
}

// Pins registers that the next wgmmas read or write in program order
// before their wgmma.fence (or after the wait that completes them), so the
// compiler neither sinks their definitions past the fence nor serializes
// the wgmmas (CUTLASS's warpgroup_fence_operand).
template <int K>
__device__ __forceinline__ void fence_regs(float (&r)[K]) {
#pragma unroll
  for (int e = 0; e < K; ++e) reg_fence(r[e]);
}
template <int T>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[T][4][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence_u(r[t][k][e]);
}

// s = C . B^T of a row tile and a key tile over N's NPAN panels (four
// k-steps each)
template <int NPAN>
__device__ __forceinline__ void issue_cb(float (&s)[32], uint32_t ct,
                                         uint32_t bt) {
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NPAN; ++kk)
    Wgmma<64>::ss(s, kmajor(ct, kk), kmajor(bt, kk), kk);
  wg_commit();
}

// acc += W . x or st += (d2e B)^T x over a 64-step key tile: A as the
// first T of its bf16 terms of fragments (split), x (64 steps x 64
// columns) at xt
template <int T, int TA>
__device__ __forceinline__ void issue_x(float (&d)[32],
                                        uint32_t (&a)[TA][4][4], uint32_t xt) {
  static_assert(T <= TA, "terms the fragments hold");
  fence_regs(d);
  fence_frags(a);
  wg_fence();
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
#pragma unroll
    for (int t = 0; t < T; ++t)
      Wgmma<64>::rs(d, a[t][kt], mnmajor(xt, kt, kXBytes));
  wg_commit();
}

// One block a (batch, head), its chunks in order; kThreads threads. NPAN:
// N's 64-column panels (1 or 2).
template <int NPAN>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tmc,
                     const __grid_constant__ CUtensorMap tmb,
                     const __grid_constant__ CUtensorMap tmx,
                     const Params pr) {
  extern __shared__ unsigned char smem_raw[];
  // full and empty of each C stage, each B / x stage and each cum slot
  __shared__ __align__(8) uint64_t bars[2 * (kCStages + kBXStages + 2)];
  __shared__ float decay[2];                 // exp(cum_Q) of each cum slot
  // 128-byte swizzled tiles need 1024-byte aligned bases
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* cum_slots =
      reinterpret_cast<float*>(smem_raw + (base - raw) + kOffCum);
  const uint32_t c_full = smem_u32(&bars[0]);
  const uint32_t c_empty = c_full + 8 * kCStages;
  const uint32_t bx_full = c_empty + 8 * kCStages;
  const uint32_t bx_empty = bx_full + 8 * kBXStages;
  const uint32_t cum_full = bx_empty + 8 * kBXStages;
  const uint32_t cum_empty = cum_full + 16;
  const int bh = blockIdx.x;                 // batch * H + head
  const int hh = bh % pr.h_len;
  const int row_b = (bh / pr.h_len) * pr.s;  // the row's first step

  if (threadIdx.x == 0) {
    for (int i = 0; i < kCStages; ++i) {
      mbar_init(c_full + 8 * i, 1);
      mbar_init(c_empty + 8 * i, kWG);       // the consumer that read it
    }
    for (int i = 0; i < kBXStages; ++i) {
      mbar_init(bx_full + 8 * i, 1);
      mbar_init(bx_empty + 8 * i, 2 * kWG);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(cum_full + 8 * i, 32);       // the scan warp's lanes
      mbar_init(cum_empty + 8 * i, 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {
    // registers move within the block's launch allocation (384 x 168):
    // 128 x 56 + 256 x 224 fill it exactly
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 0) {
      // ---- TMA: each 64-step tile's C, then its B and x ----
      for (int c = 0; c < pr.nc; ++c)
        for (int t = 0; t < pr.rt; ++t) {
          const int u = c * pr.rt + t;
          const int row = row_b + c * pr.q + t * kRows;
          const int sc = u % kCStages, sb = u % kBXStages;
          mbar_wait(c_empty + 8 * sc, ((u / kCStages) & 1) ^ 1);
          mbar_expect_tx(c_full + 8 * sc, NPAN * kPanelBytes);
#pragma unroll
          for (int pn = 0; pn < NPAN; ++pn)
            tma_load_2d(base + sc * kNBytes + pn * kPanelBytes, &tmc,
                        c_full + 8 * sc, pn * kPanel, row);
          mbar_wait(bx_empty + 8 * sb, ((u / kBXStages) & 1) ^ 1);
          mbar_expect_tx(bx_full + 8 * sb, NPAN * kPanelBytes + kXBytes);
          const uint32_t bx = base + kOffBX + sb * kBXBytes;
#pragma unroll
          for (int pn = 0; pn < NPAN; ++pn)
            tma_load_2d(bx + pn * kPanelBytes, &tmb, bx_full + 8 * sb,
                        pn * kPanel, row);
          tma_load(bx + kNBytes, &tmx, bx_full + 8 * sb, 0, hh, row);
        }
    } else if (threadIdx.x >> 5 == 1) {
      // ---- each chunk's decay sums and weights, a chunk ahead: lane l
      // sums steps 8 l .. 8 l + 7, a warp scan adds the lanes before ----
      const int lane = threadIdx.x & 31;
      const float a_neg = -expf(pr.a_log[hh]);
      for (int c = 0; c < pr.nc; ++c) {
        const int cs = c & 1;
        mbar_wait(cum_empty + 8 * cs, ((c >> 1) & 1) ^ 1);
        float* cum = cum_slots + cs * kCumFloats;
        const size_t row0 = (size_t)row_b + (size_t)c * pr.q;
        float part[8], d[8], run = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = lane * 8 + e;
          d[e] = j < pr.q ? pr.dt[(row0 + j) * pr.h_len + hh] : 0.f;
          run += d[e] * a_neg;
          part[e] = run;
        }
        float incl = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        float excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) excl = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          cum[lane * 8 + e] = excl + part[e];
          cum[kQMax + lane * 8 + e] = d[e];
        }
        __syncwarp();
        const float last = cum[pr.q - 1];
        const float tile_last = cum[lane * 8 | (kRows - 1)];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = lane * 8 + e;
          const float cj = excl + part[e];
          cum[2 * kQMax + j] = expf(last - cj) * d[e];   // 0 past q
          cum[3 * kQMax + j] = expf(cj);
          cum[4 * kQMax + j] = expf(tile_last - cj) * d[e];
        }
        if (lane == 0) decay[cs] = expf(last);
        mbar_arrive(cum_full + 8 * cs);
      }
    }
  } else {
    // ---- consumers: row tiles 0 and 3 (w 0) or 1 and 2 (w 1), then
    // state rows 64 w .. 64 w + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int w = wg - 1;
    const int t = threadIdx.x - wg * kWG;
    const int warp = t >> 5, lane = t & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const uint32_t h_hi = base + kOffH, h_lo = h_hi + kHBytes;
    // the state in the accumulator layout: st[4 jj + e] is row n0 + 8 (e
    // >> 1), column 8 jj + 2 tig + (e & 1)
    const int n0 = 64 * w + 16 * warp + gid;
    float st[32];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 8 * (e >> 1), p = 8 * jj + 2 * tig + (e & 1);
        st[4 * jj + e] = pr.h_in != nullptr && n < pr.n && p < pr.p
                             ? pr.h_in[((size_t)bh * pr.n + n) * pr.p + p]
                             : 0.f;
      }
    // st as bf16 hi and lo into the swizzled N x 64 planes read by C . h
    auto write_state = [&]() {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = n0 + 8 * hf;
          const uint32_t off = n * 128 + ((jj ^ (n & 7)) << 4) + 4 * tig;
          uint32_t v[2];
          split(st[4 * jj + 2 * hf], st[4 * jj + 2 * hf + 1], v);
          st_shared(h_hi + off, v[0]);
          st_shared(h_lo + off, v[1]);
        }
      // generic-proxy writes that wgmma (the async proxy) reads next
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    write_state();
    consumers_sync(2);

    for (int c = 0; c < pr.nc; ++c) {
      const int cs = c & 1;
      mbar_wait(cum_full + 8 * cs, (c >> 1) & 1);
      const float* cum = cum_slots + cs * kCumFloats;
      const float* dtv = cum + kQMax;
      const float* d2e = cum + 2 * kQMax;
      const float* ecum = cum + 3 * kQMax;
      const float* ej = cum + 4 * kQMax;
      auto bx_tile = [&](int j) {
        return base + kOffBX +
               (uint32_t)((c * pr.rt + j) % kBXStages) * kBXBytes;
      };
      auto wait_bx = [&](int j) {
        const int u = c * pr.rt + j;
        mbar_wait(bx_full + 8 * (u % kBXStages), (u / kBXStages) & 1);
      };

      for (int k = 0; k < 2; ++k) {
        const int tt = k == 0 ? w : 3 - w;   // the row tile
        if (tt >= pr.rt) continue;
        const int uc = c * pr.rt + tt;
        const int sc = uc % kCStages;
        const uint32_t ct = base + sc * kNBytes;
        mbar_wait(c_full + 8 * sc, (uc / kCStages) & 1);
        wait_bx(0);
        float acc[32], s[32];
        uint32_t wf[3][4][4];                // W in three bf16 terms
        // the inbound state C . (h hi + h lo), and C . B^T of key tile 0
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NPAN; ++kk)
          Wgmma<64>::ss_t(acc, kmajor(ct, kk), mnmajor(h_hi, kk, kHBytes),
                          kk);
#pragma unroll
        for (int kk = 0; kk < 4 * NPAN; ++kk)
          Wgmma<64>::ss_t(acc, kmajor(ct, kk), mnmajor(h_lo, kk, kHBytes),
                          1);
        wg_commit();
        issue_cb<NPAN>(s, ct, bx_tile(0));
        wg_wait<0>();
        fence_regs(acc);
        fence_regs(s);
        const int i0 = tt * kRows + 16 * warp + gid;   // rows i0, i0 + 8
        const float c0 = cum[i0], c1 = cum[i0 + 8];
        {
          const float e0 = ecum[i0], e1 = ecum[i0 + 8];
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[e] *= e & 2 ? e1 : e0;
        }
        // W = C . B^T exp(cum_i - cum_j) dt_j of key tile j, in s. Below
        // the diagonal exp(cum_i - cum_j) = exp(cum_i - cum_r) exp(cum_r -
        // cum_j), r the key tile's last step, each factor at most 1; on it
        // the masked form (0 above the diagonal, where exp never sees a
        // positive argument).
        auto form_w = [&](int j) {
          if (j < tt) {
            const float cr = cum[64 * j + kRows - 1];
            const float f0 = ex2((c0 - cr) * kLog2e);
            const float f1 = ex2((c1 - cr) * kLog2e);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[4 * jj + e] *= (e & 2 ? f1 : f0) *
                                 ej[64 * j + 8 * jj + 2 * tig + (e & 1)];
          } else {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = 64 * j + 8 * jj + 2 * tig + (e & 1);
                const int i = i0 + 8 * (e >> 1);
                const float ci = e & 2 ? c1 : c0;
                s[4 * jj + e] =
                    key <= i
                        ? s[4 * jj + e] * ex2((ci - cum[key]) * kLog2e) *
                              dtv[key]
                        : 0.f;
              }
          }
        };
        // W as A fragments in three bf16 terms
        auto pack_w = [&]() {
          fence_frags(wf);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              uint32_t v[3];
              split(s[4 * jj + 2 * hf], s[4 * jj + 2 * hf + 1], v);
#pragma unroll
              for (int t = 0; t < 3; ++t)
                wf[t][jj >> 1][(jj & 1) * 2 + hf] = v[t];
            }
        };
        // flash_wgmma_kernel's order: C . B^T of tile j is issued with
        // tile j - 1's W . x, and W of tile j is formed under that W . x
        form_w(0);
        pack_w();
        for (int j = 1; j <= tt; ++j) {
          wait_bx(j);
          issue_cb<NPAN>(s, ct, bx_tile(j));
          issue_x<3>(acc, wf, bx_tile(j - 1) + kNBytes);
          wg_wait<1>();                      // C . B^T of tile j
          fence_regs(s);
          form_w(j);
          wg_wait<0>();                      // tile j - 1's W . x
          fence_regs(acc);
          pack_w();
        }
        issue_x<3>(acc, wf, bx_tile(tt) + kNBytes);
        wg_wait<0>();
        fence_regs(acc);
        mbar_arrive(c_empty + 8 * sc);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = i0 + 8 * hf;
          if (i >= pr.q) continue;
          __nv_bfloat16* yo =
              pr.y + ((size_t)(row_b + c * pr.q + i) * pr.h_len + hh) * pr.p;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int p = 8 * jj + 2 * tig;
            if (p < pr.p)
              *reinterpret_cast<__nv_bfloat162*>(yo + p) =
                  __floats2bfloat162_rn(acc[4 * jj + 2 * hf],
                                        acc[4 * jj + 2 * hf + 1]);
          }
        }
      }

      // the state: h <- exp(cum_Q) h + sum_j (d2e_j B_j)^T x_j, B_j^T read
      // from its tile's panel w by ldmatrix.trans and scaled in registers
      const float dec = decay[cs];
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] *= dec;
      if (64 * w < pr.n) {
        const int mi = lane >> 3, r = lane & 7;
        uint32_t af[2][4][4];                // d2e B^T in two bf16 terms
        for (int j = 0; j < pr.rt; ++j) {
          wait_bx(j);
          const uint32_t bt = bx_tile(j) + w * kPanelBytes;
#pragma unroll
          for (int kt = 0; kt < 4; ++kt) {
            const int key = 16 * kt + r + 8 * (mi >> 1);
            uint32_t v[4];
            ldsm_x4_trans(v, bt + key * 128 +
                                 (((2 * warp + (mi & 1)) ^ (key & 7)) << 4));
            const int k0 = 64 * j + 16 * kt + 2 * tig;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kk = k0 + 8 * (e >> 1);
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&v[e]));
              uint32_t v2[2];
              split(f.x * d2e[kk], f.y * d2e[kk + 1], v2);
              af[0][kt][e] = v2[0];
              af[1][kt][e] = v2[1];
            }
          }
          issue_x<2>(st, af, bx_tile(j) + kNBytes);
          wg_wait<0>();
          fence_regs(st);
          fence_frags(af);
        }
      }
      consumers_sync(1);       // every read of the inbound state is done
      write_state();
      for (int j = 0; j < pr.rt; ++j)
        mbar_arrive(bx_empty + 8 * ((c * pr.rt + j) % kBXStages));
      mbar_arrive(cum_empty + 8 * cs);
      consumers_sync(2);       // the next chunk's inbound state is written
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + 8 * hf, p = 8 * jj + 2 * tig;
        if (n < pr.n && p < pr.p)
          *reinterpret_cast<float2*>(pr.h_out +
                                     ((size_t)bh * pr.n + n) * pr.p + p) =
              make_float2(st[4 * jj + 2 * hf], st[4 * jj + 2 * hf + 1]);
      }
  }
}

// a rank-2 or rank-3 bf16 tensor read in boxes `box` into 128-byte
// swizzled rows; elements past its edges read as zeros
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
      const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NPAN>
cudaError_t launch_panels(const CUtensorMap& tmc, const CUtensorMap& tmb,
                          const CUtensorMap& tmx, const Params& pr,
                          int blocks, cudaStream_t st) {
  constexpr int bytes = kSmem + 1024;        // + the alignment slack
  const cudaError_t err = set_smem_once<ssd_wgmma_kernel<NPAN>>(bytes);
  if (err != cudaSuccess) return err;
  ssd_wgmma_kernel<NPAN><<<blocks, kThreads, bytes, st>>>(tmc, tmb, tmx, pr);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* dt, const void* a_log,
                   const void* b, const void* c, const void* h_in, void* y,
                   void* h_out, int bsz, int s, int h, int p, int n, int q,
                   cudaStream_t st) {
  const cuuint64_t rows = (cuuint64_t)bsz * s;
  const cuuint64_t bc_dims[2] = {(cuuint64_t)n, rows};
  const cuuint64_t bc_strides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t bc_box[2] = {kPanel, kRows};
  // x (B * S, H, P): a head's rows lie H * P elements apart
  const cuuint64_t x_dims[3] = {(cuuint64_t)p, (cuuint64_t)h, rows};
  const cuuint64_t x_strides[2] = {(cuuint64_t)p * 2, (cuuint64_t)h * p * 2};
  const cuuint32_t x_box[3] = {kPanel, 1, kRows};
  CUtensorMap tmc, tmb, tmx;
  cudaError_t err = tensor_map(&tmc, c, 2, bc_dims, bc_strides, bc_box);
  if (err == cudaSuccess) err = tensor_map(&tmb, b, 2, bc_dims, bc_strides,
                                           bc_box);
  if (err == cudaSuccess) err = tensor_map(&tmx, x, 3, x_dims, x_strides,
                                           x_box);
  if (err != cudaSuccess) return err;
  Params pr;
  pr.dt = static_cast<const float*>(dt);
  pr.a_log = static_cast<const float*>(a_log);
  pr.h_in = static_cast<const float*>(h_in);
  pr.y = static_cast<__nv_bfloat16*>(y);
  pr.h_out = static_cast<float*>(h_out);
  pr.h_len = h;
  pr.s = s;
  pr.p = p;
  pr.n = n;
  pr.q = q;
  pr.nc = s / q;
  pr.rt = (q + kRows - 1) / kRows;
  return n > kPanel ? launch_panels<2>(tmc, tmb, tmx, pr, bsz * h, st)
                    : launch_panels<1>(tmc, tmb, tmx, pr, bsz * h, st);
}

}  // namespace tc

}  // namespace

// route 0: the CUDA-core kernels, dtype 0 float32 or 1 bfloat16 (x, b, c,
// y), with their fp32 scratch cb (B, S / Q, Q, Q), states (B, S / Q, H,
// N, P) and total (B, S / Q, H); route 1: the tensor-core kernel, bfloat16
// with p <= 64 and p, n multiples of 8, no scratch (cb, states, total may
// be null). h_in may be null (zeros). 1 <= q <= 256, s % q == 0,
// 1 <= p <= 128, 1 <= n <= 128.
extern "C" int ssd_chunk_launch(const void* x, const void* dt,
                                const void* a_log, const void* b,
                                const void* c, const void* h_in, void* cb,
                                void* states, void* total, void* y,
                                void* h_out, int dtype, int route, int bsz,
                                int s, int h, int p, int n, int q,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q < 1 || q > kQMax || s % q || p < 1 || p > 2 * kPT || n < 1 ||
      n > kNMax)
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (dtype != 1 || p > tc::kPanel || p % 8 || n % 8)
      return (int)cudaErrorInvalidValue;
    return (int)tc::launch(x, dt, a_log, b, c, h_in, y, h_out, bsz, s, h, p,
                           n, q, st);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, dt, a_log, b, c, h_in, cb, states, total, y,
                              h_out, bsz, s, h, p, n, q, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, a_log, b, c, h_in, cb, states,
                                      total, y, h_out, bsz, s, h, p, n, q,
                                      st);
  return (int)cudaErrorInvalidValue;
}
