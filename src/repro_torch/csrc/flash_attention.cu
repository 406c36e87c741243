// Blockwise online-softmax (flash) attention, causal with an optional
// sliding window, for Hopper (sm_90a), in fp32 or bf16 with fp32
// accumulation. Forward only.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention_fwd (body
// _flash_kernel): q (B, KVH, G, Sq, D), k/v (B, KVH, Skv, D) in;
// (B, KVH, G, Sq, D) in q's dtype out. Positions are arange, the Sq query
// rows being the last Sq of the Skv context (prefill); key j counts for
// query row i where 0 <= (i + Skv - Sq) - j (< window when window > 0).
// Unlike the reference, any Sq <= Skv is taken: the ragged edge of the last
// query and key tiles is masked here instead of asserted away.
//
// Bound: operations. A causal prefill of S tokens does ~2 * S^2 * D flops a
// head for 4 * S * D * sizeof(T) bytes; at S = 4096 that is ~1000 flops a
// byte, far above the card's ~295. Design: one block per (b, kv head,
// query head, tile of kBQ query rows), heavy (late) query tiles first. The
// block keeps its Q tile (pre-scaled, fp32) in shared memory and walks only
// the key tiles a row of it can reach: causal, and for a window the tiles
// not wholly evicted (the reference's block skip). Each key tile goes
// through shared memory once; 256 threads each own a 4 x 4 block of the
// kBQ x kBK scores (float4 loads along D) and the matching 4 rows x D/16
// columns of the output accumulator, with the online softmax (m, l) of its
// four rows in registers, reduced over the 16 lanes that share a row. The
// probabilities stay in fp32 (the reference kernel rounds them to V's
// dtype; its plain version does not). Masked scores are the reference's
// finite -1e30, so a first tile that is masked for some rows is washed out
// by alpha = exp(-1e30 - m) = 0 when a real score arrives. That kernel
// runs on the CUDA cores and serves float32 (whose tolerance the tensor
// cores' bf16 or TF32 inputs would not meet) and head dim 256.
//
// bf16 with head dims up to 128 runs on the tensor cores instead
// (flash_mma_kernel): mma.sync m16n8k16 with bf16 inputs and fp32
// accumulation, FlashAttention-2 style. Four warps own 16 query rows
// each; a warp keeps its Q fragments, its 16 x 64 scores and its 16 x D
// output accumulator in registers, and its probabilities go from the
// score accumulator straight into the A fragments of the PV product
// (rounded to bf16 there, as the reference kernel rounds them to V's
// dtype). K and V tiles are staged in shared memory at a padded row
// stride so that ldmatrix (transposed for V) reads them without bank
// conflicts. Scores are kept in log2 units (exp2), masked with the same
// finite -1e30. wgmma, TMA and a pipelined (multi-stage) tile ring are
// later work.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "error.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kThreads = 256;
constexpr int kBQ = 64;            // query rows a block
constexpr int kBK = 64;            // keys a tile

__device__ __forceinline__ void unpack16(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack16(const uint4& u, float* f,
                                         __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Q and K tiles at row stride D + 4 (float4 reads, no bank conflicts), V
// at stride D; the probabilities (kBQ x (kBK + 1)) reuse the K tile's space
template <int D>
__host__ __device__ constexpr int kp_floats() {
  return kBK * (D + 4) > kBQ * (kBK + 1) ? kBK * (D + 4) : kBQ * (kBK + 1);
}

template <int D>
__host__ __device__ constexpr int smem_floats() {
  return kBQ * (D + 4) + kp_floats<D>() + kBK * D;
}

// rows [row0, row0 + rows) of a (rows_total, D) matrix of T -> fp32 shared
// memory at row stride `ld`, times `mul`; rows past the matrix are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long row0, long long rows,
                                          float* dst, int ld, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NV = D / VEC;
  for (int i = threadIdx.x; i < ROWS * NV; i += kThreads) {
    const int r = i / NV, c = i % NV;
    float f[VEC];
    if (row0 + r < rows) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * D + c * VEC));
      unpack16(u, f, T());
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * ld + c * VEC + e] = f[e] * mul;
  }
}

// grid (B*KVH*G, ceil(Sq / kBQ)); Sq <= Skv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int g_len,
                     long long sq, long long skv, int window, float scale) {
  constexpr int LDQ = D + 4;
  constexpr int LDP = kBK + 1;
  constexpr int DC = D / 16;            // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // kBQ x LDQ
  float* ks = qs + kBQ * LDQ;           // kBK x LDQ
  float* ps = ks;                       // kBQ x LDP, over the K tile
  float* vs = ks + kp_floats<D>();      // kBK x D

  const int bhg = blockIdx.x;           // (b * KVH + h) * G + g
  const long long bh = bhg / g_len;
  const long long qt = (long long)gridDim.y - 1 - blockIdx.y;  // late first
  const long long q0 = qt * kBQ;
  const long long off = skv - sq;       // suffix alignment
  const T* qb = q + (size_t)bhg * sq * D;
  const T* kb = k + (size_t)bh * skv * D;
  const T* vb = v + (size_t)bh * skv * D;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;              // rows rg*4 .. rg*4+3
  const int cg = tid & 15;              // score cols cg + 16 j, out cols
                                        // cg + 16 c
  load_tile<T, D, kBQ>(qb, q0, sq, qs, LDQ, scale);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // key tiles some row of this block can reach
  const long long q_lo = q0 + off;
  const long long q_hi = min(q0 + kBQ, sq) - 1 + off;
  const long long kv_end = min(skv, q_hi + 1);
  const long long kv_begin = window ? max(0LL, q_lo - window + 1) : 0LL;
  for (long long k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();                    // the last tile's P and V are read
    load_tile<T, D, kBK>(kb, k0, skv, ks, LDQ, 1.f);
    load_tile<T, D, kBK>(vb, k0, skv, vs, D, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg * 4 + i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (cg + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q0 + rg * 4 + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k0 + cg + 16 * j;
        const long long dp = qpos - kpos;
        const bool ok = dp >= 0 && (window == 0 || dp < window);
        // a key past Skv is no key (weight exactly 0); a masked one takes
        // the reference's finite -1e30
        s[i][j] = kpos >= skv ? -INFINITY : (ok ? s[i][j] : kNegInf);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                    // every thread is done with K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(rg * 4 + i) * LDP + cg + 16 * j] = p[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(rg * 4 + i) * LDP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = vs[c * D + cg + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

  T* ob = out + (size_t)bhg * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + rg * 4 + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(ob + (size_t)row * D + cg + 16 * c, acc[i][c] * inv);
  }
}

// ---- tensor-core path: bf16, D in {32, 64, 128} -------------------------

constexpr int kMmaWarps = 4;                 // 16 query rows each
constexpr int kMmaThreads = kMmaWarps * 32;

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* smem_ptr) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem_ptr);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* smem_ptr) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem_ptr);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows [row0, row0 + ROWS) of a (rows, D) bf16 matrix -> shared memory at
// row stride LD (elements); rows past the matrix are zeros
template <int D, int LD, int ROWS>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* src,
                                           long long row0, long long rows,
                                           __nv_bfloat16* dst) {
  constexpr int NV = D / 8;                  // 16-byte vectors a row
  for (int i = threadIdx.x; i < ROWS * NV; i += kMmaThreads) {
    const int r = i / NV, c = i % NV;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      u = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D
                                               + c * 8));
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = u;
  }
}

template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return 3 * kBQ * (D + 8) * 2;              // Q, K, V tiles of bf16
}

// grid (B*KVH*G, ceil(Sq / kBQ)); Sq <= Skv; kBQ == kBK == 64
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int g_len,
                     long long sq, long long skv, int window,
                     float scale_log2) {
  constexpr int LD = D + 8;          // +16 bytes: ldmatrix rows on 8 banks
  constexpr int KS = D / 16;         // k-steps of QK^T; d-tile pairs of PV
  constexpr int NT = kBK / 8;        // score n-tiles (8 keys each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * LD;
  __nv_bfloat16* vs = ks + kBK * LD;

  const int bhg = blockIdx.x;
  const long long bh = bhg / g_len;
  const long long q0 =
      ((long long)gridDim.y - 1 - blockIdx.y) * kBQ;   // late tiles first
  const long long off = skv - sq;
  const __nv_bfloat16* qb = q + (size_t)bhg * sq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * skv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * skv * D;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;         // fragment row (and row + 8)
  const int tig = lane & 3;          // fragment column pair
  const int lm = lane >> 3;          // which 8x8 matrix this lane addresses
  const int lr = lane & 7;           // and which row of it

  stage_tile<D, LD, kBQ>(qb, q0, sq, qs);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                qs + (warp * 16 + (lm & 1) * 8 + lr) * LD + kk * 16
                    + (lm >> 1) * 8);

  float m[2] = {kNegInf, kNegInf};   // rows gid, gid + 8 (log2 units)
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums
  float o[D / 8][4];
#pragma unroll
  for (int e = 0; e < D / 8; ++e)
    o[e][0] = o[e][1] = o[e][2] = o[e][3] = 0.f;

  const long long row_a = q0 + warp * 16 + gid;      // query rows
  const long long pos_a = row_a + off, pos_b = pos_a + 8;
  const long long q_lo = q0 + off;
  const long long q_hi = min(q0 + kBQ, sq) - 1 + off;
  const long long kv_end = min(skv, q_hi + 1);
  const long long kv_begin = window ? max(0LL, q_lo - window + 1) : 0LL;
  for (long long k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();                 // the last tile's K and V are read
    stage_tile<D, LD, kBK>(kb, k0, skv, ks);
    stage_tile<D, LD, kBK>(vb, k0, skv, vs);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b0, b1, b2, b3;     // n-tiles j and j + 1
        ldmatrix_x4(b0, b1, b2, b3,
                    ks + ((j + (lm >> 1)) * 8 + lr) * LD + kk * 16
                        + (lm & 1) * 8);
        mma_bf16(s[j], qf[kk], b0, b1);
        mma_bf16(s[j + 1], qf[kk], b2, b3);
      }
    }

    // scale, mask, online softmax (log2 units) over this tile's 64 keys
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long kpos = k0 + j * 8 + tig * 2 + (e & 1);
        const long long dp = (e < 2 ? pos_a : pos_b) - kpos;
        const bool ok = dp >= 0 && (window == 0 || dp < window);
        s[j][e] = kpos >= skv ? -INFINITY
                              : (ok ? s[j][e] * scale_log2 : kNegInf);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int e = 0; e < D / 8; ++e) {
      o[e][0] *= alpha[0];
      o[e][1] *= alpha[0];
      o[e][2] *= alpha[1];
      o[e][3] *= alpha[1];
    }
    uint32_t pf[NT / 2][4];          // P as the A fragments of P V
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2f(s[j][0] - m[0]), p1 = exp2f(s[j][1] - m[0]);
      const float p2 = exp2f(s[j][2] - m[1]), p3 = exp2f(s[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

#pragma unroll
    for (int t = 0; t < NT / 2; ++t) {       // 16 keys a k-step
#pragma unroll
      for (int e = 0; e < D / 8; e += 2) {   // d tiles e and e + 1
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          vs + (t * 16 + (lm & 1) * 8 + lr) * LD
                              + (e + (lm >> 1)) * 8);
        mma_bf16(o[e], pf[t], b0, b1);
        mma_bf16(o[e + 1], pf[t], b2, b3);
      }
    }
  }

  // the row sums are split over the four lanes of a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
  __nv_bfloat16* ob = out + (size_t)bhg * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row_a + h * 8;
    if (row >= sq) continue;
#pragma unroll
    for (int e = 0; e < D / 8; ++e)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + e * 8
                                         + tig * 2) =
          __floats2bfloat162_rn(o[e][h * 2] * l[h], o[e][h * 2 + 1] * l[h]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bhg, int g, long long sq, long long skv, int window,
                   cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D <= 128) {
    const int bytes = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(bhg, (unsigned)((sq + kBQ - 1) / kBQ));
    flash_mma_kernel<D><<<grid, kMmaThreads, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), g, sq, skv, window,
        (float)(1.4426950408889634 / sqrt((double)D)));   // log2(e) / sqrt(D)
    return cudaGetLastError();
  } else {
    const int bytes = smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(bhg, (unsigned)((sq + kBQ - 1) / kBQ));
    flash_fwd_kernel<T, D><<<grid, kThreads, bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), g, sq, skv, window,
        (float)(1.0 / sqrt((double)D)));
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t by_dim(const void* q, const void* k, const void* v, void* out,
                   int bhg, int g, long long sq, long long skv, int d,
                   int window, cudaStream_t st) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, bhg, g, sq, skv, window, st);
    case 64: return launch<T, 64>(q, k, v, out, bhg, g, sq, skv, window, st);
    case 128:
      return launch<T, 128>(q, k, v, out, bhg, g, sq, skv, window, st);
    case 256:
      return launch<T, 256>(q, k, v, out, bhg, g, sq, skv, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16; 1 <= sq <= skv
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int b, int kvh, int g, long long sq,
                                      long long skv, int d, int window,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bhg = b * kvh * g;
  if (dtype == 0)
    return (int)by_dim<float>(q, k, v, out, bhg, g, sq, skv, d, window, st);
  if (dtype == 1)
    return (int)by_dim<__nv_bfloat16>(q, k, v, out, bhg, g, sq, skv, d,
                                      window, st);
  return (int)cudaErrorInvalidValue;
}
