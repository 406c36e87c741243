// Split-K decode attention (one query token per row against a ring-buffer
// KV cache) for Hopper (sm_90a), in fp32 or bf16 with fp32 accumulation.
//
// Replaces the TPU kernel
// repro/kernels/decode_attention/kernel.py::decode_attention_fwd (body
// _decode_kernel): q (B, KVH, G, D), k/v (B, KVH, S, D) in the model's
// kernel-native ring layout, q_pos (B,) and the stored-position plane
// kv_pos (B, S) int32 in; (B, KVH, G, D) in q's dtype out. A slot counts
// where 0 <= q_pos - kv_pos (< window when window > 0); never-written slots
// hold INF_POS and so are masked. Masked scores are the finite -1e30, as in
// the reference, so a row whose every slot is masked averages V uniformly
// (an empty ring, an inactive serving slot) instead of producing NaN.
//
// Bound: memory. A decode step reads every K and V row and the position
// plane once, 2 * D * sizeof(T) + 4 bytes a slot, for ~4 * G * D flops a
// slot: far below the card's ~295 flops a byte. Design: split-K. A block
// owns one (b, kv head) and a contiguous slice of the ring, and serves all
// G query heads of that kv head from each K/V row it reads (GQA reuse).
// Each group of lanes covering one row with 16-byte loads (16 lanes for a
// bf16 row of 128) keeps its own online-softmax state (m, l, acc) in
// registers, fp32, and takes kUnroll rows a round so several loads are in
// flight; a butterfly over the group's lanes completes each dot product.
// At the end the block folds its groups in shared memory and writes one
// fp32 partial (m, l, acc) per (row, split); a second small launch folds
// the splits and writes the output. There is no sequential grid here, so
// the reference's carried VMEM scratch becomes the partials.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "error.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // rows a lane group loads per round

// 16 bytes of T -> 16 / sizeof(T) floats
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* q_pos;
  const int32_t* kv_pos;
  float* part_ml;   // (B*KVH, n_splits, G, 2): m, l
  float* part_acc;  // (B*KVH, n_splits, G, D)
  void* out;
  int kvh;
  int g;
  long long s;
  long long chunk;  // ring slots a split covers
  int n_splits;
  int window;
  float scale;
};

// grid (B*KVH, n_splits, ceil(G / GM)); GM query heads a block, G <= GM
// for the last z-slice is masked
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(Args a) {
  constexpr int VEC = 16 / sizeof(T);      // elements a 16-byte load
  constexpr int NV = D / VEC;              // 16-byte vectors a row
  constexpr int LPK = NV < 32 ? NV : 32;   // lanes a row
  constexpr int VPL = NV / LPK;            // vectors a lane
  constexpr int EPL = VPL * VEC;           // elements a lane
  constexpr int KPW = 32 / LPK;            // rows a warp takes at once
  constexpr int NGRP = kWarps * KPW;       // lane groups a block

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int g0 = blockIdx.z * GM;
  const int b = bh / a.kvh;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPK;
  const int grp = (threadIdx.x >> 5) * KPW + lane / LPK;

  const T* qb = static_cast<const T*>(a.q) + ((size_t)bh * a.g) * D;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * a.s * D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * a.s * D;
  const int32_t* pb = a.kv_pos + (size_t)b * a.s;

  // this lane's elements of each query head: vectors sub + LPK * j
  float qf[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (g0 + g < a.g) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            qb + (size_t)(g0 + g) * D + (sub + LPK * j) * VEC);
        unpack16(u, &qf[g][j * VEC], T());
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[g][j * VEC + e] *= a.scale;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[g][j * VEC + e] = 0.f;
      }
    }
  }

  float m[GM], l[GM], acc[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const long long s0 = (long long)split * a.chunk;
  const long long s1 = min(a.s, s0 + a.chunk);
  const int qp = a.q_pos[b];
  // every lane runs the same number of rounds, so the shuffles below see
  // the whole warp; rows past the slice are loaded as nothing
  for (long long base = s0; base < s1; base += (long long)NGRP * kUnroll) {
    uint4 kr[kUnroll][VPL], vr[kUnroll][VPL];
    int pos[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long idx = base + (long long)u * NGRP + grp;
      in[u] = idx < s1;
      pos[u] = in[u] ? __ldg(pb + idx) : 0;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const size_t off = (size_t)idx * D + (sub + LPK * j) * VEC;
        kr[u][j] = in[u] ? __ldg(reinterpret_cast<const uint4*>(kb + off))
                         : make_uint4(0, 0, 0, 0);
        vr[u][j] = in[u] ? __ldg(reinterpret_cast<const uint4*>(vb + off))
                         : make_uint4(0, 0, 0, 0);
      }
    }
    float s[kUnroll][GM];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[EPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j) unpack16(kr[u][j], &kf[j * VEC], T());
      const int dp = qp - pos[u];
      const bool ok = dp >= 0 && (a.window == 0 || dp < a.window);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qf[g][e], kf[e], dot);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        // a slot past the slice is no slot at all (weight exactly 0); a
        // masked slot takes the reference's finite -1e30
        s[u][g] = !in[u] ? -INFINITY : (ok ? dot : kNegInf);
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) mx = fmaxf(mx, s[u][g]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      m[g] = m_new;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[EPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j) unpack16(vr[u][j], &vf[j * VEC], T());
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float p = expf(s[u][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // fold the block's lane groups, then write this split's partial
  __shared__ float sm_ml[NGRP][GM][2];
  __shared__ float sm_acc[NGRP][GM][D];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (sub == 0) {
      sm_ml[grp][g][0] = m[g];
      sm_ml[grp][g][1] = l[g];
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[grp][g][(sub + LPK * j) * VEC + e] = acc[g][j * VEC + e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < GM * D; t += kThreads) {
    const int g = t / D, d = t % D;
    if (g0 + g >= a.g) continue;
    float mm = sm_ml[0][g][0];
    for (int i = 1; i < NGRP; ++i) mm = fmaxf(mm, sm_ml[i][g][0]);
    float ll = 0.f, aa = 0.f;
    for (int i = 0; i < NGRP; ++i) {
      const float w = expf(sm_ml[i][g][0] - mm);
      ll = fmaf(sm_ml[i][g][1], w, ll);
      aa = fmaf(sm_acc[i][g][d], w, aa);
    }
    const size_t row = ((size_t)bh * a.n_splits + split) * a.g + g0 + g;
    a.part_acc[row * D + d] = aa;
    if (d == 0) {
      a.part_ml[row * 2] = mm;
      a.part_ml[row * 2 + 1] = ll;
    }
  }
}

// grid (B*KVH*G): folds the splits of one (b, kv head, query head) row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(Args a, int d_len) {
  const int row = blockIdx.x;   // (b * KVH + h) * G + g
  const int bh = row / a.g, g = row % a.g;
  const size_t first = (size_t)bh * a.n_splits * a.g + g;  // split 0
  float mm = kNegInf;
  for (int sp = 0; sp < a.n_splits; ++sp)
    mm = fmaxf(mm, a.part_ml[(first + (size_t)sp * a.g) * 2]);
  for (int d = threadIdx.x; d < d_len; d += blockDim.x) {
    float ll = 0.f, aa = 0.f;
    for (int sp = 0; sp < a.n_splits; ++sp) {
      const size_t r = first + (size_t)sp * a.g;
      const float w = expf(a.part_ml[r * 2] - mm);
      ll = fmaf(a.part_ml[r * 2 + 1], w, ll);
      aa = fmaf(a.part_acc[r * d_len + d], w, aa);
    }
    store(static_cast<T*>(a.out) + (size_t)row * d_len + d,
          aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int D, int GM>
cudaError_t launch(const Args& a, int bh, cudaStream_t st) {
  const dim3 grid(bh, a.n_splits, (a.g + GM - 1) / GM);
  decode_partial_kernel<T, D, GM><<<grid, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<bh * a.g, kThreads, 0, st>>>(a, D);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_heads(const Args& a, int bh, cudaStream_t st) {
  if (a.g <= 1) return launch<T, D, 1>(a, bh, st);
  if (a.g <= 2) return launch<T, D, 2>(a, bh, st);
  if (a.g <= 4) return launch<T, D, 4>(a, bh, st);
  return launch<T, D, 8>(a, bh, st);
}

template <typename T>
cudaError_t by_dim(const Args& a, int d, int bh, cudaStream_t st) {
  switch (d) {
    case 32: return by_heads<T, 32>(a, bh, st);
    case 64: return by_heads<T, 64>(a, bh, st);
    case 128: return by_heads<T, 128>(a, bh, st);
    case 256: return by_heads<T, 256>(a, bh, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16. part_ml / part_acc are fp32 scratch of
// (B*KVH, n_splits, G, 2) and (B*KVH, n_splits, G, D) the wrapper allocates.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* part_ml, void* part_acc, void* out, int dtype,
    int b, int kvh, int g, long long s, int d, int n_splits, int window,
    void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_pos = static_cast<const int32_t*>(q_pos);
  a.kv_pos = static_cast<const int32_t*>(kv_pos);
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.out = out;
  a.kvh = kvh;
  a.g = g;
  a.s = s;
  a.n_splits = n_splits;
  a.chunk = (s + n_splits - 1) / n_splits;
  a.window = window;
  a.scale = (float)(1.0 / sqrt((double)d));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)by_dim<float>(a, d, b * kvh, st);
  if (dtype == 1) return (int)by_dim<__nv_bfloat16>(a, d, b * kvh, st);
  return (int)cudaErrorInvalidValue;
}
