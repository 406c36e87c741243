// Split-K decode attention (one query token per row against a ring-buffer
// KV cache) for Hopper (sm_90a), in fp32 or bf16 with fp32 accumulation.
//
// Replaces the TPU kernel
// repro/kernels/decode_attention/kernel.py::decode_attention_fwd (body
// _decode_kernel): q (B, KVH, G, D), k/v (B, KVH, S, D) in the model's
// kernel-native ring layout, q_pos (B,) and the stored-position plane
// kv_pos (B, S) int32 in; (B, KVH, G, D) in q's dtype out. K and V may be
// a kv-head range of a wider ring: their rows of S * D elements lie one
// after another within a batch row, and the batch rows kv_bs elements
// apart (KVH * S * D for a whole ring). With m_out / l_out given the call
// also writes each (row, kv head, query head)'s softmax partial: m, the
// largest masked score, and l, the sum of exp(score - m) over the ring's
// slots, and then writes the normalised output in fp32 (out_f32), so
// partials of ring blocks held apart combine exactly. A slot counts
// where 0 <= q_pos - kv_pos (< window when window > 0); never-written slots
// hold INF_POS and so are masked. Masked scores are the finite -1e30, as in
// the reference, so a row whose every slot is masked averages V uniformly
// (an empty ring, an inactive serving slot) instead of producing NaN.
//
// Bound: memory. A decode step needs K and V of the valid slots, 2 * D *
// sizeof(T) bytes each, and the position plane, for ~4 * G * D flops a
// slot: far below the card's ~295 flops a byte. Design: read only what the
// positions let through, in one launch.
// - A block owns one (b, kv head, group of GM query heads) row and one of
//   n_splits slices of it, and serves all its query heads from each K/V
//   row it reads (GQA reuse).
// - Positions first. Each block scans its batch row's position plane (4
//   bytes a slot, L2-resident after the first block) for the first and the
//   last valid slot. The splits divide only the tiles between them, so no
//   block is left with the empty tail of the ring. A row with no valid
//   slot at all is known here, and then every tile's V is read (its output
//   is the uniform average) and no K. A scan in every block, rather than a
//   pre-pass launch, keeps the call one launch with no scratch written
//   between launches.
// - Tiles of TK slots (up to 16 KB of K and 16 KB of V) come in by 1-D
//   bulk copies (cp.async.bulk, completion on an mbarrier) into a ring of
//   kStages tiles, as many blocks an SM as fit (three at the path's 64 KB
//   ring), so a tile's copies run under the last tile's work. Warp 0
//   reads a tile's positions one tile ahead and ballots them into a mask;
//   a tile with no valid slot issues no copy (its barrier is arrived on
//   without bytes) and is skipped. Fewer, larger tiles won over 8 KB ones
//   in four stages: each tile costs a block barrier and a ballot.
// - Each group of lanes covering one row with 16-byte shared-memory reads
//   (16 lanes for a bf16 row of 128) keeps its own online-softmax state (m,
//   l, acc) in registers, fp32; a butterfly over the group's lanes
//   completes each dot product. The block folds its groups in shared
//   memory and writes one fp32 partial (m, l, acc) a query head.
// - The splits are folded in the same launch: each block takes a ticket in
//   a per-row counter after writing its partial; the last one folds all
//   partials, writes the output and resets the counter, so the counter is
//   zero between calls and under CUDA graph replay.
// - The library plans the call (decode_attention_plan): the splits of a
//   row are as many as keep every block of the call resident at once, from
//   the SM count and the blocks an SM holds; the host sizes the scratch
//   from the same plan. The tile size lives here only.
// - With a counter given, each block adds the bytes of the K/V copies it
//   issued (what its mbarriers expect), so a run can count on the card what
//   the kernel read.
// There is no sequential grid here, so the reference's carried VMEM
// scratch becomes the partials.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "error.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;         // tiles in the ring
constexpr int kTileBytes = 16384;  // K (or V) bytes a tile
constexpr int kMaxTile = 64;       // slots a tile at most (two ballots)

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

// `bytes` contiguous bytes global -> shared, counted on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* q_pos;
  const int32_t* kv_pos;
  float* part;      // (rows, n_splits, GM, D + 2): m, l, acc
  int* tickets;     // (rows,), zero between calls
  unsigned long long* copied;  // K/V bytes copied, summed; may be null
  void* out;
  float* m_out;     // (B, KVH, G) or null
  float* l_out;     // (B, KVH, G) or null
  long long kv_bs;  // elements between the batch rows of k and v
  int out_f32;      // out is fp32 (else q's type)
  int kvh;
  int g;
  int zs;           // z-slices of a kv head: ceil(G / GM)
  int s;            // ring slots
  int n_splits;
  int window;
  float scale;
};

template <typename T, int D, int GM>
struct Shape {
  static constexpr int ROW = D * (int)sizeof(T);             // bytes a slot
  static constexpr int TK =
      kTileBytes / ROW < kMaxTile ? kTileBytes / ROW : kMaxTile;
  static constexpr int BYTES = TK * ROW;                     // a K or V tile
  static constexpr int VEC = 16 / (int)sizeof(T);            // a 16-byte read
  static constexpr int NV = D / VEC;                         // reads a row
  static constexpr int LPK = NV < 32 ? NV : 32;              // lanes a row
  static constexpr int VPL = NV / LPK;                       // reads a lane
  static constexpr int EPL = VPL * VEC;                      // elements a lane
  static constexpr int NGRP = kWarps * (32 / LPK);           // lane groups
  static constexpr int U = TK / NGRP;                        // slots a group
  static constexpr int RING = kStages * 2 * BYTES;
  static constexpr int FOLD = NGRP * GM * (D + 2) * 4;       // group fold
  static constexpr int SMEM = RING > FOLD ? RING : FOLD;
  static_assert(U >= 1 && TK % NGRP == 0, "tile / lane-group mismatch");
};

// partial records a row: n_splits * GM * (D + 2) floats
template <int D, int GM>
__device__ __forceinline__ size_t part_floats(int n_splits) {
  return (size_t)n_splits * GM * (D + 2);
}

// grid (B * KVH * zs, n_splits); GM query heads a block
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(Args a) {
  using SH = Shape<T, D, GM>;
  constexpr int TK = SH::TK, VEC = SH::VEC, LPK = SH::LPK, VPL = SH::VPL;
  constexpr int EPL = SH::EPL, NGRP = SH::NGRP, U = SH::U;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ unsigned long long tile_mask[kStages];
  __shared__ int red[2][kWarps];
  __shared__ int last_block;

  const int row = blockIdx.x;              // (b * KVH + h) * zs + z
  const int split = blockIdx.y;
  const int bh = row / a.zs;
  const int g0 = (row % a.zs) * GM;
  const int b = bh / a.kvh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LPK;
  const int grp = warp * (32 / LPK) + lane / LPK;

  const size_t kv_off =
      (size_t)b * a.kv_bs + (size_t)(bh - b * a.kvh) * a.s * D;
  const T* kb = static_cast<const T*>(a.k) + kv_off;
  const T* vb = static_cast<const T*>(a.v) + kv_off;
  const int32_t* pb = a.kv_pos + (size_t)b * a.s;
  const int qp = a.q_pos[b];
  const uint32_t ring = smem_u32(smem);
  unsigned long long copied = 0;           // warp 0, lane 0: bytes issued

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // 1. the row's first and last valid slot
  int first = a.s, last = -1;
  auto see = [&](int pos, int i) {
    const int dp = qp - pos;
    if (dp >= 0 && (a.window == 0 || dp < a.window)) {
      first = min(first, i);
      last = max(last, i);
    }
  };
  if ((a.s & 3) == 0 && (reinterpret_cast<uintptr_t>(pb) & 15) == 0) {
    const int4* p4 = reinterpret_cast<const int4*>(pb);
#pragma unroll 4
    for (int i = tid; i < a.s / 4; i += kThreads) {
      const int4 v = __ldg(p4 + i);
      see(v.x, 4 * i);
      see(v.y, 4 * i + 1);
      see(v.z, 4 * i + 2);
      see(v.w, 4 * i + 3);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < a.s; i += kThreads) see(__ldg(pb + i), i);
  }
  first = __reduce_min_sync(0xffffffffu, first);
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) {
    red[0][warp] = first;
    red[1][warp] = last;
  }
  __syncthreads();                         // also publishes the barriers
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    first = min(first, red[0][w]);
    last = max(last, red[1][w]);
  }
  // with no valid slot, every tile is read for V (the uniform average)
  const bool any = last >= 0;
  const int t_lo = any ? first / TK : 0;
  const int t_hi = any ? last / TK : (a.s - 1) / TK;
  const int per = (t_hi - t_lo + a.n_splits) / a.n_splits;
  const int my_lo = t_lo + split * per;
  const int n = max(0, min(t_hi + 1, my_lo + per) - my_lo);

  // 2. warp 0: tile i's positions, then its copies into stage i % kStages.
  // The positions come in one tile ahead of the copies (fetch), so that
  // their latency hides under a tile's work.
  auto fetch = [&](int i, int* pos) {
    const int k0 = (my_lo + i) * TK;
    const int rows = min(TK, a.s - k0);
    pos[0] = lane < rows ? __ldg(pb + k0 + lane) : 0;
    pos[1] = 32 + lane < rows ? __ldg(pb + k0 + 32 + lane) : 0;
  };
  auto issue = [&](int i, const int* pos) {
    const int st = i % kStages;
    const int k0 = (my_lo + i) * TK;
    const int rows = min(TK, a.s - k0);
    unsigned long long mask;
    if (any) {
      const int d0 = qp - pos[0], d1 = qp - pos[1];
      const bool v0 =
          lane < rows && d0 >= 0 && (a.window == 0 || d0 < a.window);
      const bool v1 =
          32 + lane < rows && d1 >= 0 && (a.window == 0 || d1 < a.window);
      mask = (unsigned long long)__ballot_sync(0xffffffffu, v0) |
             ((unsigned long long)__ballot_sync(0xffffffffu, v1) << 32);
    } else {
      mask = rows == 64 ? ~0ull : (1ull << rows) - 1;
    }
    if (lane == 0) {
      tile_mask[st] = mask;
      const uint32_t bar = smem_u32(&full[st]);
      if (mask) {
        const uint32_t bytes = (uint32_t)rows * SH::ROW;
        const uint32_t dst = ring + st * 2 * SH::BYTES;
        mbar_expect_tx(bar, any ? 2 * bytes : bytes);
        copied += any ? 2 * bytes : bytes;
        if (any) bulk_load(dst, kb + (size_t)k0 * D, bytes, bar);
        bulk_load(dst + SH::BYTES, vb + (size_t)k0 * D, bytes, bar);
      } else {
        mbar_arrive(bar);                  // nothing to read: skip the tile
      }
    }
  };
  int pos[2];
  if (warp == 0) {
    for (int i = 0; i < min(n, kStages); ++i) {
      fetch(i, pos);
      issue(i, pos);
    }
    if (kStages < n) fetch(kStages, pos);
  }

  // this lane's elements of each query head: vectors sub + LPK * j
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * a.g * D;
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

  // 3. the tiles: scores, online softmax, P V
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    mbar_wait(smem_u32(&full[st]), (i / kStages) & 1);
    const unsigned long long mask = tile_mask[st];
    if (mask) {
      const T* ks = reinterpret_cast<const T*>(smem + st * 2 * SH::BYTES);
      const T* vs = ks + TK * D;
      float sc[U][GM];
      bool in[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = u * NGRP + grp;       // slot within the tile
        in[u] = (mask >> r) & 1;
        if (any) {
          float kf[EPL];
#pragma unroll
          for (int j = 0; j < VPL; ++j)
            unpack16(*reinterpret_cast<const uint4*>(
                         ks + r * D + (sub + LPK * j) * VEC),
                     &kf[j * VEC], T());
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) dot = fmaf(qf[g][e], kf[e], dot);
#pragma unroll
            for (int o = LPK / 2; o > 0; o >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, o);
            // a masked slot's weight exp(-1e30 - m) is 0 once the row has
            // a valid slot, as -inf's is
            sc[u][g] = in[u] ? dot : -INFINITY;
          }
        } else {
#pragma unroll
          for (int g = 0; g < GM; ++g) sc[u][g] = in[u] ? kNegInf : -INFINITY;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mx = sc[0][g];
#pragma unroll
        for (int u = 1; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = u * NGRP + grp;
        float vf[EPL];
#pragma unroll
        for (int j = 0; j < VPL; ++j)
          unpack16(*reinterpret_cast<const uint4*>(
                       vs + r * D + (sub + LPK * j) * VEC),
                   &vf[j * VEC], T());
#pragma unroll
        for (int e = 0; e < EPL; ++e) vf[e] = in[u] ? vf[e] : 0.f;
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float p = expf(sc[u][g] - m[g]);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();                       // every thread is done with st
    if (warp == 0 && i + kStages < n) {
      issue(i + kStages, pos);
      if (i + kStages + 1 < n) fetch(i + kStages + 1, pos);
    }
  }

  if (a.copied != nullptr && tid == 0) atomicAdd(a.copied, copied);

  // 4. fold the block's lane groups (over the ring, now idle) and write
  // this split's partial
  float* sm_acc = reinterpret_cast<float*>(smem);        // NGRP x GM x D
  float* sm_ml = sm_acc + NGRP * GM * D;                  // NGRP x GM x 2
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (sub == 0) {
      sm_ml[(grp * GM + g) * 2] = m[g];
      sm_ml[(grp * GM + g) * 2 + 1] = l[g];
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(grp * GM + g) * D + (sub + LPK * j) * VEC + e] =
            acc[g][j * VEC + e];
  }
  __syncthreads();
  float* part = a.part + (size_t)row * part_floats<D, GM>(a.n_splits) +
                (size_t)split * GM * (D + 2);
  for (int t = tid; t < GM * D; t += kThreads) {
    const int g = t / D, d = t % D;
    float mm = sm_ml[g * 2];
    for (int i = 1; i < NGRP; ++i) mm = fmaxf(mm, sm_ml[(i * GM + g) * 2]);
    float ll = 0.f, aa = 0.f;
    for (int i = 0; i < NGRP; ++i) {
      const float w = expf(sm_ml[(i * GM + g) * 2] - mm);
      ll = fmaf(sm_ml[(i * GM + g) * 2 + 1], w, ll);
      aa = fmaf(sm_acc[(i * GM + g) * D + d], w, aa);
    }
    part[g * (D + 2) + 2 + d] = aa;
    if (d == 0) {
      part[g * (D + 2)] = mm;
      part[g * (D + 2) + 1] = ll;
    }
  }

  // 5. the row's last block folds the splits and resets the ticket
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_block = atomicAdd(a.tickets + row, 1) == a.n_splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const float* rp = a.part + (size_t)row * part_floats<D, GM>(a.n_splits);
  constexpr int STRIDE = GM * (D + 2);     // one split's records
  for (int t = tid; t < GM * D; t += kThreads) {
    const int g = t / D, d = t % D;
    if (g0 + g >= a.g) continue;
    const float* pg = rp + g * (D + 2);
    float mm = kNegInf;
    for (int sp = 0; sp < a.n_splits; ++sp)
      mm = fmaxf(mm, __ldcg(pg + (size_t)sp * STRIDE));
    float ll = 0.f, aa = 0.f;
    for (int sp = 0; sp < a.n_splits; ++sp) {
      const float* r = pg + (size_t)sp * STRIDE;
      const float w = expf(__ldcg(r) - mm);
      ll = fmaf(__ldcg(r + 1), w, ll);
      aa = fmaf(__ldcg(r + 2 + d), w, aa);
    }
    const size_t head = (size_t)bh * a.g + g0 + g;
    const float o = aa / fmaxf(ll, 1e-30f);
    if (a.out_f32)
      static_cast<float*>(a.out)[head * D + d] = o;
    else
      store(static_cast<T*>(a.out) + head * D + d, o);
    if (d == 0 && a.m_out != nullptr) {
      a.m_out[head] = mm;
      a.l_out[head] = ll;
    }
  }
  if (tid == 0) a.tickets[row] = 0;
}

// one instantiation of the kernel: element type, head dim, query heads a
// block
template <typename T_, int D_, int GM_>
struct Inst {
  using T = T_;
  static constexpr int D = D_, GM = GM_;
};

// f(Inst<T, D, GM>{}) for the instantiation that serves (dtype, d, g)
template <typename T, int D, typename F>
cudaError_t by_heads(int g, F&& f) {
  if (g <= 1) return f(Inst<T, D, 1>{});
  if (g <= 2) return f(Inst<T, D, 2>{});
  if (g <= 4) return f(Inst<T, D, 4>{});
  return f(Inst<T, D, 8>{});
}

template <typename T, typename F>
cudaError_t by_dim(int d, int g, F&& f) {
  switch (d) {
    case 32: return by_heads<T, 32>(g, f);
    case 64: return by_heads<T, 64>(g, f);
    case 128: return by_heads<T, 128>(g, f);
    case 256: return by_heads<T, 256>(g, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t by_type(int dtype, int d, int g, F&& f) {
  if (dtype == 0) return by_dim<float>(d, g, f);
  if (dtype == 1) return by_dim<__nv_bfloat16>(d, g, f);
  return cudaErrorInvalidValue;
}

// plan[0..3]: splits of a row, ring slots a tile, rows (B * KVH * z-slices;
// one ticket each), scratch fp32 words
template <typename I>
cudaError_t plan(I, int bh, int g, long long s, long long* out) {
  using SH = Shape<typename I::T, I::D, I::GM>;
  const auto kernel = decode_attention_kernel<typename I::T, I::D, I::GM>;
  cudaError_t err =
      set_smem_once<decode_attention_kernel<typename I::T, I::D, I::GM>>(
          SH::SMEM);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, SH::SMEM);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)bh * ((g + I::GM - 1) / I::GM);
  const long long tiles = (s + SH::TK - 1) / SH::TK;
  long long splits = (long long)per_sm * sms / rows;
  splits = splits < tiles ? splits : tiles;
  splits = splits < 65535 ? (splits > 1 ? splits : 1) : 65535;
  out[0] = splits;
  out[1] = SH::TK;
  out[2] = rows;
  out[3] = rows * splits * I::GM * (I::D + 2) + rows;
  return cudaSuccess;
}

template <typename I>
cudaError_t launch(I, Args a, int bh, cudaStream_t st) {
  using SH = Shape<typename I::T, I::D, I::GM>;
  const auto kernel = decode_attention_kernel<typename I::T, I::D, I::GM>;
  const cudaError_t err =
      set_smem_once<decode_attention_kernel<typename I::T, I::D, I::GM>>(
          SH::SMEM);
  if (err != cudaSuccess) return err;
  a.zs = (a.g + I::GM - 1) / I::GM;
  const int rows = bh * a.zs;
  a.tickets = reinterpret_cast<int*>(
      a.part + (size_t)rows * a.n_splits * I::GM * (I::D + 2));
  kernel<<<dim3(rows, a.n_splits), kThreads, SH::SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16. The plan of a call on the current
// device into plan[0..3] (see plan above); asked once per shape.
extern "C" int decode_attention_plan(int dtype, int b, int kvh, int g,
                                     long long s, int d, long long* out) {
  if (s < 1 || s > 0x7fffffffLL || b < 1 || kvh < 1 || g < 1)
    return (int)cudaErrorInvalidValue;
  return (int)by_type(dtype, d, g, [&](auto inst) {
    return plan(inst, b * kvh, g, s, out);
  });
}

// scratch: fp32, zero-filled once, of the plan's size: rows * n_splits *
// GM * (D + 2) partial floats followed by one int32 ticket a row, which
// every call leaves zero again. Calls sharing one scratch must not
// overlap. copied: null, or an int64 to which each block adds the bytes of
// the K/V copies it issued. kv_bs: the elements between two batch rows of
// k (and v), at least KVH * S * D and a multiple of 16 bytes. m_out /
// l_out: both null, or (B, KVH, G) fp32 each for the softmax partials, and
// then out is fp32.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* scratch, void* copied, void* out, void* m_out,
    void* l_out, int dtype, int b, int kvh, int g, long long s, int d,
    long long kv_bs, int n_splits, int window, void* stream) {
  if (s < 1 || s > 0x7fffffffLL || n_splits < 1 || n_splits > 65535 ||
      kv_bs < (long long)kvh * s * d ||
      (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_pos = static_cast<const int32_t*>(q_pos);
  a.kv_pos = static_cast<const int32_t*>(kv_pos);
  a.part = static_cast<float*>(scratch);
  a.tickets = nullptr;
  a.copied = static_cast<unsigned long long*>(copied);
  a.out = out;
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.kv_bs = kv_bs;
  a.out_f32 = m_out != nullptr;
  a.kvh = kvh;
  a.g = g;
  a.zs = 1;
  a.s = (int)s;
  a.n_splits = n_splits;
  a.window = window;
  a.scale = (float)(1.0 / sqrt((double)d));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_type(dtype, d, g, [&](auto inst) {
    return launch(inst, a, b * kvh, st);
  });
}
