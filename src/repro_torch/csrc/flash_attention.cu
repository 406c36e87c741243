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
// byte, far above the card's ~295. Two kernels:
//
// flash_wgmma_kernel, bf16 at every head dim (32, 64, 128 and 256), is
// built for the tensor cores' full rate, which only wgmma reaches. A block
// is three warpgroups. The first is the producer: it gives up registers
// (setmaxnreg) and one of its threads issues TMA loads
// (cp.async.bulk.tensor through a CUtensorMap, 128-byte swizzle, or
// 64-byte at head dim 32) of the Q tiles and of each K and V tile into a
// ring guarded by full and empty mbarriers, K's and V's apart, so loads
// run ahead of the products. Up to D 128 a tile has 128 keys and the ring
// three stages; at D 256, where a 128-key (K, V) stage would take 128 KiB
// of the 227, a tile has 64 keys and the ring two stages (64 KiB of Q and
// 128 KiB of K and V). The other two warpgroups are consumers with 240
// registers a thread; each owns 64 query rows: S = Q K^T by wgmma
// m64nBNk16 with both operands in shared memory, then P, rounded to bf16
// and packed from the score accumulator straight into A fragments, times V
// by wgmma with A from registers and V read as an MN-major (transposed)
// operand, at D 256 as two m64n128k16 products a k-step over O's two
// column halves (O is 128 registers a thread there). Tile j's S product is
// issued together with tile j - 1's P V, and tile j's softmax runs while
// that P V does (FlashAttention-3's intra-warpgroup overlap); a K tile is
// freed as soon as its S product is done, so with two stages the next K
// tile loads under the P V, and a V tile once its P V is done. The other
// consumer's products fill the tensor cores meanwhile. The softmax takes
// exp2 on the special-function unit (ex2.approx.ftz) of the raw score
// scaled to log2 units by one FFMA.
// GQA: the 64-row units (query head g, query tile t) are numbered t * G +
// g and a work item is two neighbours, so at even G both consumers hold
// two heads of one kv head at the same positions and every K/V tile
// loaded serves both. Only tiles that some row of the item can see are
// loaded (the reference's block skip); a consumer skips a tile none of its
// rows can see, and masks only a tile that crosses the diagonal, a window
// edge or the end of the keys. Masked scores take a finite value (-2^100
// raw, kMaskRaw), so a row whose scores so far are all masked weighs them
// uniformly and the first real score washes them out (alpha = 0), as the
// reference's finite -1e30 does; keys past Skv, which TMA fills with
// zeros, take -inf (weight exactly 0). The grid is persistent, one block
// an SM; work items go out heaviest (latest query tiles) first, in a
// snake order over the blocks, and the producer loads the next item's Q
// and keys while the consumers write the last item's output.
//
// flash_fwd_kernel, float32 (whose tolerance the tensor cores' bf16 or TF32
// inputs would not meet), runs on the CUDA cores; bf16 reaches it only when
// the caller asks for that route (route 0, the wrapper's
// way="cuda_core"), to measure against. One block per (b, kv head, query
// head, tile of kBQ query rows), heavy (late) query tiles first. The block
// keeps its Q tile (pre-scaled, fp32) in shared memory and walks only the
// key tiles a row of it can reach; 256 threads each own a 4 x 4 block of
// the kBQ x kBK scores (float4 loads along D) and the matching 4 rows x
// D/16 columns of the output accumulator, with the online softmax (m, l)
// of its four rows in registers, reduced over the 16 lanes that share a
// row. Its probabilities stay in fp32.
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "error.cuh"
#include "hopper.cuh"

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

// ---- Hopper path: bf16, D in {32, 64, 128, 256}: TMA + wgmma ------------

namespace hop {

constexpr int kWG = 128;                 // threads a warpgroup
constexpr int kThreads = 3 * kWG;        // the producer and two consumers
constexpr int kRows = 64;                // query rows a consumer

// Shared memory: each consumer's Q tile, then STAGES (K, V) tiles of BN
// keys. A tile is stored in column panels of SW bytes a row (the TMA box's
// width, the swizzle span), each panel rows x SW bytes. Up to D 128 a tile
// has 128 keys and the ring three stages; at D 256 a (K, V) stage of 128
// keys would be 128 KiB, so a tile has 64 keys and the ring two stages:
// 64 KiB of Q and 128 KiB of K and V.
template <int D>
struct Layout {
  static constexpr int BN = D <= 128 ? 128 : 64;  // keys a tile
  static constexpr int STAGES = D <= 128 ? 3 : 2;  // (K, V) tiles in the ring
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;
  static constexpr int COLS = SW / 2;            // bf16 columns a panel
  static constexpr int KPP = SW / 32;            // k16 steps a panel
  static constexpr int PV_N = D < 128 ? D : 128; // columns of a P V wgmma
  static constexpr int Q_PANEL = kRows * SW;
  static constexpr int Q_BYTES = kRows * D * 2;
  static constexpr int KV_PANEL = BN * SW;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int KV_OFF = 2 * Q_BYTES;
  static constexpr int SMEM = KV_OFF + STAGES * 2 * KV_BYTES;
  static constexpr uint64_t MODE = SW == 128 ? 1 : 2;   // descriptor swizzle
  static_assert(SMEM + 1024 <= 232448, "over a block's shared memory");
};

struct Params {
  __nv_bfloat16* out;
  int g;          // query heads a kv head
  int sq, skv;
  int window;
  int n_units;    // units of a (b, kv head): ceil(Sq / kRows) * G
  int n_pairs;    // ceil(n_units / 2)
  int bh;         // B * KVH
  int n_items;    // n_pairs * bh
  float scale_log2;
};

// One consumer's 64 query rows: unit u = query tile * G + query head.
struct Unit {
  bool ok;        // u < n_units
  int g, q0;      // query head, first query row
  int lo, hi;     // positions of its first and last real row
  __device__ Unit(const Params& p, int u) {
    ok = u < p.n_units;
    g = u % p.g;
    q0 = (u / p.g) * kRows;
    lo = q0 + p.skv - p.sq;
    hi = min(q0 + kRows, p.sq) - 1 + p.skv - p.sq;
  }
  // keys [begin, end) that some row of the unit can see
  __device__ int begin(const Params& p) const {
    return p.window ? max(0, lo - p.window + 1) : 0;
  }
  __device__ int end(const Params& p) const { return min(p.skv, hi + 1); }
};

// The masked score, in raw (unscaled) units: a power of two, so that its
// product with the scale is exact and a row whose every score so far is
// masked gets exp2(mask * scale - mask * scale) = 1 for each, the uniform
// weights of the reference's finite -1e30; against any real score its
// weight is exp2(-2^100 * scale - m) = 0, as -1e30's is.
constexpr float kMaskRaw = -0x1p100f;

// mask the tile's raw scores where it crosses the diagonal, a window edge
// or the end of the keys (a fully visible tile is left as it is); a tile
// of BN keys, NS = BN / 2 scores a thread
template <int BN>
__device__ __forceinline__ void mask_scores(float* s, const Params& p,
                                            const Unit& u, int k0, int pos_a,
                                            int tig) {
  constexpr int NS = BN / 2;
  const bool visible = k0 + BN <= p.skv && k0 + BN - 1 <= u.lo &&
                       (p.window == 0 || u.hi - k0 < p.window);
  if (visible) return;
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    const int kpos = k0 + (e >> 2) * 8 + tig * 2 + (e & 1);
    const int dp = pos_a + (e & 2) * 4 - kpos;     // rows gid, gid + 8
    const bool ok = dp >= 0 && (p.window == 0 || dp < p.window);
    s[e] = kpos >= p.skv ? -INFINITY : (ok ? s[e] : kMaskRaw);
  }
}

// the online softmax's step over one tile of raw scores: the new row
// maxima (m, raw units), the rescale of the running sums (alpha), and the
// tile's probabilities exp2(s * scale - m * scale) (one FFMA and one ex2
// an element) in place of its scores, with their row sums (rs); rows gid
// and gid + 8
template <int NS>
__device__ __forceinline__ void softmax_step(float* s, float* m, float* alpha,
                                             float* rs, float scale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < NS; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float neg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = ex2((m[h] - m_new) * scale);
    m[h] = m_new;
    neg[h] = -m_new * scale;
    rs[h] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    s[e] = ex2(fmaf(s[e], scale, neg[(e >> 1) & 1]));
    rs[(e >> 1) & 1] += s[e];
  }
}

// P (rounded to bf16) as the A fragments of P V: 16 keys a k-step
template <int NS>
__device__ __forceinline__ void pack_p(const float* s, uint32_t (*pf)[4]) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    pf[j >> 1][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// S = Q K^T over one key tile: Q (64 x D) at qa, K (BN x D) at kb, both
// K-major in swizzled panels
template <int D>
__device__ __forceinline__ void issue_s(float* s, uint32_t qa, uint32_t kb) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<L::BN>::ss(
        s,
        make_desc(qa + (kk / L::KPP) * L::Q_PANEL + (kk % L::KPP) * 32, 16,
                  8 * L::SW, L::MODE),
        make_desc(kb + (kk / L::KPP) * L::KV_PANEL + (kk % L::KPP) * 32, 16,
                  8 * L::SW, L::MODE),
        kk);
  wg_commit();
}

// O += P V over one key tile: P in registers, V (BN x D) at vb read as an
// MN-major operand, 16 keys a k-step; at D 256 a k-step is two wgmmas of
// 128 columns, O's registers 0-63 over V's panels 0-1 and 64-127 over
// panels 2-3 (the column order of one m64n256 accumulator)
template <int D>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*pf)[4],
                                         uint32_t vb) {
  using L = Layout<D>;
#pragma unroll
  for (int kt = 0; kt < L::BN / 16; ++kt)
#pragma unroll
    for (int h = 0; h < D / L::PV_N; ++h)
      Wgmma<L::PV_N>::rs(
          o + h * (L::PV_N / 2), pf[kt],
          make_desc(vb + h * (L::PV_N / L::COLS) * L::KV_PANEL +
                        kt * 16 * L::SW,
                    L::KV_PANEL, 8 * L::SW, L::MODE));
  wg_commit();
}

// A work item: the pair of units n_pairs - 1 - j / BH (late query tiles
// first) of the (b, kv head) j % BH, and the key tiles of BN keys some row
// of it can see, [t_lo, t_lo + n_tiles).
template <int BN>
struct Item {
  int bh;
  Unit u0, u1;
  int t_lo, n_tiles;
  __device__ Item(const Params& p, int j)
      : bh(j % p.bh),
        u0(p, 2 * (p.n_pairs - 1 - j / p.bh)),
        u1(p, 2 * (p.n_pairs - 1 - j / p.bh) + 1) {
    const int begin = u1.ok ? min(u0.begin(p), u1.begin(p)) : u0.begin(p);
    const int end = u1.ok ? max(u0.end(p), u1.end(p)) : u0.end(p);
    t_lo = begin / BN;
    n_tiles = (end + BN - 1) / BN - t_lo;
  }
};

// Persistent: grid (min(items, SMs)), each block taking one item a round
// (item_of). Sq <= Skv; kThreads threads.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const Params p) {
  using L = Layout<D>;
  constexpr int BN = L::BN;
  constexpr int ST = L::STAGES;
  constexpr int NS = BN / 2;         // score registers a thread
  constexpr int NO = D / 2;          // output registers a thread
  extern __shared__ unsigned char smem_raw[];
  // q full, q empty, then a barrier a stage in each of: K full, V full,
  // K empty, V empty
  __shared__ __align__(8) uint64_t bars[2 + 4 * ST];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = smem_u32(&bars[0]), bar_q_empty = bar_q + 8;
  const uint32_t bar_k_full = bar_q + 16;
  const uint32_t bar_v_full = bar_k_full + 8 * ST;
  const uint32_t bar_k_empty = bar_v_full + 8 * ST;
  const uint32_t bar_v_empty = bar_k_empty + 8 * ST;

  // round k's item: blocks take the items in a snake order (k even: block
  // b the b-th of the round, k odd: the b-th from its end), which levels
  // the rounds' decreasing work across blocks
  auto item_of = [](int k) {
    return k * (int)gridDim.x +
           (k & 1 ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, 2 * kWG);          // every consumer thread
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k_full + 8 * s, 1);
      mbar_init(bar_v_full + 8 * s, 1);
      mbar_init(bar_k_empty + 8 * s, 2 * kWG);
      mbar_init(bar_v_empty + 8 * s, 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;                    // ring tiles so far
      for (int k = 0, j; (j = item_of(k)) < p.n_items; ++k) {
        const Item<BN> item(p, j);
        mbar_wait(bar_q_empty, (k & 1) ^ 1);  // the last item's Q is read
        mbar_expect_tx(bar_q, (item.u1.ok ? 2 : 1) * L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < D / L::COLS; ++c) {
          tma_load(base + c * L::Q_PANEL, &tq, bar_q, c * L::COLS,
                   item.u0.q0, item.bh * p.g + item.u0.g);
          if (item.u1.ok)
            tma_load(base + L::Q_BYTES + c * L::Q_PANEL, &tq, bar_q,
                     c * L::COLS, item.u1.q0, item.bh * p.g + item.u1.g);
        }
        for (int i = 0; i < item.n_tiles; ++i, ++it) {
          const int st = it % ST;
          const uint32_t phase = ((it / ST) & 1) ^ 1;
          const uint32_t kb = base + L::KV_OFF + st * 2 * L::KV_BYTES;
          const int k0 = (item.t_lo + i) * BN;
          // K and V of a stage are freed apart (K once S = Q K^T is done),
          // so the next K tile loads while this tile's P V runs
          mbar_wait(bar_k_empty + 8 * st, phase);
          mbar_expect_tx(bar_k_full + 8 * st, L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < D / L::COLS; ++c)
            tma_load(kb + c * L::KV_PANEL, &tk, bar_k_full + 8 * st,
                     c * L::COLS, k0, item.bh);
          mbar_wait(bar_v_empty + 8 * st, phase);
          mbar_expect_tx(bar_v_full + 8 * st, L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < D / L::COLS; ++c)
            tma_load(kb + L::KV_BYTES + c * L::KV_PANEL, &tv,
                     bar_v_full + 8 * st, c * L::COLS, k0, item.bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg - 1;
    const int t = threadIdx.x - wg * kWG;
    const int warp = t >> 5, lane = t & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const uint32_t qa = base + w * L::Q_BYTES;
    int it = 0;                      // ring tiles before this item's
    auto wait_k = [&](int i) {
      mbar_wait(bar_k_full + 8 * ((it + i) % ST), ((it + i) / ST) & 1);
    };
    auto wait_v = [&](int i) {
      mbar_wait(bar_v_full + 8 * ((it + i) % ST), ((it + i) / ST) & 1);
    };
    auto free_k = [&](int i) {
      mbar_arrive(bar_k_empty + 8 * ((it + i) % ST));
    };
    auto free_v = [&](int i) {
      mbar_arrive(bar_v_empty + 8 * ((it + i) % ST));
    };
    auto k_base = [&](int i) {
      return base + L::KV_OFF + ((it + i) % ST) * 2 * L::KV_BYTES;
    };
    auto skip = [&](int i) {         // a tile none of the unit's rows sees
      wait_k(i);
      wait_v(i);
      free_k(i);
      free_v(i);
    };

    for (int k = 0, j; (j = item_of(k)) < p.n_items; ++k) {
      const Item<BN> item(p, j);
      const Unit u = w ? item.u1 : item.u0;
      const int row_a = u.q0 + warp * 16 + gid;   // rows of o[4j + 0, 1];
      const int pos_a = row_a + p.skv - p.sq;     // row_a + 8: o[4j + 2, 3]
      // the item's tiles this unit sees: [first, last]; others skipped
      const int n_tiles = item.n_tiles;
      const int first = u.ok ? u.begin(p) / BN - item.t_lo : n_tiles;
      const int last = u.ok ? (u.end(p) - 1) / BN - item.t_lo : n_tiles - 1;

      mbar_wait(bar_q, k & 1);
      for (int i = 0; i < first; ++i) skip(i);   // before the window
      float o[NO];
#pragma unroll
      for (int e = 0; e < NO; ++e) o[e] = 0.f;
      float m[2] = {kMaskRaw, kMaskRaw};   // raw units
      float l[2] = {0.f, 0.f};           // this lane's share of row sums
      if (first <= last) {
        float s[NS], alpha[2], rs[2];
        uint32_t pf[BN / 16][4];
        wait_k(first);
        wg_fence();
        issue_s<D>(s, qa, k_base(first));
        wg_wait<0>();
#pragma unroll
        for (int e = 0; e < NS; ++e) reg_fence(s[e]);
        free_k(first);
        mask_scores<BN>(s, p, u, (item.t_lo + first) * BN, pos_a, tig);
        softmax_step<NS>(s, m, alpha, rs, p.scale_log2);
        l[0] = rs[0];
        l[1] = rs[1];
        pack_p<NS>(s, pf);
        // tile i's scores are formed while tile i - 1's P V runs; its
        // softmax runs under that product too
        for (int i = first + 1; i <= last; ++i) {
          wait_k(i);
          wait_v(i - 1);
          wg_fence();
          issue_s<D>(s, qa, k_base(i));
          issue_pv<D>(o, pf, k_base(i - 1) + L::KV_BYTES);
          wg_wait<1>();
#pragma unroll
          for (int e = 0; e < NS; ++e) reg_fence(s[e]);
          free_k(i);
          mask_scores<BN>(s, p, u, (item.t_lo + i) * BN, pos_a, tig);
          softmax_step<NS>(s, m, alpha, rs, p.scale_log2);
          wg_wait<0>();
#pragma unroll
          for (int e = 0; e < NO; ++e) reg_fence(o[e]);
#pragma unroll
          for (int jj = 0; jj < BN / 16; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) reg_fence_u(pf[jj][e]);
          free_v(i - 1);
#pragma unroll
          for (int e = 0; e < NO; ++e) o[e] *= alpha[(e >> 1) & 1];
          l[0] = l[0] * alpha[0] + rs[0];
          l[1] = l[1] * alpha[1] + rs[1];
          pack_p<NS>(s, pf);
        }
        wait_v(last);
        wg_fence();
        issue_pv<D>(o, pf, k_base(last) + L::KV_BYTES);
        wg_wait<0>();
#pragma unroll
        for (int e = 0; e < NO; ++e) reg_fence(o[e]);
        free_v(last);
      }
      for (int i = last + 1; i < n_tiles; ++i) skip(i);   // past the diagonal
      mbar_arrive(bar_q_empty);       // the next item's Q may come in
      it += n_tiles;

      if (u.ok) {
        // the row sums are split over the four lanes of a row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
          l[h] = 1.f / fmaxf(l[h], 1e-30f);
        }
        __nv_bfloat16* ob =
            p.out + ((size_t)item.bh * p.g + u.g) * (size_t)p.sq * D;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_a + h * 8;
          if (row >= p.sq) continue;
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D +
                                               jj * 8 + tig * 2) =
                __floats2bfloat162_rn(o[4 * jj + 2 * h] * l[h],
                                      o[4 * jj + 2 * h + 1] * l[h]);
        }
      }
    }
  }
}

// a (planes, rows, D) bf16 tensor read in boxes of (COLS, box_rows, 1),
// swizzled as the wgmma descriptors expect; rows past the tensor read as 0
template <int D>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, long long planes,
                       long long rows, int box_rows) {
  using L = Layout<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int g, int sq, int skv, int window,
                   cudaStream_t st) {
  using L = Layout<D>;
  constexpr int bytes = L::SMEM + 1024;          // + the alignment slack
  cudaError_t err = set_smem_once<flash_wgmma_kernel<D>>(bytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  err = tensor_map<D>(&tq, q, (long long)bh * g, sq, kRows);
  if (err == cudaSuccess) err = tensor_map<D>(&tk, k, bh, skv, L::BN);
  if (err == cudaSuccess) err = tensor_map<D>(&tv, v, bh, skv, L::BN);
  if (err != cudaSuccess) return err;
  Params p;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.g = g;
  p.sq = sq;
  p.skv = skv;
  p.window = window;
  p.n_units = ((sq + kRows - 1) / kRows) * g;
  p.n_pairs = (p.n_units + 1) / 2;
  p.bh = bh;
  p.n_items = p.n_pairs * bh;
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  flash_wgmma_kernel<D><<<min(p.n_items, sms), kThreads, bytes, st>>>(
      tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace hop

// route 1: flash_wgmma_kernel (bf16 only), 0: flash_fwd_kernel; a route
// the dtype does not take is refused, never replaced by the other
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int g, int sq, int skv, int window, int route,
                   cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (route == 1)
      return hop::launch<D>(q, k, v, out, bh, g, sq, skv, window, st);
  }
  if (route != 0) return cudaErrorInvalidValue;
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  const cudaError_t err = set_smem_once<flash_fwd_kernel<T, D>>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh * g, (unsigned)((sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), g, sq, skv, window,
      (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(const void* q, const void* k, const void* v, void* out,
                   int bh, int g, int sq, int skv, int d, int window,
                   int route, cudaStream_t st) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, out, bh, g, sq, skv, window, route, st);
    case 64:
      return launch<T, 64>(q, k, v, out, bh, g, sq, skv, window, route, st);
    case 128:
      return launch<T, 128>(q, k, v, out, bh, g, sq, skv, window, route, st);
    case 256:
      return launch<T, 256>(q, k, v, out, bh, g, sq, skv, window, route, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16; route 0: CUDA cores, 1: tensor cores
// (bfloat16 only); 1 <= sq <= skv < 2^31
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int b, int kvh, int g, long long sq,
                                      long long skv, int d, int window,
                                      int route, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sq < 1 || sq > skv || skv > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)by_dim<float>(q, k, v, out, b * kvh, g, (int)sq, (int)skv, d,
                              window, route, st);
  if (dtype == 1)
    return (int)by_dim<__nv_bfloat16>(q, k, v, out, b * kvh, g, (int)sq,
                                      (int)skv, d, window, route, st);
  return (int)cudaErrorInvalidValue;
}
