// Flash attention for Hopper (sm_90a): one ring step of the forward (B11)
// and of the FlashAttention-2 recompute backward (B12).
//
// Replaces flash_attention_block (kernel _kernel) and
// flash_attention_backward_block (kernels _bwd_dq_kernel, _bwd_dkv_kernel)
// of tpu_distalg/ops/pallas_attention.py, with this contract (see
// tpu_distalg_torch/ops/attention_kernels.py):
//   * q, do (H, S_q, d); k, v (H_kv, S_kv, d); query head h reads KV head
//     h / (H / H_kv); the state o (H, S_q, d) and m, l, lse, delta (H, S_q)
//     float32, all row-major; S_kv a multiple of 64 (JAX's contract makes it
//     one of 128), any S_q (tail rows are masked);
//   * causality is positional: query row r sits at q_off + r, key c at
//     k_off + c, and r attends c iff q_off + r >= k_off + c. A tile whose
//     first query sits at or past its last key is "full" (no mask), a tile
//     wholly above the diagonal is skipped, the rest are masked with the
//     finite sentinel -1e30, and in masked tiles a row whose running max is
//     still at or below -5e29 adds nothing (alpha = p = 0), never exp(0);
//   * the forward folds the block into (o, m, l): m_new = max(m, rowmax s),
//     l = l·alpha + Σ p (p in float32), o = o·alpha + round(p)·V, with
//     s = (q·k)·scale; the backward recomputes p = exp(s − lse), dp = dO·Vᵀ,
//     ds = (p·(dp − delta))·scale, and dq = round(ds)·K,
//     dv = round(p)ᵀ·dO, dk = round(ds)ᵀ·Q;
//   * bf16 q, k, v: every tile product runs on the tensor cores
//     (mma.sync m16n8k16, bf16 operands, float32 accumulation); "round" is
//     to bf16, and a float32 dO is rounded to bf16 when it is staged, as the
//     TPU's MXU rounds float32 operands at default precision (ROADMAP C).
//     float32 q, k, v: every product runs in float32 on the CUDA cores, no
//     rounding anywhere (the port keeps TF32 off).
//
// What bounds it on the card: operations. At 32k tokens, 8 heads, d 128 the
// causal forward is 2.2e12 FLOP (2.2 ms at the bf16 tensor-core peak) over
// 0.2 GB of q, k, v and state.
//
// Design, simple first: one block of 4 warps (8 at d 256) per (head, 64
// query rows) for the forward and the dQ pass, per (KV head, 64 KV rows)
// for the dK/dV pass. A warp owns 16 rows and 128 output columns (at d 256
// two warps share 16 rows, each recomputing the same scores for its half of
// the columns, so the state is bitwise the same in both). The block stages
// each tile of K and V (the forward stores V transposed) or of Q and dO in
// shared memory with 16-byte loads, the warps run the tile products from
// shared memory, and P and dS pass through a per-warp shared tile (in the
// operand type, which is the rounding the contract asks for). The dK/dV
// pass walks (group member, query tile) in a fixed order and the dQ pass
// the KV tiles in order, all sums held in registers: no atomics, a replay
// is bitwise. The causal skip and full tests use the kernel's own tiles and
// the global offsets. Tiles are issued heaviest first. ldmatrix, cp.async,
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64;    // query rows a forward / dQ block
constexpr int kBKV = 64;   // KV rows a dK/dV block
constexpr int kBQI = 32;   // query rows a dK/dV step
constexpr int kDC = 128;   // output columns a warp
constexpr int kSmemLimit = 232448;

// KV rows a forward / dQ step: float32 at d 256 halves it to fit shared
// memory
template <typename T, int D>
__host__ __device__ constexpr int fwd_bkv() {
  return (sizeof(T) == 4 && D == 256) ? 32 : 64;
}

// padding of a shared row, in elements (16 bytes): rows then start 4 banks
// apart, so the fragment loads below are free of conflicts
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[NT][4] += A (16 × K) · B (K × 8·NT), in the m16n8 accumulator layout:
// lane 4g + t holds rows g, g + 8 and columns 8j + 2t, 8j + 2t + 1 of each
// 8-column tile j. A is row-major in shared memory (row stride lda); B's
// element (k, n) sits at B[n·ldb + k] when NK, else at B[k·ldb + n].
template <int NT, int K, bool NK>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const bf16* A,
                                         int lda, const bf16* B, int ldb,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    a[0] = ld_pair(A + g * lda + k0 + 2 * t);
    a[1] = ld_pair(A + (g + 8) * lda + k0 + 2 * t);
    a[2] = ld_pair(A + g * lda + k0 + 2 * t + 8);
    a[3] = ld_pair(A + (g + 8) * lda + k0 + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + g;
      uint32_t b0, b1;
      if (NK) {
        b0 = ld_pair(B + n * ldb + k0 + 2 * t);
        b1 = ld_pair(B + n * ldb + k0 + 2 * t + 8);
      } else {
        const bf16* c = B + (k0 + 2 * t) * ldb + n;
        b0 = pack(c[0], c[ldb]);
        b1 = pack(c[8 * ldb], c[9 * ldb]);
      }
      mma_bf16(acc[j], a, b0, b1);
    }
  }
}

// The same product in float32 on the CUDA cores, k in order.
template <int NT, int K, bool NK>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* A,
                                         int lda, const float* B, int ldb,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k];
    const float a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * t;
      const float b0 = NK ? B[n * ldb + k] : B[k * ldb + n];
      const float b1 = NK ? B[(n + 1) * ldb + k] : B[k * ldb + n + 1];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// Rows [row0, row0 + nrows) of a row-major (.., D) array into dst (row
// stride ld, type T), with 16-byte loads; rows at or past `valid` are zero.
template <typename T, typename TS, int D>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const TS* src,
                                           int row0, int nrows, int valid) {
  constexpr int V = 16 / sizeof(TS);
  constexpr int kPerRow = D / V;
  for (int e = threadIdx.x; e < nrows * kPerRow; e += blockDim.x) {
    const int r = e / kPerRow, c = (e % kPerRow) * V;
    T* out = dst + r * ld + c;
    if (r < valid) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + c));
      if constexpr (std::is_same<T, TS>::value) {
        *reinterpret_cast<uint4*>(out) = raw;
      } else {
        const TS* x = reinterpret_cast<const TS*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) out[i] = from_f<T>(to_f(x[i]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = from_f<T>(0.0f);
    }
  }
}

// Rows [row0, row0 + nrows) of a row-major (.., D) array, transposed into
// dst[c · ld + r].
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(T* dst, int ld, const T* src,
                                                 int row0, int nrows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kPerRow = D / V;
  for (int e = threadIdx.x; e < nrows * kPerRow; e += blockDim.x) {
    const int r = e / kPerRow, c = (e % kPerRow) * V;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
        src + static_cast<size_t>(row0 + r) * D + c));
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[(c + i) * ld + r] = x[i];
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Global position limits of a tile: skip when the last query row sits
// before the first key; full when the first query row sits at or past the
// last key.
__device__ __forceinline__ bool tile_dead(int q_last, int k_first) {
  return q_last < k_first;
}
__device__ __forceinline__ bool tile_full(int q_first, int k_last) {
  return q_first >= k_last;
}

// ------------------------------------------------------------------ B11

template <typename T, int D>
__host__ __device__ constexpr size_t fwd_smem() {
  constexpr int BKV = fwd_bkv<T, D>();
  constexpr int P = pad<T>();
  return sizeof(T) * (static_cast<size_t>(kBQ) * (D + P) +
                      static_cast<size_t>(BKV) * (D + P) +
                      static_cast<size_t>(D) * (BKV + P) +
                      static_cast<size_t>(4 * (D / kDC)) * 16 * (BKV + P));
}

template <typename T, int D>
__global__ void __launch_bounds__(128 * (D / kDC))
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ o0,
               const float* __restrict__ m0, const float* __restrict__ l0,
               float* __restrict__ o, float* __restrict__ m,
               float* __restrict__ l, int group, int s_q, int s_kv, int q_off,
               int k_off, float scale, int causal) {
  constexpr int BKV = fwd_bkv<T, D>();
  constexpr int P = pad<T>();
  constexpr int LD = D + P;     // Qs, Ks
  constexpr int LDV = BKV + P;  // Vt, Ps
  constexpr int NS = BKV / 8;   // 8-column tiles of a score row
  constexpr int NO = kDC / 8;   // 8-column tiles of a warp's output
  extern __shared__ uint4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Ks = Qs + kBQ * LD;
  T* Vt = Ks + BKV * LD;
  T* Ps = Vt + D * LDV;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp & 3, cw = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int hh = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int n_valid = min(kBQ, s_q - r0);
  const T* qh = q + static_cast<size_t>(hh) * s_q * D;
  const T* kh = k + static_cast<size_t>(hh / group) * s_kv * D;
  const T* vh = v + static_cast<size_t>(hh / group) * s_kv * D;
  T* Pw = Ps + warp * 16 * LDV;

  stage_rows<T, T, D>(Qs, LD, qh, r0, kBQ, n_valid);

  // the carried state of this lane's rows a = 16·rw + g and b = a + 8
  const int ra = r0 + 16 * rw + g, rb = ra + 8;
  const bool va = ra < s_q, vb = rb < s_q;
  const size_t sa = static_cast<size_t>(hh) * s_q + ra;
  const size_t sb = sa + 8;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = cw * kDC + 8 * j + 2 * t;
    acc[j][0] = va ? o0[sa * D + c] : 0.0f;
    acc[j][1] = va ? o0[sa * D + c + 1] : 0.0f;
    acc[j][2] = vb ? o0[sb * D + c] : 0.0f;
    acc[j][3] = vb ? o0[sb * D + c + 1] : 0.0f;
  }
  float m_a = va ? m0[sa] : -INFINITY, m_b = vb ? m0[sb] : -INFINITY;
  float l_a = va ? l0[sa] : 0.0f, l_b = vb ? l0[sb] : 0.0f;

  const int q_first = q_off + r0;
  const int q_last = q_off + r0 + n_valid - 1;
  int n_tiles = s_kv / BKV;
  if (causal) {
    const int live = q_last - k_off;  // keys [k_off, q_last] can be seen
    n_tiles = live < 0 ? 0 : min(n_tiles, live / BKV + 1);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k_first = k_off + jt * BKV;
    __syncthreads();  // the previous tile's reads are done
    stage_rows<T, T, D>(Ks, LD, kh, jt * BKV, BKV, BKV);
    stage_transposed<T, D>(Vt, LDV, vh, jt * BKV, BKV);
    __syncthreads();
    float s[NS][4];
    zero(s);
    warp_mma<NS, D, true>(s, Qs + 16 * rw * LD, LD, Ks, LD, lane);
    const bool full = !causal || tile_full(q_first, k_first + BKV - 1);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (!full) {
          const int qpos = q_off + (e < 2 ? ra : rb);
          const int kpos = k_first + 8 * j + 2 * t + (e & 1);
          if (qpos < kpos) x = kNeg;
        }
        s[j][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const bool live_a = full || mn_a > kNeg / 2;
    const bool live_b = full || mn_b > kNeg / 2;
    const float al_a = live_a ? expf(m_a - mn_a) : 0.0f;
    const float al_b = live_b ? expf(m_b - mn_b) : 0.0f;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = live_a ? expf(s[j][0] - mn_a) : 0.0f;
      const float p1 = live_a ? expf(s[j][1] - mn_a) : 0.0f;
      const float p2 = live_b ? expf(s[j][2] - mn_b) : 0.0f;
      const float p3 = live_b ? expf(s[j][3] - mn_b) : 0.0f;
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      T* pa = Pw + g * LDV + 8 * j + 2 * t;
      pa[0] = from_f<T>(p0);
      pa[1] = from_f<T>(p1);
      pa[8 * LDV] = from_f<T>(p2);
      pa[8 * LDV + 1] = from_f<T>(p3);
    }
    l_a = l_a * al_a + quad_sum(sum_a);
    l_b = l_b * al_b + quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= al_a;
      acc[j][1] *= al_a;
      acc[j][2] *= al_b;
      acc[j][3] *= al_b;
    }
    __syncwarp();
    warp_mma<NO, BKV, true>(acc, Pw, LDV, Vt + cw * kDC * LDV, LDV, lane);
    __syncwarp();  // P is read before the next tile overwrites it
  }

#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = cw * kDC + 8 * j + 2 * t;
    if (va) {
      o[sa * D + c] = acc[j][0];
      o[sa * D + c + 1] = acc[j][1];
    }
    if (vb) {
      o[sb * D + c] = acc[j][2];
      o[sb * D + c + 1] = acc[j][3];
    }
  }
  if (cw == 0 && t == 0) {
    if (va) {
      m[sa] = m_a;
      l[sa] = l_a;
    }
    if (vb) {
      m[sb] = m_b;
      l[sb] = l_b;
    }
  }
}

// ------------------------------------------------------------ B12, dQ

template <typename T, int D>
__host__ __device__ constexpr size_t dq_smem() {
  constexpr int BKV = fwd_bkv<T, D>();
  constexpr int P = pad<T>();
  return sizeof(T) * (static_cast<size_t>(2 * kBQ) * (D + P) +
                      static_cast<size_t>(2 * BKV) * (D + P) +
                      static_cast<size_t>(4 * (D / kDC)) * 16 * (BKV + P));
}

template <typename T, typename TD, int D>
__global__ void __launch_bounds__(128 * (D / kDC))
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const TD* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int group, int s_q, int s_kv, int q_off,
              int k_off, float scale, int causal) {
  constexpr int BKV = fwd_bkv<T, D>();
  constexpr int P = pad<T>();
  constexpr int LD = D + P;
  constexpr int LDP = BKV + P;
  constexpr int NS = BKV / 8;
  constexpr int NO = kDC / 8;
  extern __shared__ uint4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Ds = Qs + kBQ * LD;  // dO
  T* Ks = Ds + kBQ * LD;
  T* Vs = Ks + BKV * LD;
  T* Ps = Vs + BKV * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp & 3, cw = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int hh = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int n_valid = min(kBQ, s_q - r0);
  const size_t hrow = static_cast<size_t>(hh) * s_q;
  const T* kh = k + static_cast<size_t>(hh / group) * s_kv * D;
  const T* vh = v + static_cast<size_t>(hh / group) * s_kv * D;
  T* Pw = Ps + warp * 16 * LDP;

  stage_rows<T, T, D>(Qs, LD, q + hrow * D, r0, kBQ, n_valid);
  stage_rows<T, TD, D>(Ds, LD, dout + hrow * D, r0, kBQ, n_valid);
  const int ra = r0 + 16 * rw + g, rb = ra + 8;
  const bool va = ra < s_q, vb = rb < s_q;
  const float lse_a = va ? lse[hrow + ra] : 0.0f;
  const float lse_b = vb ? lse[hrow + rb] : 0.0f;
  const float dl_a = va ? delta[hrow + ra] : 0.0f;
  const float dl_b = vb ? delta[hrow + rb] : 0.0f;

  float acc[NO][4];
  zero(acc);
  const int q_first = q_off + r0;
  const int q_last = q_off + r0 + n_valid - 1;
  int n_tiles = s_kv / BKV;
  if (causal) {
    const int live = q_last - k_off;  // keys [k_off, q_last] can be seen
    n_tiles = live < 0 ? 0 : min(n_tiles, live / BKV + 1);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k_first = k_off + jt * BKV;
    __syncthreads();
    stage_rows<T, T, D>(Ks, LD, kh, jt * BKV, BKV, BKV);
    stage_rows<T, T, D>(Vs, LD, vh, jt * BKV, BKV, BKV);
    __syncthreads();
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    warp_mma<NS, D, true>(s, Qs + 16 * rw * LD, LD, Ks, LD, lane);
    warp_mma<NS, D, true>(dp, Ds + 16 * rw * LD, LD, Vs, LD, lane);
    const bool full = !causal || tile_full(q_first, k_first + BKV - 1);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool row_a = e < 2;
        const int kpos = k_first + 8 * j + 2 * t + (e & 1);
        const bool keep = (row_a ? va : vb) &&
                          (full || q_off + (row_a ? ra : rb) >= kpos);
        const float p =
            keep ? expf(s[j][e] * scale - (row_a ? lse_a : lse_b)) : 0.0f;
        const float ds = (p * (dp[j][e] - (row_a ? dl_a : dl_b))) * scale;
        Pw[(g + (row_a ? 0 : 8)) * LDP + 8 * j + 2 * t + (e & 1)] =
            from_f<T>(ds);
      }
    }
    __syncwarp();
    warp_mma<NO, BKV, false>(acc, Pw, LDP, Ks + cw * kDC, LD, lane);
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = cw * kDC + 8 * j + 2 * t;
    if (va) {
      dq[(hrow + ra) * D + c] = acc[j][0];
      dq[(hrow + ra) * D + c + 1] = acc[j][1];
    }
    if (vb) {
      dq[(hrow + rb) * D + c] = acc[j][2];
      dq[(hrow + rb) * D + c + 1] = acc[j][3];
    }
  }
}

// --------------------------------------------------------- B12, dK/dV

template <typename T, int D>
__host__ __device__ constexpr size_t dkv_smem() {
  constexpr int P = pad<T>();
  return sizeof(T) * (static_cast<size_t>(2 * kBKV) * (D + P) +
                      static_cast<size_t>(2 * kBQI) * (D + P) +
                      static_cast<size_t>(4 * (D / kDC)) * 16 * (kBQI + P)) +
         sizeof(float) * 2 * kBQI;
}

template <typename T, typename TD, int D>
__global__ void __launch_bounds__(128 * (D / kDC))
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const TD* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int group,
               int s_q, int s_kv, int q_off, int k_off, float scale,
               int causal) {
  constexpr int P = pad<T>();
  constexpr int LD = D + P;
  constexpr int LDP = kBQI + P;
  constexpr int NS = kBQI / 8;
  constexpr int NO = kDC / 8;
  extern __shared__ uint4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);
  T* Vs = Ks + kBKV * LD;
  T* Qs = Vs + kBKV * LD;
  T* Ds = Qs + kBQI * LD;  // dO
  T* Ps = Ds + kBQI * LD;
  float* lse_s = reinterpret_cast<float*>(Ps + 4 * (D / kDC) * 16 * LDP);
  float* dl_s = lse_s + kBQI;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp & 3, cw = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int hk = blockIdx.y;
  const int c0 = blockIdx.x * kBKV;  // heaviest (earliest keys) first
  const size_t kvrow = static_cast<size_t>(hk) * s_kv;
  T* Pw = Ps + warp * 16 * LDP;

  stage_rows<T, T, D>(Ks, LD, k + kvrow * D, c0, kBKV, kBKV);
  stage_rows<T, T, D>(Vs, LD, v + kvrow * D, c0, kBKV, kBKV);
  // this lane's KV rows a = 16·rw + g and b = a + 8, at global positions
  const int pos_a = k_off + c0 + 16 * rw + g, pos_b = pos_a + 8;
  const int k_first = k_off + c0, k_last = k_first + kBKV - 1;

  float acc_k[NO][4], acc_v[NO][4];
  zero(acc_k);
  zero(acc_v);
  const int n_q = (s_q + kBQI - 1) / kBQI;
  for (int gm = 0; gm < group; ++gm) {
    const size_t hrow = static_cast<size_t>(hk * group + gm) * s_q;
    for (int qi = 0; qi < n_q; ++qi) {
      const int r0 = qi * kBQI;
      const int n_valid = min(kBQI, s_q - r0);
      const int q_first = q_off + r0;
      if (causal && tile_dead(q_first + n_valid - 1, k_first))
        continue;  // uniform over the block
      __syncthreads();  // the previous step's reads are done
      stage_rows<T, T, D>(Qs, LD, q + hrow * D, r0, kBQI, n_valid);
      stage_rows<T, TD, D>(Ds, LD, dout + hrow * D, r0, kBQI, n_valid);
      for (int i = threadIdx.x; i < kBQI; i += blockDim.x) {
        lse_s[i] = i < n_valid ? lse[hrow + r0 + i] : 0.0f;
        dl_s[i] = i < n_valid ? delta[hrow + r0 + i] : 0.0f;
      }
      __syncthreads();
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for this warp's 16 KV rows
      float s[NS][4], dp[NS][4];
      zero(s);
      zero(dp);
      warp_mma<NS, D, true>(s, Ks + 16 * rw * LD, LD, Qs, LD, lane);
      warp_mma<NS, D, true>(dp, Vs + 16 * rw * LD, LD, Ds, LD, lane);
      const bool full = !causal || tile_full(q_first, k_last);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);  // query row in the step
          const bool keep = col < n_valid &&
                            (full || q_first + col >= (e < 2 ? pos_a : pos_b));
          s[j][e] = keep ? expf(s[j][e] * scale - lse_s[col]) : 0.0f;
          Pw[(g + (e < 2 ? 0 : 8)) * LDP + col] = from_f<T>(s[j][e]);
        }
      }
      __syncwarp();
      warp_mma<NO, kBQI, false>(acc_v, Pw, LDP, Ds + cw * kDC, LD, lane);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const float ds = (s[j][e] * (dp[j][e] - dl_s[col])) * scale;
          Pw[(g + (e < 2 ? 0 : 8)) * LDP + col] = from_f<T>(ds);
        }
      }
      __syncwarp();
      warp_mma<NO, kBQI, false>(acc_k, Pw, LDP, Qs + cw * kDC, LD, lane);
      __syncwarp();
    }
  }
  const size_t ra = kvrow + c0 + 16 * rw + g, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = cw * kDC + 8 * j + 2 * t;
    dk[ra * D + c] = acc_k[j][0];
    dk[ra * D + c + 1] = acc_k[j][1];
    dk[rb * D + c] = acc_k[j][2];
    dk[rb * D + c + 1] = acc_k[j][3];
    dv[ra * D + c] = acc_v[j][0];
    dv[ra * D + c + 1] = acc_v[j][1];
    dv[rb * D + c] = acc_v[j][2];
    dv[rb * D + c + 1] = acc_v[j][3];
  }
}

// ------------------------------------------------------------ launches

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* o0, const void* m0, const void* l0,
                       void* o, void* m, void* l, int h, int group, int s_q,
                       int s_kv, int q_off, int k_off, float scale,
                       int causal, cudaStream_t s) {
  if (s_kv % fwd_bkv<T, D>()) return cudaErrorInvalidValue;
  constexpr size_t smem = fwd_smem<T, D>();
  auto kernel = fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + kBQ - 1) / kBQ, h);
  kernel<<<grid, 128 * (D / kDC), smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(o0),
      static_cast<const float*>(m0), static_cast<const float*>(l0),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      group, s_q, s_kv, q_off, k_off, scale, causal);
  return cudaGetLastError();
}

template <typename T, typename TD, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, int h, int h_kv,
                       int s_q, int s_kv, int q_off, int k_off, float scale,
                       int causal, cudaStream_t s) {
  if (s_kv % fwd_bkv<T, D>() || s_kv % kBKV) return cudaErrorInvalidValue;
  const int group = h / h_kv;
  constexpr size_t smem_q = dq_smem<T, D>();
  auto kq = dq_kernel<T, TD, D>;
  cudaError_t err = allow_smem(kq, smem_q);
  if (err != cudaSuccess) return err;
  kq<<<dim3((s_q + kBQ - 1) / kBQ, h), 128 * (D / kDC), smem_q, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TD*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), group, s_q, s_kv, q_off, k_off, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem_kv = dkv_smem<T, D>();
  auto kkv = dkv_kernel<T, TD, D>;
  err = allow_smem(kkv, smem_kv);
  if (err != cudaSuccess) return err;
  kkv<<<dim3(s_kv / kBKV, h_kv), 128 * (D / kDC), smem_kv, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TD*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), group, s_q, s_kv,
      q_off, k_off, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int h, int h_kv, int s_q, int s_kv, int d) {
  return h < 1 || h > 65535 || h_kv < 1 || h % h_kv || s_q < 1 ||
         s_kv < 1 || (d != 128 && d != 256);
}

}  // namespace

extern "C" {

const char* tda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B11. q, k, v of one type (bf16 when is_bf16 != 0, else float32); o0, m0, l0
// the carried state, o, m, l the updated one (may alias the carry: a block
// reads its rows' carry before it writes them). Returns a cudaError_t.
int tda_flash_fwd(const void* q, const void* k, const void* v, const void* o0,
                  const void* m0, const void* l0, void* o, void* m, void* l,
                  int h, int h_kv, int s_q, int s_kv, int d, int q_off,
                  int k_off, float scale, int causal, int is_bf16,
                  int device, void* stream) {
  if (bad_shape(h, h_kv, s_q, s_kv, d))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = h / h_kv;
#define TDA_FWD(T, D)                                                     \
  launch_fwd<T, D>(q, k, v, o0, m0, l0, o, m, l, h, group, s_q, s_kv, q_off, \
                   k_off, scale, causal, s)
  if (is_bf16) return d == 128 ? TDA_FWD(bf16, 128) : TDA_FWD(bf16, 256);
  return d == 128 ? TDA_FWD(float, 128) : TDA_FWD(float, 256);
#undef TDA_FWD
}

// B12: the dQ pass, then the dK/dV pass, on one stream. q, k, v of one type
// (bf16 when is_bf16 != 0); dout float32, or bf16 when do_is_bf16 != 0 (only
// with bf16 q). lse, delta (H, S_q) float32; dq (H, S_q, d), dk, dv (H_kv, S_kv,
// d) float32, written whole. Returns a cudaError_t.
int tda_flash_bwd(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, void* dk, void* dv, int h, int h_kv, int s_q,
                  int s_kv, int d, int q_off, int k_off, float scale,
                  int causal, int is_bf16, int do_is_bf16, int device,
                  void* stream) {
  if (bad_shape(h, h_kv, s_q, s_kv, d) || (do_is_bf16 && !is_bf16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDA_BWD(T, TD, D)                                                   \
  launch_bwd<T, TD, D>(q, k, v, dout, lse, delta, dq, dk, dv, h, h_kv, s_q, \
                       s_kv, q_off, k_off, scale, causal, s)
  if (is_bf16 && do_is_bf16)
    return d == 128 ? TDA_BWD(bf16, bf16, 128) : TDA_BWD(bf16, bf16, 256);
  if (is_bf16)
    return d == 128 ? TDA_BWD(bf16, float, 128) : TDA_BWD(bf16, float, 256);
  return d == 128 ? TDA_BWD(float, float, 128) : TDA_BWD(float, float, 256);
#undef TDA_BWD
}

}  // extern "C"
