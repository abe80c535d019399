// SSGD logistic-regression kernels for Hopper (sm_90a): the masked
// gradient sum over all rows (B6), over sampled row blocks (B1), over all
// rows with a Bernoulli mask drawn in the kernel (B5), T block-sampled
// SGD steps in one launch (B2), and B1's two halves for the
// tensor-parallel split (B3 forward, B4 backward).
//
// Replaces, in tpu_distalg/ops/pallas_kernels.py:
//   B6 fused_grad_sum           (body _grad_kernel)
//   B1 fused_grad_sum_gathered  (body _grad_kernel_gathered)
//   B2 fused_train_gathered     (body _train_kernel_gathered)
//   B5 fused_grad_sum_packed    (body _grad_kernel_packed)
//   B3 fused_forward_gathered   (body _fwd_kernel_gathered)
//   B4 fused_backward_gathered  (body _bwd_kernel_gathered)
// with their contracts (see tpu_distalg_torch/ops/ssgd_kernels.py):
//   * z = Σ_j x_j · w_j in float32, with w cast to X's element type first
//     (B2 also zeroes w at columns >= y_col, as its selector does);
//   * B6: resid = (σ(z) − y)·mask in float32;
//     B1/B2: resid = (σ(z) − x[y_col])·x[v_col], rounded to X's type;
//     B5: as B1 over every row, with x[v_col] replaced by
//     m = x[v_col]·[bits(row) < thresh], bits = the two threefry2x32 words
//     of the counter (0, row) under the key (key0, key1), xored: what
//     utils/prng.py's bits() gives element `row` under that key. The TPU
//     kernel draws from its on-core generator, whose bits exist nowhere
//     else; this mask depends on the key and the row alone, not on the grid;
//   * g = Σ_rows resid·x and count = Σ mask (or Σ x[v_col], Σ m) in float32;
//   * B3: zyv[i / P][i % P] = z, [P + i % P] = x[y_col], [2P + i % P] =
//     x[v_col] for sampled row i (row i % gbr of block ids[i / gbr]);
//     B4: g = Σ_i resid_i·x_i with resid_i = resid[i] rounded to X's type;
//   * B2 step: nb = max(count, 1); w_new = w − (η/nb)·g with g zeroed at
//     columns >= y_col; if α ≠ 0, w_new −= α·(w − center) with the w from
//     before the step; the next step's w cast to X's type comes from the
//     float32 master.
//
// The TPU kernels pack P rows per sublane row and use a block-diagonal
// selector matmul and a (P, P·D) accumulator folded afterwards, only to
// dodge TPU lane padding. The packed X2 (n/P, P·D) is, byte for byte, the
// row-major (n, D) augmented matrix, so these kernels read (n, D) rows
// directly; sampled block b is rows [b·gbr, (b+1)·gbr).
//
// What bounds them on the card: memory. Each sampled row is read once
// (D·2 bytes in bf16) for 4·D operations, far below the card's
// operations-per-byte balance. At the bench geometry (13 of 128 blocks of
// 8192 rows, D = 128, bf16) a step moves 27.3 MB: 8.1 µs at 3.35 TB/s. B5
// reads every row whatever the mask keeps: 268 MB there, 80 µs; it runs
// B1's row body and folds, and every lane of a row hashes the row's
// counter itself (about 110 integer operations beside the row's loads).
//
// Design.
//   * G lanes own one row, each a 16-byte vector (8 bf16 or 4 float) at a
//     time; rows are spread over the block's warps and U rows per lane
//     group are loaded before any is used, to keep loads in flight.
//     z is reduced within the lane group by a butterfly (every lane ends
//     with the same bits), and each lane keeps its columns' partial
//     gradient in registers.
//   * Determinism, no float atomics: a fixed split of the rows over the
//     blocks; each block reduces its warps in order and writes a partial
//     (D + 1 floats: the gradient and the count). B1 and B6 then sum the
//     partials in a second launch, in block order, with a fixed tree.
//   * B2 is one persistent cooperative launch for T steps, its grid no
//     larger than the co-resident block count. Every step: each block
//     writes its partial; grid-wide sync; one warp per column sums the
//     partials in block order and writes the step's (g, count); grid-wide
//     sync; every block reads that sum and applies the same update to its
//     own copy of the float32 master in shared memory, so all copies stay
//     equal bit for bit. The two syncs order every write of the partials
//     and of the sum against every read of the step before, so one buffer
//     of each serves all steps. (Every block summing all partials itself,
//     with one sync, measured slower: the partials are read once per
//     block.) skip_update drops the syncs, the sums and the update (the
//     gradient pass stays): the difference prices the update chain.
//   * Rows of more than 128 vectors (2048 bytes) do not fit a lane group's
//     registers. There B1, B5 and B2 take a wide body (wide_rows): a pass
//     gives each warp one row, which it reads in turns of 32 vectors
//     against w to find the residual; then every thread adds the pass's
//     rows, in row order, to the columns it owns of the block's partial,
//     summed in place in device memory (L2). B2 keeps one cooperative
//     launch and two grid syncs a step, each block's float32 master in
//     device memory beside the partials. Any width is taken.
//   * B6 up to d = 4096: one warp per row with scalar loads, each
//     lane owning the columns j ≡ lane (mod 32) of its warp's accumulator
//     in shared memory; the row is read twice, the second time from L1.
//     Wider: a pass that writes each row's residual (float32), then a pass
//     over (row chunk, column tile) blocks, each adding its chunk's rows
//     in row order, and reduce_partials over the chunks in a fixed order.
//   * B3 and B4 take rows of any width (the tp split exists for rows too
//     wide for one card's data-parallel layout): G = the least power of
//     two >= L (at most 32) lanes own a row, a lane one 16-byte vector.
//     B3 on rows of at most 32 vectors keeps its vector of w in
//     registers and holds 4 rows in flight; on longer rows a warp reads
//     a row in turns of 32 vectors against w cast to X's type in shared
//     memory. Each row's z is one lane group's fixed-order butterfly, so
//     B3's results do not depend on the grid. B4 gives each block one
//     column tile (G vectors) of one chunk of rows; a lane adds its rows
//     in row order, the block folds its lane groups and warps in a fixed
//     order and writes its partial, and a second launch adds the chunks'
//     partials in chunk order. Chunks come from the shapes alone
//     (ops/ssgd_kernels.py::tp_kernel_plan), so B4 replays bit for bit.
//     Both are bound by the bytes of the sampled rows, each read once.
// TMA, wgmma and a faster cross-block reduction are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kReduceThreads = 128;
constexpr int kB6Rows = 4;  // rows per warp per pass in B6
// rows each lane group loads before using any (U), for rows of at most
// 32 vectors (kU1) and of up to 128 (kU4): kU1 = 2 was the fastest of 2,
// 4, 8 and 16 for B2 at D = 128 bf16 on an H100 (a larger U costs
// occupancy through registers); kU4 is not tuned
constexpr int kU1 = 2;
constexpr int kU4 = 2;
// rows of more than this many 16-byte vectors (2048 bytes) take the wide
// body (wide_rows): their columns no longer fit a lane group's registers
constexpr int kMaxNarrowVectors = 32 * 4;
// B6 keeps 9 float32 rows of width d in shared memory up to this d; wider
// rows take two passes (resid_kernel, grad_cols_kernel)
constexpr int kMaxGradD = 4096;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // values per 16-byte vector
  __device__ static void unpack(const uint4& v, float (&o)[N]) {
    o[0] = __uint_as_float(v.x);
    o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z);
    o[3] = __uint_as_float(v.w);
  }
  __device__ static float scalar(const float* p) { return __ldg(p); }
  __device__ static float quant(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& v, float (&o)[N]) {
    // a bf16 is the high half of the float32 with the same value: the
    // element at the lower address is the low half of each 32-bit word
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float scalar(const __nv_bfloat16* p) {
    return __bfloat162float(p[0]);
  }
  __device__ static float quant(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// B5's row sampler: a row is kept iff its bits fall below thresh.
struct RowSampler {
  uint32_t key0, key1, thresh;
};

// threefry2x32 (20 rounds) of the counter (c0, c1) under (k0, k1): the two
// output words xored, as utils/prng.py's bits() combines them.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t c0, uint32_t c1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0 ^ x1;
}

// Rows one thread block works on: a U-unrolled pass covers
// kWarps · (32 / G) · U sampled rows.
template <int U>
__host__ __device__ inline int pass_rows(int G) {
  return kWarps * (32 / G) * U;
}

// Accumulate the sampled rows [r0, r1) into this lane's partial gradient.
// Sampled row i is row i % gbr of block ids[i / gbr]; a block id outside
// [0, n_blocks) contributes nothing. With SAMPLED (B5) sampled row i is row
// i itself, ids is not read, and the row's validity is zeroed unless `rs`
// keeps it. Every lane of the warp runs the same number of passes (the
// shuffles need the whole warp).
template <typename T, int VPL, int U, bool SAMPLED = false>
__device__ __forceinline__ void grad_rows(
    const T* __restrict__ X, const int* __restrict__ ids, int n_blocks,
    int gbr, int D, int L, int G, int y_col, int v_col,
    const float (&wq)[VPL][Vec<T>::N], int r0, int r1,
    float (&acc)[VPL][Vec<T>::N], float& cnt, RowSampler rs = {}) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G;
  const int li = lane % G;
  const int R = 32 / G;
  const int step = kWarps * R * U;
  for (int base = r0; base < r1; base += step) {
    uint4 raw[U][VPL];  // the loaded vectors, unpacked only when used
    float yv[U], vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + (u * kWarps + warp) * R + grp;
      bool ok = i < r1;
      long long prow = i;
      if (ok && !SAMPLED) {
        const int s = i / gbr;
        const int b = ids[s];
        ok = b >= 0 && b < n_blocks;
        prow = static_cast<long long>(b) * gbr + (i - s * gbr);
      }
      const T* row = X + prow * D;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int vi = li + G * k;
        raw[u][k] = ok && vi < L
                        ? __ldg(reinterpret_cast<const uint4*>(row + vi * N))
                        : make_uint4(0u, 0u, 0u, 0u);
      }
      yv[u] = ok ? Vec<T>::scalar(row + y_col) : 0.0f;
      vv[u] = ok ? Vec<T>::scalar(row + v_col) : 0.0f;
      if (SAMPLED && threefry_bits(rs.key0, rs.key1, 0u,
                                   static_cast<uint32_t>(i)) >= rs.thresh)
        vv[u] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[VPL][N];
#pragma unroll
      for (int k = 0; k < VPL; ++k) Vec<T>::unpack(raw[u][k], x[k]);
      float z = 0.0f;
#pragma unroll
      for (int k = 0; k < VPL; ++k)
#pragma unroll
        for (int e = 0; e < N; ++e) z = fmaf(x[k][e], wq[k][e], z);
      for (int o = G >> 1; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
      const float r = Vec<T>::quant((sigmoid(z) - yv[u]) * vv[u]);
#pragma unroll
      for (int k = 0; k < VPL; ++k)
#pragma unroll
        for (int e = 0; e < N; ++e) acc[k][e] = fmaf(r, x[k][e], acc[k][e]);
      cnt += vv[u];
    }
  }
}

// This lane's columns of w, cast to X's type; columns >= limit are 0.
template <typename T, int VPL>
__device__ __forceinline__ void load_wq(const float* w, int L, int G,
                                        int limit,
                                        float (&wq)[VPL][Vec<T>::N]) {
  constexpr int N = Vec<T>::N;
  const int li = (threadIdx.x & 31) % G;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int vi = li + G * k;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int j = vi * N + e;
      wq[k][e] = (vi < L && j < limit) ? Vec<T>::quant(w[j]) : 0.0f;
    }
  }
}

// Fold the lanes' partial sums into the block's (D + 1) partial, in a
// fixed order: lane groups by butterfly, then warps 0..kWarps-1.
template <typename T, int VPL>
__device__ __forceinline__ void block_partial(float (&acc)[VPL][Vec<T>::N],
                                              float cnt, int D, int L, int G,
                                              float* red, float* red_cnt,
                                              float* out) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < VPL; ++k)
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc[k][e] += __shfl_xor_sync(kFull, acc[k][e], o);
    cnt += __shfl_xor_sync(kFull, cnt, o);
  }
  if (lane < G) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int vi = lane + G * k;
      if (vi < L)
#pragma unroll
        for (int e = 0; e < N; ++e) red[warp * D + vi * N + e] = acc[k][e];
    }
  }
  if (lane == 0) red_cnt[warp] = cnt;
  __syncthreads();
  for (int j = threadIdx.x; j <= D; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += j < D ? red[w * D + j] : red_cnt[w];
    out[j] = s;
  }
}

// B1 and, with SAMPLED, B5, stage 1: each block's partial over its share of
// the sampled rows.
template <typename T, int VPL, int U, bool SAMPLED>
__global__ void __launch_bounds__(kThreads)
    grad_gathered_kernel(const T* __restrict__ X, const int* __restrict__ ids,
                         int n_blocks, int gbr, int D, int L, int G,
                         int y_col, int v_col, const float* __restrict__ w,
                         RowSampler rs, int chunk, int rows_total,
                         float* partial) {
  extern __shared__ float smem[];
  float* red = smem;
  float* red_cnt = smem + kWarps * D;
  float wq[VPL][Vec<T>::N];
  load_wq<T, VPL>(w, L, G, D, wq);
  float acc[VPL][Vec<T>::N] = {};
  float cnt = 0.0f;
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(r0 + chunk, rows_total);
  grad_rows<T, VPL, U, SAMPLED>(X, ids, n_blocks, gbr, D, L, G, y_col, v_col,
                                wq, r0, r1, acc, cnt, rs);
  block_partial<T, VPL>(acc, cnt, D, L, G, red, red_cnt,
                        partial + static_cast<size_t>(blockIdx.x) * (D + 1));
}

// Stage 2 of B1 and B6: out[j] = Σ_b partial[b][j] in a fixed order
// (contiguous runs per thread, then a fixed tree). One block per column.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials(const float* __restrict__ partial, int nblk, int width,
                    float* out) {
  __shared__ float sm[kReduceThreads];
  const int j = blockIdx.x;
  const int per = (nblk + kReduceThreads - 1) / kReduceThreads;
  const int b0 = threadIdx.x * per;
  const int b1 = min(b0 + per, nblk);
  float s = 0.0f;
  for (int b = b0; b < b1; ++b)
    s += partial[static_cast<size_t>(b) * width + j];
  sm[threadIdx.x] = s;
  __syncthreads();
  for (int o = kReduceThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) sm[threadIdx.x] += sm[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = sm[0];
}

// B2: T steps in one cooperative launch (see the header).
template <typename T, int VPL, int U>
__global__ void __launch_bounds__(kThreads)
    train_gathered_kernel(const T* __restrict__ X, const int* __restrict__ idx,
                          int T_steps, int n_s, int n_blocks, int gbr, int D,
                          int L, int G, int y_col, int v_col,
                          const float* __restrict__ w0,
                          const float* __restrict__ center, float eta,
                          float alpha, int skip_update, int chunk,
                          float* partial, float* w_out) {
  extern __shared__ float smem[];
  float* w_s = smem;                 // D: the float32 master
  float* g_s = w_s + D;              // D + 1: the step's gradient and count
  float* red = g_s + D + 1;          // kWarps · D
  float* red_cnt = red + kWarps * D; // kWarps
  cg::grid_group grid = cg::this_grid();
  const int W = D + 1;
  const int nb = gridDim.x;
  const int lane = threadIdx.x & 31;
  float* gsum = partial + static_cast<size_t>(nb) * W;  // W: the step's sum
  for (int j = threadIdx.x; j < D; j += kThreads) w_s[j] = w0[j];
  __syncthreads();
  float wq[VPL][Vec<T>::N];
  load_wq<T, VPL>(w_s, L, G, y_col, wq);
  const int rows_total = n_s * gbr;
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(r0 + chunk, rows_total);
  for (int t = 0; t < T_steps; ++t) {
    float acc[VPL][Vec<T>::N] = {};
    float cnt = 0.0f;
    grad_rows<T, VPL, U>(X, idx + static_cast<size_t>(t) * n_s, n_blocks,
                         gbr, D, L, G, y_col, v_col, wq, r0, r1, acc, cnt);
    block_partial<T, VPL>(acc, cnt, D, L, G, red, red_cnt,
                          partial + static_cast<size_t>(blockIdx.x) * W);
    if (skip_update) {
      __syncthreads();
      continue;
    }
    grid.sync();
    // one warp per column: lane l sums blocks l, l+32, … in order, then a
    // butterfly; the block owning column j writes g[j] once
    for (int j = blockIdx.x * kWarps + (threadIdx.x >> 5); j < W;
         j += nb * kWarps) {
      float s = 0.0f;
      for (int b = lane; b < nb; b += 32)
        s += __ldcg(partial + static_cast<size_t>(b) * W + j);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (lane == 0) gsum[j] = s;
    }
    grid.sync();
    for (int j = threadIdx.x; j < W; j += kThreads) g_s[j] = __ldcg(gsum + j);
    __syncthreads();
    const float coef = __fdiv_rn(eta, fmaxf(g_s[D], 1.0f));
    for (int j = threadIdx.x; j < D; j += kThreads) {
      const float w_old = w_s[j];
      const float g = j < y_col ? g_s[j] : 0.0f;
      float w_new = __fsub_rn(w_old, __fmul_rn(coef, g));
      if (alpha != 0.0f)
        w_new = __fsub_rn(w_new, __fmul_rn(alpha, __fsub_rn(w_old, center[j])));
      w_s[j] = w_new;
    }
    __syncthreads();
    load_wq<T, VPL>(w_s, L, G, y_col, wq);
  }
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < D; j += kThreads) w_out[j] = w_s[j];
}

// ---------------------------------------------- B1, B5, B2 on wide rows

// z of the row at `row` (L vectors), read by one warp in turns of 32
// vectors against w cast to X's type (zero at columns >= limit); every
// lane ends with the same bits.
template <typename T>
__device__ __forceinline__ float wide_z(const T* row, const float* w, int L,
                                        int limit) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  float z = 0.0f;
  for (int vi = lane; vi < L; vi += 32) {
    float x[N];
    Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(row) + vi), x);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int j = vi * N + e;
      z = fmaf(x[e], j < limit ? Vec<T>::quant(w[j]) : 0.0f, z);
    }
  }
  for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
  return z;
}

// The block's partial over the sampled rows [r0, r1) of rows too wide for
// registers: `part` (D + 1 floats in device memory, the gradient, then the
// count) is written whole. A pass takes one row a warp: each warp finds its
// row's residual, then every thread adds the pass's rows, in row order, to
// the columns it owns (vectors tid, tid + kThreads, …) of `part`, so every
// column is summed in row order: no atomics, no dependence on the timing.
// Row selection and the residual are grad_rows'.
template <typename T, bool SAMPLED>
__device__ void wide_rows(const T* __restrict__ X, const int* __restrict__ ids,
                          int n_blocks, int gbr, int D, int L, int y_col,
                          int v_col, const float* w, int limit, int r0,
                          int r1, float* part, RowSampler rs) {
  constexpr int N = Vec<T>::N;
  __shared__ float r_s[kWarps], v_s[kWarps];
  __shared__ long long row_s[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < D; j += kThreads) part[j] = 0.0f;
  float cnt = 0.0f;
  for (int base = r0; base < r1; base += kWarps) {
    const int i = base + warp;  // the same on every lane of the warp
    bool ok = i < r1;
    long long prow = i;
    if (ok && !SAMPLED) {
      const int s = i / gbr;
      const int b = ids[s];
      ok = b >= 0 && b < n_blocks;
      prow = static_cast<long long>(b) * gbr + (i - s * gbr);
    }
    float r = 0.0f, v = 0.0f;
    if (ok) {
      const T* row = X + prow * D;
      const float z = wide_z<T>(row, w, L, limit);
      v = Vec<T>::scalar(row + v_col);
      if (SAMPLED && threefry_bits(rs.key0, rs.key1, 0u,
                                   static_cast<uint32_t>(i)) >= rs.thresh)
        v = 0.0f;
      r = Vec<T>::quant((sigmoid(z) - Vec<T>::scalar(row + y_col)) * v);
    }
    if (lane == 0) {
      r_s[warp] = r;
      v_s[warp] = v;
      row_s[warp] = ok ? prow : -1;
    }
    __syncthreads();
    for (int vi = threadIdx.x; vi < L; vi += kThreads) {
      float a[N];
#pragma unroll
      for (int e = 0; e < N; ++e) a[e] = part[vi * N + e];
      for (int u = 0; u < kWarps; ++u) {
        if (row_s[u] < 0) continue;
        float x[N];
        Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(
                           X + row_s[u] * D) + vi), x);
#pragma unroll
        for (int e = 0; e < N; ++e) a[e] = fmaf(r_s[u], x[e], a[e]);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) part[vi * N + e] = a[e];
    }
    if (threadIdx.x == 0)
      for (int u = 0; u < kWarps; ++u) cnt += v_s[u];
    __syncthreads();  // the pass's rows are read before the next overwrites
  }
  if (threadIdx.x == 0) part[D] = cnt;
}

// B1 and, with SAMPLED, B5 on wide rows, stage 1.
template <typename T, bool SAMPLED>
__global__ void __launch_bounds__(kThreads)
    grad_wide_kernel(const T* __restrict__ X, const int* __restrict__ ids,
                     int n_blocks, int gbr, int D, int L, int y_col,
                     int v_col, const float* __restrict__ w, RowSampler rs,
                     int chunk, int rows_total, float* partial) {
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(r0 + chunk, rows_total);
  wide_rows<T, SAMPLED>(X, ids, n_blocks, gbr, D, L, y_col, v_col, w, D, r0,
                        r1, partial + static_cast<size_t>(blockIdx.x) * (D + 1),
                        rs);
}

// B2 on wide rows: train_gathered_kernel's steps and syncs, with each
// block's float32 master in device memory (wcopy, D floats a block) and
// its partial summed in place (wide_rows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    train_wide_kernel(const T* __restrict__ X, const int* __restrict__ idx,
                      int T_steps, int n_s, int n_blocks, int gbr, int D,
                      int L, int y_col, int v_col,
                      const float* __restrict__ w0,
                      const float* __restrict__ center, float eta,
                      float alpha, int skip_update, int chunk, float* partial,
                      float* wcopy, float* w_out) {
  cg::grid_group grid = cg::this_grid();
  const int W = D + 1;
  const int nb = gridDim.x;
  const int lane = threadIdx.x & 31;
  float* gsum = partial + static_cast<size_t>(nb) * W;  // W: the step's sum
  float* part = partial + static_cast<size_t>(blockIdx.x) * W;
  float* wb = wcopy + static_cast<size_t>(blockIdx.x) * D;
  for (int j = threadIdx.x; j < D; j += kThreads) wb[j] = w0[j];
  __syncthreads();
  const int rows_total = n_s * gbr;
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(r0 + chunk, rows_total);
  for (int t = 0; t < T_steps; ++t) {
    wide_rows<T, false>(X, idx + static_cast<size_t>(t) * n_s, n_blocks, gbr,
                        D, L, y_col, v_col, wb, y_col, r0, r1, part, {});
    if (skip_update) {
      __syncthreads();
      continue;
    }
    grid.sync();
    for (int j = blockIdx.x * kWarps + (threadIdx.x >> 5); j < W;
         j += nb * kWarps) {
      float s = 0.0f;
      for (int b = lane; b < nb; b += 32)
        s += __ldcg(partial + static_cast<size_t>(b) * W + j);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (lane == 0) gsum[j] = s;
    }
    grid.sync();
    const float coef = __fdiv_rn(eta, fmaxf(__ldcg(gsum + D), 1.0f));
    for (int j = threadIdx.x; j < D; j += kThreads) {
      const float w_old = wb[j];
      const float g = j < y_col ? __ldcg(gsum + j) : 0.0f;
      float w_new = __fsub_rn(w_old, __fmul_rn(coef, g));
      if (alpha != 0.0f)
        w_new = __fsub_rn(w_new, __fmul_rn(alpha, __fsub_rn(w_old, center[j])));
      wb[j] = w_new;
    }
    __syncthreads();
  }
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < D; j += kThreads) w_out[j] = wb[j];
}

// The geometry shared by B1 and B2: 16-byte vectors per row L, lanes per
// row G (a power of two), vectors per lane VPL.
struct Geometry {
  int L, G, vpl;
};

template <typename T>
bool geometry(int D, Geometry* g) {
  constexpr int N = Vec<T>::N;
  if (D < 1 || D % N) return false;
  g->L = D / N;
  if (g->L <= 32) {
    g->G = 1;
    while (g->G < g->L) g->G <<= 1;
    g->vpl = 1;
    return true;
  }
  g->G = 32;
  g->vpl = 4;
  return g->L <= 32 * 4;
}

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  return n;
}

// Rows per block: a multiple of the pass, so that at most `max_blocks`
// blocks cover rows_total.
int chunk_rows(int rows_total, int max_blocks, int pass) {
  int chunk = (rows_total + max_blocks - 1) / max_blocks;
  return (chunk + pass - 1) / pass * pass;
}

template <typename T, int VPL, int U, bool SAMPLED>
cudaError_t grad_gathered_v(const void* X, const int* ids, int n_s,
                            int n_blocks, int gbr, int D, const Geometry& g,
                            int y_col, int v_col, const float* w,
                            RowSampler rs, int max_blocks, float* partial,
                            float* out, cudaStream_t s) {
  const int rows_total = n_s * gbr;
  const int chunk = chunk_rows(rows_total, max_blocks, pass_rows<U>(g.G));
  const int nblk = (rows_total + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * (kWarps * D + kWarps);
  grad_gathered_kernel<T, VPL, U, SAMPLED><<<nblk, kThreads, smem, s>>>(
      static_cast<const T*>(X), ids, n_blocks, gbr, D, g.L, g.G, y_col, v_col,
      w, rs, chunk, rows_total, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<D + 1, kReduceThreads, 0, s>>>(partial, nblk, D + 1, out);
  return cudaGetLastError();
}

// B1 (ids of n_s blocks of gbr rows) or, with SAMPLED, B5 (ids unused, one
// "block" of all gbr = n rows, sampled by rs).
template <typename T, bool SAMPLED>
cudaError_t launch_grad_gathered(const void* X, const int* ids, int n_s,
                                 int n_blocks, int gbr, int D, int y_col,
                                 int v_col, const float* w, RowSampler rs,
                                 int max_blocks, float* partial, float* out,
                                 cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  if (D >= N && D % N == 0 && D / N > kMaxNarrowVectors) {
    const int rows_total = n_s * gbr;
    const int chunk = chunk_rows(rows_total, max_blocks, kWarps);
    const int nblk = (rows_total + chunk - 1) / chunk;
    grad_wide_kernel<T, SAMPLED><<<nblk, kThreads, 0, s>>>(
        static_cast<const T*>(X), ids, n_blocks, gbr, D, D / N, y_col, v_col,
        w, rs, chunk, rows_total, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    reduce_partials<<<D + 1, kReduceThreads, 0, s>>>(partial, nblk, D + 1,
                                                     out);
    return cudaGetLastError();
  }
  Geometry g;
  if (!geometry<T>(D, &g)) return cudaErrorInvalidValue;
  return g.vpl == 1
             ? grad_gathered_v<T, 1, kU1, SAMPLED>(X, ids, n_s, n_blocks, gbr,
                                                   D, g, y_col, v_col, w, rs,
                                                   max_blocks, partial, out,
                                                   s)
             : grad_gathered_v<T, 4, kU4, SAMPLED>(X, ids, n_s, n_blocks, gbr,
                                                   D, g, y_col, v_col, w, rs,
                                                   max_blocks, partial, out,
                                                   s);
}

template <typename T, int VPL, int U>
cudaError_t train_v(const void* X, const int* idx, int T_steps, int n_s,
                    int n_blocks, int gbr, int D, const Geometry& g,
                    int y_col, int v_col, const float* w0,
                    const float* center, float eta, float alpha,
                    int skip_update, int max_blocks, int device,
                    float* partial, float* w_out, cudaStream_t s) {
  auto kernel = train_gathered_kernel<T, VPL, U>;
  const size_t smem = sizeof(float) * (2 * D + 1 + kWarps * D + kWarps);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int resident = per_sm * sm_count(device);
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int rows_total = n_s * gbr;
  const int cap = max_blocks < resident ? max_blocks : resident;
  int chunk = chunk_rows(rows_total, cap, pass_rows<U>(g.G));
  const int nblk = (rows_total + chunk - 1) / chunk;
  const T* Xp = static_cast<const T*>(X);
  int L = g.L, G = g.G;
  void* args[] = {&Xp,    &idx,    &T_steps,     &n_s,   &n_blocks,
                  &gbr,   &D,      &L,           &G,     &y_col,
                  &v_col, &w0,     &center,      &eta,   &alpha,
                  &skip_update, &chunk, &partial, &w_out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(nblk), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t train_wide(const void* X, const int* idx, int T_steps, int n_s,
                       int n_blocks, int gbr, int D, int y_col, int v_col,
                       const float* w0, const float* center, float eta,
                       float alpha, int skip_update, int max_blocks,
                       int device, float* partial, float* wcopy,
                       float* w_out, cudaStream_t s) {
  auto kernel = train_wide_kernel<T>;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int resident = per_sm * sm_count(device);
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int rows_total = n_s * gbr;
  const int cap = max_blocks < resident ? max_blocks : resident;
  int chunk = chunk_rows(rows_total, cap, kWarps);
  const int nblk = (rows_total + chunk - 1) / chunk;
  const T* Xp = static_cast<const T*>(X);
  int L = D / Vec<T>::N;
  void* args[] = {&Xp,    &idx,    &T_steps,     &n_s,   &n_blocks,
                  &gbr,   &D,      &L,           &y_col, &v_col,
                  &w0,    &center, &eta,         &alpha, &skip_update,
                  &chunk, &partial, &wcopy,      &w_out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(nblk), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_train(const void* X, const int* idx, int T_steps, int n_s,
                         int n_blocks, int gbr, int D, int y_col, int v_col,
                         const float* w0, const float* center, float eta,
                         float alpha, int skip_update, int max_blocks,
                         int device, float* partial, float* wcopy,
                         float* w_out, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  if (D >= N && D % N == 0 && D / N > kMaxNarrowVectors)
    return train_wide<T>(X, idx, T_steps, n_s, n_blocks, gbr, D, y_col, v_col,
                         w0, center, eta, alpha, skip_update, max_blocks,
                         device, partial, wcopy, w_out, s);
  Geometry g;
  if (!geometry<T>(D, &g)) return cudaErrorInvalidValue;
  return g.vpl == 1
             ? train_v<T, 1, kU1>(X, idx, T_steps, n_s, n_blocks, gbr, D, g,
                                  y_col, v_col, w0, center, eta, alpha,
                                  skip_update, max_blocks, device, partial,
                                  w_out, s)
             : train_v<T, 4, kU4>(X, idx, T_steps, n_s, n_blocks, gbr, D, g,
                                  y_col, v_col, w0, center, eta, alpha,
                                  skip_update, max_blocks, device, partial,
                                  w_out, s);
}

// B6, stage 1: one warp per row, kB6Rows rows per warp per pass.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    grad_kernel(const T* __restrict__ X, const float* __restrict__ y,
                const float* __restrict__ mask, const float* __restrict__ w,
                int n, int d, int chunk, float* partial) {
  extern __shared__ float smem[];
  float* wq = smem;                   // d
  float* acc = smem + d;              // kWarps · d
  float* red_cnt = acc + kWarps * d;  // kWarps
  for (int j = threadIdx.x; j < d; j += kThreads) wq[j] = Vec<T>::quant(w[j]);
  for (int j = threadIdx.x; j < kWarps * d; j += kThreads) acc[j] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* mine = acc + warp * d;
  float cnt = 0.0f;
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long r1 = r0 + chunk < n ? r0 + chunk : n;
  for (long long base = r0; base < r1; base += kWarps * kB6Rows) {
    const long long i0 = base + warp * kB6Rows;
    float z[kB6Rows] = {};
    for (int j = lane; j < d; j += 32) {
      const float wj = wq[j];
#pragma unroll
      for (int u = 0; u < kB6Rows; ++u)
        if (i0 + u < r1)
          z[u] = fmaf(Vec<T>::scalar(X + (i0 + u) * d + j), wj, z[u]);
    }
    float r[kB6Rows];
#pragma unroll
    for (int u = 0; u < kB6Rows; ++u) {
      for (int o = 16; o > 0; o >>= 1) z[u] += __shfl_xor_sync(kFull, z[u], o);
      const bool ok = i0 + u < r1;
      const float m = ok ? mask[i0 + u] : 0.0f;
      r[u] = ok ? (sigmoid(z[u]) - y[i0 + u]) * m : 0.0f;
      cnt += m;
    }
    for (int j = lane; j < d; j += 32) {
      float a = mine[j];
#pragma unroll
      for (int u = 0; u < kB6Rows; ++u)
        if (i0 + u < r1)
          a = fmaf(r[u], Vec<T>::scalar(X + (i0 + u) * d + j), a);
      mine[j] = a;
    }
  }
  if (lane == 0) red_cnt[warp] = cnt;
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * (d + 1);
  for (int j = threadIdx.x; j <= d; j += kThreads) {
    float s = 0.0f;
    for (int w8 = 0; w8 < kWarps; ++w8)
      s += j < d ? acc[w8 * d + j] : red_cnt[w8];
    out[j] = s;
  }
}

// B6 on rows wider than kMaxGradD, pass 1: resid[i] = (σ(z_i) − y_i)·mask_i
// in float32, one warp a row (z as grad_kernel sums it: each lane its
// columns j ≡ lane (mod 32) in order, then a butterfly), grid-stride.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    resid_kernel(const T* __restrict__ X, const float* __restrict__ y,
                 const float* __restrict__ mask, const float* __restrict__ w,
                 int n, int d, float* __restrict__ resid) {
  const int lane = threadIdx.x & 31;
  for (long long i = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       i < n; i += static_cast<long long>(gridDim.x) * kWarps) {
    float z = 0.0f;
    for (int j = lane; j < d; j += 32)
      z = fmaf(Vec<T>::scalar(X + i * d + j), Vec<T>::quant(__ldg(w + j)), z);
    for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
    if (lane == 0) resid[i] = (sigmoid(z) - y[i]) * mask[i];
  }
}

// Pass 2: block (chunk, tile) sums resid·x over the chunk's rows, in row
// order, for the tile's kThreads columns (column d is the count Σ mask),
// and writes partial[chunk][tile's columns]; reduce_partials adds the
// chunks in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    grad_cols_kernel(const T* __restrict__ X, const float* __restrict__ mask,
                     const float* __restrict__ resid, int n, int d, int chunk,
                     float* __restrict__ partial) {
  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j > d) return;
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long r1 = r0 + chunk < n ? r0 + chunk : n;
  float a = 0.0f;
  if (j < d) {
#pragma unroll 4
    for (long long i = r0; i < r1; ++i)
      a = fmaf(__ldg(resid + i), Vec<T>::scalar(X + i * d + j), a);
  } else {
    for (long long i = r0; i < r1; ++i) a += __ldg(mask + i);
  }
  partial[static_cast<size_t>(blockIdx.x) * (d + 1) + j] = a;
}

template <typename T>
cudaError_t launch_grad_wide(const void* X, const float* y, const float* mask,
                             const float* w, int n, int d, int max_blocks,
                             float* partial, float* resid, float* out,
                             cudaStream_t s) {
  const int tiles = (d + 1 + kThreads - 1) / kThreads;
  const int want = max(1, max_blocks / tiles);
  const int chunk = (n + want - 1) / want;
  const int n_chunks = (n + chunk - 1) / chunk;
  const int n_grid = min(max_blocks, (n + kWarps - 1) / kWarps);
  resid_kernel<T><<<n_grid, kThreads, 0, s>>>(static_cast<const T*>(X), y,
                                              mask, w, n, d, resid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grad_cols_kernel<T><<<dim3(n_chunks, tiles), kThreads, 0, s>>>(
      static_cast<const T*>(X), mask, resid, n, d, chunk, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<d + 1, kReduceThreads, 0, s>>>(partial, n_chunks, d + 1,
                                                   out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grad(const void* X, const float* y, const float* mask,
                        const float* w, int n, int d, int max_blocks,
                        float* partial, float* resid, float* out,
                        cudaStream_t s) {
  if (d > kMaxGradD)
    return launch_grad_wide<T>(X, y, mask, w, n, d, max_blocks, partial,
                               resid, out, s);
  const int chunk = chunk_rows(n, max_blocks, kWarps * kB6Rows);
  const int nblk = (n + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * ((kWarps + 1) * d + kWarps);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(grad_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  grad_kernel<T><<<nblk, kThreads, smem, s>>>(static_cast<const T*>(X), y,
                                              mask, w, n, d, chunk, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<d + 1, kReduceThreads, 0, s>>>(partial, nblk, d + 1, out);
  return cudaGetLastError();
}

// ------------------------------------------------------------ B3 and B4

constexpr int kTpU = 4;  // rows a lane group holds in flight (B3, B4)

// Lanes that own a row of L vectors (tp_kernel_plan's G).
__host__ __device__ inline int tp_lanes(int L) {
  int G = 1;
  while (G < L && G < 32) G <<= 1;
  return G;
}

// Sampled row i (< 2^31, so 32-bit division) of the blocks `ids`: its
// row in X, or -1 when its block id lies outside [0, n_blocks).
__device__ __forceinline__ long long sampled_row(const int* ids, int n_blocks,
                                                 int gbr, int i) {
  const int s = i / gbr;
  const int b = ids[s];
  if (b < 0 || b >= n_blocks) return -1;
  return static_cast<long long>(b) * gbr + (i - s * gbr);
}

__device__ __forceinline__ void write_zyv(float* zyv, int P, int i, float z,
                                          float y, float v) {
  const int r = i / P;
  float* o = zyv + static_cast<long long>(r) * 3 * P + (i - r * P);
  o[0] = z;
  o[P] = y;
  o[2 * P] = v;
}

// B3 on rows of at most 32 vectors: G lanes a row, one vector a lane,
// kTpU rows in flight; a grid-stride loop over the sampled rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    forward_narrow_kernel(const T* __restrict__ X, const int* __restrict__ ids,
                          int n_blocks, int gbr, int L, int G, int y_col,
                          int v_col, int P, const float* __restrict__ w,
                          int rows_total, float* __restrict__ zyv) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int R = 32 / G;
  const int li = lane % G;
  const int D = L * N;
  float wq[N];
#pragma unroll
  for (int e = 0; e < N; ++e)
    wq[e] = li < L ? Vec<T>::quant(w[li * N + e]) : 0.0f;
  // rows_total < 2^31 and the grid is at most TP_MAX_FWD_BLOCKS blocks,
  // so base + kTpU · groups stays below 2^31 + 2^21
  const long long groups = static_cast<long long>(gridDim.x) * kWarps * R;
  const long long gid =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * R + lane / G;
  for (long long base = 0; base < rows_total; base += groups * kTpU) {
    uint4 raw[kTpU];
    float yv[kTpU], vv[kTpU];
#pragma unroll
    for (int u = 0; u < kTpU; ++u) {
      const long long i = base + u * groups + gid;
      const long long r =
          i < rows_total ? sampled_row(ids, n_blocks, gbr, static_cast<int>(i))
                         : -1;
      const T* row = X + (r < 0 ? 0 : r) * D;
      raw[u] = r >= 0 && li < L
                   ? __ldg(reinterpret_cast<const uint4*>(row + li * N))
                   : make_uint4(0u, 0u, 0u, 0u);
      yv[u] = r >= 0 && li == 0 ? Vec<T>::scalar(row + y_col) : 0.0f;
      vv[u] = r >= 0 && li == 0 ? Vec<T>::scalar(row + v_col) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kTpU; ++u) {
      float x[N];
      Vec<T>::unpack(raw[u], x);
      float z = 0.0f;
#pragma unroll
      for (int e = 0; e < N; ++e) z = fmaf(x[e], wq[e], z);
      for (int o = G >> 1; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
      const long long i = base + u * groups + gid;
      if (li == 0 && i < rows_total)
        write_zyv(zyv, P, static_cast<int>(i), z, yv[u], vv[u]);
    }
  }
}

// B3 on rows of more than 32 vectors: a warp a row, in turns of 32
// vectors, against w cast to X's type in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    forward_wide_kernel(const T* __restrict__ X, const int* __restrict__ ids,
                        int n_blocks, int gbr, int L, int y_col, int v_col,
                        int P, const float* __restrict__ w,
                        int rows_total, float* __restrict__ zyv) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float ws[];  // D: w cast to X's type
  const int D = L * N;
  for (int j = threadIdx.x; j < D; j += kThreads) ws[j] = Vec<T>::quant(w[j]);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * kWarps;
  for (int i = blockIdx.x * kWarps + (threadIdx.x >> 5); i < rows_total;
       i += nw) {
    const long long r = sampled_row(ids, n_blocks, gbr, i);
    float z = 0.0f;
    if (r >= 0) {
      const uint4* row = reinterpret_cast<const uint4*>(X + r * D);
#pragma unroll 4
      for (int vi = lane; vi < L; vi += 32) {
        float x[N];
        Vec<T>::unpack(__ldg(row + vi), x);
        const float* wv = ws + vi * N;
#pragma unroll
        for (int e = 0; e < N; ++e) z = fmaf(x[e], wv[e], z);
      }
    }
    for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
    if (lane == 0) {
      const T* row = X + (r < 0 ? 0 : r) * D;
      write_zyv(zyv, P, i, z, r >= 0 ? Vec<T>::scalar(row + y_col) : 0.0f,
                r >= 0 ? Vec<T>::scalar(row + v_col) : 0.0f);
    }
  }
}

// B4, stage 1: block (chunk, tile) adds resid·x over the chunk's rows for
// the tile's G vectors of columns, and writes partial[chunk][tile cols].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    backward_kernel(const T* __restrict__ X, const int* __restrict__ ids,
                    int n_blocks, int gbr, int L, int G,
                    const float* __restrict__ resid, int chunk,
                    int rows_total, float* __restrict__ partial) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[kWarps * 32 * N];  // each warp's tile of G·N sums
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int R = 32 / G;
  const int grp = lane / G;
  const int li = lane % G;
  const int D = L * N;
  const int vi = blockIdx.y * G + li;
  const bool col_ok = vi < L;
  // chunk · n_chunks < rows_total + chunk <= 2^31 + a pass (the wrapper)
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long r1 = r0 + chunk < rows_total ? r0 + chunk : rows_total;
  float acc[N] = {};
  for (long long base = r0; base < r1; base += kWarps * R * kTpU) {
    uint4 raw[kTpU];
    float rv[kTpU];
#pragma unroll
    for (int u = 0; u < kTpU; ++u) {
      const long long i = base + (u * kWarps + warp) * R + grp;
      const long long r =
          i < r1 ? sampled_row(ids, n_blocks, gbr, static_cast<int>(i)) : -1;
      raw[u] = r >= 0 && col_ok
                   ? __ldg(reinterpret_cast<const uint4*>(X + r * D + vi * N))
                   : make_uint4(0u, 0u, 0u, 0u);
      rv[u] = r >= 0 ? Vec<T>::quant(__ldg(resid + i)) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kTpU; ++u) {
      float x[N];
      Vec<T>::unpack(raw[u], x);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = fmaf(rv[u], x[e], acc[e]);
    }
  }
  // lane groups by butterfly, then warps 0..kWarps-1
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], o);
  if (lane < G)
#pragma unroll
    for (int e = 0; e < N; ++e) red[(warp * G + lane) * N + e] = acc[e];
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * D;
  for (int k = threadIdx.x; k < G * N; k += kThreads) {
    const int j = blockIdx.y * G * N + k;
    if (j < D) {
      float s = 0.0f;
      for (int w8 = 0; w8 < kWarps; ++w8) s += red[w8 * G * N + k];
      out[j] = s;
    }
  }
}

template <typename T>
cudaError_t launch_forward(const void* X, const int* ids, int n_s,
                           int n_blocks, int gbr, int D, int y_col, int v_col,
                           int P, const float* w, int n_grid, float* zyv,
                           cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  if (D % N) return cudaErrorInvalidValue;
  const int L = D / N;
  const int rows = n_s * gbr;  // < 2^31 (checked by the entry point)
  const T* Xp = static_cast<const T*>(X);
  if (L <= 32) {
    forward_narrow_kernel<T><<<n_grid, kThreads, 0, s>>>(
        Xp, ids, n_blocks, gbr, L, tp_lanes(L), y_col, v_col, P, w, rows,
        zyv);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(float) * D;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        forward_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  forward_wide_kernel<T><<<n_grid, kThreads, smem, s>>>(
      Xp, ids, n_blocks, gbr, L, y_col, v_col, P, w, rows, zyv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* X, const int* ids, int n_s,
                            int n_blocks, int gbr, int D, const float* resid,
                            int chunk, int n_chunks, float* partial,
                            float* out, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  if (D % N) return cudaErrorInvalidValue;
  const int L = D / N;
  const int G = tp_lanes(L);
  const int rows = n_s * gbr;  // < 2^31 (checked by the entry point)
  if (static_cast<long long>(chunk) * n_chunks < rows ||
      static_cast<long long>(chunk) * (n_chunks - 1) >= rows)
    return cudaErrorInvalidValue;
  const dim3 grid(n_chunks, (L + G - 1) / G);
  backward_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(X), ids, n_blocks, gbr, L, G, resid, chunk, rows,
      partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<D, kReduceThreads, 0, s>>>(partial, n_chunks, D, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// X element types: 0 = float32, 1 = bfloat16.

// The number of blocks B1 and B6 write partials for is at most
// max_blocks; `partial` holds max_blocks · (width + 1) floats and `out`
// width + 1 (the gradient, then the count). Returns a cudaError_t.

// B6: X (n, d), y and mask (n,), w (d,) float32; `resid` holds n floats
// (used when d > 4096).
int tda_ssgd_grad(const void* X, int dtype, const void* y, const void* mask,
                  const void* w, int n, int d, int max_blocks, void* partial,
                  void* resid, void* out, int device, void* stream) {
  if (n < 1 || d < 1 || max_blocks < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto launch = dtype == 0 ? launch_grad<float> : launch_grad<__nv_bfloat16>;
  return launch(X, static_cast<const float*>(y),
                static_cast<const float*>(mask), static_cast<const float*>(w),
                n, d, max_blocks, static_cast<float*>(partial),
                static_cast<float*>(resid), static_cast<float*>(out),
                static_cast<cudaStream_t>(stream));
}

// B1: X (n_blocks · gbr, D) row-major, ids (n_s,) int32, w (D,) float32.
int tda_ssgd_grad_gathered(const void* X, int dtype, const void* ids, int n_s,
                           int n_blocks, int gbr, int D, int y_col, int v_col,
                           const void* w, int max_blocks, void* partial,
                           void* out, int device, void* stream) {
  if (n_s < 1 || n_blocks < 1 || gbr < 1 || max_blocks < 1 ||
      static_cast<long long>(n_s) * gbr >= (1LL << 30) || y_col < 0 ||
      y_col >= D || v_col < 0 || v_col >= D || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto launch = dtype == 0 ? launch_grad_gathered<float, false>
                           : launch_grad_gathered<__nv_bfloat16, false>;
  return launch(X, static_cast<const int*>(ids), n_s, n_blocks, gbr, D, y_col,
                v_col, static_cast<const float*>(w), RowSampler{}, max_blocks,
                static_cast<float*>(partial), static_cast<float*>(out),
                static_cast<cudaStream_t>(stream));
}

// B5: X (n, D) row-major, w (D,) float32; row i is kept iff the threefry
// bits of counter (0, i) under (key0, key1) are below thresh.
int tda_ssgd_grad_packed(const void* X, int dtype, int n, int D, int y_col,
                         int v_col, const void* w, uint32_t key0,
                         uint32_t key1, uint32_t thresh, int max_blocks,
                         void* partial, void* out, int device, void* stream) {
  if (n < 1 || n >= (1 << 30) || max_blocks < 1 || y_col < 0 || y_col >= D ||
      v_col < 0 || v_col >= D || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto launch = dtype == 0 ? launch_grad_gathered<float, true>
                           : launch_grad_gathered<__nv_bfloat16, true>;
  return launch(X, nullptr, 1, 1, n, D, y_col, v_col,
                static_cast<const float*>(w), RowSampler{key0, key1, thresh},
                max_blocks, static_cast<float*>(partial),
                static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

// B2: idx (T, n_s) int32; w0, center and w_out (D,) float32; `partial`
// holds (max_blocks + 1) · (D + 1) floats, then max_blocks · D more for the
// blocks' masters on rows over 2048 bytes.
int tda_ssgd_train(const void* X, int dtype, const void* idx, int T_steps,
                   int n_s, int n_blocks, int gbr, int D, int y_col, int v_col,
                   const void* w0, const void* center, float eta, float alpha,
                   int skip_update, int max_blocks, void* partial, void* w_out,
                   int device, void* stream) {
  if (T_steps < 1 || n_s < 1 || n_blocks < 1 || gbr < 1 || max_blocks < 1 ||
      static_cast<long long>(n_s) * gbr >= (1LL << 30) || y_col < 0 ||
      y_col >= D || v_col < 0 || v_col >= D || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto launch = dtype == 0 ? launch_train<float> : launch_train<__nv_bfloat16>;
  return launch(X, static_cast<const int*>(idx), T_steps, n_s, n_blocks, gbr,
                D, y_col, v_col, static_cast<const float*>(w0),
                static_cast<const float*>(center), eta, alpha, skip_update,
                max_blocks, device, static_cast<float*>(partial),
                static_cast<float*>(partial) +
                    static_cast<size_t>(max_blocks + 1) * (D + 1),
                static_cast<float*>(w_out), static_cast<cudaStream_t>(stream));
}

// B3: X (n_blocks · gbr, D) row-major, ids (n_s,) int32, w (D,) float32,
// zyv (n_s · gbr / P, 3P) float32; n_grid blocks.
int tda_ssgd_forward_gathered(const void* X, int dtype, const void* ids,
                              int n_s, int n_blocks, int gbr, int D,
                              int y_col, int v_col, int P, const void* w,
                              int n_grid, void* zyv, int device,
                              void* stream) {
  if (n_s < 1 || n_blocks < 1 || gbr < 1 || P < 1 || gbr % P ||
      n_grid < 1 || D < 1 || D > 32768 ||
      static_cast<long long>(n_s) * gbr >= (1LL << 31) || y_col < 0 ||
      y_col >= D || v_col < 0 || v_col >= D || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto launch = dtype == 0 ? launch_forward<float>
                           : launch_forward<__nv_bfloat16>;
  return launch(X, static_cast<const int*>(ids), n_s, n_blocks, gbr, D, y_col,
                v_col, P, static_cast<const float*>(w), n_grid,
                static_cast<float*>(zyv), static_cast<cudaStream_t>(stream));
}

// B4: X and ids as B3, resid (n_s · gbr,) float32 in sampled order;
// `partial` holds n_chunks · D floats, `out` D. The rows split into
// n_chunks chunks of `chunk` rows (the last may be shorter).
int tda_ssgd_backward_gathered(const void* X, int dtype, const void* ids,
                               int n_s, int n_blocks, int gbr, int D,
                               const void* resid, int chunk, int n_chunks,
                               void* partial, void* out, int device,
                               void* stream) {
  if (n_s < 1 || n_blocks < 1 || gbr < 1 || chunk < 1 || n_chunks < 1 ||
      n_chunks > 65535 * 32 || D < 1 || D > 32768 ||
      static_cast<long long>(n_s) * gbr >= (1LL << 31) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto launch = dtype == 0 ? launch_backward<float>
                           : launch_backward<__nv_bfloat16>;
  return launch(X, static_cast<const int*>(ids), n_s, n_blocks, gbr, D,
                static_cast<const float*>(resid), chunk, n_chunks,
                static_cast<float*>(partial), static_cast<float*>(out),
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
