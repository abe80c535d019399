// SSGD logistic-regression kernels for Hopper (sm_90a): the masked
// gradient sum over all rows (B6), over sampled row blocks (B1), over all
// rows with a Bernoulli mask drawn in the kernel (B5), and T block-sampled
// SGD steps in one launch (B2).
//
// Replaces, in tpu_distalg/ops/pallas_kernels.py:
//   B6 fused_grad_sum           (body _grad_kernel)
//   B1 fused_grad_sum_gathered  (body _grad_kernel_gathered)
//   B2 fused_train_gathered     (body _train_kernel_gathered)
//   B5 fused_grad_sum_packed    (body _grad_kernel_packed)
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
//   * B6 takes any row width d: one warp per row with scalar loads, each
//     lane owning the columns j ≡ lane (mod 32) of its warp's accumulator
//     in shared memory; the row is read twice, the second time from L1.
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
cudaError_t launch_train(const void* X, const int* idx, int T_steps, int n_s,
                         int n_blocks, int gbr, int D, int y_col, int v_col,
                         const float* w0, const float* center, float eta,
                         float alpha, int skip_update, int max_blocks,
                         int device, float* partial, float* w_out,
                         cudaStream_t s) {
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

template <typename T>
cudaError_t launch_grad(const void* X, const float* y, const float* mask,
                        const float* w, int n, int d, int max_blocks,
                        float* partial, float* out, cudaStream_t s) {
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

}  // namespace

extern "C" {

const char* tda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// X element types: 0 = float32, 1 = bfloat16.

// The number of blocks B1 and B6 write partials for is at most
// max_blocks; `partial` holds max_blocks · (width + 1) floats and `out`
// width + 1 (the gradient, then the count). Returns a cudaError_t.

// B6: X (n, d), y and mask (n,), w (d,) float32.
int tda_ssgd_grad(const void* X, int dtype, const void* y, const void* mask,
                  const void* w, int n, int d, int max_blocks, void* partial,
                  void* out, int device, void* stream) {
  if (n < 1 || d < 1 || max_blocks < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto launch = dtype == 0 ? launch_grad<float> : launch_grad<__nv_bfloat16>;
  return launch(X, static_cast<const float*>(y),
                static_cast<const float*>(mask), static_cast<const float*>(w),
                n, d, max_blocks, static_cast<float*>(partial),
                static_cast<float*>(out), static_cast<cudaStream_t>(stream));
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
// holds (max_blocks + 1) · (D + 1) floats.
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
                static_cast<float*>(w_out), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
