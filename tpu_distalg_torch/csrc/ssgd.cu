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
// B1's row body from device memory and folds, and every lane of a row hashes the row's
// counter itself (about 110 integer operations beside the row's loads).
//
// Design.
//   * B1 and B2 on rows of at most 2048 bytes run on a ring of shared-
//     memory stages fed by bulk copies. A block is 16 consumer warps and a
//     producer warp, at most one block per SM. One lane of the producer
//     cuts the block's sampled rows into stages of stage_rows rows (~16 KB)
//     and copies each into the next free slot with cp.async.bulk,
//     completing on the slot's mbarrier: a sampled block is contiguous in
//     X, so a stage is one copy, or one per sampled block it touches. A
//     block id outside [0, n_blocks) is not copied; the slot's mask marks
//     its rows absent. The consumers read x, y and v from the slot and
//     release it on its second mbarrier. The producer waits for free slots
//     only, so in B2 the next step's rows are in flight (up to 12 slots,
//     about 25 MB card-wide, nearly a step) while the update runs.
//   * Row body (B1, B2, and B5 from device memory): G lanes own one row,
//     each VPL 16-byte vectors (8 bf16 or 4 float each); z is reduced
//     within the lane group by a butterfly (every lane ends with the same
//     bits), and each lane keeps its columns' partial gradient in
//     registers (accumulate_rows). B1 and B2 give a lane 2 vectors (4 on
//     rows of more than 64), so that a row's scalar work (butterfly, σ,
//     rounding) is shared by 32 / G rows a warp instruction; G is a
//     template parameter, so the lane arithmetic folds away. Measured on
//     an H100, the consumers' arithmetic, not the copies, bounds a step.
//   * The plan (ops/ssgd_kernels.py::gathered_plan) depends on the shapes
//     and the SM count alone: blocks of `chunk` sampled rows, stages and
//     slots. B1 and B2 share it and the row body, so B2's step t equals
//     B1 called at B2's w_t bit for bit.
//   * Determinism, no float atomics: each block reduces its warps in order
//     and writes a partial (D + 1 floats: the gradient and the count);
//     fold_partials sums the blocks' partials in an order fixed by their
//     number and width.
//   * B1 is one launch: each block writes its partial, fences and takes a
//     ticket (an integer atomicAdd); the block with the last ticket folds
//     the partials, writes (g, count) and resets the ticket.
//   * B2 is one persistent cooperative launch for T steps with one
//     grid-wide barrier a step: an arrival counter that only the consumer
//     warps wait on (the last block to leave resets it). The partials are
//     double-buffered by step parity, so a fast block writes step t + 1's
//     while a slow one still reads step t's; after the barrier every block
//     folds all partials itself in the same order (so every copy of w gets
//     the same bits) and applies the update to its float32 master in
//     shared memory. skip_update drops the barrier, the fold and the update
//     (the gradient pass stays): the difference prices the update chain.
//   * B5 keeps the row body with rows read from device memory (U rows a
//     lane group in flight), block partials and reduce_partials.
//   * Rows of more than 128 vectors (2048 bytes) do not fit a lane group's
//     registers. B1 and B2 take them, up to kWideMaxVectors vectors (32
//     KB; 16,384 bf16 columns), on the same ring with a wide consumer
//     body (wide_ring_body): the producer, slots, masks and barriers are
//     the narrow ring's, so each sampled row is read from device memory
//     once, by a bulk copy, and the next step's rows load while a step's
//     fold and update run. Stages are whole rows, about 16 KB (4 rows at
//     epsilon's 4,016 bytes). The consumers take a round of consecutive
//     stages (at most one row a warp, at most half the slots): each warp
//     sums its row's z from the slot against w cast to X's type, which
//     sits in shared memory as a row of X's type beside the float32
//     master; then each thread adds the round's rows, in row order, into
//     the 16-byte column vectors it owns of the block's partial (k,
//     k + 512, …), which stay in its registers for the whole step. (Owned
//     columns summing z as well, reduced across the block, ran twice as
//     slow at epsilon's 251 vectors a row on an H100: half the threads
//     own none.) So a row crosses shared memory twice and device memory
//     once, and the partial reaches device memory once a step (D + 1
//     floats a block, double-buffered by step parity). The fold
//     (wide_fold) sums the blocks' partials over S = min(16, blocks)
//     slices in an order fixed by the block count: B2 spreads it over the
//     blocks (block k folds its share of the columns, about 1 MB read a
//     step card-wide) between two of the ring's arrival-counter barriers,
//     then every block updates its float32 master in shared memory from
//     the step's sum and recasts w; B1 folds in the last block to
//     take its ticket, the ring serving as scratch. B1 and B2 share the
//     plan, the body and the fold, so B2's step t equals B1 at B2's w_t
//     bit for bit here too. Measured on an H100 at epsilon's shape, the
//     consumers bound it, as they bound the narrow ring: with the copies
//     taken out, 125 steps without the update take 7.42 ms against 7.60.
//   * Rows wider than the wide ring takes keep the wide body (wide_rows),
//     as B5 does at every width over 2048 bytes: a pass gives each warp
//     one row, which it reads in turns of 32 vectors against w to find
//     the residual; then every thread adds the pass's rows, in row order,
//     to the columns it owns of the block's partial, summed in place in
//     device memory (L2). B1 and B5 add the partials with
//     reduce_partials; B2 keeps one cooperative launch and two grid syncs
//     a step, each block's float32 master in device memory beside the
//     partials. Any width is taken.
//   * B6 up to d = 4096: one warp per row with scalar loads, each
//     lane owning the columns j ≡ lane (mod 32) of its warp's accumulator
//     in shared memory; the row is read twice, the second time from L1.
//     Wider: a pass that writes each row's residual (float32), then a pass
//     over (row chunk, column tile) blocks, each adding its chunk's rows
//     in row order, and reduce_partials over the chunks in a fixed order.
//   * B3 on rows of at most 2048 bytes runs on B1's ring: the same
//     producer (ring_produce), slots and barriers (ring_layout, with room
//     for two stages of packed zyv rows), and its own consumer body: a
//     lane group sums a row's z from the slot against w cast to X's type
//     (VPL vectors a lane, then the group's butterfly, so z depends on the
//     row's shape alone), lane 0 puts (z, y, v) into the stage's packed
//     zyv rows in shared memory, and the consumers store the stage's rows
//     in 16-byte stores. Its plan (ops/ssgd_kernels.py::forward_plan, from
//     the shapes and the SM count) makes a block's chunk and a stage
//     multiples of P and of 4, so one block writes each packed zyv row and
//     each stage's rows are one aligned run of zyv. No fold, no ticket.
//     Wider rows (or a P that no stage fits) take forward_wide_kernel: a
//     warp a row, in turns of 32 vectors against w in shared memory.
//   * B4 takes rows of any width: G = the least power of two >= L (at most
//     32) lanes own a row, a lane one 16-byte vector, and each block one
//     column tile (G vectors) of one chunk of rows; a lane adds its rows
//     in row order, the block folds its lane groups and warps in a fixed
//     order and writes its partial, and a second launch adds the chunks'
//     partials in chunk order. Chunks come from the shapes alone
//     (ops/ssgd_kernels.py::tp_kernel_plan), so B4 replays bit for bit.
//     Both are bound by the bytes of the sampled rows, each read once.

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
// rows each lane group of B5 loads before using any (U), for rows of at
// most 32 vectors (kU1) and of up to 128 (kU4): kU1 = 2 was the fastest of
// 2, 4, 8 and 16 for B2's first design, which shared this body, at D =
// 128 bf16 on an H100 (a larger U costs occupancy through registers); kU4
// is not tuned
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
  __device__ static float value(float x) { return x; }
  __device__ static float quant(float x) { return x; }
  __device__ static float cast(float x) { return x; }
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
  __device__ static float value(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static float quant(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static __nv_bfloat16 cast(float x) {
    return __float2bfloat16_rn(x);
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
// kWarps · (32 / G) · U rows.
template <int U>
__host__ __device__ inline int pass_rows(int G) {
  return kWarps * (32 / G) * U;
}

// The row body of B1, B2 and B5: U rows of this lane group, loaded as
// 16-byte vectors (raw, zero for an absent row or a vector past L) with
// their y and validity v, go into this lane's partial gradient. z sums
// x·wq over the lane's vectors in order, then the lane group's butterfly
// (every lane ends with the same bits); resid = (σ(z) − y)·v rounded to
// X's type; acc += resid·x, cnt += v.
template <typename T, int VPL, int U>
__device__ __forceinline__ void accumulate_rows(
    const uint4 (&raw)[U][VPL], const float (&yv)[U], const float (&vv)[U],
    const float (&wq)[VPL][Vec<T>::N], int G, float (&acc)[VPL][Vec<T>::N],
    float& cnt) {
  constexpr int N = Vec<T>::N;
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

// B5: accumulate the rows [r0, r1) of X (each read from device memory)
// into this lane's partial gradient, row i's validity zeroed unless `rs`
// keeps it. Every lane of the warp runs the same number of passes (the
// shuffles need the whole warp).
template <typename T, int VPL, int U>
__device__ __forceinline__ void sampled_rows(
    const T* __restrict__ X, int D, int L, int G, int y_col, int v_col,
    const float (&wq)[VPL][Vec<T>::N], int r0, int r1,
    float (&acc)[VPL][Vec<T>::N], float& cnt, RowSampler rs) {
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
      const bool ok = i < r1;
      const T* row = X + static_cast<long long>(i) * D;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int vi = li + G * k;
        raw[u][k] = ok && vi < L
                        ? __ldg(reinterpret_cast<const uint4*>(row + vi * N))
                        : make_uint4(0u, 0u, 0u, 0u);
      }
      yv[u] = ok ? Vec<T>::scalar(row + y_col) : 0.0f;
      vv[u] = ok ? Vec<T>::scalar(row + v_col) : 0.0f;
      if (threefry_bits(rs.key0, rs.key1, 0u, static_cast<uint32_t>(i)) >=
          rs.thresh)
        vv[u] = 0.0f;
    }
    accumulate_rows<T, VPL, U>(raw, yv, vv, wq, G, acc, cnt);
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

// A barrier of the threads 0..THREADS-1: the whole block in B5's kernel,
// the consumer warps in B1's and B2's (their producer warp never waits on
// it).
template <int THREADS = kThreads>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// Fold the lanes' partial sums into the block's (D + 1) partial, in a
// fixed order: lane groups by butterfly, then warps 0..WARPS-1.
template <typename T, int VPL, int WARPS = kWarps>
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
  consumer_sync<WARPS * 32>();
  for (int j = threadIdx.x; j <= D; j += WARPS * 32) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += j < D ? red[w * D + j] : red_cnt[w];
    out[j] = s;
  }
}

// B5, stage 1: each block's partial over its share of the rows.
template <typename T, int VPL, int U>
__global__ void __launch_bounds__(kThreads)
    grad_packed_kernel(const T* __restrict__ X, int D, int L, int G,
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
  sampled_rows<T, VPL, U>(X, D, L, G, y_col, v_col, wq, r0, r1, acc, cnt, rs);
  block_partial<T, VPL>(acc, cnt, D, L, G, red, red_cnt,
                        partial + static_cast<size_t>(blockIdx.x) * (D + 1));
}

// Stage 2 of B6, B4 and the wide B1 and B5: out[j] = Σ_b partial[b][j] in
// a fixed order (contiguous runs per thread, then a fixed tree). One block
// per column.
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

// ------------------------------------------- B1 and B2: the bulk-copy ring

// Hopper's asynchronous copies and barriers (the same helpers as
// attention.cu's; each library builds alone).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16) from device memory into shared memory with
// one bulk copy, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// counter += 1 at gpu scope, ordered after the block's earlier writes
// (the consumer barrier before it gathers them into this thread's view)
__device__ __forceinline__ void arrive_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(
                   reinterpret_cast<uint64_t>(p))
               : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(reinterpret_cast<uint64_t>(p))
               : "memory");
  return v;
}

constexpr int kRingWarps = 16;    // consumer warps, then a producer warp
constexpr int kRingConsumers = kRingWarps * 32;
constexpr int kRingThreads = kRingConsumers + 32;
constexpr int kRingU = 1;         // rows a lane group takes a pass
// 16-byte vectors a lane holds of a row: 2 for rows of at most
// kRingVPL2Vectors vectors, else 4 (the registers of 16 warps allow no
// more)
constexpr int kRingVPL2Vectors = 64;
constexpr int kMaxStageRows = 1024;
constexpr int kMaskWords = kMaxStageRows / 32;
constexpr int kMaxStages = 12;
constexpr int kFoldBatch = 16;    // partials a folding thread has in flight
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use

// B1's and B2's launch: the plan (ops/ssgd_kernels.py::gathered_plan)
// and the shapes. Block k takes the sampled rows [k·chunk, (k+1)·chunk),
// in stages of stage_rows rows over `stages` ring slots.
struct RingArgs {
  const unsigned char* X;
  const int* idx;  // (T, n_s) block ids
  int n_s, n_blocks, gbr, D, L, y_col, v_col;
  int rows_total, chunk, stage_rows, stages, row_bytes;
};

// Byte offsets in the dynamic shared memory: the ring (stages ·
// stage_bytes), the slots' full and empty barriers, the slots' row masks,
// then w (D floats), red (kRingWarps·D + kRingWarps), scratch
// (max(4·kRingConsumers, Wp)), a flag and B3's out_floats of packed zyv
// rows (none for B1 and B2). ops/ssgd_kernels.py::_ring_smem computes the
// same total.
struct RingLayout {
  int full, empty, mask, w, red, scratch, flag, out, bytes;
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// The partials' row width: D + 1 floats rounded up to a float4.
__host__ __device__ inline int partial_width(int D) { return (D + 4) / 4 * 4; }

__host__ __device__ inline RingLayout ring_layout(int D, int stage_bytes,
                                                  int stages,
                                                  int out_floats = 0) {
  const int Wp = partial_width(D);
  RingLayout l;
  int o = stages * stage_bytes;
  l.full = o;
  o += 8 * stages;
  l.empty = o;
  o += 8 * stages;
  l.mask = o;
  o += 4 * kMaskWords * stages;
  l.w = o;
  o = round16(o + 4 * D);
  l.red = o;
  o = round16(o + 4 * (kRingWarps * D + kRingWarps));
  l.scratch = o;
  o += 4 * (4 * kRingConsumers > Wp ? 4 * kRingConsumers : Wp);
  l.flag = o;
  l.out = o + 16;
  l.bytes = l.out + 4 * out_floats;
  return l;
}

// Set bits [lo, hi) of the mask m.
__device__ __forceinline__ void set_bits(uint32_t* m, int lo, int hi) {
  for (int q = lo >> 5; q <= (hi - 1) >> 5; ++q) {
    const int a = max(lo, q * 32) - q * 32;
    const int b = min(hi, q * 32 + 32) - q * 32;
    m[q] |= (b - a == 32 ? ~0u : ((1u << (b - a)) - 1u)) << a;
  }
}

// Lane 0 of the producer warp: for each step, the block's sampled rows
// [r0, r1) in stages of stage_rows rows, each into the next ring slot
// once the consumers have released it. Sampled row i is row i % gbr of
// block ids[i / gbr], so a run of rows of one sampled block is contiguous
// in X: one bulk copy. A block id outside [0, n_blocks) is not copied,
// and the slot's mask marks its rows absent. The producer waits for
// nothing but free slots: it runs up to `stages` slots ahead, across
// B2's step boundaries.
__device__ void ring_produce(const RingArgs& a, int T_steps, int r0, int r1,
                            unsigned char* ring, uint64_t* full,
                            uint64_t* empty, uint32_t* mask) {
  const int stage_bytes = a.stage_rows * a.row_bytes;
  int slot = 0, round = 0;  // round r fills each slot for the (r+1)-th time
  for (int t = 0; t < T_steps; ++t) {
    const int* ids = a.idx + static_cast<size_t>(t) * a.n_s;
    for (int i0 = r0; i0 < r1; i0 += a.stage_rows) {
      if (round > 0) mbar_wait(empty + slot, (round - 1) & 1);
      const int i1 = min(i0 + a.stage_rows, r1);
      uint32_t* m = mask + slot * kMaskWords;
      for (int q = 0; q < (i1 - i0 + 31) / 32; ++q) m[q] = 0u;
      uint32_t bytes = 0;
      for (int i = i0; i < i1;) {
        const int s = i / a.gbr;
        const int e = min((s + 1) * a.gbr, i1);
        const int b = __ldg(ids + s);
        if (b >= 0 && b < a.n_blocks) {
          bytes += (e - i) * a.row_bytes;
          set_bits(m, i - i0, e - i0);
        }
        i = e;
      }
      mbar_expect_tx(full + slot, bytes);  // releases the mask's writes
      unsigned char* dst = ring + static_cast<size_t>(slot) * stage_bytes;
      for (int i = i0; i < i1;) {
        const int s = i / a.gbr;
        const int e = min((s + 1) * a.gbr, i1);
        const int b = __ldg(ids + s);
        if (b >= 0 && b < a.n_blocks)
          bulk_copy(dst + (i - i0) * a.row_bytes,
                    a.X + (static_cast<long long>(b) * a.gbr + (i - s * a.gbr)) *
                              a.row_bytes,
                    (e - i) * a.row_bytes, full + slot);
        i = e;
      }
      if (++slot == a.stages) {
        slot = 0;
        ++round;
      }
    }
  }
}

// The consumer warps' share of one ring slot of n rows: B1's and B2's
// row body over rows read from shared memory (an absent row counts
// nothing).
template <typename T, int VPL, int G>
__device__ __forceinline__ void consume_stage(
    const unsigned char* st, const uint32_t* m, int n, int row_bytes, int L,
    int y_col, int v_col, const float (&wq)[VPL][Vec<T>::N],
    float (&acc)[VPL][Vec<T>::N], float& cnt) {
  constexpr int R = 32 / G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G;
  const int li = lane % G;
  for (int base = 0; base < n; base += kRingWarps * R * kRingU) {
    uint4 raw[kRingU][VPL];
    float yv[kRingU], vv[kRingU];
#pragma unroll
    for (int u = 0; u < kRingU; ++u) {
      const int r = base + (u * kRingWarps + warp) * R + grp;
      const bool ok = r < n && ((m[r >> 5] >> (r & 31)) & 1u);
      const unsigned char* row = st + r * row_bytes;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int vi = li + G * k;
        raw[u][k] = ok && vi < L ? *reinterpret_cast<const uint4*>(row + vi * 16)
                                 : make_uint4(0u, 0u, 0u, 0u);
      }
      const T* x = reinterpret_cast<const T*>(row);
      yv[u] = ok ? Vec<T>::value(x[y_col]) : 0.0f;
      vv[u] = ok ? Vec<T>::value(x[v_col]) : 0.0f;
    }
    accumulate_rows<T, VPL, kRingU>(raw, yv, vv, wq, G, acc, cnt);
  }
}

// The fold of the nb block partials part[b·Wp + j], in an order fixed by
// nb and Wp alone, in two halves. fold_slices: consumer thread (h, q)
// adds float4 q of blocks h, h + S, h + 2S, … in that order into
// scratch (S slices, as many as kRingConsumers / (Wp / 4) allows, at
// most nb); returns S. fold_column: column j's S slice sums in slice
// order. Every consumer thread of the block calls fold_slices.
__device__ int fold_slices(const float* part, int nb, int Wp, float* scratch) {
  const int Q = Wp / 4;
  const int S = max(1, min(nb, kRingConsumers / Q));
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int it = threadIdx.x; it < Q * S; it += kRingConsumers) {
    const int q = it % Q;
    const int h = it / Q;
    const float4* p = reinterpret_cast<const float4*>(part) + q;
    float4 s = zero;
    for (int b0 = h; b0 < nb; b0 += kFoldBatch * S) {
      float4 v[kFoldBatch];
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u) {
        const int b = b0 + u * S;
        v[u] = b < nb ? __ldcg(p + static_cast<size_t>(b) * Q) : zero;
      }
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u) {
        s.x += v[u].x;
        s.y += v[u].y;
        s.z += v[u].z;
        s.w += v[u].w;
      }
    }
    reinterpret_cast<float4*>(scratch)[it] = s;
  }
  consumer_sync<kRingConsumers>();
  return S;
}

__device__ __forceinline__ float fold_column(const float* scratch, int S,
                                             int Wp, int j) {
  float s = scratch[j];
  for (int h = 1; h < S; ++h) s += scratch[h * Wp + j];
  return s;
}

// B1 (TRAIN false: one step at w, the fold in the last block to finish,
// (g, count) into out) and B2 (TRAIN: T steps, w_out). counters[0] is
// B1's ticket; counters[1] and [2] are B2's arrivals and departures.
// Each launch leaves them at zero.
template <typename T, int VPL, int G, bool TRAIN>
__device__ __forceinline__ void ring_body(const RingArgs& a, int T_steps,
                                          const float* w0,
                                          const float* center, float eta,
                                          float alpha, int skip_update,
                                          unsigned* counters, float* partial,
                                          float* out) {
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const int D = a.D;
  const int W = D + 1;
  const int Wp = partial_width(D);
  const int stage_bytes = a.stage_rows * a.row_bytes;
  const RingLayout lay = ring_layout(D, stage_bytes, a.stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem + lay.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(ring_smem + lay.empty);
  uint32_t* mask = reinterpret_cast<uint32_t*>(ring_smem + lay.mask);
  float* w_s = reinterpret_cast<float*>(ring_smem + lay.w);
  float* red = reinterpret_cast<float*>(ring_smem + lay.red);
  float* red_cnt = red + kRingWarps * D;
  float* scratch = reinterpret_cast<float*>(ring_smem + lay.scratch);
  int* flag = reinterpret_cast<int*>(ring_smem + lay.flag);
  const int nb = gridDim.x;
  const int r0 = blockIdx.x * a.chunk;
  const int r1 = min(r0 + a.chunk, a.rows_total);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kRingWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= kRingConsumers) {
    if (threadIdx.x == kRingConsumers)
      ring_produce(a, T_steps, r0, r1, ring_smem, full, empty, mask);
    return;
  }
  for (int j = threadIdx.x; j < D; j += kRingConsumers) w_s[j] = w0[j];
  consumer_sync<kRingConsumers>();
  float wq[VPL][N];
  load_wq<T, VPL>(w_s, a.L, G, TRAIN ? a.y_col : D, wq);
  int slot = 0, phase = 0;
  for (int t = 0; t < T_steps; ++t) {
    float acc[VPL][N] = {};
    float cnt = 0.0f;
    for (int i0 = r0; i0 < r1; i0 += a.stage_rows) {
      mbar_wait(full + slot, phase);
      consume_stage<T, VPL, G>(
          ring_smem + static_cast<size_t>(slot) * stage_bytes,
          mask + slot * kMaskWords, min(a.stage_rows, r1 - i0), a.row_bytes,
          a.L, a.y_col, a.v_col, wq, acc, cnt);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty + slot);
      if (++slot == a.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    // B2's partials alternate between two buffers by step parity: a block
    // writes step t + 1's only after every block has arrived at step t + 1's
    // barrier, so after every block has folded step t's
    float* buf = partial + static_cast<size_t>(t & 1) * nb * Wp;
    block_partial<T, VPL, kRingWarps>(
        acc, cnt, D, a.L, G, red, red_cnt,
        buf + static_cast<size_t>(blockIdx.x) * Wp);
    consumer_sync<kRingConsumers>();
    if (!TRAIN) {
      if (threadIdx.x == 0) {
        __threadfence();
        *flag = atomicAdd(counters, 1u) == static_cast<unsigned>(nb - 1);
      }
      consumer_sync<kRingConsumers>();
      if (*flag) {
        __threadfence();
        const int S = fold_slices(partial, nb, Wp, scratch);
        for (int j = threadIdx.x; j < W; j += kRingConsumers)
          out[j] = fold_column(scratch, S, Wp, j);
        if (threadIdx.x == 0) counters[0] = 0u;
      }
      return;
    }
    if (skip_update) continue;
    if (threadIdx.x == 0) {  // the grid-wide barrier of step t
      arrive_release(counters + 1);
      const unsigned want = static_cast<unsigned>(t + 1) * nb;
      while (ld_relaxed(counters + 1) < want) {
      }
      __threadfence();
    }
    consumer_sync<kRingConsumers>();
    // every thread sums the count itself (the same bits as column D's)
    const int S = fold_slices(buf, nb, Wp, scratch);
    const float coef =
        __fdiv_rn(eta, fmaxf(fold_column(scratch, S, Wp, D), 1.0f));
    for (int j = threadIdx.x; j < D; j += kRingConsumers) {
      const float w_old = w_s[j];
      const float g = j < a.y_col ? fold_column(scratch, S, Wp, j) : 0.0f;
      float w_new = __fsub_rn(w_old, __fmul_rn(coef, g));
      if (alpha != 0.0f)
        w_new = __fsub_rn(w_new, __fmul_rn(alpha, __fsub_rn(w_old, center[j])));
      w_s[j] = w_new;
    }
    consumer_sync<kRingConsumers>();
    load_wq<T, VPL>(w_s, a.L, G, a.y_col, wq);
  }
  if (!TRAIN) return;
  if (!skip_update && threadIdx.x == 0 &&
      atomicAdd(counters + 2, 1u) == static_cast<unsigned>(nb - 1)) {
    // every block has passed its last barrier: none reads the arrivals
    counters[1] = 0u;
    counters[2] = 0u;
  }
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < D; j += kRingConsumers) out[j] = w_s[j];
}

template <typename T, int VPL, int G>
__global__ void __launch_bounds__(kRingThreads, 1)
    grad_ring_kernel(RingArgs a, const float* __restrict__ w,
                     unsigned* counters, float* partial, float* out) {
  ring_body<T, VPL, G, false>(a, 1, w, nullptr, 0.0f, 0.0f, 0, counters, partial,
                           out);
}

template <typename T, int VPL, int G>
__global__ void __launch_bounds__(kRingThreads, 1)
    train_ring_kernel(RingArgs a, int T_steps, const float* __restrict__ w0,
                      const float* __restrict__ center, float eta,
                      float alpha, int skip_update, unsigned* counters,
                      float* partial, float* w_out) {
  ring_body<T, VPL, G, true>(a, T_steps, w0, center, eta, alpha, skip_update,
                          counters, partial, w_out);
}

// ----------------------------------------- B1 and B2 on wide rows: the ring

// 16-byte vectors of a row a consumer thread owns of the block's partial,
// held in registers: rows of up to kWideMaxVectors vectors (32 KB) take
// the wide ring
constexpr int kWideMaxKV = 4;
constexpr int kWideMaxVectors = kRingConsumers * kWideMaxKV;
// the fold's slices of blocks (S = min(kWideFoldSlices, blocks)), and the
// float4s of B2's fold scratch
constexpr int kWideFoldSlices = 16;
constexpr int kWideFoldQuads = 256;

// Byte offsets in the wide ring's dynamic shared memory: the ring, the
// slots' full and empty barriers and row masks (as ring_layout), then w
// cast to X's type (D elements of X's type, a row's layout), the float32
// master (D floats), the fold's scratch, a round's rows (two buffers of
// r, v, present and the row's byte offset, kRingWarps each) and a flag.
// ops/ssgd_kernels.py::_wide_smem computes the same total.
struct WideLayout {
  int full, empty, mask, wq, w, scratch, rows, flag, bytes;
};

__host__ __device__ inline WideLayout wide_layout(int D, int row_bytes,
                                                  int stage_bytes,
                                                  int stages) {
  WideLayout l;
  int o = stages * stage_bytes;
  l.full = o;
  o += 8 * stages;
  l.empty = o;
  o += 8 * stages;
  l.mask = o;
  o += 4 * kMaskWords * stages;
  l.wq = round16(o);
  l.w = l.wq + row_bytes;  // a whole number of 16-byte vectors
  l.scratch = l.w + 4 * D;  // D is a multiple of 4
  l.rows = l.scratch + 16 * kWideFoldQuads;
  l.flag = l.rows + 4 * 4 * 2 * kRingWarps;
  l.bytes = l.flag + 16;
  return l;
}

// z of a row of L vectors in shared memory against w cast to X's type
// (wq, laid out as a row), read by one warp in turns of 32 vectors; every
// lane ends with the same bits.
template <typename T>
__device__ __forceinline__ float wide_ring_z(const uint4* row,
                                             const uint4* wq, int L) {
  constexpr int N = Vec<T>::N;
  float z = 0.0f;
#pragma unroll 4
  for (int vi = threadIdx.x & 31; vi < L; vi += 32) {
    float x[N], w[N];
    Vec<T>::unpack(row[vi], x);
    Vec<T>::unpack(wq[vi], w);
#pragma unroll
    for (int e = 0; e < N; ++e) z = fmaf(x[e], w[e], z);
  }
  for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
  return z;
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// The fold of the nb partials part[b·Wp + j] over the column float4s
// [q0, q1), in an order fixed by nb alone: slice h of S = min(
// kWideFoldSlices, nb) sums blocks h, h + S, h + 2S, … in order, and the
// S slice sums add in slice order, into dst (columns >= W not written).
// A pass takes C = cap / S float4s: consumer thread `it` sums one slice
// of one float4 into scratch (cap float4s), then each float4 adds its
// slices. So the sum of a column does not depend on which block folds
// it, nor on cap. Every consumer thread of the block calls it.
__device__ void wide_fold(const float* part, int nb, int Wp, int q0, int q1,
                          float4* scratch, int cap, int W, float* dst) {
  const int Q = Wp / 4;
  const int S = min(kWideFoldSlices, nb);
  const int C = cap / S;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* p = reinterpret_cast<const float4*>(part);
  for (int qc = q0; qc < q1; qc += C) {
    const int nq = min(C, q1 - qc);
    for (int it = threadIdx.x; it < nq * S; it += kRingConsumers) {
      const int q = qc + it % nq;
      const int h = it / nq;
      float4 s = zero;
      for (int b0 = h; b0 < nb; b0 += kFoldBatch * S) {
        float4 v[kFoldBatch];
#pragma unroll
        for (int u = 0; u < kFoldBatch; ++u) {
          const int b = b0 + u * S;
          v[u] = b < nb ? __ldcg(p + static_cast<size_t>(b) * Q + q) : zero;
        }
#pragma unroll
        for (int u = 0; u < kFoldBatch; ++u) add4(s, v[u]);
      }
      scratch[it] = s;
    }
    consumer_sync<kRingConsumers>();
    for (int it = threadIdx.x; it < nq; it += kRingConsumers) {
      float4 s = scratch[it];
      for (int h = 1; h < S; ++h) add4(s, scratch[h * nq + it]);
      const int j = 4 * (qc + it);
      if (j + 4 <= W) {
        reinterpret_cast<float4*>(dst)[qc + it] = s;
      } else {
        const float v[4] = {s.x, s.y, s.z, s.w};
        for (int e = 0; j + e < W; ++e) dst[j + e] = v[e];
      }
    }
    consumer_sync<kRingConsumers>();
  }
}

// The ring's grid-wide barrier: the block's arrival (ordered after its
// consumers' writes by the caller's consumer_sync) and the wait until
// `want` arrivals in all; only the consumer warps take part.
__device__ __forceinline__ void ring_barrier(unsigned* arrivals,
                                             unsigned want) {
  if (threadIdx.x == 0) {
    arrive_release(arrivals);
    while (ld_relaxed(arrivals) < want) {
    }
    __threadfence();
  }
  consumer_sync<kRingConsumers>();
}

// B1 (TRAIN false) and B2 (TRAIN) on rows of 129 to kWideMaxVectors
// vectors, on the narrow ring's producer, slots and barriers. Consumers
// take a round of spr consecutive stages of a step (at most kRingWarps
// rows): warp w finds row w's residual from the slot against w cast to
// X's type in shared memory; then thread k adds the round's rows, in row
// order, into its KV vectors k, k + 512, … of the block's partial, in
// registers, and the warps release the round's slots. At a step's end
// the block writes its partial (D + 1 floats, double-buffered by step
// parity). B1: the last block to take a ticket folds (wide_fold, the
// ring as scratch) into out = (g, count). B2: a barrier; block k folds
// its share of the columns into the step's sum (after the partials:
// W floats); a barrier; every block applies the update to its float32
// master in shared memory and recasts w. counters as ring_body's.
template <typename T, int KV, bool TRAIN>
__device__ __forceinline__ void wide_ring_body(
    const RingArgs& a, int T_steps, const float* w0, const float* center,
    float eta, float alpha, int skip_update, unsigned* counters,
    float* partial, float* out) {
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const int D = a.D;
  const int L = a.L;
  const int Wp = partial_width(D);
  const int stage_bytes = a.stage_rows * a.row_bytes;
  const WideLayout lay = wide_layout(D, a.row_bytes, stage_bytes, a.stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem + lay.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(ring_smem + lay.empty);
  uint32_t* mask = reinterpret_cast<uint32_t*>(ring_smem + lay.mask);
  T* wq = reinterpret_cast<T*>(ring_smem + lay.wq);
  float* w_s = reinterpret_cast<float*>(ring_smem + lay.w);
  float4* scratch = reinterpret_cast<float4*>(ring_smem + lay.scratch);
  float* r_s = reinterpret_cast<float*>(ring_smem + lay.rows);
  float* v_s = r_s + 2 * kRingWarps;
  int* ok_s = reinterpret_cast<int*>(v_s + 2 * kRingWarps);
  int* off_s = ok_s + 2 * kRingWarps;
  int* flag = reinterpret_cast<int*>(ring_smem + lay.flag);
  const int nb = gridDim.x;
  const int r0 = blockIdx.x * a.chunk;
  const int r1 = min(r0 + a.chunk, a.rows_total);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kRingWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= kRingConsumers) {
    if (threadIdx.x == kRingConsumers)
      ring_produce(a, T_steps, r0, r1, ring_smem, full, empty, mask);
    return;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int limit = TRAIN ? a.y_col : D;
  for (int j = tid; j < D; j += kRingConsumers) {
    const float v = w0[j];
    w_s[j] = v;
    wq[j] = Vec<T>::cast(j < limit ? v : 0.0f);
  }
  consumer_sync<kRingConsumers>();
  // a round: spr whole stages, one row a warp, half the slots at most so
  // that the producer keeps the other half in flight
  const int spr = min(kRingWarps / a.stage_rows, a.stages / 2);
  const int round_rows = spr * a.stage_rows;
  int slot = 0, phase = 0, rb = 0;
  for (int t = 0; t < T_steps; ++t) {
    float acc[KV][N] = {};
    float cnt = 0.0f;
    for (int i0 = r0; i0 < r1; i0 += round_rows) {
      const int n = min(round_rows, r1 - i0);
      const int ns = (n + a.stage_rows - 1) / a.stage_rows;
      for (int s = 0, sl = slot, ph = phase; s < ns; ++s) {
        mbar_wait(full + sl, ph);
        if (++sl == a.stages) {
          sl = 0;
          ph ^= 1;
        }
      }
      const int base = rb * kRingWarps;
      if (warp < n) {
        const int s = warp / a.stage_rows;
        const int k = warp - s * a.stage_rows;
        const int sl = slot + s < a.stages ? slot + s : slot + s - a.stages;
        const bool ok = (mask[sl * kMaskWords] >> k) & 1u;  // k < 32
        const int off = sl * stage_bytes + k * a.row_bytes;
        float r = 0.0f, v = 0.0f;
        if (ok) {
          const float z = wide_ring_z<T>(
              reinterpret_cast<const uint4*>(ring_smem + off),
              reinterpret_cast<const uint4*>(wq), L);
          const T* x = reinterpret_cast<const T*>(ring_smem + off);
          v = Vec<T>::value(x[a.v_col]);
          r = Vec<T>::quant((sigmoid(z) - Vec<T>::value(x[a.y_col])) * v);
        }
        if (lane == 0) {
          r_s[base + warp] = r;
          v_s[base + warp] = v;
          ok_s[base + warp] = ok;
          off_s[base + warp] = off;
        }
      }
      // the round's r, v, present and offsets are written; a round's
      // buffer is written again two rounds later, after the next sync
      consumer_sync<kRingConsumers>();
      if (tid < L) {
#pragma unroll
        for (int u = 0; u < kRingWarps; ++u) {
          if (u < n && ok_s[base + u]) {
            const float r = r_s[base + u];
            const uint4* row =
                reinterpret_cast<const uint4*>(ring_smem + off_s[base + u]);
#pragma unroll
            for (int q = 0; q < KV; ++q) {
              const int vi = tid + q * kRingConsumers;
              if (vi < L) {
                float x[N];
                Vec<T>::unpack(row[vi], x);
#pragma unroll
                for (int e = 0; e < N; ++e)
                  acc[q][e] = fmaf(r, x[e], acc[q][e]);
              }
            }
          }
        }
      }
      if (tid == 0)
        for (int u = 0; u < n; ++u) cnt += v_s[base + u];
      __syncwarp();
      for (int s = 0; s < ns; ++s) {
        if (lane == 0) mbar_arrive(empty + slot);
        if (++slot == a.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
      rb ^= 1;
    }
    // the step's partial, double-buffered by step parity as ring_body's
    float* buf = partial + static_cast<size_t>(t & 1) * nb * Wp;
    float4* mine = reinterpret_cast<float4*>(
        buf + static_cast<size_t>(blockIdx.x) * Wp);
#pragma unroll
    for (int q = 0; q < KV; ++q) {
      const int vi = tid + q * kRingConsumers;
      if (vi < L)
#pragma unroll
        for (int h = 0; h < N / 4; ++h)
          mine[vi * (N / 4) + h] =
              make_float4(acc[q][4 * h], acc[q][4 * h + 1], acc[q][4 * h + 2],
                          acc[q][4 * h + 3]);
    }
    if (tid == 0) buf[static_cast<size_t>(blockIdx.x) * Wp + D] = cnt;
    consumer_sync<kRingConsumers>();
    if (!TRAIN) {
      if (tid == 0) {
        __threadfence();
        *flag = atomicAdd(counters, 1u) == static_cast<unsigned>(nb - 1);
      }
      consumer_sync<kRingConsumers>();
      if (!*flag) return;
      __threadfence();
      // every slot has been consumed: the ring is free for the fold
      wide_fold(partial, nb, Wp, 0, Wp / 4,
                reinterpret_cast<float4*>(ring_smem),
                a.stages * stage_bytes / 16, D + 1, out);
      if (tid == 0) counters[0] = 0u;
      return;
    }
    if (skip_update) continue;
    float* gsum = partial + 2 * static_cast<size_t>(nb) * Wp;
    ring_barrier(counters + 1, static_cast<unsigned>(2 * t + 1) * nb);
    const int Q = Wp / 4;
    const int share = (Q + nb - 1) / nb;
    const int q0 = min(static_cast<int>(blockIdx.x) * share, Q);
    wide_fold(buf, nb, Wp, q0, min(q0 + share, Q), scratch, kWideFoldQuads,
              Wp, gsum);
    ring_barrier(counters + 1, static_cast<unsigned>(2 * t + 2) * nb);
    const float coef = __fdiv_rn(eta, fmaxf(__ldcg(gsum + D), 1.0f));
    for (int j = tid; j < D; j += kRingConsumers) {
      const float w_old = w_s[j];
      const float g = j < a.y_col ? __ldcg(gsum + j) : 0.0f;
      float w_new = __fsub_rn(w_old, __fmul_rn(coef, g));
      if (alpha != 0.0f)
        w_new = __fsub_rn(w_new, __fmul_rn(alpha, __fsub_rn(w_old, center[j])));
      w_s[j] = w_new;
      wq[j] = Vec<T>::cast(j < a.y_col ? w_new : 0.0f);
    }
    consumer_sync<kRingConsumers>();
  }
  if (!TRAIN) return;
  if (!skip_update && tid == 0 &&
      atomicAdd(counters + 2, 1u) == static_cast<unsigned>(nb - 1)) {
    // every block has passed its last barrier: none reads the arrivals
    counters[1] = 0u;
    counters[2] = 0u;
  }
  if (blockIdx.x == 0)
    for (int j = tid; j < D; j += kRingConsumers) out[j] = w_s[j];
}

template <typename T, int KV>
__global__ void __launch_bounds__(kRingThreads, 1)
    wide_grad_ring_kernel(RingArgs a, const float* __restrict__ w,
                          unsigned* counters, float* partial, float* out) {
  wide_ring_body<T, KV, false>(a, 1, w, nullptr, 0.0f, 0.0f, 0, counters,
                               partial, out);
}

// B2's wide ring: the name holds "train_ring_kernel", as B2's kernels'
// names do (the benchmark finds B2 by them)
template <typename T, int KV>
__global__ void __launch_bounds__(kRingThreads, 1)
    wide_train_ring_kernel(RingArgs a, int T_steps,
                           const float* __restrict__ w0,
                           const float* __restrict__ center, float eta,
                           float alpha, int skip_update, unsigned* counters,
                           float* partial, float* w_out) {
  wide_ring_body<T, KV, true>(a, T_steps, w0, center, eta, alpha, skip_update,
                              counters, partial, w_out);
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
// Row selection and the residual are those of the narrow bodies.
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

// B1 on rows wider than the wide ring takes and, with SAMPLED, B5 on
// rows over 2048 bytes, stage 1.
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

// B2 on rows wider than the wide ring takes: T steps in one cooperative
// launch, two grid syncs a step (every block writes its partial; one warp
// per column sums the partials in block order into the step's sum; every
// block applies the update to its own float32 master in device memory,
// wcopy, D floats a block), its partial summed in place (wide_rows).
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

// The geometry of B5's row body: 16-byte vectors per row L, lanes per
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

// B1 (ids of n_s blocks of gbr rows) on rows wider than the wide ring
// takes or, with SAMPLED, B5 (ids unused, one "block" of all gbr = n
// rows, sampled by rs) on rows over 2048 bytes: wide_rows' partials,
// then reduce_partials.
template <typename T, bool SAMPLED>
cudaError_t launch_grad_wide_rows(const void* X, const int* ids, int n_s,
                                  int n_blocks, int gbr, int D, int y_col,
                                  int v_col, const float* w, RowSampler rs,
                                  int max_blocks, float* partial, float* out,
                                  cudaStream_t s) {
  const int rows_total = n_s * gbr;
  const int chunk = chunk_rows(rows_total, max_blocks, kWarps);
  const int nblk = (rows_total + chunk - 1) / chunk;
  grad_wide_kernel<T, SAMPLED><<<nblk, kThreads, 0, s>>>(
      static_cast<const T*>(X), ids, n_blocks, gbr, D, D / Vec<T>::N, y_col,
      v_col, w, rs, chunk, rows_total, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<D + 1, kReduceThreads, 0, s>>>(partial, nblk, D + 1, out);
  return cudaGetLastError();
}

template <typename T>
bool wide_row(int D) {
  constexpr int N = Vec<T>::N;
  return D >= N && D % N == 0 && D / N > kMaxNarrowVectors;
}

template <typename T, int VPL, int U>
cudaError_t packed_v(const void* X, int n, int D, const Geometry& g,
                     int y_col, int v_col, const float* w, RowSampler rs,
                     int max_blocks, float* partial, float* out,
                     cudaStream_t s) {
  const int chunk = chunk_rows(n, max_blocks, pass_rows<U>(g.G));
  const int nblk = (n + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * (kWarps * D + kWarps);
  grad_packed_kernel<T, VPL, U><<<nblk, kThreads, smem, s>>>(
      static_cast<const T*>(X), D, g.L, g.G, y_col, v_col, w, rs, chunk, n,
      partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<D + 1, kReduceThreads, 0, s>>>(partial, nblk, D + 1, out);
  return cudaGetLastError();
}

// B5 over all n rows of X.
template <typename T>
cudaError_t launch_packed(const void* X, int n, int D, int y_col, int v_col,
                          const float* w, RowSampler rs, int max_blocks,
                          float* partial, float* out, cudaStream_t s) {
  if (wide_row<T>(D))
    return launch_grad_wide_rows<T, true>(X, nullptr, 1, 1, n, D, y_col,
                                          v_col, w, rs, max_blocks, partial,
                                          out, s);
  Geometry g;
  if (!geometry<T>(D, &g)) return cudaErrorInvalidValue;
  return g.vpl == 1 ? packed_v<T, 1, kU1>(X, n, D, g, y_col, v_col, w, rs,
                                          max_blocks, partial, out, s)
                    : packed_v<T, 4, kU4>(X, n, D, g, y_col, v_col, w, rs,
                                          max_blocks, partial, out, s);
}

// Allow B1's (TRAIN false) or B2's ring kernel the shared memory it may
// ask for, once per device.
template <typename T, int VPL, int G, bool TRAIN>
cudaError_t allow_ring_smem(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaError_t err =
      TRAIN ? cudaFuncSetAttribute(train_ring_kernel<T, VPL, G>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmemMax)
            : cudaFuncSetAttribute(grad_ring_kernel<T, VPL, G>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmemMax);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

template <typename T, int VPL, int G>
cudaError_t ring_v(bool train, RingArgs a, int blocks, size_t smem,
                   int T_steps, const float* w0, const float* center,
                   float eta, float alpha, int skip_update, int device,
                   unsigned* counters, float* partial, float* out,
                   cudaStream_t s) {
  if (!train) {
    cudaError_t err = allow_ring_smem<T, VPL, G, false>(device);
    if (err != cudaSuccess) return err;
    grad_ring_kernel<T, VPL, G><<<blocks, kRingThreads, smem, s>>>(
        a, w0, counters, partial, out);
    return cudaGetLastError();
  }
  cudaError_t err = allow_ring_smem<T, VPL, G, true>(device);
  if (err != cudaSuccess) return err;
  void* args[] = {&a,     &T_steps,     &w0,       &center,  &eta,
                  &alpha, &skip_update, &counters, &partial, &out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(train_ring_kernel<T, VPL, G>), dim3(blocks),
      dim3(kRingThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// B1 (train false: out = (g, count)) or B2 (train: T steps, out = w) on
// rows of at most 2048 bytes, on the plan's blocks, chunk, stage_rows and
// stages, which must cover the rows_total sampled rows and fit the
// shared memory. `work` holds 32 floats (the counters), then the
// partials: 2 · blocks · partial_width(D) floats.
// B1's and B2's ring arguments from the plan; false if the plan's blocks,
// chunk, stage_rows and stages do not cover the rows_total sampled rows.
template <typename T>
bool ring_args(const void* X, const int* idx, int n_s, int n_blocks, int gbr,
               int D, int y_col, int v_col, int blocks, int chunk,
               int stage_rows, int stages, RingArgs* a) {
  *a = RingArgs{static_cast<const unsigned char*>(X),
                idx,
                n_s,
                n_blocks,
                gbr,
                D,
                D / Vec<T>::N,
                y_col,
                v_col,
                n_s * gbr,
                chunk,
                stage_rows,
                stages,
                D * static_cast<int>(sizeof(T))};
  return blocks >= 1 && chunk >= 1 && stage_rows >= 1 &&
         stage_rows <= kMaxStageRows && stages >= 2 && stages <= kMaxStages &&
         static_cast<long long>(blocks) * chunk >= a->rows_total &&
         static_cast<long long>(blocks - 1) * chunk < a->rows_total;
}

template <typename T>
cudaError_t launch_ring(bool train, const void* X, const int* idx,
                        int T_steps, int n_s, int n_blocks, int gbr, int D,
                        int y_col, int v_col, const float* w0,
                        const float* center, float eta, float alpha,
                        int skip_update, int blocks, int chunk,
                        int stage_rows, int stages, int device, float* work,
                        float* out, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  if (D < 1 || D % N || D / N > kMaxNarrowVectors)
    return cudaErrorInvalidValue;
  // VPL vectors a lane: the least power of two G of lanes that holds the
  // row's L vectors (a row's scalar work, z's butterfly, σ and the
  // rounding, is then shared by 32 / G rows a warp instruction)
  const int L = D / N;
  const int vpl = L <= kRingVPL2Vectors ? 2 : 4;
  int G = 1;
  while (G * vpl < L) G <<= 1;
  RingArgs a;
  if (!ring_args<T>(X, idx, n_s, n_blocks, gbr, D, y_col, v_col, blocks,
                    chunk, stage_rows, stages, &a))
    return cudaErrorInvalidValue;
  const size_t smem = ring_layout(D, stage_rows * a.row_bytes, stages).bytes;
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  unsigned* counters = reinterpret_cast<unsigned*>(work);
  float* partial = work + 32;
  auto launch = ring_v<T, 4, 32>;  // rows of 65 to 128 vectors
  if (vpl == 2)
    switch (G) {
      case 1: launch = ring_v<T, 2, 1>; break;
      case 2: launch = ring_v<T, 2, 2>; break;
      case 4: launch = ring_v<T, 2, 4>; break;
      case 8: launch = ring_v<T, 2, 8>; break;
      case 16: launch = ring_v<T, 2, 16>; break;
      default: launch = ring_v<T, 2, 32>; break;
    }
  return launch(train, a, blocks, smem, T_steps, w0, center, eta, alpha,
                skip_update, device, counters, partial, out, s);
}

// Rows over 2048 bytes that the wide ring takes: at most kWideMaxVectors
// vectors (then w, the master and two stages of one row fit the shared
// memory, whatever the element type); wider rows take the wide body.
template <typename T>
bool wide_ring_row(int D) {
  return wide_row<T>(D) && D / Vec<T>::N <= kWideMaxVectors;
}

template <typename T, int KV>
cudaError_t wide_ring_v(bool train, RingArgs a, int blocks, size_t smem,
                        int T_steps, const float* w0, const float* center,
                        float eta, float alpha, int skip_update, int device,
                        unsigned* counters, float* partial, float* out,
                        cudaStream_t s) {
  static bool done[2][64] = {};
  const bool known = device >= 0 && device < 64;
  if (!(known && done[train][device])) {
    const cudaError_t err =
        train ? cudaFuncSetAttribute(wide_train_ring_kernel<T, KV>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     kSmemMax)
              : cudaFuncSetAttribute(wide_grad_ring_kernel<T, KV>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     kSmemMax);
    if (err != cudaSuccess) return err;
    if (known) done[train][device] = true;
  }
  if (!train) {
    wide_grad_ring_kernel<T, KV><<<blocks, kRingThreads, smem, s>>>(
        a, w0, counters, partial, out);
    return cudaGetLastError();
  }
  void* args[] = {&a,     &T_steps,     &w0,       &center,  &eta,
                  &alpha, &skip_update, &counters, &partial, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(wide_train_ring_kernel<T, KV>), dim3(blocks),
      dim3(kRingThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// B1 (train false: out = (g, count)) or B2 (train: T steps, out = w) on
// rows that wide_ring_row takes, on the plan as launch_ring's. `work`
// holds 32 floats (the counters), the partials (2 · blocks ·
// partial_width(D) floats), then the step's sum (partial_width(D)).
template <typename T>
cudaError_t launch_wide_ring(bool train, const void* X, const int* idx,
                             int T_steps, int n_s, int n_blocks, int gbr,
                             int D, int y_col, int v_col, const float* w0,
                             const float* center, float eta, float alpha,
                             int skip_update, int blocks, int chunk,
                             int stage_rows, int stages, int device,
                             float* work, float* out, cudaStream_t s) {
  RingArgs a;
  if (!wide_ring_row<T>(D) ||
      !ring_args<T>(X, idx, n_s, n_blocks, gbr, D, y_col, v_col, blocks,
                    chunk, stage_rows, stages, &a) ||
      stage_rows > kRingWarps ||
      2LL * T_steps * blocks >= (1LL << 32))  // B2's arrivals, two a step
    return cudaErrorInvalidValue;
  const size_t smem =
      wide_layout(D, a.row_bytes, stage_rows * a.row_bytes, stages).bytes;
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  unsigned* counters = reinterpret_cast<unsigned*>(work);
  float* partial = work + 32;
  auto launch = wide_ring_v<T, 4>;
  switch ((a.L + kRingConsumers - 1) / kRingConsumers) {
    case 1: launch = wide_ring_v<T, 1>; break;
    case 2: launch = wide_ring_v<T, 2>; break;
    case 3: launch = wide_ring_v<T, 3>; break;
    default: break;
  }
  return launch(train, a, blocks, smem, T_steps, w0, center, eta, alpha,
                skip_update, device, counters, partial, out, s);
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

// B1: the ring or the wide ring in one launch, or, on rows too wide for
// the wide ring, the wide body's two launches (at most `blocks` blocks;
// `work` + 32 holds their partials).
template <typename T>
cudaError_t launch_grad_gathered(const void* X, const int* ids, int n_s,
                                 int n_blocks, int gbr, int D, int y_col,
                                 int v_col, const float* w, int blocks,
                                 int chunk, int stage_rows, int stages,
                                 int device, float* work, float* out,
                                 cudaStream_t s) {
  if (wide_ring_row<T>(D))
    return launch_wide_ring<T>(false, X, ids, 1, n_s, n_blocks, gbr, D, y_col,
                               v_col, w, nullptr, 0.0f, 0.0f, 0, blocks, chunk,
                               stage_rows, stages, device, work, out, s);
  if (wide_row<T>(D))
    return launch_grad_wide_rows<T, false>(X, ids, n_s, n_blocks, gbr, D,
                                           y_col, v_col, w, RowSampler{},
                                           blocks, work + 32, out, s);
  return launch_ring<T>(false, X, ids, 1, n_s, n_blocks, gbr, D, y_col, v_col,
                        w, nullptr, 0.0f, 0.0f, 0, blocks, chunk, stage_rows,
                        stages, device, work, out, s);
}

// B2: the ring or the wide ring in one cooperative launch, or, on rows
// too wide for the wide ring, the wide body's cooperative launch (at most
// `blocks` blocks; `work` + 32 holds their partials, the step's sum and
// their masters).
template <typename T>
cudaError_t launch_train(const void* X, const int* idx, int T_steps, int n_s,
                         int n_blocks, int gbr, int D, int y_col, int v_col,
                         const float* w0, const float* center, float eta,
                         float alpha, int skip_update, int blocks, int chunk,
                         int stage_rows, int stages, int device, float* work,
                         float* w_out, cudaStream_t s) {
  if (wide_ring_row<T>(D))
    return launch_wide_ring<T>(true, X, idx, T_steps, n_s, n_blocks, gbr, D,
                               y_col, v_col, w0, center, eta, alpha,
                               skip_update, blocks, chunk, stage_rows, stages,
                               device, work, w_out, s);
  if (wide_row<T>(D)) {
    float* partial = work + 32;
    return train_wide<T>(X, idx, T_steps, n_s, n_blocks, gbr, D, y_col, v_col,
                         w0, center, eta, alpha, skip_update, blocks, device,
                         partial,
                         partial + static_cast<size_t>(blocks + 1) * (D + 1),
                         w_out, s);
  }
  return launch_ring<T>(true, X, idx, T_steps, n_s, n_blocks, gbr, D, y_col,
                        v_col, w0, center, eta, alpha, skip_update, blocks,
                        chunk, stage_rows, stages, device, work, w_out, s);
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

constexpr int kTpU = 4;  // rows a lane group holds in flight (B4)

// Lanes that own a row of L vectors in B4 (tp_kernel_plan's G).
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

// B3 on rows of at most 2048 bytes, on B1's ring: the producer lane
// (ring_produce) copies the block's sampled rows [k·chunk, (k+1)·chunk)
// into the ring slots; a consumer lane group of G lanes takes a row of the
// slot, VPL (kFwdVPL) 16-byte vectors a lane, and sums z = Σ x·w (w cast to X's
// type) in vector order, then the group's fixed-order butterfly, so z
// depends on the row's shape alone. Lane 0 of the group writes the row's
// (z, y, v), y and v read from the slot, into the slot's packed zyv rows
// in shared memory (two buffers, by stage parity); the consumers then
// store the stage's 3·n floats, a contiguous run of zyv since a stage
// starts at a multiple of P and of 4, in 16-byte stores. An absent row
// (its block id outside [0, n_blocks)) gives zeros. Rows are independent:
// no partials, no fold, no ticket.
template <typename T, int VPL, int G>
__global__ void __launch_bounds__(kRingThreads, 1)
    forward_ring_kernel(RingArgs a, const float* __restrict__ w, int P,
                        float* __restrict__ zyv) {
  constexpr int N = Vec<T>::N;
  constexpr int R = 32 / G;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const int D = a.D;
  const int stage_bytes = a.stage_rows * a.row_bytes;
  const RingLayout lay =
      ring_layout(D, stage_bytes, a.stages, 6 * a.stage_rows);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem + lay.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(ring_smem + lay.empty);
  uint32_t* mask = reinterpret_cast<uint32_t*>(ring_smem + lay.mask);
  float* w_s = reinterpret_cast<float*>(ring_smem + lay.w);
  float* outs = reinterpret_cast<float*>(ring_smem + lay.out);
  const int r0 = blockIdx.x * a.chunk;
  const int r1 = min(r0 + a.chunk, a.rows_total);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kRingWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= kRingConsumers) {
    if (threadIdx.x == kRingConsumers)
      ring_produce(a, 1, r0, r1, ring_smem, full, empty, mask);
    return;
  }
  for (int j = threadIdx.x; j < D; j += kRingConsumers) w_s[j] = w[j];
  consumer_sync<kRingConsumers>();
  float wq[VPL][N];
  load_wq<T, VPL>(w_s, a.L, G, D, wq);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G;
  const int li = lane % G;
  const uint32_t p_inv = 0xffffffffu / static_cast<uint32_t>(P) + 1u;  // P > 1
  int slot = 0, phase = 0, buf = 0;
  for (int i0 = r0; i0 < r1; i0 += a.stage_rows) {
    const int n = min(a.stage_rows, r1 - i0);
    float* ob = outs + buf * 3 * a.stage_rows;
    mbar_wait(full + slot, phase);
    const unsigned char* st =
        ring_smem + static_cast<size_t>(slot) * stage_bytes;
    const uint32_t* m = mask + slot * kMaskWords;
    for (int base = 0; base < n; base += kRingWarps * R) {
      const int r = base + warp * R + grp;
      const bool ok = r < n && ((m[r >> 5] >> (r & 31)) & 1u);
      const unsigned char* row = st + r * a.row_bytes;
      float z = 0.0f;
#pragma unroll
      for (int kk = 0; kk < VPL; ++kk) {
        const int vi = li + G * kk;
        float x[N];
        Vec<T>::unpack(ok && vi < a.L
                           ? *reinterpret_cast<const uint4*>(row + vi * 16)
                           : make_uint4(0u, 0u, 0u, 0u),
                       x);
#pragma unroll
        for (int e = 0; e < N; ++e) z = fmaf(x[e], wq[kk][e], z);
      }
#pragma unroll
      for (int o = G >> 1; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
      if (li == 0 && r < n) {
        const T* x = reinterpret_cast<const T*>(row);
        // r / P exactly (r and P at most 1024): a multiply, not a division
        const int pr = P == 1 ? r
                              : static_cast<int>(__umulhi(
                                    static_cast<uint32_t>(r), p_inv));
        float* o = ob + pr * 3 * P + (r - pr * P);
        o[0] = z;
        o[P] = ok ? Vec<T>::value(x[a.y_col]) : 0.0f;
        o[2 * P] = ok ? Vec<T>::value(x[a.v_col]) : 0.0f;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
    consumer_sync<kRingConsumers>();
    // the stage's packed rows are zyv[3·i0, 3·(i0 + n)): 16-byte aligned
    float* dst = zyv + 3LL * i0;
    const int nf = 3 * n;
    for (int e = threadIdx.x; e < nf / 4; e += kRingConsumers)
      reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(ob)[e];
    for (int e = nf / 4 * 4 + threadIdx.x; e < nf; e += kRingConsumers)
      dst[e] = ob[e];
    buf ^= 1;
    if (++slot == a.stages) {
      slot = 0;
      phase ^= 1;
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

// B3's row geometry on the ring: kFwdVPL vectors a lane and the least
// power of two G of lanes that holds the row's L vectors; a warp then
// takes 32 / G rows a pass, so a row's fixed work (the butterfly, the
// packed-row index, the stores) is shared by more rows than B1's VPL 2
// allows (ops/ssgd_kernels.py::forward_plan agrees).
constexpr int kFwdVPL = 4;

inline int forward_lanes(int L) {
  int G = 1;
  while (G * kFwdVPL < L) G <<= 1;
  return G;
}

template <typename T, int VPL, int G>
cudaError_t forward_ring_v(const RingArgs& a, const float* w, int P,
                           int blocks, size_t smem, int device, float* zyv,
                           cudaStream_t s) {
  static bool done[64] = {};
  if (!(device >= 0 && device < 64 && done[device])) {
    const cudaError_t err = cudaFuncSetAttribute(
        forward_ring_kernel<T, VPL, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) done[device] = true;
  }
  forward_ring_kernel<T, VPL, G><<<blocks, kRingThreads, smem, s>>>(a, w, P,
                                                                    zyv);
  return cudaGetLastError();
}

// B3: on rows of at most 2048 bytes the ring (blocks of `chunk` rows,
// stages of stage_rows rows over `stages` slots: ops/ssgd_kernels.py::
// forward_plan, whose chunk and stage_rows are multiples of P and of 4);
// wider rows, or stage_rows 0, the wide body on `blocks` blocks.
template <typename T>
cudaError_t launch_forward(const void* X, const int* ids, int n_s,
                           int n_blocks, int gbr, int D, int y_col, int v_col,
                           int P, const float* w, int blocks, int chunk,
                           int stage_rows, int stages, int device, float* zyv,
                           cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  if (D % N) return cudaErrorInvalidValue;
  const int L = D / N;
  const int rows = n_s * gbr;  // < 2^31 (checked by the entry point)
  if (L > kMaxNarrowVectors || stage_rows == 0) {
    const size_t smem = sizeof(float) * D;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          forward_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    forward_wide_kernel<T><<<blocks, kThreads, smem, s>>>(
        static_cast<const T*>(X), ids, n_blocks, gbr, L, y_col, v_col, P, w,
        rows, zyv);
    return cudaGetLastError();
  }
  RingArgs a{static_cast<const unsigned char*>(X),
             ids,
             n_s,
             n_blocks,
             gbr,
             D,
             L,
             y_col,
             v_col,
             rows,
             chunk,
             stage_rows,
             stages,
             D * static_cast<int>(sizeof(T))};
  if (rows >= (1 << 30) || chunk < 1 || chunk % P || chunk % 4 ||
      stage_rows % P ||
      stage_rows % 4 || stage_rows > kMaxStageRows || stages < 2 ||
      stages > kMaxStages ||
      static_cast<long long>(blocks) * chunk < rows ||
      static_cast<long long>(blocks - 1) * chunk >= rows)
    return cudaErrorInvalidValue;
  const size_t smem =
      ring_layout(D, stage_rows * a.row_bytes, stages, 6 * stage_rows).bytes;
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  auto launch = forward_ring_v<T, kFwdVPL, 32>;
  switch (forward_lanes(L)) {
    case 1: launch = forward_ring_v<T, kFwdVPL, 1>; break;
    case 2: launch = forward_ring_v<T, kFwdVPL, 2>; break;
    case 4: launch = forward_ring_v<T, kFwdVPL, 4>; break;
    case 8: launch = forward_ring_v<T, kFwdVPL, 8>; break;
    case 16: launch = forward_ring_v<T, kFwdVPL, 16>; break;
    default: break;
  }
  return launch(a, w, P, blocks, smem, device, zyv, s);
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
// blocks, chunk, stage_rows and stages are ops/ssgd_kernels.py's
// gathered_plan (rows over 2048 bytes: at most `blocks` blocks). `work`
// holds the plan's workspace, zero at its first use (each launch leaves
// its counters at zero); `out` D + 1 floats.
int tda_ssgd_grad_gathered(const void* X, int dtype, const void* ids, int n_s,
                           int n_blocks, int gbr, int D, int y_col, int v_col,
                           const void* w, int blocks, int chunk,
                           int stage_rows, int stages, void* work, void* out,
                           int device, void* stream) {
  if (n_s < 1 || n_blocks < 1 || gbr < 1 || blocks < 1 ||
      static_cast<long long>(n_s) * gbr >= (1LL << 30) || y_col < 0 ||
      y_col >= D || v_col < 0 || v_col >= D || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto launch = dtype == 0 ? launch_grad_gathered<float>
                           : launch_grad_gathered<__nv_bfloat16>;
  return launch(X, static_cast<const int*>(ids), n_s, n_blocks, gbr, D, y_col,
                v_col, static_cast<const float*>(w), blocks, chunk,
                stage_rows, stages, device, static_cast<float*>(work),
                static_cast<float*>(out), static_cast<cudaStream_t>(stream));
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
  auto launch = dtype == 0 ? launch_packed<float> : launch_packed<__nv_bfloat16>;
  return launch(X, n, D, y_col, v_col, static_cast<const float*>(w),
                RowSampler{key0, key1, thresh}, max_blocks,
                static_cast<float*>(partial), static_cast<float*>(out),
                static_cast<cudaStream_t>(stream));
}

// B2: idx (T, n_s) int32; w0, center and w_out (D,) float32; the plan and
// `work` as B1's (on the same stream B1 and B2 may share one workspace).
int tda_ssgd_train(const void* X, int dtype, const void* idx, int T_steps,
                   int n_s, int n_blocks, int gbr, int D, int y_col, int v_col,
                   const void* w0, const void* center, float eta, float alpha,
                   int skip_update, int blocks, int chunk, int stage_rows,
                   int stages, void* work, void* w_out, int device,
                   void* stream) {
  if (T_steps < 1 || n_s < 1 || n_blocks < 1 || gbr < 1 || blocks < 1 ||
      static_cast<long long>(n_s) * gbr >= (1LL << 30) ||
      static_cast<long long>(T_steps) * blocks >= (1LL << 32) || y_col < 0 ||
      y_col >= D || v_col < 0 || v_col >= D || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto launch = dtype == 0 ? launch_train<float> : launch_train<__nv_bfloat16>;
  return launch(X, static_cast<const int*>(idx), T_steps, n_s, n_blocks, gbr,
                D, y_col, v_col, static_cast<const float*>(w0),
                static_cast<const float*>(center), eta, alpha, skip_update,
                blocks, chunk, stage_rows, stages, device,
                static_cast<float*>(work), static_cast<float*>(w_out),
                static_cast<cudaStream_t>(stream));
}

// B3: X (n_blocks · gbr, D) row-major, ids (n_s,) int32, w (D,) float32,
// zyv (n_s · gbr / P, 3P) float32 (16-byte aligned); blocks, chunk,
// stage_rows and stages are ops/ssgd_kernels.py's forward_plan (rows over
// 2048 bytes, or stage_rows 0: `blocks` blocks of the wide body).
int tda_ssgd_forward_gathered(const void* X, int dtype, const void* ids,
                              int n_s, int n_blocks, int gbr, int D,
                              int y_col, int v_col, int P, const void* w,
                              int blocks, int chunk, int stage_rows,
                              int stages, void* zyv, int device,
                              void* stream) {
  if (n_s < 1 || n_blocks < 1 || gbr < 1 || P < 1 || gbr % P ||
      blocks < 1 || D < 1 || D > 32768 ||
      static_cast<long long>(n_s) * gbr >= (1LL << 31) || y_col < 0 ||
      y_col >= D || v_col < 0 || v_col >= D || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto launch = dtype == 0 ? launch_forward<float>
                           : launch_forward<__nv_bfloat16>;
  return launch(X, static_cast<const int*>(ids), n_s, n_blocks, gbr, D, y_col,
                v_col, P, static_cast<const float*>(w), blocks, chunk,
                stage_rows, stages, device, static_cast<float*>(zyv),
                static_cast<cudaStream_t>(stream));
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
