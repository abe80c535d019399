// Flash attention for Hopper (sm_90a): one ring step of the forward (B11)
// and of the FlashAttention-2 recompute backward (B12).
//
// Replaces flash_attention_block (kernel _kernel) and
// flash_attention_backward_block (kernels _bwd_dq_kernel, _bwd_dkv_kernel)
// of tpu_distalg/ops/pallas_attention.py, with this contract (see
// tpu_distalg_torch/ops/attention_kernels.py):
//   * q, do (H, S_q, d); k, v (H_kv, S_kv, d); query head h reads KV head
//     h / (H / H_kv); the state o (H, S_q, d) and m, l, lse, delta (H, S_q)
//     float32, all row-major; d a multiple of 128 and S_kv one of 128
//     (JAX's contract), any S_q (tail rows are masked);
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
//   * bf16 q, k, v (and dO, which the wrapper rounds to bf16 once, as the
//     TPU's MXU rounds float32 operands at default precision, ROADMAP C):
//     every tile product runs on the tensor cores (wgmma, bf16 operands,
//     float32 accumulation), "round" is to bf16, and the exponentials are
//     exp2 with log2(e) folded in (exp2(0) = 1 and exp2(-inf) = 0, so the
//     exact cases stay exact). float32 q, k, v: every product runs in
//     float32 on the CUDA cores, no rounding anywhere (the port keeps TF32
//     off).
//
// What bounds it on the card: operations. At 32k tokens, 8 heads, d 128 the
// causal forward is 2.2e12 FLOP (2.2 ms at the bf16 tensor-core peak) over
// 0.2 GB of q, k, v and state.
//
// Design of the bf16 kernels (FlashAttention-3's shape, simple first).
// A block of 384 threads: two consumer warpgroups and a producer
// warpgroup, whose registers setmaxnreg hands to the consumers.
//   * Rows. The forward and the dQ pass give a block 128 query rows of one
//     head, the dK/dV pass 128 KV rows of one KV head; each consumer
//     warpgroup owns 64 of them, which is one wgmma's M. Blocks are issued
//     heaviest first.
//   * Loads. The producer's one lane brings every tile into shared memory
//     by TMA (3-D tensor maps (d, S, H), so the rows past a head's end read
//     as zero, never as the next head's), in boxes of 64 columns with the
//     128-byte swizzle that the wgmma descriptors name. At d = 128 the
//     block's own operand stays resident (q; q and dO; k and v) and a ring
//     of stages carries the other side's tiles, guarded by full and empty
//     mbarriers, so the next tiles are in flight while the tensor cores
//     work. A stage is released after the products that read it completed.
//     In the dK/dV pass the producer's warp also stages each step's
//     lse·log2(e) and delta beside its tiles.
//   * Products. S = Q·Kᵀ and dP = dO·Vᵀ (Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ in the
//     dK/dV pass) are wgmma with both operands in shared memory, K-major.
//     The softmax, the masks, the live guard and dS run on the accumulator
//     in registers (each warp's part of it is the m16n8 layout: rows by
//     quad shuffles). P and dS are rounded to bf16 into the A fragments of
//     the next wgmma, in registers: O += P·V, dQ += dS·K, dV += Pᵀ·dO and
//     dK += dSᵀ·Q read their B (V, K, dO, Q) from shared memory as an
//     MN-major operand, so no thread ever transposes a tile.
//   * Wide heads (d = 128·n, n > 1): grid z splits the output columns in
//     groups of 128; every block sums its scores over the full d, a
//     128-column group of both operands a stage, and takes its output
//     group's operand in a stage of its own.
//   * Order. No atomics; every sum runs in a fixed order (the dK/dV pass
//     walks (group member, query step) in JAX's order, the others the KV
//     steps in order), so a replay is bitwise. Tiles are dead, full or
//     crossing by the kernel's own tiles and the global offsets.
// The float32 kernels keep the CUDA cores: a block of 4 warps per 64 rows
// and 128 output columns (grid z), tiles staged by all threads, P and dS
// through shared memory, the scores summed over d in 128-column chunks.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kSmemLimit = 232448;

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

// ------------------------------------------------ Hopper building blocks

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
  asm volatile(
      "{\n.reg .pred done;\n"
      "TDA_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra TDA_DONE;\n"
      "bra TDA_WAIT;\n"
      "TDA_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// across the asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A tile of R rows × 128 bf16 columns as TMA lays it out with the 128-byte
// swizzle: two boxes of 64 columns (128 bytes a row), box c at c·R·128
// bytes; rows 128 bytes apart, 8-row groups 1024 bytes apart.
// Descriptor of the K-major operand whose rows start at row r, for the
// 16-column step kk (0..7) of the tile.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int R, int r,
                                           int kk) {
  const uint32_t a = tile + (kk >> 2) * R * 128 + r * 128 + (kk & 3) * 32;
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
// Descriptor of the MN-major B operand (K = the tile's rows, N = its 128
// columns) for the 16-row step kb: the two 64-column boxes lie R·128
// bytes apart (leading offset), 8-row groups 1024 bytes (stride offset).
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int R, int kb) {
  const uint32_t a = tile + kb * 16 * 128;
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((R * 128) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (m64 x n64, float32) += A · B, A and B bf16 in shared memory, both
// K-major (descriptors da, db); the sum is dropped first when zero_d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int zero_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.eq.s32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(zero_d));
}

// d (m64 x n128, float32) += A · B, A and B bf16 in shared memory, both
// K-major (descriptors da, db); the sum is dropped first when zero_d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int zero_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.eq.s32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(zero_d));
}

// d (m64 x n128, float32) += A · B, A bf16 in registers (the m16n8k16
// A fragment of each warp's 16 rows), B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.s32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------- float32 (CUDA cores)

constexpr int kBQ = 64;    // query rows a forward / dQ block
constexpr int kBKVf = 64;  // KV rows a forward / dQ step, and a dK/dV block
constexpr int kBQI = 32;   // query rows a dK/dV step
constexpr int kDC = 128;   // the columns of a chunk, and a block's outputs
constexpr int kLD = kDC + 4;   // a staged chunk's row stride: rows start
                               // 4 banks apart, so the fragment loads are
                               // free of conflicts
constexpr int kLDP = kBKVf + 4;

// acc[NT][4] += A (16 × K) · B (K × 8·NT) in float32, k in order, in the
// m16n8 accumulator layout: lane 4g + t holds rows g, g + 8 and columns
// 8j + 2t, 8j + 2t + 1 of each 8-column tile j. A is row-major (row stride
// lda); B's element (k, n) sits at B[n·ldb + k] when NK, else at
// B[k·ldb + n].
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

// Rows [row0, row0 + nrows), columns [c0, c0 + kDC) of a row-major (.., d)
// float32 array into dst (row stride kLD), with 16-byte loads; rows at or
// past `valid` are zero.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int d, int c0, int row0,
                                           int nrows, int valid) {
  constexpr int kPerRow = kDC / 4;
  for (int e = threadIdx.x; e < nrows * kPerRow; e += blockDim.x) {
    const int r = e / kPerRow, c = (e % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      x = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * d + c0 + c));
    *reinterpret_cast<float4*>(dst + r * kLD + c) = x;
  }
}

// The same rows and columns, transposed into dst[c · kLDP + r].
__device__ __forceinline__ void stage_transposed(float* dst, const float* src,
                                                 int d, int c0, int row0,
                                                 int nrows) {
  constexpr int kPerRow = kDC / 4;
  for (int e = threadIdx.x; e < nrows * kPerRow; e += blockDim.x) {
    const int r = e / kPerRow, c = (e % kPerRow) * 4;
    const float4 x = __ldg(reinterpret_cast<const float4*>(
        src + static_cast<size_t>(row0 + r) * d + c0 + c));
    dst[c * kLDP + r] = x.x;
    dst[(c + 1) * kLDP + r] = x.y;
    dst[(c + 2) * kLDP + r] = x.z;
    dst[(c + 3) * kLDP + r] = x.w;
  }
}

constexpr size_t kFwdSmemF32 =
    sizeof(float) * (2 * kBQ * kLD + kDC * kLDP + 4 * 16 * kLDP);

// B11, float32: a block of 4 warps owns 64 query rows (16 a warp) and the
// output columns [128·z, 128·z + 128); the scores sum over d in chunks of
// 128 staged in shared memory (q once when d is 128).
__global__ void __launch_bounds__(128)
    fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ o0,
            const float* __restrict__ m0, const float* __restrict__ l0,
            float* __restrict__ o, float* __restrict__ m,
            float* __restrict__ l, int d, int group, int s_q, int s_kv,
            int q_off, int k_off, float scale, int causal) {
  constexpr int NS = kBKVf / 8;
  constexpr int NO = kDC / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kLD;
  float* Vt = Ks + kBQ * kLD;
  float* Ps = Vt + kDC * kLDP;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hh = blockIdx.y, c_out = blockIdx.z * kDC;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int n_valid = min(kBQ, s_q - r0);
  const float* qh = q + static_cast<size_t>(hh) * s_q * d;
  const float* kh = k + static_cast<size_t>(hh / group) * s_kv * d;
  const float* vh = v + static_cast<size_t>(hh / group) * s_kv * d;
  float* Pw = Ps + warp * 16 * kLDP;
  const int n_chunks = d / kDC;
  if (n_chunks == 1) stage_rows(Qs, qh, d, 0, r0, kBQ, n_valid);

  // the carried state of this lane's rows a = 16·warp + g and b = a + 8
  const int ra = r0 + 16 * warp + g, rb = ra + 8;
  const bool va = ra < s_q, vb = rb < s_q;
  const size_t sa = static_cast<size_t>(hh) * s_q + ra;
  const size_t sb = sa + 8;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = c_out + 8 * j + 2 * t;
    acc[j][0] = va ? o0[sa * d + c] : 0.0f;
    acc[j][1] = va ? o0[sa * d + c + 1] : 0.0f;
    acc[j][2] = vb ? o0[sb * d + c] : 0.0f;
    acc[j][3] = vb ? o0[sb * d + c + 1] : 0.0f;
  }
  float m_a = va ? m0[sa] : -INFINITY, m_b = vb ? m0[sb] : -INFINITY;
  float l_a = va ? l0[sa] : 0.0f, l_b = vb ? l0[sb] : 0.0f;

  const int q_first = q_off + r0;
  const int q_last = q_off + r0 + n_valid - 1;
  int n_tiles = s_kv / kBKVf;
  if (causal) {
    const int live = q_last - k_off;  // keys [k_off, q_last] can be seen
    n_tiles = live < 0 ? 0 : min(n_tiles, live / kBKVf + 1);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k_first = k_off + jt * kBKVf;
    float s[NS][4];
    zero(s);
    for (int ch = 0; ch < n_chunks; ++ch) {
      __syncthreads();  // the previous reads of Qs, Ks, Vt are done
      if (n_chunks > 1) stage_rows(Qs, qh, d, ch * kDC, r0, kBQ, n_valid);
      stage_rows(Ks, kh, d, ch * kDC, jt * kBKVf, kBKVf, kBKVf);
      if (ch == n_chunks - 1)
        stage_transposed(Vt, vh, d, c_out, jt * kBKVf, kBKVf);
      __syncthreads();
      warp_mma<NS, kDC, true>(s, Qs + 16 * warp * kLD, kLD, Ks, kLD, lane);
    }
    const bool full = !causal || tile_full(q_first, k_first + kBKVf - 1);
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
      float* pa = Pw + g * kLDP + 8 * j + 2 * t;
      pa[0] = p0;
      pa[1] = p1;
      pa[8 * kLDP] = p2;
      pa[8 * kLDP + 1] = p3;
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
    warp_mma<NO, kBKVf, true>(acc, Pw, kLDP, Vt, kLDP, lane);
    __syncwarp();  // P is read before the next tile overwrites it
  }

#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = c_out + 8 * j + 2 * t;
    if (va) {
      o[sa * d + c] = acc[j][0];
      o[sa * d + c + 1] = acc[j][1];
    }
    if (vb) {
      o[sb * d + c] = acc[j][2];
      o[sb * d + c + 1] = acc[j][3];
    }
  }
  if (blockIdx.z == 0 && t == 0) {
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

constexpr size_t kDqSmemF32 =
    sizeof(float) * (5 * kBQ * kLD + 4 * 16 * kLDP);

// B12's dQ pass, float32: as fwd_f32, S and dP over d in chunks; then
// dQ[:, 128·z …] += dS · K[:, 128·z …].
__global__ void __launch_bounds__(128)
    dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int d, int group, int s_q, int s_kv,
           int q_off, int k_off, float scale, int causal) {
  constexpr int NS = kBKVf / 8;
  constexpr int NO = kDC / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ds = Qs + kBQ * kLD;  // dO
  float* Ks = Ds + kBQ * kLD;
  float* Vs = Ks + kBKVf * kLD;
  float* Ko = Vs + kBKVf * kLD;  // K's output columns
  float* Ps = Ko + kBKVf * kLD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hh = blockIdx.y, c_out = blockIdx.z * kDC;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int n_valid = min(kBQ, s_q - r0);
  const size_t hrow = static_cast<size_t>(hh) * s_q;
  const float* kh = k + static_cast<size_t>(hh / group) * s_kv * d;
  const float* vh = v + static_cast<size_t>(hh / group) * s_kv * d;
  float* Pw = Ps + warp * 16 * kLDP;
  const int n_chunks = d / kDC;
  if (n_chunks == 1) {
    stage_rows(Qs, q + hrow * d, d, 0, r0, kBQ, n_valid);
    stage_rows(Ds, dout + hrow * d, d, 0, r0, kBQ, n_valid);
  }
  const int ra = r0 + 16 * warp + g, rb = ra + 8;
  const bool va = ra < s_q, vb = rb < s_q;
  const float lse_a = va ? lse[hrow + ra] : 0.0f;
  const float lse_b = vb ? lse[hrow + rb] : 0.0f;
  const float dl_a = va ? delta[hrow + ra] : 0.0f;
  const float dl_b = vb ? delta[hrow + rb] : 0.0f;

  float acc[NO][4];
  zero(acc);
  const int q_first = q_off + r0;
  const int q_last = q_off + r0 + n_valid - 1;
  int n_tiles = s_kv / kBKVf;
  if (causal) {
    const int live = q_last - k_off;  // keys [k_off, q_last] can be seen
    n_tiles = live < 0 ? 0 : min(n_tiles, live / kBKVf + 1);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k_first = k_off + jt * kBKVf;
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    for (int ch = 0; ch < n_chunks; ++ch) {
      __syncthreads();
      if (n_chunks > 1) {
        stage_rows(Qs, q + hrow * d, d, ch * kDC, r0, kBQ, n_valid);
        stage_rows(Ds, dout + hrow * d, d, ch * kDC, r0, kBQ, n_valid);
      }
      stage_rows(Ks, kh, d, ch * kDC, jt * kBKVf, kBKVf, kBKVf);
      stage_rows(Vs, vh, d, ch * kDC, jt * kBKVf, kBKVf, kBKVf);
      if (ch == n_chunks - 1 && n_chunks > 1)
        stage_rows(Ko, kh, d, c_out, jt * kBKVf, kBKVf, kBKVf);
      __syncthreads();
      warp_mma<NS, kDC, true>(s, Qs + 16 * warp * kLD, kLD, Ks, kLD, lane);
      warp_mma<NS, kDC, true>(dp, Ds + 16 * warp * kLD, kLD, Vs, kLD, lane);
    }
    const bool full = !causal || tile_full(q_first, k_first + kBKVf - 1);
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
        Pw[(g + (row_a ? 0 : 8)) * kLDP + 8 * j + 2 * t + (e & 1)] = ds;
      }
    }
    __syncwarp();
    warp_mma<NO, kBKVf, false>(acc, Pw, kLDP, n_chunks > 1 ? Ko : Ks, kLD,
                               lane);
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = c_out + 8 * j + 2 * t;
    if (va) {
      dq[(hrow + ra) * d + c] = acc[j][0];
      dq[(hrow + ra) * d + c + 1] = acc[j][1];
    }
    if (vb) {
      dq[(hrow + rb) * d + c] = acc[j][2];
      dq[(hrow + rb) * d + c + 1] = acc[j][3];
    }
  }
}

constexpr int kLDQ = kBQI + 4;
constexpr size_t kDkvSmemF32 =
    sizeof(float) * (2 * kBKVf * kLD + 2 * kBQI * kLD + 4 * 16 * kLDQ +
                     2 * kBQI);

// B12's dK/dV pass, float32: a block of 4 warps owns 64 KV rows and the
// output columns [128·z, 128·z + 128); it walks (group member, 32-row
// query step) in order, Sᵀ and dPᵀ over d in chunks, then dV += Pᵀ·dO and
// dK += dSᵀ·Q on the output columns.
__global__ void __launch_bounds__(128)
    dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int d, int group,
            int s_q, int s_kv, int q_off, int k_off, float scale,
            int causal) {
  constexpr int NS = kBQI / 8;
  constexpr int NO = kDC / 8;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBKVf * kLD;
  float* Qs = Vs + kBKVf * kLD;
  float* Ds = Qs + kBQI * kLD;  // dO
  float* Ps = Ds + kBQI * kLD;
  float* lse_s = Ps + 4 * 16 * kLDQ;
  float* dl_s = lse_s + kBQI;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hk = blockIdx.y, c_out = blockIdx.z * kDC;
  const int c0 = blockIdx.x * kBKVf;  // heaviest (earliest keys) first
  const size_t kvrow = static_cast<size_t>(hk) * s_kv;
  float* Pw = Ps + warp * 16 * kLDQ;
  const int n_chunks = d / kDC;
  if (n_chunks == 1) {
    stage_rows(Ks, k + kvrow * d, d, 0, c0, kBKVf, kBKVf);
    stage_rows(Vs, v + kvrow * d, d, 0, c0, kBKVf, kBKVf);
  }
  // this lane's KV rows a = 16·warp + g and b = a + 8, at global positions
  const int pos_a = k_off + c0 + 16 * warp + g, pos_b = pos_a + 8;
  const int k_first = k_off + c0, k_last = k_first + kBKVf - 1;

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
      float s[NS][4], dp[NS][4];
      zero(s);
      zero(dp);
      for (int ch = 0; ch < n_chunks; ++ch) {
        __syncthreads();  // the previous step's reads are done
        if (n_chunks > 1) {
          stage_rows(Ks, k + kvrow * d, d, ch * kDC, c0, kBKVf, kBKVf);
          stage_rows(Vs, v + kvrow * d, d, ch * kDC, c0, kBKVf, kBKVf);
        }
        stage_rows(Qs, q + hrow * d, d, ch * kDC, r0, kBQI, n_valid);
        stage_rows(Ds, dout + hrow * d, d, ch * kDC, r0, kBQI, n_valid);
        for (int i = threadIdx.x; i < kBQI; i += blockDim.x) {
          lse_s[i] = i < n_valid ? lse[hrow + r0 + i] : 0.0f;
          dl_s[i] = i < n_valid ? delta[hrow + r0 + i] : 0.0f;
        }
        __syncthreads();
        // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for this warp's 16 KV rows
        warp_mma<NS, kDC, true>(s, Ks + 16 * warp * kLD, kLD, Qs, kLD, lane);
        warp_mma<NS, kDC, true>(dp, Vs + 16 * warp * kLD, kLD, Ds, kLD,
                                lane);
      }
      if (n_chunks > 1) {  // Q and dO at the output columns
        __syncthreads();
        stage_rows(Qs, q + hrow * d, d, c_out, r0, kBQI, n_valid);
        stage_rows(Ds, dout + hrow * d, d, c_out, r0, kBQI, n_valid);
        __syncthreads();
      }
      const bool full = !causal || tile_full(q_first, k_last);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);  // query row in the step
          const bool keep = col < n_valid &&
                            (full || q_first + col >= (e < 2 ? pos_a : pos_b));
          s[j][e] = keep ? expf(s[j][e] * scale - lse_s[col]) : 0.0f;
          Pw[(g + (e < 2 ? 0 : 8)) * kLDQ + col] = s[j][e];
        }
      }
      __syncwarp();
      warp_mma<NO, kBQI, false>(acc_v, Pw, kLDQ, Ds, kLD, lane);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const float ds = (s[j][e] * (dp[j][e] - dl_s[col])) * scale;
          Pw[(g + (e < 2 ? 0 : 8)) * kLDQ + col] = ds;
        }
      }
      __syncwarp();
      warp_mma<NO, kBQI, false>(acc_k, Pw, kLDQ, Qs, kLD, lane);
      __syncwarp();
    }
  }
  const size_t ra = kvrow + c0 + 16 * warp + g, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = c_out + 8 * j + 2 * t;
    dk[ra * d + c] = acc_k[j][0];
    dk[ra * d + c + 1] = acc_k[j][1];
    dk[rb * d + c] = acc_k[j][2];
    dk[rb * d + c + 1] = acc_k[j][3];
    dv[ra * d + c] = acc_v[j][0];
    dv[ra * d + c + 1] = acc_v[j][1];
    dv[rb * d + c] = acc_v[j][2];
    dv[rb * d + c + 1] = acc_v[j][3];
  }
}

// ---------------------------------------------- bf16 (wgmma, TMA, Hopper)

constexpr int kRows = 128;            // a block's rows: 2 warpgroups of 64
constexpr int kConsumers = 256;       // the two consumer warpgroups
constexpr int kThreadsH = kConsumers + 128;  // + the producer warpgroup
constexpr int kTile = 128;            // the columns of a staged tile
constexpr int kFwdBKV = 128;          // KV rows a forward step
constexpr int kDqBKV = 64;            // KV rows a dQ step
constexpr int kDkvBQ = 64;            // query rows a dK/dV step
constexpr float kLog2e = 1.4426950408889634f;

// The registers of the block (168 a thread at launch, 384 threads) move
// from the producer warpgroup, which needs few, to the consumers, which
// hold two accumulators each: 128 · 24 + 256 · 240 = 168 · 384.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// bytes of a staged R-row tile (two 64-column boxes of R · 128 bytes)
__host__ __device__ constexpr int tile_bytes(int R) { return R * 256; }

// A tile of R rows × 128 columns starting at (column c, row r) of head h,
// by two TMA boxes, completing on `bar`.
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c, int r, int h,
                                          int R) {
  tma_load(dst, map, bar, c, r, h);
  tma_load(dst + R * 128, map, bar, c + 64, r, h);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The ring of staged tiles: a stage index and its phase, walked in the
// same order by the producer and the consumers.
struct Ring {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void next(int n) {
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// A consumer warp is done with a stage: after its products completed.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The shared memory of a Hopper kernel: [resident tiles][stages × slot]
// [full and empty barriers, the resident barrier], 1024-aligned.
__host__ __device__ constexpr size_t hopper_smem(int resident, int stages,
                                                 int slot) {
  return 1024 + static_cast<size_t>(resident) +
         static_cast<size_t>(stages) * slot + 8 * (2 * stages + 1);
}

// ------------------------------------------------------ B11, bf16

// RES (d = 128): Q stays resident and a stage holds K and V of a step.
// Else (d = 128·n, n > 1): the scores sum over d in 128-column groups, a
// stage holding (Q, K) of a group, and the block's 128 output columns
// (grid z) of V come in a stage of their own.
template <bool RES>
struct FwdPlan {
  static constexpr int kSlot = 2 * tile_bytes(kRows);
  static constexpr int kStages = RES ? 2 : 3;
  static constexpr int kResident = RES ? tile_bytes(kRows) : 0;
  static constexpr size_t kSmem = hopper_smem(kResident, kStages, kSlot);
};

template <bool RES>
__global__ void __launch_bounds__(kThreadsH, 1)
    fwd_hopper(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ o0, const float* __restrict__ m0,
               const float* __restrict__ l0, float* __restrict__ o,
               float* __restrict__ m, float* __restrict__ l, int d,
               int group, int s_q, int s_kv, int q_off, int k_off,
               float scale, int causal) {
  using Plan = FwdPlan<RES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* qres = base;
  uint8_t* ring = base + Plan::kResident;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Plan::kStages *
                                                          Plan::kSlot);
  uint64_t* empty = full + Plan::kStages;
  uint64_t* resbar = empty + Plan::kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hh = blockIdx.y, hk = hh / group, zc = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const int n_valid = min(kRows, s_q - r0);
  const int ng = RES ? 1 : d / kTile;
  const int q_first = q_off + r0;
  const int q_last = q_first + n_valid - 1;
  int n_tiles = s_kv / kFwdBKV;
  if (causal) {
    const int live = q_last - k_off;  // keys [k_off, q_last] can be seen
    n_tiles = live < 0 ? 0 : min(n_tiles, live / kFwdBKV + 1);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < Plan::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers / 32);
    }
    mbar_init(resbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one lane works
    producer_regs();
    if (warp == kConsumers / 32 && lane == 0) {
      if (RES) {
        mbar_expect_tx(resbar, tile_bytes(kRows));
        load_tile(qres, &tq, resbar, 0, r0, hh, kRows);
      }
      Ring ring_p;
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int kv0 = jt * kFwdBKV;
        for (int gi = 0; gi < ng; ++gi) {
          uint8_t* slot = ring + ring_p.stage * Plan::kSlot;
          uint64_t* fb = &full[ring_p.stage];
          mbar_wait(&empty[ring_p.stage], ring_p.phase ^ 1);
          mbar_expect_tx(fb, Plan::kSlot);
          if (RES) {
            load_tile(slot, &tk, fb, 0, kv0, hk, kFwdBKV);
            load_tile(slot + tile_bytes(kRows), &tv, fb, 0, kv0, hk, kFwdBKV);
          } else {
            load_tile(slot, &tq, fb, gi * kTile, r0, hh, kRows);
            load_tile(slot + tile_bytes(kRows), &tk, fb, gi * kTile, kv0, hk,
                      kFwdBKV);
          }
          ring_p.next(Plan::kStages);
        }
        if (!RES) {
          mbar_wait(&empty[ring_p.stage], ring_p.phase ^ 1);
          mbar_expect_tx(&full[ring_p.stage], tile_bytes(kFwdBKV));
          load_tile(ring + ring_p.stage * Plan::kSlot, &tv,
                    &full[ring_p.stage], zc * kTile, kv0, hk, kFwdBKV);
          ring_p.next(Plan::kStages);
        }
      }
    }
    return;
  }
  consumer_regs();

  // the consumers: warpgroup wg owns rows [64·wg, 64·wg + 64) of the block,
  // its warp wl rows 16·wl + g and + 8 in the m16n8 layout
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ra = r0 + 64 * wg + 16 * wl + g, rb = ra + 8;
  const bool va = ra < s_q, vb = rb < s_q;
  const size_t sa = static_cast<size_t>(hh) * s_q + ra;
  const size_t sb = sa + 8;
  const int c_out = zc * kTile;
  float acc[64];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c_out + 8 * j + 2 * t;
    acc[4 * j] = va ? o0[sa * d + c] : 0.0f;
    acc[4 * j + 1] = va ? o0[sa * d + c + 1] : 0.0f;
    acc[4 * j + 2] = vb ? o0[sb * d + c] : 0.0f;
    acc[4 * j + 3] = vb ? o0[sb * d + c + 1] : 0.0f;
  }
  float m_a = va ? m0[sa] : -INFINITY, m_b = vb ? m0[sb] : -INFINITY;
  float l_a = va ? l0[sa] : 0.0f, l_b = vb ? l0[sb] : 0.0f;
  if (RES) mbar_wait(resbar, 0);
  const uint32_t qres_a = smem_u32(qres);
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.0f;
  Ring rc;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k_first = k_off + jt * kFwdBKV;
    uint32_t vtile = 0;
    for (int gi = 0; gi < ng; ++gi) {
      mbar_wait(&full[rc.stage], rc.phase);
      const uint32_t slot = smem_u32(ring + rc.stage * Plan::kSlot);
      const uint32_t at = RES ? qres_a : slot;
      const uint32_t bt = slot + tile_bytes(kRows) * (RES ? 0 : 1);
      wg_fence();
      reg_fence(s);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_ss_n128(s, desc_k(at, kRows, 64 * wg, kk),
                      desc_k(bt, kFwdBKV, 0, kk), gi == 0 && kk == 0);
      wg_commit();
      wg_wait0();
      reg_fence(s);
      if (RES) {
        vtile = slot + tile_bytes(kRows);  // released after P·V
      } else {
        release(&empty[rc.stage], lane);
        rc.next(Plan::kStages);
      }
    }
    if (!RES) {
      mbar_wait(&full[rc.stage], rc.phase);
      vtile = smem_u32(ring + rc.stage * Plan::kSlot);
    }
    // the online softmax on the scores in registers
    const bool full_tile = !causal || tile_full(q_first, k_first + kFwdBKV - 1);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale;
        if (!full_tile) {
          const int qpos = q_off + (e < 2 ? ra : rb);
          const int kpos = k_first + 8 * j + 2 * t + (e & 1);
          if (qpos < kpos) x = kNeg;
        }
        s[4 * j + e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const bool live_a = full_tile || mn_a > kNeg / 2;
    const bool live_b = full_tile || mn_b > kNeg / 2;
    const float ml_a = mn_a * kLog2e, ml_b = mn_b * kLog2e;
    const float al_a = live_a ? exp2f(fmaf(m_a, kLog2e, -ml_a)) : 0.0f;
    const float al_b = live_b ? exp2f(fmaf(m_b, kLog2e, -ml_b)) : 0.0f;
    float sum_a = 0.0f, sum_b = 0.0f;
    uint32_t pk[32];  // P rounded to bf16: the A fragments of P·V
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = live_a ? exp2f(fmaf(s[4 * j], kLog2e, -ml_a)) : 0.0f;
      const float p1 =
          live_a ? exp2f(fmaf(s[4 * j + 1], kLog2e, -ml_a)) : 0.0f;
      const float p2 =
          live_b ? exp2f(fmaf(s[4 * j + 2], kLog2e, -ml_b)) : 0.0f;
      const float p3 =
          live_b ? exp2f(fmaf(s[4 * j + 3], kLog2e, -ml_b)) : 0.0f;
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      pk[2 * j] = pack_bf16(p0, p1);
      pk[2 * j + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * al_a + quad_sum(sum_a);
    l_b = l_b * al_b + quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[4 * j] *= al_a;
      acc[4 * j + 1] *= al_a;
      acc[4 * j + 2] *= al_b;
      acc[4 * j + 3] *= al_b;
    }
    wg_fence();
    reg_fence(acc);
#pragma unroll
    for (int kb = 0; kb < kFwdBKV / 16; ++kb) {
      const uint32_t a[4] = {pk[4 * kb], pk[4 * kb + 1], pk[4 * kb + 2],
                             pk[4 * kb + 3]};
      wgmma_rs_n128(acc, a, desc_mn(vtile, kFwdBKV, kb));
    }
    wg_commit();
    wg_wait0();
    reg_fence(acc);
    release(&empty[rc.stage], lane);
    rc.next(Plan::kStages);
  }

#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c_out + 8 * j + 2 * t;
    if (va)
      *reinterpret_cast<float2*>(o + sa * d + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (vb)
      *reinterpret_cast<float2*>(o + sb * d + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (zc == 0 && t == 0) {
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

// ------------------------------------------------- B12, dQ, bf16

// RES (d = 128): Q and dO stay resident, a stage holds K and V of a step
// (K is also dQ's operand). Else: a stage holds (Q, dO, K, V) of a
// 128-column group, and K at the block's output columns comes in a stage
// of its own.
template <bool RES>
struct DqPlan {
  static constexpr int kSlot =
      RES ? 2 * tile_bytes(kDqBKV) : 2 * tile_bytes(kRows) +
                                         2 * tile_bytes(kDqBKV);
  static constexpr int kStages = RES ? 4 : 2;
  static constexpr int kResident = RES ? 2 * tile_bytes(kRows) : 0;
  static constexpr size_t kSmem = hopper_smem(kResident, kStages, kSlot);
};

template <bool RES>
__global__ void __launch_bounds__(kThreadsH, 1)
    dq_hopper(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int d, int group, int s_q, int s_kv,
              int q_off, int k_off, float scale, int causal) {
  using Plan = DqPlan<RES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* qres = base;  // RES: Q, then dO
  uint8_t* ring = base + Plan::kResident;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Plan::kStages *
                                                          Plan::kSlot);
  uint64_t* empty = full + Plan::kStages;
  uint64_t* resbar = empty + Plan::kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hh = blockIdx.y, hk = hh / group, zc = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int n_valid = min(kRows, s_q - r0);
  const int ng = RES ? 1 : d / kTile;
  const int q_first = q_off + r0;
  const int q_last = q_first + n_valid - 1;
  int n_tiles = s_kv / kDqBKV;
  if (causal) {
    const int live = q_last - k_off;
    n_tiles = live < 0 ? 0 : min(n_tiles, live / kDqBKV + 1);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < Plan::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers / 32);
    }
    mbar_init(resbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    producer_regs();
    if (warp == kConsumers / 32 && lane == 0) {
      if (RES) {
        mbar_expect_tx(resbar, 2 * tile_bytes(kRows));
        load_tile(qres, &tq, resbar, 0, r0, hh, kRows);
        load_tile(qres + tile_bytes(kRows), &tdo, resbar, 0, r0, hh, kRows);
      }
      Ring ring_p;
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int kv0 = jt * kDqBKV;
        for (int gi = 0; gi < ng; ++gi) {
          uint8_t* slot = ring + ring_p.stage * Plan::kSlot;
          uint64_t* fb = &full[ring_p.stage];
          mbar_wait(&empty[ring_p.stage], ring_p.phase ^ 1);
          mbar_expect_tx(fb, Plan::kSlot);
          if (!RES) {
            load_tile(slot, &tq, fb, gi * kTile, r0, hh, kRows);
            load_tile(slot + tile_bytes(kRows), &tdo, fb, gi * kTile, r0, hh,
                      kRows);
            slot += 2 * tile_bytes(kRows);
          }
          load_tile(slot, &tk, fb, gi * kTile, kv0, hk, kDqBKV);
          load_tile(slot + tile_bytes(kDqBKV), &tv, fb, gi * kTile, kv0, hk,
                    kDqBKV);
          ring_p.next(Plan::kStages);
        }
        if (!RES) {
          mbar_wait(&empty[ring_p.stage], ring_p.phase ^ 1);
          mbar_expect_tx(&full[ring_p.stage], tile_bytes(kDqBKV));
          load_tile(ring + ring_p.stage * Plan::kSlot, &tk,
                    &full[ring_p.stage], zc * kTile, kv0, hk, kDqBKV);
          ring_p.next(Plan::kStages);
        }
      }
    }
    return;
  }
  consumer_regs();

  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ra = r0 + 64 * wg + 16 * wl + g, rb = ra + 8;
  const bool va = ra < s_q, vb = rb < s_q;
  const size_t hrow = static_cast<size_t>(hh) * s_q;
  // exp(s·scale − lse) = exp2(s·scale·log2e − lse·log2e)
  const float sl2 = scale * kLog2e;
  const float ll_a = va ? lse[hrow + ra] * kLog2e : 0.0f;
  const float ll_b = vb ? lse[hrow + rb] * kLog2e : 0.0f;
  const float dl_a = va ? delta[hrow + ra] : 0.0f;
  const float dl_b = vb ? delta[hrow + rb] : 0.0f;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
  if (RES) mbar_wait(resbar, 0);
  const uint32_t qres_a = smem_u32(qres);
  Ring rc;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k_first = k_off + jt * kDqBKV;
    uint32_t ktile = 0;
    for (int gi = 0; gi < ng; ++gi) {
      mbar_wait(&full[rc.stage], rc.phase);
      uint32_t slot = smem_u32(ring + rc.stage * Plan::kSlot);
      uint32_t qt = qres_a, dt = qres_a + tile_bytes(kRows);
      if (!RES) {
        qt = slot;
        dt = slot + tile_bytes(kRows);
        slot += 2 * tile_bytes(kRows);
      }
      wg_fence();
      reg_fence(s);
      reg_fence(dp);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_ss_n64(s, desc_k(qt, kRows, 64 * wg, kk),
                     desc_k(slot, kDqBKV, 0, kk), gi == 0 && kk == 0);
        wgmma_ss_n64(dp, desc_k(dt, kRows, 64 * wg, kk),
                     desc_k(slot + tile_bytes(kDqBKV), kDqBKV, 0, kk),
                     gi == 0 && kk == 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence(s);
      reg_fence(dp);
      if (RES) {
        ktile = slot;  // released after dS·K
      } else {
        release(&empty[rc.stage], lane);
        rc.next(Plan::kStages);
      }
    }
    if (!RES) {
      mbar_wait(&full[rc.stage], rc.phase);
      ktile = smem_u32(ring + rc.stage * Plan::kSlot);
    }
    const bool full_tile = !causal || tile_full(q_first, k_first + kDqBKV - 1);
    uint32_t pk[16];  // dS rounded to bf16: the A fragments of dS·K
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool row_a = e < 2;
        const int kpos = k_first + 8 * j + 2 * t + (e & 1);
        const bool keep = (row_a ? va : vb) &&
                          (full_tile || q_off + (row_a ? ra : rb) >= kpos);
        const float p =
            keep ? exp2f(fmaf(s[4 * j + e], sl2, -(row_a ? ll_a : ll_b)))
                 : 0.0f;
        ds[e] = (p * (dp[4 * j + e] - (row_a ? dl_a : dl_b))) * scale;
      }
      pk[2 * j] = pack_bf16(ds[0], ds[1]);
      pk[2 * j + 1] = pack_bf16(ds[2], ds[3]);
    }
    wg_fence();
    reg_fence(acc);
#pragma unroll
    for (int kb = 0; kb < kDqBKV / 16; ++kb) {
      const uint32_t a[4] = {pk[4 * kb], pk[4 * kb + 1], pk[4 * kb + 2],
                             pk[4 * kb + 3]};
      wgmma_rs_n128(acc, a, desc_mn(ktile, kDqBKV, kb));
    }
    wg_commit();
    wg_wait0();
    reg_fence(acc);
    release(&empty[rc.stage], lane);
    rc.next(Plan::kStages);
  }
  const int c_out = zc * kTile;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c_out + 8 * j + 2 * t;
    if (va)
      *reinterpret_cast<float2*>(dq + (hrow + ra) * d + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (vb)
      *reinterpret_cast<float2*>(dq + (hrow + rb) * d + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------- B12, dK/dV, bf16

// RES (d = 128): K and V stay resident, a stage holds Q and dO of a step
// (also the operands of dV and dK). Else: a stage holds (K, V, Q, dO) of
// a 128-column group, and Q and dO at the block's output columns come in
// a stage of their own. The stage of dV's and dK's operands also holds
// the step's lse·log2(e) and delta, which the producer warp stages.
// lse·log2(e) and delta of query rows [r0, r0 + kDkvBQ) of a head into
// dst[0, kDkvBQ) and dst[kDkvBQ, 2·kDkvBQ), by the 32 lanes of a warp (0
// past S_q); the warp synchronises before one lane signals the stage.
__device__ __forceinline__ void stage_stats(float* dst,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            size_t hrow, int r0, int s_q,
                                            int lane) {
  for (int i = lane; i < kDkvBQ; i += 32) {
    const bool ok = r0 + i < s_q;
    dst[i] = ok ? __ldg(lse + hrow + r0 + i) * kLog2e : 0.0f;
    dst[kDkvBQ + i] = ok ? __ldg(delta + hrow + r0 + i) : 0.0f;
  }
  __syncwarp();
}

template <bool RES>
struct DkvPlan {
  // the step's tiles, then 1 KB: lse·log2(e) and delta of its query rows
  static constexpr int kStats =
      RES ? 2 * tile_bytes(kDkvBQ) : 2 * tile_bytes(kRows) +
                                         2 * tile_bytes(kDkvBQ);
  static constexpr int kSlot = kStats + 1024;
  static constexpr int kStages = RES ? 4 : 2;
  static constexpr int kResident = RES ? 2 * tile_bytes(kRows) : 0;
  static constexpr size_t kSmem = hopper_smem(kResident, kStages, kSlot);
};

template <bool RES>
__global__ void __launch_bounds__(kThreadsH, 1)
    dkv_hopper(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int d, int group, int s_q, int s_kv,
               int q_off, int k_off, float scale, int causal) {
  using Plan = DkvPlan<RES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* kres = base;  // RES: K, then V
  uint8_t* ring = base + Plan::kResident;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Plan::kStages *
                                                          Plan::kSlot);
  uint64_t* empty = full + Plan::kStages;
  uint64_t* resbar = empty + Plan::kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = blockIdx.y, zc = blockIdx.z;
  const int c0 = blockIdx.x * kRows;  // heaviest (earliest keys) first
  const int ng = RES ? 1 : d / kTile;
  const int k_first = k_off + c0, k_last = k_first + kRows - 1;
  const int n_q = (s_q + kDkvBQ - 1) / kDkvBQ;
  if (threadIdx.x == 0) {
    for (int i = 0; i < Plan::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers / 32);
    }
    mbar_init(resbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // (group member, query step) in order, skipping the dead steps
  auto dead = [&](int qi) {
    const int r0 = qi * kDkvBQ;
    return causal &&
           tile_dead(q_off + r0 + min(kDkvBQ, s_q - r0) - 1, k_first);
  };
  if (warp >= kConsumers / 32) {
    producer_regs();
    if (warp == kConsumers / 32) {  // lane 0 loads tiles, the warp stats
      if (RES && lane == 0) {
        mbar_expect_tx(resbar, 2 * tile_bytes(kRows));
        load_tile(kres, &tk, resbar, 0, c0, hk, kRows);
        load_tile(kres + tile_bytes(kRows), &tv, resbar, 0, c0, hk, kRows);
      }
      Ring ring_p;
      for (int gm = 0; gm < group; ++gm) {
        const int hh = hk * group + gm;
        const size_t hrow = static_cast<size_t>(hh) * s_q;
        for (int qi = 0; qi < n_q; ++qi) {
          if (dead(qi)) continue;
          const int r0 = qi * kDkvBQ;
          // every lane waits on every stage, so no lane can run a phase
          // ahead of the consumers (a barrier tells phases apart by parity)
          for (int gi = 0; gi < ng; ++gi) {
            uint8_t* slot = ring + ring_p.stage * Plan::kSlot;
            uint64_t* fb = &full[ring_p.stage];
            mbar_wait(&empty[ring_p.stage], ring_p.phase ^ 1);
            if (RES)
              stage_stats(reinterpret_cast<float*>(slot + Plan::kStats), lse,
                          delta, hrow, r0, s_q, lane);
            if (lane == 0) {
              mbar_expect_tx(fb, Plan::kStats);
              if (!RES) {
                load_tile(slot, &tk, fb, gi * kTile, c0, hk, kRows);
                load_tile(slot + tile_bytes(kRows), &tv, fb, gi * kTile, c0,
                          hk, kRows);
                slot += 2 * tile_bytes(kRows);
              }
              load_tile(slot, &tq, fb, gi * kTile, r0, hh, kDkvBQ);
              load_tile(slot + tile_bytes(kDkvBQ), &tdo, fb, gi * kTile, r0,
                        hh, kDkvBQ);
            }
            ring_p.next(Plan::kStages);
          }
          if (!RES) {
            uint8_t* slot = ring + ring_p.stage * Plan::kSlot;
            uint64_t* fb = &full[ring_p.stage];
            mbar_wait(&empty[ring_p.stage], ring_p.phase ^ 1);
            stage_stats(reinterpret_cast<float*>(slot + Plan::kStats), lse,
                        delta, hrow, r0, s_q, lane);
            if (lane == 0) {
              mbar_expect_tx(fb, 2 * tile_bytes(kDkvBQ));
              load_tile(slot, &tq, fb, zc * kTile, r0, hh, kDkvBQ);
              load_tile(slot + tile_bytes(kDkvBQ), &tdo, fb, zc * kTile, r0,
                        hh, kDkvBQ);
            }
            ring_p.next(Plan::kStages);
          }
        }
      }
    }
    return;
  }
  consumer_regs();

  // warpgroup wg owns KV rows [64·wg, 64·wg + 64) of the block
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int pos_a = k_first + 64 * wg + 16 * wl + g, pos_b = pos_a + 8;
  const float sl2 = scale * kLog2e;
  float acc_k[64], acc_v[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.0f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
  if (RES) mbar_wait(resbar, 0);
  const uint32_t kres_a = smem_u32(kres);
  Ring rc;
  for (int gm = 0; gm < group; ++gm) {
    for (int qi = 0; qi < n_q; ++qi) {
      if (dead(qi)) continue;
      const int r0 = qi * kDkvBQ;
      const int q_first = q_off + r0;
      uint32_t qdo = 0;  // Q, then dO, at the output columns
      for (int gi = 0; gi < ng; ++gi) {
        mbar_wait(&full[rc.stage], rc.phase);
        uint32_t slot = smem_u32(ring + rc.stage * Plan::kSlot);
        uint32_t kt = kres_a, vt = kres_a + tile_bytes(kRows);
        if (!RES) {
          kt = slot;
          vt = slot + tile_bytes(kRows);
          slot += 2 * tile_bytes(kRows);
        }
        wg_fence();
        reg_fence(s);
        reg_fence(dp);
        // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for this warpgroup's 64 KV rows
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_ss_n64(s, desc_k(kt, kRows, 64 * wg, kk),
                       desc_k(slot, kDkvBQ, 0, kk), gi == 0 && kk == 0);
          wgmma_ss_n64(dp, desc_k(vt, kRows, 64 * wg, kk),
                       desc_k(slot + tile_bytes(kDkvBQ), kDkvBQ, 0, kk),
                       gi == 0 && kk == 0);
        }
        wg_commit();
        wg_wait0();
        reg_fence(s);
        reg_fence(dp);
        if (RES) {
          qdo = slot;  // released after the dV and dK products
        } else {
          release(&empty[rc.stage], lane);
          rc.next(Plan::kStages);
        }
      }
      if (!RES) {
        mbar_wait(&full[rc.stage], rc.phase);
        qdo = smem_u32(ring + rc.stage * Plan::kSlot);
      }
      const bool full_tile = !causal || tile_full(q_first, k_last);
      // lse·log2(e), then delta, of the step's query rows
      const float* stats = reinterpret_cast<const float*>(
          ring + rc.stage * Plan::kSlot + Plan::kStats);
      uint32_t pp[16], pd[16];  // Pᵀ and dSᵀ in bf16: the A fragments
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;  // query row in the step
          const bool ok = r0 + col < s_q;
          const float ll = stats[col];
          const float dl = stats[kDkvBQ + col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // KV row a, then b
            const int i = 4 * j + 2 * h + e;
            const bool keep =
                ok && (full_tile || q_first + col >= (h ? pos_b : pos_a));
            p[2 * h + e] = keep ? exp2f(fmaf(s[i], sl2, -ll)) : 0.0f;
            ds[2 * h + e] = (p[2 * h + e] * (dp[i] - dl)) * scale;
          }
        }
        pp[2 * j] = pack_bf16(p[0], p[1]);
        pp[2 * j + 1] = pack_bf16(p[2], p[3]);
        pd[2 * j] = pack_bf16(ds[0], ds[1]);
        pd[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
      wg_fence();
      reg_fence(acc_v);
      reg_fence(acc_k);
#pragma unroll
      for (int kb = 0; kb < kDkvBQ / 16; ++kb) {
        const uint32_t a[4] = {pp[4 * kb], pp[4 * kb + 1], pp[4 * kb + 2],
                               pp[4 * kb + 3]};
        wgmma_rs_n128(acc_v, a, desc_mn(qdo + tile_bytes(kDkvBQ), kDkvBQ, kb));
      }
#pragma unroll
      for (int kb = 0; kb < kDkvBQ / 16; ++kb) {
        const uint32_t a[4] = {pd[4 * kb], pd[4 * kb + 1], pd[4 * kb + 2],
                               pd[4 * kb + 3]};
        wgmma_rs_n128(acc_k, a, desc_mn(qdo, kDkvBQ, kb));
      }
      wg_commit();
      wg_wait0();
      reg_fence(acc_v);
      reg_fence(acc_k);
      release(&empty[rc.stage], lane);
      rc.next(Plan::kStages);
    }
  }
  const size_t ra = static_cast<size_t>(hk) * s_kv + c0 + 64 * wg + 16 * wl +
                    g;
  const size_t rb = ra + 8;
  const int c_out = zc * kTile;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c_out + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(dk + ra * d + c) =
        make_float2(acc_k[4 * j], acc_k[4 * j + 1]);
    *reinterpret_cast<float2*>(dk + rb * d + c) =
        make_float2(acc_k[4 * j + 2], acc_k[4 * j + 3]);
    *reinterpret_cast<float2*>(dv + ra * d + c) =
        make_float2(acc_v[4 * j], acc_v[4 * j + 1]);
    *reinterpret_cast<float2*>(dv + rb * d + c) =
        make_float2(acc_v[4 * j + 2], acc_v[4 * j + 3]);
  }
}

// ------------------------------------------------------------ launches

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The 3-D map (d, S, H) of a row-major bf16 (H, S, d) array, in boxes of
// 64 columns × `rows` rows with the 128-byte swizzle; rows past S read as
// zero, never as the next head's.
bool tensor_map(CUtensorMap* map, const void* p, int d, int s, int h,
                int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool RES>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v,
                            const float* o0, const float* m0, const float* l0,
                            float* o, float* m, float* l, int h, int h_kv,
                            int s_q, int s_kv, int d, int q_off, int k_off,
                            float scale, int causal, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, d, s_q, h, kRows) ||
      !tensor_map(&tk, k, d, s_kv, h_kv, kFwdBKV) ||
      !tensor_map(&tv, v, d, s_kv, h_kv, kFwdBKV))
    return cudaErrorInvalidValue;
  constexpr size_t smem = FwdPlan<RES>::kSmem;
  auto kernel = fwd_hopper<RES>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + kRows - 1) / kRows, h, d / kTile);
  kernel<<<grid, kThreadsH, smem, s>>>(tq, tk, tv, o0, m0, l0, o, m, l, d,
                                       h / h_kv, s_q, s_kv, q_off, k_off,
                                       scale, causal);
  return cudaGetLastError();
}

template <bool RES>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, float* dq, float* dk,
                            float* dv, int h, int h_kv, int s_q, int s_kv,
                            int d, int q_off, int k_off, float scale,
                            int causal, cudaStream_t s) {
  const int group = h / h_kv;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, d, s_q, h, kRows) ||
      !tensor_map(&tdo, dout, d, s_q, h, kRows) ||
      !tensor_map(&tk, k, d, s_kv, h_kv, kDqBKV) ||
      !tensor_map(&tv, v, d, s_kv, h_kv, kDqBKV))
    return cudaErrorInvalidValue;
  constexpr size_t smem_q = DqPlan<RES>::kSmem;
  auto kq = dq_hopper<RES>;
  cudaError_t err = allow_smem(kq, smem_q);
  if (err != cudaSuccess) return err;
  kq<<<dim3((s_q + kRows - 1) / kRows, h, d / kTile), kThreadsH, smem_q,
       s>>>(tq, tk, tv, tdo, lse, delta, dq, d, group, s_q, s_kv, q_off,
            k_off, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!tensor_map(&tq, q, d, s_q, h, kDkvBQ) ||
      !tensor_map(&tdo, dout, d, s_q, h, kDkvBQ) ||
      !tensor_map(&tk, k, d, s_kv, h_kv, kRows) ||
      !tensor_map(&tv, v, d, s_kv, h_kv, kRows))
    return cudaErrorInvalidValue;
  constexpr size_t smem_kv = DkvPlan<RES>::kSmem;
  auto kkv = dkv_hopper<RES>;
  err = allow_smem(kkv, smem_kv);
  if (err != cudaSuccess) return err;
  kkv<<<dim3(s_kv / kRows, h_kv, d / kTile), kThreadsH, smem_kv, s>>>(
      tq, tk, tv, tdo, lse, delta, dk, dv, d, group, s_q, s_kv, q_off, k_off,
      scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_fwd_f32(const float* q, const float* k, const float* v,
                           const float* o0, const float* m0, const float* l0,
                           float* o, float* m, float* l, int h, int h_kv,
                           int s_q, int s_kv, int d, int q_off, int k_off,
                           float scale, int causal, cudaStream_t s) {
  cudaError_t err = allow_smem(fwd_f32, kFwdSmemF32);
  if (err != cudaSuccess) return err;
  fwd_f32<<<dim3((s_q + kBQ - 1) / kBQ, h, d / kDC), 128, kFwdSmemF32, s>>>(
      q, k, v, o0, m0, l0, o, m, l, d, h / h_kv, s_q, s_kv, q_off, k_off,
      scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_bwd_f32(const float* q, const float* k, const float* v,
                           const float* dout, const float* lse,
                           const float* delta, float* dq, float* dk,
                           float* dv, int h, int h_kv, int s_q, int s_kv,
                           int d, int q_off, int k_off, float scale,
                           int causal, cudaStream_t s) {
  const int group = h / h_kv;
  cudaError_t err = allow_smem(dq_f32, kDqSmemF32);
  if (err != cudaSuccess) return err;
  dq_f32<<<dim3((s_q + kBQ - 1) / kBQ, h, d / kDC), 128, kDqSmemF32, s>>>(
      q, k, v, dout, lse, delta, dq, d, group, s_q, s_kv, q_off, k_off, scale,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(dkv_f32, kDkvSmemF32);
  if (err != cudaSuccess) return err;
  dkv_f32<<<dim3(s_kv / kBKVf, h_kv, d / kDC), 128, kDkvSmemF32, s>>>(
      q, k, v, dout, lse, delta, dk, dv, d, group, s_q, s_kv, q_off, k_off,
      scale, causal);
  return cudaGetLastError();
}

// d a multiple of 128, S_kv one of 128 (JAX's contract), the grid's
// limits on heads and column groups
bool bad_shape(int h, int h_kv, int s_q, int s_kv, int d) {
  return h < 1 || h > 65535 || h_kv < 1 || h % h_kv || s_q < 1 ||
         s_kv < 1 || s_kv % 128 || d < 128 || d % 128 || d / 128 > 65535;
}

}  // namespace

extern "C" {

const char* tda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B11. q, k, v of one type (bf16 when is_bf16 != 0, else float32); o0, m0,
// l0 the carried state, o, m, l the updated one (o may alias o0: a block
// reads its rows' and columns' carry before it writes them; m and l must
// not alias m0 and l0 when d > 128, as every column group reads them and
// the first writes them). Returns a cudaError_t.
int tda_flash_fwd(const void* q, const void* k, const void* v, const void* o0,
                  const void* m0, const void* l0, void* o, void* m, void* l,
                  int h, int h_kv, int s_q, int s_kv, int d, int q_off,
                  int k_off, float scale, int causal, int is_bf16,
                  int device, void* stream) {
  if (bad_shape(h, h_kv, s_q, s_kv, d)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fo0 = static_cast<const float*>(o0);
  const float* fm0 = static_cast<const float*>(m0);
  const float* fl0 = static_cast<const float*>(l0);
  float* fo = static_cast<float*>(o);
  float* fm = static_cast<float*>(m);
  float* fl = static_cast<float*>(l);
  if (is_bf16)
    return (d == kTile ? launch_fwd_bf16<true> : launch_fwd_bf16<false>)(
        q, k, v, fo0, fm0, fl0, fo, fm, fl, h, h_kv, s_q, s_kv, d, q_off,
        k_off, scale, causal, s);
  return launch_fwd_f32(static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v), fo0, fm0, fl0, fo, fm,
                        fl, h, h_kv, s_q, s_kv, d, q_off, k_off, scale, causal,
                        s);
}

// B12: the dQ pass, then the dK/dV pass, on one stream. q, k, v and dout
// of one type (bf16 when is_bf16 != 0, else float32). lse, delta (H, S_q)
// float32; dq (H, S_q, d), dk, dv (H_kv, S_kv, d) float32, written whole.
// Returns a cudaError_t.
int tda_flash_bwd(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, void* dk, void* dv, int h, int h_kv, int s_q,
                  int s_kv, int d, int q_off, int k_off, float scale,
                  int causal, int is_bf16, int device, void* stream) {
  if (bad_shape(h, h_kv, s_q, s_kv, d)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* flse = static_cast<const float*>(lse);
  const float* fdl = static_cast<const float*>(delta);
  float* fdq = static_cast<float*>(dq);
  float* fdk = static_cast<float*>(dk);
  float* fdv = static_cast<float*>(dv);
  if (is_bf16)
    return (d == kTile ? launch_bwd_bf16<true> : launch_bwd_bf16<false>)(
        q, k, v, dout, flse, fdl, fdq, fdk, fdv, h, h_kv, s_q, s_kv, d, q_off,
        k_off, scale, causal, s);
  return launch_bwd_f32(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), flse,
      fdl, fdq, fdk, fdv, h, h_kv, s_q, s_kv, d, q_off, k_off, scale, causal,
      s);
}

}  // extern "C"
