// Fused matmul + top-k for Hopper (sm_90a): top-k of Q·Vᵀ per query row
// without writing the (B, N) score matrix to device memory.
//
// Replaces tpu_distalg/ops/pallas_topk.py::fused_matmul_topk (kernel body
// _topk_kernel), with the contract of xla_matmul_topk in the same file:
//   * scores are float32 dot products of a query row with an item row;
//   * local rows at or past n_valid (or past N) score -inf and are never
//     selected; a selected row r is reported as r + index_offset;
//   * order is value descending, ties toward the lower index;
//   * slots left when fewer than k valid items exist are (-inf, 2^31-1).
//
// What bounds it on the card: memory. V is the only large operand and is
// read once (N·d·4 bytes); Q (B·d·4) and the result (B·k·8) are small.
// At N=16384, d=64, B=32 that is 4.2 MB, about 1.25 µs at 3.35 TB/s,
// against 67 MFLOP, about 1.0 µs at 67 TFLOP/s float32. At N=1,048,576
// it is about 80 µs against 64 µs. Both are bounds from data-sheet peaks.
//
// Design. The TPU kernel walks item tiles in a sequential grid and keeps a
// running (B, k) best buffer in VMEM from one grid step to the next. Blocks
// on Hopper run in parallel and carry nothing between them, so this is two
// launches:
//   1. topk_tiles: the grid covers (item ranges, query tiles of 32). A block
//      stages 32 query rows and a 128-item sub-tile of V in shared memory,
//      32 features at a time, and computes its 32×128 scores with FMAs on
//      the CUDA cores in a fixed order over d (no TF32, no tensor cores).
//      The scores go to shared memory, never to device memory. One warp per
//      query then folds the 128 scores into the query's sorted best-k list
//      (shared memory): a ballot finds the scores that beat the list's
//      k-th entry and only those are inserted. The block walks its item
//      range sub-tile by sub-tile and writes one sorted list per query:
//      (B, n_tiles, k) candidate pairs.
//   2. topk_merge: one warp per query folds its n_tiles·k candidates into
//      the final list with the same ballot-and-insert step.
// Both compare (value, index) pairs, so the tie rule holds across tiles.
// The kernel allocates nothing: the caller passes the candidate scratch and
// the outputs. Tensor-core scores, cp.async/TMA double buffering of V and
// a one-pass merge are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kQ = 32;        // query rows per block
constexpr int kTile = 128;    // items per sub-tile
constexpr int kDk = 32;       // features staged per step
constexpr int kPer = kQ * kTile / kThreads;  // scores per thread
constexpr int kMaxK = 128;
constexpr int kSlots = kMaxK / kWarp;        // list slots per lane
constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// (va, ia) comes before (vb, ib): larger value, or equal value and lower index.
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Insert (cv, ci) into the warp's sorted list lv/li of length k. The whole
// warp calls it with the same candidate, which beats the list's last entry.
__device__ void list_insert(float* lv, int* li, int k, float cv, int ci,
                            int lane) {
  int pos = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = j * kWarp + lane;
    const bool b = s < k && beats(lv[s], li[s], cv, ci);
    pos += __popc(__ballot_sync(kFull, b));
  }
  float tv[kSlots];
  int ti[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = j * kWarp + lane;
    if (s > pos && s < k) {
      tv[j] = lv[s - 1];
      ti[j] = li[s - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = j * kWarp + lane;
    if (s > pos && s < k) {
      lv[s] = tv[j];
      li[s] = ti[j];
    }
  }
  if (lane == 0) {
    lv[pos] = cv;
    li[pos] = ci;
  }
  __syncwarp();
}

// Offer one candidate per lane to the warp's list.
__device__ void list_offer(float* lv, int* li, int k, float cv, int ci,
                           int lane) {
  unsigned m = __ballot_sync(kFull, beats(cv, ci, lv[k - 1], li[k - 1]));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float v = __shfl_sync(kFull, cv, src);
    const int i = __shfl_sync(kFull, ci, src);
    // the list may have grown since the ballot: check again (same answer
    // on every lane, so the warp stays converged)
    if (beats(v, i, lv[k - 1], li[k - 1])) list_insert(lv, li, k, v, i, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
topk_tiles(const float* __restrict__ Q, const float* __restrict__ V, int B,
           int N, int d, int k, int index_offset, int n_limit,
           int subs_per_block, float* __restrict__ cand_v,
           int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // kQ × kDk
  float* Vs = Qs + kQ * kDk;                    // kTile × (kDk + 1)
  float* S = Vs + kTile * (kDk + 1);            // kQ × kTile scores
  float* Lv = S + kQ * kTile;                   // kQ × k list values
  int* Li = reinterpret_cast<int*>(Lv + kQ * k);  // kQ × k list indices

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int q0 = blockIdx.y * kQ;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int my_item = tid % kTile;
  const int q_first = tid / kTile;   // this thread's queries: q_first + 2j

  for (int e = tid; e < kQ * k; e += kThreads) {
    Lv[e] = neg_inf();
    Li[e] = kSentinel;
  }

  for (int sub = 0; sub < subs_per_block; ++sub) {
    const int base = (tile * subs_per_block + sub) * kTile;
    if (base >= N) break;  // the same for every thread of the block
    float acc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kDk) {
      __syncthreads();  // the previous step's readers are done
      for (int e = tid; e < kQ * kDk; e += kThreads) {
        const int r = e / kDk, c = e % kDk;
        const int q = q0 + r, f = d0 + c;
        Qs[e] = (q < B && f < d) ? Q[(size_t)q * d + f] : 0.f;
      }
      for (int e = tid; e < kTile * kDk; e += kThreads) {
        const int r = e / kDk, c = e % kDk;
        const int it = base + r, f = d0 + c;
        Vs[r * (kDk + 1) + c] = (it < N && f < d) ? V[(size_t)it * d + f] : 0.f;
      }
      __syncthreads();
      const int cmax = min(kDk, d - d0);
      for (int c = 0; c < cmax; ++c) {
        const float v = Vs[my_item * (kDk + 1) + c];
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          acc[j] = fmaf(Qs[(q_first + 2 * j) * kDk + c], v, acc[j]);
      }
    }
    const bool ok = base + my_item < n_limit;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      S[(q_first + 2 * j) * kTile + my_item] = ok ? acc[j] : neg_inf();
    __syncthreads();
    for (int r = warp; r < kQ && q0 + r < B; r += kWarps) {
      for (int c0 = 0; c0 < kTile; c0 += kWarp) {
        const int p = base + c0 + lane;
        list_offer(Lv + r * k, Li + r * k, k, S[r * kTile + c0 + lane],
                   p < n_limit ? p + index_offset : kSentinel, lane);
      }
    }
    // S is rewritten only after the next sub-tile's first __syncthreads
  }
  __syncthreads();
  for (int e = tid; e < kQ * k; e += kThreads) {
    const int r = e / k, j = e % k;
    const int q = q0 + r;
    if (q < B) {
      const size_t o = ((size_t)q * n_tiles + tile) * k + j;
      cand_v[o] = Lv[e];
      cand_i[o] = Li[e];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
topk_merge(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
           int B, int n_cand, int k, float* __restrict__ out_v,
           int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= B) return;  // whole warp; no block-wide barrier follows
  float* lv = reinterpret_cast<float*>(smem) + warp * k;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + kWarps * k) +
            warp * k;
  for (int j = lane; j < k; j += kWarp) {
    lv[j] = neg_inf();
    li[j] = kSentinel;
  }
  __syncwarp();
  const float* cv = cand_v + (size_t)q * n_cand;
  const int* ci = cand_i + (size_t)q * n_cand;
  for (int c0 = 0; c0 < n_cand; c0 += kWarp) {
    const int s = c0 + lane;
    list_offer(lv, li, k, s < n_cand ? cv[s] : neg_inf(),
               s < n_cand ? ci[s] : kSentinel, lane);
  }
  for (int j = lane; j < k; j += kWarp) {
    const float v = lv[j];
    out_v[(size_t)q * k + j] = v;
    // an exhausted slot may hold a real index with a -inf score
    out_i[(size_t)q * k + j] = v == neg_inf() ? kSentinel : li[j];
  }
}

}  // namespace

extern "C" {

const char* tda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch both stages on `stream`. Pointers are device pointers to
// contiguous arrays: Q (B, d), V (N, d) float32; cand_v/cand_i
// (B, n_tiles, k); out_v/out_i (B, k). Returns a cudaError_t (0 = launched).
int tda_topk(const void* Q, const void* V, int B, int N, int d, int k,
             int index_offset, int n_valid, int subs_per_block, int n_tiles,
             void* cand_v, void* cand_i, void* out_v, void* out_i,
             int device, void* stream) {
  if (B < 1 || N < 1 || d < 1 || k < 1 || k > kMaxK || subs_per_block < 1)
    return cudaErrorInvalidValue;
  const int n_sub = (N + kTile - 1) / kTile;
  if (n_tiles != (n_sub + subs_per_block - 1) / subs_per_block)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_limit = n_valid < 0 ? 0 : (n_valid < N ? n_valid : N);

  const size_t smem1 =
      sizeof(float) * (kQ * kDk + kTile * (kDk + 1) + kQ * kTile) +
      (sizeof(float) + sizeof(int)) * kQ * k;
  if (smem1 > 48 * 1024) {
    err = cudaFuncSetAttribute(topk_tiles,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem1));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid1(n_tiles, (B + kQ - 1) / kQ);
  topk_tiles<<<grid1, kThreads, smem1, s>>>(
      static_cast<const float*>(Q), static_cast<const float*>(V), B, N, d, k,
      index_offset, n_limit, subs_per_block, static_cast<float*>(cand_v),
      static_cast<int*>(cand_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem2 = (sizeof(float) + sizeof(int)) * kWarps * k;
  topk_merge<<<(B + kWarps - 1) / kWarps, kThreads, smem2, s>>>(
      static_cast<const float*>(cand_v), static_cast<const int*>(cand_i), B,
      n_tiles * k, k, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // extern "C"
