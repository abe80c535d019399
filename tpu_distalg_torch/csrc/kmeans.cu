// K-means cluster statistics for Hopper (sm_90a): one pass over the points
// gives, per cluster, the sum of its points and their count (B10).
//
// Replaces fused_cluster_stats (body _kernel) of
// tpu_distalg/ops/pallas_kmeans.py, with this contract (see
// tpu_distalg_torch/ops/kmeans_kernels.py):
//   * a point's cluster is the first minimum over c of the float32 expansion
//     (|p|² − 2·p·c) + |c|², scanned with a strict <, i.e. what
//     ops.kmeans.assign_clusters computes. The TPU kernel compares these
//     distances rounded to the bf16 grid, only because its shift matmuls
//     round; that rounding is not reproduced;
//   * a row whose mask is 0 adds nothing and counts nothing;
//   * sums (k, dim) float32 and counts (k,) float32 (summed as integers).
//
// The TPU kernel packs 128/dpad points per 128-lane row and works through
// selector matmuls, a butterfly of permutation matmuls, phantom centres and
// a diagonal-band fold, all to avoid cross-lane moves. The packed X2
// (n/pp, 128) is, byte for byte, the row-major (n, dpad) matrix, so this
// kernel reads rows of dpad floats directly.
//
// What bounds it on the card: memory, and before that the SM's load/store
// pipe, which carries the global loads, every shared-memory access and every
// shuffle at 32 lanes a clock. A point is read once (dpad·4 + 4 bytes) for
// about 4·k·dim operations: at dim 16, k 8 that is 7.5 operations a byte,
// under the card's float32 balance of 20.
//
// Design.
//   * G lanes own one row, each holding VPL (1, 2 or 4) 16-byte vectors of
//     it, so a warp works on R = 32/G rows at once, and a lane loads 8
//     vectors (U = 8/VPL rows) before it uses any. The wrapper picks VPL:
//     more vectors a lane mean fewer lanes a row, so fewer shuffles and fewer
//     shared-memory reads a row, but more tiles (below).
//   * The centres, zero-padded to dpad, and |c|² sit in shared memory (or,
//     when they and one tile exceed it, the centres stay in device memory).
//     A lane reads its vectors of a centre once for its U rows, multiplies,
//     the G lanes add by an xor butterfly (every lane ends with the same
//     bits), and each lane scans the k distances itself.
//   * Replay bit for bit, no float atomics: each lane group has a private
//     (k, dpad + 4) float32 tile in shared memory (column dpad holds the
//     count as an integer), its lanes own distinct columns, and it adds its
//     rows in row order. Where R tiles a warp do not fit, the warp's groups
//     share one tile and take turns in group order, which is row order too.
//     The block then adds its tiles in tile order into its slot of a
//     (blocks, k, dpad + 4) scratch, and a second launch adds the slots in
//     block order with a fixed tree. Rows per block, warps, VPL and tiles
//     are chosen by the wrapper from n, k and dpad alone, never from the
//     card, so the order of every sum is a function of the shapes.
// Centres in registers, fewer shuffles (a transposed reduction) and TMA row
// loads are later work.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kInFlight = 8;  // vectors a lane loads before using any
constexpr int kReduceThreads = 128;
// dynamic shared memory a block can opt in to on sm_90
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ void add4(float* p, const float4& x) {
  float4 a = *reinterpret_cast<float4*>(p);
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
  *reinterpret_cast<float4*>(p) = a;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Stage 1: each block's (k, dpad + 4) partial over its rows.
template <int VPL>
__global__ void __launch_bounds__(kMaxWarps * 32)
    stats_kernel(const float4* __restrict__ X, const float* __restrict__ mask,
                 const float* __restrict__ cpad, int n, int k, int dpad,
                 int tiles_per_warp, int rows_per_block, int cen_in_smem,
                 float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int U = kInFlight / VPL;  // rows a lane group loads at once
  const int G = (dpad >> 2) / VPL;    // lanes a row
  const int R = 32 / G;               // rows a warp works on at once
  const int W = blockDim.x >> 5;
  const int stride = dpad + 4;
  const int tile_floats = k * stride;
  const int n_tiles = W * tiles_per_warp;
  float* tiles = smem;                          // n_tiles · k · stride
  float* cn2 = tiles + n_tiles * tile_floats;   // k
  float* cen_s = cn2 + ((k + 3) & ~3);          // k · dpad, if it fits
  const float* cen = cen_in_smem ? cen_s : cpad;
  for (int e = threadIdx.x; e < n_tiles * tile_floats; e += blockDim.x)
    tiles[e] = 0.0f;
  if (cen_in_smem) {
    for (int e = threadIdx.x; e < k * dpad; e += blockDim.x)
      cen_s[e] = cpad[e];
    __syncthreads();
  }
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < dpad; ++j)
      s = fmaf(cen[c * dpad + j], cen[c * dpad + j], s);
    cn2[c] = s;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G;
  const int li = lane % G;
  const bool own_tile = tiles_per_warp > 1 || R == 1;
  float* tile = tiles + static_cast<size_t>(
      warp * tiles_per_warp + (tiles_per_warp > 1 ? grp : 0)) * tile_floats;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  const int step = W * R * U;
  for (long long base = r0; base < r1; base += step) {
    float4 x[U][VPL];
    float m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (u * W + warp) * R + grp;
      const bool ok = i < r1;
#pragma unroll
      for (int q = 0; q < VPL; ++q)
        x[u][q] = ok ? __ldg(X + i * (dpad >> 2) + li + G * q)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      m[u] = ok ? __ldg(mask + i) : 0.0f;
    }
    // the U rows' distances together: a centre's vectors are read once
    float pp[U], best[U];
    int bc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      pp[u] = 0.0f;
#pragma unroll
      for (int q = 0; q < VPL; ++q) pp[u] += dot4(x[u][q], x[u][q]);
      for (int o = G >> 1; o > 0; o >>= 1)
        pp[u] += __shfl_xor_sync(kFull, pp[u], o);
      best[u] = __int_as_float(0x7f800000);  // +inf
      bc[u] = 0;
    }
    for (int c = 0; c < k; ++c) {
      const float4* cv = reinterpret_cast<const float4*>(cen + c * dpad) + li;
      float d[U];
#pragma unroll
      for (int u = 0; u < U; ++u) d[u] = 0.0f;
#pragma unroll
      for (int q = 0; q < VPL; ++q) {
        const float4 cq = cv[G * q];
#pragma unroll
        for (int u = 0; u < U; ++u) d[u] += dot4(x[u][q], cq);
      }
      const float cc = cn2[c];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        for (int o = G >> 1; o > 0; o >>= 1)
          d[u] += __shfl_xor_sync(kFull, d[u], o);
        const float dist = (pp[u] - 2.0f * d[u]) + cc;
        if (dist < best[u]) {
          best[u] = dist;
          bc[u] = c;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool keep = m[u] != 0.0f;
      float* row = tile + bc[u] * stride;
      if (own_tile) {
        if (keep) {
#pragma unroll
          for (int q = 0; q < VPL; ++q) add4(row + 4 * (li + G * q), x[u][q]);
          if (li == 0) reinterpret_cast<int*>(row)[dpad] += 1;
        }
      } else {
        // the warp's groups share its tile: one group at a time, in row
        // order
        for (int g = 0; g < R; ++g) {
          if (keep && grp == g) {
#pragma unroll
            for (int q = 0; q < VPL; ++q)
              add4(row + 4 * (li + G * q), x[u][q]);
            if (li == 0) reinterpret_cast<int*>(row)[dpad] += 1;
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * tile_floats;
  for (int e = threadIdx.x; e < tile_floats; e += blockDim.x) {
    if (e % stride == dpad) {
      int s = 0;
      for (int t = 0; t < n_tiles; ++t)
        s += reinterpret_cast<const int*>(tiles)[t * tile_floats + e];
      reinterpret_cast<int*>(out)[e] = s;
    } else {
      float s = 0.0f;
      for (int t = 0; t < n_tiles; ++t) s += tiles[t * tile_floats + e];
      out[e] = s;
    }
  }
}

// Stage 2: one block per output entry adds the blocks' partials in a fixed
// order (contiguous runs per thread, then a fixed tree). Blocks
// [0, k·dim) give sums[c][j]; blocks [k·dim, k·dim + k) give counts[c].
__global__ void __launch_bounds__(kReduceThreads)
    fold_kernel(const float* __restrict__ partial, int nblk, int k, int dim,
                int dpad, float* __restrict__ sums,
                float* __restrict__ counts) {
  __shared__ float sm[kReduceThreads];
  const int stride = dpad + 4;
  const int tile_floats = k * stride;
  const int b = blockIdx.x;
  const bool is_count = b >= k * dim;
  const int c = is_count ? b - k * dim : b / dim;
  const int e = c * stride + (is_count ? dpad : b % dim);
  const int per = (nblk + kReduceThreads - 1) / kReduceThreads;
  const int b0 = threadIdx.x * per;
  const int b1 = min(b0 + per, nblk);
  if (is_count) {
    int* smi = reinterpret_cast<int*>(sm);
    int s = 0;
    for (int i = b0; i < b1; ++i)
      s += reinterpret_cast<const int*>(
          partial)[static_cast<size_t>(i) * tile_floats + e];
    smi[threadIdx.x] = s;
    __syncthreads();
    for (int o = kReduceThreads / 2; o > 0; o >>= 1) {
      if (threadIdx.x < o) smi[threadIdx.x] += smi[threadIdx.x + o];
      __syncthreads();
    }
    if (threadIdx.x == 0) counts[c] = static_cast<float>(smi[0]);
    return;
  }
  float s = 0.0f;
  for (int i = b0; i < b1; ++i)
    s += partial[static_cast<size_t>(i) * tile_floats + e];
  sm[threadIdx.x] = s;
  __syncthreads();
  for (int o = kReduceThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) sm[threadIdx.x] += sm[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[b] = sm[0];
}

}  // namespace

extern "C" {

const char* tda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B10. X (n, dpad) float32 row-major and 16-byte aligned, mask (n,), cpad
// (k, dpad) the centres zero-padded; partial holds
// ceil(n / rows_per_block) · k · (dpad + 4) floats; sums (k, dim) and counts
// (k,) float32. warps, vpl (vectors a lane: 1, 2 or 4), tiles_per_warp (1 or
// the rows a warp works on at once, 32/((dpad/4)/vpl)), rows_per_block (a
// multiple of the rows a block's warps load at once) and cen_in_smem come
// from the wrapper's plan. Returns a cudaError_t.
int tda_kmeans_stats(const void* X, const void* mask, const void* cpad, int n,
                     int k, int dim, int dpad, int warps, int vpl,
                     int tiles_per_warp, int rows_per_block, int cen_in_smem,
                     void* partial, void* sums, void* counts, int device,
                     void* stream) {
  if (n < 1 || k < 1 || k > 256 || dim < 1 || dim > dpad || dpad < 8 ||
      dpad > 128 || (dpad & (dpad - 1)) || warps < 1 || warps > kMaxWarps ||
      (vpl != 1 && vpl != 2 && vpl != 4) || vpl > (dpad >> 2))
    return cudaErrorInvalidValue;
  const int R = 32 / ((dpad >> 2) / vpl);
  if ((tiles_per_warp != 1 && tiles_per_warp != R) || rows_per_block < 1 ||
      rows_per_block % (warps * R * (kInFlight / vpl)))
    return cudaErrorInvalidValue;
  const size_t floats =
      static_cast<size_t>(warps) * tiles_per_warp * k * (dpad + 4) +
      ((k + 3) & ~3) + (cen_in_smem ? static_cast<size_t>(k) * dpad : 0);
  const size_t smem = floats * sizeof(float);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto kernel = vpl == 1 ? stats_kernel<1>
                         : vpl == 2 ? stats_kernel<2> : stats_kernel<4>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (n + rows_per_block - 1) / rows_per_block;
  kernel<<<nblk, warps * 32, smem, s>>>(
      static_cast<const float4*>(X), static_cast<const float*>(mask),
      static_cast<const float*>(cpad), n, k, dpad, tiles_per_warp,
      rows_per_block, cen_in_smem, static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fold_kernel<<<k * dim + k, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), nblk, k, dim, dpad,
      static_cast<float*>(sums), static_cast<float*>(counts));
  return cudaGetLastError();
}

}  // extern "C"
