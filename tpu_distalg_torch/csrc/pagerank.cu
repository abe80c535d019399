// PageRank sweep kernels for Hopper (sm_90a): a CSR SpMV over the rows of
// the dst-sorted edge list (B7) and a segmented sum of per-edge
// contributions over the same rows (B8).
//
// Replaces, in tpu_distalg/ops/pallas_pagerank.py:
//   B7 spmv_table     (body _spmv_kernel)  y[v] = Σ_{e in row v} x[src[e]]·w[e]
//   B8 scatter_table  (body _kernel)       y[v] = Σ_{e in row v} c[e]
// where row v is the edges [row_ptr[v], row_ptr[v+1]) of the dst-sorted
// list (see tpu_distalg_torch/ops/pagerank_kernels.py).
//
// The TPU kernels keep a (V/128, 128) vertex table in VMEM and add each
// 1024-edge chunk into a window of it with a one-hot MXU matmul; their
// windows, chunk padding and host planners (plan_spmv, plan_scatter) exist
// to fit VMEM and the (8, 128) tiling. On the card the dst-sorted list is a
// CSR matrix: each row is owned by one group of lanes, which writes its sum
// once, so there is no scatter, no plan and no float atomic.
//
// What bounds them on the card: memory. Per edge B7 reads src and w once
// (8 bytes) and x[src] (4 bytes at a random place, but the rank vector,
// 4 MB at 1M vertices, stays in the 50 MB L2); per row it reads row_ptr
// and writes y (8 bytes). At 1M vertices × 7,999,981 edges that is 76 MB,
// 22.7 µs at 3.35 TB/s (B8: 40 MB, 11.9 µs). One multiply and one add per
// edge: the operations are negligible.
//
// Design.
//   * G lanes own one row (G = 4, 8, 16 or 32: the wrapper picks the power
//     of two at or above the average degree). Lane l adds the row's edges
//     l, l + G, l + 2G, … in order, so neighbouring lanes read neighbouring
//     edges and a warp's 32/G rows are contiguous in src, w and c.
//   * The G partial sums fold by an xor butterfly (offsets G/2 … 1). a + b
//     and b + a are the same float, so every lane of the group ends with
//     the same bits, and lane 0 writes y[v]. The order of the adds is fixed
//     by the row's length and G alone: a fixed input replays bit for bit.
//   * __fmul_rn / __fadd_rn keep nvcc from contracting x·w into the sum as
//     an FMA, which the plain PyTorch version does not do.
//   * A row of any length is right: a hub row of 100k edges is 100k / G
//     steps of one group, slow but in a fixed order. A row without edges
//     writes 0.
// Splitting long rows over warps, 16-byte loads, and fusing the rank update
// into the store are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int G, bool kGather>
__global__ void __launch_bounds__(kThreads)
    csr_row_sums(const int* __restrict__ row_ptr, const int* __restrict__ src,
                 const float* __restrict__ w, const float* __restrict__ v,
                 int V, float* __restrict__ y) {
  const int lane = threadIdx.x & (G - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  // rows past V run an empty loop: every lane must reach the shuffles
  unsigned start = 0, end = 0;
  if (row < V) {
    start = static_cast<unsigned>(__ldg(row_ptr + row));
    end = static_cast<unsigned>(__ldg(row_ptr + row + 1));
  }
  float acc = 0.0f;
#pragma unroll 4
  for (unsigned e = start + lane; e < end; e += G) {
    const float t = kGather ? __fmul_rn(__ldg(v + __ldg(src + e)), __ldg(w + e))
                            : __ldg(v + e);
    acc = __fadd_rn(acc, t);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  if (lane == 0 && row < V) y[row] = acc;
}

template <bool kGather>
cudaError_t launch(const int* row_ptr, const int* src, const float* w,
                   const float* v, int V, int G, float* y, int device,
                   cudaStream_t s) {
  if (V < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(V) * G + kThreads - 1) /
                            kThreads);
  switch (G) {
    case 4:
      csr_row_sums<4, kGather><<<blocks, kThreads, 0, s>>>(row_ptr, src, w, v,
                                                           V, y);
      break;
    case 8:
      csr_row_sums<8, kGather><<<blocks, kThreads, 0, s>>>(row_ptr, src, w, v,
                                                           V, y);
      break;
    case 16:
      csr_row_sums<16, kGather><<<blocks, kThreads, 0, s>>>(row_ptr, src, w,
                                                            v, V, y);
      break;
    case 32:
      csr_row_sums<32, kGather><<<blocks, kThreads, 0, s>>>(row_ptr, src, w,
                                                            v, V, y);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B7: row_ptr (V + 1,) and src (E,) int32, w (E,) and x float32, y (V,)
// float32; G lanes per row. Returns a cudaError_t.
int tda_pagerank_spmv(const void* row_ptr, const void* src, const void* w,
                      const void* x, int V, int G, void* y, int device,
                      void* stream) {
  return launch<true>(static_cast<const int*>(row_ptr),
                      static_cast<const int*>(src),
                      static_cast<const float*>(w),
                      static_cast<const float*>(x), V, G,
                      static_cast<float*>(y), device,
                      static_cast<cudaStream_t>(stream));
}

// B8: row_ptr (V + 1,) int32, c (E,) float32 in row order, y (V,) float32.
int tda_pagerank_segment_sum(const void* row_ptr, const void* c, int V, int G,
                             void* y, int device, void* stream) {
  return launch<false>(static_cast<const int*>(row_ptr), nullptr, nullptr,
                       static_cast<const float*>(c), V, G,
                       static_cast<float*>(y), device,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
