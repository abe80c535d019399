// The SSP straggler's interference work for Hopper (sm_90a).
//
// Not the port of a Pallas kernel: the JAX package spells this as plain JAX
// (tpu_distalg/parallel/ssp.py::straggle_work, a lax.fori_loop of `units`
// passes of v <- v * 1.0000001 + 1e-7 over a 4096-lane float32 vector, then
// its sum). In eager torch that loop would be `units` launches of one small
// op each, host time rather than device time; here one launch does a tick's
// work for every shard: block s runs units[s] passes over its own 4096 lanes
// and writes the sum to out[s]. The values feed nothing the trainer keeps;
// only the device time they take matters.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4096;
constexpr int kThreads = 256;
constexpr int kPerThread = kLanes / kThreads;

__global__ void straggle_kernel(const int* __restrict__ units, float salt,
                                float* __restrict__ out) {
  const int s = blockIdx.x;
  const int u = units[s];
  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) v[j] = salt;
  for (int i = 0; i < u; ++i) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) v[j] = v[j] * 1.0000001f + 1e-7f;
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc += v[j];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    out[s] = total;
  }
}

}  // namespace

extern "C" {

const char* tda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// units (n_shards,) int32 on the card, out (n_shards,) float32.
int tda_straggle(const void* units, int n_shards, float salt, void* out,
                 void* stream) {
  if (n_shards <= 0) return 0;
  straggle_kernel<<<n_shards, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(units), salt, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
