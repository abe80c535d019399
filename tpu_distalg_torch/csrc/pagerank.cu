// PageRank sweep kernels for Hopper (sm_90a): a CSR SpMV over the rows of
// the dst-sorted edge list (B7) and a segmented sum of per-edge
// contributions over the same rows (B8).
//
// Replaces, in tpu_distalg/ops/pallas_pagerank.py:
//   B7 spmv_table     :457 (body _spmv_kernel)  y[v] = Σ_{e in row v} x[src[e]]·w[e]
//   B8 scatter_table  :498 (body _kernel)       y[v] = Σ_{e in row v} c[e]
// where row v is the edges [row_ptr[v], row_ptr[v+1]) of the dst-sorted
// list (see tpu_distalg_torch/ops/pagerank_kernels.py).
//
// The TPU kernels keep a (V/128, 128) vertex table in VMEM and add each
// 1024-edge chunk into a window of it with a one-hot MXU matmul; their
// windows, chunk padding and host planners (plan_spmv, plan_scatter) exist
// to fit VMEM and the (8, 128) tiling. On the card the dst-sorted list is a
// CSR matrix whose rows are summed in shared memory: no scatter, no float
// atomic.
//
// What bounds them on the card. Per edge B7 streams src and w once (8
// bytes) and gathers x[src] (4 bytes at a random place in a vector that
// stays in the 50 MB L2); per row it reads row_ptr and writes y (8 bytes).
// At 1M vertices × 7,999,981 edges that is 76 MB, 22.7 µs at 3.35 TB/s
// (B8: 40 MB, 11.9 µs); one multiply and one add an edge are negligible.
// But every gather costs L2 a 32-byte sector: the gathers, not device
// memory, set B7's floor, the "gather ceiling" that gather_ceiling()
// below measures (8M random reads take ~69 µs on an H100 whatever else
// the kernel does; PERF.md §6). B8 has no gather: its bound is the bytes.
//
// Design.
//   * Tiles on the merge path. The path is the V row ends and E edges in
//     order (row v's end comes after its edges). Tile t is the path items
//     [t·items, (t+1)·items): rows [i0, i1) end in it and it holds the
//     edges [j0, j1), j = t·items − i. The plan (rows_before[t] = i0 of
//     tile t, made once per graph by the wrapper) fixes i0 and i1, so every
//     tile has the same work (at most `items` rows plus edges) however
//     skewed the rows are. A block takes one tile.
//   * Streams. A block reads its row_ptr slice once, in one coalesced pass,
//     and src and w (B8: c) as 16-byte vectors (two a thread at most),
//     with L1 no-allocate and L2 evict-first so that the 64 MB stream does
//     not push x out of the caches; a misaligned head and tail (an emulated
//     shard's slice starts at any 4-byte offset) take scalar loads. When
//     src and w are misaligned against each other the same grid takes
//     scalar loads throughout (kVec false). All of a thread's loads are
//     issued before its first gather, and all its gathers (up to 8, __ldg)
//     before its first product, so each thread has several sectors in
//     flight.
//   * Fixed order. The products go to shared memory. A row's part in a
//     tile of at most kShort edges is summed by one thread in edge order; a
//     longer one by a warp, lane l adding edges l, l + 32, … in order and
//     the lanes folding by an xor butterfly.
//   * Rows across tiles. A row over one tile boundary with at most kWhole
//     edges before it (at the main shape, every row that crosses) is read
//     whole by the tile that holds its end: warp 0 takes those edges from
//     device memory while the other warps sum the short rows. Any other
//     row has one part in each of its tiles; every tile of it stores its
//     part, takes an integer ticket, and the last to arrive adds the parts
//     in tile order (a warp: strided, then the butterfly) and resets the
//     ticket to 0 for the next launch. The ticket's fences sit on a
//     block's exit, so they are kept for the rows that need them. The
//     order of the adds depends on the row's length and the plan alone: a
//     fixed input replays bit for bit.
//   * __fmul_rn / __fadd_rn keep nvcc from contracting x·w into the sum as
//     an FMA, which the plain PyTorch version does not do.
//   * A row without edges writes 0; a tile without edges writes its rows'
//     zeros; E = 0 is a plan of row ends alone.
// Tried and dropped (PERF.md §6): persistent blocks that keep the next
// tile's streams in flight (77 registers, 3 blocks of 256 an SM: slower);
// short rows read in 16-byte words (no gain); tiles of 512 or 1024 items
// (more tiles' fixed costs), and of 4096 on 512 threads (B8 slower); the
// smallest shared-memory carveout (twice as slow).
// Open: B7 is bound by the gathers' rate; beating it needs fewer random
// sectors (x split into windows that fit in shared memory, with the edges
// ordered by window: another layout of the prepared graph). Fusing the
// rank update into B7's store would change the kernel's contract (the JAX
// spmv_table returns the sweep alone).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 2048;           // path items a tile, at most
constexpr int kSlots = kMaxItems / 4 / kThreads;  // 16-byte vectors a thread
constexpr int kShort = 16;                // longer parts go to a warp
constexpr int kWhole = 64;  // earlier edges a tile reads to sum a row whole
constexpr int kMaxLong = kMaxItems / (kShort + 1) + 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long evict_first() {
  unsigned long long policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
      : "=l"(policy));
  return policy;
}

// a read-only stream: L1 no-allocate, L2 evict-first
__device__ __forceinline__ int4 ld_stream4(const void* p,
                                           unsigned long long policy) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 "
      "{%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ int ld_stream(const void* p,
                                         unsigned long long policy) {
  int v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(policy));
  return v;
}

template <bool kVec>
__device__ __forceinline__ int4 ld_group(const int* p,
                                         unsigned long long policy) {
  if (kVec) return ld_stream4(p, policy);
  return make_int4(ld_stream(p, policy), ld_stream(p + 1, policy),
                   ld_stream(p + 2, policy), ld_stream(p + 3, policy));
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  return acc;
}

__device__ __forceinline__ float product(float xv, int wv) {
  return __fmul_rn(xv, __int_as_float(wv));
}

// One tile of the merge path (see the note above). kGather: B7 (src, w,
// x), else B8 (w holds c). kCeiling: the gather ceiling's probe — the same
// loads, gathers and products, no row structure, one value a block in y.
template <bool kGather, bool kVec, bool kCeiling>
__global__ void __launch_bounds__(kThreads)
    csr_tiles(const int* __restrict__ row_ptr, const int* __restrict__ src,
              const int* __restrict__ w, const float* __restrict__ x,
              const int* __restrict__ rows_before, int V, int E, int items,
              int* __restrict__ tickets, float* __restrict__ parts,
              float* __restrict__ y) {
  __shared__ __align__(16) float prod[kMaxItems + 8];
  __shared__ int rp[kMaxItems + 2];
  __shared__ int longs[kMaxLong];
  __shared__ int n_long;
  __shared__ float part[2];
  __shared__ float warp_part[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x;
  const long long d0 = static_cast<long long>(t) * items;
  const long long d1 = min(d0 + items, static_cast<long long>(V) + E);
  const int i0 = __ldg(rows_before + t), i1 = __ldg(rows_before + t + 1);
  const int j0 = static_cast<int>(d0 - i0), j1 = static_cast<int>(d1 - i1);
  const int n_rows = i1 - i0;
  const unsigned long long policy = evict_first();

  // row_ptr[i0 .. i1 + 1]: the rows ending here, the open row's end too
  if (!kCeiling) {
    const int n_rp = min(n_rows + 2, V + 1 - i0);
    for (int k = tid; k < n_rp; k += kThreads)
      rp[k] = ld_stream(row_ptr + i0 + k, policy);
    if (tid == 0) n_long = 0;
  }

  // edges: 16-byte groups on the stream's own alignment, [ja, jb); the
  // head [j0, ja) and tail [jb, j1) are scalars. prod[e - base] puts group
  // g at prod[4 + 4g], 16-byte aligned.
  const int* lead = kGather ? src : w;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(lead) >> 2) & 3);
  const int ja = min(j0 + ((4 - ((mis + j0) & 3)) & 3), j1);
  const int n_groups = (j1 - ja) >> 2;
  const int jb = ja + 4 * n_groups;
  const int base = ja - 4;
  int se = -1;
  if (tid < ja - j0) se = j0 + tid;
  else if (tid >= 4 && tid - 4 < j1 - jb) se = jb + tid - 4;

  int4 sv[kSlots], wv[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int g = tid + s * kThreads;
    if (g < n_groups) {
      const int e = ja + 4 * g;
      if (kGather) sv[s] = ld_group<kVec>(src + e, policy);
      wv[s] = ld_group<kVec>(w + e, policy);
    }
  }
  int ss = 0, sw = 0;
  if (se >= 0) {
    if (kGather) ss = ld_stream(src + se, policy);
    sw = ld_stream(w + se, policy);
  }
  float4 xv[kSlots];
  float sx = 0.0f;
  if (kGather) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (tid + s * kThreads < n_groups) {
        xv[s].x = __ldg(x + sv[s].x);
        xv[s].y = __ldg(x + sv[s].y);
        xv[s].z = __ldg(x + sv[s].z);
        xv[s].w = __ldg(x + sv[s].w);
      }
    }
    if (se >= 0) sx = __ldg(x + ss);
  }
  float4 pv[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (kGather) {
      pv[s] = make_float4(product(xv[s].x, wv[s].x), product(xv[s].y, wv[s].y),
                          product(xv[s].z, wv[s].z), product(xv[s].w, wv[s].w));
    } else {
      pv[s] = make_float4(__int_as_float(wv[s].x), __int_as_float(wv[s].y),
                          __int_as_float(wv[s].z), __int_as_float(wv[s].w));
    }
  }
  const float sp = kGather ? product(sx, sw) : __int_as_float(sw);

  if (kCeiling) {  // the probe: every product, summed a block, one store
    float acc = se >= 0 ? sp : 0.0f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (tid + s * kThreads < n_groups)
        acc += pv[s].x + pv[s].y + pv[s].z + pv[s].w;
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_part[warp] = acc;
    __syncthreads();
    if (tid == 0) {
      float total = 0.0f;
      for (int k = 0; k < kWarps; ++k) total += warp_part[k];
      y[t] = total;
    }
    return;
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int g = tid + s * kThreads;
    if (g < n_groups) *reinterpret_cast<float4*>(prod + 4 + 4 * g) = pv[s];
  }
  if (se >= 0) prod[se - base] = sp;
  __syncthreads();

  // Rows that cross a tile boundary. Row r spans tiles ta .. tb (tb holds
  // its end, and there r is i0, so tb's j0 is tb·items − r). One that spans
  // just the tile before and this one, with at most kWhole edges there, is
  // read whole here by warp 0, those edges from device memory; the tile
  // before leaves it. Any other is summed in parts, one a tile, through the
  // tickets below.
  auto tiles_of = [&](int r, int first, int end, int& ta, int& tb) {
    ta = static_cast<int>((static_cast<long long>(first) + r) / items);
    tb = static_cast<int>((static_cast<long long>(end) + r) / items);
  };
  int hta = t, htb = t, tta = t, ttb = t;
  const bool head = n_rows > 0 && rp[0] < j0;  // began in an earlier tile
  if (head) tiles_of(i0, rp[0], rp[1], hta, htb);
  const bool tail = i1 < V && rp[n_rows] < j1;  // goes on past this tile
  if (tail) tiles_of(i1, rp[n_rows], rp[n_rows + 1], tta, ttb);
  const bool head_whole = head && hta == t - 1 && j0 - rp[0] <= kWhole;
  const bool tail_next =
      tail && ttb - tta == 1 &&
      static_cast<long long>(ttb) * items - i1 - rp[n_rows] <= kWhole;

  // part k < n_rows: row i0 + k over [max(rp[k], j0), rp[k + 1]); part
  // n_rows: the open row i1 over [max(rp[n_rows], j0), j1)
  auto settle = [&](int k, float acc) {
    if (k == n_rows) {
      part[1] = acc;
    } else if (k == 0 && head) {
      part[0] = acc;
    } else {
      y[i0 + k] = acc;
    }
  };
  if (warp == 0) {
    if (head_whole) {
      float acc = 0.0f;
      for (int e = rp[0] + lane; e < rp[1]; e += 32) {
        float v;
        if (e >= j0) {
          v = prod[e - base];
        } else if (kGather) {
          v = product(__ldg(x + __ldg(src + e)), __ldg(w + e));
        } else {
          v = __int_as_float(__ldg(w + e));
        }
        acc = __fadd_rn(acc, v);
      }
      acc = warp_sum(acc);
      if (lane == 0) y[i0] = acc;
    }
  } else {
    for (int k = tid - 32; k <= n_rows; k += kThreads - 32) {
      if ((k == 0 && head_whole) || (k == n_rows && (!tail || tail_next)))
        continue;
      const int b = max(rp[k], j0), e = k < n_rows ? rp[k + 1] : j1;
      if (e - b > kShort) {
        longs[atomicAdd(&n_long, 1)] = k;
        continue;
      }
      float acc = 0.0f;
      for (int i = b; i < e; ++i) acc = __fadd_rn(acc, prod[i - base]);
      settle(k, acc);
    }
  }
  __syncthreads();
  for (int l = warp; l < n_long; l += kWarps) {
    const int k = longs[l];
    const int b = max(rp[k], j0), e = k < n_rows ? rp[k + 1] : j1;
    float acc = 0.0f;
    for (int i = b + lane; i < e; i += 32) acc = __fadd_rn(acc, prod[i - base]);
    acc = warp_sum(acc);
    if (lane == 0) settle(k, acc);
  }
  __syncthreads();

  // rows in parts: warp 0 the one that ends here (slot 0), warp 1 the one
  // that goes on (slot 1)
  int r = -1, ta = 0, tb = 0;
  const int slot = warp;
  if (warp == 0 && head && !head_whole) {
    r = i0;
    ta = hta;
    tb = htb;
  } else if (warp == 1 && tail && !tail_next) {
    r = i1;
    ta = tta;
    tb = ttb;
  }
  if (r < 0) return;
  int last = 0;
  if (lane == 0) {
    parts[2 * t + slot] = part[slot];
    __threadfence();
    last = atomicAdd(tickets + tb, 1) == tb - ta;
  }
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  // the tails of tiles ta .. tb - 1, then the head of tb
  float acc = 0.0f;
  for (int u = ta + lane; u <= tb; u += 32)
    acc = __fadd_rn(acc, __ldcg(parts + 2 * u + (u == tb ? 0 : 1)));
  acc = warp_sum(acc);
  if (lane == 0) {
    y[r] = acc;
    tickets[tb] = 0;  // every tile of the row has arrived
  }
}

template <bool kGather, bool kCeiling>
cudaError_t launch(const int* row_ptr, const int* src, const int* w,
                   const float* x, int V, int E, const int* rows_before,
                   int n_tiles, int items, int* tickets, float* parts,
                   float* y, int device, cudaStream_t s) {
  const long long n_items = static_cast<long long>(V) + E;
  if (V < 1 || E < 0 || items < 1 || items > kMaxItems ||
      n_tiles != (n_items + items - 1) / items)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // 16-byte groups of src and w line up only when both start at the same
  // offset from a 16-byte boundary
  const bool vec = !kGather || ((reinterpret_cast<uintptr_t>(src) ^
                                 reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  if (vec) {
    csr_tiles<kGather, true, kCeiling><<<n_tiles, kThreads, 0, s>>>(
        row_ptr, src, w, x, rows_before, V, E, items, tickets, parts, y);
  } else {
    csr_tiles<kGather, false, kCeiling><<<n_tiles, kThreads, 0, s>>>(
        row_ptr, src, w, x, rows_before, V, E, items, tickets, parts, y);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B7: row_ptr (V + 1,) and src (E,) int32, w (E,) and x float32, y (V,)
// float32; rows_before (n_tiles + 1,) int32, the plan for tiles of `items`
// path items; tickets (n_tiles,) int32, zero, and left zero; parts
// (2·n_tiles,) float32 scratch. Returns a cudaError_t.
int tda_pagerank_spmv(const void* row_ptr, const void* src, const void* w,
                      const void* x, int V, int E, const void* rows_before,
                      int n_tiles, int items, void* tickets, void* parts,
                      void* y, int device, void* stream) {
  return launch<true, false>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(src),
      static_cast<const int*>(w), static_cast<const float*>(x), V, E,
      static_cast<const int*>(rows_before), n_tiles, items,
      static_cast<int*>(tickets), static_cast<float*>(parts),
      static_cast<float*>(y), device, static_cast<cudaStream_t>(stream));
}

// B8: row_ptr (V + 1,) int32, c (E,) float32 in row order, y (V,) float32;
// the plan and scratch as for B7.
int tda_pagerank_segment_sum(const void* row_ptr, const void* c, int V,
                             int E, const void* rows_before, int n_tiles,
                             int items, void* tickets, void* parts, void* y,
                             int device, void* stream) {
  return launch<false, false>(
      static_cast<const int*>(row_ptr), nullptr, static_cast<const int*>(c),
      nullptr, V, E, static_cast<const int*>(rows_before), n_tiles, items,
      static_cast<int*>(tickets), static_cast<float*>(parts),
      static_cast<float*>(y), device, static_cast<cudaStream_t>(stream));
}

// The gather ceiling (a measurement, on no path): B7's loads, gathers and
// products over the same plan without the row structure; out (n_tiles,)
// float32 gets one sum a tile.
int tda_pagerank_gather_ceiling(const void* row_ptr, const void* src,
                                const void* w, const void* x, int V, int E,
                                const void* rows_before, int n_tiles,
                                int items, void* out, int device,
                                void* stream) {
  return launch<true, true>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(src),
      static_cast<const int*>(w), static_cast<const float*>(x), V, E,
      static_cast<const int*>(rows_before), n_tiles, items, nullptr, nullptr,
      static_cast<float*>(out), device, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
