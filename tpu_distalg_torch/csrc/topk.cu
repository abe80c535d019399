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
// Design: one launch. The TPU kernel walks item tiles in a sequential grid
// and keeps a running (B, k) best buffer in VMEM; blocks on Hopper run in
// parallel, so each block owns (a query tile, an item range), and the last
// block of a query tile to finish merges the tile's lists.
//   * Plan (ops/topk.py::topk_plan, from the shapes and the SM count):
//     shape A, 32 queries a block, 128-item sub-tiles, when there is work
//     for the whole card at k <= 64; else shape B, 8 queries a block,
//     256-item sub-tiles. Item ranges (block_items, a multiple of 128) are
//     sized for two (A) or one (B) blocks an SM, and to at least 4·k items,
//     so that a block's list is not mostly candidates.
//   * Scores: float32 FMAs on the CUDA cores in a fixed order over d (no
//     TF32: resolve_device turns it off; no tensor cores), so integer
//     inputs give exact scores. A thread owns a register tile of TQ
//     queries × TI items; Q and V come from shared memory in 16-byte loads
//     (rows padded to 36 floats: conflict-free). Each (sub-tile, 32-feature
//     chunk) stage of V and Q comes in with 16-byte cp.async (4-byte when d
//     is not a multiple of 4), double-buffered (four buffers at the
//     serving shape, whose blocks have four stages: all in flight at
//     once), so the next stages land while this one is scored. Items past
//     the range or n_valid are not loaded.
//   * Selection without an insert per candidate (FAISS's WarpSelect and
//     BlockSelect idea): each query keeps a sorted list of its k best
//     (value, index) pairs and its k-th best as a threshold. A thread
//     offers a score only if it beats the threshold; a winner takes a slot
//     in the query's queue (32·QV entries, shared memory) by an integer
//     atomicAdd, one a warp a query while scoring (a warp's lanes offer
//     their f-th scores to one query: a ballot gives each its slot). Then
//     a warp merges each non-empty queue into its query's list, into the
//     other of the list's two buffers: up to 16 entries by ranks counted
//     against the queue in registers, more by a bitonic sort in registers
//     and the merge path (lane l writes an odd-length stretch of the
//     first k of list ∪ queue, after a binary search for where it
//     starts). Scores that found a full queue are offered again after the
//     flush, against the new threshold.
//   * Order: the comparator is a total order on (value desc, index asc),
//     each item is offered once, and nothing a threshold turns away can be
//     in the top k, so the result is the exact top k whatever order the
//     winners reached the queues in, and a replay is bitwise. Integer
//     atomics only.
//   * Early bounds (k <= 32): while a list is not full, the k-th best of a
//     warp's lanes' best scores of a query bounds its k-th best (k
//     distinct items reach it), and so, in the merge, does the k-th best
//     of the lanes' best list heads; both are found with a 32-wide
//     bitonic sort across the warp and turn most candidates away before
//     they take a queue slot.
//   * Cross-block merge in the same launch: every block writes its lists
//     to the workspace, fences and takes a ticket for its query tile (an
//     integer atomicAdd). The block with the last ticket feeds the other
//     blocks' lists through the same threshold, queue and merge (all its
//     warps; 8 (shape A) or 16 candidates a thread a round, the next
//     round's loads in flight; every list's best entries first; a list
//     is dropped once an entry of it is turned away), writes the outputs
//     (a -inf value gets the 2^31-1 index) and resets the ticket.
//     A query tile with one item range writes directly. Blocks share
//     nothing else across a launch: the tickets are the only state that
//     outlives it, and every launch leaves them zero.
//   * Each pruning mechanism above is kept for what it saves, measured
//     with it switched off (tools/topk_probe.py; PERF.md).
//   * k: lists stay in shared memory while they fit a block's 227 KB: up to
//     k = 64 with shape A and k = 1092 with shape B (8 queries, 256-entry
//     queues). Past that each block's lists live in the workspace in device
//     memory (same code through generic pointers). Queues hold 64 entries
//     at k <= 64 and 256 above.
// The kernel allocates nothing: the caller passes the workspace's two
// regions (the state: the tickets, zero before and after every launch;
// the lists) sized by tda_topk_layout, and the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kDk = 32;            // features a stage
constexpr int kRow = kDk + 4;      // a staged row: 144 bytes, conflict-free
constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use
constexpr int kShapeAMaxK = 64;    // the largest k of shape A (64-entry queues)
constexpr int kMergeRound = 16 * 256;  // the most candidates a merge round takes

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// (va, ia) comes before (vb, ib): larger value, or equal value and lower index.
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// (v, i) as a 64-bit key whose unsigned order is the order of beats():
// the float's bits made monotone, then the index inverted (lower wins).
__device__ __forceinline__ unsigned long long order_key(float v, int i) {
  const uint32_t b = __float_as_uint(v);
  const uint32_t m = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(m) << 32) |
         (~static_cast<uint32_t>(i) ^ 0x80000000u);
}

__device__ __forceinline__ void order_unkey(unsigned long long key, float& v,
                                            int& i) {
  const uint32_t m = static_cast<uint32_t>(key >> 32);
  v = __uint_as_float((m & 0x80000000u) ? (m & 0x7fffffffu) : ~m);
  i = static_cast<int>(~static_cast<uint32_t>(key) ^ 0x80000000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device memory into shared memory, or zeros when
// !ok. V streams through once (L2 only: .cg); every block rereads the
// same few rows of Q at every stage, so they are kept in L1 (.ca), or the
// L2 slices that hold them become the card's bottleneck.
template <bool L1>
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  if (L1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's launch: shapes, its workspace and outputs.
struct TopkArgs {
  const float* Q;
  const float* V;
  int B, N, d, k, index_offset, n_limit, range_items, n_ranges, q_tiles;
  unsigned* tickets;        // q_tiles, left at zero (the state region)
  float* cand_v;            // (q_tiles, n_ranges, QT, k) final block lists
  int* cand_i;
  float* glist_v;           // (q_tiles · n_ranges, 2, QT, k) or null
  int* glist_i;
  float* out_v;
  int* out_i;
};

// Shared state of a block's selection: per query its queue, count,
// threshold and which of its two list buffers is current.
struct Sel {
  float* qv;
  int* qi;
  int* qcnt;
  float* thr_v;
  int* thr_i;
  int* par;
  float* lv;   // list buffers: lv + (p · QT + q) · k
  int* li;
  int k, qt;
  __device__ float* list_v(int p, int q) const {
    return lv + (static_cast<size_t>(p) * qt + q) * k;
  }
  __device__ int* list_i(int p, int q) const {
    return li + (static_cast<size_t>(p) * qt + q) * k;
  }
};

// Sort 32·QV (value, index) pairs held QV a lane (element j·32 + lane)
// best first, with a bitonic network.
template <int QV>
__device__ __forceinline__ void warp_sort(float (&v)[QV], int (&ix)[QV]) {
  const int lane = threadIdx.x & 31;
  constexpr int n = 32 * QV;
#pragma unroll
  for (int size = 2; size <= n; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {  // partners in one lane
        const int js = stride / 32;
#pragma unroll
        for (int j = 0; j < QV; ++j) {
          if (j & js) continue;
          const int jp = j | js;
          const bool best_low = ((j * 32 + lane) & size) == 0;
          if (beats(v[jp], ix[jp], v[j], ix[j]) == best_low) {
            const float tv = v[j];
            const int ti = ix[j];
            v[j] = v[jp];
            ix[j] = ix[jp];
            v[jp] = tv;
            ix[jp] = ti;
          }
        }
      } else {
        const bool low = (lane & stride) == 0;
#pragma unroll
        for (int j = 0; j < QV; ++j) {
          const float pv = __shfl_xor_sync(kFull, v[j], stride);
          const int pi = __shfl_xor_sync(kFull, ix[j], stride);
          const bool best_low = ((j * 32 + lane) & size) == 0;
          // the low element keeps the better of the two when best_low
          if (beats(pv, pi, v[j], ix[j]) == (low == best_low)) {
            v[j] = pv;
            ix[j] = pi;
          }
        }
      }
    }
  }
}

// T independent sorts of 32 (value, index) pairs, one a lane in each,
// best first (lane 0 holds the best), interleaved for the latency.
template <int T>
__device__ __forceinline__ void warp_sort32(float (&v)[T], int (&ix)[T]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool low = (lane & stride) == 0;
      const bool best_low = (lane & size) == 0;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float pv = __shfl_xor_sync(kFull, v[t], stride);
        const int pi = __shfl_xor_sync(kFull, ix[t], stride);
        if (beats(pv, pi, v[t], ix[t]) == (low == best_low)) {
          v[t] = pv;
          ix[t] = pi;
        }
      }
    }
  }
}

// One warp merges query q's queue (n entries) into its list, into the
// other list buffer, and raises the threshold to the new k-th entry.
// New positions are ranks: a list entry moves down by the queue entries
// that beat it, and a queue entry lands after the list entries that beat
// or equal it and the queue entries that beat it (no two entries are
// equal, so the positions are a permutation). Up to kCount entries the
// warp counts those ranks against the queue held in registers; more it
// sorts (warp_sort) and merges along the merge path, lane l writing an
// odd-length stretch of outputs (odd, so the lanes' shared-memory reads
// start in different banks).
constexpr int kCount = 16;

template <int QV>
__device__ void flush_query(const Sel& s, int q, int n) {
  constexpr int QCAP = 32 * QV;
  const int lane = threadIdx.x & 31;
  const int k = s.k;
  float* qv = s.qv + q * QCAP;
  int* qi = s.qi + q * QCAP;
  const int p = s.par[q];
  const float* av = s.list_v(p, q);
  const int* ai = s.list_i(p, q);
  float* cv = s.list_v(p ^ 1, q);
  int* ci = s.list_i(p ^ 1, q);
  if (n <= kCount) {
    float bv[kCount];
    int bi[kCount];
#pragma unroll
    for (int b = 0; b < kCount; ++b) {
      bv[b] = b < n ? qv[b] : neg_inf();  // padding beats nothing
      bi[b] = b < n ? qi[b] : kSentinel;
    }
    for (int i = lane; i < k; i += 32) {
      const float v = av[i];
      const int ix = ai[i];
      int c = i;
#pragma unroll
      for (int b = 0; b < kCount; ++b) c += beats(bv[b], bi[b], v, ix);
      if (c < k) {
        cv[c] = v;
        ci[c] = ix;
      }
    }
    if (lane < n) {
      const float v = qv[lane];
      const int ix = qi[lane];
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (!beats(v, ix, av[mid], ai[mid]))
          lo = mid + 1;
        else
          hi = mid;
      }
#pragma unroll
      for (int b = 0; b < kCount; ++b) lo += beats(bv[b], bi[b], v, ix);
      if (lo < k) {
        cv[lo] = v;
        ci[lo] = ix;
      }
    }
  } else {
    float v[QV];
    int ix[QV];
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const int e = j * 32 + lane;
      v[j] = e < n ? qv[e] : neg_inf();
      ix[j] = e < n ? qi[e] : kSentinel;
    }
    warp_sort<QV>(v, ix);
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      qv[j * 32 + lane] = v[j];
      qi[j * 32 + lane] = ix[j];
    }
    __syncwarp();
    const int S = (k + 31) / 32 | 1;
    const int o0 = lane * S;
    const int o1 = min(o0 + S, k);
    if (o0 < k) {
      // how many list entries are among the first o0 outputs
      int lo = max(0, o0 - n), hi = min(o0, k);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int b = o0 - 1 - mid;
        if (!beats(qv[b], qi[b], av[mid], ai[mid]))
          lo = mid + 1;
        else
          hi = mid;
      }
      int ia = lo, ib = o0 - lo;
      // the heads of both runs (ia < k holds: ia + ib = o < k)
      float hav = av[ia], hbv = ib < n ? qv[ib] : neg_inf();
      int hai = ai[ia], hbi = ib < n ? qi[ib] : kSentinel;
      for (int o = o0; o < o1; ++o) {
        if (ib >= n || !beats(hbv, hbi, hav, hai)) {
          cv[o] = hav;
          ci[o] = hai;
          if (++ia < k) {
            hav = av[ia];
            hai = ai[ia];
          }
        } else {
          cv[o] = hbv;
          ci[o] = hbi;
          if (++ib < n) {
            hbv = qv[ib];
            hbi = qi[ib];
          }
        }
      }
    }
  }
  __syncwarp();
  if (lane == 0) {
    s.par[q] = p ^ 1;
    // the threshold may stand above the list's k-th (an early bound)
    if (beats(cv[k - 1], ci[k - 1], s.thr_v[q], s.thr_i[q])) {
      s.thr_v[q] = cv[k - 1];
      s.thr_i[q] = ci[k - 1];
    }
    s.qcnt[q] = 0;
  }
  __syncwarp();
}

// Raise query q's threshold to the bound `key` (an order key; 0 = none)
// where it stands higher.
__device__ __forceinline__ void raise_threshold(const Sel& s, int q,
                                                unsigned long long key) {
  if (key == 0ull) return;
  float v;
  int i;
  order_unkey(key, v, i);
  if (beats(v, i, s.thr_v[q], s.thr_i[q])) {
    s.thr_v[q] = v;
    s.thr_i[q] = i;
  }
}

// Offer each thread's F candidates (value, index, query; bit f of
// `pend` set for those to offer) to their queries' lists until every one
// is in a queue or turned away by its query's threshold. Every thread of
// the block calls it. ONE_Q: every lane of a warp offers its f-th
// candidate to the same query (the scores), so one atomicAdd a warp
// reserves the lanes' slots; else (the merge) each winner takes its own,
// and a candidate turned away clears bit `cb[f]` of `alive` (if given):
// its list's later entries cannot pass either.
template <int F, int QV, bool ONE_Q>
__device__ void select(const Sel& s, const float (&cv)[F], const int (&ci)[F],
                       const int (&cq)[F], unsigned pend,
                       uint32_t* alive = nullptr,
                       const int* cb = nullptr) {
  constexpr int QCAP = 32 * QV;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (;;) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int q = cq[f];
      bool want = (pend >> f) & 1u;
      // turned away unless it reaches the threshold: a list's own k-th is
      // never offered again, and the merge's bound may be an entry of
      // another block's list, which must come in; in the merge an empty
      // list slot adds nothing (a -inf score ends as the sentinel)
      if (want && (beats(s.thr_v[q], s.thr_i[q], cv[f], ci[f]) ||
                   (!ONE_Q && cv[f] == neg_inf()))) {
        pend &= ~(1u << f);
        want = false;
        if (alive != nullptr)
          atomicAnd(alive + (cb[f] >> 5), ~(1u << (cb[f] & 31)));
      }
      int slot = QCAP;
      if (ONE_Q) {
        const unsigned m = __ballot_sync(kFull, want);
        if (m) {  // the same for every lane of the warp
          const int leader = __ffs(m) - 1;
          int base = 0;
          if (lane == leader) base = atomicAdd(s.qcnt + q, __popc(m));
          slot = __shfl_sync(kFull, base, leader) + __popc(m & below);
        }
      } else if (want) {
        slot = atomicAdd(s.qcnt + q, 1);
      }
      if (want && slot < QCAP) {
        s.qv[q * QCAP + slot] = cv[f];
        s.qi[q * QCAP + slot] = ci[f];
        pend &= ~(1u << f);
      }
    }
    const int more = __syncthreads_or(pend != 0u);
    for (int q = warp; q < s.qt; q += kWarps) {
      const int n = min(s.qcnt[q], QCAP);
      if (n > 0) flush_query<QV>(s, q, n);
    }
    __syncthreads();
    if (!more) return;
  }
}

// Stage buffers of V and Q a block: 4 for shape B with 64-entry queues
// (the serving shape: a block's few stages all in flight at once), else
// 2 (double buffering).
__host__ __device__ constexpr int stage_buffers(bool shape_b, int qv) {
  return shape_b && qv == 2 ? 4 : 2;
}

// Shared memory of a block: V and Q stages (nb each), the queues, the
// per-query state, then (lists_in_smem) the two list buffers.
__host__ __device__ inline int topk_smem_bytes(int qt, int sub, int qcap,
                                               int nb, int k,
                                               bool lists_in_smem) {
  int o = 4 * nb * (sub + qt) * kRow;      // V and Q stages
  o += 8 * qt * qcap;                      // queues
  o += 8 * qt;                             // the early bounds (keys)
  o += 4 * (4 * qt + 4);                   // qcnt, thr_v, thr_i, par, flag
  if (lists_in_smem) o += 2 * 8 * qt * k;  // two list buffers
  return o;
}

// Shape A (QG 8) keeps two blocks an SM: at most 128 registers a thread.
// SLIST: the lists are in shared memory (known at compile time, so their
// loads and stores are shared-memory instructions, not generic ones).
template <int TQ, int TI, int QG, int QV, bool VEC, bool SLIST>
__global__ void __launch_bounds__(kThreads, QG == 8 ? 2 : 1)
    topk_kernel(TopkArgs a) {
  constexpr int QT = TQ * QG;         // queries a block
  constexpr int IG = kThreads / QG;   // item groups
  constexpr int SUB = TI * IG;        // items a sub-tile
  constexpr int QCAP = 32 * QV;
  constexpr int F = TQ * TI;          // scores a thread
  // candidates a thread takes a merge round (shape A: fewer, to stay in
  // its 128 registers)
  constexpr int MF = QG == 8 ? 8 : 16;
  constexpr int NB = stage_buffers(QG == 2, QV);
  extern __shared__ __align__(16) unsigned char smem[];
  float* Vs = reinterpret_cast<float*>(smem);       // NB × SUB × kRow
  float* Qs = Vs + NB * SUB * kRow;                 // NB × QT × kRow
  Sel s;
  s.qv = Qs + NB * QT * kRow;                       // QT × QCAP
  s.qi = reinterpret_cast<int*>(s.qv + QT * QCAP);  // QT × QCAP
  unsigned long long* sbnd =                        // QT order keys
      reinterpret_cast<unsigned long long*>(s.qi + QT * QCAP);
  s.qcnt = reinterpret_cast<int*>(sbnd + QT);
  s.thr_v = reinterpret_cast<float*>(s.qcnt + QT);
  s.thr_i = reinterpret_cast<int*>(s.thr_v + QT);
  s.par = s.thr_i + QT;
  int* flag = s.par + QT;
  s.k = a.k;
  s.qt = QT;
  const int k = a.k;
  const int tid = threadIdx.x;
  const int qtile = blockIdx.x % a.q_tiles;
  const int range = blockIdx.x / a.q_tiles;
  const int blk = qtile * a.n_ranges + range;
  if (SLIST) {
    s.lv = reinterpret_cast<float*>(flag + 4);
    s.li = reinterpret_cast<int*>(s.lv + 2 * QT * k);
  } else {
    s.lv = a.glist_v + static_cast<size_t>(blk) * 2 * QT * k;
    s.li = a.glist_i + static_cast<size_t>(blk) * 2 * QT * k;
  }
  const int q0 = qtile * QT;
  const int r_begin = range * a.range_items;
  // items past the range, N or n_valid are neither loaded nor offered
  const int v_end = min(min(r_begin + a.range_items, a.N), a.n_limit);

  for (int e = tid; e < QT * k; e += kThreads) {
    s.lv[e] = neg_inf();  // buffer 0 of every query
    s.li[e] = kSentinel;
  }
  if (tid < QT) {
    sbnd[tid] = 0ull;
    s.qcnt[tid] = 0;
    s.thr_v[tid] = neg_inf();
    s.thr_i[tid] = kSentinel;
    s.par[tid] = 0;
  }

  const int qg = tid / IG;
  const int ig = tid % IG;
  const int d = a.d;
  const int n_dc = (d + kDk - 1) / kDk;
  const int n_sub = v_end > r_begin ? (v_end - r_begin + SUB - 1) / SUB : 0;
  const int n_st = n_sub * n_dc;

  // stage st into buffer st % NB (past the last stage, an empty group,
  // so that every thread has committed NB - 1 groups ahead of the one it
  // waits for)
  auto issue = [&](int st) {
    const int u = st / n_dc;
    const int c = st - u * n_dc;
    const int base = r_begin + u * SUB;
    const int f0 = c * kDk;
    float* vs = Vs + (st % NB) * SUB * kRow;
    float* qs = Qs + (st % NB) * QT * kRow;
    if (st >= n_st) {
    } else if (VEC) {
      constexpr int W = kDk / 4;
      for (int e = tid; e < (SUB + QT) * W; e += kThreads) {
        const int r = e / W;
        const int f = f0 + 4 * (e - r * W);
        if (r < SUB) {
          const int it = base + r;
          const bool ok = it < v_end && f < d;
          cp_async16<false>(vs + r * kRow + (f - f0),
                            ok ? a.V + static_cast<size_t>(it) * d + f : a.V,
                            ok);
        } else {
          const int q = q0 + r - SUB;
          const bool ok = q < a.B && f < d;
          cp_async16<true>(qs + (r - SUB) * kRow + (f - f0),
                           ok ? a.Q + static_cast<size_t>(q) * d + f : a.Q,
                           ok);
        }
      }
    } else {
      for (int e = tid; e < (SUB + QT) * kDk; e += kThreads) {
        const int r = e / kDk;
        const int f = f0 + (e - r * kDk);
        if (r < SUB) {
          const int it = base + r;
          const bool ok = it < v_end && f < d;
          cp_async4(vs + r * kRow + (f - f0),
                    ok ? a.V + static_cast<size_t>(it) * d + f : a.V, ok);
        } else {
          const int q = q0 + r - SUB;
          const bool ok = q < a.B && f < d;
          cp_async4(qs + (r - SUB) * kRow + (f - f0),
                    ok ? a.Q + static_cast<size_t>(q) * d + f : a.Q, ok);
        }
      }
    }
    cp_async_commit();
  };

  float acc[TQ][TI];
#pragma unroll
  for (int t = 0; t < TQ; ++t)
#pragma unroll
    for (int r = 0; r < TI; ++r) acc[t][r] = 0.0f;
  for (int st = 0; st < NB - 1; ++st) issue(st);
  __syncthreads();  // the lists' and states' initial values
  for (int st = 0; st < n_st; ++st) {
    issue(st + NB - 1);
    cp_async_wait<NB - 1>();
    __syncthreads();
    const int u = st / n_dc;
    const int c = st - u * n_dc;
    const float* vs = Vs + (st % NB) * SUB * kRow;
    const float* qs = Qs + (st % NB) * QT * kRow;
    // features in order; past d both operands are zero-filled, so the
    // whole stage is summed (a fixed trip count the compiler unrolls)
#pragma unroll
    for (int f = 0; f < kDk; f += 4) {
      float4 qv[TQ], vv[TI];
#pragma unroll
      for (int t = 0; t < TQ; ++t)
        qv[t] = *reinterpret_cast<const float4*>(qs + (qg * TQ + t) * kRow + f);
#pragma unroll
      for (int r = 0; r < TI; ++r)
        vv[r] = *reinterpret_cast<const float4*>(vs + (ig + IG * r) * kRow + f);
#pragma unroll
      for (int t = 0; t < TQ; ++t)
#pragma unroll
        for (int r = 0; r < TI; ++r) {
          acc[t][r] = fmaf(qv[t].x, vv[r].x, acc[t][r]);
          acc[t][r] = fmaf(qv[t].y, vv[r].y, acc[t][r]);
          acc[t][r] = fmaf(qv[t].z, vv[r].z, acc[t][r]);
          acc[t][r] = fmaf(qv[t].w, vv[r].w, acc[t][r]);
        }
    }
    if (c == n_dc - 1) {  // the sub-tile's scores are complete
      const int base = r_begin + u * SUB;
      bool filling = false;  // the same for every lane of a warp
#pragma unroll
      for (int t = 0; t < TQ; ++t)
        filling = filling || s.thr_v[qg * TQ + t] == neg_inf();
      if (k <= 32 && __syncthreads_or(filling)) {
        // While a query's list is not full its threshold is -inf and
        // every score would take a queue slot. A warp's lanes each hold
        // TI of its scores of a query: the k-th best of the lanes' best
        // ones is a lower bound of the query's k-th best (k distinct
        // items reach it), so it turns most of them away first.
        float bv[TQ];
        int bi[TQ];
#pragma unroll
        for (int t = 0; t < TQ; ++t) {
          bv[t] = neg_inf();
          bi[t] = kSentinel;
#pragma unroll
          for (int r = 0; r < TI; ++r) {
            const int it = base + ig + IG * r;
            if (it < v_end && beats(acc[t][r], it + a.index_offset, bv[t],
                                    bi[t])) {
              bv[t] = acc[t][r];
              bi[t] = it + a.index_offset;
            }
          }
        }
        warp_sort32<TQ>(bv, bi);
#pragma unroll
        for (int t = 0; t < TQ; ++t) {
          const float kv = __shfl_sync(kFull, bv[t], k - 1);
          const int kix = __shfl_sync(kFull, bi[t], k - 1);
          const int q = qg * TQ + t;
          if ((tid & 31) == 0 && kv != neg_inf() &&
              s.thr_v[q] == neg_inf())
            atomicMax(sbnd + q, order_key(kv, kix));
        }
        __syncthreads();
        if (tid < QT) {
          raise_threshold(s, tid, sbnd[tid]);
          sbnd[tid] = 0ull;
        }
        __syncthreads();
      }
      float cv[F];
      int ci[F], cq[F];
      unsigned pend = 0u;
#pragma unroll
      for (int t = 0; t < TQ; ++t)
#pragma unroll
        for (int r = 0; r < TI; ++r) {
          const int f = t * TI + r;
          const int it = base + ig + IG * r;
          const bool ok = it < v_end && q0 + qg * TQ + t < a.B;
          cv[f] = acc[t][r];
          ci[f] = ok ? it + a.index_offset : kSentinel;
          cq[f] = qg * TQ + t;
          if (ok) pend |= 1u << f;
          acc[t][r] = 0.0f;
        }
      select<F, QV, true>(s, cv, ci, cq, pend);
    }
    __syncthreads();  // this stage's buffers are free for stage st + NB
  }

  if (a.n_ranges == 1) {  // the block's lists are the result
    for (int e = tid; e < QT * k; e += kThreads) {
      const int q = e / k;
      if (q0 + q >= a.B) continue;
      const int j = e - q * k;
      const float v = s.list_v(s.par[q], q)[j];
      a.out_v[static_cast<size_t>(q0 + q) * k + j] = v;
      a.out_i[static_cast<size_t>(q0 + q) * k + j] =
          v == neg_inf() ? kSentinel : s.list_i(s.par[q], q)[j];
    }
    return;
  }
  const size_t tile_base = static_cast<size_t>(qtile) * a.n_ranges * QT * k;
  for (int e = tid; e < QT * k; e += kThreads) {
    const int q = e / k;
    if (q0 + q >= a.B) continue;
    const int j = e - q * k;
    const size_t o = tile_base + (static_cast<size_t>(range) * QT + q) * k + j;
    a.cand_v[o] = s.list_v(s.par[q], q)[j];
    a.cand_i[o] = s.list_i(s.par[q], q)[j];
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *flag = atomicAdd(a.tickets + qtile, 1u) ==
            static_cast<unsigned>(a.n_ranges - 1);
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // The last block of the tile: the other ranges' lists through the
  // threshold, the queues and the merge (its own list is already its
  // running list). Candidate e is entry j of range ρ's list of query q,
  // e = (j · n_ranges + ρ) · QT + q: every list's best entries come
  // first and a round spreads over all queries, so thresholds rise early
  // and most later entries are turned away without a queue slot.
  const int n_e = k * a.n_ranges * QT;   // < 2^31 (tda_topk checks)
  // A bit a (query, range) list, in the free stage buffers when they hold
  // them: cleared when an entry of the list is turned away, after which
  // its later entries are neither loaded nor offered.
  uint32_t* alive = reinterpret_cast<uint32_t*>(Vs);
  const int alive_words = (QT * a.n_ranges + 31) / 32;
  if (alive_words > NB * SUB * kRow) alive = nullptr;
  if (alive != nullptr)
    for (int e = tid; e < alive_words; e += kThreads) alive[e] = ~0u;
  __syncthreads();
  auto load = [&](int e0, float (&cv)[MF], int (&ci)[MF], int (&cq)[MF],
                  int (&cb)[MF], unsigned& pend) {
    pend = 0u;
#pragma unroll
    for (int f = 0; f < MF; ++f) {
      const int e = e0 + f * kThreads + tid;
      const int jr = e / QT;
      const int q = e - jr * QT;
      const int j = jr / a.n_ranges;
      const int rho = jr - j * a.n_ranges;
      cq[f] = q;
      cb[f] = q * a.n_ranges + rho;
      cv[f] = neg_inf();
      ci[f] = kSentinel;
      if (e < n_e && rho != range && q0 + q < a.B &&
          (alive == nullptr || ((alive[cb[f] >> 5] >> (cb[f] & 31)) & 1u))) {
        const size_t o =
            tile_base + (static_cast<size_t>(rho) * QT + q) * k + j;
        cv[f] = __ldcg(a.cand_v + o);
        ci[f] = __ldcg(a.cand_i + o);
        pend |= 1u << f;
      }
    }
  };
  const int round = MF * kThreads;
  float cv[MF], nv[MF];
  int ci[MF], cq[MF], cb[MF], ni[MF], nq[MF], nb[MF];
  unsigned pend, npend;
  // the first round's candidates are loaded before the heads are read:
  // their latencies overlap
  load(0, cv, ci, cq, cb, pend);
  if (k <= 32) {
    // The lists' heads: a warp takes a query, each lane keeps the best
    // head of its ranges, and the k-th best of the lanes' is a bound too
    // (k distinct items reach it), usually near the tile's k-th best.
    const int warp = tid / kWarp;
    const int lane = tid & 31;
    for (int q = warp; q < QT && q0 + q < a.B; q += kWarps) {
      float hv[1] = {neg_inf()};
      int hi[1] = {kSentinel};
      for (int rho = lane; rho < a.n_ranges; rho += 32) {
        if (rho == range) continue;
        const size_t o = tile_base + (static_cast<size_t>(rho) * QT + q) * k;
        const float v = __ldcg(a.cand_v + o);
        const int ix = __ldcg(a.cand_i + o);
        if (beats(v, ix, hv[0], hi[0])) {
          hv[0] = v;
          hi[0] = ix;
        }
      }
      warp_sort32<1>(hv, hi);
      const float kv = __shfl_sync(kFull, hv[0], k - 1);
      const int kix = __shfl_sync(kFull, hi[0], k - 1);
      if (lane == 0 && kv != neg_inf() && beats(kv, kix, s.thr_v[q], s.thr_i[q])) {
        s.thr_v[q] = kv;
        s.thr_i[q] = kix;
      }
    }
    __syncthreads();
  }
  for (int e0 = 0; e0 < n_e; e0 += round) {
    npend = 0u;
    if (e0 + round < n_e) load(e0 + round, nv, ni, nq, nb, npend);
    if (__syncthreads_or(pend != 0u))  // a round of dead lists costs a barrier
      select<MF, QV, false>(s, cv, ci, cq, pend, alive, cb);
#pragma unroll
    for (int f = 0; f < MF; ++f) {
      cv[f] = nv[f];
      ci[f] = ni[f];
      cq[f] = nq[f];
      cb[f] = nb[f];
    }
    pend = npend;
  }
  for (int e = tid; e < QT * k; e += kThreads) {
    const int q = e / k;
    if (q0 + q >= a.B) continue;
    const int j = e - q * k;
    const float v = s.list_v(s.par[q], q)[j];
    a.out_v[static_cast<size_t>(q0 + q) * k + j] = v;
    // an exhausted slot holds (-inf, 2^31-1) already; a valid item whose
    // score is -inf takes the sentinel too
    a.out_i[static_cast<size_t>(q0 + q) * k + j] =
        v == neg_inf() ? kSentinel : s.list_i(s.par[q], q)[j];
  }
  if (tid == 0) a.tickets[qtile] = 0u;  // every block of the tile is done
}

// Shape A (32 queries, 128-item sub-tiles) or B (8 queries, 256 items).
struct Shape {
  int qt, sub;
};

Shape shape_of(int shape) {
  return shape == 0 ? Shape{32, 128} : Shape{8, 256};
}

template <int TQ, int TI, int QG, int QV, bool VEC, bool SLIST = true>
cudaError_t launch(const TopkArgs& a, int blocks, int smem, int device,
                   cudaStream_t s) {
  static bool allowed[64] = {};
  auto kernel = topk_kernel<TQ, TI, QG, QV, VEC, SLIST>;
  if (smem > 48 * 1024 && !(device >= 0 && device < 64 && allowed[device])) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) allowed[device] = true;
  }
  kernel<<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// A launch's layout, from its plan (shape and range_items, chosen by
// ops/topk.py::topk_plan): its queues, stage buffers and shared memory,
// where its lists live, and the words of its two workspace regions.
//   * state: a ticket a query tile. A launch leaves every word of it zero
//     and nothing else is written there, so the region is zero before
//     every launch whatever plan ran before it on the same workspace.
//   * lists: the blocks' final lists when a query tile spans several
//     ranges, then the running lists when they do not fit shared memory.
struct Layout {
  Shape sh;
  int qv, nb, smem;
  bool smem_lists;
  long long q_tiles, n_ranges, lists, state_words, list_words;
};

// cudaSuccess, or cudaErrorInvalidValue for a plan the kernel does not
// take: a bad shape, or a block count or a query tile's candidate count
// (n_ranges · QT · k, counted in an int by the merge) past int32.
int layout_of(int B, int N, int k, int shape, int range_items, Layout& L) {
  if (B < 1 || N < 1 || k < 1 || (shape != 0 && shape != 1) ||
      (shape == 0 && k > kShapeAMaxK) || range_items < 128 ||
      range_items % 128)
    return cudaErrorInvalidValue;
  L.sh = shape_of(shape);
  L.qv = k <= kShapeAMaxK ? 2 : 8;
  L.nb = stage_buffers(shape == 1, L.qv);
  L.q_tiles = (B + L.sh.qt - 1) / L.sh.qt;
  L.n_ranges = (N + range_items - 1LL) / range_items;
  if (L.q_tiles * L.n_ranges >= (1LL << 31) ||
      L.n_ranges * L.sh.qt * k + kMergeRound >= (1LL << 31))
    return cudaErrorInvalidValue;
  L.smem_lists = topk_smem_bytes(L.sh.qt, L.sh.sub, 32 * L.qv, L.nb, k,
                                 true) <= kSmemMax;
  L.smem = topk_smem_bytes(L.sh.qt, L.sh.sub, 32 * L.qv, L.nb, k,
                           L.smem_lists);
  L.lists = L.q_tiles * L.n_ranges * L.sh.qt * k;
  L.state_words = L.q_tiles;
  L.list_words = (L.n_ranges > 1 ? 2 * L.lists : 0) +
                 (L.smem_lists ? 0 : 4 * L.lists);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* tda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The sizes a plan needs: words[0] the state region's 4-byte words,
// words[1] the list region's, words[2] the block's dynamic shared memory
// in bytes. Returns a cudaError_t (cudaErrorInvalidValue: the kernel does
// not take the plan).
int tda_topk_layout(int B, int N, int k, int shape, int range_items,
                    long long* words) {
  Layout L;
  const int err = layout_of(B, N, k, shape, range_items, L);
  if (err != cudaSuccess) return err;
  words[0] = L.state_words;
  words[1] = L.list_words;
  words[2] = L.smem;
  return cudaSuccess;
}

// Launch the top-k on `stream`. Q (B, d), V (N, d) float32 contiguous
// device arrays (16-byte aligned when d % 4 == 0); shape and range_items
// are ops/topk.py::topk_plan's; `state` (zero; every launch leaves it so)
// and `lists` hold at least the words tda_topk_layout gives; out_v/out_i
// (B, k). Returns a cudaError_t (0 = launched).
int tda_topk(const void* Q, const void* V, int B, int N, int d, int k,
             int index_offset, int n_valid, int shape, int range_items,
             void* state, long long state_words, void* lists,
             long long list_words, void* out_v, void* out_i, int device,
             void* stream) {
  Layout L;
  int err = layout_of(B, N, k, shape, range_items, L);
  if (err != cudaSuccess) return err;
  if (d < 1 || state_words < L.state_words || list_words < L.list_words)
    return cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(Q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(V) % 16 == 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  TopkArgs a;
  a.Q = static_cast<const float*>(Q);
  a.V = static_cast<const float*>(V);
  a.B = B;
  a.N = N;
  a.d = d;
  a.k = k;
  a.index_offset = index_offset;
  a.n_limit = n_valid < 0 ? 0 : (n_valid < N ? n_valid : N);
  a.range_items = range_items;
  a.n_ranges = static_cast<int>(L.n_ranges);
  a.q_tiles = static_cast<int>(L.q_tiles);
  a.tickets = static_cast<unsigned*>(state);
  float* w = static_cast<float*>(lists);
  long long o = 0;
  a.cand_v = nullptr;
  a.cand_i = nullptr;
  if (L.n_ranges > 1) {
    a.cand_v = w;
    a.cand_i = reinterpret_cast<int*>(w + L.lists);
    o = 2 * L.lists;
  }
  a.glist_v = nullptr;
  a.glist_i = nullptr;
  if (!L.smem_lists) {
    a.glist_v = w + o;
    a.glist_i = reinterpret_cast<int*>(w + o + 2 * L.lists);
  }
  a.out_v = static_cast<float*>(out_v);
  a.out_i = static_cast<int*>(out_i);
  const int blocks = static_cast<int>(L.q_tiles * L.n_ranges);
  const int smem = L.smem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shape == 0)
    return vec ? launch<4, 4, 8, 2, true>(a, blocks, smem, device, s)
               : launch<4, 4, 8, 2, false>(a, blocks, smem, device, s);
  if (L.qv == 2)
    return vec ? launch<4, 2, 2, 2, true>(a, blocks, smem, device, s)
               : launch<4, 2, 2, 2, false>(a, blocks, smem, device, s);
  if (L.smem_lists)
    return vec ? launch<4, 2, 2, 8, true>(a, blocks, smem, device, s)
               : launch<4, 2, 2, 8, false>(a, blocks, smem, device, s);
  return vec ? launch<4, 2, 2, 8, true, false>(a, blocks, smem, device, s)
             : launch<4, 2, 2, 8, false, false>(a, blocks, smem, device, s);
}

}  // extern "C"
