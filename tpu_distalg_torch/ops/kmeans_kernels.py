"""K-means kernel: the packed layout and the one-pass cluster statistics.

Port of ``tpu_distalg/ops/pallas_kmeans.py``:

  * :func:`packed_geometry` and :func:`pack_points` (``:61-109``): points
    padded to ``dpad`` columns (a power of two, at least 8) and packed
    ``pp = 128/dpad`` to a 128-wide row, the mask packed beside them, so
    that X2 is (n/pp, 128) and mask2 (n/pp, pp);
  * B10 :func:`fused_cluster_stats` (``:176``): one pass over the points
    gives ``(Σ points (k, dim), count (k,))`` per cluster under the
    current centres.

The packed X2 is, byte for byte, the row-major (n, dpad) matrix and
mask2 the flat (n,) mask, and the CUDA kernel (``csrc/kmeans.cu``) reads
them as such; the TPU kernel's selector and permutation matmuls, its
power-of-two padding of k, its block multiple and its VMEM guard existed
only for the TPU and are not ported.

A deliberate difference: the TPU kernel compares distances rounded to
the bf16 grid (its shift matmuls round); the port compares the float32
expansion ``|p|² − 2p·c + |c|²`` with a strict ``<``, the contract of
``ops.kmeans.assign_clusters``, which the bf16 grid approximates.

Beside the wrapper is its plain PyTorch version
(:func:`cluster_stats_reference`). The wrapper takes it only for tensors
on the CPU; for CUDA tensors it launches the kernel (counted in
``fused_cluster_stats.launches``) or raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.ops import _native
from tpu_distalg_torch.ops import kmeans as kops
from tpu_distalg_torch.utils.device import resolve_device

MAX_DIM, MAX_K = 128, 256
#: dynamic shared memory a block can opt in to on sm_90, in bytes
SMEM_LIMIT = 232448
#: 16-byte vectors a lane loads before it uses any (kInFlight in the source)
VECTORS_IN_FLIGHT = 8


def packed_geometry(dim: int, k: int):
    """``(dpad, pp)``: dim padded to a power of two of at least 8, and
    the points per packed 128-wide row."""
    dpad = 8
    while dpad < dim:
        dpad *= 2
    if dim < 1 or dpad > MAX_DIM:
        raise ValueError(
            f"fused k-means supports 1 <= dim <= {MAX_DIM}, got {dim}")
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"fused k-means supports 1 <= k <= {MAX_K}, got {k}")
    return dpad, 128 // dpad


def pack_points(points, mask, *, dim: int, k: int,
                device: str | torch.device | None = None):
    """(n, dim) points and their (n,) mask → ``(X2 (n2, 128), mask2
    (n2, pp))`` float32 on ``device``, rows padded to a multiple of pp
    with mask 0."""
    dev = resolve_device(device)
    dpad, pp = packed_geometry(dim, k)
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    n_t = n + ((-n) % pp)
    out = np.zeros((n_t, dpad), np.float32)
    out[:n, :dim] = points
    m = np.zeros((n_t,), np.float32)
    m[:n] = np.asarray(mask, np.float32)
    return (torch.from_numpy(out.reshape(n_t // pp, pp * dpad)).to(dev),
            torch.from_numpy(m.reshape(n_t // pp, pp)).to(dev))


# ---------------------------------------------------------------- plain


def cluster_stats_reference(X2, mask2, centers, *, dim: int, k: int):
    """Plain B10: ``assign_clusters`` on the unpacked points, then an
    ``index_add_`` of the kept rows onto their clusters. The sums are
    added in float64 and rounded once: on the card ``index_add_`` adds
    with atomics, one after another in no fixed order, and a float32
    sum of a million terms taken that way is off by thousands of ulps
    (so the plain version is a check, never a path). Counts are added
    as integers."""
    dpad, _ = packed_geometry(dim, k)
    pts = X2.reshape(-1, dpad)[:, :dim]
    keep = mask2.reshape(-1) != 0
    assign = kops.assign_clusters(pts, centers)
    sums = torch.zeros((k, dim), dtype=torch.float64,
                       device=X2.device).index_add_(
        0, assign, pts.to(torch.float64) * keep[:, None])
    counts = torch.zeros((k,), dtype=torch.int64,
                         device=X2.device).index_add_(0, assign, keep.long())
    return sums.to(torch.float32), counts.to(torch.float32)


# --------------------------------------------------------------- kernel


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """How the CUDA kernel splits the rows: warps a block, 16-byte
    vectors of a row a lane holds (so ``(dpad/4)/vectors_per_lane``
    lanes own a row), private accumulator tiles a warp (one per row the
    warp works on at once, or one shared by those rows' lanes in turn),
    rows a block, and whether the centres fit in shared memory beside
    the tiles."""

    warps: int
    vectors_per_lane: int
    tiles_per_warp: int
    rows_per_block: int
    cen_in_smem: bool

    def n_blocks(self, n: int) -> int:
        return -(-n // self.rows_per_block)


def kernel_plan(k: int, dpad: int) -> KernelPlan:
    """The kernel's launch geometry, from the shapes alone (never from
    the card), so the order of every sum is a function of (n, k, dpad)
    and a fixed input replays bit for bit on any card.

    Fewer lanes a row cost the SM's load/store pipe less (fewer
    shuffles and centre reads a row) but need more private tiles. So:
    the most vectors a lane whose tiles leave room for five blocks of
    four warps on an SM (48 KB a block); else one vector a lane with
    four or two warps; else one tile a warp, shared in turns."""
    vectors = dpad // 4                      # 16-byte vectors a row
    tile = k * (dpad + 4) * 4                # one (k, dpad + 4) f32 tile
    fixed = ((k + 3) // 4 * 4) * 4           # |c|²
    centres = k * dpad * 4

    def plan(warps, per_lane, tiles, cen_in_smem=True):
        rows_at_once = 32 // (vectors // per_lane)
        step = warps * rows_at_once * (VECTORS_IN_FLIGHT // per_lane)
        rows = max(4096, 16 * k * (dpad + 4))
        return KernelPlan(warps=warps, vectors_per_lane=per_lane,
                          tiles_per_warp=tiles,
                          rows_per_block=-(-rows // step) * step,
                          cen_in_smem=cen_in_smem)

    for per_lane in (4, 2, 1):
        if per_lane <= vectors:
            tiles = 32 // (vectors // per_lane)
            if 4 * tiles * tile + fixed + centres <= 48 * 1024:
                return plan(4, per_lane, tiles)
    tiles = 32 // vectors
    for warps in (4, 2):
        if warps * tiles * tile + fixed + centres <= SMEM_LIMIT:
            return plan(warps, 1, tiles)
    for warps in (8, 4, 2, 1):
        if warps * tile + fixed + centres <= SMEM_LIMIT:
            return plan(warps, 1, 1)
    if tile + fixed > SMEM_LIMIT:
        raise ValueError(f"fused k-means: one (k={k}, {dpad + 4}) tile "
                         f"exceeds {SMEM_LIMIT} bytes of shared memory")
    return plan(1, 1, 1, cen_in_smem=False)


def fused_cluster_stats(X2, mask2, centers, *, dim: int, k: int):
    """B10: ``(Σ points (k, dim) f32, count (k,) f32)`` per cluster in
    one pass over the points.

    ``X2`` (n2, 128) and ``mask2`` (n2, pp) float32 as
    :func:`pack_points` or ``models.kmeans.pack_device`` lay them out;
    ``centers`` (k, dim) float32. A point goes to the first minimum of
    ``|p|² − 2p·c + |c|²`` over the centres; a row whose mask is 0 adds
    nothing and counts nothing. The same contract as
    ``ops.kmeans.cluster_stats`` after ``assign_clusters``. A CPU tensor
    goes to :func:`cluster_stats_reference`; a CUDA tensor launches the
    kernel (``fused_cluster_stats.launches``) or raises."""
    for name, t in (("X2", X2), ("mask2", mask2), ("centers", centers)):
        _native.check_tensor(name, t, (torch.float32,), 2)
    dpad, pp = packed_geometry(dim, k)
    if (X2.shape[1] != 128 or tuple(mask2.shape) != (X2.shape[0], pp)
            or tuple(centers.shape) != (k, dim)):
        raise ValueError(
            f"fused_cluster_stats: X2 {tuple(X2.shape)}, mask2 "
            f"{tuple(mask2.shape)}, centers {tuple(centers.shape)} "
            f"incompatible with dim={dim}, k={k}: want (n2, 128), "
            f"(n2, {pp}), ({k}, {dim})")
    if all(t.device.type == "cpu" for t in (X2, mask2, centers)):
        return cluster_stats_reference(X2, mask2, centers, dim=dim, k=k)
    dev = _native.cuda_device(X2, mask2, centers)
    n = X2.shape[0] * pp
    if not 1 <= n < 2**31:
        raise ValueError(f"fused_cluster_stats: {n} rows; the CUDA kernel "
                         f"takes 1 <= n < 2**31")
    X2, mask2 = X2.contiguous(), mask2.contiguous()
    cpad = centers if dpad == dim else torch.nn.functional.pad(
        centers, (0, dpad - dim))
    cpad = cpad.contiguous()
    if X2.data_ptr() % 16 or cpad.data_ptr() % 16:
        raise ValueError("fused_cluster_stats: X2 and centers must be "
                         "16-byte aligned")
    plan = kernel_plan(k, dpad)
    lib = _native.load("kmeans")
    partial = torch.empty((plan.n_blocks(n), k * (dpad + 4)),
                          dtype=torch.float32, device=dev)
    sums = torch.empty((k, dim), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    rc = lib.tda_kmeans_stats(
        X2.data_ptr(), mask2.data_ptr(), cpad.data_ptr(), n, k, dim, dpad,
        plan.warps, plan.vectors_per_lane, plan.tiles_per_warp,
        plan.rows_per_block, int(plan.cen_in_smem), partial.data_ptr(), sums.data_ptr(),
        counts.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _native.check(lib, rc, "fused_cluster_stats")
    fused_cluster_stats.launches += 1
    return sums, counts


fused_cluster_stats.launches = 0

#: the kernels of this module, for resetting and reading launch counts
KERNELS = (fused_cluster_stats,)
