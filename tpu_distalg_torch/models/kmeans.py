"""K-means (Lloyd's algorithm).

Port of ``tpu_distalg/models/kmeans.py`` on the emulated data axis
(:mod:`..parallel`). Each iteration assigns every point to its nearest
centre, sums ``(Σ points, count)`` per cluster and shard, adds the
shards in shard order (the reference's ``reduceByKey``) and moves each
centre to its cluster's mean; a cluster without points keeps its
centre. JAX's ``lax.scan``/``while_loop`` are Python loops here. Two
iteration bodies:

  * :func:`make_fit_fn`: torch ops (``ops/kmeans.py``: a distance
    matmul, an argmin, a one-hot matmul);
  * :func:`make_fit_fn_fused`: kernel B10
    (``ops/kmeans_kernels.fused_cluster_stats``), one pass over the
    points an iteration, on the layout of :func:`pack_device`.

Fixed mode runs ``n_iterations`` (the reference runs 5 and never uses
its ``convergeDist``); converge mode stops once the centres move by no
more than ``converge_dist`` in all, which costs one device→host read
an iteration. With ``checkpoint_dir`` the fit runs in saved segments
that equal a straight run bit for bit.

Across processes each process assigns and sums its own shards' points
(:func:`..parallel.spmd.data_parallel`) and the shards' statistics add
in global shard order, so the centres are equal on every process and
equal one process's; the assignments stay row-sharded, each process
holding its own rows and their global range
(``KMeansResult.assignment_rows``).

Minibatch k-means (:func:`fit_minibatch`, Sculley's update) runs over a
``ShardedDataset`` of any backend (``data/``): sampled blocks staged
through the prefetch pipeline, bitwise equal across backends.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.ops import kmeans as kops
from tpu_distalg_torch.ops import kmeans_kernels
from tpu_distalg_torch.parallel import (
    Mesh,
    build_sharded,
    parallelize,
    partition,
    spmd,
    tree_allreduce_sum,
)


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    """The JAX package's fields and defaults (knob names follow the
    reference's ``k-means.py:14-17``)."""

    k: int = 2
    n_iterations: int = 5
    converge_dist: float | None = None  # None → fixed iterations
    max_iterations: int = 1000          # cap in converge mode
    seed: int = 42
    # scale-path init: 'sample' = k random rows (the reference's
    # takeSample); 'farthest' = greedy max-min over an oversample
    init: str = "sample"


@dataclasses.dataclass
class KMeansResult:
    centers: torch.Tensor         # (k, dim)
    assignments: torch.Tensor     # final cluster of this process's points
    n_iterations_run: int
    #: the global (padded, or packed for the fused fit) rows
    #: ``assignments`` covers; None: all of them, in one process
    assignment_rows: range | None = None


def _held_rows(n_held: int, mesh: Mesh) -> range | None:
    """The global rows of this process's ``n_held`` rows (None with one
    process, which holds them all)."""
    if mesh.process_count == 1:
        return None
    n = n_held // mesh.n_local
    return range(mesh.local_data.start * n,
                 (mesh.local_data.start + mesh.n_local) * n)


def _stats(points, mask, centers, mesh: Mesh):
    """Global ``(sums, counts)`` and the cluster of each of this
    process's points: per shard ``assign_clusters`` + ``cluster_stats``,
    summed in shard order."""
    k = centers.shape[0]

    def one(s):
        p = partition.data_block(points, s, mesh)
        assign = kops.assign_clusters(p, centers)
        return (kops.cluster_stats(p, partition.data_block(mask, s, mesh),
                                   assign, k), assign)

    outs = spmd.data_parallel(one, mesh)
    sums, counts = tree_allreduce_sum([st for st, _ in outs], mesh)
    assigns = [a for _, a in outs]
    return sums, counts, (assigns[0] if len(assigns) == 1
                          else torch.cat(assigns))


def _one_iter(points, mask, mesh: Mesh):
    """One torch-op Lloyd iteration: ``centers -> centers``."""
    def one_iter(centers):
        sums, counts, _ = _stats(points, mask, centers, mesh)
        return kops.update_centers(sums, counts, centers)

    return one_iter


def init_centers(points: np.ndarray, k: int, seed: int) -> np.ndarray:
    """Seeded k-point sample without replacement, the reference's
    ``takeSample(False, k, 42)``; equal to the JAX package's."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(points.shape[0], size=k, replace=False)
    return np.asarray(points)[idx].astype(np.float32)


def _seg_loop(one_iter, config: KMeansConfig, seg: int, centers0, shift0,
              n_run0: int):
    """THE Lloyd loop: the straight fit (one full-length segment)
    and every checkpoint segment run this code, so a segmented run
    equals a straight one bit for bit. Fixed mode runs exactly ``seg``
    iterations; converge mode at most ``seg`` more, and because the
    carried ``shift`` enters the loop's condition, segments after
    convergence do nothing. Returns ``(centers, shift, n_run)``."""
    centers = centers0
    if config.converge_dist is None:
        for _ in range(seg):
            centers = one_iter(centers)
        return centers, shift0, n_run0 + seg
    shift, it = shift0, 0
    while float(shift) > config.converge_dist and it < seg:
        new = one_iter(centers)
        shift = torch.sum(torch.sqrt(torch.sum((new - centers) ** 2, dim=1)))
        centers = new
        it += 1
    return centers, shift, n_run0 + it


def _lloyd_loop(one_iter, config: KMeansConfig, centers0):
    """The straight fit: one full-length segment of
    :func:`_seg_loop`. Returns (final centres, iterations run)."""
    n_total = (config.n_iterations if config.converge_dist is None
               else config.max_iterations)
    inf = torch.tensor(float("inf"), dtype=torch.float32,
                       device=centers0.device)
    centers, _, n_run = _seg_loop(one_iter, config, n_total, centers0, inf,
                                  0)
    return centers, n_run


def make_fit_fn(mesh: Mesh, config: KMeansConfig):
    """The torch-op fit: call as ``fit(points, mask, centers0)`` →
    ``(centers, assignments, n_iterations_run)`` with ``points`` and
    ``mask`` the padded arrays of :func:`parallelize` or
    :func:`build_sharded`."""
    def fit(points, mask, centers0):
        centers, n_run = _lloyd_loop(_one_iter(points, mask, mesh),
                                     config, torch.as_tensor(centers0).to(
                                         mesh.device))
        # the final assignment under the final centres, as the
        # reference's closing display re-evaluates them
        _, _, assign = _stats(points, mask, centers, mesh)
        return centers, assign, n_run

    return fit


def pack_device(mesh: Mesh, points, mask, *, dim: int, k: int):
    """Sharded (n, dim) points and their mask on the device → the fused
    kernel's ``(X2, mask2)`` (``kmeans_kernels.pack_points``' layout),
    each shard packing its own slice: columns padded to ``dpad``, a
    shard's ragged tail padded with mask-0 rows. Where nothing needs
    padding the result is a view of ``points``, not a copy."""
    dpad, pp = kmeans_kernels.packed_geometry(dim, k)
    X2s, m2s = [], []
    for s in mesh.local_data:
        p = partition.data_block(points, s, mesh)
        m = partition.data_block(mask, s, mesh)
        pad = (-p.shape[0]) % pp
        if pad or dpad != dim:
            p = torch.nn.functional.pad(p, (0, dpad - dim, 0, pad))
            m = torch.nn.functional.pad(m, (0, pad))
        X2s.append(p.reshape(-1, pp * dpad))
        m2s.append(m.reshape(-1, pp))
    if len(X2s) == 1:
        return X2s[0], m2s[0]
    return torch.cat(X2s), torch.cat(m2s)


def make_fit_fn_fused(mesh: Mesh, config: KMeansConfig, dim: int):
    """Lloyd iterations through kernel B10: call as ``fit(X2, mask2,
    centers0)`` with :func:`pack_device`'s outputs. Centres and the
    iteration count match :func:`make_fit_fn` (up to the order of the
    float32 sums); the assignments are in PACKED order, each shard's
    padding rows included: select with ``mask2.reshape(-1) > 0`` to get
    the input rows' order back."""
    dpad, _ = kmeans_kernels.packed_geometry(dim, config.k)

    def fit(X2, m2, centers0):
        def one_iter(centers):
            sums, counts = tree_allreduce_sum(spmd.data_parallel(
                lambda s: kmeans_kernels.fused_cluster_stats(
                    partition.data_block(X2, s, mesh),
                    partition.data_block(m2, s, mesh), centers, dim=dim,
                    k=config.k), mesh), mesh)
            return kops.update_centers(sums, counts, centers)

        centers, n_run = _lloyd_loop(one_iter, config,
                                     torch.as_tensor(centers0).to(
                                         mesh.device))
        pts = X2.reshape(-1, dpad)[:, :dim]
        return centers, kops.assign_clusters(pts, centers), n_run

    return fit


def _rows_as_tensor(make_rows, ids, device) -> torch.Tensor:
    return make_rows(torch.as_tensor(np.asarray(ids, np.int64),
                                     device=device)).to(torch.float32)


def init_centers_from_rows(make_rows, n_rows: int, k: int, seed: int,
                           device: str | torch.device = "cpu"
                           ) -> torch.Tensor:
    """Seeded init for the scale path: draw k DISTINCT global row ids
    on the host (the ids, never the data) and regenerate exactly those
    rows with the counter-based generator on ``device``. The ids equal
    the JAX package's."""
    if k > n_rows:
        raise ValueError(
            f"cannot sample k={k} distinct rows from n_rows={n_rows}")
    rng = np.random.default_rng(seed)
    chosen: list[int] = []
    seen: set[int] = set()
    while len(chosen) < k:
        for i in rng.integers(0, n_rows, size=k).tolist():
            if i not in seen and len(chosen) < k:
                seen.add(i)
                chosen.append(i)
    return _rows_as_tensor(make_rows, chosen, device)


def init_centers_farthest(make_rows, n_rows: int, k: int, seed: int,
                          oversample: int = 32,
                          device: str | torch.device = "cpu"
                          ) -> torch.Tensor:
    """Farthest-point init for the scale path: regenerate
    ``oversample·k`` candidate rows and greedily pick k by max-min
    distance, on the host. Random-row init merges clusters of a
    balanced mixture with probability about 1 − k!/kᵏ; this does not,
    and needs no pass over the data."""
    rng = np.random.default_rng(seed)
    m = oversample * k
    ids = rng.integers(0, n_rows, size=m, dtype=np.int64)
    cand = _rows_as_tensor(make_rows, ids, device).cpu().numpy()
    chosen = [int(rng.integers(0, m))]
    d = np.linalg.norm(cand - cand[chosen[0]], axis=1)
    while len(chosen) < k:
        nxt = int(d.argmax())
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(cand - cand[nxt], axis=1))
    return torch.as_tensor(cand[chosen], device=device)


def init_centers_scaled(make_rows, n_rows: int, config: KMeansConfig,
                        device: str | torch.device = "cpu"
                        ) -> torch.Tensor:
    """The scale path's ``config.init`` dispatch."""
    if config.init == "farthest":
        return init_centers_farthest(make_rows, n_rows, config.k,
                                     config.seed, device=device)
    if config.init == "sample":
        return init_centers_from_rows(make_rows, n_rows, config.k,
                                      config.seed, device=device)
    raise ValueError(f"unknown init {config.init!r}")


def make_fit_seg_fn(mesh: Mesh, config: KMeansConfig, seg: int):
    """One checkpoint segment: up to ``seg`` Lloyd iterations continuing
    from ``(centers, shift, n_run)``, through the :func:`_seg_loop` the
    straight fit runs."""
    def seg_run(points, mask, centers0, shift0, n_run0):
        return _seg_loop(_one_iter(points, mask, mesh), config, seg,
                         centers0, shift0, n_run0)

    return seg_run


def _fit_segmented(data, mask, mesh: Mesh, config: KMeansConfig, centers0,
                   checkpoint_dir: str, checkpoint_every: int):
    """Checkpointed Lloyd fit: the state is the (k, dim) centres, the
    convergence carry and the iteration count, in that order (an
    artifact's first leaf is the centres)."""
    from tpu_distalg_torch.utils import checkpoint as ckpt

    converge = config.converge_dist is not None
    n_total = config.max_iterations if converge else config.n_iterations
    stop_when = ((lambda s: float(s[1]) <= config.converge_dist)
                 if converge else None)

    def run_seg(fn, state, t0):
        centers, shift, n_run = fn(data, mask, state[0], state[1],
                                   int(state[2]))
        n_run = torch.tensor(n_run, dtype=torch.int32, device=mesh.device)
        return (centers, shift, n_run), shift.reshape(1)

    dev = mesh.device
    state0 = (
        torch.as_tensor(centers0).to(dev),
        # fixed mode never updates shift: it stays finite for the
        # segment-boundary guard; converge mode starts at inf like the
        # straight loop
        torch.tensor(np.inf if converge else 0.0, dtype=torch.float32,
                     device=dev),
        torch.tensor(0, dtype=torch.int32, device=dev),
    )
    state, _, _ = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, n_total,
        lambda seg: make_fit_seg_fn(mesh, config, seg), run_seg, state0,
        # fixed mode's shift = 0 would read as "converged" to a
        # converge-mode resume: the tag keeps the modes apart
        tag="kmeans_converge" if converge else "kmeans_fixed",
        stop_when=stop_when, mesh=mesh)
    centers = state[0]
    _, _, assign = _stats(data, mask, centers, mesh)
    return KMeansResult(centers=centers, assignments=assign,
                        n_iterations_run=int(state[2]))


def _fit_sharded(ps, mesh: Mesh, config: KMeansConfig, centers0,
                 checkpoint_dir: str | None, checkpoint_every: int):
    """The torch-op fit of sharded points, straight or in segments."""
    if checkpoint_dir is not None:
        return _fit_segmented(ps.data, ps.mask, mesh, config, centers0,
                              checkpoint_dir, checkpoint_every)
    centers, assign, n_run = make_fit_fn(mesh, config)(ps.data, ps.mask,
                                                       centers0)
    return KMeansResult(centers=centers, assignments=assign,
                        n_iterations_run=n_run,
                        assignment_rows=_held_rows(ps.data.shape[0], mesh))


def fit(points: np.ndarray, mesh: Mesh,
        config: KMeansConfig = KMeansConfig(), *,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 100) -> KMeansResult:
    """End-to-end fit of host points on the mesh's device."""
    return _fit_sharded(parallelize(points, mesh, table="kmeans",
                                    leaf="points"), mesh, config,
                        init_centers(points, config.k, config.seed),
                        checkpoint_dir, checkpoint_every)


def make_minibatch_step_fn(mesh: Mesh, k: int, dim: int):
    """Minibatch k-means' step over one staged batch of a
    ``ShardedDataset`` in the ``points_valid_f32`` layout
    (``data/builders.py``), ``models/kmeans.py:338-378`` of the JAX
    package: per shard, ``assign_clusters`` and the masked
    ``cluster_stats`` of the staged rows (torch ops, as JAX runs XLA
    ops there), summed in shard order, then Sculley's (2010) update,
    each centre moved toward its minibatch mean at rate ``count_c /
    n_seen_c``. ``step(staged, centers, n_seen) -> (centers, n_seen)``;
    the arithmetic is the same whichever backend staged the batch, so a
    run is bitwise equal across backends. Across processes the staged
    batch holds this process's shards, and the stats add over every
    shard in global order."""
    def step(staged, centers, n_seen):
        per = []
        for s in range(staged.shape[0]):
            pts, m = staged[s, :, :dim], staged[s, :, dim]
            per.append(kops.cluster_stats(
                pts, m, kops.assign_clusters(pts, centers), k))
        sums, counts = tree_allreduce_sum(per, mesh)
        n_seen = n_seen + counts
        eta = torch.where(n_seen > 0, counts / torch.clamp_min(n_seen, 1.0),
                          0.0)
        means = sums / torch.clamp_min(counts, 1.0)[:, None]
        centers = torch.where(counts[:, None] > 0,
                              centers + eta[:, None] * (means - centers),
                              centers)
        return centers, n_seen

    return step


def init_centers_from_dataset(dataset, k: int, seed: int) -> torch.Tensor:
    """Greedy farthest-point init over the dataset's first block (shard
    0), on the host: the same for every backend (the staged block is).
    A random k-sample would merge clusters, which the minibatch update
    cannot split (``init_centers_farthest``). Across processes process
    0's first shard is shard 0, and its block crosses to the others."""
    from tpu_distalg_torch.parallel.collectives import allgather_rows

    block0 = dataset.stage(np.zeros((dataset.n_shards, 1), np.int64))
    block0 = allgather_rows(block0[:1].contiguous(), dataset.mesh)
    block0 = block0[0].cpu().numpy()
    dim = block0.shape[1] - 1
    pts = block0[block0[:, dim] > 0][:, :dim]
    if k > pts.shape[0]:
        raise ValueError(
            f"cannot sample k={k} centers from a {pts.shape[0]}-row "
            "first block; raise block_rows")
    rng = np.random.default_rng(seed)
    chosen = [int(rng.integers(0, pts.shape[0]))]
    d = np.linalg.norm(pts - pts[chosen[0]], axis=1)
    while len(chosen) < k:
        nxt = int(d.argmax())
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(pts - pts[nxt], axis=1))
    return torch.from_numpy(pts[chosen].astype(np.float32)).to(
        dataset.device)


def fit_minibatch(dataset, config: KMeansConfig, *, n_steps: int,
                  mini_batch_blocks: int = 4,
                  centers0=None) -> KMeansResult:
    """Minibatch k-means over a :class:`~tpu_distalg_torch.data.
    ShardedDataset` in the ``points_valid_f32`` layout: each step draws
    ``mini_batch_blocks`` blocks a shard with the host block sampler
    the streamed SSGD trainer uses (keyed on the absolute step), stages
    them through the prefetch pipeline and folds them into the centres
    with Sculley's update. Padding rows carry valid 0 and are inert."""
    import contextlib

    from tpu_distalg_torch.data import make_host_block_sampler
    from tpu_distalg_torch.utils import metrics

    dim = int(dataset.meta.get("dim", dataset.pd - 1))
    ns = min(mini_batch_blocks, dataset.n_blocks)
    ids = make_host_block_sampler(config.seed, dataset.n_shards,
                                  dataset.n_blocks, ns,
                                  dataset.device)(np.arange(n_steps))
    if centers0 is None:
        centers0 = init_centers_from_dataset(dataset, config.k, config.seed)
    step = make_minibatch_step_fn(dataset.mesh, config.k, dim)
    centers = torch.as_tensor(centers0, dtype=torch.float32).to(
        dataset.device)
    n_seen = torch.zeros((config.k,), dtype=torch.float32,
                         device=dataset.device)
    with contextlib.closing(dataset.stream(ids)) as batches:
        for staged in batches:
            centers, n_seen = step(staged, centers, n_seen)
    metrics.guard_finite(centers, "minibatch k-means centers")
    return KMeansResult(centers=centers,
                        assignments=torch.zeros((0,), dtype=torch.int64,
                                                device=dataset.device),
                        n_iterations_run=n_steps)


def fit_scaled(mesh: Mesh, n_rows: int, make_rows,
               config: KMeansConfig = KMeansConfig(), *,
               checkpoint_dir: str | None = None,
               checkpoint_every: int = 100) -> KMeansResult:
    """Scale-out fit: the dataset is synthesized ON the device, shard by
    shard (:func:`build_sharded`), and the initial centres are
    regenerated from row ids, so host memory is O(k) in ``n_rows``.
    ``make_rows(row_ids)`` must be counter-based
    (``datasets.gaussian_mixture_rows``)."""
    return _fit_sharded(
        build_sharded(mesh, n_rows, make_rows), mesh, config,
        init_centers_scaled(make_rows, n_rows, config, mesh.device),
        checkpoint_dir, checkpoint_every)
