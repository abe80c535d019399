"""PageRank power iteration.

Port of ``tpu_distalg/models/pagerank.py``. The edges are deduplicated
and sorted by dst once on the host (:mod:`..ops.graph`), held on the
device as CSR rows (:func:`..ops.pagerank_kernels.plan_csr`), and split
into the emulated data shards' contiguous slices; each shard sweeps its
slice into a dense (V,) vector and the shards' vectors are added in
shard order (the JAX package's psum). JAX's ``lax.scan`` over the
iterations is a Python loop here.

Two modes, as in the JAX package:
  * ``mode='reference'`` reproduces the reference's semantics: n is the
    number of vertices with out-links, a vertex holds a rank in round
    t+1 only if it received a contribution in round t, and sink mass
    vanishes. Each iteration runs kernel B7 twice: on ``ranks·has_rank``
    with ``w_e`` (each product equals JAX's ``ranks[src]·(w_e·active)``
    bit for bit, since ``active`` is 0 or 1) and on ``has_rank`` with
    weight 1, which counts the contributions each vertex received.
  * ``mode='standard'``: textbook PageRank over all vertices with the
    dangling mass spread evenly. ``scatter`` picks the sweep:
    ``auto``/``spmv`` run B7 (the JAX package's Path E); ``pallas`` a
    torch gather ``ranks[src]·w_e`` and then B8 (the JAX hybrid sweep);
    ``xla`` the library call ``torch.sparse_csr_tensor(...) @ ranks``,
    the A/B line (JAX's ``segment_sum`` sweep), which is not a kernel
    path. The CSR plan exists for every graph, so on the card ``auto``
    is always B7 and ``pallas``/``spmv`` never lack a plan.

The streamed and virtual backends are the out-of-core engine
(:mod:`..graphs`: edge-block caches swept a staged batch at a time
through B7, standard mode); :func:`choose_data_backend` names the one a
run takes. The JAX package's ~12M-vertex VMEM guard is a TPU limit and
has no counterpart here, so ``resident`` stays resident at any size.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from tpu_distalg_torch.ops import graph as gops
from tpu_distalg_torch.ops import pagerank_kernels as pk
from tpu_distalg_torch.parallel import Mesh, tree_allreduce_sum

_MODES = ("reference", "standard")
_SCATTERS = ("auto", "pallas", "xla", "spmv")


@dataclasses.dataclass(frozen=True)
class PageRankConfig:
    """The JAX package's knobs and defaults (names follow the
    reference's ``pagerank.py:17-19``)."""

    n_iterations: int = 10
    q: float = 0.15
    mode: str = "reference"  # 'reference' | 'standard'
    redistribute_dangling: bool = True  # standard mode only
    scatter: str = "auto"  # 'auto' | 'pallas' | 'xla' | 'spmv'


@dataclasses.dataclass
class PageRankResult:
    ranks: torch.Tensor     # (V,) float32
    has_rank: torch.Tensor  # (V,) float32: 1 where a vertex holds a rank


@dataclasses.dataclass
class DeviceEdges:
    """The CSR rows of each emulated shard on the mesh's device:
    ``shards[s] = (row_ptr (V+1,) int32, src int32, w_e float32)`` over
    shard s's slice of the dst-sorted edges, and ``plans[s]`` the
    kernels' tile plan of its rows (``pagerank_kernels.tile_plan``)."""

    shards: list
    plans: list
    has_out: torch.Tensor   # (V,) float32
    n_vertices: int
    n_edges: int
    n_ref: float            # the reference's n: vertices with out-links


def choose_data_backend(requested: str) -> str:
    """The ``--data-backend`` knob: ``resident`` (this module's CSR
    sweep), or ``streamed``/``virtual`` (the out-of-core engine,
    :mod:`..graphs`). The JAX package's VMEM guard, which turns a large
    resident request into a streamed one, has no counterpart: the CSR
    sweep has no window caps, so every request is kept as it is."""
    if requested in ("resident", "streamed", "virtual"):
        return requested
    raise ValueError(f"unknown data backend {requested!r}")


def prepare_device_edges(el: gops.EdgeList, mesh: Mesh) -> DeviceEdges:
    """One-time prep: the dst-sorted CSR plan, each shard's rows and
    their tile plan for the kernels, and the per-vertex out-link mask, on
    ``mesh.device`` (int32 and float32, converted once after the range
    checks)."""
    plan = pk.plan_csr(el, mesh.n_data)
    dev = mesh.device
    src = torch.from_numpy(plan.src).to(dev)
    w_e = torch.from_numpy(plan.w_e).to(dev)
    shards = []
    for s, (lo, hi) in enumerate(plan.bounds):
        shards.append((torch.from_numpy(plan.shard_row_ptr(s)).to(dev),
                       src[lo:hi], w_e[lo:hi]))
    has_out = (el.out_degree > 0).astype(np.float32)
    return DeviceEdges(shards=shards,
                       plans=[pk.tile_plan(rp, src.shape[0])
                              for rp, src, _ in shards],
                       has_out=torch.from_numpy(has_out).to(dev),
                       n_vertices=el.n_vertices, n_edges=el.n_edges,
                       n_ref=float(has_out.sum()))


def _check_config(config: PageRankConfig) -> None:
    if config.mode not in _MODES:
        raise ValueError(f"unknown mode {config.mode!r}")
    if config.scatter not in _SCATTERS:
        raise ValueError(f"unknown scatter mode {config.scatter!r}")
    if config.mode != "standard" and config.scatter != "auto":
        raise ValueError(
            f"scatter={config.scatter!r} only applies to mode="
            "'standard' — the reference-parity mode always sweeps with "
            "the kernel B7")


def _library_sweep(de: DeviceEdges):
    """``scatter='xla'``: one sparse CSR matrix per shard, applied with
    ``@`` (the library's SpMV; the A/B line, not a kernel path)."""
    V = de.n_vertices
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        mats = [torch.sparse_csr_tensor(rp, src, w, (V, V),
                                        check_invariants=False)
                for rp, src, w in de.shards]
    return lambda x: [m @ x for m in mats]


def _sweep(de: DeviceEdges, scatter: str):
    """``sweep(ranks)`` → each shard's (V,) contributions."""
    if scatter in ("auto", "spmv"):
        return lambda x: [pk.spmv_table(rp, src, w, x, plan)
                          for (rp, src, w), plan in zip(de.shards, de.plans)]
    if scatter == "pallas":
        def gather_then_b8(x):
            return [pk.scatter_table(rp, torch.index_select(x, 0, src) * w,
                                     plan)
                    for (rp, src, w), plan in zip(de.shards, de.plans)]

        return gather_then_b8
    return _library_sweep(de)


def make_run_fn(mesh: Mesh, config: PageRankConfig, n_vertices: int):
    """The n-iteration sweep: call as ``run(de, ranks0=None,
    has_rank0=None)`` → ``(ranks, has_rank)`` with ``de`` from
    :func:`prepare_device_edges`. The carry-in resumes the power
    iteration mid-schedule (iterations do not depend on their index, so
    segments of a run equal the straight run bit for bit)."""
    _check_config(config)
    del mesh
    V = n_vertices
    q = config.q
    n_it = config.n_iterations

    if config.mode == "reference":
        def run(de, ranks0=None, has_rank0=None):
            ranks, has_rank = _carry_in(de, config, ranks0, has_rank0)
            ones = [torch.ones_like(w) for _, _, w in de.shards]
            for _ in range(n_it):
                x = ranks * has_rank
                c, received = tree_allreduce_sum(
                    (pk.spmv_table(rp, src, w, x, plan),
                     pk.spmv_table(rp, src, one, has_rank, plan))
                    for (rp, src, w), one, plan in zip(de.shards, ones,
                                                       de.plans))
                has_rank = (received > 0).to(torch.float32)
                ranks = torch.where(received > 0,
                                    q / de.n_ref + (1 - q) * c, 0.0)  # :57
            return ranks, has_rank

        return run

    def run(de, ranks0=None, has_rank0=None):
        # every vertex holds a rank in standard mode
        ranks, _ = _carry_in(de, config, ranks0, has_rank0)
        sweep = _sweep(de, config.scatter)
        sink = 1.0 - de.has_out
        for _ in range(n_it):
            (c,) = tree_allreduce_sum((part,) for part in sweep(ranks))
            if config.redistribute_dangling:
                c = c + torch.sum(ranks * sink) / V
            ranks = q / V + (1 - q) * c
        return ranks, torch.ones_like(ranks)

    return run


def run(edges: np.ndarray, mesh: Mesh,
        config: PageRankConfig = PageRankConfig(),
        n_vertices: int | None = None, *,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 5, ranks0=None,
        has_rank0=None) -> PageRankResult:
    """PageRank of an (E, 2) edge array on ``mesh.device``: host prep,
    upload, then :func:`run_prepared`. ``ranks0``/``has_rank0`` carry in
    a rank state (``convert.pagerank_state_from_jax``)."""
    _check_config(config)
    de = prepare_device_edges(gops.prepare_edges(edges, n_vertices), mesh)
    return run_prepared(de, mesh, config, checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every, ranks0=ranks0,
                        has_rank0=has_rank0)


def _carry_in(de: DeviceEdges, config: PageRankConfig, ranks0=None,
              has_rank0=None):
    """``(ranks0, has_rank0)``: what the caller carries in, else a fresh
    run's (``pagerank.py:47``; standard mode: 1/V everywhere)."""
    if config.mode == "reference":
        r0 = torch.where(de.has_out > 0, 1.0 / de.n_ref, 0.0)
        h0 = de.has_out
    else:
        r0 = torch.full((de.n_vertices,), 1.0 / de.n_vertices,
                        dtype=torch.float32, device=de.has_out.device)
        h0 = torch.ones_like(r0)
    return (r0 if ranks0 is None else ranks0,
            h0 if has_rank0 is None else has_rank0)


def run_prepared(de: DeviceEdges, mesh: Mesh,
                 config: PageRankConfig = PageRankConfig(), *,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 5, ranks0=None,
                 has_rank0=None) -> PageRankResult:
    """The power iteration on prepared edges; with ``checkpoint_dir``,
    in segments of ``checkpoint_every`` iterations that are saved after
    each and resumed from the newest (:func:`_run_segmented`)."""
    if checkpoint_dir is not None:
        return _run_segmented(de, mesh, config, checkpoint_dir,
                              checkpoint_every, ranks0, has_rank0)
    fn = make_run_fn(mesh, config, de.n_vertices)
    ranks, has_rank = fn(de, ranks0, has_rank0)
    return PageRankResult(ranks=ranks, has_rank=has_rank)


def _run_segmented(de: DeviceEdges, mesh: Mesh, config: PageRankConfig,
                   checkpoint_dir: str, checkpoint_every: int,
                   ranks0=None, has_rank0=None) -> PageRankResult:
    """Checkpointed power iteration: the state is the (V,) rank vector
    and the reference mode's has_rank mask, tagged with the mode so a
    run cannot resume the other mode's state. Segments equal the
    straight run bit for bit."""
    from tpu_distalg_torch.utils import checkpoint as ckpt

    state0 = _carry_in(de, config, ranks0, has_rank0)

    def make_seg_fn(seg):
        return make_run_fn(mesh, dataclasses.replace(config,
                                                     n_iterations=seg),
                           de.n_vertices)

    def run_seg(fn, state, t0):
        ranks, has_rank = fn(de, *state)
        return (ranks, has_rank), torch.sum(ranks).reshape(1)

    (ranks, has_rank), _, _ = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, config.n_iterations, make_seg_fn,
        run_seg, state0, tag=f"pagerank_{config.mode}")
    return PageRankResult(ranks=ranks, has_rank=has_rank)
