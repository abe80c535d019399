"""Streamed PageRank sweeps over edge-block caches: out-of-core PageRank.

Port of ``tpu_distalg/graphs/engine.py``. The edges stay on disk
(:mod:`.ingest` caches) and flow through the data subsystem's prefetch
pipeline (:meth:`..data.ShardedDataset.stream`: gather ∥ H2D ∥ sweep,
through the ``data:gather`` and ``data:h2d`` seams); only the O(V)
state lives on the device: the rank vector, the out-link mask and each
shard's window accumulator.

One power iteration::

    for each staged batch (S, bb·block_edges, 3), for each shard s:
        acc[s] += the batch's per-dst sums of ranks[src]·w   (B7, in
                  dst − lo_s; ops/graph.accumulate_block)
    c = the shards' windows combined into (V,):
        sparse: comms.sparse_allreduce of acc[s][didx]·dmask at
                didx + lo_s (each shard's distinct destinations)
        dense:  each window placed at lo_s in a (V,) vector, out-of-range
                positions dropped, the shards added in shard order
    ranks' = q/V + (1 − q)·(c + dangling/V)

The emulated shards run one after another on one device, as every
emulated mesh of the port does. ``combine='auto'`` picks by the wire
bytes ``comms.rank_combine_stats`` counts (``8k(n−1)`` pair bytes
against the dense ring's ``4V·2(n−1)/n``); the counters go out through
``comms.emit_rank_combine_counters``.

Contracts, as in the JAX package: streamed ≡ virtual ≡ resident bit for
bit (the three backends stage the same bytes and share every function
here), a run replays bit for bit (B7 sums in a fixed order, the window
add has no atomics), and a run segmented through
``utils/checkpoint.run_segmented`` (tag ``pagerank_streamed``) equals
the straight run bit for bit.

Not ported: the JAX package's CPU-mesh rendezvous guard (``serialize``,
which blocks after every batch on a CPU mesh so that its collectives do
not starve): the port's shards are emulated on one device and run no
collective, so there is nothing to guard.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.data import cache as dcache
from tpu_distalg_torch.graphs import ingest
from tpu_distalg_torch.telemetry import events as tevents

COMBINES = ("auto", "sparse", "dense")


@dataclasses.dataclass(frozen=True)
class StreamedPageRankConfig:
    """Standard-mode PageRank over a streamed edge-block cache (the
    reference-parity mode's per-vertex receive masks are a resident
    concern)."""

    n_iterations: int = 10
    q: float = 0.15
    redistribute_dangling: bool = True
    batch_blocks: int = 4       # blocks per shard per staged step
    combine: str = "auto"       # 'auto' | 'sparse' | 'dense'

    def __post_init__(self):
        if self.combine not in COMBINES:
            raise ValueError(
                f"unknown combine {self.combine!r}; choose from "
                f"{COMBINES}")


@dataclasses.dataclass
class StreamedPageRankResult:
    ranks: torch.Tensor         # (V,) float32
    n_iterations_run: int
    combine: str                # the resolved combine ('sparse'/'dense')
    comm_stats: dict            # per-sync rank_combine_stats accounting


@dataclasses.dataclass
class GraphDataset:
    """An opened edge-block cache and its O(V)/O(k) side state on the
    mesh's device: everything a sweep needs besides the staged blocks."""

    ds: object                  # ShardedDataset of packed edge rows
    header: dict
    lo: list                    # (S,) each shard's window base dst
    didx: torch.Tensor          # (S, k) int64 local offsets
    dmask: torch.Tensor         # (S, k) float32 pair validity
    has_out: torch.Tensor       # (V,) float32

    @property
    def geom(self) -> dict:
        return self.header["geom"]

    @property
    def n_vertices(self) -> int:
        return int(self.geom["n_vertices"])

    @property
    def n_edges(self) -> int:
        return int(self.geom["n_edges"])

    @property
    def window(self) -> int:
        return int(self.geom["window"])

    @property
    def k_sparse(self) -> int:
        return int(self.geom["k_sparse"])

    @property
    def n_shards(self) -> int:
        return int(self.geom["n_shards"])


def open_graph_dataset(path: str, mesh, *, backend: str = "streamed",
                       legacy_geom: dict | None = None) -> GraphDataset:
    """Open a COMPLETE edge-block cache behind any data backend:
    ``streamed`` memmaps the bin; ``virtual`` copies it into host memory
    and ``resident`` onto the mesh's device (the same bytes: sweeps are
    bitwise equal across the three). The cache's shard count must be
    the mesh's data axis (windows are baked at ingest).

    ``legacy_geom``: a cache whose meta.json is the bare flat geometry
    (the pre-versioned header) reopens when it matches, its memmap
    rebuilt from the geometry."""
    from tpu_distalg_torch.data.sharded import ShardedDataset

    mm, header = dcache.open_cache(path, layout=ingest.LAYOUT,
                                   legacy_geom=legacy_geom)
    geom = header["geom"]
    if int(geom.get("bv", -1)) != ingest.BLOCK_FORMAT_VERSION:
        raise ValueError(
            f"edge-block cache at {path!r} has block format "
            f"bv={geom.get('bv')!r}; this engine speaks "
            f"bv={ingest.BLOCK_FORMAT_VERSION} — re-ingest the edges")
    n_shards = int(mesh.n_data)
    if int(geom["n_shards"]) != n_shards:
        raise ValueError(
            f"edge-block cache at {path!r} was ingested for "
            f"{geom['n_shards']} shards; this mesh has {n_shards} — "
            f"shard windows are baked at ingest, re-ingest for this "
            f"mesh (or open on a matching one)")
    if mm is None:
        gran = int(geom["n_shards"]) * int(geom["block_edges"])
        n_rows = -(-int(geom["n_edges"]) // gran) * gran
        mm = np.memmap(dcache.bin_path(path), dtype=np.int32, mode="r",
                       shape=(n_rows, ingest.ROW_WIDTH))
    deg, didx, dmask = ingest.read_aux(path, geom)
    block_edges = int(geom["block_edges"])
    if backend == "streamed":
        ds = ShardedDataset(mm, mesh, block_rows=block_edges,
                            meta=dict(geom), backend="streamed")
    elif backend in ("virtual", "resident"):
        ds = ShardedDataset.from_array(
            np.array(mm), mesh, block_rows=block_edges, meta=dict(geom),
            backend=backend)
    else:
        raise ValueError(
            f"unknown graph data backend {backend!r}; choose from "
            f"('resident', 'virtual', 'streamed')")
    dev = mesh.device
    return GraphDataset(
        ds=ds, header=header, lo=[int(x) for x in geom["lo"]],
        didx=torch.from_numpy(didx.astype(np.int64)).to(dev),
        dmask=torch.from_numpy(dmask).to(dev),
        has_out=torch.from_numpy((deg > 0).astype(np.float32)).to(dev))


def resolve_combine(combine: str, k: int, length: int, n: int) -> str:
    """'auto' picks the combine whose accounting moves fewer bytes:
    the sparse pair exchange (``8k(n−1)``) or the dense ring psum
    (``4V·2(n−1)/n``). Deterministic in the geometry."""
    from tpu_distalg_torch.parallel import comms

    if combine != "auto":
        return combine
    st = comms.rank_combine_stats(k, length, n)
    return ("sparse" if st["bytes_wire"] <= st["bytes_dense_ring"]
            else "dense")


def _block_schedule(n_blocks: int, n_shards: int,
                    batch_blocks: int) -> np.ndarray:
    """Every shard's local blocks in order, ``bb`` a staged step, ``bb``
    the largest divisor of ``n_blocks`` ≤ ``batch_blocks`` (one batch
    shape for the whole sweep)."""
    bb = max(1, min(int(batch_blocks), n_blocks))
    while n_blocks % bb:
        bb -= 1
    local = np.arange(n_blocks, dtype=np.int64).reshape(-1, 1, bb)
    return np.broadcast_to(local, (n_blocks // bb, n_shards, bb))


def make_sweep_fns(gd: GraphDataset, config: StreamedPageRankConfig):
    """The three pieces of one power iteration, ``(zeros_fn, accum_fn,
    update_fn, combine)``: the zeroed (S, window + 1) accumulators (the
    last column the trash slot of :func:`..ops.graph.accumulate_block`),
    the accumulate of one staged batch, and the combine and update.
    Every backend, iteration and segment runs these and nothing else."""
    from tpu_distalg_torch.ops import graph as gops
    from tpu_distalg_torch.parallel import comms, tree_allreduce_sum

    V, W, S = gd.n_vertices, gd.window, gd.n_shards
    dev = gd.has_out.device
    combine = resolve_combine(config.combine, gd.k_sparse, V, S)
    q = config.q

    def zeros_fn():
        return torch.zeros((S, W + 1), dtype=torch.float32, device=dev)

    def accum_fn(acc, staged, ranks):
        for s in range(S):
            gops.accumulate_block(acc[s], ranks, staged[s], gd.lo[s])
        return acc

    if combine == "sparse":
        # padding pairs (dmask 0) carry value 0; they go to a trash
        # index V, so each shard's real indices are unique
        lo = torch.tensor(gd.lo, dtype=torch.int64, device=dev)[:, None]
        idx = torch.where(gd.dmask > 0, gd.didx + lo, V)

        def combined(acc):
            vals = torch.gather(acc, 1, gd.didx) * gd.dmask
            return comms.sparse_allreduce(vals, idx, V + 1,
                                          unique=True)[:V]
    else:
        def combined(acc):
            def placed(s):
                dense = torch.zeros(V, dtype=torch.float32, device=dev)
                n = min(W, V - gd.lo[s])
                dense[gd.lo[s]:gd.lo[s] + n] = acc[s, :n]
                return (dense,)

            (c,) = tree_allreduce_sum(placed(s) for s in range(S))
            return c

    sink = 1.0 - gd.has_out

    def update_fn(acc, ranks):
        c = combined(acc)
        if config.redistribute_dangling:
            c = c + torch.sum(ranks * sink) / V
        return q / V + (1.0 - q) * c

    return zeros_fn, accum_fn, update_fn, combine


def run_streamed_pagerank(gd: GraphDataset,
                          config: StreamedPageRankConfig =
                          StreamedPageRankConfig(), *,
                          checkpoint_dir: str | None = None,
                          checkpoint_every: int = 5
                          ) -> StreamedPageRankResult:
    """The out-of-core power iteration. With ``checkpoint_dir`` the run
    is segmented (``utils/checkpoint.run_segmented``: the (V,) ranks are
    saved after every segment, and a later run resumes from the newest
    bit for bit). The rank combine's counters count the sweeps actually
    run."""
    from tpu_distalg_torch.parallel import comms

    V, S = gd.n_vertices, gd.n_shards
    zeros_fn, accum_fn, update_fn, combine = make_sweep_fns(gd, config)
    ids = _block_schedule(gd.ds.n_blocks, S, config.batch_blocks)
    executed = {"n": 0}

    def sweep(ranks):
        with tevents.span("graph:sweep", backend=gd.ds.backend,
                          n_edges=gd.n_edges, combine=combine):
            acc = zeros_fn()
            with contextlib.closing(gd.ds.stream(ids)) as batches:
                for staged in batches:
                    acc = accum_fn(acc, staged, ranks)
            ranks = update_fn(acc, ranks)
        tevents.counter("graph.edges_streamed", gd.n_edges)
        executed["n"] += 1
        return ranks

    ranks0 = torch.full((V,), 1.0 / V, dtype=torch.float32,
                        device=gd.has_out.device)
    if checkpoint_dir is None:
        ranks = ranks0
        for _ in range(config.n_iterations):
            ranks = sweep(ranks)
    else:
        from tpu_distalg_torch.utils import checkpoint as ckpt

        def run_seg(seg, state, t0):
            (ranks,) = state
            for _ in range(seg):
                ranks = sweep(ranks)
            return (ranks,), torch.sum(ranks).reshape(1)

        (ranks,), _, _ = ckpt.run_segmented(
            checkpoint_dir, checkpoint_every, config.n_iterations,
            lambda seg: seg, run_seg, (ranks0,), tag="pagerank_streamed")
    st = comms.emit_rank_combine_counters(
        gd.k_sparse, V, S, n_syncs=executed["n"], combine=combine)
    return StreamedPageRankResult(
        ranks=ranks, n_iterations_run=config.n_iterations,
        combine=combine, comm_stats=st)
