"""Transitive closure by fixpoint iteration.

Port of ``tpu_distalg/models/transitive_closure.py``. The reference
joins its whole path set against the edges, unions, dedups and counts
every round until the count stops growing (``transitive_closure.py:
27-40``). Two formulations, as in the JAX package:

  * :func:`run` keeps the paths as a dense (V, V) bool matrix: a round
    is a boolean matmul and a logical or (:func:`..ops.graph.
    closure_step`), V padded up to a multiple of the data shards;
  * :func:`run_sparse` keeps them as a capacity-capped buffer of
    distinct (x, z) pairs sorted by x then z (padding (V, V) last): a
    round is the CSR segmented expand (path (x, y) joins y's
    out-edges), the union with the known set, the distinct, and the
    compaction back into the buffer. :func:`run_sparse_auto` doubles the
    capacity on overflow, within a byte budget.

The JAX package runs each fixpoint inside ``lax.while_loop``; here the
loop is on the host, which reads the count once a round (and the
sparse round's join size, to test it against its buffer). The sparse
round's set operations are one int64 key x·(V+1)+z, sorted once and
deduplicated (``torch.unique``), which orders the pairs as JAX's
two-key sort does. Its buffers have JAX's capacities and its overflow
rule exactly — a round whose join exceeds J or whose distinct count
exceeds C overflows the run, though torch could size the buffers to
the true join — so :func:`run_sparse_auto` regrows through JAX's
capacities. With ``checkpoint_dir`` a run goes through
:func:`..utils.checkpoint.run_segmented` (tags ``closure_dense`` and
``closure_sparse``) and resumes bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.ops import graph as gops
from tpu_distalg_torch.parallel import Mesh


@dataclasses.dataclass(frozen=True)
class ClosureConfig:
    max_iterations: int | None = None  # None → V + 1 (always enough)


@dataclasses.dataclass
class ClosureResult:
    paths: torch.Tensor  # (V_pad, V_pad) bool reachability
    n_paths: int         # the reference's final paths.count() (:42)
    n_rounds: int


@dataclasses.dataclass(frozen=True)
class SparseClosureConfig:
    """Config for :func:`run_sparse`. ``capacity`` bounds the distinct
    paths the buffer holds (auto = max(8×edges, 1024), rounded up to the
    shards); ``join_capacity`` bounds the (path ⋈ edge) candidates of
    one round (auto = max(2×capacity, 8×edges, 1024)); ``max_iterations``
    caps the fixpoint (auto = V + 1)."""

    capacity: int | None = None
    join_capacity: int | None = None
    max_iterations: int | None = None


@dataclasses.dataclass
class SparseClosureResult:
    paths: np.ndarray  # (n_paths, 2) distinct (x, z) pairs, sorted
    n_paths: int
    n_rounds: int


def _scalar(v: int) -> torch.Tensor:
    """A host int64 counter of the fixpoint state."""
    return torch.tensor(int(v), dtype=torch.int64)


def _segmented(checkpoint_dir, checkpoint_every, cap, rounds, state0, tag,
               stop_when, cnt_at: int):
    """Run ``rounds(state, seg)`` (up to ``seg`` more rounds, bounded by
    ``cap``) through :func:`..utils.checkpoint.run_segmented`; a
    segment's history entry is the count (``state[cnt_at]``) as
    float32."""
    from tpu_distalg_torch.utils import checkpoint as ckpt

    def run_seg(seg, state, t0):
        del t0  # the fixpoint carries its own round counter
        state = rounds(state, seg)
        return state, np.asarray([float(state[cnt_at])], np.float32)

    state, _, _ = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, cap, lambda seg: seg, run_seg,
        state0, tag=tag, stop_when=stop_when)
    return state


def run(edges: np.ndarray, mesh: Mesh,
        config: ClosureConfig = ClosureConfig(),
        n_vertices: int | None = None, *,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 8) -> ClosureResult:
    """The dense fixpoint: paths start as the edge set; each round
    composes them with the edges and adds the result, until the count
    stops growing or ``max_iterations`` rounds have run."""
    el = gops.prepare_edges(edges, n_vertices)
    n_shards = mesh.n_data
    # pad the vertex count so the path matrix's rows split evenly over
    # the shards; padded vertices are isolated and add no paths
    V = -(-el.n_vertices // n_shards) * n_shards
    cap = config.max_iterations if config.max_iterations is not None \
        else V + 1
    adj = torch.zeros((V, V), dtype=torch.bool, device=mesh.device)
    adj[torch.from_numpy(el.src.astype(np.int64)).to(mesh.device),
        torch.from_numpy(el.dst.astype(np.int64)).to(mesh.device)] = True
    edges_op = gops.closure_operand(adj)

    def rounds(state, seg):
        paths, old, cnt, it = state
        old, cnt, it = int(old), int(cnt), int(it)
        it_hi = min(it + seg, cap)
        while cnt != old and it < it_hi:
            paths = gops.closure_step(paths, edges_op)
            old, cnt, it = cnt, int(gops.path_count(paths)), it + 1
        return paths, _scalar(old), _scalar(cnt), _scalar(it)

    state0 = (adj, _scalar(-1), _scalar(int(gops.path_count(adj))),
              _scalar(0))
    if checkpoint_dir is None:
        paths, _, cnt, it = rounds(state0, cap)
    else:
        paths, _, cnt, it = _segmented(
            checkpoint_dir, checkpoint_every, cap, rounds, state0,
            "closure_dense", lambda s: int(s[2]) == int(s[1]), cnt_at=2)
    return ClosureResult(paths=paths, n_paths=int(cnt), n_rounds=int(it))


def run_sparse(edges: np.ndarray, mesh: Mesh,
               config: SparseClosureConfig = SparseClosureConfig(),
               n_vertices: int | None = None, *,
               checkpoint_dir: str | None = None,
               checkpoint_every: int = 8) -> SparseClosureResult:
    """Transitive closure without the V×V matrix, in O(closure size)
    memory. Like the reference it re-joins the whole path set each
    round. Raises ValueError when a round overflows ``capacity`` or
    ``join_capacity``."""
    el = gops.prepare_edges(edges, n_vertices)
    V, E = el.n_vertices, el.n_edges
    C = (config.capacity if config.capacity is not None
         else max(8 * E, 1024))
    C = -(-C // mesh.n_data) * mesh.n_data
    J = (config.join_capacity if config.join_capacity is not None
         else max(2 * C, 8 * E, 1024))
    cap = config.max_iterations if config.max_iterations is not None \
        else V + 1
    if E > C:
        raise ValueError(f"capacity {C} < edge count {E}")
    dev = mesh.device
    # CSR over src (prepare_edges sorts by src); the sentinel vertex V
    # has degree 0, so padding entries join nothing
    offsets = np.zeros(V + 2, dtype=np.int64)
    offsets[1:V + 1] = np.cumsum(np.bincount(el.src, minlength=V))
    offsets[V + 1] = offsets[V]
    deg = torch.from_numpy(np.diff(offsets)).to(dev)          # (V+1,)
    off = torch.from_numpy(offsets[:V + 1]).to(dev)
    dst = torch.from_numpy(el.dst.astype(np.int64)).to(dev)   # src-sorted
    px0 = torch.full((C,), V, dtype=torch.int32, device=dev)
    pz0 = torch.full((C,), V, dtype=torch.int32, device=dev)
    px0[:E] = torch.from_numpy(el.src).to(dev)
    pz0[:E] = torch.from_numpy(el.dst).to(dev)

    def rounds(state, seg):
        px, pz, old, cnt, it, ov = state
        old, cnt, it, ov = int(old), int(cnt), int(it), bool(ov)
        it_hi = min(it + seg, cap)
        while cnt != old and it < it_hi and not ov:
            x = px[:cnt].to(torch.int64)
            y = pz[:cnt].to(torch.int64)
            k = deg[y]
            K = int(k.sum())                       # the true join size
            it += 1
            if K > J:
                ov = True                          # fail fast, as JAX
                break
            # path p owns candidate slots [start_p, start_p + k_p)
            pid = torch.repeat_interleave(
                torch.arange(cnt, device=dev), k, output_size=K)
            rank = torch.arange(K, device=dev) - (torch.cumsum(k, 0)
                                                  - k)[pid]
            cz = dst[off[y[pid]] + rank]
            keys = torch.cat([x * (V + 1) + y, x[pid] * (V + 1) + cz])
            uniq = torch.unique(keys, sorted=True)  # union, distinct
            new_cnt = uniq.numel()
            old, cnt = cnt, min(new_cnt, C)
            if new_cnt > C:
                ov = True
                break
            px = torch.full_like(px, V)
            pz = torch.full_like(pz, V)
            px[:cnt] = torch.div(uniq, V + 1, rounding_mode="floor").to(
                torch.int32)
            pz[:cnt] = (uniq % (V + 1)).to(torch.int32)
        return px, pz, _scalar(old), _scalar(cnt), _scalar(it), \
            torch.tensor(ov)

    state0 = (px0, pz0, _scalar(-1), _scalar(E), _scalar(0),
              torch.tensor(False))
    if checkpoint_dir is None:
        px, pz, _, cnt, it, ov = rounds(state0, cap)
    else:
        px, pz, _, cnt, it, ov = _segmented(
            checkpoint_dir, checkpoint_every, cap, rounds, state0,
            "closure_sparse",
            lambda s: bool(s[5]) or int(s[3]) == int(s[2]), cnt_at=3)
    if bool(ov):
        raise ValueError(
            f"closure overflowed its buffers (capacity {C}, "
            f"join_capacity {J}); rerun with a larger "
            f"SparseClosureConfig.capacity/join_capacity")
    n_paths = int(cnt)
    pairs = torch.stack([px[:n_paths], pz[:n_paths]], dim=1)
    return SparseClosureResult(paths=pairs.cpu().numpy(), n_paths=n_paths,
                               n_rounds=int(it))


#: per-path buffer cost of one :func:`run_sparse` round in the JAX
#: package: px/pz and the two-key sort's union copy at C + J slots (J
#: defaults to 2C), ~8 B a slot across ~4C live slots. The auto-sizer
#: budgets against this figure, as the JAX package's does.
SPARSE_BYTES_PER_CAPACITY_SLOT = 32


def run_sparse_auto(edges: np.ndarray, mesh: Mesh, *,
                    n_vertices: int | None = None,
                    start_capacity: int | None = None,
                    budget_bytes: int = 4 << 30,
                    max_iterations: int | None = None,
                    checkpoint_dir: str | None = None,
                    checkpoint_every: int = 8) -> SparseClosureResult:
    """:func:`run_sparse` with capacity auto-sizing: start at
    ``start_capacity`` (default max(8×edges, 1024)), at least the edge
    count, and double on overflow, re-running the fixpoint from the
    start; each regrow emits ``closure_capacity_grow`` and the
    ``closure.capacity_regrows`` counter. A capacity whose working set
    (capacity × :data:`SPARSE_BYTES_PER_CAPACITY_SLOT`) exceeds
    ``budget_bytes`` raises ValueError. With ``checkpoint_dir`` each
    attempt owns the directory: an overflowed attempt's checkpoints
    hold buffers of the old capacity, so they are all pruned before the
    regrown retry (the resume's signature check would refuse them)."""
    from tpu_distalg_torch.telemetry import events as tevents

    E = int(np.asarray(edges).shape[0]) if len(edges) else 0
    cap = (int(start_capacity) if start_capacity is not None
           else max(8 * E, 1024))
    cap = max(cap, E)
    while True:
        if cap * SPARSE_BYTES_PER_CAPACITY_SLOT > budget_bytes:
            raise ValueError(
                f"sparse closure refused: capacity {cap} needs "
                f"~{cap * SPARSE_BYTES_PER_CAPACITY_SLOT / 1e9:.1f} GB "
                f"working set, over the {budget_bytes / 1e9:.1f} GB "
                f"budget — the closure is larger than the budget "
                f"allows; raise budget_bytes, or use the dense path "
                f"(run) if V×V bits fit")
        try:
            return run_sparse(
                edges, mesh,
                SparseClosureConfig(capacity=cap,
                                    max_iterations=max_iterations),
                n_vertices,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every)
        except ValueError as e:
            if "overflowed its buffers" not in str(e):
                raise
            if checkpoint_dir is not None:
                from tpu_distalg_torch.utils import checkpoint as ckpt

                ckpt.prune(checkpoint_dir, keep=0)
            tevents.emit("closure_capacity_grow", capacity=cap,
                         next_capacity=cap * 2)
            tevents.counter("closure.capacity_regrows")
            cap *= 2
