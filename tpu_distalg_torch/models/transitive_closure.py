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

Across processes (a mesh whose data axis spans ``torch.distributed``
processes) the dense path matrix's rows are split over the data shards:
a process composes its own rows with the whole edge operand (row x of
paths∘edges needs only row x of paths; the round's set is the same as
edges∘paths', the paths of length ≤ t+2) and the round's count is a
psum. The sparse buffer is split the same way, each process holding its
shards' slice of the C slots, a range of x: it joins its own paths,
whose candidates keep their x, so the processes' candidates meet only
at a slice's first x, whose keys go to the first process holding it;
each process takes the sorted distinct set of the x it owns, and the
owned sets, in process order, are cut back into the slices (both
exchanges point to point, only the keys that change hands). Counts, join sizes and
overflows are global, so every process runs the same rounds, overflows
together and regrows together; the sets are exact, so P processes equal
one process bit for bit.

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
from tpu_distalg_torch.parallel import Mesh, collectives


@dataclasses.dataclass(frozen=True)
class ClosureConfig:
    max_iterations: int | None = None  # None → V + 1 (always enough)


@dataclasses.dataclass
class ClosureResult:
    paths: torch.Tensor  # (V_pad, V_pad) bool reachability (this
    #                      process's rows across processes)
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
    paths: np.ndarray  # (n_paths, 2) distinct (x, z) pairs, sorted (this
    #                    process's slice of them across processes)
    n_paths: int
    n_rounds: int


def _scalar(v: int) -> torch.Tensor:
    """A host int64 counter of the fixpoint state."""
    return torch.tensor(int(v), dtype=torch.int64)


def _global_sum(v: int, mesh: Mesh) -> int:
    """An integer summed over the processes (itself in one)."""
    return sum(collectives.row_counts(int(v), mesh))


def _exchange_ints(values, mesh) -> list[list[int]]:
    """Every process's few ints, in process order (one small
    all-gather; ``[values]`` in one process)."""
    t = torch.as_tensor([[int(v) for v in values]], dtype=torch.int64,
                        device=mesh.device)
    return collectives.allgather_rows(t, mesh).cpu().tolist()


def _union_owned(keys: torch.Tensor, x0: int, views: list, V: int,
                 mesh: Mesh) -> torch.Tensor:
    """The sorted distinct keys whose x this process owns. A slice of
    the sorted buffer holds a range of x, and the candidates of its
    paths keep their x, so the processes' candidates overlap only at a
    slice's first x, which the first process holding that x owns: the
    others send it their keys of that x. Concatenated in process order,
    the owned sets are the sorted distinct union."""
    me = mesh.process_index
    has = [bool(v[1]) for v in views]

    def owner(x):
        return next(p for p, v in enumerate(views)
                    if has[p] and v[2] <= x <= v[3])

    sends, recvs = {}, {}
    for p, v in enumerate(views):
        if has[p] and owner(v[2]) != p:
            if p == me:
                at0 = torch.div(keys, V + 1, rounding_mode="floor") == x0
                sends[owner(x0)] = keys[at0].view(torch.uint8)
                keys = keys[~at0]
            elif owner(v[2]) == me:
                recvs[p] = v[4] * 8
    got = collectives.send_recv(sends, recvs, keys.device)
    if got:
        keys = torch.cat([keys] + [got[p].view(torch.int64)
                                   for p in sorted(got)])
    return torch.unique(keys, sorted=True)


def _to_slots(uniq: torch.Tensor, counts: list, Cl: int,
              mesh: Mesh) -> torch.Tensor:
    """The keys of this process's buffer slots ``[me·Cl, (me+1)·Cl)``,
    from every process's owned keys (``counts`` of them, which cover the
    global ranks in process order): each process sends every other the
    part of its owned keys that falls in that one's slots."""
    me = mesh.process_index
    offs = np.concatenate([[0], np.cumsum(counts)])

    def part(p, q):
        """Process p's owned keys in process q's slots: (start, end)
        within p's list."""
        a = max(offs[p], q * Cl)
        b = min(offs[p + 1], (q + 1) * Cl)
        return (int(a - offs[p]), int(b - offs[p])) if b > a else None

    sends, recvs, pieces = {}, {}, {}
    for q in range(mesh.process_count):
        mine = part(me, q)
        if mine is not None:
            if q == me:
                pieces[me] = uniq[mine[0]:mine[1]]
            else:
                sends[q] = uniq[mine[0]:mine[1]].contiguous().view(
                    torch.uint8)
        theirs = part(q, me)
        if q != me and theirs is not None:
            recvs[q] = (theirs[1] - theirs[0]) * 8
    for p, buf in collectives.send_recv(sends, recvs,
                                        uniq.device).items():
        pieces[p] = buf.view(torch.int64)
    if not pieces:
        return uniq[:0]
    return torch.cat([pieces[p] for p in sorted(pieces)])


def _segmented(checkpoint_dir, checkpoint_every, cap, rounds, state0, tag,
               stop_when, cnt_at: int, mesh: Mesh, sharded: tuple):
    """Run ``rounds(state, seg)`` (up to ``seg`` more rounds, bounded by
    ``cap``) through :func:`..utils.checkpoint.run_segmented`; a
    segment's history entry is the count (``state[cnt_at]``) as
    float32. ``sharded`` marks the leaves a process holds its rows
    of."""
    from tpu_distalg_torch.utils import checkpoint as ckpt

    def run_seg(seg, state, t0):
        del t0  # the fixpoint carries its own round counter
        state = rounds(state, seg)
        return state, np.asarray([float(state[cnt_at])], np.float32)

    state, _, _ = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, cap, lambda seg: seg, run_seg,
        state0, tag=tag, stop_when=stop_when, mesh=mesh, sharded=sharded)
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
    dev = mesh.device
    src = torch.from_numpy(el.src.astype(np.int64)).to(dev)
    dst = torch.from_numpy(el.dst.astype(np.int64)).to(dev)
    adj = torch.zeros((V, V), dtype=torch.bool, device=dev)
    adj[src, dst] = True
    edges_op = gops.closure_operand(adj)
    # this process's rows of the path matrix (all of them in one)
    rows = V // mesh.process_count
    lo = mesh.process_index * rows
    paths0 = adj[lo:lo + rows].clone()
    del adj

    def rounds(state, seg):
        paths, old, cnt, it = state
        old, cnt, it = int(old), int(cnt), int(it)
        it_hi = min(it + seg, cap)
        while cnt != old and it < it_hi:
            paths = gops.closure_step(paths, edges_op)
            old, cnt, it = cnt, _global_sum(gops.path_count(paths), mesh), \
                it + 1
        return paths, _scalar(old), _scalar(cnt), _scalar(it)

    state0 = (paths0, _scalar(-1),
              _scalar(_global_sum(gops.path_count(paths0), mesh)),
              _scalar(0))
    if checkpoint_dir is None:
        paths, _, cnt, it = rounds(state0, cap)
    else:
        paths, _, cnt, it = _segmented(
            checkpoint_dir, checkpoint_every, cap, rounds, state0,
            "closure_dense", lambda s: int(s[2]) == int(s[1]), cnt_at=2,
            mesh=mesh, sharded=(True,))
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
    # this process's slots of the buffer (all C in one process)
    Cl = C // mesh.process_count
    lo = mesh.process_index * Cl
    # CSR over src (prepare_edges sorts by src); the sentinel vertex V
    # has degree 0, so padding entries join nothing
    offsets = np.zeros(V + 2, dtype=np.int64)
    offsets[1:V + 1] = np.cumsum(np.bincount(el.src, minlength=V))
    offsets[V + 1] = offsets[V]
    deg = torch.from_numpy(np.diff(offsets)).to(dev)          # (V+1,)
    off = torch.from_numpy(offsets[:V + 1]).to(dev)
    dst = torch.from_numpy(el.dst.astype(np.int64)).to(dev)   # src-sorted

    def fill(px, pz, xs, zs, cnt):
        """Slots ``[lo, lo + Cl)`` of the buffer whose first ``cnt``
        pairs are ``(xs, zs)`` (global arrays)."""
        n = max(0, min(cnt - lo, Cl))
        px[:n] = xs[lo:lo + n]
        pz[:n] = zs[lo:lo + n]
        return px, pz

    px0, pz0 = fill(
        torch.full((Cl,), V, dtype=torch.int32, device=dev),
        torch.full((Cl,), V, dtype=torch.int32, device=dev),
        torch.from_numpy(el.src).to(dev), torch.from_numpy(el.dst).to(dev),
        E)

    def rounds(state, seg):
        px, pz, old, cnt, it, ov = state
        old, cnt, it, ov = int(old), int(cnt), int(it), bool(ov)
        it_hi = min(it + seg, cap)
        while cnt != old and it < it_hi and not ov:
            n_mine = max(0, min(cnt - lo, Cl))
            x = px[:n_mine].to(torch.int64)
            y = pz[:n_mine].to(torch.int64)
            k = deg[y]
            K_mine = int(k.sum())
            # the boundary: paths at this slice's first x, which an
            # earlier process may hold too, and their candidates
            x0 = int(x[0]) if n_mine else -1
            at0 = x == x0
            n_b = int(at0.sum()) + int(k[at0].sum())
            views = _exchange_ints(
                [K_mine, n_mine > 0, x0, int(x[-1]) if n_mine else -1, n_b],
                mesh)
            K = sum(v[0] for v in views)           # the true join size
            it += 1
            if K > J:
                ov = True                          # fail fast, as JAX
                break
            # path p owns candidate slots [start_p, start_p + k_p)
            pid = torch.repeat_interleave(
                torch.arange(n_mine, device=dev), k, output_size=K_mine)
            rank = torch.arange(K_mine, device=dev) - (torch.cumsum(k, 0)
                                                       - k)[pid]
            cz = dst[off[y[pid]] + rank]
            keys = torch.cat([x * (V + 1) + y, x[pid] * (V + 1) + cz])
            uniq = _union_owned(keys, x0, views, V, mesh)
            counts = [int(c) for c in collectives.row_counts(
                uniq.numel(), mesh)]
            new_cnt = sum(counts)                  # union, distinct
            old, cnt = cnt, min(new_cnt, C)
            if new_cnt > C:
                ov = True
                break
            mine = _to_slots(uniq, counts, Cl, mesh)
            px = torch.full_like(px, V)
            pz = torch.full_like(pz, V)
            px[:mine.numel()] = torch.div(mine, V + 1,
                                          rounding_mode="floor").to(
                torch.int32)
            pz[:mine.numel()] = (mine % (V + 1)).to(torch.int32)
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
            lambda s: bool(s[5]) or int(s[3]) == int(s[2]), cnt_at=3,
            mesh=mesh, sharded=(True, True))
    if bool(ov):
        raise ValueError(
            f"closure overflowed its buffers (capacity {C}, "
            f"join_capacity {J}); rerun with a larger "
            f"SparseClosureConfig.capacity/join_capacity")
    n_paths = int(cnt)
    n_mine = max(0, min(n_paths - lo, Cl))
    pairs = torch.stack([px[:n_mine], pz[:n_mine]], dim=1)
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
