"""Parameter-server tier — the center, sharded by partition rule tables.

Port of ``tpu_distalg/cluster/ps.py``: the same numpy arithmetic in the
same order, so splits, joins and merges are bitwise the JAX package's.
``mode="rowstore"`` keeps the center in the sharded row store
(:mod:`.rowstore`) and merges row-wise.

The coordinator process holds the replicated-center state the SGD
family trains (``w`` for the LR/SSGD vocabulary) split across
``n_shards`` PS shards, each with its own lock so concurrent merges on
disjoint shards never serialize. WHICH leaves split and which stay
whole is not re-decided here: the model's registered
:mod:`~tpu_distalg_torch.parallel.partition` rule table is consulted — a
leaf whose spec shards its leading dim splits row-wise across the PS
shards (``np.array_split``: UNEVEN splits are first-class, which is
what a worker count that does not divide the model axis produces —
the device-side mirror of this is ``partition.reshard``'s
pad-reshard-slice path), a replicated-spec leaf lives whole on shard
0. So the PS placement is the same one-rule-table-per-model contract
the in-process trainers follow.

The merge is the stale-synchronous weighted delta application of
``parallel/ssp.py``, over the wire instead of a collective: each
contribution carries its base version, its weight is ``decay**age``
(``age = commit_window − base``, exactly ``ssp.staleness_weights``'
exponent), and the center moves by the weighted MEAN of the delivered
deltas — ``w += Σ wᵢ·Δᵢ / Σ wᵢ``, the same formula
``ssgd.make_ssp_train_fn``'s window body applies on device. A commit
nobody delivered to is a hard no-op (no epsilon divides).

numpy-only: the PS applies host math; device placement is the
workers' business.
"""

from __future__ import annotations

import threading

import numpy as np

from tpu_distalg_torch.parallel import partition
from tpu_distalg_torch.parallel.ssp import DEFAULT_DECAY
from tpu_distalg_torch.tune import defaults as tune_defaults

PS_MODES = ("replicated", "rowstore")

#: suffix of a delta's per-leaf row-index array (rowstore mode): a push
#: carrying ``{name}.rows`` moves ONLY those leading-dim rows of leaf
#: ``name``; without it the delta is whole-leaf (rows 0..n)
ROWS_SUFFIX = ".rows"


def split_center(center: dict, table_name: str,
                 n_shards: int) -> list[dict]:
    """Per-PS-shard sub-dicts of ``center`` under the model's rule
    table: sharded-spec leaves row-split (uneven OK), replicated-spec
    leaves whole on shard 0. The union of the shards is exactly the
    center (reassembled by :func:`join_center`). The slicing itself
    lives in :class:`partition.RowOwnershipMap` (``np.array_split``
    arithmetic, table-driven)."""
    return partition.RowOwnershipMap.for_center(
        center, table_name, n_shards).split(center)


def join_center(shards: list[dict]) -> dict:
    """Inverse of :func:`split_center` (concatenate the split leaves in
    shard order; whole leaves pass through)."""
    out: dict = {}
    names: list[str] = []
    for sh in shards:
        for name in sh:
            if name not in names:
                names.append(name)
    for name in names:
        pieces = [sh[name] for sh in shards if name in sh]
        out[name] = (pieces[0].copy() if len(pieces) == 1
                     else np.concatenate(pieces, axis=0))
    return out


class PsShard:
    """One PS shard: its slice of every split leaf, one lock."""

    def __init__(self, leaves: dict):
        self.lock = threading.Lock()
        self.leaves = {k: np.asarray(v, np.float32)
                       if np.asarray(v).dtype.kind == "f"
                       else np.asarray(v).copy()
                       for k, v in leaves.items()}

    def apply_weighted(self, contribs: list[tuple[float, dict]]) -> None:
        """``leaf += Σ wᵢ·Δᵢ / Σ wᵢ`` for this shard's slice of every
        delta — the ssp window merge, host-side. Empty ⇒ hard no-op."""
        if not contribs:
            return
        wsum = float(sum(w for w, _ in contribs))
        if wsum <= 0.0:
            return
        with self.lock:
            for name in self.leaves:
                acc = None
                for w, delta in contribs:
                    if name not in delta:
                        continue
                    term = np.float32(w) * np.asarray(delta[name],
                                                      np.float32)
                    acc = term if acc is None else acc + term
                if acc is not None:
                    self.leaves[name] = (
                        self.leaves[name] + acc / np.float32(wsum))


class ParameterServer:
    """The tier: ``n_shards`` :class:`PsShard`\\ s over one model's
    center, plus the version counter (= windows merged so far — the
    number a contribution's age is measured against).

    ``history_depth > 0`` keeps a bounded ``{version: center}`` ring
    of post-merge snapshots — the compressed cluster wire's
    VERSION-DELTA pull source: a worker caching center@v is served
    ``quantize(center@new − center@v)`` instead of a dense snapshot,
    and because the ring rebuilds deterministically from WAL replay
    (each replayed commit re-records its snapshot), a recovered
    coordinator re-serves bit-identical pull bytes. Dense mode keeps
    the depth at 0: zero overhead, trajectories pinned to history."""

    def __init__(self, center: dict, *, table: str = "lr",
                 n_shards: int = tune_defaults.PS_SHARDS,
                 decay: float = DEFAULT_DECAY,
                 history_depth: int = 0, mode: str = "replicated",
                 row_staleness: int | None = None):
        if mode not in PS_MODES:
            raise ValueError(
                f"unknown ps mode {mode!r}; choose from {PS_MODES}")
        self.table = table
        self.decay = float(decay)
        self.n_shards = int(n_shards)
        self.mode = mode
        if mode == "rowstore":
            from tpu_distalg_torch.cluster import rowstore as _rowstore

            self.store = _rowstore.RowStore(
                center, table=table, n_shards=self.n_shards,
                decay=self.decay, staleness=row_staleness)
            self.shards = []
        else:
            self.store = None
            self.shards = [PsShard(s) for s in
                           split_center(center, table, self.n_shards)]
        self._version_lock = threading.Lock()
        self.version = 0  # windows merged into the center
        self.history_depth = int(history_depth)
        self.history: dict[int, dict] = {}

    @staticmethod
    def weight(decay: float, age: int) -> float:
        """``decay**age`` — ssp.staleness_weights' exponent, scalar."""
        return float(np.float32(decay) ** np.float32(max(0, age)))

    def merge(self, commit_window: int,
              contribs: list[tuple[int, int, dict]]) -> list[dict]:
        """Apply one commit: ``contribs`` is ``[(slot, base, delta)]``
        in SLOT order (the caller — the coordinator's commit loop —
        owns the ordering, which is what makes the merge sequence a
        pure function of the plan). Returns the per-contribution
        records ``[{slot, base, age, weight}]``; bumps ``version``."""
        if self.mode == "rowstore":
            return self._merge_rows(commit_window, contribs)
        records = []
        weighted: list[tuple[float, list[dict]]] = []
        for slot, base, delta in contribs:
            # base = the center version (windows merged) the delta was
            # computed against; a fresh delivery at window w has
            # base == w (it adopted the post-commit-(w−1) center), so
            # age = w − base = 0 — in-process ssp's winid − basegen
            age = max(0, commit_window - int(base))
            w = self.weight(self.decay, age)
            records.append({"slot": int(slot), "base": int(base),
                            "age": int(age), "weight": round(w, 6)})
            # each delta splits under the SAME rule table as the
            # center, so shard i applies exactly its slice
            weighted.append(
                (w, split_center(delta, self.table, self.n_shards)))
        for i, shard in enumerate(self.shards):
            shard.apply_weighted(
                [(w, pieces[i]) for w, pieces in weighted])
        with self._version_lock:
            self.version = max(self.version, commit_window + 1)
        self.record_history(commit_window + 1)
        return records

    def _merge_rows(self, commit_window: int,
                    contribs: list[tuple[int, int, dict]]) -> list[dict]:
        """Rowstore-mode commit: each delta's ``{name}.rows`` array
        selects the leading-dim rows it moves (absent: the whole leaf),
        the contribution's scalar ``base`` becomes every row's base
        version, and the weighted mean applies ROW-WISE in the
        :class:`~tpu_distalg_torch.cluster.rowstore.RowStore` — a
        whole-leaf push at a uniform base merges bit-identically to the
        replicated path."""
        records = []
        row_contribs = []
        for slot, base, delta in contribs:
            age = max(0, commit_window - int(base))
            records.append({"slot": int(slot), "base": int(base),
                            "age": int(age),
                            "weight": round(
                                self.weight(self.decay, age), 6)})
            leaf_deltas = {}
            for name, vals in delta.items():
                if name.endswith(ROWS_SUFFIX):
                    continue
                vals = np.asarray(vals, np.float32)
                rows = delta.get(f"{name}{ROWS_SUFFIX}")
                if rows is None:
                    rows = np.arange(
                        vals.shape[0] if vals.ndim else 1,
                        dtype=np.int64)
                    vals = vals.reshape((rows.shape[0],)
                                        + vals.shape[1:])
                leaf_deltas[name] = (np.asarray(rows, np.int64),
                                     vals, int(base))
            row_contribs.append((int(slot), leaf_deltas))
        self.store.merge_rows(commit_window, row_contribs)
        with self._version_lock:
            self.version = max(self.version, commit_window + 1)
        self.record_history(commit_window + 1)
        return records

    # --------------------------------------------- version history

    def record_history(self, version: int) -> None:
        """Snapshot the center as ``center@version`` into the bounded
        ring (no-op at depth 0); pruned oldest-first."""
        if self.history_depth <= 0:
            return
        self.history[int(version)] = self.snapshot()
        while len(self.history) > self.history_depth:
            del self.history[min(self.history)]

    def delta_since(self, have: int, version: int) -> dict | None:
        """``{name: center@version − center@have}`` leafwise, or
        ``None`` when either endpoint fell out of the ring (the
        caller falls back to a dense snapshot — the resume/rejoin
        path)."""
        a = self.history.get(int(have))
        b = self.history.get(int(version))
        if a is None or b is None:
            return None
        return {name: (np.asarray(b[name], np.float32)
                       - np.asarray(a[name], np.float32))
                for name in b}

    def snapshot(self) -> dict:
        """The assembled center (copies, consistent per shard)."""
        if self.mode == "rowstore":
            return self.store.snapshot()
        parts = []
        for shard in self.shards:
            with shard.lock:
                parts.append({k: v.copy()
                              for k, v in shard.leaves.items()})
        return join_center(parts)
