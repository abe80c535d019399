"""The sharded row store — row-partitioned cluster state (port of
``tpu_distalg/cluster/rowstore.py``).

The replicated PS tier (:mod:`.ps`) holds the whole center and moves it
whole. Here the PS tier owns DISJOINT ROW RANGES of each leaf under the
partition rule table's :class:`~tpu_distalg_torch.parallel.partition.
RowOwnershipMap`; workers pull only the rows their window touches and
push sparse per-row deltas, and staleness is PER ROW: every stored row
carries the version (windows merged) of its last update, a pull returns
``(values, versions)``, and a push's per-row base versions drive row-wise
``decay**age`` weights and the row-wise SSP gate. The store is host
numpy, as the JAX package's is: it is host cluster state, and its merges
are the JAX package's arithmetic in the JAX package's order, so a store
fed the same pushes holds the same bytes.

Wire format: a sparse row push or pull is the ordinary framed transport
payload (``transport.encode_frame``, the JAX package's bytes) with, per
leaf, a ``{name}.rows`` int64 row-index array, an optional
``{name}.vbase`` int64 per-row base-version array, and the values as raw
f32 (``dense``) or the ``--comm int8/topk`` host-codec parts
(``pcomms.encode_tree`` under an explicit seed path, without error
feedback, so a respawned worker re-encodes the same bytes). Pulls ship
raw f32 rows. The WAL logs the pushed wire arrays per commit (a per-row
redo record): replay re-runs the same decode.

On top of the store, :func:`run_cluster_pagerank` runs PageRank over a
fleet: the dst-sorted edge blocks of a ``graphs/ingest.py`` cache are
partitioned across workers (one a cache shard), each worker pulls only
the ranks of the distinct source vertices its edges reference, computes
its window's contributions on ``device`` (``cuda`` unless told ``cpu``)
through B7 (``ops/pagerank_kernels.spmv_table``, one launch an edge
block in block order, the association of the port's graph engine), and
pushes ``(didx + lo, acc · dmask)`` sparse pairs, applied at the PS in
slot order. Chaos points: ``cluster:worker`` kills recompute the
iteration, ``cluster:coordinator`` kills at the commit point roll the
in-flight iteration back, ``cluster:ps`` kills at the shard merge seam
exercise the REDO path, and ``cluster:rpc`` oserrors retry the frame;
all recover to the bitwise final ranks of the undisturbed run.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from tpu_distalg_torch.cluster import transport
from tpu_distalg_torch.cluster import wal as walmod
from tpu_distalg_torch.faults import registry as fregistry
from tpu_distalg_torch.parallel import comms as pcomms
from tpu_distalg_torch.parallel import partition
from tpu_distalg_torch.parallel.ssp import DEFAULT_DECAY
from tpu_distalg_torch.telemetry import events as tevents
from tpu_distalg_torch.tune import defaults as tune_defaults

#: schedule cell code for a kill (hang cells hold seconds)
KILL_CELL = -1.0

#: seed-path tag for the fleet's stateless push encode (disjoint from
#: comms.PUSH_SEED_TAG/PULL_SEED_TAG so a rowstore push can never
#: collide with an SSP push's stochastic-rounding stream)
ROW_SEED_TAG = 7

#: suffix of the per-leaf row-index wire array
ROWS_SUFFIX = ".rows"
#: suffix of the per-leaf per-row base-version wire array
VBASE_SUFFIX = ".vbase"


class RowStalenessError(RuntimeError):
    """A pushed row's base version is older than the staleness bound
    allows — the row-wise SSP gate refused the contribution."""


def strip_row_arrays(arrays: dict) -> tuple[dict, dict, dict]:
    """Split a pushed wire dict into ``(value_arrays, rows, vbase)``
    where ``rows``/``vbase`` map leaf name -> int64 array. The value
    arrays are exactly what the host codec (or the dense path)
    decodes; the row metadata never enters the codec."""
    vals, rows, vbase = {}, {}, {}
    for k, v in arrays.items():
        if k.endswith(ROWS_SUFFIX):
            rows[k[:-len(ROWS_SUFFIX)]] = np.asarray(v, np.int64)
        elif k.endswith(VBASE_SUFFIX):
            vbase[k[:-len(VBASE_SUFFIX)]] = np.asarray(v, np.int64)
        else:
            vals[k] = v
    return vals, rows, vbase


class _RowShard:
    """One PS shard of the row store: its row ranges of every sharded
    leaf (whole replicated leaves live on shard 0), a same-leading-dim
    int64 version array per leaf, one lock."""

    def __init__(self, leaves: dict):
        self.lock = threading.Lock()
        self.leaves = {k: np.asarray(v, np.float32)
                       if np.asarray(v).dtype.kind == "f"
                       else np.asarray(v).copy()
                       for k, v in leaves.items()}
        self.versions = {
            k: np.zeros((v.shape[0] if v.ndim else 1,), np.int64)
            for k, v in self.leaves.items()}


class RowStore:
    """Row-partitioned cluster state: ``n_shards`` :class:`_RowShard`\\ s
    under one :class:`~tpu_distalg_torch.parallel.partition.RowOwnershipMap`,
    per-row versions, sparse pull and row-wise weighted merge.

    ``staleness`` (optional) arms the row-wise SSP gate: a merge whose
    per-row age exceeds it raises :class:`RowStalenessError` instead of
    silently down-weighting a contribution the protocol should never
    have admitted."""

    def __init__(self, center: dict, *, table: str = "lr",
                 n_shards: int = tune_defaults.PS_SHARDS,
                 decay: float = DEFAULT_DECAY,
                 staleness: int | None = None):
        self.map = partition.RowOwnershipMap.for_center(
            center, table, n_shards)
        self.n_shards = self.map.n_shards
        self.decay = float(decay)
        self.staleness = staleness
        self.shards = [_RowShard(piece)
                       for piece in self.map.split(center)]
        self.version = 0

    # ------------------------------------------------------ pulling

    def pull_rows(self, name: str, rows) -> tuple[np.ndarray,
                                                  np.ndarray]:
        """``(values, versions)`` for ``rows`` of leaf ``name``, in
        the caller's row order — the sparse pull. Counters account
        the rows actually shipped vs the dense-replication
        equivalent (the whole leading dim)."""
        own = self.map[name]
        rows = np.asarray(rows, np.int64)
        owners = own.owner_of(rows)
        probe_shard = 0 if own.sharded else own.owner
        first = self.shards[probe_shard].leaves[name]
        out = np.empty((rows.shape[0],) + first.shape[1:],
                       first.dtype)
        vers = np.empty((rows.shape[0],), np.int64)
        for i in range(self.n_shards):
            sel = owners == i
            if not np.any(sel):
                continue
            lo, _hi = own.range_of(i)
            sh = self.shards[i]
            with sh.lock:
                local = rows[sel] - lo
                out[sel] = sh.leaves[name][local]
                vers[sel] = sh.versions[name][local]
        n_dim = int(own.shape[0]) if len(own.shape) else 1
        tevents.counter("rowstore.rows_pulled", int(rows.shape[0]))
        tevents.counter("rowstore.pull_rows_dense", n_dim)
        return out, vers

    # ------------------------------------------------------ merging

    def _ages(self, commit_window: int, rows: np.ndarray,
              vbase: np.ndarray) -> np.ndarray:
        ages = np.maximum(
            0, np.int64(commit_window) - np.asarray(vbase, np.int64))
        if self.staleness is not None and ages.size \
                and int(ages.max()) > int(self.staleness):
            worst = rows[int(np.argmax(ages))]
            raise RowStalenessError(
                f"row {int(worst)} pushed with age {int(ages.max())} "
                f"> staleness bound {self.staleness} — the row-wise "
                f"SSP gate refuses it")
        return ages

    def merge_rows(self, commit_window: int,
                   contribs: list) -> list[dict]:
        """One commit of sparse per-row deltas, in SLOT order:
        ``contribs`` is ``[(slot, {name: (rows, vals, vbase)})]``
        where ``rows`` is int64 row indices, ``vals`` the per-row
        delta block and ``vbase`` per-row base versions (int64 array,
        or a scalar applied row-wise). Per row: ``leaf[r] += Σ wᵢ(r)·
        Δᵢ[r] / Σ wᵢ(r)`` over the contributions touching ``r``, with
        ``wᵢ(r) = decay**(commit_window − vbase)`` — exactly the
        replicated :class:`~tpu_distalg_torch.cluster.ps.PsShard` arithmetic
        (f32 term accumulation in contribution order, one python-float
        weight sum, one f32 divide) restricted row-wise, so a push
        touching EVERY row at a uniform base merges bit-identically to
        the dense replicated path. Rows nobody touched do not move and
        keep their version. Returns per-contribution records
        ``[{slot, age, weight, rows}]`` (age/weight of the oldest
        row); bumps ``version``."""
        records = []
        staged: list[tuple[int, dict]] = []
        for slot, leaf_deltas in contribs:
            prepared: dict = {}
            age_max = 0
            w_min = 1.0
            for name, (rows, vals, vbase) in leaf_deltas.items():
                rows = np.asarray(rows, np.int64)
                vbase = (np.full(rows.shape, int(vbase), np.int64)
                         if np.ndim(vbase) == 0
                         else np.asarray(vbase, np.int64))
                ages = self._ages(commit_window, rows, vbase)
                w = (np.float32(self.decay)
                     ** ages.astype(np.float32))
                if ages.size:
                    age_max = max(age_max, int(ages.max()))
                    w_min = min(w_min, float(w.min()))
                prepared[name] = (rows,
                                  np.asarray(vals, np.float32), w)
            staged.append((int(slot), prepared))
            records.append({"slot": int(slot), "age": age_max,
                            "weight": round(w_min, 6),
                            "rows": int(sum(
                                r.shape[0] for r, _v, _w
                                in prepared.values()))})
        if any(r["rows"] for r in records):
            tevents.gauge("rowstore.max_row_staleness",
                          max(r["age"] for r in records))
        for i, sh in enumerate(self.shards):
            with sh.lock:
                for name, own in self.map.leaves.items():
                    lo, hi = own.range_of(i)
                    if hi <= lo:
                        continue
                    leaf = sh.leaves[name]
                    acc = np.zeros_like(leaf, dtype=np.float32)
                    wsum = np.zeros((leaf.shape[0],), np.float64)
                    touched = np.zeros((leaf.shape[0],), bool)
                    for _slot, prepared in staged:
                        if name not in prepared:
                            continue
                        rows, vals, w = prepared[name]
                        sel = (rows >= lo) & (rows < hi)
                        if not np.any(sel):
                            continue
                        local = rows[sel] - lo
                        wl = w[sel]
                        term = (wl.reshape(
                            (-1,) + (1,) * (vals.ndim - 1))
                            * vals[sel])
                        acc[local] = acc[local] + term
                        wsum[local] += wl.astype(np.float64)
                        touched[local] = True
                    apply = touched & (wsum > 0.0)
                    if np.any(apply):
                        div = wsum[apply].astype(np.float32).reshape(
                            (-1,) + (1,) * (leaf.ndim - 1))
                        leaf[apply] = leaf[apply] + acc[apply] / div
                        sh.versions[name][apply] = commit_window + 1
        self.version = max(self.version, commit_window + 1)
        return records

    def replace_rows(self, commit_window: int, name: str,
                     rows, vals) -> None:
        """Absolute row update (the PageRank rank replacement): set
        ``leaf[rows] = vals`` and bump those rows' versions — no
        weighting, the caller owns the combine."""
        own = self.map[name]
        rows = np.asarray(rows, np.int64)
        vals = np.asarray(vals)
        for i in range(self.n_shards):
            lo, hi = own.range_of(i)
            if hi <= lo:
                continue
            sel = (rows >= lo) & (rows < hi)
            if not np.any(sel):
                continue
            sh = self.shards[i]
            with sh.lock:
                local = rows[sel] - lo
                sh.leaves[name][local] = vals[sel]
                sh.versions[name][local] = commit_window + 1
        self.version = max(self.version, commit_window + 1)

    # ----------------------------------------------------- snapshots

    def snapshot(self) -> dict:
        """The assembled center (copies, consistent per shard)."""
        parts = []
        for sh in self.shards:
            with sh.lock:
                parts.append({k: v.copy()
                              for k, v in sh.leaves.items()})
        return self.map.join(parts)

    def row_versions(self, name: str) -> np.ndarray:
        """The full per-row version vector of leaf ``name`` (shard
        slices concatenated in ownership order)."""
        own = self.map[name]
        if not own.sharded:
            sh = self.shards[own.owner]
            with sh.lock:
                return sh.versions[name].copy()
        parts = []
        for i in range(self.n_shards):
            sh = self.shards[i]
            with sh.lock:
                parts.append(sh.versions[name].copy())
        return np.concatenate(parts)


# --------------------------------------------------------- wire frames


def frame_roundtrip(kind: str, meta: dict, arrays: dict,
                    *, counter: str) -> tuple[dict, dict]:
    """Encode one row-store frame, account its REAL wire bytes, pass
    it through the ``cluster:rpc`` seam, and parse it back — the
    in-process fleet's stand-in for a socket send/recv that keeps the
    byte accounting and the dtype-safety checks (TDA051's no-widening
    contract) honest. Returns ``(meta, arrays)`` as the receiver sees
    them. An injected transient rpc fault retries the identical
    bytes."""
    buf = transport.encode_frame(kind, meta, arrays)
    tevents.counter(counter, len(buf))
    last: Exception | None = None
    for _ in range(4):
        try:
            fregistry.inject("cluster:rpc", None)
            break
        except fregistry.InjectedOSError as e:
            last = e
            tevents.counter("rowstore.rpc_retries")
    else:
        raise last  # storm outlasted the retry budget
    psize = transport._PREFIX.size
    _magic, hlen, blen, _crc = transport._PREFIX.unpack(buf[:psize])
    header = buf[psize:psize + hlen]
    body = buf[psize + hlen:psize + hlen + blen]
    _kind, m, arrs = transport.parse_payload(header, body)
    return m, arrs


def encode_row_push(codec, name: str, rows: np.ndarray,
                    vals: np.ndarray, *seed_path: int) -> dict:
    """The sparse push payload for one leaf: ``{name}.rows`` int64 +
    values, raw f32 when ``codec is None`` else the host-codec parts
    (EF-free, seeded by ``seed_path`` so a respawned worker re-encodes
    the identical bytes)."""
    arrays = {f"{name}{ROWS_SUFFIX}": np.asarray(rows, np.int64)}
    if codec is None:
        arrays[f"{name}.val"] = np.asarray(vals, np.float32)
    else:
        enc, _res = pcomms.encode_tree(
            codec, {name: np.asarray(vals, np.float32)}, None,
            ROW_SEED_TAG, *seed_path)
        arrays.update(enc)
    return arrays


def decode_row_push(codec, name: str, arrays: dict,
                    n_rows: int, tail: tuple = ()) -> tuple[
                        np.ndarray, np.ndarray]:
    """Inverse of :func:`encode_row_push` -> ``(rows, vals)``."""
    vals_arrays, rows, _vb = strip_row_arrays(arrays)
    idx = rows[name]
    if codec is None:
        vals = np.asarray(vals_arrays[f"{name}.val"], np.float32)
    else:
        template = {name: np.zeros((n_rows,) + tail, np.float32)}
        vals = pcomms.decode_tree(codec, vals_arrays, template)[name]
    return idx, vals.reshape((n_rows,) + tail)


# ----------------------------------------------------- fault schedules


def compile_point_schedule(point: str, n_windows: int, n_cols: int = 1,
                           *, plan=None) -> np.ndarray:
    """The plan-pure fault schedule for one fleet point: one probe per
    (window, col) cell in row-major order against a fresh quiet
    registry — same discipline as ``worker.compile_worker_schedule``.
    Cell ``KILL_CELL`` = kill, > 0 = hang/straggle argument."""
    live = fregistry.active()
    if plan is None:
        plan = live.plan if live is not None else None
    out = np.zeros((n_windows, n_cols), np.float64)
    if plan is None or not any(r.point == point for r in plan.rules):
        return out
    reg = fregistry.FaultRegistry(plan, quiet=True)
    for w in range(n_windows):
        for c in range(n_cols):
            hit = reg.probe(point)
            if hit is None:
                continue
            kind, arg = hit
            if kind == "kill":
                out[w, c] = KILL_CELL
            else:
                out[w, c] = float(
                    arg if arg is not None
                    else fregistry.DEFAULT_HANG_SECONDS)
    if live is not None and live.plan == plan:
        live.record(reg.fired)
    return out


# ------------------------------------------------- cluster PageRank


@dataclasses.dataclass
class ClusterPageRankConfig:
    n_iterations: int = 8
    q: float = 0.15
    ps_shards: int = 2
    comm: str = "dense"
    table: str = "pagerank_cluster"
    plan_spec: str | None = None
    wal_dir: str | None = None
    #: rows one worker may hold at once (pull working set); ``None``
    #: disables the check. The ">1-host-RAM" contract: a budget below
    #: the vertex count forces streaming row pulls and FAILS LOUDLY if
    #: any worker ever materializes more.
    model_budget_rows: int | None = None
    max_restarts: int = 6


class _FleetDied(RuntimeError):
    """Internal: a seeded coordinator/PS kill fired — unwind to the
    recovery loop (the process-death stand-in of the in-process
    fleet)."""


class _PrWorker:
    """One fleet worker: its contiguous dst-window slice of the edge
    cache, its sparse pull set (the distinct sources with nonzero weight)
    and sparse push pairs (the shard's ``didx + lo`` window offsets),
    and, on ``device``, each edge block's runs of equal dst as B7's CSR
    rows with their tile plans, made once here and never per
    iteration."""

    def __init__(self, slot: int, rows: np.ndarray, lo: int,
                 window: int, block_edges: int, didx: np.ndarray,
                 dmask: np.ndarray, budget: int | None, device):
        import torch

        from tpu_distalg_torch.ops import pagerank_kernels as pk

        self.slot = slot
        self.window = int(window)
        self.lo = int(lo)
        rows = np.asarray(rows)
        w = np.ascontiguousarray(rows[:, 2]).view(np.float32)
        nz = w != 0.0          # padding rows carry zero weight: inert
        self.src = rows[:, 0][nz].astype(np.int64)
        self.dst_local = rows[:, 1][nz].astype(np.int64) - self.lo
        self.w = np.ascontiguousarray(w[nz])
        # the window acc is summed ONE EDGE BLOCK AT A TIME (`acc +
        # block sums` in block order), the engine's association; a
        # zero-weight padding row adds exactly +0.0, so dropping them
        # leaves every block's sums as they were
        block_of = np.flatnonzero(nz) // int(block_edges)
        self.block_starts = np.concatenate(
            [[0], np.flatnonzero(np.diff(block_of)) + 1,
             [self.src.shape[0]]]).astype(np.int64)
        self.pull_idx = np.unique(self.src)
        if budget is not None and self.pull_idx.shape[0] > budget:
            raise RuntimeError(
                f"worker {slot} needs {self.pull_idx.shape[0]} rank "
                f"rows at once but the model budget is {budget} — "
                f"the cache's dst windows must shrink (more shards), "
                f"not the honesty of the claim")
        self.src_local = np.searchsorted(self.pull_idx, self.src)
        self.didx = np.asarray(didx, np.int64)
        self.dmask = np.asarray(dmask, np.float32)
        self.push_idx = self.didx + self.lo
        # B7's operands: a block's runs of equal dst are its CSR rows
        # (the cache is dst-sorted), its sources index the pulled rows
        dev = self.device = torch.device(device)
        self.blocks = []
        for b in range(self.block_starts.shape[0] - 1):
            s, e = int(self.block_starts[b]), int(self.block_starts[b + 1])
            if e <= s:
                continue
            d = self.dst_local[s:e]
            heads = np.flatnonzero(np.concatenate(
                [[True], d[1:] != d[:-1]]))
            row_ptr = torch.as_tensor(
                np.append(heads, e - s).astype(np.int32), device=dev)
            src = torch.as_tensor(self.src_local[s:e].astype(np.int32),
                                  device=dev)
            self.blocks.append((
                row_ptr, src, torch.as_tensor(self.w[s:e], device=dev),
                torch.as_tensor(d[heads], device=dev),
                pk.tile_plan(row_ptr, e - s)))
        self.didx_dev = torch.as_tensor(self.didx, device=dev)
        self.dmask_dev = torch.as_tensor(self.dmask, device=dev)

    def contribs(self, pulled: np.ndarray) -> np.ndarray:
        """The window accumulation (B7 a block, each block's run sums
        added at their slots, in block order) reduced to the sparse
        pairs the push ships: ``acc[didx] * dmask``, on the host."""
        import torch

        from tpu_distalg_torch.ops import pagerank_kernels as pk

        x = torch.as_tensor(np.asarray(pulled, np.float32),
                            device=self.device)
        acc = torch.zeros(self.window, dtype=torch.float32,
                          device=self.device)
        for row_ptr, src, w, slot, plan in self.blocks:
            y = pk.spmv_table(row_ptr, src, w, x, plan)
            acc.index_put_((slot,), acc.index_select(0, slot) + y)
        return (acc[self.didx_dev] * self.dmask_dev).cpu().numpy()


def pagerank_event_digest(events: list) -> str:
    """CRC32 hex over the commit event sequence — the fleet's replay
    comparison surface (kill/recovery evidence deliberately outside
    it: wall clock and restart counts legitimately differ)."""
    import zlib

    crc = 0
    for e in events:
        crc = zlib.crc32(repr(e).encode(), crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def run_cluster_pagerank(path: str, cfg: ClusterPageRankConfig, *,
                         device=None) -> dict:
    """PageRank over the fleet through the row store: one worker per
    cache shard, its window computed on ``device`` (``cuda`` unless told
    ``cpu``; B7 there), sparse rank pulls and pushes through real wire
    frames, WAL row-redo records per commit, seeded chaos at the worker,
    coordinator, PS and rpc seams. Final ranks match the single-process
    ``graphs.run_streamed_pagerank`` within 1e-6 (the same combine
    order: slot-ordered origin accumulation, the ``sparse_allreduce``
    contract) and replay bitwise under kills.

    The workers run in slot order; the commit applies in slot order.
    Synchronous by construction: every push's base is the iteration's
    own version, so per-row ages are 0."""
    from tpu_distalg_torch.data import cache as dcache
    from tpu_distalg_torch.graphs import ingest
    from tpu_distalg_torch.utils.device import resolve_device

    mm, header = dcache.open_cache(path, layout=ingest.LAYOUT)
    geom = header["geom"]
    V = int(geom["n_vertices"])
    S = int(geom["n_shards"])
    window = int(geom["window"])
    lo = np.asarray(geom["lo"], np.int64)
    deg, didx, dmask = ingest.read_aux(path, geom)
    has_out = (deg > 0).astype(np.float32)
    n_iters = int(cfg.n_iterations)
    q = np.float32(cfg.q)

    codec = pcomms.make_host_codec(cfg.comm)
    plan = (fregistry.FaultPlan.parse(cfg.plan_spec)
            if cfg.plan_spec else None)
    worker_sched = compile_point_schedule(
        "cluster:worker", n_iters, S, plan=plan)
    coord_sched = compile_point_schedule(
        "cluster:coordinator", n_iters, plan=plan)
    ps_sched = compile_point_schedule(
        "cluster:ps", n_iters, plan=plan)

    dev = resolve_device(device)
    workers = [
        _PrWorker(s, dcache.shard_view(mm, S, s), int(lo[s]), window,
                  int(geom["block_edges"]), didx[s], dmask[s],
                  cfg.model_budget_rows, dev)
        for s in range(S)]
    peak_pull = max(w.pull_idx.shape[0] for w in workers)
    rows_pulled_iter = int(sum(w.pull_idx.shape[0] for w in workers))
    sparse_fraction = rows_pulled_iter / float(S * V)

    def new_store() -> RowStore:
        return RowStore(
            {"ranks": np.full((V,), 1.0 / V, np.float32)},
            table=cfg.table, n_shards=cfg.ps_shards)

    wal = None
    if cfg.wal_dir:
        wal = walmod.WriteAheadLog(cfg.wal_dir)

    def recover() -> tuple[RowStore, int, list]:
        """Rebuild the store from the WAL's row-redo records (base
        ranks are a pure function of V): re-decode each durable
        commit's pushed wire arrays and re-apply — bitwise, because
        the decode is a pure function of the logged bytes."""
        store = new_store()
        events: list = []
        if cfg.wal_dir is None:
            return store, 0, events
        records, _base = walmod.WriteAheadLog.replay(
            cfg.wal_dir, 1 << 30)
        for kind, meta, arrays in records:
            if kind != "rowcommit":
                continue
            it = int(meta["window"])
            _apply_commit(store, it, meta, arrays)
            events.append(_commit_event(it, meta))
        return store, store.version, events

    def _commit_event(it: int, meta: dict) -> tuple:
        return ("rowcommit", it,
                tuple(int(c["digest"]) for c in meta["contribs"]))

    def _apply_commit(store: RowStore, it: int, meta: dict,
                      arrays: dict) -> None:
        """Slot-ordered origin accumulation (the sparse_allreduce
        contract) + the dangling/teleport update, applied through the
        row store."""
        c = np.zeros((V,), np.float32)
        for contrib in meta["contribs"]:
            s = int(contrib["slot"])
            prefix = f"{s}/"
            sub = {k[len(prefix):]: v for k, v in arrays.items()
                   if k.startswith(prefix)}
            idx, vals = decode_row_push(
                codec, "ranks", sub, workers[s].push_idx.shape[0])
            np.add.at(c, idx, vals)
        dangling = np.float32(meta["dangling"])
        new_ranks = q / np.float32(V) + (np.float32(1.0) - q) * (
            c + dangling / np.float32(V))
        store.replace_rows(it, "ranks", np.arange(V, dtype=np.int64),
                           new_ranks)
        tevents.gauge("rowstore.max_row_staleness", 0)

    store = new_store()
    events: list = []
    if wal is not None:
        store, ver, events = recover()
        wal.open_segment(0, {"workload": "pagerank",
                             "n_iterations": n_iters})
    recoveries = 0
    restarts = 0
    fired_cells: set[tuple[str, int]] = set()
    t0 = time.monotonic()

    it = store.version
    while it < n_iters:
        try:
            # ---- workers: sparse pull, window compute, sparse push
            pushes: dict[int, tuple[dict, dict]] = {}

            def run_worker(s: int):
                wkr = workers[s]
                cell = float(worker_sched[it, s])
                if cell == KILL_CELL and ("w", it * S + s) \
                        not in fired_cells:
                    fired_cells.add(("w", it * S + s))
                    raise fregistry.InjectedKill(
                        f"worker {s} killed at iteration {it}")
                pulled, _vers = store.pull_rows("ranks", wkr.pull_idx)
                _pm, _pa = frame_roundtrip(
                    "rowpull",
                    {"slot": s, "window": it, "rows":
                     int(wkr.pull_idx.shape[0])},
                    {"ranks.rows": wkr.pull_idx,
                     "ranks.val": pulled},
                    counter="rowstore.wire_pull_bytes")
                tevents.counter("rowstore.wire_dense_bytes", 4 * V)
                vals = wkr.contribs(pulled)
                arrays = encode_row_push(
                    codec, "ranks", wkr.push_idx, vals, it, s)
                meta, arrs = frame_roundtrip(
                    "rowpush", {"slot": s, "window": it, "base": it},
                    arrays, counter="rowstore.wire_push_bytes")
                tevents.counter("rowstore.rows_pushed",
                                int(wkr.push_idx.shape[0]))
                tevents.counter("rowstore.wire_dense_bytes", 4 * V)
                pushes[s] = (meta, arrs)

            for s in range(S):
                # deterministic respawn: a killed worker's iteration
                # recomputes from the same pulled rows — same bytes
                for attempt in (0, 1):
                    try:
                        run_worker(s)
                        break
                    except fregistry.InjectedKill:
                        if attempt:
                            raise
                        recoveries += 1
                        tevents.counter("cluster.recoveries")

            # ---- commit (coordinator role), slot order
            cell = float(coord_sched[it, 0])
            if cell != 0.0 and ("c", it) not in fired_cells:
                fired_cells.add(("c", it))
                if cell == KILL_CELL:
                    # pushes in RAM, record not durable: rollback path
                    raise _FleetDied(f"coordinator kill at {it}")
                time.sleep(cell)
            snap = store.snapshot()["ranks"]
            dangling = float(np.float32(np.sum(
                snap * (np.float32(1.0) - has_out))))
            wal_meta = {
                "window": it, "version": it + 1,
                "dangling": dangling,
                "contribs": [
                    {"slot": s,
                     "digest": walmod.delta_digest(pushes[s][1])}
                    for s in sorted(pushes)],
            }
            wal_arrays = {f"{s}/{k}": v for s in sorted(pushes)
                          for k, v in pushes[s][1].items()}
            if wal is not None:
                wal.append("rowcommit", wal_meta, wal_arrays)
            # the cluster:ps seam: record durable, merge not applied —
            # a kill here exercises the REDO path (replay re-applies)
            cell = float(ps_sched[it, 0])
            if cell != 0.0 and ("p", it) not in fired_cells:
                fired_cells.add(("p", it))
                if cell == KILL_CELL:
                    raise _FleetDied(f"ps shard kill at {it}")
                time.sleep(cell)
            _apply_commit(store, it, wal_meta, wal_arrays)
            events.append(_commit_event(it, wal_meta))
            it = store.version
        except _FleetDied:
            restarts += 1
            recoveries += 1
            tevents.counter("cluster.recoveries")
            if restarts > cfg.max_restarts:
                raise
            if wal is None:
                raise RuntimeError(
                    "a coordinator/ps kill fired without a wal_dir — "
                    "nothing to recover from")
            store, _ver, events = recover()
            wal.open_segment(0, {"workload": "pagerank",
                                 "n_iterations": n_iters})
            it = store.version

    if wal is not None:
        wal.close()
    elapsed = time.monotonic() - t0
    return {
        "ranks": store.snapshot()["ranks"],
        "version": store.version,
        "events": events,
        "event_digest": pagerank_event_digest(events),
        "recoveries": recoveries,
        "elapsed_s": elapsed,
        "iters_per_sec": (n_iters / elapsed if elapsed > 0
                          else float("inf")),
        "sparse_pull_fraction": sparse_fraction,
        "peak_pull_rows": int(peak_pull),
        "n_vertices": V,
        "n_workers": S,
    }
