"""Coordinator process — rendezvous, clock, failure detection, commits.

Port of ``tpu_distalg/cluster/coordinator.py``. The coordinator is the
control plane: it holds the center on the host in numpy, as the JAX
package's does, so its merges, WAL records and event sequences are the
JAX package's under the same plan. Its durable center checkpoints are
the port's ``step_<N>.npz`` (``utils/checkpoint.py``, the leaves as
``center.<name>`` arrays), not the JAX package's msgpack. With
``ps_mode="rowstore"`` the center lives in the sharded row store
(``cluster/rowstore.py``) and pushes merge row-wise.

The multi-process replacement for PySpark's driver↔executor process
model: one coordinator owns generation-numbered MEMBERSHIP
(``parallel/membership.py``'s epoch semantics over the wire — every join/leave bumps the generation
and is recorded as a ``membership_epoch`` event), the cross-process
SSP CLOCK (the ``version`` counter: windows merged into the center —
``parallel/ssp.py``'s clock vector collapsed to the one number the
PS tier measures staleness against), HEARTBEAT failure detection
(``telemetry/heartbeat.py`` threads on the worker side, an age scan
here; a ``kill -9`` is seen even sooner as the connection's EOF), and
DURABLE center checkpoints (``utils/checkpoint.py`` — CRC footer,
atomic rename, quarantine fallback on resume).

Determinism contract (the acceptance the chaos/replay tests pin):
window ``w`` COMMITS only when every active admitted worker has
delivered a push or announced a skip for ``w`` — and because workers
pre-announce schedule-driven skips at window START, a straggler never
stalls a commit (its interference overlaps the peers' windows; its
delta arrives later, staler, weighted ``decay**age`` by the PS).
Contributions apply in SLOT order, never arrival order, and a push's
reply (the pull: the post-commit center) is deferred until its window
commits — so the merge sequence, the applied weights, and the
membership transitions are a pure function of the seeded fault plan,
and the same plan replays to the identical event sequence. What stays
timing-dependent is only WALL CLOCK (and the window at which an
unsolicited late joiner is admitted — the local launcher pins that
with an admission hold when replay equality matters).

A worker's death (EOF or heartbeat-timeout) removes it from the
expected set of the commit that was waiting on it, so training
CONTINUES at reduced quorum; a fresh worker joins by pulling the
center — no restart-budget burn, no resume-renegotiation round trip.
``policy='restart'`` is the measured BSP-baseline alternative: any
death aborts the run (checkpoint saved) for the launcher to respawn
everything — the gang-scheduled world the elastic runtime replaces.

CRASH TOLERANCE (the other half of elasticity — the control plane is
as killable as the data plane): with a ``checkpoint_dir`` every state
transition the replay contract depends on is appended to a durable
write-ahead ledger (``cluster/wal.py``) and fsynced BEFORE the
corresponding ack leaves the socket — admissions and incarnation
grants, announced skips, window commits (slot-ordered contribution
digests + the applied delta bytes), membership leaves, admission
holds. On restart :meth:`Coordinator._maybe_resume` replays the
ledger on top of the newest durable center: membership generation,
the SSP clock, incarnation fencing, and the in-flight window's
partial commit state all reconstruct; a half-committed window (pushes
in RAM, commit record never written) rolls back to its start — and
because push acks are deferred until commit, no worker ever observed
it, so rollback is invisible by construction: the surviving workers
re-present their incarnation tokens (re-admitted WITHOUT burning a
membership epoch) and re-push the identical deltas, which the WAL's
commit digests dedupe if the commit did land. The seeded
``cluster:coordinator`` fault point (kinds ``kill``/``hang``, probed
plan-pure by :func:`compile_coordinator_schedule`) makes the
coordinator's own death a replayable chaos input — same plan, same
recovery, bitwise-identical final center and identical merge/
membership event digest vs the undisturbed run.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import threading
import time

import numpy as np

from tpu_distalg_torch.cluster import ps as psmod
from tpu_distalg_torch.cluster import rowstore as rowstoremod
from tpu_distalg_torch.cluster import transport
from tpu_distalg_torch.cluster import wal as walmod
from tpu_distalg_torch.faults import registry as fregistry
from tpu_distalg_torch.parallel import comms as pcomms
from tpu_distalg_torch.parallel import membership
from tpu_distalg_torch.parallel.ssp import (
    DEFAULT_DECAY,
    DEFAULT_STALENESS,
)
from tpu_distalg_torch.telemetry import events as tevents
from tpu_distalg_torch.tune import defaults as tune_defaults

#: how often the accept loop wakes to scan for stale heartbeats
POLL_SECONDS = 0.05
#: default worker-silence deadline before a slot is declared dead
DEFAULT_HEARTBEAT_TIMEOUT = 5.0
#: coordinator-schedule cell code for a kill (hang cells hold seconds)
COORD_KILL = -1.0

PULL_SEED_TAG = pcomms.PULL_SEED_TAG

#: every Nth commit version ships a DENSE version-pinned pull instead
#: of a delta: pull-direction quantization noise has no EF channel
#: (each decoded delta adds independent rounding noise to the
#: worker's cached view — a random walk of stddev ~ sqrt(windows) ·
#: scale), so the periodic refresh bounds the drift at
#: sqrt(REFRESH) · scale instead of letting a long run's workers
#: train against an ever-worse center. Amortized wire cost: 4d/16 =
#: 0.25 bytes/elem/window on top of int8's ~1 — the reduction claim
#: survives. A pure function of cv, so replays are unaffected. The
#: default cadence lives in the tuner's geometry table
#: (``tune/defaults.py``); ``ClusterConfig.pull_refresh_windows``
#: overrides it per run (the autotuner's resolver re-derives the
#: cadence from the measured wire).
PULL_REFRESH_WINDOWS = tune_defaults.PULL_REFRESH_WINDOWS

FREE, ACTIVE, DEAD = "free", "active", "dead"

#: name prefix of the center's leaves in a checkpoint's npz
_CENTER = "center."


class CoordinatorKilled(Exception):
    """Thread-mode stand-in for the coordinator's SIGKILL (the real
    coordinator process never raises this — it is gone)."""


def compile_coordinator_schedule(n_windows: int, *,
                                 plan=None) -> np.ndarray:
    """The (n_windows,) float64 coordinator fault schedule from the
    plan's ``cluster:coordinator`` rules: cell == -1 = kill (the
    coordinator SIGKILLs itself at that window's commit point — pushes
    buffered in RAM, commit record not yet durable: the rollback path),
    cell > 0 = hang that many seconds there. One probe per window
    against a FRESH quiet registry (a pure function of the plan, like
    the worker/SSP compilers); fires mirror into the live ledger
    exactly once."""
    live = fregistry.active()
    if plan is None:
        plan = live.plan if live is not None else None
    out = np.zeros((n_windows,), np.float64)
    if plan is None or not any(
            r.point == "cluster:coordinator" for r in plan.rules):
        return out
    reg = fregistry.FaultRegistry(plan, quiet=True)
    for w in range(n_windows):
        hit = reg.probe("cluster:coordinator")
        if hit is None:
            continue
        kind, arg = hit
        if kind == "kill":
            out[w] = COORD_KILL
        else:
            out[w] = float(arg if arg is not None
                           else fregistry.DEFAULT_HANG_SECONDS)
    if live is not None and live.plan == plan:
        live.record(reg.fired)
    return out


def _tupled(x):
    """JSON round-trip repair: the WAL snapshot stores the event list
    through JSON (tuples become lists); the comparable sequences are
    tuples all the way down."""
    if isinstance(x, list):
        return tuple(_tupled(v) for v in x)
    return x


@dataclasses.dataclass
class TrainTask:
    """The training job the coordinator OWNS and hands every worker at
    join (a worker needs only the coordinator's address): the synthetic
    two-class task of bench.comm_comparison_task's shape, sliced into
    per-slot contiguous row blocks."""

    algo: str = "ssgd"            # 'ssgd' | 'local_sgd'
    n_rows: int = 4096
    test_rows: int = 1024
    n_features: int = 30
    data_seed: int = 0
    seed: int = 42                # sampling seed base (per-slot stride)
    eta: float = 0.1
    mini_batch_fraction: float = 0.1
    lam: float = 0.0
    reg_type: str = "l2"

    def as_meta(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ClusterConfig:
    n_slots: int = 3
    n_windows: int = 24
    staleness: int = DEFAULT_STALENESS      # ticks per window AND bound
    decay: float = DEFAULT_DECAY
    ps_shards: int = 2
    table: str = "lr"                       # PS placement rule table
    host: str = "127.0.0.1"
    port: int = 0                           # 0 = ephemeral
    heartbeat_timeout: float = DEFAULT_HEARTBEAT_TIMEOUT
    heartbeat_interval: float = 0.5
    rpc_deadline: float = 30.0
    #: seconds a bound connection's EOF leaves its slot SUSPECT before
    #: the death fires — the window a reconnecting worker's re-dial
    #: has to race the coordinator's EOF sweep of its dead connection
    #: (a transient transport fault must not burn a membership epoch)
    reconnect_grace: float = 1.0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 8               # windows between center saves
    policy: str = "elastic"                 # 'elastic' | 'restart'
    plan_spec: str | None = None            # fault plan handed to workers
    #: cluster wire schedule — ``dense`` (f32 snapshots/deltas, the
    #: pre-compression trajectories bit-for-bit), ``int8[:seed]``
    #: (seeded stochastic rounding, ~1 byte/elem both directions) or
    #: ``topk[:frac]`` ((value, index) pairs with worker-side error
    #: feedback on pushes; pulls ride the int8 codec — see
    #: ``worker.py``). ``@seq`` disables the async push overlap.
    comm: str = "dense"
    #: PS state layout — ``replicated`` (every shard a row slice of a
    #: center that must fit one host; the verbatim pre-rowstore path,
    #: pinned bitwise) or ``rowstore`` (disjoint row ownership with
    #: per-row versions: pushes carry ``{leaf}.rows`` index arrays and
    #: merge row-wise — see ``cluster/rowstore.py``)
    ps_mode: str = "replicated"
    #: compressed-pull refresh cadence — every Nth commit ships a
    #: dense version-pinned pull (see :data:`PULL_REFRESH_WINDOWS`).
    #: The autotuner's resolver re-derives this from the measured
    #: wire; a pure function of cv either way, so replays and the
    #: bitwise determinism contract are unaffected by the value.
    pull_refresh_windows: int = tune_defaults.PULL_REFRESH_WINDOWS
    #: the rig profile id this config's geometry was resolved from
    #: (``None`` = untuned table defaults) — carried into the welcome
    #: meta so worker logs can name the profile that shaped the run
    tune_profile: str | None = None
    train: TrainTask = dataclasses.field(default_factory=TrainTask)

    def __post_init__(self):
        if self.ps_mode not in psmod.PS_MODES:
            raise ValueError(
                f"unknown ps_mode {self.ps_mode!r}; choose from "
                f"{psmod.PS_MODES}")
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if self.staleness < 1:
            raise ValueError(
                f"staleness must be >= 1, got {self.staleness}")
        if self.pull_refresh_windows < 1:
            raise ValueError(
                f"pull_refresh_windows must be >= 1, got "
                f"{self.pull_refresh_windows}")
        # parse-validate eagerly: an unknown/deviceless schedule must
        # fail at config time, not in a worker subprocess mid-join
        pcomms.make_host_codec(self.comm)
        if self.policy not in ("elastic", "restart"):
            raise ValueError(
                f"unknown policy {self.policy!r}: 'elastic' (continue "
                f"at reduced quorum) or 'restart' (the BSP gang-"
                f"scheduled baseline: any death aborts for a full "
                f"respawn from the checkpoint)")


@dataclasses.dataclass
class SlotState:
    status: str = FREE
    admit: int = 0                   # first window this worker owns
    incarnation: int = 0             # fencing token: which JOIN owns
    #                                  this slot (a zombie's frames
    #                                  must never act on a replacement)
    last_beat: float = 0.0
    pushes: dict = dataclasses.field(default_factory=dict)
    skips: set = dataclasses.field(default_factory=set)
    delivered: int = -1              # newest window pushed or skipped
    stats: dict = dataclasses.field(default_factory=dict)
    conn_serial: int = 0             # which CONNECTION owns the
    #                                  incarnation: a resume-join bumps
    #                                  it, so the dead predecessor
    #                                  connection's EOF is inert
    suspect_at: float | None = None  # EOF seen; death after the
    #                                  reconnect grace unless a fenced
    #                                  frame lands first


def init_center(task: TrainTask) -> dict:
    """The step-0 center — zero weights over the biased feature width
    (the SGD family's convention for this task)."""
    return {"w": np.zeros((task.n_features + 1,), np.float32)}


def center_accuracy(center: dict, task: TrainTask) -> float:
    """Test accuracy of the center on the task's held-out tail —
    numpy-only, so the coordinator can report convergence without a
    device."""
    from tpu_distalg_torch.utils import datasets

    X, y = datasets.synthetic_two_class(
        task.n_rows + task.test_rows, task.n_features,
        seed=task.data_seed)
    X = datasets.add_bias_column(X)
    X_te, y_te = X[task.n_rows:], y[task.n_rows:]
    z = X_te @ np.asarray(center["w"], np.float32)
    return float(np.mean((z > 0).astype(np.float32) == y_te))


class ClusterAborted(RuntimeError):
    """The run ended without completing (restart policy fired, or the
    caller stopped it)."""


class Coordinator:
    """``start()`` binds and serves on daemon threads; ``wait()``
    blocks to the result. One lock + condition guard all state; the
    commit loop runs inside whichever handler completes a window."""

    def __init__(self, config: ClusterConfig, *, die=None):
        self.cfg = config
        self.task = config.train
        # the cluster wire codec (None = dense, the verbatim legacy
        # path) + the model's known center layout for exact decode;
        # compressed modes keep a bounded center-version history in
        # the PS for version-delta pulls (deep enough that any base
        # the SSP gate admits — plus the async push's one-window lag
        # — still resolves to a delta instead of a dense fallback)
        self._codec = pcomms.make_host_codec(config.comm)
        self._pull_codec = pcomms.make_host_pull_codec(config.comm)
        self._center_template = init_center(config.train)
        self._history_depth = (0 if self._codec is None
                               else 2 * config.staleness + 8)
        self.ps = psmod.ParameterServer(
            init_center(self.task), table=config.table,
            n_shards=config.ps_shards, decay=config.decay,
            history_depth=self._history_depth,
            mode=config.ps_mode)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.slots = {i: SlotState() for i in range(config.n_slots)}
        self.version = 0              # windows merged (the SSP clock)
        self.gen = 0                  # membership generation
        self.done = False
        self.aborted: str | None = None
        self.killed = False           # thread-mode SIGKILL stand-in
        self.recovered = False        # this incarnation replayed a WAL
        self.wal_records_replayed = 0
        self.first_recommit_at: float | None = None  # monotonic time
        #                               of the first commit AFTER a
        #                               recovery — the endpoint of the
        #                               measured detect→recover→
        #                               first-recommitted-window span
        self.events: list[tuple] = []
        self.hold_at: dict[int, int] = {}   # window -> required actives
        self.worker_stats: dict[int, dict] = {}
        self.commit_digests: dict[tuple[int, int], int] = {}
        self._next_incarnation = 1
        self._threads: list[threading.Thread] = []
        self._listener: socket.socket | None = None
        self._conns: set[socket.socket] = set()
        self._stop = threading.Event()
        self._die_fn = die            # thread-mode override (sockets
        #                               slam instead of a real SIGKILL)
        comm_sched = pcomms.CommSpec.parse(config.comm).schedule
        self._tag = (f"cluster:{self.task.algo}:ssp:"
                     f"{config.staleness}:{config.decay:g}"
                     + ("" if comm_sched == "dense"
                        else f":{comm_sched}"))
        self.port: int | None = None
        self.wal: walmod.WriteAheadLog | None = None
        plan = (fregistry.FaultPlan.parse(config.plan_spec)
                if config.plan_spec else None)
        self._coord_sched = compile_coordinator_schedule(
            config.n_windows, plan=plan)
        self._coord_fired: set[int] = set()
        # the PS-shard fault schedule (cluster:ps — the merge seam,
        # AFTER the commit record is durable): compiled by the shared
        # rowstore compiler, one probe per window, same plan-purity
        self._ps_sched = rowstoremod.compile_point_schedule(
            "cluster:ps", config.n_windows, plan=plan)[:, 0]
        self._ps_fired: set[int] = set()
        self._maybe_resume()
        # seed the version history at whatever center recovery landed
        # on (replayed commits already recorded theirs inside merge)
        self.ps.record_history(self.version)

    # ------------------------------------------------------ lifecycle

    def _maybe_resume(self) -> None:
        """Durable-state recovery: restore the newest center
        checkpoint, then replay the WAL on top of it — membership
        generation, incarnation fencing, the SSP clock, announced
        skips and every committed-but-not-yet-checkpointed window's
        merge all reconstruct; an in-flight window with no commit
        record rolls back to its start (invisible: its acks never
        left). Torn WAL tails are truncated with a quarantine event
        inside :func:`wal.read_segment`, mirroring checkpoint
        restore."""
        from tpu_distalg_torch.utils import checkpoint as ckpt

        if not self.cfg.checkpoint_dir:
            return
        wal_dir = os.path.join(self.cfg.checkpoint_dir, "wal")
        restored = ckpt.restore_newest_with_fallback(
            self.cfg.checkpoint_dir)
        if restored is not None:
            payload, step = restored
            saved_tag = payload["tag"]
            center = {k[len(_CENTER):]: np.asarray(v)
                      for k, v in payload.items()
                      if k.startswith(_CENTER)}
            if saved_tag != self._tag or not center:
                raise ValueError(
                    f"checkpoint in {self.cfg.checkpoint_dir} holds "
                    f"workload {saved_tag!r}, this cluster is "
                    f"{self._tag!r} — use a fresh directory")
            self.ps = psmod.ParameterServer(
                center, table=self.cfg.table,
                n_shards=self.cfg.ps_shards, decay=self.cfg.decay,
                history_depth=self._history_depth,
                mode=self.cfg.ps_mode)
            self.version = int(step)
            self.ps.version = self.version
            # the restored base enters the version history BEFORE the
            # WAL replay merges on top: a re-pushed window whose
            # original ack diffed against this base must re-serve the
            # identical delta bytes, not a dense fallback
            self.ps.record_history(self.version)
        if self.cfg.policy == "restart":
            # the gang-scheduled BASELINE deliberately has no WAL:
            # it restarts from the last PERIODIC save and re-pays
            # every window since — replaying a ledger here would (a)
            # quietly gift the baseline lossless restarts and flatter
            # the measured elastic speedup's denominator, and (b)
            # resurrect the aborted incarnations' slot state, whose
            # inevitable heartbeat deaths would re-trigger the abort
            # in a loop
            if restored is not None:
                tevents.emit("cluster_resume", version=self.version)
            return
        records, replay_base = walmod.WriteAheadLog.replay(
            wal_dir, self.version)
        self.wal = walmod.WriteAheadLog(wal_dir)
        if records:
            t0 = time.monotonic()
            n = self._apply_wal_records(records)
            self.recovered = True
            self.wal_records_replayed = n
            # the replayed segment stays the open segment — recovery
            # appends continue it (its snapshot + records already
            # cover everything up to here)
            self.wal.open_segment(
                replay_base if replay_base is not None
                else self.version, self._snapshot_control())
            tevents.emit(
                "cluster_recovered", version=self.version,
                gen=self.gen, records=n, base=replay_base,
                seconds=round(time.monotonic() - t0, 4))
            tevents.counter("cluster.recoveries")
            tevents.counter("cluster.wal_records_replayed", n)
        else:
            self.wal.open_segment(self.version,
                                  self._snapshot_control())
            if restored is not None:
                tevents.emit("cluster_resume", version=self.version)

    # ----------------------------------------------------- WAL plumbing

    def _snapshot_control(self) -> dict:
        """The control-plane snapshot a WAL segment opens with: the
        data plane lives in the center checkpoint, everything else
        (clock, generation, fencing counter, slot table, event
        history, holds, commit digests) lives here — so recovery =
        checkpoint + snapshot + records, in that order."""
        return {
            "version": self.version,
            "gen": self.gen,
            "next_incarnation": self._next_incarnation,
            "done": self.done,
            "events": self.events,
            "hold_at": {str(k): v for k, v in self.hold_at.items()},
            "worker_stats": {str(k): v for k, v
                             in self.worker_stats.items()},
            "commit_digests": [[w, s, d] for (w, s), d
                               in self.commit_digests.items()],
            "slots": {
                # last_beat, suspect_at, conn_serial and stats are
                # PER-INCARNATION state and must
                # NOT be resurrected: a recovered slot gets a FRESH
                # liveness clock (see _apply_wal_records), connection
                # ownership dies with the old process's sockets, and
                # worker stats re-ride the bye frames; pushes roll
                # forward from replayed WAL push records instead
                str(i): {"status": st.status, "admit": st.admit,
                         "incarnation": st.incarnation,
                         "delivered": st.delivered,
                         "skips": sorted(st.skips)}
                for i, st in self.slots.items()},
        }

    def _adopt_snapshot(self, snap: dict) -> None:
        """Apply a ``base`` record. ``version`` only moves FORWARD: a
        snapshot older than the restored center (the crash landed
        between a checkpoint and its WAL rotation) must not rewind the
        clock — its commit records re-apply idempotently instead."""
        self.version = max(self.version, int(snap.get("version", 0)))
        self.ps.version = max(self.ps.version, self.version)
        self.gen = int(snap.get("gen", self.gen))
        self._next_incarnation = max(
            self._next_incarnation,
            int(snap.get("next_incarnation", 1)))
        if snap.get("done"):
            self.done = True
        self.events = [_tupled(e) for e in snap.get("events", [])]
        self.hold_at = {int(k): int(v) for k, v
                        in (snap.get("hold_at") or {}).items()}
        self.worker_stats = {int(k): dict(v) for k, v
                             in (snap.get("worker_stats")
                                 or {}).items()}
        self.commit_digests = {
            (int(w), int(s)): int(d)
            for w, s, d in snap.get("commit_digests", [])}
        for k, s in (snap.get("slots") or {}).items():
            self.slots[int(k)] = SlotState(
                status=s["status"], admit=int(s["admit"]),
                incarnation=int(s["incarnation"]),
                delivered=int(s["delivered"]),
                skips=set(int(x) for x in s.get("skips", ())))

    def _apply_wal_records(self, records) -> int:
        """Roll the control state (and any post-checkpoint commits)
        forward through the replayed records; returns the record
        count. Recovered ACTIVE slots get a fresh liveness clock —
        their workers have ``heartbeat_timeout`` seconds to re-present
        their incarnation tokens before the usual elastic death."""
        for kind, meta, arrays in records:
            if kind == "base":
                self._adopt_snapshot(meta)
            elif kind == "admit":
                slot = int(meta["slot"])
                self.slots[slot] = SlotState(
                    status=ACTIVE, admit=int(meta["admit"]),
                    incarnation=int(meta["incarnation"]),
                    delivered=int(meta["admit"]) - 1)
                self.gen = int(meta["gen"])
                self._next_incarnation = max(
                    self._next_incarnation,
                    int(meta["incarnation"]) + 1)
                self.events.append(
                    ("join", slot, int(meta["admit"]), self.gen))
            elif kind == "leave":
                slot = int(meta["slot"])
                st = self.slots.get(slot)
                if st is not None:
                    st.status = DEAD
                self.gen = int(meta["gen"])
                self.events.append(
                    ("leave", slot, int(meta["window"]), self.gen,
                     str(meta.get("reason", ""))))
            elif kind == "skip":
                st = self.slots.get(int(meta["slot"]))
                if st is not None and \
                        st.incarnation == int(meta.get(
                            "inc", st.incarnation)):
                    w = int(meta["window"])
                    st.skips.add(w)
                    st.delivered = max(st.delivered, w)
            elif kind == "hold":
                self.hold_at[int(meta["window"])] = \
                    int(meta["n_active"])
            elif kind == "commit":
                self._replay_commit(meta, arrays)
            elif kind == "bye":
                slot = int(meta["slot"])
                self.worker_stats[slot] = dict(meta.get("stats")
                                               or {})
                st = self.slots.get(slot)
                if st is not None and st.status == ACTIVE:
                    st.status = FREE
            elif kind == "done":
                self.done = True
        now = time.monotonic()
        for st in self.slots.values():
            if st.status == ACTIVE:
                st.last_beat = now
                st.suspect_at = None
        return len(records)

    def _replay_commit(self, meta: dict, arrays: dict) -> None:
        """Re-apply one committed window's redo record: the merge
        event always re-enters the history; the DELTAS re-apply only
        when the window is not already inside the restored center
        (the idempotence that lets an older segment roll forward past
        a quarantined checkpoint)."""
        w = int(meta["window"])
        contribs = []
        for c in meta.get("contribs", ()):
            slot = int(c["slot"])
            self.commit_digests[(w, slot)] = int(c["digest"])
            st = self.slots.get(slot)
            if st is not None:
                st.pushes.pop(w, None)
                st.delivered = max(st.delivered, w)
            prefix = f"{slot}/"
            delta = {k[len(prefix):]: v for k, v in arrays.items()
                     if k.startswith(prefix)}
            contribs.append((slot, int(c["base"]),
                             self._decode_delta(delta)))
        skipped = [int(s) for s in meta.get("skipped", ())]
        for s in skipped:
            st = self.slots.get(s)
            if st is not None:
                st.skips.discard(w)
                st.delivered = max(st.delivered, w)
        if w >= self.version:
            self.ps.merge(w, contribs)
            self.version = w + 1
            self.ps.version = self.version
        self.events.append((
            "merge", w,
            tuple((int(c["slot"]), int(c["age"]))
                  for c in meta.get("contribs", ())),
            tuple(skipped)))

    def _wal_append(self, kind: str, meta: dict,
                    arrays: dict | None = None) -> None:
        """One durable ledger record (no-op without a checkpoint
        dir). Transient disk faults retry through ``supervised`` —
        the same discipline as ``checkpoint.save`` — because an
        un-durable record must never let its ack escape."""
        if self.wal is None or self.killed:
            return
        from tpu_distalg_torch.telemetry.supervisor import supervised

        supervised(lambda: self.wal.append(kind, meta, arrays),
                   phase="cluster:wal", retries=2, backoff=0.05,
                   backoff_cap=0.05, jitter=0.0, retry_on=(OSError,),
                   failure_counter="cluster.wal_write_failures",
                   log=lambda m: None)

    def start(self) -> "Coordinator":
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        for attempt in range(100):
            try:
                self._listener.bind((self.cfg.host, self.cfg.port))
                break
            except OSError:
                # a recovered coordinator re-binds its predecessor's
                # port and can race the dying listener's close (thread
                # mode) or the kernel's release of it — brief patience
                # instead of failing the recovery
                if attempt == 99:
                    raise
                time.sleep(0.05)
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        t = threading.Thread(target=self._accept_loop,
                             name="tda-cluster-accept", daemon=True)
        t.start()
        self._threads.append(t)
        tevents.emit("cluster_start", port=self.port,
                     n_slots=self.cfg.n_slots,
                     n_windows=self.cfg.n_windows,
                     resume_version=self.version)
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self.wal is not None:
            self.wal.close()

    def _die(self) -> None:
        """The ``cluster:coordinator`` kill cell. The real coordinator
        SIGKILLs its own process (sockets slam, WAL handle dies with
        it — the genuine article); thread mode runs the injected
        ``die`` hook (slams the listener and every connection for the
        same EOF observable) and unwinds the handler."""
        self.killed = True
        self._stop.set()
        if self.wal is not None:
            self.wal.close()
        if self._die_fn is not None:
            self._die_fn(self)
            self._cond.notify_all()
            raise CoordinatorKilled()
        os.kill(os.getpid(), signal.SIGKILL)

    def slam(self) -> None:
        """Abruptly close the listener and every live connection —
        what a SIGKILL does to the process's sockets; the thread-mode
        ``die`` hook and the tests use it directly."""
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for conn in list(self._conns):
            for fn in (lambda: conn.shutdown(2), conn.close):
                try:
                    fn()
                except OSError:
                    pass

    def wait(self, timeout: float | None = None) -> dict:
        """Block until done/aborted; returns the result dict. Raises
        :class:`ClusterAborted` under the restart policy's abort (the
        launcher catches it and respawns), and ``TimeoutError`` when
        ``timeout`` expires first (the run keeps going)."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        with self._cond:
            while not self.done and self.aborted is None:
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"cluster run still at window {self.version}/"
                        f"{self.cfg.n_windows} after {timeout}s")
                self._cond.wait(timeout=0.2 if remaining is None
                                else min(0.2, remaining))
        if self.aborted is not None:
            raise ClusterAborted(self.aborted)
        return self.result()

    def result(self) -> dict:
        with self._lock:
            center = self.ps.snapshot()
            return {
                "center": center,
                "version": self.version,
                "gen": self.gen,
                "events": list(self.events),
                "merge_sequence": self.merge_sequence(),
                "membership_sequence": self.membership_sequence(),
                "accuracy": center_accuracy(center, self.task),
                "worker_stats": dict(self.worker_stats),
                "recovered": self.recovered,
                "wal_records_replayed": self.wal_records_replayed,
            }

    def hold_admission(self, window: int, n_active: int) -> None:
        """Pin the admission of a (re)joining worker to a WINDOW: the
        commit of ``window`` waits until ``n_active`` workers are
        active. This is how the local launcher makes a rejoin land at
        a plan-determined position in the event sequence (an
        unsolicited late join is otherwise admitted at whatever window
        the cluster happens to be at). Durable: a recovered
        coordinator must keep honoring the hold."""
        with self._cond:
            self.hold_at[int(window)] = int(n_active)
            self._wal_append("hold", {"window": int(window),
                                      "n_active": int(n_active)})
            self._cond.notify_all()

    # ------------------------------------------------- event recording

    def merge_sequence(self) -> list:
        """The commit trace: ``(window, ((slot, age), ...), (skipped
        slots...))`` per merge, in commit order — what the replay
        acceptance compares bit-for-bit. Caller may hold the lock."""
        return [e[1:] for e in self.events if e[0] == "merge"]

    def membership_sequence(self) -> list:
        """``(kind, slot, window)`` SORTED — concurrent connects make
        same-window join ORDER (and so the generation numbers)
        scheduler-dependent, so the comparable sequence projects the
        plan-determined fields and is order-free within a window."""
        return sorted((e[0], e[1], e[2]) for e in self.events
                      if e[0] in ("join", "leave"))

    def _emit_membership(self, reason: str, prev_active: int) -> None:
        active = tuple(self.slots[i].status == ACTIVE
                       for i in sorted(self.slots))
        membership.emit_epoch_event(
            membership.Epoch(gen=self.gen, start=self.version,
                             end=self.cfg.n_windows, active=active),
            reason=reason, prev_active=prev_active)
        tevents.counter("cluster.membership_epochs")

    # ------------------------------------------------------ accept/IO

    def _accept_loop(self) -> None:
        self._listener.settimeout(POLL_SECONDS)
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                try:
                    self._scan_heartbeats()
                except CoordinatorKilled:
                    break  # a death's commit drain hit a kill cell
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # daemon handlers, deliberately untracked: a long-lived
            # coordinator accepts one connection per join/heartbeat/
            # rejoin forever, and an ever-growing thread list would be
            # a slow leak (stop() ends them via the stop event/EOF)
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="tda-cluster-conn", daemon=True).start()

    def _scan_heartbeats(self) -> None:
        """Declare slots dead on silence past the heartbeat timeout
        (the partition/hang detector), or on an unresolved connection
        EOF past the reconnect grace — EOF alone is only SUSPICION,
        because a worker riding out a transient transport fault
        re-dials the same incarnation and must not burn a membership
        epoch racing our sweep of its dead connection."""
        now = time.monotonic()
        with self._lock:
            for slot, st in list(self.slots.items()):
                if st.status != ACTIVE:
                    continue
                if st.last_beat > 0 and now - st.last_beat \
                        > self.cfg.heartbeat_timeout:
                    self._death(slot, "heartbeat timeout")
                elif st.suspect_at is not None and \
                        now - st.suspect_at \
                        > self.cfg.reconnect_grace:
                    self._death(slot, "connection lost")

    def _serve_conn(self, conn: socket.socket) -> None:
        """One connection's request loop. A worker's MAIN connection
        binds to its slot, its join incarnation AND a connection
        serial; EOF on it marks that incarnation SUSPECT (death after
        the reconnect grace) — never its replacement's, and never an
        incarnation that already resumed on a newer connection (the
        serial check: a re-dial superseded this one). Heartbeat
        connections never join, so they never bind and their EOF is
        inert."""
        bound_slot: int | None = None
        bound_inc: int | None = None
        bound_serial: int | None = None
        self._conns.add(conn)
        try:
            while not self._stop.is_set():
                try:
                    kind, meta, arrays = transport.recv_frame(
                        conn, deadline=max(
                            self.cfg.rpc_deadline,
                            4 * self.cfg.heartbeat_timeout))
                except transport.TransportTimeout:
                    continue  # idle connection; liveness rides beats
                reply = self._handle(kind, meta, arrays, conn)
                if kind == "join" and "slot" in reply[1]:
                    bound_slot = int(reply[1]["slot"])
                    bound_inc = int(reply[1]["incarnation"])
                    bound_serial = int(reply[1].get("serial", 0))
                transport.send_frame(
                    conn, *reply, deadline=self.cfg.rpc_deadline)
                if kind == "bye":
                    break
        except transport.TransportClosed:
            pass
        except transport.TransportError:
            pass
        except CoordinatorKilled:
            pass  # thread-mode SIGKILL stand-in: just unwind
        finally:
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass
            if bound_slot is not None and not self.killed:
                with self._lock:
                    st = self.slots.get(bound_slot)
                    if st is not None and st.status == ACTIVE \
                            and st.incarnation == bound_inc \
                            and st.conn_serial == bound_serial:
                        st.suspect_at = time.monotonic()

    # ------------------------------------------------------- handlers

    def _fenced(self, meta) -> SlotState | None:
        """Lock held. The slot state a frame may act on: ACTIVE and
        carrying the SAME incarnation token (every frame a welcomed
        worker sends has one) — a partitioned zombie's late frames
        must neither feed the replacement's push state nor keep its
        heartbeat fresh, and a REPLACEMENT's pre-welcome join retries
        (slot but no token yet) must not read as liveness for the
        dying incarnation they are waiting to replace (that would
        clear the EOF suspicion forever and wedge the admission)."""
        slot = meta.get("slot")
        if slot is None:
            return None
        st = self.slots.get(int(slot))
        if st is None or st.status != ACTIVE:
            return None
        inc = meta.get("inc")
        if inc is None or int(inc) != st.incarnation:
            return None
        return st

    def _handle(self, kind, meta, arrays, conn):
        """Dispatch one frame -> ``(kind, meta, arrays)`` reply."""
        if self.killed:
            # a dead coordinator goes SILENT, never answers: in the
            # beat between killed=True and the socket slam, an error
            # reply here would escape to a healthy worker and read as
            # a GENUINE rejection (fatal), when the right observable
            # is EOF -> reconnect -> resume on the recovered
            # incarnation
            raise CoordinatorKilled()
        with self._lock:
            st = self._fenced(meta)
            if st is not None:
                st.last_beat = time.monotonic()
                st.suspect_at = None  # a live fenced frame IS liveness
        if kind == "join":
            return self._handle_join(meta)
        if kind == "push":
            return self._handle_push(meta, arrays)
        if kind == "skip":
            return self._handle_skip(meta)
        if kind in ("poll", "beat", "hb"):
            with self._lock:
                return ("ok", self._status_meta(), {})
        if kind == "hold":
            # the launcher's admission pin, over the wire (a
            # subprocess coordinator has no in-process handle)
            self.hold_admission(int(meta["window"]),
                                int(meta["n_active"]))
            with self._lock:
                return ("ok", self._status_meta(), {})
        if kind == "pull":
            with self._lock:
                return ("center", self._status_meta(),
                        self.ps.snapshot())
        if kind == "bye":
            return self._handle_bye(meta)
        return ("error", {"error": f"unknown frame kind {kind!r}"}, {})

    def _status_meta(self) -> dict:
        return {"version": self.version, "gen": self.gen,
                "done": self.done,
                "restart": self.aborted is not None,
                # CLOCK_MONOTONIC is machine-wide on Linux, so a
                # launcher process can subtract its own detect time
                # from this to get the true recovery span (the
                # subprocess-coordinator recovery measurement)
                "recommit_at": self.first_recommit_at}

    def _welcome_meta(self, slot: int, st: SlotState) -> dict:
        return {
            "slot": slot, "gen": self.gen,
            "version": self.version,
            "admit": st.admit,
            "incarnation": st.incarnation,
            "serial": st.conn_serial,
            "n_slots": self.cfg.n_slots,
            "n_windows": self.cfg.n_windows,
            "s": self.cfg.staleness,
            "decay": self.cfg.decay,
            "heartbeat_interval": self.cfg.heartbeat_interval,
            "heartbeat_timeout": self.cfg.heartbeat_timeout,
            "rpc_deadline": self.cfg.rpc_deadline,
            "comm": self.cfg.comm,
            "ps_mode": self.cfg.ps_mode,
            "pull_refresh": self.cfg.pull_refresh_windows,
            "tune_profile": self.cfg.tune_profile,
            "plan": self.cfg.plan_spec,
            "train": self.task.as_meta(),
            "done": self.done,
            "restart": self.aborted is not None,
        }

    def _handle_join(self, meta) -> tuple:
        want = meta.get("slot")
        with self._lock:
            if meta.get("resume") and want is not None:
                # a surviving worker re-attaching after a coordinator
                # recovery or a transient connection loss: it presents
                # the SAME incarnation token, so it is re-admitted
                # WITHOUT burning a membership epoch (no gen bump, no
                # join event — the membership never changed); the new
                # connection supersedes the dead one (serial bump), so
                # the old connection's pending EOF sweep is inert
                st = self.slots.get(int(want))
                if st is not None and st.status == ACTIVE and \
                        st.incarnation == int(meta.get("inc", -1)):
                    st.last_beat = time.monotonic()
                    st.suspect_at = None
                    st.conn_serial += 1
                    tevents.emit("cluster_worker_resume",
                                 slot=int(want),
                                 incarnation=st.incarnation)
                    tevents.counter("cluster.worker_resumes")
                    self._cond.notify_all()
                    welcome = self._welcome_meta(int(want), st)
                    welcome["resume"] = True
                    # NO center payload: a resumed worker keeps its
                    # local state (it re-pushes / re-pulls as its own
                    # loop dictates) — shipping the model here would
                    # tax every reconnect on the recovery hot path
                    # only to be discarded
                    return ("welcome", welcome, {})
                if meta.get("resume_only"):
                    # a best-effort frame's reconnect (the bye): the
                    # incarnation is gone and a FRESH admission would
                    # be a ghost slot nobody drives — commits would
                    # stall on it until the heartbeat timeout and the
                    # spurious join/leave would change the membership
                    # digest of a run that recovered correctly
                    return ("error", {"error": "incarnation gone — "
                                               "resume-only join "
                                               "refused"}, {})
                # fencing moved on (declared dead during the outage):
                # fall through to a fresh admission — the worker
                # resets to the new admission window
            slot = None
            if want is not None and int(want) in self.slots and \
                    self.slots[int(want)].status != ACTIVE:
                slot = int(want)
            else:
                for i in sorted(self.slots):
                    if self.slots[i].status != ACTIVE:
                        slot = i
                        break
            if slot is None:
                return ("error", {
                    "error": f"all {self.cfg.n_slots} slots active — "
                             f"grow --workers to admit more"}, {})
            prev_active = sum(s.status == ACTIVE
                              for s in self.slots.values())
            # a launcher-pinned admission window makes the rejoin's
            # position in the event sequence plan-determined; an
            # unsolicited join starts at the first uncommitted window
            admit = max(self.version,
                        int(meta.get("admit_at") or self.version))
            admit = min(admit, max(0, self.cfg.n_windows - 1))
            inc = self._next_incarnation
            self._next_incarnation += 1
            st = self.slots[slot] = SlotState(
                status=ACTIVE, admit=admit, incarnation=inc,
                last_beat=time.monotonic(),
                delivered=admit - 1)
            self.gen += 1
            self.events.append(("join", slot, admit, self.gen))
            # the admission + incarnation grant go durable BEFORE the
            # welcome leaves: a recovered coordinator must keep
            # fencing the tokens it already handed out
            self._wal_append("admit", {"slot": slot, "admit": admit,
                                       "incarnation": inc,
                                       "gen": self.gen})
            tevents.emit("cluster_join", slot=slot, gen=self.gen,
                         window=admit)
            tevents.counter("cluster.joins")
            self._emit_membership(
                "rejoin" if meta.get("rejoin") else "join",
                prev_active)
            self._try_commit()
            return ("welcome", self._welcome_meta(slot, st),
                    self.ps.snapshot())

    def _handle_skip(self, meta) -> tuple:
        window = int(meta["window"])
        with self._lock:
            st = self._fenced(meta)
            if st is None:
                return ("error", {"error": "stale slot"}, {})
            already = window in st.skips or window <= st.delivered
            st.skips.add(window)
            st.delivered = max(st.delivered, window)
            # the announced skip goes durable BEFORE its ack: the ack
            # releases the worker into its straggle, and a recovered
            # coordinator must still expect the aged delivery instead
            # of stalling the window's commit on a skip nobody will
            # re-announce (a RE-announced skip — the ack was lost to
            # the crash — is deduped here: replay already holds it)
            if not already:
                self._wal_append("skip", {"slot": int(meta["slot"]),
                                          "inc": st.incarnation,
                                          "window": window})
            # (no cluster.skips bump here: the WORKER owns that
            # counter — in thread mode both sides share one sink and
            # the merged report would double-count; the server-side
            # story is cluster.skipped_deliveries at commit time)
            self._try_commit()
            return ("ok", self._status_meta(), {})

    def _decode_delta(self, arrays: dict) -> dict:
        """A pushed contribution's dense reconstruction: identity in
        dense mode; under a wire codec the exact host decode (int8 ->
        int32 widening before the one scale multiply, topk scatter-
        add) against the model's known center layout. The WAL and the
        idempotence digests see the COMPRESSED bytes — this decode is
        a pure function of them, so replay stays bitwise. A rowstore-
        mode push's ``{leaf}.rows`` index arrays ride AROUND the codec
        (they are exact int64 structure, not compressible values, and
        their ``{leaf}.``-prefixed names would otherwise be mistaken
        for codec parts) and re-attach to the decoded delta for the
        PS's row-wise merge."""
        if self._codec is None:
            return arrays
        rows = {k: v for k, v in arrays.items()
                if k.endswith(psmod.ROWS_SUFFIX)}
        vals = {k: v for k, v in arrays.items()
                if not k.endswith(psmod.ROWS_SUFFIX)}
        out = pcomms.decode_tree(self._codec, vals,
                                 self._center_template)
        out.update(rows)
        return out

    def _pull_reply(self, slot: int, window: int, have) -> tuple:
        """Lock held. The deferred push-ack's pull payload for a push
        of ``window`` from ``slot``. Dense mode ships the live center
        snapshot (the pre-compression contract, bit-for-bit). Under a
        wire codec the reply is VERSION-PINNED to the push's own
        commit (``cv = window + 1``) and ships the compressed delta
        ``center@cv − center@have`` (seeded by (slot, have, cv), so a
        recovered coordinator re-serves identical bytes); a ``have``
        outside the PS history falls back to a dense version-pinned
        snapshot — the resume/rejoin path — and every
        :data:`PULL_REFRESH_WINDOWS`-th commit ships dense ON
        SCHEDULE, bounding the pull-noise random walk in the worker's
        cached view."""
        if self._codec is None:
            return ("center", self._status_meta(), self.ps.snapshot())
        cv = window + 1
        refresh = self.cfg.pull_refresh_windows
        if have is not None and int(have) < cv \
                and cv % refresh:
            delta = self.ps.delta_since(int(have), cv)
            if delta is not None:
                arrays, _ = pcomms.encode_tree(
                    self._pull_codec, delta, None,
                    PULL_SEED_TAG, slot, int(have), cv)
                meta = self._status_meta()
                meta.update(mode="delta", cv=cv, have=int(have))
                tevents.counter("cluster.delta_pulls")
                return ("center", meta, arrays)
        meta = self._status_meta()
        meta["mode"] = "dense"
        # pin the fallback to the OLDEST history version >= cv, never
        # the live clock: a peer's concurrent commit (a WAL-replayed
        # skip can release a window this slot never re-delivers) may
        # already have advanced self.version, and an arrival-timed cv
        # would make the worker's next push base — and so the
        # decay^age merge weights — scheduler-dependent, breaking the
        # plan-determined replay contract exactly on the recovery
        # path it exists for
        newer = sorted(v for v in self.ps.history if v >= cv)
        if newer:
            meta["cv"] = newer[0]
            snap = self.ps.history[newer[0]]
        else:   # no history at all (dense-depth 0 cannot reach here)
            meta["cv"] = self.version
            snap = self.ps.snapshot()
        if not cv % refresh:
            tevents.counter("cluster.pull_refreshes")
        else:
            tevents.counter("cluster.pull_dense_fallbacks")
        return ("center", meta, snap)

    def _handle_push(self, meta, arrays) -> tuple:
        window = int(meta["window"])
        base = int(meta["base"])
        with self._cond:
            st = self._fenced(meta)
            if st is None:
                return ("error", {"error": "stale slot"}, {})
            if window < self.version:
                # re-delivery of an ALREADY-COMMITTED window: the
                # commit record went durable but the coordinator died
                # before the deferred ack left, so the worker pushed
                # again after reconnecting. Idempotent by the WAL's
                # commit digest: the same bytes were already merged —
                # ack with the window's own pull reply, apply nothing.
                want = self.commit_digests.get(
                    (window, int(meta["slot"])))
                if want is not None and \
                        want != walmod.delta_digest(arrays):
                    return ("error", {
                        "error": f"non-idempotent re-delivery for "
                                 f"window {window}: delta digest "
                                 f"mismatch vs the committed record "
                                 f"— refusing to double-apply"}, {})
                tevents.counter("cluster.dedup_pushes")
                return self._pull_reply(int(meta["slot"]), window,
                                        meta.get("have"))
            st.pushes[window] = (base, dict(arrays))
            st.delivered = max(st.delivered, window)
            # (no cluster.pushes bump: the worker owns it — see skip)
            self._try_commit()
            # the DEFERRED ack: reply once this window has merged —
            # the pull piggybacks the post-commit center, and the
            # worker's next base version is plan-determined instead of
            # arrival-order-determined (the determinism contract)
            while (self.version <= window and not self.done
                   and self.aborted is None
                   and self._fenced(meta) is st
                   and not self._stop.is_set()):
                self._cond.wait(timeout=0.2)
            if self._fenced(meta) is not st:
                return ("error", {"error": "declared dead while "
                                           "awaiting commit"}, {})
            return self._pull_reply(int(meta["slot"]), window,
                                    meta.get("have"))

    def _handle_bye(self, meta) -> tuple:
        slot = int(meta["slot"])
        with self._lock:
            st = self._fenced(meta)
            if st is not None:
                self.worker_stats[slot] = dict(meta.get("stats") or {})
                self._record_worker_counters(slot)
                self._wal_append("bye", {
                    "slot": slot,
                    "stats": self.worker_stats[slot]})
                if self.done or st.delivered >= self.cfg.n_windows - 1:
                    # graceful departure: end-of-run, or a worker that
                    # already delivered (pushed or skipped) everything
                    # it owes and finished its last window before the
                    # peers' final pushes commit — a DEATH here would
                    # make the membership sequence race wall clock,
                    # and under the restart policy would abort a
                    # healthy completing run
                    st.status = FREE
                    self._try_commit()
                    self._cond.notify_all()
                else:
                    self._death(slot, "graceful leave")
            return ("ok", self._status_meta(), {})

    def _record_worker_counters(self, slot: int) -> None:
        stats = self.worker_stats.get(slot) or {}
        ms = stats.get("push_pull_ms_total")
        n = stats.get("pushes")
        if ms is not None:
            tevents.counter("cluster.push_pull_ms",
                            int(round(float(ms))))
        if n:
            tevents.counter("cluster.worker_pushes", int(n))

    # ------------------------------------------------ death & commits

    def _death(self, slot: int, reason: str) -> None:
        """Lock held. Membership leave + generation bump; the commit
        that was blocked on this worker proceeds without it."""
        st = self.slots[slot]
        if st.status != ACTIVE or self.killed:
            return
        prev_active = sum(s.status == ACTIVE
                          for s in self.slots.values())
        st.status = DEAD
        self.gen += 1
        window = max(st.delivered, st.admit - 1) + 1
        self.events.append(("leave", slot, window, self.gen, reason))
        self._wal_append("leave", {"slot": slot, "window": window,
                                   "gen": self.gen,
                                   "reason": reason})
        tevents.emit("cluster_leave", slot=slot, gen=self.gen,
                     reason=reason, delivered=st.delivered)
        tevents.counter("cluster.leaves")
        self._emit_membership(f"leave:{reason}", prev_active)
        if self.cfg.policy == "restart" and not self.done:
            self._abort(f"worker {slot} died ({reason}); restart "
                        f"policy aborts for a full respawn")
            return
        self._try_commit()
        self._cond.notify_all()

    def _abort(self, reason: str) -> None:
        """Lock held. The restart-policy exit. Deliberately NO
        checkpoint here: the gang-scheduled baseline restarts from the
        last PERIODIC save and re-pays every window since — exactly
        the progress loss the elastic policy exists to avoid (an
        abort-time save would quietly gift the baseline lossless
        restarts and flatter the measured speedup's denominator)."""
        self.aborted = reason
        tevents.emit("cluster_abort", reason=reason,
                     version=self.version)
        self._cond.notify_all()

    def _expected(self, window: int) -> list[int]:
        return [i for i in sorted(self.slots)
                if self.slots[i].status == ACTIVE
                and self.slots[i].admit <= window]

    def _try_commit(self) -> None:
        """Lock held. Drain every committable window: all expected
        workers have pushed-or-skipped it (and any admission hold is
        satisfied); apply pushes in slot order; bump the clock."""
        while self.version < self.cfg.n_windows and not self.done \
                and self.aborted is None and not self.killed:
            w = self.version
            need = self.hold_at.get(w)
            expected = self._expected(w)
            if need is not None and len(expected) < need:
                return                       # admission hold
            if not expected:
                return                       # quorumless: wait for a join
            if any(w not in self.slots[i].pushes
                   and w not in self.slots[i].skips
                   for i in expected):
                return
            # the seeded coordinator fault lands HERE — every push for
            # w is buffered in RAM, the commit record is not yet
            # durable: a kill exercises the rollback path (the window
            # re-runs from its pushes on reconnect), a hang freezes
            # the commit the workers are all waiting on
            if w < self._coord_sched.shape[0] and \
                    self._coord_sched[w] and \
                    w not in self._coord_fired:
                self._coord_fired.add(w)
                cell = float(self._coord_sched[w])
                if cell == COORD_KILL:
                    tevents.emit("cluster_coordinator_kill",
                                 window=w)
                    self._die()       # never returns (or raises)
                time.sleep(cell)      # the frozen-coordinator cell
                # the freeze held the state lock, so every beat
                # handler was parked and last_beat is uniformly
                # stale: restart the liveness clock (same semantics
                # as recovery) — otherwise an unfairly-scheduled
                # heartbeat scan could declare healthy workers dead
                # the moment the lock frees, making the digest
                # timing-dependent
                now_ = time.monotonic()
                for st_ in self.slots.values():
                    if st_.status == ACTIVE:
                        st_.last_beat = now_
                        st_.suspect_at = None
            contribs = []
            skipped = []
            for i in sorted(self.slots):     # dead workers' buffered
                st = self.slots[i]           # pushes still count: they
                if w in st.pushes:           # delivered before dying
                    base, delta = st.pushes.pop(w)
                    contribs.append((i, base, delta))
                elif w in st.skips:
                    st.skips.discard(w)
                    skipped.append(i)
            # WRITE-AHEAD: the commit record (slot-ordered contribution
            # digests + the delta bytes — a redo log) goes durable
            # BEFORE the merge mutates the center and BEFORE any
            # deferred push-ack observes the new version; a crash on
            # either side of this line is recoverable (before: the
            # window rolls back invisibly; after: replay re-applies
            # the record and re-pushes dedupe against its digests)
            wal_meta = {
                "window": w,
                "contribs": [
                    {"slot": i, "base": b,
                     "age": max(0, w - int(b)),
                     "digest": walmod.delta_digest(d)}
                    for i, b, d in contribs],
                "skipped": skipped,
                "version": w + 1,
            }
            self._wal_append(
                "commit", wal_meta,
                {f"{i}/{k}": v for i, _b, d in contribs
                 for k, v in d.items()})
            for c in wal_meta["contribs"]:
                self.commit_digests[(w, c["slot"])] = c["digest"]
            # the seeded PS-SHARD fault lands HERE — the commit record
            # IS durable but the merge has not applied: a kill
            # exercises the WAL's REDO half (recovery replays the
            # record and re-applies the logged deltas; the coordinator
            # cell above covers the rollback half), a hang freezes the
            # shard merge everyone is waiting on
            if w < self._ps_sched.shape[0] and \
                    self._ps_sched[w] and \
                    w not in self._ps_fired:
                self._ps_fired.add(w)
                cell = float(self._ps_sched[w])
                if cell == COORD_KILL:
                    tevents.emit("cluster_ps_kill", window=w)
                    self._die()       # never returns (or raises)
                time.sleep(cell)      # the frozen-shard cell: same
                #                       liveness-clock reset as the
                #                       coordinator freeze above
                now_ = time.monotonic()
                for st_ in self.slots.values():
                    if st_.status == ACTIVE:
                        st_.last_beat = now_
                        st_.suspect_at = None
            # the WAL carried the COMPRESSED payload bytes (the redo
            # log replays bitwise); the exact host decode happens
            # here, strictly after durability, in slot order
            records = self.ps.merge(
                w, [(i, b, self._decode_delta(d))
                    for i, b, d in contribs])
            self.version = w + 1
            if self.recovered and self.first_recommit_at is None:
                self.first_recommit_at = time.monotonic()
            self.events.append((
                "merge", w,
                tuple((r["slot"], r["age"]) for r in records),
                tuple(skipped)))
            tevents.emit("cluster_merge", window=w,
                         applied=records, skipped=skipped,
                         n_active=len(expected))
            tevents.counter("cluster.merges")
            tevents.counter("cluster.deliveries", len(records))
            tevents.counter("cluster.skipped_deliveries",
                            len(skipped))
            if records:
                tevents.gauge(
                    "cluster.max_staleness",
                    max(r["age"] for r in records))
            self._checkpoint()
            if self.version >= self.cfg.n_windows:
                self.done = True
                self._wal_append("done", {"version": self.version})
                self._checkpoint(force=True)
                tevents.emit("cluster_done", version=self.version,
                             gen=self.gen)
            self._cond.notify_all()

    def _checkpoint(self, force: bool = False) -> None:
        """Lock held. Durable center save through the shared
        checkpoint machinery (CRC footer, atomic rename, prune), then
        the WAL rotates onto the new durable center: a fresh segment
        opens with the control-state snapshot and segments older than
        the oldest KEPT checkpoint are deleted — the configured-
        cadence truncation that keeps the ledger O(windows since last
        save), while a quarantined-corrupt newest checkpoint can still
        fall back and roll forward from the older segments."""
        if not self.cfg.checkpoint_dir:
            return
        if not force and (self.version == 0
                          or self.version % self.cfg.checkpoint_every):
            return
        from tpu_distalg_torch.utils import checkpoint as ckpt

        ckpt.save(self.cfg.checkpoint_dir, self._tag, [], self.version,
                  extra={f"{_CENTER}{k}": v
                         for k, v in self.ps.snapshot().items()})
        ckpt.prune(self.cfg.checkpoint_dir, keep=3)
        if self.wal is not None:
            kept = ckpt.list_steps(self.cfg.checkpoint_dir)
            self.wal.rotate(self.version, self._snapshot_control(),
                            keep_base=min(kept) if kept else None)
        tevents.emit("checkpoint_saved", step=self.version,
                     tag=self._tag)
        tevents.counter("checkpoints_saved")
