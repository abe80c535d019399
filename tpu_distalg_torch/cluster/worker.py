"""Worker process — the existing SGD-family trainers behind push/pull.

Port of ``tpu_distalg/cluster/worker.py``: the same protocol, the same
schedules and the same frames, with the port's trainers on the device
the worker is given (``run_worker(..., device=)``, ``cuda`` unless told
``cpu``). The device is initialised through
``telemetry.supervisor.init_backend`` BEFORE the worker dials the
coordinator, so the slow part of a first CUDA call never eats into the
heartbeat timeout that starts at the join; after the welcome the order
is the JAX package's (trainer, then heartbeat).

A worker owns one SLOT of the cluster's data (a contiguous row block
of the coordinator-described task), builds its OWN local mesh
(``get_mesh(data=1)`` on its device), and runs the EXISTING
trainers' window loops — ``ssgd.make_train_fn`` (per-tick
minibatch SGD) or ``local_sgd.make_train_fn`` (the MA-family local
rounds) — between push/pull seams: at each window boundary it pushes
its accumulated center delta (``w_local − w_base``) with the base
version it trained against, and the deferred ack returns the
post-commit center it adopts next. Staleness weighting happens at the
PS (``decay**age``); the worker's only clock duty is the GATE: it may
not start window ``k`` until ``k − version ≤ s`` (the cross-process
spelling of ``parallel/ssp.py``'s conservative bound).

Fault schedule (plan-pure, like ``ssp.compile_straggle_schedule``):
:func:`compile_worker_schedule` probes ``cluster:worker`` once per
(window, slot) cell in row-major order against a fresh quiet registry
— the same plan compiles the same schedule in every process, which is
what makes a chaos run replayable. Cell kinds:

  * ``straggle:u`` — the worker announces a SKIP for the window at its
    START (so peers' commit never waits on the interference), then
    pays ``u`` units of real compute (``ssp.straggle_work``) on top of
    the window's ticks; its delta rides a later boundary, staler.
  * ``kill`` — the worker runs HALF the window's ticks and then
    ``kill -9``\\ s itself (``os.kill(getpid(), SIGKILL)``); in thread
    mode the injected ``die`` slams the sockets instead, which is the
    same observable (EOF at the coordinator).

Liveness: a ``telemetry/heartbeat.py`` ``Heartbeat`` thread beats over
a SECOND connection (``emit_fn`` both records the event and sends the
frame), so a worker wedged in compute is still visibly alive and a
partitioned one goes visibly silent. The beat loop survives transient
send failures: a broken heartbeat connection is re-dialed with a
short bounded retry (``cluster.heartbeat_retries``) instead of
leaving the socket dead while the main loop lives.

COMPRESSED WIRE (``--comm int8[:seed]``/``topk[:frac]``, from the
welcome frame): the window delta is host-encoded BEFORE transport
framing (``parallel/comms.py`` codecs — seeded per (slot, window), so
replays are bitwise), with the error-feedback residual carried in
THIS loop's state: what the wire did not carry rides into the next
window's encode, and a fresh re-admission (reset) zeroes it with the
rest of the local state. Pulls are version deltas: the worker caches
``center@have`` and the deferred ack ships only the compressed diff
to the push's own commit version (dense snapshot on rejoin/deep
recovery). Unless ``@seq``, the push runs ASYNCHRONOUSLY on a
background sender over a second crash-tolerant :class:`_Link`, so
the next window's ticks start immediately; the next boundary
harvests the ack and REBASES the local weights onto the fresher
center (stale-model SSP — the gate's ``window − version ≤ s`` bound
is unchanged, because the version still only advances at commit).

RECONNECT (coordinator crash tolerance): ``TransportClosed``/
``TransportTimeout`` on the control connection no longer kills the
worker. :class:`_Link` wraps every control-plane round trip in a
bounded retry/backoff/jitter loop (``telemetry.supervisor.supervised``
— the same generalized core behind backend init and checkpoint
writes): it re-dials, re-presents its slot + incarnation token
(``resume`` join), and re-sends the request. A recovered coordinator
re-admits a matching incarnation WITHOUT burning a membership epoch;
a push whose window was committed before the crash (the ack died with
the coordinator) is deduped by the WAL's commit digest, and a push
whose window was rolled back simply re-delivers — either way the
worker cannot tell a recovered coordinator from one that never died,
which is the whole determinism story. Only if the coordinator
declared this incarnation dead during the outage does the worker get
a FRESH admission (a ``reset``): it adopts the new center at the new
admission window, exactly like a replacement process would.
"""

from __future__ import annotations

import os
import signal
import threading
import time

import numpy as np

from tpu_distalg_torch.cluster import transport
from tpu_distalg_torch.faults import registry as fregistry
from tpu_distalg_torch.parallel import comms as pcomms
from tpu_distalg_torch.parallel import ssp as pssp
from tpu_distalg_torch.telemetry import events as tevents
from tpu_distalg_torch.telemetry import heartbeat as theartbeat
from tpu_distalg_torch.telemetry.supervisor import init_backend, supervised
from tpu_distalg_torch.tune import defaults as tune_defaults

#: per-slot sampling-seed stride: slots draw independent minibatches
SLOT_SEED_STRIDE = 1_000_003
#: how long the gate polls before giving up on a wedged coordinator
GATE_DEADLINE_SECONDS = 300.0
GATE_POLL_SECONDS = 0.02

#: schedule cell code for a kill (straggle cells hold their +units)
KILL = -1

#: control-connection reconnect budget: retries × capped backoff must
#: comfortably cover a coordinator respawn (process spawn + checkpoint
#: restore + WAL replay + bind) — exhaustion is a real outage
RECONNECT_RETRIES = 20
RECONNECT_BACKOFF_SECONDS = 0.1
RECONNECT_BACKOFF_CAP_SECONDS = 1.0
RECONNECT_JITTER = 0.25


class LinkClosed(RuntimeError):
    """The link was closed on purpose (worker shutdown / kill cell):
    NOT a transport fault, so the retry loop never re-dials — a
    background pusher outliving a thread-mode kill must not
    resume-join and resurrect the slot."""


class _Link:
    """The worker's control connection with crash-tolerant round
    trips: every request retries through re-dial + resume-join on a
    closed/timed-out transport, with bounded exponential backoff +
    jitter. A resume that comes back as a FRESH admission (the
    coordinator declared this incarnation dead during the outage)
    surfaces as a synthetic ``("reset", welcome, center)`` reply the
    main loop adopts like a new join."""

    def __init__(self, host, port, sock, connect, ident, rpc_deadline,
                 stats, log):
        self.host, self.port = host, port
        self.sock = sock
        self.connect = connect
        self.ident = ident          # shared with the caller: a fresh
        #                             admission swaps the token in place
        self.rpc_deadline = rpc_deadline
        self.stats = stats
        self.log = log
        self.closed = False
        self._pending_reset = None

    def drop(self):
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def close(self):
        self.closed = True
        self.drop()

    def _resume(self, *, dial_attempts: int = 200,
                resume_only: bool = False):
        """Re-dial and re-present the incarnation token. Sets
        ``_pending_reset`` when the coordinator hands out a fresh
        admission instead of a resume; ``resume_only`` forbids that
        fallback (the bye's mode — a dead incarnation's farewell must
        not be answered with a GHOST admission nobody will drive)."""
        # fine-grained dial: the recovery metric is detect→recover→
        # first-recommitted-window, and a coarse retry sleep here
        # would put its floor at the sleep, not at the real respawn
        sock = self.connect(self.host, self.port,
                            attempts=dial_attempts,
                            retry_sleep=0.05)
        try:
            k, m, arrs = transport.request(
                sock, "join",
                {"slot": self.ident["slot"], "inc": self.ident["inc"],
                 "resume": True, "rejoin": True,
                 "resume_only": resume_only},
                deadline=self.rpc_deadline)
        except transport.TransportError:
            try:
                sock.close()
            except OSError:
                pass
            raise
        if k != "welcome":
            try:
                sock.close()
            except OSError:
                pass
            raise transport.TransportClosed(
                f"resume-join rejected: {m.get('error', k)}")
        self.sock = sock
        self.stats["reconnects"] += 1
        tevents.counter("cluster.reconnects")
        tevents.emit("cluster_worker_reconnect",
                     slot=self.ident["slot"],
                     resumed=bool(m.get("resume")))
        if m.get("resume"):
            return
        # fencing moved on: fresh incarnation, fresh admission — the
        # old incarnation's unpushed work is dropped, like a dead
        # worker's would be
        self.ident["inc"] = int(m["incarnation"])
        self.stats["readmissions"] += 1
        tevents.counter("cluster.readmissions")
        self._pending_reset = (dict(m), dict(arrs))

    def request(self, kind, meta, arrays=None, *, deadline=None,
                retries=RECONNECT_RETRIES):
        """One crash-tolerant round trip; may return the synthetic
        ``reset`` reply instead of the requested one. ``retries``
        trims the whole budget for best-effort frames — the re-dial
        inside the retry shrinks with it, so a bye against a
        coordinator that already exited fails in seconds, not
        minutes — and a trimmed-budget frame is also RESUME-ONLY (a
        farewell must never be answered with a fresh admission)."""
        deadline = deadline if deadline is not None \
            else self.rpc_deadline
        best_effort = retries < RECONNECT_RETRIES

        def attempt():
            if self.closed:
                raise LinkClosed("link closed — no further round "
                                 "trips (worker shutting down)")
            if self.sock is None:
                self._resume(
                    dial_attempts=20 if best_effort else 200,
                    resume_only=best_effort)
                if self._pending_reset is not None:
                    m, arrs = self._pending_reset
                    self._pending_reset = None
                    return ("reset", m, arrs)
            try:
                return transport.request(self.sock, kind, meta,
                                         arrays, deadline=deadline)
            except (transport.TransportClosed,
                    transport.TransportTimeout):
                self.drop()
                raise

        return supervised(
            attempt, phase="cluster_rpc",
            retries=retries,
            backoff=RECONNECT_BACKOFF_SECONDS,
            backoff_cap=RECONNECT_BACKOFF_CAP_SECONDS,
            jitter=RECONNECT_JITTER,
            retry_on=(transport.TransportClosed,
                      transport.TransportTimeout),
            event="cluster_reconnect",
            failure_counter="cluster.rpc_failures",
            log=self.log)


class _HbLink:
    """The heartbeat connection with transient-failure survival: a
    failed beat drops + re-dials the socket with a short in-beat
    retry and bumps ``cluster.heartbeat_retries`` — the beat thread
    itself never dies of an I/O error (the main loop may be healthy
    and compute-bound; a silently dead beat loop would get it
    declared dead by the coordinator's heartbeat scan)."""

    RETRIES = 2

    def __init__(self, host, port, connect, ident, deadline, stats):
        self.host, self.port = host, port
        self.connect = connect
        self.ident = ident
        self.deadline = deadline
        self.stats = stats
        self.sock = None
        self.lock = threading.Lock()

    def _drop(self):
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def beat(self) -> None:
        with self.lock:
            for attempt in range(self.RETRIES + 1):
                try:
                    if self.sock is None:
                        # short-fused dial: a beat must not wedge the
                        # beat thread for the full connect budget —
                        # the NEXT interval retries anyway
                        self.sock = self.connect(
                            self.host, self.port, attempts=2,
                            retry_sleep=0.05)
                    # tda: ignore[TDA112] -- the beat is a pure
                    # liveness signal on its own link; the reply is
                    # drained only to keep the socket frame-aligned,
                    # and a stale-slot error must not kill the beat
                    # thread — the MAIN link surfaces fencing on the
                    # next rpc
                    transport.send_frame(self.sock, "beat",
                                         dict(self.ident),
                                         deadline=self.deadline)
                    transport.recv_frame(self.sock,
                                         deadline=self.deadline)
                    return
                except (transport.TransportError, OSError):
                    self._drop()
                    self.stats["heartbeat_retries"] += 1
                    tevents.counter("cluster.heartbeat_retries")
                    if attempt < self.RETRIES:
                        time.sleep(0.05 * (attempt + 1))
            # still down after the in-beat retries: stay alive — the
            # next interval's beat re-dials again

    def close(self):
        with self.lock:
            self._drop()


class _DonePush:
    """An already-completed push round trip wearing the
    :class:`_PendingPush` interface, so the synchronous (``@seq`` /
    dense) path folds its ack through the SAME ``harvest`` code as
    the overlapped one — one implementation of the deferred-ack
    contract, no drift between the two spellings."""

    def __init__(self, window: int, base: int, result, rtt_ms: float):
        self.window = window
        self.base = base
        self.rtt_ms = rtt_ms
        self._result = result

    def wait(self):
        return self._result


class _PendingPush:
    """One in-flight push: the full crash-tolerant round trip (send →
    deferred commit → pull reply) runs on a background thread over a
    DEDICATED link, so the next window's ticks start immediately —
    the push/pull overlap. ``rtt_ms`` is measured inside the thread
    (send to reply), so the reported push→commit→pull latency never
    absorbs the overlapped compute. At most one is in flight: the
    next boundary harvests it before sending again, which keeps the
    SSP gate's bound the only staleness authority."""

    def __init__(self, link: _Link, window: int, base: int,
                 meta: dict, arrays: dict, deadline: float):
        self.window = window
        self.base = base
        self.rtt_ms = 0.0
        self._lock = threading.Lock()
        self._result = None
        self._error: BaseException | None = None

        def _send():
            t0 = time.monotonic()
            try:
                # tda: ignore[TDA112] -- the async push's reply is
                # consumed by harvest(), which raises on an error
                # reply; this sender closure only parks it
                reply = link.request("push", meta, arrays,
                                     deadline=deadline)
                with self._lock:
                    self._result = reply
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                with self._lock:
                    self._error = e
            finally:
                with self._lock:
                    self.rtt_ms = (time.monotonic() - t0) * 1e3

        self._t = threading.Thread(
            target=_send, name="tda-cluster-push", daemon=True)
        self._t.start()

    def wait(self):
        self._t.join()
        with self._lock:
            if self._error is not None:
                raise self._error
            return self._result


class WorkerKilled(Exception):
    """Thread-mode stand-in for SIGKILL (the real worker never raises
    this — it is gone)."""


def compile_worker_schedule(n_windows: int, n_slots: int, *,
                            plan=None) -> np.ndarray:
    """The (n_windows, n_slots) int32 cluster fault schedule from the
    plan's ``cluster:worker`` rules: cell > 0 = straggle units, cell
    == -1 = kill. One probe per cell in row-major order against a
    FRESH quiet registry (a pure function of the plan — every process
    compiles the identical schedule); fires mirror into the live
    ledger exactly once, like the SSP compilers."""
    live = fregistry.active()
    if plan is None:
        plan = live.plan if live is not None else None
    out = np.zeros((n_windows, n_slots), np.int32)
    if plan is None or not any(
            r.point == "cluster:worker" for r in plan.rules):
        return out
    reg = fregistry.FaultRegistry(plan, quiet=True)
    for w in range(n_windows):
        for k in range(n_slots):
            hit = reg.probe("cluster:worker")
            if hit is None:
                continue
            kind, arg = hit
            if kind == "kill":
                out[w, k] = KILL
            else:
                out[w, k] = int(arg if arg is not None
                                else fregistry.DEFAULT_STRAGGLE_UNITS)
    if live is not None and live.plan == plan:
        live.record(reg.fired)
    return out


def strip_kills(plan_spec: str | None,
                points: tuple[str, ...] = ("cluster:worker",)
                ) -> str | None:
    """The plan with its KILL rules at ``points`` removed — what a
    respawned incarnation runs under (the fault was transient: a
    restarted executor — or a recovered coordinator, with
    ``points=('cluster:coordinator',)`` — re-dying on the same
    deterministic cell would loop forever, in both the elastic and
    the restart-baseline arms)."""
    if not plan_spec:
        return plan_spec
    plan = fregistry.FaultPlan.parse(plan_spec)
    rules = tuple(r for r in plan.rules
                  if not (r.point in points and r.kind == "kill"))
    return fregistry.FaultPlan(seed=plan.seed, rules=rules).spec()


def _slot_rows(task: dict, slot: int, n_slots: int):
    """This slot's contiguous row block of the shared synthetic task
    (the whole-task generation is deterministic in the data seed, so
    every incarnation of a slot sees identical rows)."""
    from tpu_distalg_torch.utils import datasets

    n_rows = int(task["n_rows"])
    X, y = datasets.synthetic_two_class(
        n_rows + int(task["test_rows"]), int(task["n_features"]),
        seed=int(task["data_seed"]))
    X = datasets.add_bias_column(X)
    per = -(-n_rows // n_slots)
    lo = min(slot * per, n_rows)
    hi = min(lo + per, n_rows)
    if hi <= lo:
        raise ValueError(
            f"slot {slot} owns no rows: {n_rows} rows over "
            f"{n_slots} slots")
    return (np.ascontiguousarray(X[lo:hi]),
            np.ascontiguousarray(y[lo:hi]))


class LocalTrainer:
    """One slot's window loops over the EXISTING trainers, on a
    one-shard mesh on the worker's device. ``run(w, window, n_ticks)``
    executes ``n_ticks`` local ticks starting at the window's absolute
    first tick and returns the new local weights (a host float32 array,
    read after the device is done)."""

    def __init__(self, task: dict, slot: int, n_slots: int, s: int,
                 device=None):
        import torch

        from tpu_distalg_torch.parallel import get_mesh

        self.s = s
        self.slot = slot
        self.algo = task.get("algo", "ssgd")
        X, y = _slot_rows(task, slot, n_slots)
        self.mesh = get_mesh(data=1, device=device)
        dev = self.device = self.mesh.device
        self.X = torch.as_tensor(X, device=dev)
        self.y = torch.as_tensor(y, device=dev)
        self.valid = torch.ones((X.shape[0],), dtype=torch.float32,
                                device=dev)
        d = X.shape[1]
        self.dummy_te = (torch.zeros((1, d), dtype=torch.float32,
                                     device=dev),
                         torch.zeros((1,), dtype=torch.float32,
                                     device=dev))
        seed = int(task["seed"]) + SLOT_SEED_STRIDE * slot
        self._fns: dict[int, object] = {}
        if self.algo == "local_sgd":
            from tpu_distalg_torch.models import local_sgd as lsgd

            def make(n_ticks):
                cfg = lsgd.LocalSGDConfig(
                    n_iterations=1, n_local_iterations=n_ticks,
                    eta=float(task["eta"]),
                    mini_batch_fraction=float(
                        task["mini_batch_fraction"]),
                    seed=seed, eval_test=False)
                return lsgd.make_train_fn(self.mesh, cfg,
                                          X.shape[0])
        elif self.algo == "ssgd":
            from tpu_distalg_torch.models import ssgd

            def make(n_ticks):
                cfg = ssgd.SSGDConfig(
                    n_iterations=n_ticks, eta=float(task["eta"]),
                    mini_batch_fraction=float(
                        task["mini_batch_fraction"]),
                    lam=float(task["lam"]),
                    reg_type=task.get("reg_type", "l2"),
                    seed=seed, eval_test=False)
                return ssgd.make_train_fn(self.mesh, cfg, X.shape[0])
        else:
            raise ValueError(
                f"unknown cluster algo {self.algo!r}: 'ssgd' or "
                f"'local_sgd'")
        self._make = make

    def run(self, w: np.ndarray, window: int, n_ticks: int
            ) -> np.ndarray:
        import torch

        if n_ticks not in self._fns:
            self._fns[n_ticks] = self._make(n_ticks)
        fn = self._fns[n_ticks]
        w_t = torch.as_tensor(np.asarray(w, np.float32),
                              device=self.device)
        if self.algo == "local_sgd":
            # one MA round of n_ticks local steps; t0 = the absolute
            # ROUND id (the round scan's sampling key unit)
            w_out, _ws, _delta, _accs = fn(
                self.X, self.y, self.valid, *self.dummy_te,
                w_t, w_t[None, :], torch.zeros_like(w_t), t0=window)
        else:
            # absolute tick ids thread the PRNG, so a window replay
            # (or a respawned incarnation) samples identically
            w_out, _accs = fn(self.X, self.y, self.valid,
                              *self.dummy_te, w_t,
                              t0=window * self.s)
        # .cpu() waits for the device
        return w_out.cpu().numpy().astype(np.float32, copy=False)

    def straggle(self, units: int) -> None:
        """Pay real interference compute on the worker's device
        (``parallel/ssp.straggle_work``: ``csrc/ssp.cu`` on the card),
        and wait for it."""
        import torch

        pssp.straggle_work(torch.tensor(
            [units * 50], dtype=torch.int32, device=self.device),
            1.0).cpu()


def _default_die():
    os.kill(os.getpid(), signal.SIGKILL)


def run_worker(host: str, port: int, *, slot: int | None = None,
               rejoin: bool = False, admit_at: int | None = None,
               die=None, connect=None, logger=None,
               device=None) -> dict:
    """The worker main loop: join → (gate → train window → push/skip)*
    → bye. Returns its stats dict (the real process also reports them
    in the ``bye`` frame and via its telemetry dir). ``die`` overrides
    the kill-cell action for thread-mode tests (default: a real
    ``SIGKILL`` on this process); ``connect`` overrides the dialer
    (thread mode tracks its sockets through it). ``admit_at`` pins a
    rejoiner's first window (the launcher's plan-determined admission
    — the coordinator holds that window's commit for it). ``device``
    is where the trainer runs (``cuda`` unless told ``cpu``); it is
    initialised before the worker dials, and a card asked for that is
    not there raises."""
    log = logger or (lambda m: None)
    die = die or _default_die
    connect = connect or transport.connect
    device = init_backend(device=device, log=log)
    sock = None
    last_err: Exception | None = None
    for attempt in range(80):
        try:
            if sock is None:
                sock = connect(host, port)
            # tda: ignore[TDA112] -- the join loop breaks only on
            # welcome; every non-welcome fall-through below retries
            # or raises "join rejected" with the error payload — the
            # error reply IS the handled rejection path
            kind, meta, center = transport.request(
                sock, "join",
                {"slot": slot, "rejoin": rejoin,
                 "admit_at": admit_at})
        except transport.TransportError as e:
            # a torn dial/handshake (an rpc-storm fault, or the
            # coordinator mid-recovery): re-dial, like every later
            # round trip does through the link
            last_err = e
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
                sock = None
            time.sleep(0.25)
            continue
        if kind == "welcome":
            break
        if "slots active" in str(meta.get("error", "")) \
                and attempt < 79:
            # a replacement racing the coordinator's EOF processing of
            # its predecessor: the slot reads ACTIVE for a beat after
            # the old process died — retry briefly instead of wedging
            # the admission hold forever
            time.sleep(0.25)
            continue
        sock.close()
        raise RuntimeError(
            f"join rejected: {meta.get('error', kind)}")
    else:
        raise transport.TransportClosed(
            f"could not join the coordinator at {host}:{port} after "
            f"80 attempts: {last_err}")
    slot = int(meta["slot"])
    inc = int(meta.get("incarnation", 0))
    # the fencing token: every frame this incarnation sends carries it,
    # so a replacement can never be confused with its zombie (the link
    # shares this dict — a fresh re-admission swaps the token in place)
    ident = {"slot": slot, "inc": inc}
    s = int(meta["s"])
    n_windows = int(meta["n_windows"])
    n_slots = int(meta["n_slots"])
    rpc_deadline = float(meta.get("rpc_deadline", 30.0))
    task = meta["train"]
    plan = meta.get("plan")
    schedule = compile_worker_schedule(
        n_windows, n_slots,
        plan=fregistry.FaultPlan.parse(plan) if plan else None)
    trainer = LocalTrainer(task, slot, n_slots, s, device=device)
    tevents.emit("cluster_worker_start", slot=slot,
                 admit=meta["admit"], gen=meta["gen"])
    tevents.mark(f"cluster:worker{slot}", emit_event=False)

    stats = {"pushes": 0, "skips": 0, "gated_ms": 0.0,
             "push_pull_ms_total": 0.0, "push_pull_ms": [],
             "ages": [], "windows": 0, "undelivered_windows": 0,
             "reconnects": 0, "readmissions": 0,
             "heartbeat_retries": 0, "delta_pulls": 0,
             "dense_pulls": 0, "async_pushes": 0}
    link = _Link(host, port, sock, connect, ident, rpc_deadline,
                 stats, log)

    # the cluster wire schedule (the coordinator's welcome carries the
    # one spelling every process runs under): dense keeps the verbatim
    # f32 snapshot protocol; int8/topk compress the push delta (EF
    # residual carried HERE, in the loop state) and receive
    # version-delta pulls against the cached center view. @seq forces
    # the synchronous push; otherwise compressed pushes overlap the
    # next window's compute on a background sender
    comm_spec = pcomms.CommSpec.parse(meta.get("comm") or "dense")
    codec = pcomms.make_host_codec(comm_spec)
    pull_codec = pcomms.make_host_pull_codec(comm_spec)
    # rowstore PS mode (the welcome carries it, like the comm spec):
    # every push names the rows it moves via a ``w.rows`` index array
    # so the PS merges row-wise. The SGD window touches every row of the
    # dense LR weight vector, so the index is the full range, which is
    # what pins rowstore-mode SSP bitwise to the replicated path; the
    # sparse workloads of the row store are
    # ``rowstore.run_cluster_pagerank`` and ``models/als.fit_rowstore``
    ps_mode = meta.get("ps_mode") or "replicated"
    # the welcome also names the tuned geometry this run was resolved
    # under — the pull-refresh cadence (the coordinator enforces it;
    # recorded here so worker stats say what wire they measured) and
    # the rig-profile id (or None for untuned table defaults)
    stats["pull_refresh"] = int(meta.get("pull_refresh")
                                or tune_defaults.PULL_REFRESH_WINDOWS)
    if meta.get("tune_profile"):
        stats["tune_profile"] = str(meta["tune_profile"])
    overlap_push = codec is not None and comm_spec.overlap
    push_link = (_Link(host, port, None, connect, ident, rpc_deadline,
                       stats, log) if overlap_push else None)

    # liveness: the shared Heartbeat thread, its emit_fn ALSO framing a
    # beat to the coordinator over its own crash-tolerant link —
    # compute-bound windows stay visibly alive, a partition goes
    # visibly silent, and one broken beat never ends the loop
    hb_link = _HbLink(host, port, connect, ident, rpc_deadline, stats)

    def hb_emit(ev, **fields):
        tevents.emit(ev, **fields)
        if ev == "heartbeat":
            hb_link.beat()

    hb = theartbeat.Heartbeat(
        interval=float(meta.get("heartbeat_interval", 0.5)),
        stall_after=None, emit_fn=hb_emit)
    hb.start()

    pending_windows = 0   # trained-but-not-yet-pushed (busy skips)
    version = int(meta["version"])
    w_base = np.asarray(center["w"], np.float32)   # cached center view
    w_local = w_base.copy()
    cut = w_local            # progress in (cut -> w_local) is unpushed
    base = version           # version underlying w_local's training
    have = version           # version of the cached center view
    residual = (pcomms.zero_residuals({"w": w_base})
                if codec is not None else None)
    window = int(meta["admit"])
    done = bool(meta.get("done"))
    restart = False
    killed = False
    pending: _PendingPush | None = None   # the one in-flight push

    def adopt_reset(m, arrays):
        """A fresh re-admission (the old incarnation was declared
        dead during a coordinator outage): adopt the welcome like a
        brand-new join — new admission window, the current center,
        zero pending work, a zero EF residual."""
        nonlocal version, done, restart, window, w_base, w_local, \
            base, have, cut, residual, pending_windows, pending, \
            push_link
        # an in-flight push predates the reset: its reply (if any) is
        # for a dead incarnation — abandoned, never harvested. Its
        # sender thread may still hold the push link mid-retry, so
        # the link is CLOSED (the thread exits on LinkClosed instead
        # of re-dialing) and a fresh one minted: the re-admitted
        # incarnation's next push must never interleave frames with
        # the zombie on one socket
        pending = None
        if push_link is not None:
            push_link.close()
            push_link = _Link(push_link.host, push_link.port, None,
                              push_link.connect, ident, rpc_deadline,
                              stats, log)
        version = int(m["version"])
        done = bool(m.get("done"))
        restart = bool(m.get("restart"))
        window = int(m["admit"])
        w_base = np.asarray(arrays["w"], np.float32)
        w_local = w_base.copy()
        cut = w_local
        base = version
        have = version
        if codec is not None:
            residual = pcomms.zero_residuals({"w": w_base})
        pending_windows = 0

    def adopt_pull(m, arrays):
        """Fold one pull payload into the cached center view: a
        ``delta`` reply applies the compressed ``center@cv −
        center@have`` diff to the view (the worker-side half of the
        version-delta protocol — both ends decode the same bytes), a
        ``dense`` reply (resume/rejoin fallback, and the whole dense
        schedule) replaces it. ``base`` pins to the reply's center
        version — under a codec that is the push's own commit
        (``cv``), a pure function of the plan, never the live clock a
        concurrently-committing peer may already have advanced."""
        nonlocal w_base, have, base
        mode = m.get("mode")
        if mode == "delta":
            delta = pcomms.decode_tree(pull_codec, arrays,
                                       {"w": w_base})["w"]
            w_base = w_base + delta
            have = int(m["cv"])
            stats["delta_pulls"] += 1
        elif mode == "dense":
            w_base = np.asarray(arrays["w"], np.float32)
            have = int(m["cv"])
            stats["dense_pulls"] += 1
        else:   # legacy dense reply (no codec): live center + version
            w_base = np.asarray(arrays["w"], np.float32)
            have = int(m.get("version", have))
        base = have
        if ps_mode == "rowstore":
            # every row of the LR vector rides each pull
            tevents.counter("rowstore.rows_pulled", int(w_base.shape[0]))
            tevents.counter("rowstore.pull_rows_dense",
                            int(w_base.shape[0]))

    def harvest(p: _PendingPush, transplant):
        """Fold an in-flight push's deferred ack into the loop state:
        record the round trip, refresh the cached view, and REBASE
        the local weights onto the fresher center — transplanting
        ``transplant`` (the progress trained while the push was in
        flight; ``None`` = the synchronous path, nothing trained
        since). Returns ``False`` on a reset (the caller restarts its
        iteration)."""
        nonlocal version, done, restart, w_local
        k, m, arrs = p.wait()
        if k == "reset":
            adopt_reset(m, arrs)
            return False
        version = int(m.get("version", version))
        done = bool(m.get("done", done))
        restart = bool(m.get("restart", restart))
        if k == "error":
            raise transport.TransportClosed(
                f"push rejected: {m.get('error')}")
        stats["pushes"] += 1
        stats["push_pull_ms"].append(round(p.rtt_ms, 3))
        stats["push_pull_ms_total"] += p.rtt_ms
        stats["ages"].append(max(0, p.window - p.base))
        tevents.counter("cluster.pushes")
        adopt_pull(m, arrs)
        w_local = (w_base + transplant if transplant is not None
                   else w_base.copy())
        return True

    def rpc(kind, meta_, arrays=None, deadline=None):
        """One crash-tolerant round trip; folds a ``reset`` into the
        loop state and reports it so call sites can restart their
        iteration."""
        nonlocal version, done, restart
        k, m, arrs = link.request(kind, meta_, arrays,
                                  deadline=deadline)
        if k == "reset":
            adopt_reset(m, arrs)
            return k, m, arrs
        if k == "error":
            # a fenced-out slot's poll/skip gets ("error", "stale
            # slot") back — adopting it as data keeps a zombie
            # training silently; surface it like any other link
            # failure so the supervised path rejoins
            raise transport.TransportClosed(
                f"{kind} rejected: {m.get('error', 'unknown')}")
        version = int(m.get("version", version))
        done = bool(m.get("done", done))
        restart = bool(m.get("restart", restart))
        return k, m, arrs

    try:
        if window > version:
            # pinned late admission: wait for the clock to reach the
            # admission window, then re-pull — the first delivery's
            # base (and so its age/weight) is plan-determined, not
            # join-timing-determined
            t_gate = time.monotonic()
            while version < window and not done and not restart:
                if time.monotonic() - t_gate > GATE_DEADLINE_SECONDS:
                    raise transport.TransportTimeout(
                        f"admission starved: version {version} never "
                        f"reached admit window {window}")
                time.sleep(GATE_POLL_SECONDS)
                rpc("poll", dict(ident))
            if not done and not restart:
                k, m, arrays = rpc("pull", dict(ident))
                if k != "reset":
                    adopt_pull(m, arrays)
                    w_local = w_base.copy()
                    cut = w_local
        while window < n_windows and not done and not restart:
            # the SSP gate: never more than s windows past the clock —
            # UNCHANGED under the push/pull overlap (an async push for
            # window w−1 still counts against the same bound: the
            # version only advances when that window commits)
            t_gate = time.monotonic()
            while window - version > s:
                if time.monotonic() - t_gate > GATE_DEADLINE_SECONDS:
                    raise transport.TransportTimeout(
                        f"gate starved: window {window} vs version "
                        f"{version} for {GATE_DEADLINE_SECONDS}s")
                time.sleep(GATE_POLL_SECONDS)
                k, _, _ = rpc("poll", dict(ident))
                if k == "reset" or done or restart:
                    break
            if done or restart:
                break
            if time.monotonic() - t_gate > 2 * GATE_POLL_SECONDS:
                stats["gated_ms"] += (time.monotonic() - t_gate) * 1e3
            cell = int(schedule[window, slot]) \
                if window < schedule.shape[0] else 0
            tevents.mark(f"cluster:worker{slot}@w{window}",
                         emit_event=False)
            if cell == KILL:
                # kill -9 MID-WINDOW: half the ticks land, the push
                # never happens, the sockets slam shut (EOF is the
                # coordinator's fastest death signal). A pusher link
                # closes FIRST: its background retry loop must not
                # resume-join and resurrect the dead incarnation in
                # thread mode
                w_local = trainer.run(w_local, window,
                                      max(1, s // 2))
                tevents.emit("cluster_worker_kill", slot=slot,
                             window=window)
                killed = True
                if push_link is not None:
                    push_link.close()
                die()
                return stats          # thread-mode die() returns
            busy = cell > 0
            if busy:
                # pre-announced skip: peers' commit of THIS window
                # must not wait out the interference
                k, _, _ = rpc("skip", dict(ident, window=window))
                if k == "reset":
                    continue
                stats["skips"] += 1
                tevents.counter("cluster.skips")
            w_local = trainer.run(w_local, window, s)
            stats["windows"] += 1
            if busy:
                trainer.straggle(cell)
                pending_windows += 1
                window += 1
                continue
            # -- push boundary -----------------------------------
            # cut the un-pushed progress (this window's training,
            # plus any busy windows' riding along), harvest the
            # previous in-flight ack — the overlap: that ack's
            # commit ran UNDER this window's compute — rebase onto
            # the fresher center, then send
            progress = w_local - cut
            push_base = base       # version this progress trained on
            if pending is not None:
                p, pending = pending, None
                if not harvest(p, progress):
                    continue       # reset adopted: restart the loop
            if codec is None:
                arrays_out = {"w": progress}
                push_meta = dict(ident, window=window,
                                 base=push_base)
            else:
                # EF: compress (progress + residual), carry the rest
                arrays_out, residual = pcomms.encode_tree(
                    codec, {"w": progress}, residual,
                    pcomms.PUSH_SEED_TAG, slot, window)
                push_meta = dict(ident, window=window,
                                 base=push_base, have=have)
            if ps_mode == "rowstore":
                # the row index rides OUTSIDE the codec (exact int64
                # structure; the coordinator detaches it before the
                # value decode) and INSIDE the push digest, so replay
                # and re-push dedup cover it like any other byte
                arrays_out["w.rows"] = np.arange(
                    progress.shape[0], dtype=np.int64)
                tevents.counter("rowstore.rows_pushed",
                                int(progress.shape[0]))
            # the ack is DEFERRED until this window commits — which
            # can legitimately wait out an admission hold (a respawned
            # PROCESS worker pays spawn + torch import + device init),
            # so the recv deadline is the gate's, not the rpc's
            push_deadline = max(rpc_deadline, GATE_DEADLINE_SECONDS)
            if overlap_push:
                pending = _PendingPush(push_link, window, push_base,
                                       push_meta, arrays_out,
                                       push_deadline)
                stats["async_pushes"] += 1
                tevents.counter("cluster.async_pushes")
                cut = w_local
            else:
                t0 = time.monotonic()
                reply = link.request("push", push_meta, arrays_out,
                                     deadline=push_deadline)
                p = _DonePush(window, push_base, reply,
                              (time.monotonic() - t0) * 1e3)
                if not harvest(p, None):
                    continue
                cut = w_local
            pending_windows = 0
            window += 1
    finally:
        if pending is not None:
            # drain the final in-flight ack (its commit is the run's
            # last window; losing it would drop the round trip from
            # the stats and leave the handler blocked on our socket)
            try:
                harvest(pending, None)
            except (transport.TransportError, LinkClosed):
                pass
            pending = None
        hb.stop()
        hb_link.close()
        if push_link is not None:
            push_link.close()
        if not killed:
            if pending_windows:
                # a straggle cell on the FINAL window(s) leaves
                # trained work with no later boundary to ride — the
                # in-process SSP drops a boundary-busy final window's
                # pending delta the same way (the scan ends); record
                # the loss instead of letting it pass silently
                stats["undelivered_windows"] = pending_windows
                tevents.counter("cluster.undelivered_windows",
                                pending_windows)
                tevents.emit("cluster_undelivered", slot=slot,
                             windows=pending_windows)
            ages = stats.pop("ages", [])
            stats["mean_age"] = (round(float(np.mean(ages)), 4)
                                 if ages else 0.0)
            stats["max_age"] = int(max(ages)) if ages else 0
            rtts = stats.pop("push_pull_ms", [])
            stats["push_pull_ms_p50"] = (
                round(float(np.percentile(rtts, 50)), 3)
                if rtts else 0.0)
            try:
                # tda: ignore[TDA112] -- fire-and-forget farewell:
                # an error from a dying coordinator changes nothing
                # about a worker that is already leaving
                link.request("bye", dict(ident, stats=stats),
                             retries=1)
            except transport.TransportError:
                pass
            pssp.emit_ssp_counters(
                pssp.SyncSpec(mode="ssp", staleness=s),
                {"merges": stats["pushes"],
                 "max_staleness": stats["max_age"],
                 "mean_staleness": stats["mean_age"]},
                straggle_ticks=stats["skips"] * s)
            tevents.counter("cluster.gated_ms",
                            int(stats["gated_ms"]))
            tevents.emit("cluster_worker_done", slot=slot, **{
                k: v for k, v in stats.items()
                if not isinstance(v, list)})
            log(f"[cluster] worker {slot} done: {stats['pushes']} "
                f"push(es), {stats['skips']} skip(s)")
            link.drop()
    stats["restart"] = restart
    return stats
