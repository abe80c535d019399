"""Local cluster launcher — N workers + coordinator on this machine.

Port of ``tpu_distalg/cluster/local.py``. Workers run on the launcher's
device (``device=``, ``cuda`` unless told ``cpu``): a thread worker is
handed it, and a process worker is ``python -m tpu_distalg_torch.cli
--device DEV cluster --role worker ...`` (the JAX launcher passes its
workers no device). All of a machine's workers share its one card.
Unlike the JAX launcher, the first window's commit waits for every
starting worker (an admission hold, :func:`_start_hold`), so the first
process to start cannot commit windows alone.

``tda cluster --role local --workers N``'s engine, and the harness the
tests and bench drive: starts an in-process :class:`Coordinator`,
spawns workers either as REAL OS processes (``spawn='process'`` — the
``tda cluster --role worker`` CLI in a subprocess, where ``kill -9``
is a genuine SIGKILL) or as threads (``spawn='thread'`` — same
protocol over the same localhost sockets, a kill cell slams the
sockets instead; fast enough for tier-1 tests and for bench arms
where process-spawn noise would drown the measurement).

Elastic supervision: when the plan's schedule kills a worker, the
launcher respawns its slot once — under the plan WITH KILL RULES
STRIPPED (``worker.strip_kills``: the fault was transient; a
deterministic cell would re-kill every incarnation forever) — and
pins the rejoin to a plan-determined window with
``Coordinator.hold_admission`` so the replayed event sequence is
identical. ``policy='restart'`` instead respawns the WHOLE cluster
from the durable checkpoint on any death: the gang-scheduled
BSP-restart baseline the bench's elastic-speedup ratio measures
against.

COORDINATOR supervision (crash tolerance): a ``cluster:coordinator``
kill cell in the plan kills the coordinator itself mid-window — in
thread/inproc mode the injected ``die`` slams its listener and every
connection (the SIGKILL observable), with ``coordinator_spawn=
'process'`` the coordinator is a real subprocess that genuinely
``kill -9``\\ s itself. Either way the launcher detects the death,
respawns the coordinator ON THE SAME PORT under the coordinator-kill-
stripped plan, and the new incarnation recovers from the durable WAL
(``cluster/wal.py``) while the surviving workers reconnect and resume
their incarnations — no membership epoch burns, no progress is lost,
and the measured ``detect -> recover -> first recommitted window``
latency lands in the result as ``recovery_ms`` (the
``cluster_coordinator_recovery_ms`` bench metric).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

from tpu_distalg_torch.cluster import rowstore as rowstoremod
from tpu_distalg_torch.cluster import transport
from tpu_distalg_torch.cluster import worker as workermod
from tpu_distalg_torch.cluster.coordinator import (
    COORD_KILL,
    ClusterAborted,
    ClusterConfig,
    Coordinator,
    compile_coordinator_schedule,
)
from tpu_distalg_torch.faults import registry as fregistry
from tpu_distalg_torch.telemetry import events as tevents
from tpu_distalg_torch.utils.device import resolve_device

#: windows a killed slot stays away before its replacement is admitted
DEFAULT_REJOIN_AFTER = 3


def _record_recovery(recovery_ms: list, t_detect: float,
                     recommit_at: float) -> float:
    """Close one detect→recover→first-recommitted-window measurement:
    append the span and emit the counter + running-median gauge. ONE
    spelling, shared by the inproc and subprocess-coordinator
    supervisors, so the recovery telemetry's shape cannot drift
    between the two."""
    ms = (recommit_at - t_detect) * 1e3
    recovery_ms.append(round(ms, 3))
    tevents.counter("cluster.recovery_ms", int(round(ms)))
    tevents.gauge(
        "cluster.recovery_ms_p50",
        round(float(np.percentile(recovery_ms, 50)), 3))
    tevents.emit("cluster_recovery_measured", ms=round(ms, 3),
                 recoveries=len(recovery_ms))
    return ms


def event_digest(result: dict) -> str:
    """The 16-hex-char fingerprint of a run's merge + membership
    sequences — what the CLI's ``cluster_result:`` tail line prints
    and the replay/chaos acceptances compare (ONE spelling, so the
    two can never drift)."""
    import hashlib

    seq = json.dumps([result["merge_sequence"],
                      result["membership_sequence"]], default=int)
    return hashlib.sha256(seq.encode()).hexdigest()[:16]


class _ThreadWorker:
    """One thread-mode worker: the real protocol over real sockets;
    its kill-cell ``die`` slams both sockets (EOF at the coordinator —
    the same observable as a SIGKILL'd process)."""

    def __init__(self, host, port, slot, *, rejoin=False,
                 admit_at=None, device=None):
        self.slot = slot
        self.device = device
        self.result: dict | None = None
        self.error: Exception | None = None
        self._socks: list = []
        self._t = threading.Thread(
            target=self._run, args=(host, port, slot, rejoin,
                                    admit_at),
            name=f"tda-cluster-worker{slot}", daemon=True)
        self._t.start()

    def _connect(self, *a, **kw):
        s = transport.connect(*a, **kw)
        self._socks.append(s)
        return s

    def _die(self):
        # not a process: death = the sockets vanish, abruptly
        for s in list(self._socks):
            try:
                s.shutdown(2)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        raise workermod.WorkerKilled()

    def _run(self, host, port, slot, rejoin, admit_at):
        try:
            self.result = workermod.run_worker(
                host, port, slot=slot, rejoin=rejoin,
                admit_at=admit_at, die=self._die,
                connect=self._connect, device=self.device)
        except workermod.WorkerKilled:
            self.result = {"killed": True}
        except Exception as e:  # noqa: BLE001 — surfaced via .error
            self.error = e

    def join(self, timeout=None):
        self._t.join(timeout)
        return self.result

    @property
    def alive(self):
        return self._t.is_alive()


def _spawn_process_worker(host, port, slot, *, plan_spec,
                          telemetry_dir, rejoin=False,
                          admit_at=None, device):
    """A REAL worker process via the CLI — ``kill -9`` here is the
    genuine article. The worker's schedule comes from the
    coordinator's welcome frame; the plan is NOT exported into the
    child's environment (a worker-side registry would double-probe).
    The child runs on the launcher's device type."""
    env = dict(os.environ)
    env.pop("TDA_FAULT_PLAN", None)
    cmd = [sys.executable, "-m", "tpu_distalg_torch.cli",
           "--device", device.type, "cluster",
           "--role", "worker", "--connect", f"{host}:{port}",
           "--slot", str(slot)]
    if rejoin:
        cmd.append("--rejoin")
    if admit_at is not None:
        cmd += ["--admit-at", str(admit_at)]
    if telemetry_dir:
        cmd += ["--telemetry-dir",
                os.path.join(telemetry_dir, f"worker-{slot}")]
    return subprocess.Popen(
        cmd, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


class _CoordSupervisor:
    """The in-process coordinator under launcher supervision: builds
    it with the thread-mode ``die`` hook (a kill cell slams the
    listener and every connection — the SIGKILL observable), detects
    the death, respawns ON THE SAME PORT under the coordinator-kill-
    stripped plan (the new incarnation recovers from the WAL), and
    measures ``detect -> recover -> first recommitted window``."""

    def __init__(self, config: ClusterConfig, log):
        self.config = config
        self.log = log
        self.coord = Coordinator(
            config, die=lambda c: c.slam()).start()
        self.port = self.coord.port
        self.recoveries = 0
        self.recovery_ms: list[float] = []
        self.wal_records_replayed = 0
        self._pending: float | None = None   # detect time of an
        #                                      unclosed measurement

    def check(self) -> None:
        """One supervision tick: respawn a killed coordinator, close
        out a pending recovery measurement once the first window past
        the death point recommits (the coordinator records that
        commit's monotonic timestamp itself, so a supervision tick
        landing late — or only at completion — still measures the
        true detect→recover→first-recommitted-window span)."""
        if self.coord.killed and self._pending is None:
            t_detect = time.monotonic()
            v_death = self.coord.version
            self.log(f"[cluster] coordinator died on schedule at "
                     f"version {v_death}; respawning on port "
                     f"{self.port} (WAL recovery)")
            # the transient fault already fired: the recovered
            # incarnation runs coordinator-kill-free
            self.config = dataclasses.replace(
                self.config, port=self.port,
                plan_spec=workermod.strip_kills(
                    self.config.plan_spec,
                    points=("cluster:coordinator", "cluster:ps")))
            self.coord = Coordinator(
                self.config, die=lambda c: c.slam()).start()
            self.recoveries += 1
            self.wal_records_replayed += \
                self.coord.wal_records_replayed
            self._pending = t_detect
        if self._pending is not None and \
                self.coord.first_recommit_at is not None:
            _record_recovery(self.recovery_ms, self._pending,
                             self.coord.first_recommit_at)
            self._pending = None

    def stop(self) -> None:
        self.coord.stop()

    def bookkeeping(self) -> dict:
        self.check()   # close out a measurement the last poll missed
        return {
            "coordinator_recoveries": self.recoveries,
            "recovery_ms": list(self.recovery_ms),
            "wal_records_replayed": self.wal_records_replayed,
        }


def run_local_cluster(config: ClusterConfig, *, spawn: str = "thread",
                      coordinator_spawn: str = "inproc",
                      respawn: bool = True,
                      rejoin_after: int = DEFAULT_REJOIN_AFTER,
                      telemetry_dir: str | None = None,
                      timeout: float = 600.0,
                      logger=None, device=None) -> dict:
    """Run one full cluster training locally; returns the
    coordinator's result dict plus launcher bookkeeping
    (``restarts``, ``respawns``, ``wall_seconds``, and — when the
    plan kills the coordinator — ``coordinator_recoveries`` /
    ``recovery_ms`` / ``wal_records_replayed``).

    * ``policy='elastic'`` (config): a killed worker's slot is
      respawned once (``respawn=True``) under the kill-stripped plan,
      admitted at the plan-determined window ``kill_window +
      rejoin_after`` via an admission hold — so a chaos run's event
      sequence replays identically.
    * ``policy='restart'``: any death aborts; the WHOLE cluster
      respawns from the checkpoint until the run completes — the
      measured BSP-restart baseline.
    * a ``cluster:coordinator`` kill cell kills the COORDINATOR
      mid-window; the launcher respawns it on the same port and the
      WAL recovery + worker reconnects make the completed run
      bitwise-identical to the undisturbed one. Requires a
      ``checkpoint_dir`` (the WAL lives under it).
      ``coordinator_spawn='process'`` runs the coordinator as a real
      subprocess (``tda cluster --role coordinator``) so the kill is
      a genuine ``kill -9``.

    Workers run on ``device`` (``cuda`` unless told ``cpu``; a card
    asked for that is not there raises).
    """
    log = logger or (lambda m: None)
    device = resolve_device(device)
    _plan = (fregistry.FaultPlan.parse(config.plan_spec)
             if config.plan_spec else None)
    coord_sched = compile_coordinator_schedule(
        config.n_windows, plan=_plan)
    ps_sched = rowstoremod.compile_point_schedule(
        "cluster:ps", config.n_windows, plan=_plan)[:, 0]
    if ((coord_sched == COORD_KILL).any()
            or (ps_sched == COORD_KILL).any()) \
            and not config.checkpoint_dir:
        raise ValueError(
            "a cluster:coordinator / cluster:ps kill plan needs a "
            "checkpoint_dir: the durable WAL (and the center "
            "checkpoints it sits on) live under it — without one "
            "there is nothing to recover from")
    if coordinator_spawn == "process":
        return _run_process_coordinator(
            config, spawn=spawn, respawn=respawn,
            rejoin_after=rejoin_after, telemetry_dir=telemetry_dir,
            timeout=timeout, log=log, device=device)
    if coordinator_spawn != "inproc":
        raise ValueError(
            f"unknown coordinator_spawn {coordinator_spawn!r}: "
            f"'inproc' (thread-mode die hook) or 'process' (real "
            f"subprocess, genuine kill -9)")
    t0 = time.monotonic()
    plan_spec = config.plan_spec
    restarts = 0
    while True:
        sup = _CoordSupervisor(config, log)
        host, port = config.host, sup.port
        schedule = workermod.compile_worker_schedule(
            config.n_windows, config.n_slots,
            plan=(fregistry.FaultPlan.parse(plan_spec)
                  if plan_spec else None))
        # first kill cell per slot (a slot dies at most once per
        # incarnation; later cells are moot — the process is gone)
        kill_cells: dict[int, int] = {}
        for w, slot in zip(*np.nonzero(schedule == workermod.KILL)):
            kill_cells.setdefault(int(slot), int(w))
        sup.coord.hold_admission(*_start_hold(
            kill_cells, config.n_slots, sup.coord.version))
        if config.policy == "elastic" and respawn:
            # pin every replacement's admission window up front: the
            # event sequence becomes a pure function of the plan
            # (durable — a recovered coordinator keeps the hold)
            for slot, w_kill in sorted(kill_cells.items()):
                sup.coord.hold_admission(
                    min(w_kill + rejoin_after, config.n_windows - 1),
                    config.n_slots)
        workers = {}
        for slot in range(config.n_slots):
            workers[slot] = _start(spawn, host, port, slot,
                                   telemetry_dir=telemetry_dir,
                                   device=device)
        pending_respawn = (
            {slot: min(w + rejoin_after, config.n_windows - 1)
             for slot, w in kill_cells.items()}
            if config.policy == "elastic" and respawn else {})
        respawned: list[int] = []
        try:
            result = _supervise(sup, workers, pending_respawn,
                                spawn, host, port, telemetry_dir,
                                timeout, log, respawned, device)
            result["restarts"] = restarts
            # OBSERVED respawns (a death the supervisor actually saw
            # and replaced), not the plan's kill-cell count — the
            # bench's did-the-kill-really-fire guard reads this
            result["respawns"] = len(respawned)
            result["wall_seconds"] = round(time.monotonic() - t0, 3)
            result.update(sup.bookkeeping())
            return result
        except ClusterAborted as e:
            restarts += 1
            log(f"[cluster] aborted ({e}); restart policy respawns "
                f"the whole cluster (restart {restarts})")
            # reap BEFORE stopping: the aborted coordinator keeps
            # answering status frames with restart=True, so surviving
            # workers exit their loops gracefully instead of entering
            # their reconnect retry budgets against a closed port
            _reap(workers, spawn)
            sup.stop()
            # the transient fault already fired: the respawned job
            # runs kill-free (worker.strip_kills), like a real
            # executor loss
            plan_spec = workermod.strip_kills(plan_spec)
            config = dataclasses.replace(config, plan_spec=plan_spec)
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"restart-policy run exceeded {timeout}s") from e
        finally:
            sup.stop()


def _start_hold(kill_cells: dict, n_slots: int, window: int
                ) -> tuple[int, int]:
    """``(window, n)``: the commit of the first window waits for ``n``
    active workers — every slot but those a kill cell takes down in that
    very window (a hold on them could never be met). The JAX launcher
    leaves the first window to start-up timing; the port's workers
    (fast on the CPU, or started one after another in processes) would
    let the first joiner commit windows alone, and the event sequence
    would depend on which process started first."""
    return window, n_slots - sum(1 for w in kill_cells.values()
                                 if w == window)


def _start(spawn, host, port, slot, *, telemetry_dir, device,
           rejoin=False, admit_at=None):
    if spawn == "process":
        return _spawn_process_worker(
            host, port, slot, plan_spec=None,
            telemetry_dir=telemetry_dir, rejoin=rejoin,
            admit_at=admit_at, device=device)
    return _ThreadWorker(host, port, slot, rejoin=rejoin,
                         admit_at=admit_at, device=device)


def _alive(h, spawn):
    return (h.poll() is None) if spawn == "process" else h.alive


def _respawn_dead_workers(workers, pending_respawn, spawn, host,
                          port, telemetry_dir, respawned, log, device):
    """One supervision sweep of the worker slots: a scheduled kill's
    dead handle is replaced ONCE, its admission pinned to the
    plan-determined window (a rejoiner never re-executes windows
    before its admission, so the old kill cell cannot re-fire).
    Shared by the inproc and subprocess-coordinator supervisors so
    the two loops cannot drift."""
    for slot in list(pending_respawn):
        h = workers.get(slot)
        if h is not None and _alive(h, spawn):
            continue
        admit_at = pending_respawn.pop(slot)
        respawned.append(slot)
        log(f"[cluster] worker {slot} died on schedule; "
            f"respawning (rejoin at window {admit_at})")
        workers[slot] = _start(
            spawn, host, port, slot, telemetry_dir=telemetry_dir,
            device=device, rejoin=True, admit_at=admit_at)


def _reap(workers, spawn):
    for h in workers.values():
        if spawn == "process":
            try:
                # workers exit on their own once the coordinator says
                # done — give them time to flush telemetry (a kill
                # here would lose their counters event) before the
                # hard reap
                h.wait(timeout=20)
            except subprocess.TimeoutExpired:
                h.kill()
                h.wait(timeout=30)
        else:
            h.join(timeout=30)


def _supervise(sup, workers, pending_respawn, spawn, host, port,
               telemetry_dir, timeout, log, respawned, device):
    """Drive one incarnation to completion: wait on the (supervised)
    coordinator, respawning killed slots (elastic) — and a killed
    COORDINATOR — as their deaths surface. ``pending_respawn`` maps
    slot -> pinned admission window; ``respawned`` collects the slots
    actually replaced."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            # short wait slices: a scheduled kill's respawn latency is
            # bounded by this poll, and it sits on the elastic arm's
            # measured wall clock
            sup.coord.wait(timeout=0.05)
            _reap(workers, spawn)
            # re-snapshot AFTER the workers' byes have landed, so the
            # result carries their reported stats
            return sup.coord.result()
        except TimeoutError:
            if time.monotonic() > deadline:
                sup.stop()
                _reap(workers, spawn)
                raise TimeoutError(
                    f"cluster run still incomplete after {timeout}s "
                    f"(version {sup.coord.version}/"
                    f"{sup.coord.cfg.n_windows})") from None
        sup.check()   # coordinator death -> respawn + WAL recovery
        _respawn_dead_workers(workers, pending_respawn, spawn, host,
                              port, telemetry_dir, respawned, log,
                              device)


# --------------------------------------------- subprocess coordinator


class _ProcCoordinator:
    """A REAL coordinator process (``tda cluster --role coordinator``)
    — the seeded ``cluster:coordinator`` kill is a genuine
    ``kill -9`` here. Stdout is drained on a thread; the launcher
    parses the ``listening on`` line for the port and the final
    ``cluster_result:`` line for the result."""

    def __init__(self, config: ClusterConfig, telemetry_dir, *,
                 port: int = 0):
        env = dict(os.environ)
        env.pop("TDA_FAULT_PLAN", None)
        # the coordinator is numpy on the host: --device cpu keeps it
        # off the card, whatever device the workers run on
        cmd = [sys.executable, "-m", "tpu_distalg_torch.cli",
               "--device", "cpu", "cluster",
               "--role", "coordinator",
               "--host", config.host, "--port", str(port),
               "--workers", str(config.n_slots),
               "--n-windows", str(config.n_windows),
               "--sync",
               f"ssp:{config.staleness}:{config.decay:g}",
               "--ps-shards", str(config.ps_shards),
               "--heartbeat-timeout", str(config.heartbeat_timeout),
               "--heartbeat-interval",
               str(config.heartbeat_interval),
               "--rpc-deadline", str(config.rpc_deadline),
               "--reconnect-grace", str(config.reconnect_grace),
               "--comm", config.comm,
               "--ps-mode", config.ps_mode,
               # the EXACT TrainTask, every field — workers take the
               # task from the coordinator's welcome, so a lossy
               # handoff here would silently train a different task
               # than the caller configured
               "--train-json", json.dumps(config.train.as_meta()),
               "--policy", config.policy]
        if config.checkpoint_dir:
            cmd += ["--checkpoint-dir", config.checkpoint_dir,
                    "--checkpoint-every",
                    str(config.checkpoint_every)]
        if config.plan_spec:
            cmd += ["--fault-plan", config.plan_spec]
        if telemetry_dir:
            cmd += ["--telemetry-dir",
                    os.path.join(telemetry_dir, "coordinator")]
        self.proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, bufsize=1)
        self.lines: list[str] = []
        self._t = threading.Thread(target=self._drain,
                                   name="tda-coord-stdout",
                                   daemon=True)
        self._t.start()
        self.port = self._await_port()

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def _await_port(self, timeout: float = 90.0) -> int:
        deadline = time.monotonic() + timeout
        prefix = "cluster_coordinator: listening on "
        while time.monotonic() < deadline:
            for line in list(self.lines):
                if line.startswith(prefix):
                    return int(line[len(prefix):].rsplit(":", 1)[1])
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"coordinator process exited rc="
                    f"{self.proc.returncode} before binding:\n"
                    + "\n".join(self.lines[-20:]))
            time.sleep(0.02)
        raise TimeoutError("coordinator process never reported its "
                           "port")

    def result_line(self) -> dict:
        prefix = "cluster_result: "
        for line in reversed(self.lines):
            if line.startswith(prefix):
                return json.loads(line[len(prefix):])
        raise RuntimeError(
            "coordinator process exited without a cluster_result "
            "line:\n" + "\n".join(self.lines[-20:]))


def _tcp_status(host, port, *, deadline: float = 2.0):
    """One status poll over the wire (the launcher's liveness /
    recovery probe for a subprocess coordinator); ``None`` when the
    coordinator is unreachable."""
    try:
        sock = transport.connect(host, port, deadline=deadline,
                                 attempts=1)
    except transport.TransportError:
        return None
    try:
        # launcher-side liveness probe: a dead
        # coordinator surfaces as TransportError from request itself,
        # and the caller treats any reply shape as "alive" (the meta
        # fields all default); there is no fencing to misread here
        _, m, _ = transport.request(sock, "poll", {},
                                    deadline=deadline)
        return m
    except transport.TransportError:
        return None
    finally:
        try:
            sock.close()
        except OSError:
            pass


def _tcp_hold(host, port, window, n_active, *,
              deadline: float = 5.0) -> None:
    """Pin an admission hold over the wire (the subprocess-coordinator
    spelling of ``Coordinator.hold_admission``)."""
    sock = transport.connect(host, port, deadline=deadline)
    try:
        # best-effort admission hint: the
        # launcher proceeds identically whether the hold lands or
        # errors (the rejoiner's admit_at pins the schedule either
        # way), so the reply is deliberately unexamined
        transport.request(sock, "hold",
                          {"window": window, "n_active": n_active},
                          deadline=deadline)
    finally:
        try:
            sock.close()
        except OSError:
            pass


def _run_process_coordinator(config: ClusterConfig, *, spawn,
                             respawn, rejoin_after, telemetry_dir,
                             timeout, log, device) -> dict:
    """The subprocess-coordinator cluster: the coordinator is a real
    OS process, so a ``cluster:coordinator`` kill cell is a genuine
    mid-window ``kill -9`` of the control plane (workers honor the
    caller's ``spawn`` — processes for the full acceptance, threads
    for a faster genuine-coordinator-kill run). The launcher
    respawns it on the same port under the coordinator-kill-stripped
    plan; recovery (WAL replay + worker reconnects) is measured over
    TCP status polls. Elastic policy only — the restart baseline has
    an in-process launcher already."""
    if config.policy != "elastic":
        raise ValueError(
            "coordinator_spawn='process' supports policy='elastic' "
            "only (the restart baseline is an in-process launcher "
            "measurement)")
    t0 = time.monotonic()
    pc = _ProcCoordinator(config, telemetry_dir)
    host, port = config.host, pc.port
    schedule = workermod.compile_worker_schedule(
        config.n_windows, config.n_slots,
        plan=(fregistry.FaultPlan.parse(config.plan_spec)
              if config.plan_spec else None))
    kill_cells: dict[int, int] = {}
    for w, slot in zip(*np.nonzero(schedule == workermod.KILL)):
        kill_cells.setdefault(int(slot), int(w))
    _plan = (fregistry.FaultPlan.parse(config.plan_spec)
             if config.plan_spec else None)
    coord_kill_expected = bool(
        (compile_coordinator_schedule(
            config.n_windows, plan=_plan) == COORD_KILL).any()
        or (rowstoremod.compile_point_schedule(
            "cluster:ps", config.n_windows,
            plan=_plan)[:, 0] == COORD_KILL).any())
    _tcp_hold(host, port, *_start_hold(
        kill_cells, config.n_slots,
        int((_tcp_status(host, port) or {}).get("version", 0))))
    pending_respawn = {}
    if respawn:
        for slot, w_kill in sorted(kill_cells.items()):
            _tcp_hold(host, port,
                      min(w_kill + rejoin_after,
                          config.n_windows - 1), config.n_slots)
        pending_respawn = {
            slot: min(w + rejoin_after, config.n_windows - 1)
            for slot, w in kill_cells.items()}
    workers = {slot: _start(spawn, host, port, slot,
                            telemetry_dir=telemetry_dir, device=device)
               for slot in range(config.n_slots)}
    respawned: list[int] = []
    recoveries = 0
    recovery_ms: list[float] = []
    pending_rec: float | None = None   # detect time
    last_version = 0
    deadline = t0 + timeout
    try:
        while True:
            rc = pc.proc.poll()
            if rc is not None:
                if rc == 0:
                    break                       # clean completion
                if not coord_kill_expected or recoveries >= 1:
                    raise RuntimeError(
                        f"coordinator process died rc={rc} with no "
                        f"scheduled kill left — a real failure:\n"
                        + "\n".join(pc.lines[-20:]))
                t_detect = time.monotonic()
                log(f"[cluster] coordinator killed (rc={rc}); "
                    f"respawning on port {port} (WAL recovery)")
                config = dataclasses.replace(
                    config, plan_spec=workermod.strip_kills(
                        config.plan_spec,
                        points=("cluster:coordinator", "cluster:ps")))
                pc = _ProcCoordinator(config, telemetry_dir,
                                      port=port)
                recoveries += 1
                pending_rec = t_detect
            status = _tcp_status(host, port)
            if status is not None:
                last_version = max(last_version,
                                   int(status.get("version", 0)))
                recommit_at = status.get("recommit_at")
                if pending_rec is not None and \
                        recommit_at is not None:
                    # the recovered coordinator stamps its own first
                    # post-recovery commit (CLOCK_MONOTONIC is
                    # machine-wide), so the span is the true detect->
                    # recover->first-recommitted-window — not "first
                    # status poll after replay"
                    _record_recovery(recovery_ms, pending_rec,
                                     float(recommit_at))
                    pending_rec = None
            _respawn_dead_workers(workers, pending_respawn,
                                  spawn, host, port,
                                  telemetry_dir, respawned, log,
                                  device)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"cluster run still incomplete after {timeout}s "
                    f"(version {last_version}/{config.n_windows})")
            time.sleep(0.05)
    finally:
        if pc.proc.poll() is None and time.monotonic() > deadline:
            pc.proc.kill()
        _reap(workers, spawn)
    pc.proc.wait(timeout=30)
    if pending_rec is not None:
        # the run completed before a status poll caught the recommit:
        # completion bounds it — record the (over-estimating) span
        # rather than dropping the observation
        _record_recovery(recovery_ms, pending_rec,
                         time.monotonic())
    result = pc.result_line()
    result["restarts"] = 0
    result["respawns"] = len(respawned)
    result["wall_seconds"] = round(time.monotonic() - t0, 3)
    result["coordinator_recoveries"] = recoveries
    result["recovery_ms"] = recovery_ms
    return result
