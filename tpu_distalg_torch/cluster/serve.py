"""Serving replicas — the data plane of the distributed serving tier (port
of ``tpu_distalg/cluster/serve.py``).

N replica processes (or threads) each hold a servable model, or a
model-axis SHARD of one, behind the framed-numpy TCP transport (the JAX
package's frames), and a front-end router (:mod:`.router`) dispatches
micro-batches at them. A replica scores on its device (``cuda`` unless
told ``cpu``): an ALS shard through ``ops/topk.fused_matmul_topk`` (B9 on
the card, one launch a micro-batch) over its slice of V with the slice's
global offset and valid count; LR and k-means through the predictors of
``serve/artifacts.py``.

Replica contract:

* **Batch-atomic scoring.** Every ``score`` frame is answered under the
  model lock and stamped with the model version it was scored under, so
  a hot swap never lands mid-batch.
* **Live hot swap.** The ``swap`` frame carries a version-pinned
  compressed delta against the replica's cached center (the pull codec
  of the ``--comm`` spec both ends derive) or a dense snapshot (the
  fallback when the replica's base does not match: it replies
  ``swap_stale`` and the router re-sends dense). Applying takes the
  lock scoring takes, so no request is dropped.
* **Deterministic scoring.** A replica scores in blocks of
  :data:`SCORE_ROWS` rows, the tail padded: every call has the same
  operand shapes whatever the batch fill, and shard boundaries align to
  :data:`SCORE_BLOCK` items. B9's scores are float32 FMAs in a fixed
  order over the rank, so a reply's bits depend only on its payload and
  the model — never on batch fill, replica count or re-route — and a
  sharded fleet's merged replies equal one replica's holding the whole
  catalogue. The dense merge's scores are summed over the rank one
  element-wise multiply-add at a time, the same order in every shape.
* **Honest death.** The ``cluster:replica`` fault point fires at the
  score seam: ``kill`` SIGKILLs the process (thread mode slams every
  socket for the same router-side EOF), mid-burst, with requests in
  flight; the router detects it by EOF or heartbeat and re-routes.

:class:`ServeFleet` is the local launcher (threads for tests and fast
paths, real subprocesses for the genuine kill -9), mirroring
``cluster/local.py``'s spawn discipline.
"""

from __future__ import annotations

import dataclasses
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from tpu_distalg_torch import faults
from tpu_distalg_torch.cluster import transport
from tpu_distalg_torch.faults import registry as fregistry
from tpu_distalg_torch.parallel import comms as pcomms
from tpu_distalg_torch.telemetry import events as tevents

#: accept-loop poll
POLL_SECONDS = 0.05

#: how long a process replica may take to announce its port
SPAWN_DEADLINE_S = 300.0

#: shard boundaries of an ALS catalogue align to this many items (the
#: JAX package's fixed gemm tile width), so every shard count cuts the
#: same padded catalogue
SCORE_BLOCK = 128

#: rows of one scoring call: a frame is scored in blocks of this many
#: rows, the last one padded, so every call has the same shapes
SCORE_ROWS = 32


class ReplicaKilled(RuntimeError):
    """Thread-mode stand-in for the replica's SIGKILL: raised after the
    socket slam so the handler unwinds like a dead process's would."""


def center_of_state(root: str, state: list) -> tuple[str, dict]:
    """Map a checkpoint's ``(tag root, state leaves)`` to ``(kind,
    center)`` — the flat ``{name: ndarray}`` tree the hot-swap delta
    codec (``comms.encode_tree``/``decode_tree``) speaks, shared with
    the training cluster's center vocabulary."""
    if root in ("lr", "ssgd", "ma", "bmuf", "easgd", "local_sgd"):
        return "lr", {"w": np.asarray(state[0], np.float32)}
    if root.startswith("kmeans"):
        return "kmeans", {"centers": np.asarray(state[0], np.float32)}
    if root == "als":
        return "als", {"U": np.asarray(state[0], np.float32),
                       "V": np.asarray(state[1], np.float32)}
    raise ValueError(
        f"no serving-plane adapter for workload tag root {root!r} "
        f"(servable: lr-family, kmeans_*, als)")


def scoped_plan_spec(plan_spec: str | None,
                     points: tuple[str, ...] = ("cluster:replica",)
                     ) -> str | None:
    """The plan restricted to rules at ``points`` — what ONE targeted
    replica subprocess runs under. Handing the full plan to every
    replica would fire each per-process hit counter independently and
    kill the whole fleet at once; the launcher scopes the kill to its
    designated victim instead (thread mode shares one ambient registry,
    so the unscoped plan already fires exactly once there)."""
    if not plan_spec:
        return plan_spec
    plan = fregistry.FaultPlan.parse(plan_spec)
    rules = tuple(r for r in plan.rules if r.point in points)
    if not rules:
        return None
    return fregistry.FaultPlan(seed=plan.seed, rules=rules).spec()


# --------------------------------------------------------------- scoring


class ReplicaModel:
    """One (possibly sharded) model on a device: the port's counterpart
    of the JAX package's ``HostModel``, with its constructor, ``meta``,
    ``rebuild`` and ``score_frame``.

    Rows are scored :data:`SCORE_ROWS` at a time with the tail padded,
    so a request's reply bits depend only on its own payload and the
    model. An ALS shard holds U whole and its slice of the catalogue,
    ``local_n`` items from ``off`` (the catalogue padded to
    ``n_shards · SCORE_BLOCK`` items, as the JAX package cuts it); its
    sparse reply is B9's top ``k_top`` of the slice (global ids, value
    descending, ties toward the lower id), its dense reply the slice's
    scores with the padding at -inf."""

    def __init__(self, kind: str, center: dict, *, shard: int = 0,
                 n_shards: int = 1, k_top: int = 10,
                 merge: str = "sparse", device=None):
        from tpu_distalg_torch.utils.device import resolve_device

        if kind not in ("lr", "kmeans", "als"):
            raise ValueError(f"unknown model kind {kind!r}")
        if not 0 <= shard < n_shards:
            raise ValueError(
                f"shard {shard} outside 0..{n_shards - 1}")
        if merge not in ("sparse", "dense"):
            raise ValueError(
                f"merge must be 'sparse' or 'dense', got {merge!r}")
        self.kind = kind
        self.center = {k: np.asarray(v, np.float32)
                       for k, v in center.items()}
        self.shard = int(shard)
        self.n_shards = int(n_shards)
        self.k_top = int(k_top)
        self.merge = merge
        self.device = resolve_device(device)
        if kind == "lr":
            from tpu_distalg_torch.serve import artifacts

            self._predict = artifacts.lr_model(
                self.center["w"].ravel(),
                device=self.device).predictor(SCORE_ROWS)
        elif kind == "kmeans":
            from tpu_distalg_torch.serve import artifacts

            self._predict = artifacts.kmeans_model(
                self.center["centers"],
                device=self.device).predictor(SCORE_ROWS)
        else:
            self._build_als()

    def _build_als(self) -> None:
        import torch

        U, V = self.center["U"], self.center["V"]
        if U.shape[1] != V.shape[1]:
            raise ValueError(
                f"U {U.shape} vs V {V.shape}: factor ranks differ")
        self.n_items = int(V.shape[0])
        span = self.n_shards * SCORE_BLOCK
        n_pad = -(-self.n_items // span) * span
        self.local_n = n_pad // self.n_shards
        if self.k_top > min(self.n_items, self.local_n):
            raise ValueError(
                f"k_top={self.k_top} exceeds the catalogue "
                f"(n_items={self.n_items}, shard width "
                f"{self.local_n}) — merged top-k would carry "
                f"sentinel rows")
        self.off = self.shard * self.local_n
        self.n_valid = max(0, min(self.local_n, self.n_items - self.off))
        Vl = np.zeros((self.local_n, V.shape[1]), np.float32)
        if self.n_valid:
            Vl[:self.n_valid] = V[self.off:self.off + self.n_valid]
        dev = self.device
        self._U = torch.as_tensor(U, device=dev)
        self._V = torch.as_tensor(Vl, device=dev)
        self._VT = self._V.T.contiguous()
        self._invalid = torch.arange(self.local_n, device=dev) \
            >= self.n_valid

    def rebuild(self, center: dict) -> "ReplicaModel":
        """The hot-swap constructor: same wiring, new weights."""
        return ReplicaModel(self.kind, center, shard=self.shard,
                            n_shards=self.n_shards, k_top=self.k_top,
                            merge=self.merge, device=self.device)

    @property
    def meta(self) -> dict:
        out = {"kind": self.kind, "shard": self.shard,
               "n_shards": self.n_shards}
        if self.kind == "als":
            out.update(k_top=self.k_top, merge=self.merge,
                       n_items=self.n_items, local_n=self.local_n,
                       off=self.off)
        return out

    # ------------------------------------------------------ per kind

    def _score_rows(self, X: np.ndarray) -> np.ndarray:
        """LR or k-means: ``SCORE_ROWS`` rows a predictor call."""
        pack, run = self._predict.pack, self._predict.run
        out = []
        for r0 in range(0, X.shape[0], SCORE_ROWS):
            rows = list(X[r0:r0 + SCORE_ROWS].astype(np.float32))
            out += run(pack(rows), len(rows))
        return np.stack(out)

    def _queries(self, ids: np.ndarray):
        """The users' rows of U, padded to ``SCORE_ROWS``."""
        import torch

        idx = torch.zeros(SCORE_ROWS, dtype=torch.int64, device=self.device)
        idx[:ids.shape[0]] = torch.as_tensor(ids, device=self.device)
        return self._U.index_select(0, idx)

    def _dense_scores(self, Q):
        """``Q · V_slotᵀ`` (SCORE_ROWS, local_n), summed over the rank
        one multiply-add at a time (the same order in every shape), the
        padding items at -inf."""
        import torch

        s = Q[:, :1] * self._VT[:1]
        for f in range(1, Q.shape[1]):
            s = torch.addcmul(s, Q[:, f:f + 1], self._VT[f:f + 1])
        return s.masked_fill_(self._invalid[None, :], float("-inf"))

    def _score_als(self, ids: np.ndarray) -> dict:
        from tpu_distalg_torch.ops import topk

        vals, idx, scores = [], [], []
        for r0 in range(0, ids.shape[0], SCORE_ROWS):
            chunk = ids[r0:r0 + SCORE_ROWS]
            n = chunk.shape[0]
            Q = self._queries(chunk)
            if self.merge == "sparse":
                v, i = topk.fused_matmul_topk(Q, self._V, self.off,
                                              self.n_valid, k=self.k_top)
                vals.append(v[:n].cpu().numpy())
                idx.append(i[:n].cpu().numpy())
            else:
                scores.append(self._dense_scores(Q)[:n].cpu().numpy())
        if self.merge == "sparse":
            return {"vals": np.concatenate(vals),
                    "idx": np.concatenate(idx).astype(np.int32)}
        return {"scores": np.concatenate(scores)}

    # ---------------------------------------------------------- frame

    def score_frame(self, arrays: dict) -> dict:
        """One ``score`` frame's reply arrays (shard candidates for a
        sharded ALS replica, final values otherwise)."""
        x = np.asarray(arrays["x"])
        if self.kind == "als":
            return self._score_als(x.astype(np.int64).reshape(-1))
        y = self._score_rows(x)
        return {"y": y.astype(np.int32 if self.kind == "kmeans"
                              else np.float32)}

    def warm(self) -> None:
        """One padded call, before the replica takes traffic: on the
        card it builds and loads the kernel and the workspaces, so that
        no request waits on them (nor a heartbeat on the model lock)."""
        if self.kind == "als":
            self._score_als(np.zeros((1,), np.int64))
        else:
            width = (self.center["w"].size if self.kind == "lr"
                     else self.center["centers"].shape[1])
            self._score_rows(np.zeros((1, width), np.float32))


# --------------------------------------------------------------- replica


class Replica:
    """One serving replica: a framed-TCP listener over a
    :class:`ReplicaModel`, with version-stamped batch-atomic scoring and
    the live hot-swap seam. :meth:`start` warms the model before it
    binds."""

    def __init__(self, slot: int, model: ReplicaModel, *,
                 version: int = 0, comm: str = "dense",
                 host: str = "127.0.0.1", port: int = 0,
                 rpc_deadline: float = 30.0,
                 process_kill: bool = False, logger=None):
        self.slot = int(slot)
        self.model = model
        self.version = int(version)
        self._comm = comm
        self.host = host
        self.port = int(port)
        self.rpc_deadline = float(rpc_deadline)
        self.process_kill = bool(process_kill)
        self.log = logger or (lambda *_: None)
        self._pull_codec = pcomms.make_host_pull_codec(comm)
        self._model_lock = threading.Lock()
        self._conns: set = set()
        self._stop = threading.Event()
        self._listener: socket.socket | None = None
        self._threads: list = []
        self.killed = False

    # ---------------------------------------------------- lifecycle

    def start(self) -> "Replica":
        self.model.warm()
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        t = threading.Thread(target=self._accept_loop,
                             name=f"tda-replica{self.slot}-accept",
                             daemon=True)
        t.start()
        self._threads.append(t)
        tevents.emit("replica_start", slot=self.slot, port=self.port,
                     version=self.version, **self.model.meta)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass

    def slam(self) -> None:
        """Abruptly close the listener and every live connection —
        what a SIGKILL does to the process's sockets (the thread-mode
        kill observable, same shape as the coordinator's)."""
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

    def _die(self) -> None:
        """The ``cluster:replica`` kill cell: a real SIGKILL in
        process mode; thread mode slams the sockets (same router-side
        EOF) and unwinds the handler."""
        self.killed = True
        self._stop.set()
        tevents.counter("cluster.replica_kills")
        if self.process_kill:
            os.kill(os.getpid(), signal.SIGKILL)
        self.slam()
        raise ReplicaKilled(f"replica {self.slot} killed at the "
                            f"score seam")

    # ----------------------------------------------------------- IO

    def _accept_loop(self) -> None:
        self._listener.settimeout(POLL_SECONDS)
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # daemon handlers, untracked on purpose (the coordinator's
            # accept-loop shape): stop()/EOF ends them
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name=f"tda-replica{self.slot}-conn",
                daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        self._conns.add(conn)
        try:
            while not self._stop.is_set():
                try:
                    kind, meta, arrays = transport.recv_frame(
                        conn, deadline=4 * self.rpc_deadline)
                except transport.TransportTimeout:
                    continue  # idle connection
                reply = self._handle(kind, meta or {}, arrays or {})
                transport.send_frame(conn, *reply,
                                     deadline=self.rpc_deadline)
                if kind == "stop":
                    break
        except transport.TransportClosed:
            pass
        except transport.TransportError:
            pass
        except ReplicaKilled:
            pass  # thread-mode SIGKILL stand-in: just unwind
        finally:
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # ----------------------------------------------------- handlers

    def _handle(self, kind: str, meta: dict, arrays: dict) -> tuple:
        if kind == "hello":
            with self._model_lock:
                m = {"replica": self.slot, "version": self.version}
                m.update(self.model.meta)
            return ("welcome", m, None)
        if kind == "score":
            return self._handle_score(arrays)
        if kind == "hb":
            with self._model_lock:
                return ("hb_ok", {"replica": self.slot,
                                  "version": self.version}, None)
        if kind == "swap":
            return self._handle_swap(meta, arrays)
        if kind == "stop":
            return ("bye", {"replica": self.slot}, None)
        return ("error", {"error": f"unknown frame kind {kind!r}"},
                None)

    def _handle_score(self, arrays: dict) -> tuple:
        # the replica's chaos seam: a kill here lands mid-burst, with
        # this batch's requests in flight and unanswered — the honest
        # failure the router's re-route machinery is measured against
        try:
            faults.inject("cluster:replica")
        except fregistry.InjectedKill:
            self._die()
        with self._model_lock:
            out = self.model.score_frame(arrays)
            version = self.version
        n = int(np.asarray(arrays["x"]).shape[0])
        tevents.counter("cluster.replica_requests", n)
        tevents.counter("cluster.replica_batches")
        return ("scored", {"replica": self.slot, "version": version,
                           "n": n}, out)

    def _handle_swap(self, meta: dict, arrays: dict) -> tuple:
        cv = int(meta["cv"])
        mode = meta.get("mode", "dense")
        with self._model_lock:
            if cv <= self.version:
                # idempotent re-publish (router recovery re-sends the
                # newest center): already absorbed, stay put
                return ("swap_ok", {"replica": self.slot,
                                    "version": self.version}, None)
            if mode == "delta":
                base = int(meta["base"])
                if self._pull_codec is None or base != self.version:
                    # delta computed against a center we don't hold —
                    # the router falls back to a dense snapshot
                    return ("swap_stale",
                            {"replica": self.slot,
                             "have": self.version}, None)
                delta = pcomms.decode_tree(self._pull_codec, arrays,
                                           self.model.center)
                center = {k: self.model.center[k] + delta[k]
                          for k in self.model.center}
                tevents.counter("cluster.replica_delta_swaps")
            else:
                center = {k: np.asarray(v, np.float32)
                          for k, v in arrays.items()}
                tevents.counter("cluster.replica_dense_swaps")
            # the atomic batch-boundary swap: scoring holds this lock
            # per batch, so no request ever sees a half-applied center
            self.model = self.model.rebuild(center)
            self.version = cv
            tevents.counter("cluster.replica_swaps")
            tevents.emit("replica_swap", slot=self.slot, version=cv,
                         mode=mode)
            return ("swap_ok", {"replica": self.slot,
                                "version": self.version}, None)


def run_replica(slot: int, artifact: str, *, shard: int = 0,
                n_shards: int = 1, k_top: int = 10,
                merge: str = "sparse", comm: str = "dense",
                host: str = "127.0.0.1", port: int = 0,
                logger=None, device=None) -> Replica:
    """The ``tda cluster --role replica`` entry: load the checkpoint
    artifact (``serve/artifacts.load_artifact_state``, with its re-read
    degradation), build the shard's :class:`ReplicaModel` on ``device``,
    warm it, listen. The caller prints the ``cluster_replica: listening
    on host:port`` line and parks."""
    from tpu_distalg_torch.serve import artifacts as serve_artifacts

    root, state, _step = serve_artifacts.load_artifact_state(artifact)
    kind, center = center_of_state(root, state)
    model = ReplicaModel(kind, center, shard=shard, n_shards=n_shards,
                         k_top=k_top, merge=merge, device=device)
    return Replica(slot, model, comm=comm, host=host, port=port,
                   process_kill=True, logger=logger).start()


# ----------------------------------------------------------- the fleet


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The local serving-plane launcher's knobs (CLI-mirrored)."""

    kind: str = "kmeans"          # lr | kmeans | als
    n_replicas: int = 3
    sharded: bool = False         # als: model-axis shards vs replicas
    policy: str = "least_loaded"  # least_loaded | consistent_hash
    comm: str = "dense"           # hot-swap wire schedule
    k_top: int = 10
    merge: str = "sparse"         # sparse pairs | dense blocks
    max_batch: int = 16
    max_delay_ms: float = 2.0
    queue_depth: int = 128
    hb_interval: float = 0.2
    hb_timeout: float = 2.0
    rpc_deadline: float = 30.0
    wal_dir: str | None = None    # router durable state (recovery)
    port: int = 0                 # router client port
    seed: int = 0
    version: int = 0              # version of the initial center
    artifact: str | None = None   # process spawn: checkpoint dir
    fault_slot: int | None = None  # process spawn: scoped-plan victim


class ServeFleet:
    """Replica fleet + router, launched locally — threads (fast, the
    test path; one ambient fault registry) or real subprocesses (kill -9
    is the genuine article). Replicas score on ``device`` (``cuda``
    unless told ``cpu``); a process replica runs the command line with
    ``--device`` of that type. The router always runs in-process: its
    crash drill is :meth:`Router.slam` + a fresh ``Router`` recovering
    from the WAL on the same port."""

    def __init__(self, config: FleetConfig, center: dict | None = None,
                 *, spawn: str = "thread", plan_spec: str | None = None,
                 telemetry_dir: str | None = None, logger=None,
                 device=None):
        if spawn not in ("thread", "process"):
            raise ValueError(f"spawn must be thread|process, "
                             f"got {spawn!r}")
        if spawn == "process" and config.artifact is None:
            raise ValueError(
                "process-mode replicas load a checkpoint artifact — "
                "set FleetConfig.artifact")
        from tpu_distalg_torch.utils.device import resolve_device

        self.cfg = config
        self.center = center
        self.spawn = spawn
        self.device = resolve_device(device)
        self.plan_spec = plan_spec
        self.telemetry_dir = telemetry_dir
        self.log = logger or (lambda *_: None)
        self.replicas: list[Replica] = []      # thread mode
        self.procs: list = []                  # process mode
        self.router = None

    # ---------------------------------------------------- lifecycle

    def start(self) -> "ServeFleet":
        from tpu_distalg_torch.cluster.router import Router, RouterConfig

        n = self.cfg.n_replicas
        n_shards = n if self.cfg.sharded else 1
        addrs = []
        if self.spawn == "thread":
            for slot in range(n):
                model = ReplicaModel(
                    self.cfg.kind, self.center,
                    shard=slot if self.cfg.sharded else 0,
                    n_shards=n_shards, k_top=self.cfg.k_top,
                    merge=self.cfg.merge, device=self.device)
                rep = Replica(slot, model, version=self.cfg.version,
                              comm=self.cfg.comm,
                              rpc_deadline=self.cfg.rpc_deadline,
                              logger=self.log).start()
                self.replicas.append(rep)
                addrs.append(("127.0.0.1", rep.port))
        else:
            for slot in range(n):
                addrs.append(self._spawn_process_replica(
                    slot, n_shards))
        self.router = Router(RouterConfig(
            replicas=tuple(addrs),
            mode="sharded" if self.cfg.sharded else "routed",
            policy=self.cfg.policy, comm=self.cfg.comm,
            port=self.cfg.port, wal_dir=self.cfg.wal_dir,
            max_batch=self.cfg.max_batch,
            max_delay_ms=self.cfg.max_delay_ms,
            queue_depth=self.cfg.queue_depth,
            hb_interval=self.cfg.hb_interval,
            hb_timeout=self.cfg.hb_timeout,
            rpc_deadline=self.cfg.rpc_deadline,
            seed=self.cfg.seed, k_top=self.cfg.k_top,
            merge=self.cfg.merge), logger=self.log).start()
        if self.center is not None:
            self.router.seed_history(self.cfg.version, self.center)
        return self

    def _spawn_process_replica(self, slot: int, n_shards: int):
        cfg = self.cfg
        cmd = [sys.executable, "-m", "tpu_distalg_torch.cli",
               "--device", self.device.type, "cluster",
               "--role", "replica", "--slot", str(slot),
               "--artifact", cfg.artifact,
               "--replica-shards", str(n_shards),
               "--shard", str(slot if cfg.sharded else 0),
               "--k-top", str(cfg.k_top), "--merge", cfg.merge,
               "--comm", cfg.comm, "--port", "0"]
        if self.telemetry_dir:
            cmd += ["--telemetry-dir",
                    os.path.join(self.telemetry_dir,
                                 f"replica-{slot}")]
        env = dict(os.environ)
        env.pop(fregistry.ENV_PLAN, None)
        if self.plan_spec and slot == (self.cfg.fault_slot or 0):
            scoped = scoped_plan_spec(self.plan_spec)
            if scoped:
                env[fregistry.ENV_PLAN] = scoped
        proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        self.procs.append(proc)
        # a process replica imports torch and warms its model (on the
        # card: the kernel build) before it announces its port
        deadline = time.monotonic() + SPAWN_DEADLINE_S
        while True:
            left = deadline - time.monotonic()
            if left <= 0 or not select.select([proc.stdout], [], [],
                                              left)[0]:
                break
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("cluster_replica: listening on "):
                host, _, port = line.rsplit(None, 1)[-1].rpartition(
                    ":")
                return (host, int(port))
        raise RuntimeError(
            f"replica {slot} subprocess never announced its port "
            f"(rc={proc.poll()})")

    # --------------------------------------------------- operations

    def request(self, payload, *, key=None, timeout: float = 30.0):
        return self.router.request(payload, key=key, timeout=timeout)

    def publish(self, center: dict, version: int) -> dict:
        return self.router.publish(center, version)

    def stats(self) -> dict:
        return self.router.stats()

    def stop(self) -> None:
        if self.router is not None:
            self.router.stop()
        for rep in self.replicas:
            rep.stop()
        for proc in self.procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs:
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)


def run_fleet_closed_loop(fleet_or_router, payloads, *,
                          concurrency: int = 4, retries: int = 0,
                          retry_backoff_s: float = 0.002,
                          timeout: float = 60.0, keys=None):
    """The fleet's closed-loop load generator — ``serve/server.py``'s
    ``run_closed_loop`` lifted onto the router surface. A shed or a
    mid-flight replica death surfaces as the request's error; with
    ``retries`` the worker resubmits after backoff (the client half of
    shed-don't-die, and what makes a chaos run's reply set complete
    and bitwise-comparable). Returns ``(results, info)`` where each
    result is ``(value, version, replica)`` or ``None``; ``info``
    carries client-observed latency percentiles (first submit to
    final answer, retries and backoff INCLUDED — what a kill actually
    costs the caller, not what the router saw per attempt)."""
    results = [None] * len(payloads)
    errors = [None] * len(payloads)
    lat_ms = [None] * len(payloads)
    counts = {"retries": 0, "failed": 0, "first_try_ok": 0}
    lock = threading.Lock()

    def worker(idxs):
        for j in idxs:
            attempt = 0
            t_first = time.perf_counter()
            while True:
                try:
                    out = fleet_or_router.request(
                        payloads[j],
                        key=None if keys is None else keys[j],
                        timeout=timeout)
                    dt_ms = (time.perf_counter() - t_first) * 1e3
                    with lock:
                        results[j] = out
                        errors[j] = None
                        lat_ms[j] = dt_ms
                        if attempt == 0:
                            counts["first_try_ok"] += 1
                    break
                except Exception as e:  # noqa: BLE001 — sheds and
                    #                     re-route exhaustion are data
                    #                     here; the loop must finish
                    with lock:
                        errors[j] = e
                    if attempt >= retries:
                        with lock:
                            counts["failed"] += 1
                        break
                    attempt += 1
                    with lock:
                        counts["retries"] += 1
                    time.sleep(retry_backoff_s)

    concurrency = max(1, min(concurrency, len(payloads) or 1))
    slices = [list(range(w, len(payloads), concurrency))
              for w in range(concurrency)]
    threads = [threading.Thread(target=worker, args=(s,), daemon=True,
                                name=f"fleet-load-{w}")
               for w, s in enumerate(slices)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    n_ok = sum(1 for e in errors if e is None)
    done = sorted(x for x in lat_ms if x is not None)

    def _pct(q):
        if not done:
            return 0.0
        return round(done[min(len(done) - 1,
                              int(q * (len(done) - 1) + 0.5))], 3)

    info = {
        "elapsed_s": round(elapsed, 4),
        "qps": round(n_ok / elapsed, 2) if elapsed > 0 else 0.0,
        "ok": n_ok,
        "failed": counts["failed"],
        "retries": counts["retries"],
        # availability = fraction answered on the FIRST attempt: what
        # the kill actually cost clients, with retries factored out
        "availability": (round(counts["first_try_ok"]
                               / len(payloads), 4)
                         if payloads else 1.0),
        "p50_ms": _pct(0.50),
        "p99_ms": _pct(0.99),
        "concurrency": concurrency,
    }
    return results, info
