"""Router — the serving plane's front end (port of
``tpu_distalg/cluster/router.py``; host Python and numpy, as the JAX
package's: frames, WAL records, policies and merges are the JAX
package's).

One router process fronts N :class:`~tpu_distalg_torch.cluster.serve.Replica`
processes. Per replica it keeps TWO framed-TCP connections — a score
socket owned by that replica's ``serve/batcher.MicroBatcher`` dispatch
thread (requests micro-batch per replica, exactly the in-process
serving shape, lifted onto the wire) and a control socket shared by the
heartbeat prober and the hot-swap publisher under a per-link lock — and
dispatches with a pluggable policy:

* **least-loaded** — fewest in-flight requests wins; ties break by a
  seeded RNG so a replayed request sequence routes identically.
* **consistent-hash** — an sha256 vnode ring over the ALIVE members;
  a death only remaps the dead replica's arcs, every other key keeps
  its home (the property the policy tests pin).

Sharded mode fans each request at every shard and merges the candidate
pairs with ``comms.merge_topk_pairs_host`` — the cross-process spelling
of the in-process ring-all-gather pair merge, same two-key sort order —
or reassembles dense score blocks (the A/B kept from PR 8). Both merges
are bitwise-identical to a single replica holding the whole catalogue.

Failure story, mirrored from the coordinator (PR 13):

* A replica death (kill -9, hang) surfaces as EOF on the score socket
  or a missed heartbeat; the router marks it dead, journals the
  membership change, and re-routes — in-flight requests retry on a
  surviving replica, a full fleet sheds honestly.
* The router itself journals admission/routing state in the PR 13
  write-ahead log: the base snapshot (port, membership, policy, seed),
  every published center (the hot-swap redo log), every death. A
  restarted router replays the WAL, rebinds the SAME port, reconnects
  the surviving fleet, and idempotently re-publishes the newest center.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import hashlib
import random
import socket
import threading
import time

import numpy as np

from tpu_distalg_torch.cluster import transport
from tpu_distalg_torch.cluster import wal as cluster_wal
from tpu_distalg_torch.parallel import comms as pcomms
from tpu_distalg_torch.serve.batcher import (MicroBatcher,
                                             ServeClosedError,
                                             ServeOverloadError)
from tpu_distalg_torch.telemetry import events as tevents

POLL_SECONDS = 0.05

#: same-port rebind discipline (the coordinator's recovery shape)
REBIND_ATTEMPTS = 100
REBIND_SLEEP = 0.05


class NoReplicaError(RuntimeError):
    """No alive replica can take this request (fleet dead, or a shard
    of a sharded fleet is gone — sharding has no redundancy)."""


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """The router's wiring (persisted in the WAL base snapshot)."""

    replicas: tuple = ()          # ((host, port), ...)
    mode: str = "routed"          # routed | sharded
    policy: str = "least_loaded"  # least_loaded | consistent_hash
    comm: str = "dense"           # hot-swap delta schedule
    port: int = 0                 # client port (0 = ephemeral)
    wal_dir: str | None = None    # durable routing state (recovery)
    max_batch: int = 16
    max_delay_ms: float = 2.0
    queue_depth: int = 128
    hb_interval: float = 0.2
    hb_timeout: float = 2.0
    rpc_deadline: float = 30.0
    history_depth: int = 8        # published centers kept for deltas
    seed: int = 0
    k_top: int = 10
    merge: str = "sparse"         # sharded ALS: sparse pairs | dense

    def __post_init__(self):
        if self.mode not in ("routed", "sharded"):
            raise ValueError(f"mode must be routed|sharded, "
                             f"got {self.mode!r}")
        if self.policy not in ("least_loaded", "consistent_hash"):
            raise ValueError(f"unknown dispatch policy {self.policy!r}")


# -------------------------------------------------------------- policies


class LeastLoadedPolicy:
    """Fewest in-flight requests wins; ties break via a seeded RNG so
    identical request/load sequences dispatch identically."""

    name = "least_loaded"

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def pick(self, alive: list, loads: dict, key=None) -> int:
        lo = min(loads[r] for r in alive)
        ties = [r for r in alive if loads[r] == lo]
        if len(ties) == 1:
            return ties[0]
        return ties[self._rng.randrange(len(ties))]


class ConsistentHashPolicy:
    """sha256 vnode ring over the ALIVE membership: a death remaps only
    the dead replica's arcs. Keyless requests ride a deterministic
    sequence counter so they still spread (and replay identically)."""

    name = "consistent_hash"

    def __init__(self, seed: int = 0, vnodes: int = 64):
        self.vnodes = int(vnodes)
        self._hash_seed = int(seed)
        self._members: tuple = ()
        self._points: list = []
        self._owners: list = []
        self._seq = 0

    @staticmethod
    def _point(token: str) -> int:
        digest = hashlib.sha256(token.encode()).digest()
        return int.from_bytes(digest[:8], "big")

    def _rebuild(self, members: tuple) -> None:
        ring = sorted((self._point(f"r{rid}#{v}"), rid)
                      for rid in members for v in range(self.vnodes))
        self._points = [p for p, _ in ring]
        self._owners = [rid for _, rid in ring]
        self._members = members

    def pick(self, alive: list, loads: dict, key=None) -> int:
        members = tuple(sorted(alive))
        if members != self._members:
            self._rebuild(members)
        if key is None:
            key = f"seq:{self._hash_seed}:{self._seq}"
            self._seq += 1
        h = self._point(f"k:{key}")
        i = bisect.bisect_left(self._points, h)
        if i == len(self._points):
            i = 0  # wrap past the top of the ring
        return self._owners[i]


def make_policy(name: str, seed: int = 0):
    if name == "consistent_hash":
        return ConsistentHashPolicy(seed)
    return LeastLoadedPolicy(seed)


# --------------------------------------------------------------- history


class _CenterHistory:
    """Bounded ``{version: center}`` ring — the router-side mirror of
    ``ps.ParameterServer``'s delta history. Both endpoints present →
    an exact f32 leafwise delta; either fell out → dense fallback."""

    def __init__(self, depth: int = 8):
        self.depth = int(depth)
        self._h: dict = {}

    def record(self, version: int, center: dict) -> None:
        self._h[int(version)] = {k: np.asarray(v, np.float32).copy()
                                 for k, v in center.items()}
        while len(self._h) > self.depth:
            del self._h[min(self._h)]

    def delta_since(self, have, version) -> dict | None:
        if have is None:
            return None
        a = self._h.get(int(have))
        b = self._h.get(int(version))
        if a is None or b is None or a.keys() != b.keys():
            return None
        return {k: b[k] - a[k] for k in b}

    def newest(self):
        if not self._h:
            return None
        v = max(self._h)
        return v, self._h[v]


# ----------------------------------------------------------------- links


class _ReplicaLink:
    """The router's view of one replica: score socket + batcher (the
    per-replica micro-batch lane) and a lock-shared control socket
    (heartbeat + hot-swap)."""

    def __init__(self, rid: int, addr: tuple, cfg: RouterConfig,
                 *, count_merge_bytes: bool = False):
        self.rid = int(rid)
        self.addr = (addr[0], int(addr[1]))
        self.cfg = cfg
        self.count_merge_bytes = count_merge_bytes
        self.alive = False
        self.version: int | None = None
        self.last_beat = time.monotonic()
        self.meta: dict = {}
        self.pending = 0            # guarded by the router's lock
        self.ctrl_lock = threading.Lock()
        self._score_sock: socket.socket | None = None
        self._ctrl_sock: socket.socket | None = None
        self.batcher: MicroBatcher | None = None

    def _dial(self) -> socket.socket:
        """One fresh connection + hello handshake. Short retry budget:
        a dead replica must surface as a TransportError in well under
        a heartbeat period, not after transport.connect's default
        10-second patience."""
        sock = transport.connect(*self.addr,
                                 deadline=self.cfg.rpc_deadline,
                                 attempts=2, retry_sleep=0.05)
        kind, meta, _ = transport.request(
            sock, "hello", deadline=self.cfg.rpc_deadline)
        if kind != "welcome":
            raise transport.TransportError(
                f"replica {self.rid} answered hello with {kind!r}")
        self.meta = meta or {}
        return sock

    def connect(self) -> None:
        cfg = self.cfg
        self._score_sock = self._dial()
        self._ctrl_sock = transport.connect(
            *self.addr, deadline=cfg.rpc_deadline)
        self.version = int(self.meta.get("version", 0))
        self.alive = True
        self.batcher = MicroBatcher(
            f"replica{self.rid}", self._predict,
            max_batch=cfg.max_batch, max_delay_ms=cfg.max_delay_ms,
            queue_depth=cfg.queue_depth)

    def _redial_score(self) -> None:
        try:
            self._score_sock.close()
        except OSError:
            pass
        self._score_sock = self._dial()

    def redial_ctrl(self) -> None:
        """Replace the control connection (heartbeat/swap retry path —
        callers hold ``ctrl_lock``)."""
        try:
            self._ctrl_sock.close()
        except OSError:
            pass
        self._ctrl_sock = transport.connect(
            *self.addr, deadline=self.cfg.rpc_deadline,
            attempts=2, retry_sleep=0.05)

    def _predict(self, payloads: list) -> list:
        """One micro-batch -> one ``score`` round trip. Returns one
        ``(value, version)`` per payload; a transport failure redials
        ONCE (scoring is pure, so replaying the frame is safe — a
        transient wire fault must not read as a replica death) and
        only then raises, failing exactly this batch's replies (the
        router re-routes them)."""
        X = np.stack([np.asarray(p) for p in payloads])
        try:
            kind, meta, arrays = transport.request(
                self._score_sock, "score", {"n": len(payloads)},
                {"x": X}, deadline=self.cfg.rpc_deadline)
        except (transport.TransportError, OSError):
            self._redial_score()
            kind, meta, arrays = transport.request(
                self._score_sock, "score", {"n": len(payloads)},
                {"x": X}, deadline=self.cfg.rpc_deadline)
        if kind != "scored":
            raise transport.TransportError(
                f"replica {self.rid} answered score with {kind!r}")
        version = int(meta["version"])
        if self.count_merge_bytes:
            tevents.counter(
                "serve.cluster_merge_bytes_wire",
                int(sum(np.asarray(a).nbytes
                        for a in arrays.values())))
        if "y" in arrays:           # routed lr/kmeans: final values
            y = arrays["y"]
            return [(y[i], version) for i in range(len(payloads))]
        if "vals" in arrays:        # ALS sparse candidates
            vals, idx = arrays["vals"], arrays["idx"]
            return [((vals[i], idx[i]), version)
                    for i in range(len(payloads))]
        scores = arrays["scores"]   # ALS dense block
        off = int(self.meta.get("off", 0))
        return [((scores[i], off), version)
                for i in range(len(payloads))]

    def close(self) -> None:
        for sock in (self._score_sock, self._ctrl_sock):
            if sock is None:
                continue
            for fn in (lambda s=sock: s.shutdown(2),
                       lambda s=sock: s.close()):
                try:
                    fn()
                except OSError:
                    pass
        if self.batcher is not None:
            self.batcher.close(timeout=1.0)


# ---------------------------------------------------------------- router


class Router:
    """The serving plane's dispatcher + hot-swap publisher + WAL'd
    control state. In-process callers use :meth:`request` /
    :meth:`publish`; remote clients speak ``route`` frames on
    :attr:`port` (see :class:`RouterClient`)."""

    def __init__(self, config: RouterConfig, *, logger=None):
        self.cfg = config
        self.log = logger or (lambda *_: None)
        self.port = int(config.port)
        self.version = 0
        self._links: dict[int, _ReplicaLink] = {}
        self._dead: set[int] = set()
        self._lock = threading.Lock()
        self._pub_lock = threading.Lock()
        self._wal_lock = threading.Lock()
        self._stop = threading.Event()
        self._listener: socket.socket | None = None
        self._conns: set = set()
        self._threads: list = []
        self._wal: cluster_wal.WriteAheadLog | None = None
        self._pull_codec = pcomms.make_host_pull_codec(config.comm)
        self._history = _CenterHistory(config.history_depth)
        self._policy = make_policy(config.policy, config.seed)
        self._latencies = collections.deque(maxlen=4096)
        self._n = {"replies": 0, "sheds": 0, "reroutes": 0,
                   "swaps": 0}
        self._t0 = time.monotonic()
        self.recovered = False

    # ---------------------------------------------------- lifecycle

    def start(self) -> "Router":
        replicas = [tuple(a) for a in self.cfg.replicas]
        if self.cfg.wal_dir:
            records, replay_base = cluster_wal.WriteAheadLog.replay(
                self.cfg.wal_dir, 1 << 60)
        else:
            records, replay_base = [], None
        if records:
            replicas = self._recover(records)
            self.recovered = True
        self._bind(retry=self.recovered)
        if self.cfg.wal_dir:
            self._wal = cluster_wal.WriteAheadLog(self.cfg.wal_dir)
            # only what a recovering router cannot re-derive (the bound
            # port and the roster) plus mode, policy and seed for the
            # record; the rest is the fresh RouterConfig's
            snapshot = {
                "port": self.port, "mode": self.cfg.mode,
                "policy": self.cfg.policy,
                "seed": self.cfg.seed,
                "replicas": [list(a) for a in replicas]}
            self._wal.open_segment(replay_base or 0, snapshot)
        count_merge = self.cfg.mode == "sharded"
        for rid, addr in enumerate(replicas):
            link = _ReplicaLink(rid, addr, self.cfg,
                                count_merge_bytes=count_merge)
            self._links[rid] = link
            if rid in self._dead:
                continue
            try:
                link.connect()
            except (transport.TransportError, OSError) as e:
                self._mark_dead(rid, reason=f"connect: {e}")
        if self.recovered:
            self._republish_newest()
        for name, target in (("accept", self._accept_loop),
                             ("hb", self._hb_loop)):
            t = threading.Thread(target=target,
                                 name=f"tda-router-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        tevents.emit("router_start", port=self.port,
                     mode=self.cfg.mode, policy=self.cfg.policy,
                     replicas=len(replicas),
                     recovered=self.recovered)
        return self

    def _bind(self, *, retry: bool) -> None:
        attempts = REBIND_ATTEMPTS if retry and self.port else 1
        last: OSError | None = None
        for _ in range(attempts):
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                sock.bind(("127.0.0.1", self.port))
            except OSError as e:
                sock.close()
                last = e
                time.sleep(REBIND_SLEEP)
                continue
            sock.listen(64)
            self._listener = sock
            self.port = sock.getsockname()[1]
            return
        raise OSError(
            f"router could not rebind port {self.port} "
            f"after {attempts} attempts: {last}")

    def _recover(self, records: list) -> list:
        """Roll the WAL forward: base snapshot -> port + membership,
        ``member_dead`` -> dead set, ``publish`` -> center history and
        current version (the hot-swap redo log)."""
        replicas = [tuple(a) for a in self.cfg.replicas]
        for kind, meta, arrays in records:
            if kind == "base":
                self.port = int(meta.get("port", self.port))
                if meta.get("replicas"):
                    replicas = [tuple(a) for a in meta["replicas"]]
            elif kind == "member_dead":
                self._dead.add(int(meta["replica"]))
            elif kind == "member_join":
                self._dead.discard(int(meta["replica"]))
            elif kind == "publish":
                v = int(meta["version"])
                self._history.record(v, arrays or {})
                self.version = max(self.version, v)
        tevents.emit("router_recover", port=self.port,
                     version=self.version, dead=sorted(self._dead))
        return replicas

    def _republish_newest(self) -> None:
        newest = self._history.newest()
        if newest is None:
            return
        version, center = newest
        for rid, link in self._links.items():
            if link.alive and (link.version or 0) < version:
                self._swap_link(link, center, version)

    def seed_history(self, version: int, center: dict) -> None:
        """Record the fleet's initial center so the FIRST publish can
        ride the compressed delta path (no WAL record: recovery's
        dense fallback covers a lost v0)."""
        self._history.record(version, center)
        self.version = max(self.version, int(version))

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
        for link in self._links.values():
            link.close()
        if self._wal is not None:
            self._wal.close()

    def slam(self) -> None:
        """The router-crash drill: drop every socket with no goodbye
        (the WAL file is all that survives — recovery's input)."""
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for conn in list(self._conns):
            for fn in (lambda c=conn: c.shutdown(2),
                       lambda c=conn: c.close()):
                try:
                    fn()
                except OSError:
                    pass
        for link in self._links.values():
            link.close()
        if self._wal is not None:
            self._wal.close()

    # --------------------------------------------------- membership

    def _mark_dead(self, rid: int, *, reason: str = "") -> None:
        with self._lock:
            link = self._links.get(rid)
            if link is None or rid in self._dead:
                return
            link.alive = False
            self._dead.add(rid)
        tevents.emit("router_replica_dead", replica=rid,
                     reason=reason)
        self.log(f"router: replica {rid} dead ({reason})")
        if self._wal is not None:
            with self._wal_lock:
                try:
                    self._wal.append("member_dead", {"replica": rid})
                except (OSError, cluster_wal.WalError):
                    pass  # journalling a death must not kill routing
        link.close()

    def _alive(self) -> list:
        with self._lock:
            return [rid for rid, l in self._links.items() if l.alive]

    def _hb_loop(self) -> None:
        cfg = self.cfg
        while not self._stop.wait(cfg.hb_interval):
            for rid in self._alive():
                link = self._links[rid]
                try:
                    with link.ctrl_lock:
                        try:
                            kind, meta, _ = transport.request(
                                link._ctrl_sock, "hb",
                                deadline=cfg.hb_timeout)
                        except (transport.TransportError, OSError):
                            # one redial: a transient wire fault on
                            # the control connection is not a death
                            link.redial_ctrl()
                            kind, meta, _ = transport.request(
                                link._ctrl_sock, "hb",
                                deadline=cfg.hb_timeout)
                    if kind != "hb_ok":
                        raise transport.TransportError(
                            f"heartbeat answered {kind!r}")
                    with self._lock:
                        link.version = int(meta["version"])
                        link.last_beat = time.monotonic()
                except (transport.TransportError, OSError) as e:
                    self._mark_dead(rid, reason=f"heartbeat: {e}")
            # readmission sweep: a replica that a transient wire fault
            # condemned is still running — probe the dead set and
            # resurrect whoever answers (the serving-plane mirror of
            # the training cluster's worker-rejoin path; a genuinely
            # killed process refuses the dial and stays dead)
            with self._lock:
                dead = sorted(self._dead)
            for rid in dead:
                self._try_revive(rid)

    def _try_revive(self, rid: int) -> bool:
        old = self._links.get(rid)
        if old is None:
            return False
        fresh = _ReplicaLink(rid, old.addr, self.cfg,
                             count_merge_bytes=old.count_merge_bytes)
        try:
            fresh.connect()
        except (transport.TransportError, OSError):
            return False
        with self._lock:
            self._links[rid] = fresh
            self._dead.discard(rid)
        if self._wal is not None:
            with self._wal_lock:
                try:
                    self._wal.append("member_join", {"replica": rid})
                except (OSError, cluster_wal.WalError):
                    pass
        newest = self._history.newest()
        if newest is not None and (fresh.version or 0) < newest[0]:
            self._swap_link(fresh, newest[1], newest[0])
        tevents.emit("router_replica_revived", replica=rid)
        self.log(f"router: replica {rid} revived")
        return True

    # ----------------------------------------------------- requests

    def request(self, payload, *, key=None, timeout: float = 30.0):
        """Score one request. Returns ``(value, version, replica)`` —
        every reply stamped with the model version it was scored
        under (sharded: the min across shards). Raises
        :class:`ServeOverloadError` on a shed (client retries),
        :class:`NoReplicaError` when no replica can take it."""
        tevents.counter("serve.cluster_requests")
        t0 = time.perf_counter()
        deadline = t0 + timeout
        if self.cfg.mode == "sharded":
            out = self._request_sharded(payload, deadline)
        else:
            out = self._request_routed(payload, key, deadline)
        with self._lock:
            self._latencies.append(time.perf_counter() - t0)
            self._n["replies"] += 1
        tevents.counter("serve.cluster_replies")
        return out

    def _shed(self, err: BaseException):
        with self._lock:
            self._n["sheds"] += 1
        tevents.counter("serve.cluster_sheds")
        raise err

    def _request_routed(self, payload, key, deadline: float):
        attempts = 0
        max_attempts = len(self._links) + 2
        while True:
            with self._lock:
                alive = sorted(r for r, l in self._links.items()
                               if l.alive)
                loads = {r: self._links[r].pending for r in alive}
            if not alive:
                raise NoReplicaError(
                    "no alive replica — the whole fleet is dead")
            rid = self._policy.pick(alive, loads, key=key)
            link = self._links[rid]
            with self._lock:
                link.pending += 1
            try:
                reply = link.batcher.submit(payload)
                value, version = reply.result(
                    max(0.05, deadline - time.perf_counter()))
                return value, version, rid
            except ServeOverloadError as e:
                self._shed(e)
            except ServeClosedError as e:
                if link.alive:
                    self._shed(e)
            except (transport.TransportError, OSError):
                pass  # fall through to the re-route bookkeeping
            finally:
                with self._lock:
                    link.pending -= 1
            # the batch this request rode died with its replica (or
            # the link closed under us): mark, count, re-route
            self._mark_dead(rid, reason="score connection lost")
            with self._lock:
                self._n["reroutes"] += 1
            tevents.counter("serve.cluster_reroutes")
            attempts += 1
            if attempts >= max_attempts:
                raise NoReplicaError(
                    f"request re-routed {attempts}x without an "
                    f"alive replica accepting it")

    def _request_sharded(self, payload, deadline: float):
        alive = sorted(self._alive())
        n_shards = len(self.cfg.replicas)
        if len(alive) < n_shards:
            raise NoReplicaError(
                f"sharded fleet needs all {n_shards} shards alive, "
                f"have {sorted(alive)} — sharding has no redundancy")
        pending = []
        for rid in alive:
            link = self._links[rid]
            with self._lock:
                link.pending += 1
            pending.append((rid, link.batcher.submit(payload)))
        parts, versions = [], []
        error: BaseException | None = None
        for rid, reply in pending:
            link = self._links[rid]
            try:
                value, version = reply.result(
                    max(0.05, deadline - time.perf_counter()))
                parts.append((rid, value))
                versions.append(version)
            except ServeOverloadError as e:
                error = error or e
            except (ServeClosedError, transport.TransportError,
                    OSError) as e:
                self._mark_dead(rid, reason="score connection lost")
                error = error or NoReplicaError(
                    f"shard {rid} died mid-request: {e}")
            finally:
                with self._lock:
                    link.pending -= 1
        if error is not None:
            if isinstance(error, ServeOverloadError):
                self._shed(error)
            raise error
        value = self._merge(parts)
        return value, min(versions), -1

    def _merge(self, parts: list):
        """Cross-process candidate merge for ONE request — sparse
        pairs through ``merge_topk_pairs_host`` (identical order to
        the in-process ring merge) or dense block reassembly + the
        same two-key top-k. Run even for a single shard so routed and
        sharded replies share one code path (stable identity)."""
        k = self.cfg.k_top
        if self.cfg.merge == "sparse":
            all_v = np.stack([np.asarray(v, np.float32)[None, :]
                              for _, (v, _i) in parts])
            all_i = np.stack([np.asarray(i, np.int32)[None, :]
                              for _, (_v, i) in parts])
            vals, idx = pcomms.merge_topk_pairs_host(all_v, all_i,
                                                     k=k)
            return vals[0], idx[0]
        blocks = sorted(((off, np.asarray(s, np.float32))
                         for _, (s, off) in parts),
                        key=lambda t: t[0])
        full = np.concatenate([s for _, s in blocks])
        gidx = np.arange(full.shape[0], dtype=np.int32)
        order = np.lexsort((gidx, -full))[:k]
        return full[order], gidx[order]

    # ------------------------------------------------------ hot-swap

    def publish(self, center: dict, version: int) -> dict:
        """Land a new center in every live replica: journal it (the
        WAL write happens BEFORE any replica sees the version — the
        write-ahead contract), then per replica push a version-pinned
        compressed delta against its cached center, falling back to a
        dense snapshot when the replica's base is gone or stale."""
        version = int(version)
        center = {k: np.asarray(v, np.float32)
                  for k, v in center.items()}
        with self._pub_lock:
            self._history.record(version, center)
            if self._wal is not None:
                with self._wal_lock:
                    self._wal.append("publish", {"version": version},
                                     center)
            self.version = max(self.version, version)
            swapped, modes = [], {}
            for rid in sorted(self._alive()):
                mode = self._swap_link(self._links[rid], center,
                                       version)
                if mode:
                    swapped.append(rid)
                    modes[rid] = mode
        with self._lock:
            self._n["swaps"] += 1
        tevents.counter("serve.cluster_swaps")
        tevents.emit("router_publish", version=version,
                     swapped=swapped, modes=modes)
        return {"version": version, "swapped": swapped,
                "modes": modes}

    def _swap_link(self, link: _ReplicaLink, center: dict,
                   version: int) -> str | None:
        """Returns the landed mode (``delta``/``dense``) or None.
        Swaps are idempotent on the replica (a version it already
        holds acks ``swap_ok``), so a transient wire fault redials
        once and replays before the death verdict."""
        for attempt in (0, 1):
            try:
                return self._swap_link_once(link, center, version)
            except (transport.TransportError, OSError) as e:
                if attempt == 0:
                    try:
                        with link.ctrl_lock:
                            link.redial_ctrl()
                        continue
                    except (transport.TransportError, OSError):
                        pass
                self._mark_dead(link.rid, reason=f"swap: {e}")
                return None

    def _swap_link_once(self, link: _ReplicaLink, center: dict,
                        version: int) -> str | None:
        cfg = self.cfg
        with link.ctrl_lock:
            have = link.version
            delta = (self._history.delta_since(have, version)
                     if self._pull_codec is not None else None)
            if delta is not None:
                arrays, _ = pcomms.encode_tree(
                    self._pull_codec, delta, None,
                    pcomms.PULL_SEED_TAG, link.rid, int(have),
                    version)
                kind, meta, _ = transport.request(
                    link._ctrl_sock, "swap",
                    {"mode": "delta", "cv": version,
                     "base": int(have)}, arrays,
                    deadline=cfg.rpc_deadline)
                if kind == "swap_ok":
                    link.version = int(meta["version"])
                    return "delta"
                # swap_stale: replica's base moved under us — fall
                # through to the dense snapshot
            kind, meta, _ = transport.request(
                link._ctrl_sock, "swap",
                {"mode": "dense", "cv": version}, center,
                deadline=cfg.rpc_deadline)
            if kind != "swap_ok":
                raise transport.TransportError(
                    f"swap answered {kind!r}")
            link.version = int(meta["version"])
            return "dense"

    # -------------------------------------------------- client wire

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
            threading.Thread(target=self._serve_client, args=(conn,),
                             name="tda-router-client",
                             daemon=True).start()

    def _serve_client(self, conn: socket.socket) -> None:
        self._conns.add(conn)
        try:
            while not self._stop.is_set():
                try:
                    kind, meta, arrays = transport.recv_frame(
                        conn, deadline=4 * self.cfg.rpc_deadline)
                except transport.TransportTimeout:
                    continue
                meta = meta or {}
                if kind == "stop":
                    transport.send_frame(conn, "bye", {},
                                         deadline=self.cfg.
                                         rpc_deadline)
                    break
                if kind != "route":
                    transport.send_frame(
                        conn, "error",
                        {"error": f"unknown frame kind {kind!r}"},
                        deadline=self.cfg.rpc_deadline)
                    continue
                reply = self._route_frame(meta, arrays or {})
                transport.send_frame(conn, *reply,
                                     deadline=self.cfg.rpc_deadline)
        except transport.TransportError:
            pass
        finally:
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _route_frame(self, meta: dict, arrays: dict) -> tuple:
        try:
            value, version, rid = self.request(
                arrays["x"], key=meta.get("key"),
                timeout=float(meta.get("timeout", 30.0)))
        except (ServeOverloadError, ServeClosedError):
            return ("reply", {"status": "shed"}, None)
        except Exception as e:  # noqa: BLE001 — the wire carries the
            #                      failure; the client decides
            return ("reply", {"status": "failed",
                              "error": str(e)}, None)
        if isinstance(value, tuple):
            out = {"vals": np.asarray(value[0], np.float32),
                   "idx": np.asarray(value[1], np.int32)}
        else:
            out = {"y": np.asarray(value)}
        return ("reply", {"status": "ok", "version": version,
                          "replica": rid}, out)

    # --------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            n = dict(self._n)
            alive = sorted(r for r, l in self._links.items()
                           if l.alive)
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        qms = [round(x * 1e3, 3) for x in lat]

        def pct(p):
            if not qms:
                return 0.0
            return qms[min(len(qms) - 1, int(p * len(qms)))]

        return {"qps": round(n["replies"] / elapsed, 2),
                "p50_ms": pct(0.50), "p99_ms": pct(0.99),
                "replies": n["replies"], "sheds": n["sheds"],
                "reroutes": n["reroutes"], "swaps": n["swaps"],
                "alive": alive, "dead": sorted(self._dead),
                "version": self.version, "port": self.port}

    def emit_gauges(self) -> dict:
        """Publish the latency/throughput gauges (the bench + report
        surface: ``serve.cluster_qps`` / ``_p50_ms`` / ``_p99_ms``)."""
        s = self.stats()
        tevents.gauge("serve.cluster_qps", s["qps"])
        tevents.gauge("serve.cluster_p50_ms", s["p50_ms"])
        tevents.gauge("serve.cluster_p99_ms", s["p99_ms"])
        return s


# ---------------------------------------------------------------- client


class RouterClient:
    """A remote client of one router: ``route`` frames over a single
    framed-TCP connection (the CLI / cross-process surface; in-process
    callers use :meth:`Router.request` directly)."""

    def __init__(self, host: str, port: int, *,
                 deadline: float = 30.0):
        self._sock = transport.connect(host, port, deadline=deadline)
        self._deadline = deadline
        self._lock = threading.Lock()

    def request(self, payload, *, key=None, timeout: float = 30.0):
        meta = {"timeout": timeout}
        if key is not None:
            meta["key"] = key
        with self._lock:
            kind, rmeta, arrays = transport.request(
                self._sock, "route", meta,
                {"x": np.asarray(payload)},
                deadline=max(self._deadline, timeout + 5.0))
        rmeta = rmeta or {}
        if kind != "reply":
            raise transport.TransportError(
                f"router answered {kind!r}")
        status = rmeta.get("status")
        if status == "shed":
            raise ServeOverloadError("router shed the request")
        if status != "ok":
            raise RuntimeError(
                f"router request failed: {rmeta.get('error')}")
        if "y" in (arrays or {}):
            value = arrays["y"]
        else:
            value = (arrays["vals"], arrays["idx"])
        return value, int(rmeta["version"]), int(rmeta["replica"])

    def close(self) -> None:
        try:
            with self._lock:
                transport.request(self._sock, "stop",
                                  deadline=self._deadline)
        except (transport.TransportError, OSError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass
