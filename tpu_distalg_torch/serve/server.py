"""The serving front end (port of ``tpu_distalg/serve/server.py``): one
:class:`MicroBatcher` per served model, aggregate latency and
throughput stats, and the closed-loop load generator.

The request surface is in-process, ``submit(model, payload) -> Reply``;
any RPC layer composes on top of it.

Across processes (a mesh whose data axis spans ``torch.distributed``
processes) every process loads the same models in the same order, and
every process must run each batch on the same payloads: the JAX
package's retrieval replicates the queries over the data axis, but
nothing there makes the hosts' batches agree. Here process 0 leads: it
alone owns the micro-batchers, the load and the stats, and it
broadcasts each dispatched batch (a header, then the packed payload
bytes) before running it. Every other process runs :meth:`Server.follow`:
it receives each batch, runs the same predictor on the same packed
bytes (so its replies equal the leader's bit for bit) and returns when
the leader's :meth:`Server.close` sends the stop. A request that is
shed, or whose payload the leader's packing refuses, is never sent. A
leader idle for :data:`HEARTBEAT_S` sends a no-op, so that a follower's
wait never reaches the group's timeout. A failed broadcast marks the
server broken (:attr:`Server.broken`); a leader that closes with
``abort=True`` sends no stop, and the followers fail when it leaves the
group.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from tpu_distalg_torch.parallel.mesh import Mesh
from tpu_distalg_torch.serve import artifacts as serve_artifacts
from tpu_distalg_torch.serve.batcher import MicroBatcher, Reply
from tpu_distalg_torch.telemetry import events as tevents

#: seconds an idle leader waits before it sends followers a no-op
HEARTBEAT_S = 20.0

#: the kinds of a leader's message header ``[kind, model, n, nbytes]``
_STOP, _BATCH, _NOOP = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (the CLI's ``serve`` flags mirror them)."""

    max_batch: int = 16          # dispatch when this many are queued …
    max_delay_ms: float = 5.0    # … or this long after the batch opens
    queue_depth: int = 128       # bounded queue; full = shed
    k_top: int = 10              # ALS: recommendations per request
    merge: str = "sparse"        # ALS shard merge: sparse pairs | dense
    block_items: int | None = None  # items per CUDA block (None: auto)


class Server:
    """Serve one or more artifacts behind micro-batchers on the mesh's
    device (``parallel.get_mesh``: ``cuda`` unless told otherwise); ALS
    item factors are split over the mesh's model axis. Across processes
    process 0 leads and the others follow (the module docstring)."""

    def __init__(self, mesh: Mesh, config: ServeConfig = ServeConfig()):
        self.mesh = mesh
        self.config = config
        self._models: dict[str, serve_artifacts.ServedModel] = {}
        self._batchers: dict[str, MicroBatcher] = {}
        self._t0 = time.perf_counter()
        self._closed = False
        self._group = mesh.process_count > 1
        self.leader = mesh.process_index == 0
        self._order: list[str] = []      # a message's model index
        self._send_lock = threading.Lock()
        self._last_send = time.monotonic()
        #: the error of a failed broadcast (the group is lost)
        self.broken: BaseException | None = None
        self._beat_stop = threading.Event()
        self._beat = None
        if self._group and self.leader:
            self._beat = threading.Thread(target=self._heartbeat,
                                          daemon=True, name="serve-beat")
            self._beat.start()

    def add_model(self, model: serve_artifacts.ServedModel,
                  *, warm: bool = True) -> serve_artifacts.ServedModel:
        """Register a model and start its batcher. ``warm`` runs one
        padded batch first, so a one-time cost (the kernel build)
        lands here and not in the first request's latency."""
        if model.name in self._models:
            raise ValueError(f"model {model.name!r} already served")
        cfg = self.config
        if warm:
            model.predict_batch([self._dummy_payload(model)],
                                cfg.max_batch)
        self._models[model.name] = model
        self._order.append(model.name)
        if self.leader:
            self._batchers[model.name] = MicroBatcher(
                model.name,
                lambda payloads, m=model: self.dispatch(m.name, payloads),
                max_batch=cfg.max_batch, max_delay_ms=cfg.max_delay_ms,
                queue_depth=cfg.queue_depth)
        tevents.emit("serve_model_added", model=model.name,
                     kind=model.kind, source=model.source,
                     **{k: v for k, v in model.meta.items()
                        if isinstance(v, (int, float, str, bool))})
        return model

    def add_artifact(self, path: str, *, name: str | None = None,
                     warm: bool = True) -> serve_artifacts.ServedModel:
        """Load a checkpoint directory (``artifacts.load_artifact``) and
        serve it."""
        cfg = self.config
        model = serve_artifacts.load_artifact(
            path, self.mesh, name=name, k_top=cfg.k_top, merge=cfg.merge,
            block_items=cfg.block_items)
        return self.add_model(model, warm=warm)

    @staticmethod
    def _dummy_payload(model: serve_artifacts.ServedModel):
        if model.kind == "lr":
            return np.zeros((model.meta["d"],), np.float32)
        if model.kind == "kmeans":
            return np.zeros((model.meta["dim"],), np.float32)
        return np.int64(0)  # als: user id

    @property
    def models(self):
        return dict(self._models)

    def dispatch(self, name: str, payloads) -> list:
        """One batch of model ``name`` (what its batcher runs): packed
        here, sent to the followers across processes, then run. A
        payload the packing refuses raises before anything is sent."""
        model = self._models[name]
        pred = model.predictor(self.config.max_batch)
        packed = pred.pack(payloads)
        if self._group:
            raw = torch.from_numpy(np.ascontiguousarray(packed).reshape(
                -1).view(np.uint8))
            self._send(_BATCH, self._order.index(name), len(payloads), raw)
        return pred.run(packed, len(payloads))

    def _send(self, kind: int, model: int = 0, n: int = 0, raw=None):
        """The leader's message: the header, then ``raw``'s bytes."""
        from tpu_distalg_torch.parallel.collectives import broadcast_bytes

        nbytes = 0 if raw is None else int(raw.numel())
        head = torch.tensor([kind, model, n, nbytes], dtype=torch.int64)
        with self._send_lock:
            if self.broken is not None:
                raise RuntimeError("the serving group is lost") from \
                    self.broken
            try:
                broadcast_bytes(head.view(torch.uint8), head.numel() * 8,
                                self.mesh)
                if nbytes:
                    broadcast_bytes(raw, nbytes, self.mesh)
            except BaseException as e:
                self.broken = e
                raise
            self._last_send = time.monotonic()

    def _heartbeat(self):
        while not self._beat_stop.wait(HEARTBEAT_S / 4):
            if time.monotonic() - self._last_send >= HEARTBEAT_S:
                try:
                    self._send(_NOOP)
                except BaseException:  # noqa: BLE001 — recorded in
                    return             # self.broken; the load sees it

    def follow(self, on_batch=None) -> int:
        """A follower's loop: receive each batch the leader sends, run
        the same predictor on the same packed bytes, until the leader
        closes. ``on_batch(name, packed, replies)`` sees every batch.
        Returns the batches run."""
        from tpu_distalg_torch.parallel.collectives import broadcast_bytes

        if not self._group or self.leader:
            raise RuntimeError("follow() runs on a follower: a process "
                               "other than 0 of a process group")
        n_run = 0
        while True:
            head = broadcast_bytes(None, 32, self.mesh).view(torch.int64)
            kind, model, n, nbytes = (int(v) for v in head)
            if kind == _STOP:
                return n_run
            if kind == _NOOP:
                continue
            name = self._order[model]
            pred = self._models[name].predictor(self.config.max_batch)
            like = pred.pack([])
            raw = broadcast_bytes(None, nbytes, self.mesh)
            packed = raw.numpy().view(like.dtype).reshape(like.shape)
            replies = pred.run(packed, n)
            if on_batch is not None:
                on_batch(name, packed, replies)
            n_run += 1

    def submit(self, name: str, payload) -> Reply:
        batcher = self._batchers.get(name)
        if batcher is None:
            raise KeyError(
                f"no served model {name!r} (have: "
                f"{', '.join(sorted(self._batchers)) or 'none'})")
        return batcher.submit(payload)

    def stats(self) -> dict:
        """Totals, shed and failure counts, latency percentiles and the
        lifetime QPS."""
        per_model = {}
        all_lat: list[float] = []
        totals = dict(requests=0, replies=0, batches=0, shed=0,
                      failed_batches=0, failed_requests=0,
                      max_queue_depth=0)
        for name, b in self._batchers.items():
            s = b.snapshot()
            all_lat.extend(s.latencies_s)
            rec = {k: getattr(s, k) for k in totals}
            rec["mean_batch_fill"] = (
                round(s.replies / s.batches, 2) if s.batches else 0.0)
            per_model[name] = rec
            for k in totals:
                if k == "max_queue_depth":
                    totals[k] = max(totals[k], rec[k])
                else:
                    totals[k] += rec[k]
        elapsed = time.perf_counter() - self._t0
        lat_ms = np.asarray(all_lat, np.float64) * 1e3

        def pct(q):
            return float(np.percentile(lat_ms, q)) if len(lat_ms) else 0.0

        return {
            **totals,
            "elapsed_s": elapsed,
            "qps": totals["replies"] / elapsed if elapsed > 0 else 0.0,
            "p50_ms": pct(50), "p99_ms": pct(99),
            "mean_ms": float(lat_ms.mean()) if len(lat_ms) else 0.0,
            "models": per_model,
        }

    def emit_counters(self) -> dict:
        """Flush the aggregate stats into telemetry gauges
        (``serve.qps``, ``serve.p50_ms``, ``serve.p99_ms``,
        ``serve.queue_depth``); returns them."""
        s = self.stats()
        tevents.gauge("serve.qps", s["qps"])
        tevents.gauge("serve.p50_ms", s["p50_ms"])
        tevents.gauge("serve.p99_ms", s["p99_ms"])
        tevents.gauge("serve.queue_depth", s["max_queue_depth"])
        return s

    def close(self, *, abort: bool = False):
        """Stop serving. A leader across processes drains its batchers
        and then sends the followers the stop, unless ``abort`` (or a
        lost group): then the followers fail when it leaves the
        group."""
        if self._closed:
            return
        self._closed = True
        for b in self._batchers.values():
            b.close()
        self._beat_stop.set()
        if self._beat is not None:
            self._beat.join()
        if self._group and self.leader and not abort and \
                self.broken is None:
            self._send(_STOP)


def run_closed_loop(server: Server, name: str, payloads, *,
                    concurrency: int = 4, retries: int = 0,
                    retry_backoff_s: float = 0.002,
                    timeout: float = 60.0):
    """Closed-loop load: ``concurrency`` workers each submit their
    slice of ``payloads`` one at a time (submit → wait → next).
    ``retries`` > 0 resubmits a shed or failed request after
    ``retry_backoff_s``. Returns ``(results, info)``: ``results[j]`` is
    request j's reply (``None`` if it failed), ``info`` holds qps over
    the generator's own window and the error and retry counts."""
    results = [None] * len(payloads)
    errors = [None] * len(payloads)
    counts = {"retries": 0, "failed": 0}
    lock = threading.Lock()

    def worker(idxs):
        for j in idxs:
            attempt = 0
            while True:
                reply = server.submit(name, payloads[j])
                try:
                    value = reply.result(timeout)
                    with lock:
                        results[j] = value
                        errors[j] = None
                    break
                except Exception as e:  # noqa: BLE001 — shed/failed
                    #                     replies are data here
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
                                name=f"serve-load-{w}")
               for w, s in enumerate(slices)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout * (len(payloads) + 1))
    elapsed = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise TimeoutError("closed-loop workers did not finish")
    n_ok = sum(1 for e in errors if e is None)
    info = {
        "elapsed_s": elapsed,
        "qps": n_ok / elapsed if elapsed > 0 else 0.0,
        "ok": n_ok,
        "failed": counts["failed"],
        "retries": counts["retries"],
        "concurrency": concurrency,
    }
    return results, info
