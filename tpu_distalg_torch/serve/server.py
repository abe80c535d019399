"""The serving front end (port of ``tpu_distalg/serve/server.py``): one
:class:`MicroBatcher` per served model, aggregate latency and
throughput stats, and the closed-loop load generator.

The request surface is in-process, ``submit(model, payload) -> Reply``;
any RPC layer composes on top of it.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from tpu_distalg_torch.parallel.mesh import Mesh
from tpu_distalg_torch.serve import artifacts as serve_artifacts
from tpu_distalg_torch.serve.batcher import MicroBatcher, Reply
from tpu_distalg_torch.telemetry import events as tevents


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
    item factors are split over the mesh's model axis."""

    def __init__(self, mesh: Mesh, config: ServeConfig = ServeConfig()):
        self.mesh = mesh
        self.config = config
        self._models: dict[str, serve_artifacts.ServedModel] = {}
        self._batchers: dict[str, MicroBatcher] = {}
        self._t0 = time.perf_counter()
        self._closed = False

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
        self._batchers[model.name] = MicroBatcher(
            model.name,
            lambda payloads, m=model: m.predict_batch(
                payloads, cfg.max_batch),
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

    def close(self):
        if self._closed:
            return
        self._closed = True
        for b in self._batchers.values():
            b.close()


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
