"""Request-level micro-batching: bounded queue → deadline-or-size
dispatch → one batched predict → scatter replies.

Port of ``tpu_distalg/serve/batcher.py`` with the same semantics:

  * the request queue is BOUNDED — a full queue sheds the request with
    :class:`ServeOverloadError`, carried in its :class:`Reply`, instead
    of growing without limit;
  * a batch dispatches when it holds ``max_batch`` requests or
    ``max_delay_ms`` after its first request, whichever comes first;
  * every blocking ``get`` carries a timeout, so the dispatch thread
    always sees the stop flag;
  * ``close()`` drains the loop and fails whatever is still queued;
  * the predictor makes exactly one device→host copy per batch, never
    one per request.

A failed batch fails that batch's replies and the loop keeps serving.
Each dispatch passes the ``data:gather`` fault seam inside its
``serve:batch`` span (JAX ``serve/batcher.py:237-239``); across
processes only the leader dispatches, so the seam fires there and a
failed batch is never sent to the followers.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

from tpu_distalg_torch import faults
from tpu_distalg_torch.telemetry import events as tevents

#: idle poll interval of the dispatch loop's first-request wait
POLL_SECONDS = 0.05

#: latency samples kept per batcher (the newest window)
MAX_LATENCY_SAMPLES = 200_000


class ServeOverloadError(RuntimeError):
    """The bounded request queue is full — this request was SHED."""


class ServeClosedError(RuntimeError):
    """The batcher is shutting down; the request was not served."""


class Reply:
    """One request's reply slot, resolved exactly once by the dispatch
    thread with a value or an error. ``latency_s`` is submit→resolve
    wall time."""

    __slots__ = ("_event", "_value", "_error", "_t_submit", "latency_s")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None
        self._t_submit = time.perf_counter()
        self.latency_s: float | None = None

    def _resolve(self, value=None, error: BaseException | None = None):
        self.latency_s = time.perf_counter() - self._t_submit
        self._value = value
        self._error = error
        self._event.set()

    @property
    def error(self) -> BaseException | None:
        return self._error

    def result(self, timeout: float = 30.0):
        """Wait (bounded) for the reply; raises the request's error."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"no reply within {timeout}s — server wedged or closed?")
        if self._error is not None:
            raise self._error
        return self._value


@dataclasses.dataclass
class BatcherStats:
    """Mutated only under the owning batcher's lock."""

    requests: int = 0
    replies: int = 0
    batches: int = 0
    shed: int = 0
    failed_batches: int = 0
    failed_requests: int = 0
    max_queue_depth: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)


class MicroBatcher:
    """One served model's queue and dispatch thread.

    ``predict(payloads)`` gets 1 ≤ len ≤ ``max_batch`` raw payloads and
    returns one reply value per payload."""

    def __init__(self, name: str, predict, *, max_batch: int = 16,
                 max_delay_ms: float = 5.0, queue_depth: int = 128):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {queue_depth}")
        self.name = name
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.queue_depth = int(queue_depth)
        self._predict = predict
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._lock = threading.Lock()
        self._stats = BatcherStats()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"serve-batch-{name}")
        self._thread.start()

    def submit(self, payload) -> Reply:
        """Enqueue one request. Never blocks: a full queue sheds it."""
        reply = Reply()
        if self._stop.is_set():
            reply._resolve(error=ServeClosedError(
                f"{self.name}: batcher closed"))
            return reply
        try:
            self._q.put_nowait((payload, reply))
        except queue.Full:
            with self._lock:
                self._stats.shed += 1
            tevents.counter("serve.shed")
            tevents.emit("serve_shed", model=self.name,
                         queue_depth=self.queue_depth)
            reply._resolve(error=ServeOverloadError(
                f"{self.name}: request queue full "
                f"(depth {self.queue_depth}) — shed; retry with backoff"))
            return reply
        if self._stop.is_set():
            # close() may have drained between our stop check and the
            # put: nobody else would read this entry, so sweep it here
            self._drain_closed()
            return reply
        with self._lock:
            self._stats.requests += 1
            depth = self._q.qsize()
            if depth > self._stats.max_queue_depth:
                self._stats.max_queue_depth = depth
        return reply

    def snapshot(self) -> BatcherStats:
        with self._lock:
            return dataclasses.replace(
                self._stats, latencies_s=list(self._stats.latencies_s))

    def close(self, timeout: float = 10.0):
        """Stop the dispatch loop (it finishes the batch in hand), then
        fail anything still queued with :class:`ServeClosedError`."""
        self._stop.set()
        self._thread.join(timeout)
        self._drain_closed()

    def _drain_closed(self):
        while True:
            try:
                _, reply = self._q.get_nowait()
            except queue.Empty:
                break
            reply._resolve(error=ServeClosedError(
                f"{self.name}: batcher closed with request queued"))

    def _loop(self):
        while True:
            try:
                first = self._q.get(timeout=POLL_SECONDS)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_delay_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break  # deadline hit with a partial batch
            self._dispatch(batch)

    def _dispatch(self, batch):
        payloads = [p for p, _ in batch]
        replies = [r for _, r in batch]
        try:
            with tevents.span("serve:batch", model=self.name,
                              n=len(batch)):
                # staging the micro-batch: the data:gather seam, before
                # anything of the batch is sent to another process
                faults.inject("data:gather")
                out = self._predict(payloads)
        except Exception as e:  # noqa: BLE001 — a failed batch fails
            #                     its replies, never the dispatch loop
            with self._lock:
                self._stats.batches += 1
                self._stats.failed_batches += 1
                self._stats.failed_requests += len(batch)
            tevents.counter("serve.requests", len(batch))
            tevents.counter("serve.batches")
            tevents.counter("serve.failed_batches")
            tevents.emit("serve_batch_failed", model=self.name,
                         n=len(batch), error=f"{type(e).__name__}: {e}")
            for r in replies:
                r._resolve(error=e)
            return
        for r, value in zip(replies, out):
            r._resolve(value=value)
        with self._lock:
            self._stats.batches += 1
            self._stats.replies += len(batch)
            lat = self._stats.latencies_s
            for r in replies:
                lat.append(r.latency_s)
            if len(lat) > MAX_LATENCY_SAMPLES:
                del lat[:len(lat) - MAX_LATENCY_SAMPLES]
        tevents.counter("serve.requests", len(batch))
        tevents.counter("serve.batches")
