"""Structured runtime telemetry — thread-safe JSONL events.

A minimal copy of the JAX package's ``telemetry/events.py`` with the
same event schema (``ev``, ``t_wall``, ``t_mono``, ``run``, ``pid``,
``host`` plus event fields), so ``tda report`` reads the port's files
too, the sync layer's ``comm.*``, ``ssp.*`` and membership counters,
gauges and events included (``parallel/comms.py``, ``ssp.py``,
``membership.py``, under the JAX package's names), the recovery
shell's (``restart``, ``quarantine``, ``preempted``, ``heartbeat``,
``stall``, ``backend_init``, ``fault_injected``, ``chaos_verdict``)
and :func:`mark`, whose newest value the heartbeat reads
(:func:`last_mark`). Telemetry is on when :func:`configure` is given a directory or
``$TDA_TELEMETRY_DIR`` is set, and every emitting function is a no-op
otherwise. Counters are kept in memory and flushed as one ``counters``
event when the sink closes.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import socket
import sys
import threading
import time
import uuid

ENV_DIR = "TDA_TELEMETRY_DIR"

_LOCK = threading.Lock()  # guards the _SINK swap only
_SINK: EventSink | None = None
#: (monotonic seconds, phase) of the newest :func:`mark`
_LAST_MARK: tuple[float, str] = (time.monotonic(), "start")


class EventSink:
    """``events-<run>.jsonl`` under ``directory``; one lock serialises
    every line, so concurrent emitters never splice lines."""

    def __init__(self, directory: str, run_id: str | None = None):
        os.makedirs(directory, exist_ok=True)
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.directory = directory
        self.path = os.path.join(directory, f"events-{self.run_id}.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._host = socket.gethostname()
        self.closed = False
        self.write("run_start", argv=list(sys.argv))

    def _record(self, ev: str, fields: dict) -> str:
        return json.dumps(
            {"ev": ev, "t_wall": round(time.time(), 6),
             "t_mono": round(time.monotonic(), 6), "run": self.run_id,
             "pid": os.getpid(), "host": self._host, **fields},
            default=str)

    def write(self, ev: str, **fields) -> None:
        line = self._record(ev, fields) + "\n"
        with self._lock:
            if not self.closed:
                self._f.write(line)

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def close(self) -> None:
        end = self._record("counters", {"counters": self.counters()}) \
            + "\n" + self._record("run_end", {}) + "\n"
        with self._lock:
            if self.closed:
                return
            self.closed = True
            self._f.write(end)
            self._f.close()


def configure(directory: str | None | bool = None, *,
              run_id: str | None = None) -> EventSink | None:
    """Select the process-global sink. ``None`` falls back to
    ``$TDA_TELEMETRY_DIR``; ``False`` disables even when the variable
    is set. Replacing an active sink closes it."""
    global _SINK
    if directory is False:
        directory = None
    else:
        directory = directory or os.environ.get(ENV_DIR) or None
    with _LOCK:
        old, _SINK = _SINK, None
    if old is not None:
        old.close()
    if directory:
        sink = EventSink(directory, run_id=run_id)
        with _LOCK:
            _SINK = sink
    return _SINK


def enabled() -> bool:
    return _SINK is not None


def get_sink() -> EventSink | None:
    return _SINK


def emit(ev: str, **fields) -> None:
    """Append one event — a no-op when telemetry is off."""
    sink = _SINK
    if sink is not None:
        sink.write(ev, **fields)


def mark(phase: str, emit_event: bool = True) -> None:
    """Record main-loop progress (the JAX package's ``events.mark``):
    always the in-memory mark, and a ``mark`` event unless
    ``emit_event=False``."""
    global _LAST_MARK
    _LAST_MARK = (time.monotonic(), str(phase))
    if emit_event:
        sink = _SINK
        if sink is not None:
            sink.write("mark", phase=phase)


def last_mark() -> tuple[float, str]:
    """(monotonic seconds, phase) of the newest mark."""
    return _LAST_MARK


def counter(name: str, n: int = 1) -> None:
    sink = _SINK
    if sink is not None:
        sink.bump(name, n)


def gauge(name: str, value, **fields) -> None:
    emit("gauge", name=name, value=value, **fields)


@contextlib.contextmanager
def span(name: str, **fields):
    """``span_start``/``span_end`` (with ``seconds``, ``ok`` and, on
    failure, ``error``) around the body, and a mark at both edges."""
    mark(name, emit_event=False)
    sink = _SINK
    if sink is None:
        yield
        return
    t0 = time.monotonic()
    sink.write("span_start", name=name, **fields)
    err = None
    try:
        yield
    except BaseException as e:
        err = f"{type(e).__name__}: {e}"
        raise
    finally:
        end = dict(fields)
        end.update(seconds=round(time.monotonic() - t0, 6),
                   ok=err is None)
        if err is not None:
            end["error"] = err
        sink.write("span_end", name=name, **end)
        mark(name, emit_event=False)


@atexit.register
def _close_default_sink() -> None:
    sink = _SINK
    if sink is not None:
        sink.close()
