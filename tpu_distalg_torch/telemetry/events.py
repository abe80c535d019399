"""Structured runtime telemetry — thread-safe JSONL events and spans.

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

:func:`span` has three states. Off (no sink, no profiler, no
:func:`recording`) it marks and does nothing else, so the trainers'
hot loops keep their spans. While a ``torch.profiler`` session or
:func:`recording` records, each span is a ``record_function`` range on
the profiler's clock, timed on the card by a pair of CUDA events at its
edges, and kept in a bounded in-memory buffer (:func:`recorded`). With
a sink, call-level spans write their lines and fine spans only add to
them. Importing this module imports no torch.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import socket
import sys
import threading
import time
import uuid

ENV_DIR = "TDA_TELEMETRY_DIR"

_LOCK = threading.Lock()  # guards the _SINK swap and _RECORDING
_SINK: EventSink | None = None
#: (monotonic seconds, phase) of the newest :func:`mark`
_LAST_MARK: tuple[float, str] = (time.monotonic(), "start")
#: open :func:`recording` blocks
_RECORDING = 0
#: a sink is set or a block records: the one flag an idle span reads
_ON = False
#: most spans the buffer keeps; past it the oldest go
MAX_RECORDED = 1 << 16
_REC_LOCK = threading.Lock()  # guards the buffer and the event pool
_RECORDED: collections.deque = collections.deque()
#: device index -> free timing events
_POOL: dict[int, list] = {}
_LOCAL = threading.local()
_MODULES = sys.modules
_monotonic = time.monotonic


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
        _set_on()
    if old is not None:
        old.close()
    if directory:
        sink = EventSink(directory, run_id=run_id)
        with _LOCK:
            _SINK = sink
            _set_on()
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


#: what :func:`span` returns while nothing records or writes: one shared
#: object whose edges do nothing
_OFF = contextlib.nullcontext()


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session records: torch's own flag,
    read without importing torch."""
    prof = _MODULES.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class Span:
    """One span while telemetry records or writes: the context manager
    :func:`span` returns, and the record :func:`recorded` returns.

    ``t0``/``t1`` are its host edges (``time.perf_counter`` seconds),
    ``parent`` the span open around it on its thread (or None), ``ok``
    False when its body raised. ``device_s`` is, on a card, the seconds
    the current CUDA stream took from reaching the opening edge to
    reaching the closing one (the span's device work and the idle it
    left between), filled by :func:`recorded`; None off the card."""

    __slots__ = ("name", "fields", "fine", "parent", "t0", "t1", "ok",
                 "device_s", "_rec", "_sink", "_rf", "_ev", "_children")

    def __init__(self, name: str, fine: bool, fields: dict, rec: bool,
                 sink: EventSink | None):
        self.name, self.fields, self.fine = name, fields, fine
        self._rec, self._sink = rec, sink
        self.parent = self._rf = self._ev = self._children = None
        self.t0 = self.t1 = 0.0
        self.ok = True
        self.device_s = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self._sink is not None and not self.fine:
            self._children = {}
            self._sink.write("span_start", name=self.name, **self.fields)
        if self._rec:
            self._open_edge()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.perf_counter()
        stack = _stack()
        if self in stack:
            stack.remove(self)
        self.ok = exc_type is None
        if self._rec:
            self._close_edge()
            _keep(self)
        if self._sink is not None:
            if self.fine:
                self._add_to_call()
            else:
                self._write_end(exc_type, exc)
            mark(self.name, emit_event=False)
        return False

    def _open_edge(self) -> None:
        """A ``record_function`` range under the span's name (a
        ``user_annotation`` in a profiler's trace) and, on a card, a
        timing event on the current stream."""
        torch = _MODULES.get("torch")
        if torch is None:   # nothing of torch runs in this process
            return
        self._rf = torch.autograd.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_initialized():
            self._ev = _timing_events(torch)
            self._ev[1].record()

    def _close_edge(self) -> None:
        if self._ev is not None:
            self._ev[2].record()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def _add_to_call(self) -> None:
        """Count a fine span and its host seconds into the call-level
        span around it, which writes them in its ``span_end``."""
        call = self.parent
        while call is not None and call._children is None:
            call = call.parent
        if call is not None:
            c = call._children.setdefault(self.name, [0, 0.0])
            c[0] += 1
            c[1] += self.t1 - self.t0

    def _write_end(self, exc_type, exc) -> None:
        end = dict(self.fields)
        end.update(seconds=round(self.t1 - self.t0, 6), ok=self.ok)
        if exc_type is not None:
            end["error"] = f"{exc_type.__name__}: {exc}"
        if self._children:
            end["children"] = {k: [n, round(s, 6)]
                               for k, (n, s) in self._children.items()}
        self._sink.write("span_end", name=self.name, **end)

    def _settle(self) -> None:
        """Read the device seconds once the closing edge is reached and
        give the events back to the pool."""
        ev = _take_events(self)
        if ev is None:
            return
        dev, start, stop = ev
        stop.synchronize()
        self.device_s = start.elapsed_time(stop) / 1e3
        _release(dev, start, stop)


def span(name: str, *, fine: bool = False, **fields):
    """A span around the body, and a mark at its opening edge.

    With no sink, no :func:`recording` and no profiler it is one shared
    object that does nothing more. While a ``torch.profiler`` session or
    :func:`recording` records, the span is a ``record_function`` range
    of its name, is timed on the card at its edges, and is kept for
    :func:`recorded`. With a sink, a call-level span writes
    ``span_start``/``span_end`` (with ``seconds``, ``ok``, on failure
    ``error``, and ``children``), and a mark at its closing edge too; a
    ``fine`` span writes no line: its count and host seconds go into
    the ``children`` of the call-level span around it, ``{name: [count,
    seconds]}``."""
    global _LAST_MARK
    _LAST_MARK = (_monotonic(), name)
    if not _ON and not _profiling():
        return _OFF
    return Span(name, fine, fields, _RECORDING > 0 or _profiling(), _SINK)


def _timing_events(torch) -> tuple:
    """(device, start, stop): two timing events of the current device,
    from the pool where it has them."""
    dev = torch.cuda.current_device()
    with _REC_LOCK:
        free = _POOL.setdefault(dev, [])
        if len(free) >= 2:
            return (dev, free.pop(), free.pop())
    return (dev, torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _take_events(s: Span) -> tuple | None:
    with _REC_LOCK:
        ev, s._ev = s._ev, None
    return ev


def _release(dev: int, *evs) -> None:
    with _REC_LOCK:
        _POOL.setdefault(dev, []).extend(evs)


def _drop(s: Span) -> None:
    """Give a span's events back unread (its device seconds stay None)."""
    ev = _take_events(s)
    if ev is not None:
        _release(*ev)


def _keep(s: Span) -> None:
    """Into the buffer; past :data:`MAX_RECORDED` the oldest goes."""
    with _REC_LOCK:
        _RECORDED.append(s)
        old = _RECORDED.popleft() if len(_RECORDED) > MAX_RECORDED else None
    if old is not None:
        _drop(old)


def _clear() -> None:
    with _REC_LOCK:
        old = list(_RECORDED)
        _RECORDED.clear()
    for s in old:
        _drop(s)


def _set_on() -> None:
    global _ON
    _ON = _SINK is not None or _RECORDING > 0


@contextlib.contextmanager
def recording():
    """Record every span of the block, as under a profiler: the buffer
    is emptied first, and what the block recorded stays readable by
    :func:`recorded` after it."""
    global _RECORDING
    _clear()
    with _LOCK:
        _RECORDING += 1
        _set_on()
    try:
        yield
    finally:
        with _LOCK:
            _RECORDING -= 1
            _set_on()


def recorded(name: str | None = None) -> list[Span]:
    """The spans recorded (under a profiler or :func:`recording`), the
    oldest first, those named ``name`` only when it is given; their
    ``device_s`` read from the card (which waits for it to reach
    them)."""
    with _REC_LOCK:
        out = [s for s in _RECORDED if name is None or s.name == name]
    for s in out:
        s._settle()
    return out


@atexit.register
def _close_default_sink() -> None:
    sink = _SINK
    if sink is not None:
        sink.close()
