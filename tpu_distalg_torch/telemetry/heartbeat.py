"""Liveness heartbeat and stall detection (port of
``tpu_distalg/telemetry/heartbeat.py``).

A daemon thread emits a ``heartbeat`` event every ``interval`` seconds
with the newest progress mark's phase and age (:func:`events.last_mark`)
and the counters so far. When ``stall_after`` is set and no mark lands
within it, one ``stall`` event fires per frozen mark, naming the stuck
phase, and the optional ``on_stall`` callback runs. ``beat()`` takes an
injected clock, so tests exercise the stall logic without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from tpu_distalg_torch.telemetry import events

DEFAULT_INTERVAL_SECONDS = 10.0
DEFAULT_STALL_SECONDS = 120.0


class Heartbeat(threading.Thread):
    """``start()`` it once; ``stop()`` returns promptly."""

    def __init__(self, interval: float = DEFAULT_INTERVAL_SECONDS,
                 stall_after: float | None = DEFAULT_STALL_SECONDS, *,
                 on_stall: Callable[[str, float], None] | None = None,
                 emit_fn=None, now=time.monotonic):
        super().__init__(name="tda-heartbeat", daemon=True)
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.interval = interval
        self.stall_after = stall_after
        self.on_stall = on_stall
        self._emit = emit_fn or events.emit
        self._now = now
        self._halt = threading.Event()
        self.n_beats = 0
        self.n_stalls = 0
        self.n_errors = 0
        self._flagged_mark: float | None = None

    def run(self) -> None:
        while not self._halt.wait(self.interval):
            self.safe_beat()

    def safe_beat(self) -> None:
        """:meth:`beat`, but a failing sink (a full disk) does not end
        the thread: stall detection stays armed."""
        try:
            self.beat()
        except Exception:  # noqa: BLE001 — liveness must outlive I/O
            self.n_errors += 1

    def beat(self) -> None:
        """One heartbeat and stall check."""
        t_mark, phase = events.last_mark()
        age = self._now() - t_mark
        sink = events.get_sink()
        self._emit("heartbeat", phase=phase,
                   seconds_since_mark=round(age, 3),
                   counters=sink.counters() if sink is not None else {})
        self.n_beats += 1
        if (self.stall_after is not None and age > self.stall_after
                and self._flagged_mark != t_mark):
            # one stall per frozen mark; a new mark re-arms detection
            self._flagged_mark = t_mark
            self.n_stalls += 1
            self._emit("stall", phase=phase,
                       seconds_since_mark=round(age, 3),
                       stall_after=self.stall_after)
            if self.on_stall is not None:
                self.on_stall(phase, age)

    def stop(self) -> None:
        self._halt.set()


def start_heartbeat(interval: float = DEFAULT_INTERVAL_SECONDS,
                    stall_after: float | None = DEFAULT_STALL_SECONDS,
                    on_stall=None) -> Heartbeat | None:
    """Start a heartbeat when it would do anything (telemetry on, or an
    ``on_stall`` action given); returns the thread or ``None``."""
    if not events.enabled() and on_stall is None:
        return None
    hb = Heartbeat(interval, stall_after, on_stall=on_stall)
    hb.safe_beat()  # a run shorter than one interval still records one
    hb.start()
    return hb
