"""Preemption: SIGTERM is a request to stop at the next boundary.

Port of ``tpu_distalg/faults/preempt.py``. A scheduler that evicts a
run (a spot VM, Kubernetes, slurm's requeue) sends SIGTERM and waits
a grace window. :func:`install` turns the signal into a request: the
handler only sets a flag (nothing that takes a lock or does I/O, so it
cannot deadlock against the main thread it interrupts), and the
segmented loops (``utils/checkpoint.run_segmented``,
``parallel/membership.run_elastic``) check the flag at every boundary
after that boundary's checkpoint is on disk, then raise
:class:`Preempted`. The process exits with :data:`PREEMPTED_RC`, so a
supervisor tells "preempted, re-run me" from a crash, and the re-run
resumes bit for bit.

Across processes the flag of every process travels in the checkpoint
write's all-gather (``utils/checkpoint.save_shared``): one signalled
process stops the whole group at the same boundary, each with rc 75.

SIGINT takes the same path, but a second SIGINT raises
``KeyboardInterrupt`` at once.
"""

from __future__ import annotations

import signal
import threading

#: sysexits.h EX_TEMPFAIL: "temporary failure, retry later" — re-run
#: the same command and it resumes from the boundary checkpoint
PREEMPTED_RC = 75


class Preempted(SystemExit):
    """Raised at the first boundary after a preemption request. A
    ``SystemExit``, so ``run_with_restarts`` never catches it and an
    uncaught one exits with :data:`PREEMPTED_RC`."""

    def __init__(self, step: int | None = None):
        super().__init__(PREEMPTED_RC)
        self.step = step


_REQUESTED = threading.Event()
_SIGNALS_SEEN: list[int] = []
_INSTALLED = False


def _handler(signum, frame):
    del frame
    if signum == signal.SIGINT and _REQUESTED.is_set():
        raise KeyboardInterrupt
    # flag only: the boundary check emits the event
    _SIGNALS_SEEN.append(int(signum))
    _REQUESTED.set()


def install(signals=(signal.SIGTERM, signal.SIGINT)) -> bool:
    """Install the handlers; False off the main thread (where Python
    refuses signal handlers)."""
    global _INSTALLED
    try:
        for s in signals:
            signal.signal(s, _handler)
    except ValueError:
        return False
    _INSTALLED = True
    return True


def installed() -> bool:
    return _INSTALLED


def requested() -> bool:
    """True once a preemption signal (or :func:`request`) arrived."""
    return _REQUESTED.is_set()


def request() -> None:
    """Request preemption from the program (tests, in-process
    schedulers)."""
    _REQUESTED.set()


def signals_seen() -> tuple[int, ...]:
    return tuple(_SIGNALS_SEEN)


def reset() -> None:
    """Clear the request and the record of signals."""
    _REQUESTED.clear()
    _SIGNALS_SEEN.clear()
