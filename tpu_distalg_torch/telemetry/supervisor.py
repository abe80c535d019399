"""Supervised execution: a deadline, retries with backoff and jitter.

Port of ``tpu_distalg/telemetry/supervisor.py``. :func:`supervised`
runs a callable under a per-attempt deadline (in a worker thread),
records every attempt as a telemetry event, retries the failures worth
retrying with exponential backoff and jitter, and on exhaustion either
calls the caller's ``fallback`` after a ``degraded`` event or emits a
machine-readable event and raises. ``utils/checkpoint.save`` and
``data/cache.build_cache`` ride it for transient disk faults;
:func:`init_backend` initialises CUDA under it. Event and counter
names are the JAX package's.

A hung attempt's worker thread cannot be killed (a wedged native call
is like that); it is a daemon thread that dies with the process.
Retries after a timeout are single-flight: the next attempt waits
another deadline on the same call instead of racing a second call
against it, and a fresh call starts only once the previous one ended.

Unlike the JAX package, :func:`init_backend` has no CPU fallback: the
port runs on the card it was asked for or raises
(:class:`BackendUnavailableError`), and ``fallback="cpu"`` is refused.
A caller's own ``fallback`` callable stays allowed.
"""

from __future__ import annotations

import random
import sys
import threading
import time
from typing import Callable

from tpu_distalg_torch.telemetry import events


class BackendUnavailableError(RuntimeError):
    """Backend init failed or hung through every retry."""


def _call_with_deadline(fn: Callable, timeout: float | None,
                        pending=None):
    """Run ``fn()`` with a deadline; returns ``(ok, value_or_exc,
    timed_out, pending)``. On a timeout the still-running call comes
    back as ``pending``: passed in again, the same call is awaited for
    another ``timeout`` (single flight)."""
    if timeout is None:
        try:
            return True, fn(), False, None
        except Exception as e:  # noqa: BLE001 — judged by the caller
            return False, e, False, None
    if pending is not None:
        th, box, done = pending
    else:
        box = {}
        done = threading.Event()

        def work():
            try:
                # tda: ignore[TDA020] -- single-writer box: the reader
                # only looks after done.wait(), and done.set() in the
                # finally below is the release that orders this write
                box["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                # tda: ignore[TDA020] -- same Event-ordered handoff
                box["error"] = e
            finally:
                done.set()

        th = threading.Thread(target=work, daemon=True,
                              name="tda-supervised")
        th.start()
    if not done.wait(timeout):
        return False, None, True, (th, box, done)
    if "error" in box:
        return False, box["error"], False, None
    return True, box["value"], False, None


def supervised(fn: Callable, *, phase: str,
               timeout: float | None = None, retries: int = 0,
               backoff: float = 1.0, backoff_cap: float = 60.0,
               jitter: float = 0.1, retry_on=(Exception,),
               fallback: Callable | None = None,
               sleep: Callable[[float], None] = time.sleep,
               rng: Callable[[], float] = random.random,
               log: Callable[[str], None] | None = None,
               event: str = "supervised",
               retry_event: str | None = None,
               exhausted_event: str | None = None,
               stall_on_timeout: bool = False,
               failure_counter: str | None = None,
               error_cls: type | None = None):
    """Run ``fn()`` under supervision; returns its value.

    ``timeout``: per-attempt deadline in seconds (``None``: none).
    ``retries``: attempts after the first. ``backoff``: the first retry
    delay, doubling per retry up to ``backoff_cap``, times ``1 +
    jitter·U[0,1)``. ``retry_on``: the exception classes worth a retry;
    any other raises at once after its attempt is recorded.
    ``fallback``: called on exhaustion after a ``degraded`` event;
    without one ``exhausted_event`` is emitted and ``error_cls``
    (wrapping the last error) or the last error itself is raised (a
    timeout is a ``TimeoutError``).

    Telemetry: one ``event`` record per attempt (``outcome`` ok, error
    or timeout, and ``seconds``), ``retry_event`` (default
    ``<event>_retry``) before each backoff sleep, a ``stall`` record on
    a timeout when ``stall_on_timeout``, and ``failure_counter`` bumped
    per failed attempt. Failing attempts do not advance the progress
    mark, so a heartbeat sees a retry storm as one stalled phase."""
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    retry_event = retry_event or f"{event}_retry"
    exhausted_event = exhausted_event or f"{event}_exhausted"
    label = phase.replace("_", " ")
    emit_err = log or (lambda m: print(f"[supervisor] {m}",
                                       file=sys.stderr))
    n_attempts = retries + 1
    last_err: Exception | None = None
    pending = None
    for attempt in range(1, n_attempts + 1):
        t0 = time.monotonic()
        ok, value, timed_out, pending = _call_with_deadline(
            fn, timeout, pending)
        dt = round(time.monotonic() - t0, 3)
        if ok:
            events.emit(event, phase=phase, attempt=attempt,
                        of=n_attempts, outcome="ok", seconds=dt)
            return value
        if timed_out:
            err_txt = f"hung past the {timeout}s deadline"
            last_err = (error_cls or TimeoutError)(
                f"{phase} attempt {attempt}/{n_attempts} {err_txt}")
        else:
            err_txt = f"{type(value).__name__}: {value}"
            last_err = value
        events.emit(event, phase=phase, attempt=attempt, of=n_attempts,
                    outcome="timeout" if timed_out else "error",
                    seconds=dt, error=err_txt)
        if timed_out and stall_on_timeout:
            events.emit("stall", phase=phase,
                        seconds_since_mark=round(
                            time.monotonic() - events.last_mark()[0], 3),
                        attempt_seconds=dt, stall_after=timeout)
        if failure_counter:
            events.counter(failure_counter)
        emit_err(f"{label} failed (attempt {attempt}/{n_attempts}): "
                 f"{err_txt}")
        if not timed_out and not isinstance(value, retry_on):
            raise value
        if attempt < n_attempts:
            delay = min(backoff * (2 ** (attempt - 1)), backoff_cap)
            delay *= 1.0 + jitter * rng()
            events.emit(retry_event, phase=phase, attempt=attempt,
                        sleep_seconds=round(delay, 3))
            sleep(delay)
    if fallback is not None:
        events.emit("degraded", phase=phase, attempts=n_attempts,
                    fallback=getattr(fallback, "__name__", str(fallback)),
                    error=str(last_err))
        emit_err(f"{label} unavailable after {n_attempts} attempts — "
                 f"degrading via {getattr(fallback, '__name__', fallback)}")
        return fallback()
    events.emit(exhausted_event, phase=phase, attempts=n_attempts,
                error=str(last_err))
    if error_cls is None:
        raise last_err
    raise error_cls(
        f"{phase} failed after {n_attempts} attempts: {last_err}"
    ) from (last_err if isinstance(last_err, Exception) else None)


def _default_init(device=None):
    """Initialise CUDA on the resolved card: ``torch.cuda.init()`` and
    one small allocation there. Returns the device."""
    import torch

    from tpu_distalg_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
    return dev


def init_backend(timeout: float | None = None, retries: int = 0,
                 backoff: float = 1.0, *, backoff_cap: float = 60.0,
                 jitter: float = 0.1, init_fn: Callable | None = None,
                 device=None, fallback: Callable | None = None,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Callable[[], float] = random.random,
                 log: Callable[[str], None] | None = None):
    """Initialise the backend under :func:`supervised`; returns
    ``init_fn()``'s value (default: CUDA initialised on ``device``,
    ``cuda`` unless told, and that device returned). Events
    ``backend_init`` / ``backend_retry`` / ``degraded`` /
    ``backend_unavailable`` and the counter ``backend_init_failures``,
    as in the JAX package.

    The ``backend:init`` fault seam fires inside each attempt, inside
    the deadline's worker, so an injected hang meets the same deadline
    a real one does. ``fallback`` is a callable invoked on exhaustion
    after a ``degraded`` event; ``None`` emits ``backend_unavailable``
    and raises :class:`BackendUnavailableError`. ``fallback="cpu"``
    raises ``ValueError``: the port does not degrade to the CPU."""
    from tpu_distalg_torch import faults

    if isinstance(fallback, str):
        raise ValueError(
            f"init_backend(fallback={fallback!r}): the port has no device "
            f"fallback — a run asked for the card fails on exhaustion "
            f"(BackendUnavailableError) instead of quietly carrying on "
            f"on the CPU; pass a callable to handle exhaustion yourself")
    if init_fn is None:
        def init_fn():
            return _default_init(device)

    def guarded_init():
        faults.inject("backend:init")
        return init_fn()

    value = supervised(
        guarded_init, phase="backend_init", timeout=timeout,
        retries=retries, backoff=backoff, backoff_cap=backoff_cap,
        jitter=jitter, retry_on=(Exception,), fallback=fallback,
        sleep=sleep, rng=rng, log=log, event="backend_init",
        retry_event="backend_retry",
        exhausted_event="backend_unavailable", stall_on_timeout=True,
        failure_counter="backend_init_failures",
        error_cls=BackendUnavailableError)
    events.mark("backend_ready")
    return value
