"""Profiling and tracing (port of ``tpu_distalg/utils/profiling.py``).

:func:`trace` is a ``torch.profiler.profile`` over CPU activity, plus
the card's (CUDA, read through CUPTI) when one is in use, that writes a
Chrome trace (``*.pt.trace.json``, for Perfetto or ``chrome://tracing``)
into a directory; :func:`maybe_trace` is the one-liner behind the
command line's ``--profile DIR``. :func:`steps_per_sec` is an honest
throughput that waits for the card before it reads the clock.
``tools/profiling.py`` reads device time by op from the same profiler.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_distalg_torch.utils.metrics import wait_for_device

#: file-name suffix of the traces :func:`trace` writes
TRACE_SUFFIX = ".pt.trace.json"


def maybe_trace(logdir, *, cuda: bool | None = None,
                name: str | None = None):
    """``trace(logdir)`` when a directory is given, else a no-op
    context — the one-liner behind every ``--profile DIR`` flag."""
    return (trace(logdir, cuda=cuda, name=name) if logdir
            else contextlib.nullcontext())


@contextlib.contextmanager
def trace(logdir: str, *, cuda: bool | None = None,
          name: str | None = None):
    """Trace the block and write ``<host>_<pid>.<ms>.pt.trace.json``
    into ``logdir`` on exit; yields the profiler. ``cuda`` adds the
    card's activity (default: when this torch sees a card); ``name``
    labels the whole block in the trace (``record_function``)::

        with profiling.trace("/tmp/trace"):
            out = train_fn(...)
    """
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    label = (torch.profiler.record_function(name) if name
             else contextlib.nullcontext())
    with profile(activities=activities) as prof:
        try:
            with label:
                yield prof
        finally:
            wait_for_device()
    # tda: ignore[TDA001] -- names the trace file (as torch.profiler's
    # tensorboard_trace_handler does); never feeds a computed value
    name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1e3)}"
    prof.export_chrome_trace(os.path.join(logdir, name + TRACE_SUFFIX))


def steps_per_sec(fn, *args, steps: int, repeats: int = 3,
                  warmup: bool = True, with_output: bool = False,
                  with_stats: bool = False, chain: int = 1):
    """Best-of-``repeats`` throughput of ``fn(*args)``, where one call
    runs ``steps`` steps. Each timed repeat enqueues ``chain``
    back-to-back calls and then waits for the card
    (``torch.cuda.synchronize``, where the JAX package fetches a leaf),
    so the number is device throughput, not dispatch rate.

    ``with_output=True`` appends the last output; ``with_stats=True``
    appends ``{"repeats", "chain", "best", "median", "min"}`` of the
    per-repeat rates (the JAX package's keys): run-to-run rates spread,
    and a best-of number means little without its spread."""
    def run(n_calls=chain):
        for _ in range(n_calls):
            out = fn(*args)
        wait_for_device()
        return out

    # one call builds and primes the path
    out = run(1) if warmup else None
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run()
        rates.append(chain * steps / (time.perf_counter() - t0))
    stats = {
        "repeats": repeats,
        "chain": chain,
        "best": round(max(rates), 2),
        "median": round(float(np.median(rates)), 2),
        "min": round(min(rates), 2),
    }
    result = (max(rates),)
    if with_stats:
        result += (stats,)
    if with_output:
        result += (out,)
    return result[0] if len(result) == 1 else result
