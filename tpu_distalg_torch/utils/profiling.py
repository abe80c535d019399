"""Profiling and tracing (port of ``tpu_distalg/utils/profiling.py``).

:func:`trace` is a ``torch.profiler.profile`` over CPU activity, plus
the card's (CUDA, read through CUPTI) when one is in use, that writes a
Chrome trace (``*.pt.trace.json``, for Perfetto or ``chrome://tracing``)
into a directory; :func:`maybe_trace` is the one-liner behind the
command line's ``--profile DIR``; the trace carries the program's own
spans (``telemetry/events.span``: ``ssgd.call``, ``ssgd.launch``, …)
as ``user_annotation`` ranges on the profiler's clock.
``tools/profiling.py`` reads device time by op from the same profiler.
A rate is the benchmark's (``benchmark/``), over a window.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

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
