"""A device trace of a bounded slice of the window, reduced to what the
per-layer readers need.

The slice runs under ``torch.profiler`` (CPU and, with a card, CUDA
activity; CUPTI on the card) inside a ``bench.window`` annotation that
ends after a synchronize. The Chrome trace goes to a temporary folder
under ``TMPDIR`` and is deleted once read. From it:

  * device operations: every kernel, copy and fill, with its interval;
  * busy time: the union of those intervals inside the window, so two
    streams at once count once;
  * idle gaps: the spans of the window no device operation covers, each
    named by the innermost host event running at its midpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import torch

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime",
                       "cuda_driver"})
WINDOW = "bench.window"
NAME_CHARS = 120


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")") and "::" in name:
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name.strip()[:NAME_CHARS]


class Trace:
    """Device operations and host events of one traced window (seconds,
    on the trace's clock)."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("the trace holds no bench.window annotation")
        w = win[0]
        self.start = w["ts"] * 1e-6
        self.end = (w["ts"] + w["dur"]) * 1e-6
        self.device_ops = []
        self.host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, b = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
            if e.get("cat") in DEVICE_CATS:
                if b > self.start and a < self.end:
                    self.device_ops.append((max(a, self.start),
                                            min(b, self.end), e["name"]))
            elif e.get("cat") in HOST_CATS and e["name"] != WINDOW:
                self.host.append((a, b, e["name"]))
        self.device_ops.sort()

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list:
        out = []
        for a, b, _ in self.device_ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_time(self, *names) -> float:
        """Seconds of the device operations whose name holds any of
        ``names``."""
        return sum(b - a for a, b, n in self.device_ops
                   if any(s in n for s in names))

    def top_ops(self, k: int = 10) -> list:
        tot: dict = {}
        for a, b, n in self.device_ops:
            n = short_name(n)
            tot[n] = tot.get(n, 0.0) + (b - a)
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda p: -p[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((a + b) / 2), b - a] for a, b in gaps[:k]]

    def _host_at(self, t: float) -> str:
        best = None
        for a, b, n in self.host:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, n)
        return "host: " + (best[2] if best else "between recorded ops")


def traced(fn, *, device) -> Trace:
    """Run ``fn()`` under the profiler inside the window annotation and
    return its :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Trace(events)
