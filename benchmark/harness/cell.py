"""One run of one cell: set-up, the measured (or traced) window, the
check against the reference, the metrics, the result's last line."""

from __future__ import annotations

import contextlib
import json
import math
import sys
import time

import torch

from counts import lr as counts_lr
from harness import imports, program, trace as htrace
from harness.registry import Registry
from reference import compare


class Spans:
    """The benchmark's own spans around calls into the program:
    seconds by name."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t)


class ForbiddenImport(RuntimeError):
    pass


def _check_imports(when: str) -> None:
    bad = imports.forbidden()
    if bad:
        raise ForbiddenImport(f"{when}: forbidden modules loaded: "
                              + ", ".join(bad))


def run_cell(reg: Registry, name: str, *, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> dict:
    """Run cell ``name`` and return its result object (the last line)."""
    cell = reg.cell(name)
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    limits = reg.limits(name)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    drv = reg.driver(traffic["driver"]).Driver(config, traffic, seed, dev)
    spans = Spans()
    drv.setup(spans)
    program.sync(dev)
    setup_s = time.perf_counter() - t_start
    _check_imports("after set-up")

    tokens, tr = [], None
    if trace:
        def body():
            for _ in range(traffic["trace_segments"]):
                tokens.append(drv.segment())

        tr = htrace.traced(body, device=dev)
        window_s = tr.window_s
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            tokens.append(drv.segment())
        program.sync(dev)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    drv.free()

    ref = drv.reference()
    numbers = drv.numbers(drv.prog, ref)
    correct, checks = compare.judge(numbers, limits)
    work = drv.work(tokens)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ctx = {"setup_s": setup_s, "spans": spans.seconds, "trace": tr,
           "window": dict(work, seconds=window_s), "config": config,
           "traffic": traffic, "peaks": counts_lr.peaks(kind)}
    metrics = {}
    for m in reg.metrics(name, trace):
        v = reg.reader(m["name"])(ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    result = {"correct": bool(correct), "attempted": work["attempted"],
              "failed": 0, "metrics": metrics, "device": device_info}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
    result["checks"] = checks
    _check_imports("after the window")
    return result


def print_result(result: dict, out=None, err=None) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
