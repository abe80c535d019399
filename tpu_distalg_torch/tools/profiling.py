"""Device time by op and the card's idle share, from ``torch.profiler``
(CUPTI), for the port's profiling tools."""

from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def device_us(prof) -> dict[str, float]:
    """Device µs by kernel or copy name over a profiled run."""
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        out[e.key] = out.get(e.key, 0.0) + float(us)
    return out


def window(run, steps: int,
           groups: dict[str, tuple[str, ...]] | None = None) -> dict:
    """Time ``run()`` (``steps`` steps or iterations): once to warm,
    once on the host's clock ending in a synchronize (the wall time),
    once under the profiler (the device time by op). Per step: wall µs,
    device µs, the top 8 ops, and the idle share 1 − device / wall;
    with ``groups``, also the share of the device time spent in the ops
    whose names contain one of each group's strings, and for "other"
    the rest."""
    run()                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = {k: v / steps for k, v in device_us(prof).items()}
    total = sum(dev.values())
    top = dict(sorted(dev.items(), key=lambda kv: -kv[1])[:8])
    out = {"wall_us_per_step": wall_us,
           "device_us_per_step": total,
           "device_idle_share": 1.0 - total / wall_us,
           "device_us_per_step_by_op": top}
    def share(marks):
        return sum(us for k, us in dev.items()
                   if any(m in k for m in marks)) / total

    if groups:
        by = {name: share(marks) for name, marks in groups.items()}
        by["other"] = 1.0 - sum(by.values())
        out["share_of_device_time_by_group"] = by
    return out
