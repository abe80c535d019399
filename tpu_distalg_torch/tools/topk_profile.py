"""Where the serving path's time goes on the card: the fused top-k
kernel's device time beside the host's time per call, and one served
micro-batch split into its device operations.

    python -m tpu_distalg_torch.tools.topk_profile

Device times come from ``torch.profiler`` (CUPTI); host times from the
wall clock around calls that end in ``torch.cuda.synchronize()``. Prints
one JSON object per line.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpu_distalg_torch.ops import topk
from tpu_distalg_torch.serve import artifacts
from tpu_distalg_torch.utils.device import resolve_device


def _device_us(prof) -> dict[str, float]:
    """Device microseconds per device activity (kernel, memcpy) over
    the profiled window."""
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        out[e.key] = out.get(e.key, 0.0) + float(us)
    return out


def _profile(fn, calls: int):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return wall_ms, _device_us(prof)


def main() -> int:
    dev = resolve_device("cuda")
    rng = np.random.default_rng(0)
    calls = 100
    for N in (16384, 1 << 20):
        Q = torch.as_tensor(rng.normal(size=(32, 64)).astype(np.float32),
                            device=dev)
        V = torch.as_tensor(rng.normal(size=(N, 64)).astype(np.float32),
                            device=dev)
        wall_ms, dev_us = _profile(
            lambda: topk.fused_matmul_topk(Q, V, 0, N, k=10), calls)
        kernels = {k: v / calls / 1e3 for k, v in dev_us.items()
                   if "topk" in k}
        print(json.dumps({"what": "fused_matmul_topk", "B": 32, "d": 64,
                          "N": N, "k": 10, "host_wall_ms_per_call": wall_ms,
                          "device_ms_per_call": kernels}))

    U = rng.normal(size=(4096, 64)).astype(np.float32)
    V = rng.normal(size=(16384, 64)).astype(np.float32)
    model = artifacts.als_model(U, V, device=dev, k_top=10)
    for fill in (8, 32):
        ids = list(rng.integers(0, 4096, size=fill))
        wall_ms, dev_us = _profile(lambda: model.predict_batch(ids, 32),
                                   calls)
        print(json.dumps({
            "what": "als predict_batch", "max_batch": 32, "requests": fill,
            "host_wall_ms_per_batch": wall_ms,
            "device_ms_per_batch": {k: v / calls / 1e3
                                    for k, v in dev_us.items()},
            "device_ms_total": sum(dev_us.values()) / calls / 1e3}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
