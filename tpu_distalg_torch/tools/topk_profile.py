"""Where the serving path's time goes on the card: the fused top-k
kernel's device time beside the host's time per call, the library line
(``torch.matmul`` + ``torch.topk``) beside it, and one served
micro-batch split into its device operations.

    python -m tpu_distalg_torch.tools.topk_profile

Cases: the serving shape (B 32, d 64, N 16,384) at k 10, 256 and 1000,
and N 1,048,576 at k 10. Device times come from ``torch.profiler``
(CUPTI): the kernel's is the sum over every kernel whose name holds
"topk", with the count of those launches a call; the library's is every
device activity of its calls. Wall times are the host's clock around
back-to-back calls that end in ``torch.cuda.synchronize()``. It uses the
wrapper's public entry point only, so it times any checkout of the
port. Prints the card's name and power limit, then one JSON object per
line.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpu_distalg_torch.ops import topk
from tpu_distalg_torch.serve import artifacts
from tpu_distalg_torch.utils.device import resolve_device

#: (N, k, calls): the serving shape at three k, and a million items
CASES = ((16384, 10, 200), (1 << 20, 10, 50), (16384, 256, 50),
         (16384, 1000, 20))


def _device(prof) -> dict[str, tuple[float, int]]:
    """Device µs and launch count per device activity over the window."""
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        t, n = out.get(e.key, (0.0, 0))
        out[e.key] = (t + float(us), n + int(e.count))
    return out


def _profile(fn, calls: int):
    """(wall ms a call, {activity: (device µs, launches)} over ``calls``)."""
    for _ in range(5):
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
    return wall_ms, _device(prof)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def main() -> int:
    dev = resolve_device("cuda")
    print(card())
    rng = np.random.default_rng(0)
    B, d = 32, 64
    for N, k, calls in CASES:
        Q = torch.as_tensor(rng.normal(size=(B, d)).astype(np.float32),
                            device=dev)
        V = torch.as_tensor(rng.normal(size=(N, d)).astype(np.float32),
                            device=dev)
        wall_ms, act = _profile(
            lambda: topk.fused_matmul_topk(Q, V, 0, N, k=k), calls)
        mine = {n: v for n, v in act.items() if "topk" in n}
        lib_wall, lib_act = _profile(
            lambda: torch.topk(Q @ V.T, k, dim=1), calls)
        print(json.dumps({
            "what": "fused_matmul_topk", "B": B, "d": d, "N": N, "k": k,
            "calls": calls,
            "device_ms_per_call": sum(t for t, _ in mine.values())
            / calls / 1e3,
            "launches_per_call": sum(n for _, n in mine.values()) / calls,
            "device_ms_by_kernel": {n: t / calls / 1e3
                                    for n, (t, _) in mine.items()},
            "wall_ms_per_call": wall_ms,
            "library_device_ms_per_call": sum(
                t for t, _ in lib_act.values()) / calls / 1e3,
            "library_wall_ms_per_call": lib_wall}))
        del Q, V

    U = rng.normal(size=(4096, 64)).astype(np.float32)
    V = rng.normal(size=(16384, 64)).astype(np.float32)
    model = artifacts.als_model(U, V, device=dev, k_top=10)
    calls = 100
    for fill in (8, 32):
        ids = list(rng.integers(0, 4096, size=fill))
        wall_ms, act = _profile(lambda: model.predict_batch(ids, 32), calls)
        print(json.dumps({
            "what": "als predict_batch", "max_batch": 32, "requests": fill,
            "host_wall_ms_per_batch": wall_ms,
            "device_ms_per_batch": {n: t / calls / 1e3
                                    for n, (t, _) in act.items()},
            "device_ms_total": sum(t for t, _ in act.values())
            / calls / 1e3}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
