"""Where a Lloyd iteration's time goes on the card, at bench.py's
geometry (10,000,000 points × 16 dims from ``gaussian_mixture_rows(k=8,
seed=0, spread=8.0)`` made on the card, k = 8, farthest-point init, 50
iterations a call).

    python -m tpu_distalg_torch.tools.kmeans_profile

For ``make_fit_fn_fused`` (kernel B10) and ``make_fit_fn`` (torch ops:
distance matmul, argmin, one-hot matmul) it runs 50 iterations under
``torch.profiler`` (CUPTI) and prints, per iteration, the host's wall
time (the window ends in ``torch.cuda.synchronize()``), the device time
of each kernel or copy, their sum, and the device's idle share
(1 − device time / wall time). One JSON object per line. Each fit ends
with one more assignment pass over the points, which the per-iteration
numbers include (a fiftieth of it each).
"""

from __future__ import annotations

import json
import time

import torch

from tpu_distalg_torch.models import kmeans
from tpu_distalg_torch.parallel import build_sharded, get_mesh
from tpu_distalg_torch.tools.profiling import window
from tpu_distalg_torch.utils import datasets

N_POINTS, DIM, K, ITERS, SPREAD = 10_000_000, 16, 8, 50, 8.0


def main() -> int:
    mesh = get_mesh(data=1, device="cuda")
    t0 = time.perf_counter()
    make_rows, _ = datasets.gaussian_mixture_rows(k=K, dim=DIM, seed=0,
                                                  spread=SPREAD)
    cfg = kmeans.KMeansConfig(k=K, n_iterations=ITERS, seed=0,
                              init="farthest")
    ps = build_sharded(mesh, N_POINTS, make_rows)
    c0 = kmeans.init_centers_scaled(make_rows, N_POINTS, cfg, mesh.device)
    X2, m2 = kmeans.pack_device(mesh, ps.data, ps.mask, dim=DIM, k=K)
    torch.cuda.synchronize()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "n_points": N_POINTS,
                      "dim": DIM, "k": K,
                      "setup_s": time.perf_counter() - t0}))
    fused = kmeans.make_fit_fn_fused(mesh, cfg, DIM)
    plain = kmeans.make_fit_fn(mesh, cfg)
    for name, run in (("make_fit_fn_fused", lambda: fused(X2, m2, c0)),
                      ("make_fit_fn", lambda: plain(ps.data, ps.mask, c0))):
        print(json.dumps({"path": name, "iterations": ITERS,
                          **window(run, ITERS)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
