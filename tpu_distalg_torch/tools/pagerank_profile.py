"""Where the PageRank sweep's time goes on the card, at bench.py's
geometry (``erdos_renyi_edges(1_000_000, 8.0, seed=0)``: 7,999,981
edges after dedupe, standard mode, 50 iterations a call).

    python -m tpu_distalg_torch.tools.pagerank_profile

For ``scatter='auto'`` (kernel B7), ``'pallas'`` (torch gather + B8),
``'xla'`` (the library's sparse CSR product) and reference mode (B7
twice an iteration) it runs 50 iterations under ``torch.profiler``
(CUPTI) and prints, per iteration, the host's wall time (the window
ends in ``torch.cuda.synchronize()``), the device time of each kernel
or copy, their sum, and the device's idle share (1 − device time /
wall time). One JSON object per line.
"""

from __future__ import annotations

import json
import time

import torch

from tpu_distalg_torch.models import pagerank
from tpu_distalg_torch.ops import graph as gops
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.tools.profiling import window
from tpu_distalg_torch.utils import datasets

N_VERTICES, AVG_DEGREE, ITERS = 1_000_000, 8.0, 50


def main() -> int:
    mesh = get_mesh(data=1, device="cuda")
    t0 = time.perf_counter()
    el = gops.prepare_edges(
        datasets.erdos_renyi_edges(N_VERTICES, AVG_DEGREE, seed=0),
        N_VERTICES)
    de = pagerank.prepare_device_edges(el, mesh)
    torch.cuda.synchronize()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__,
                      "n_vertices": el.n_vertices, "n_edges": el.n_edges,
                      "prep_s": time.perf_counter() - t0}))
    for mode, scatter in (("standard", "auto"), ("standard", "pallas"),
                          ("standard", "xla"), ("reference", "auto")):
        fn = pagerank.make_run_fn(mesh, pagerank.PageRankConfig(
            n_iterations=ITERS, mode=mode, scatter=scatter), el.n_vertices)
        print(json.dumps({"mode": mode, "scatter": scatter,
                          "iterations": ITERS,
                          **window(lambda: fn(de), ITERS)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
