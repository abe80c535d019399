"""Where the PageRank sweep's time goes on the card, at bench.py's
geometry (``erdos_renyi_edges(1_000_000, 8.0, seed=0)``: 7,999,981
edges after dedupe, standard mode, 50 iterations a call), for this
checkout or for several in turn.

    python -m tpu_distalg_torch.tools.pagerank_profile
    python -m tpu_distalg_torch.tools.pagerank_profile --trees \\
        build/parent . . build/parent

Each tree (a checkout's root; ``.`` is this one) runs in its own
process with its own build of the kernels, in the order given, so that
two versions compare in turns on one card. The graph is prepared once,
on the host, and handed to every tree. Per tree it prints one JSON
object per line:

  * ``kernels``: B7 (``spmv_table``) and B8 (``scatter_table``) at the
    main shape and on the skewed graph (below), device ms a call by CUDA
    events over back-to-back calls and by CUPTI (``torch.profiler``, the
    kernels whose names hold ``csr_``), with the prepared plan where the
    tree has one; the gather ceiling (``gather_ceiling``) where the tree
    has it;
  * per sweep, for ``scatter='auto'`` (B7), ``'pallas'`` (torch gather +
    B8), ``'xla'`` (the library's sparse CSR product) and reference mode
    (B7 twice an iteration): 50 iterations' wall time (the window ends in
    ``torch.cuda.synchronize()``), the device time of each kernel or
    copy, their sum, the device's idle share (1 − device time / wall
    time) and iterations/s on the wall clock.

The skewed graph: V 1,000,000, in-degrees
``np.minimum(np.random.default_rng(0).zipf(2.0, V), 100_000)`` (8,109,611
edges; the 2,372 rows of 256 edges or more hold 54% of them), src uniform
from the same generator, built directly as CSR rows.

It uses only the wrappers', the model's and the graph prep's public
entry points, so it times any checkout of the port.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N_VERTICES, AVG_DEGREE, ITERS = 1_000_000, 8.0, 50
#: calls a kernel timing averages over
KERNEL_CALLS = 200
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = os.path.join(os.path.dirname(_PKG), "build", "pagerank_profile",
                     "graph.npz")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def skewed_rows(v: int = N_VERTICES, seed: int = 0):
    """(row_ptr (v+1,) int32, src int32) of the skewed graph."""
    import numpy as np

    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(2.0, v), 100_000)
    rp = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=rp[1:])
    src = rng.integers(0, v, size=int(rp[-1])).astype(np.int32)
    return rp.astype(np.int32), src


def prepare_graph(path: str = GRAPH) -> str:
    """The main shape's deduplicated edges, saved once for the trees."""
    import numpy as np

    from tpu_distalg_torch.ops import graph as gops
    from tpu_distalg_torch.utils import datasets

    el = gops.prepare_edges(
        datasets.erdos_renyi_edges(N_VERTICES, AVG_DEGREE, seed=0),
        N_VERTICES)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, src=el.src, dst=el.dst, out_degree=el.out_degree)
    return path


def _event_ms(fn, calls: int) -> float:
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _cupti_ms(fn, calls: int) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_distalg_torch.tools.profiling import device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(us for k, us in device_us(prof).items()
               if "csr_" in k) / calls / 1e3


def _kernel_times(pk, rp, src, w, x, plan) -> dict:
    """B7, B8 (and the ceiling) on one CSR, events and CUPTI."""
    import torch

    extra = () if plan is None else (plan,)
    c = torch.index_select(x, 0, src) * w
    runs = {"B7": lambda: pk.spmv_table(rp, src, w, x, *extra),
            "B8": lambda: pk.scatter_table(rp, c, *extra)}
    if hasattr(pk, "gather_ceiling"):
        runs["gather_ceiling"] = lambda: pk.gather_ceiling(rp, src, w, x,
                                                           *extra)
    out = {}
    for key, fn in runs.items():
        out[f"{key}_event_ms"] = _event_ms(fn, KERNEL_CALLS)
        out[f"{key}_cupti_ms"] = _cupti_ms(fn, KERNEL_CALLS)
    return out


def run(label: str, graph: str) -> None:
    """Measure the checkout whose package is on sys.path."""
    import numpy as np
    import torch

    from tpu_distalg_torch.models import pagerank
    from tpu_distalg_torch.ops import graph as gops
    from tpu_distalg_torch.ops import pagerank_kernels as pk
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.tools.profiling import window

    mesh = get_mesh(data=1, device="cuda")
    dev = mesh.device
    g = np.load(graph)
    el = gops.EdgeList(src=g["src"], dst=g["dst"], n_vertices=N_VERTICES,
                       out_degree=g["out_degree"])
    t0 = time.perf_counter()
    de = pagerank.prepare_device_edges(el, mesh)
    torch.cuda.synchronize()
    head = {"tree": label, "card": card(), "torch": torch.__version__,
            "package": os.path.dirname(pk.__file__)}
    # tda: ignore[TDA100] -- not a checkpoint payload: one line of the
    # profile's output, from which nothing resumes
    print(json.dumps({**head, "n_vertices": el.n_vertices,
                      "n_edges": el.n_edges,
                      "device_prep_s": time.perf_counter() - t0}),
          flush=True)

    rp, src, w = de.shards[0]
    plan = getattr(de, "plans", [None])[0]
    x = torch.as_tensor(np.random.default_rng(17).random(N_VERTICES).astype(
        np.float32), device=dev)
    kernels = {"main": _kernel_times(pk, rp, src, w, x, plan)}
    srp, ssrc = (torch.as_tensor(a, device=dev) for a in skewed_rows())
    sw = torch.as_tensor(np.random.default_rng(18).random(
        ssrc.shape[0]).astype(np.float32), device=dev)
    splan = pk.tile_plan(srp, ssrc.shape[0]) if plan is not None else None
    kernels["skewed"] = _kernel_times(pk, srp, ssrc, sw, x, splan)
    kernels["skewed"]["n_edges"] = int(ssrc.shape[0])
    print(json.dumps({**head, "kernels": kernels}), flush=True)
    del srp, ssrc, sw

    for mode, scatter in (("standard", "auto"), ("standard", "pallas"),
                          ("standard", "xla"), ("reference", "auto")):
        fn = pagerank.make_run_fn(mesh, pagerank.PageRankConfig(
            n_iterations=ITERS, mode=mode, scatter=scatter), el.n_vertices)
        win = window(lambda: fn(de), ITERS)
        print(json.dumps({**head, "mode": mode, "scatter": scatter,
                          "iterations": ITERS,
                          "iters_per_s": 1e6 / win["wall_us_per_step"],
                          **win}), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--run"]:
        run(argv[1], argv[2])
        return 0
    trees = argv[1:] if argv[:1] == ["--trees"] else ["."]
    graph = prepare_graph()
    for tree in trees:
        root = os.path.abspath(tree)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--run",
                        tree, graph], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root), check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
