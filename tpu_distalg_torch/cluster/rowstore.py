"""The row store's fault-schedule compiler (a part of
``tpu_distalg/cluster/rowstore.py``, ``:389-416``).

The coordinator compiles its ``cluster:ps`` schedule through
:func:`compile_point_schedule` even with the replicated parameter server
(``cluster/coordinator.py``, ``cluster/local.py``), as the JAX package's
does. The sharded row store itself (``RowStore``, ``--ps-mode
rowstore``, ``run_cluster_pagerank``) waits for ROADMAP A12.5.
"""

from __future__ import annotations

import numpy as np

from tpu_distalg_torch.faults import registry as fregistry

#: schedule cell code for a kill (hang cells hold seconds)
KILL_CELL = -1.0


def compile_point_schedule(point: str, n_windows: int, n_cols: int = 1,
                           *, plan=None) -> np.ndarray:
    """The plan-pure fault schedule for one fleet point: one probe per
    (window, col) cell in row-major order against a fresh quiet
    registry — same discipline as ``worker.compile_worker_schedule``.
    Cell ``KILL_CELL`` = kill, > 0 = hang/straggle argument."""
    live = fregistry.active()
    if plan is None:
        plan = live.plan if live is not None else None
    out = np.zeros((n_windows, n_cols), np.float64)
    if plan is None or not any(r.point == point for r in plan.rules):
        return out
    reg = fregistry.FaultRegistry(plan, quiet=True)
    for w in range(n_windows):
        for c in range(n_cols):
            hit = reg.probe(point)
            if hit is None:
                continue
            kind, arg = hit
            if kind == "kill":
                out[w, c] = KILL_CELL
            else:
                out[w, c] = float(
                    arg if arg is not None
                    else fregistry.DEFAULT_HANG_SECONDS)
    if live is not None and live.plan == plan:
        live.record(reg.fired)
    return out
