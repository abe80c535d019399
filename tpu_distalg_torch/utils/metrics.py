"""Accuracy, the finite-weights guard, EWMA smoothing, plots and a
step timer.

Port of ``tpu_distalg/utils/metrics.py`` (``binary_accuracy``,
``guard_finite``, ``ewma``, ``draw_acc_plot``, ``display_clusters``,
``StepTimer``). The plots need matplotlib, which is imported only when
a plot is asked for; where it is not installed, asking for one raises an
ImportError that names it.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def binary_accuracy(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Accuracy with the reference's decision rule, predict 1 iff
    σ(z) >= 0.5, i.e. z >= 0; a float32 scalar tensor. The mean is the
    count times float32(1/n), as XLA computes ``jnp.mean`` (116/171 is
    then 0.6783626, where a division would give 0.67836255)."""
    pred = torch.where(logits < 0.0, 0.0, 1.0)
    hits = (pred == labels).to(torch.float32).sum()
    return hits * torch.tensor(1.0 / labels.numel(), dtype=torch.float32,
                               device=hits.device)


def guard_finite(tensors, context: str):
    """Raise FloatingPointError if a floating tensor (or array) holds
    NaN or Inf; returns its argument."""
    items = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    for x in items:
        t = torch.as_tensor(x)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"non-finite values in {context} — check eta/"
                f"regularisation/input data")
    return tensors


def ewma(values, alpha: float = 0.9) -> np.ndarray:
    """EWMA with the reference's recurrence s[t] = α·s[t-1] +
    (1-α)·v[t], s[0] = v[0]."""
    values = np.asarray(values, dtype=np.float64)
    out = np.empty_like(values)
    if len(values) == 0:
        return out
    out[0] = values[0]
    for i in range(1, len(values)):
        out[i] = alpha * out[i - 1] + (1 - alpha) * values[i]
    return out


def _pyplot():
    """matplotlib's pyplot on the Agg backend (files, no display)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plots need the matplotlib package, which this Python does "
            "not have: install matplotlib, or drop --plot") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_acc_plot(accs, path: str, alpha: float = 0.9,
                  title: str = "Accuracy on test dataset") -> None:
    """Raw and EWMA accuracy curves, saved to ``path``."""
    plt = _pyplot()
    accs = np.asarray(accs)
    xs = np.arange(1, len(accs) + 1)
    fig, ax = plt.subplots()
    ax.plot(xs, accs, color="C0", alpha=0.3)
    ax.plot(xs, ewma(accs, alpha), color="C0")
    ax.set_title(title)
    ax.set_xlabel("Round")
    ax.set_ylabel("Accuracy")
    fig.savefig(path)
    plt.close(fig)


def display_clusters(points, assignments, path: str, k: int | None = None
                     ) -> None:
    """2-D cluster scatter plot saved to ``path`` — the reference's
    ``display_clusters`` (``k-means.py:30-40``), with stable per-cluster
    colours instead of its random hex strings."""
    points = np.asarray(points)
    assignments = np.asarray(assignments)
    if points.shape[1] != 2:
        raise ValueError("display_clusters draws 2-D points only")
    plt = _pyplot()
    k = k if k is not None else int(assignments.max()) + 1
    fig, ax = plt.subplots()
    for c in range(k):
        sel = assignments == c
        ax.scatter(points[sel, 0], points[sel, 1], s=12, label=f"c{c}")
    ax.legend(loc="best", fontsize=8)
    fig.savefig(path)
    plt.close(fig)


class StepTimer:
    """Wall-clock timer for device work. Launches return before the
    device is done, so assign the work's output to ``.result`` inside
    the block — ``__exit__`` waits for the card (a synchronize, where
    the JAX package blocks on the result) before reading the clock::

        with StepTimer() as t:
            t.result = train_fn(...)
        print(t.elapsed)
    """

    def __init__(self):
        self._t0 = None
        self.elapsed = 0.0
        self.result = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None and self.result is not None:
            wait_for_device()
        self.elapsed = time.perf_counter() - self._t0
        return False


def wait_for_device() -> None:
    """Wait for the card's queued work (nothing to wait for while CUDA
    is not initialised in this process)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
