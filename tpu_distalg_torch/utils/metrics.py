"""Accuracy, the finite-weights guard and EWMA smoothing.

Port of ``tpu_distalg/utils/metrics.py`` (``binary_accuracy``,
``guard_finite``, ``ewma``, ``draw_acc_plot``). The plot needs
matplotlib, which is imported only when a plot is asked for.
"""

from __future__ import annotations

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


def draw_acc_plot(accs, path: str, alpha: float = 0.9,
                  title: str = "Accuracy on test dataset") -> None:
    """Raw and EWMA accuracy curves, saved to ``path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

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
