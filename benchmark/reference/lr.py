"""Plain two-class logistic regression: the minibatch SGD step, the
round of model averaging, the loss and the held-out accuracy, in plain
torch.

The precision is the configuration's: a row is stored in ``rows``
(bfloat16), the forward product reads the weights rounded to
``forward_weights`` and the backward product the residual rounded to
``residual``; every sum is float64 here, and the master weights are
float32, updated ``w ← w − η·g/max(count, 1)``. The reference follows
the published algorithm (the reference scripts' ``ssgd.py``, ``ma.py``)
and imports nothing of the program under test.
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}


def rounded(x: torch.Tensor, dtype_name: str) -> torch.Tensor:
    """x rounded to the named type (nearest even), as float64."""
    return x.to(DTYPES[dtype_name]).to(torch.float64)


class Rows:
    """The training rows, their last column the bias column of ones,
    rounded to the stored type, read block by block as the layout in
    :mod:`reference.draws` lays them out."""

    def __init__(self, X: torch.Tensor, y: torch.Tensor, block_rows: int,
                 precision: dict):
        self.X, self.y = X, y
        self.n = X.shape[0]
        self.block_rows = block_rows
        self.precision = precision

    def batch(self, block_ids: torch.Tensor):
        """(rows, d) float64 and (rows,) float64 labels of the valid
        rows of the given blocks."""
        br = self.block_rows
        r = (block_ids.reshape(-1, 1).to(torch.int64) * br
             + torch.arange(br, device=block_ids.device)).reshape(-1)
        r = r[r < self.n]
        return (rounded(self.X[r], self.precision["rows"]),
                self.y[r].to(torch.float64))


def gradient(w32: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             precision: dict):
    """(Σ gradient, count) of the log-loss over rows x at weights w32."""
    wq = rounded(w32, precision["forward_weights"])
    resid = rounded(torch.sigmoid(x @ wq) - y, precision["residual"])
    return x.T @ resid, x.shape[0]


def sgd_step(w32: torch.Tensor, x, y, eta: float, precision: dict,
             keep: float = 1.0) -> torch.Tensor:
    """One SGD step on the rows; ``keep`` < 1 uses only the leading
    share of them (a planted fault: part of the batch left out, the mean
    taken over the rest)."""
    if keep < 1.0:
        m = max(1, int(x.shape[0] * keep))
        x, y = x[:m], y[:m]
    g, cnt = gradient(w32, x, y, precision)
    return (w32.to(torch.float64) - eta * g / max(cnt, 1)).to(torch.float32)


def log_loss(w32: torch.Tensor, x, y) -> float:
    """Mean log-loss of the rows at w32, float64."""
    z = x @ w32.to(torch.float64)
    return float((torch.nn.functional.softplus(z) - y * z).mean())


def accuracy(w32: torch.Tensor, X_test: torch.Tensor, y_test: torch.Tensor,
             chunk: int = 1 << 16) -> float:
    """Share of held-out rows (features without the bias column) whose
    label is 1 exactly when x·w >= 0."""
    w = w32.to(torch.float64)
    hits = 0
    for lo in range(0, X_test.shape[0], chunk):
        z = X_test[lo:lo + chunk].to(torch.float64) @ w[:-1] + w[-1]
        hits += int(((z >= 0).to(torch.float64)
                     == y_test[lo:lo + chunk].to(torch.float64)).sum())
    return hits / X_test.shape[0]
