"""The two-class task of a logistic-regression configuration, made on the
device from the seed and handed to both sides as host arrays.

Features are standard normal; a teacher ``t ~ N(0, s²/f)`` with bias
``s/4`` gives each row the logit ``x·t + b``, and the label is 1 where
the logit plus logistic noise is positive, so that no classifier is
right on every row. The training rows carry a last column of ones, the
bias column of the reference's augmented X. The initial weights are
uniform on [-1, 1) for every column, the reference's
``2*ranf(D+1) − 1``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK_ROWS = 1 << 20


def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + stream) % (1 << 63))
    return g


def _rows(n: int, f: int, teacher, bias, g, device, X_out: np.ndarray,
          with_bias: bool):
    """Fill X_out (n, f [+ 1]) float32 on the host; return labels."""
    X_host = torch.from_numpy(X_out)
    y = np.empty(n, np.float32)
    for lo in range(0, n, CHUNK_ROWS):
        m = min(CHUNK_ROWS, n - lo)
        x = torch.randn((m, f), generator=g, device=device)
        u = torch.rand((m,), generator=g, device=device).clamp(1e-7, 1 - 1e-7)
        z = (x * teacher).sum(dim=1) + bias + torch.log(u) - torch.log1p(-u)
        X_host[lo:lo + m, :f].copy_(x)
        y[lo:lo + m] = (z > 0).to(torch.float32).cpu().numpy()
    if with_bias:
        X_out[:, f] = 1.0
    return y


def lr_task(config: dict, seed: int, device) -> dict:
    """``X`` (n, f + 1) float32 with the bias column, ``y`` (n,),
    ``X_test`` (n_test, f), ``y_test``, ``w0`` (f + 1,) float32: numpy
    arrays on the host, the same for the same seed."""
    f = config["n_features"]
    scale = config["data"]["teacher_scale"]
    g = _gen(seed, 0, device)
    teacher = torch.randn((f,), generator=g, device=device) * (
        scale / math.sqrt(f))
    bias = scale / 4
    w0 = (torch.rand((f + 1,), generator=g, device=device) * 2 - 1).cpu()
    X = np.empty((config["n_train"], f + 1), np.float32)
    y = _rows(config["n_train"], f, teacher, bias, _gen(seed, 1, device),
              device, X, True)
    X_test = np.empty((config["n_test"], f), np.float32)
    y_test = _rows(config["n_test"], f, teacher, bias,
                   _gen(seed, 2, device), device, X_test, False)
    return dict(X=X, y=y, X_test=X_test, y_test=y_test,
                w0=w0.numpy().astype(np.float32))
