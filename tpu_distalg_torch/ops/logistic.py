"""Logistic-regression ops: the plain PyTorch math of SSGD.

Port of ``tpu_distalg/ops/logistic.py``: a stable sigmoid
(``torch.sigmoid``, never ``1/(exp(-z)+1)``), the masked gradient sum
``(Xᵀ·(σ(Xw) − y)·mask, Σmask)`` that is the reference's treeAggregate
pair for one shard, the four regulariser gradients and the uniform
[-1, 1) initial weights drawn from the port's threefry, so that they
equal the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

from tpu_distalg_torch.utils import prng


def _promote(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X in the promoted type of X and w (a bfloat16 X meets float32 w
    in float32, as ``jnp`` promotes it)."""
    return X.to(torch.promote_types(X.dtype, w.dtype))


def predict_proba(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """σ(X·w)."""
    return torch.sigmoid(_promote(X, w) @ w)


def grad_sum(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
             mask: torch.Tensor):
    """Masked gradient sum and sample count: ``(Xᵀ·r, Σmask)`` with
    ``r = (σ(X·w) − y)·mask``."""
    X = _promote(X, w)
    residual = (predict_proba(X, w) - y) * mask
    return X.T @ residual, mask.sum()


def reg_gradient(w: torch.Tensor, reg_type: str = "l2",
                 alpha: float = 0.0) -> torch.Tensor:
    """l2 → w, l1 → sign(w), elastic_net → α·sign(w) + (1−α)·w,
    none → 0."""
    if reg_type == "none":
        return torch.zeros_like(w)
    if reg_type == "l2":
        return w
    if reg_type == "l1":
        return torch.sign(w)
    if reg_type == "elastic_net":
        return alpha * torch.sign(w) + (1 - alpha) * w
    raise ValueError(f"unknown reg_type {reg_type!r}")


def init_weights(key: torch.Tensor, dim: int) -> torch.Tensor:
    """Uniform in [-1, 1), float32 — the reference's ``2*ranf(D+1) − 1``
    init; equal to ``logistic.init_weights`` of the JAX package under
    the same seed."""
    return prng.uniform(key, (dim,), -1.0, 1.0)
