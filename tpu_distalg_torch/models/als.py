"""ALS matrix factorisation (port of ``tpu_distalg/models/als.py``).

The resident single-device fit: R, U and V live on one device and
every half-sweep is one batched normal-equation solve against a k×k
Gram (``ops/linalg.py``). It follows the JAX package step for step:
the same V0 draw (``default_rng(seed + 1)``; U0 is never read), the
same sweep order (U-update, V-update, then the RMSE), and the same
``reg_rows`` quirk (the U-update regularises with ``n``, the V-update
with ``m``).

With ``checkpoint_dir`` the fit saves the artifact ``{"tag": "als",
"state": [U, V]}`` as ``step_<n_iterations>.npz`` when it ends, which
``serve/artifacts.load_artifact`` serves. Segmented resume, restarts,
``fit_streamed`` and ``fit_rowstore`` are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.ops import linalg
from tpu_distalg_torch.utils import checkpoint
from tpu_distalg_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    lam: float = 0.01
    m: int = 100
    n: int = 500
    k: int = 10
    n_iterations: int = 5
    seed: int = 0


@dataclasses.dataclass
class ALSResult:
    U: torch.Tensor
    V: torch.Tensor
    rmse_history: torch.Tensor  # per-sweep RMSE

    @property
    def final_rmse(self) -> float:
        return float(self.rmse_history[-1])


def synthesize_rank_k(config: ALSConfig) -> np.ndarray:
    """R = U₀·V₀ᵀ with U₀, V₀ ~ U[0,1) — the exactly-rank-k target."""
    rng = np.random.default_rng(config.seed)
    U0 = rng.random((config.m, config.k), dtype=np.float32)
    V0 = rng.random((config.n, config.k), dtype=np.float32)
    return U0 @ V0.T


def fit(config: ALSConfig = ALSConfig(), R: np.ndarray | None = None, *,
        device: str | torch.device | None = None,
        checkpoint_dir: str | None = None) -> ALSResult:
    """Fit U·Vᵀ ≈ R on ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    if R is None:
        R = synthesize_rank_k(config)
    elif R.shape != (config.m, config.n):
        config = dataclasses.replace(config, m=R.shape[0], n=R.shape[1])
    rng = np.random.default_rng(config.seed + 1)
    V0 = rng.random((config.n, config.k), dtype=np.float32)

    R_dev = torch.as_tensor(np.asarray(R, np.float32), device=dev)
    V = torch.as_tensor(V0, device=dev)
    U = None
    errs = []
    for _ in range(config.n_iterations):
        U = linalg.solve_factor_block(
            linalg.gram(V, config.lam, config.n), V, R_dev)
        V = linalg.solve_factor_block(
            linalg.gram(U, config.lam, config.m), U, R_dev.T)
        errs.append(linalg.rmse(R_dev, U, V))
    if U is None:
        U = torch.zeros((config.m, config.k), dtype=torch.float32,
                        device=dev)
    hist = torch.stack(errs) if errs else torch.zeros(0, device=dev)
    if not bool(torch.isfinite(hist).all()):
        raise FloatingPointError(f"ALS rmse history not finite: {hist}")
    if checkpoint_dir is not None:
        checkpoint.save(checkpoint_dir, "als",
                        [U.cpu().numpy(), V.cpu().numpy()],
                        step=config.n_iterations)
    return ALSResult(U=U, V=V, rmse_history=hist)
