"""Batched linear algebra for ALS (port of ``tpu_distalg/ops/linalg.py``).

The k×k Gram is computed once per half-sweep and every row solves
against one Cholesky factor. The solve is a k×k library call
(``torch.linalg.cholesky`` + ``torch.cholesky_solve``), as the JAX
package leaves it to XLA; it is not a Pallas kernel there.

Precision: the large products (the right-hand sides ``Fᵀ·Rᵀ`` and the
RMSE's ``U·Vᵀ``) run in full float32 (TF32 is off, see
``utils/device.py``). The k×k Gram and its Cholesky solve run in
float64, where the JAX package keeps float32: without a ridge term
(``lam=0``) at rank 64 the Gram of the first sweep's factor is too
ill-conditioned for float32, and the rmse of an exactly rank-64 target
then stalls around 1e-3 of RMS(R) on the card and on the CPU alike, or
the float32 Cholesky fails outright. ``python -m
tpu_distalg_torch.tools.als_precision`` measures both on the card. The
Gram costs 2·rows·k² operations, nothing beside the right-hand side's
2·rows·cols·k.
"""

from __future__ import annotations

import torch


def gram(F: torch.Tensor, lam: float, reg_rows: int) -> torch.Tensor:
    """``FᵀF + λ·reg_rows·I`` in float64 — the ridge-regularised Gram.

    ``reg_rows`` keeps the reference's quirk: the diagonal boost scales
    with the row count of the factor matrix, not per-row rating
    counts."""
    F64 = F.to(torch.float64)
    k = F.shape[1]
    return F64.T @ F64 + lam * reg_rows * torch.eye(
        k, dtype=torch.float64, device=F.device)


def solve_factor_block(G: torch.Tensor, F: torch.Tensor,
                       R_block: torch.Tensor) -> torch.Tensor:
    """Solve ``G · uᵢ = Fᵀ·R_block[i, :]`` for every row i: one Cholesky
    factor shared by all right-hand sides ``(k, rows)``. The right-hand
    sides are a float32 product; the solve runs in float64 and the
    result is ``F``'s dtype."""
    rhs = F.T @ R_block.T                       # (k, rows), float32
    L = torch.linalg.cholesky(G.to(torch.float64))
    out = torch.cholesky_solve(rhs.to(torch.float64), L).T
    return out.to(F.dtype).contiguous()         # (rows, k)


def rmse(R: torch.Tensor, U: torch.Tensor, V: torch.Tensor
         ) -> torch.Tensor:
    """√(‖R − UVᵀ‖² / (m·n))."""
    diff = R - U @ V.T
    return torch.sqrt(torch.sum(diff * diff) / (R.shape[0] * R.shape[1]))
