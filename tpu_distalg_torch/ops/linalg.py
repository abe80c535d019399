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


def gram_part(F: torch.Tensor) -> torch.Tensor:
    """``FᵀF`` in float64: one shard's share of a Gram that is summed
    over shards (the whole Gram on one shard)."""
    F64 = F.to(torch.float64)
    return F64.T @ F64


def regularise(G: torch.Tensor, lam: float, reg_rows: int) -> torch.Tensor:
    """``G + λ·reg_rows·I``, the ridge-regularised Gram.

    ``reg_rows`` keeps the reference's quirk: the diagonal boost scales
    with the row count of the factor matrix, not per-row rating
    counts."""
    return G + lam * reg_rows * torch.eye(
        G.shape[0], dtype=torch.float64, device=G.device)


def solve_rhs(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Rows solving ``(L·Lᵀ) · uᵢ = rhs[:, i]``: ``L`` the float64
    Cholesky factor of a Gram, shared by every right-hand side, ``rhs``
    (k, rows) the float32 product ``Fᵀ·R_blockᵀ`` → (rows, k) in
    ``rhs``'s dtype."""
    out = torch.cholesky_solve(rhs.to(torch.float64), L).T
    return out.to(rhs.dtype).contiguous()


def sq_err(R: torch.Tensor, U: torch.Tensor, V: torch.Tensor
           ) -> torch.Tensor:
    """‖R − UVᵀ‖²: one block's share of the rmse's sum, which the fit
    sums over blocks and divides by the true m·n."""
    diff = R - U @ V.T
    return torch.sum(diff * diff)
