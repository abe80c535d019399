"""Why the port's ALS Gram runs in float64: the rmse history of an
unregularised fit with a float32 Gram and Cholesky (the JAX package's
choice) beside the port's float64 one.

    python -m tpu_distalg_torch.tools.als_precision [--device cuda]

The target is bench.py's full-width one (4096 users × 16384 items,
exactly rank 64, N(0, 0.3²) factors, lam=0), the start is the port's V0
draw, and every rmse is printed relative to RMS(R). Both variants run
the same sweep; they differ only in the dtype of the k×k Gram and its
solve.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpu_distalg_torch.models import als
from tpu_distalg_torch.ops import linalg
from tpu_distalg_torch.utils.device import resolve_device


def _solve_f32(F, R_block):
    G = F.T @ F
    return torch.cholesky_solve(F.T @ R_block.T,
                                torch.linalg.cholesky(G)).T


def _solve_port(F, R_block):
    L = torch.linalg.cholesky(linalg.gram_part(F))
    return linalg.solve_rhs(L, F.T @ R_block.T)


def history(solve, R, V0, sweeps: int) -> list[float]:
    """Relative rmse per sweep of an unregularised fit; a failed
    float32 Cholesky ends the history with ``nan``."""
    rms = float(torch.sqrt(torch.mean(R.double() ** 2)))
    V, out = V0, []
    for _ in range(sweeps):
        try:
            U = solve(V, R)
            V = solve(U, R.T)
        except torch.linalg.LinAlgError:
            out.append(float("nan"))
            break
        err = torch.sqrt(linalg.sq_err(R, U, V) / R.numel())
        # tda: ignore[TDA011] -- a precision probe run by hand: each
        # sweep's error is its output, and it times nothing
        out.append(float(err) / rms)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--sweeps", type=int, default=8)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    m, n, k = 4096, 16384, 64
    rng = np.random.default_rng(0)
    R = (rng.normal(0.0, 0.3, (m, k)).astype(np.float32)
         @ rng.normal(0.0, 0.3, (n, k)).astype(np.float32).T)
    targets = {
        "normal(0,0.3) factors": R,
        "U[0,1) factors (synthesize_rank_k)": als.synthesize_rank_k(
            als.ALSConfig(m=m, n=n, k=k)),
    }
    V0 = torch.as_tensor(np.random.default_rng(1).random(
        (n, k), dtype=np.float32), device=dev)
    for label, target in targets.items():
        Rd = torch.as_tensor(target, device=dev)
        for name, solve in (("float32 Gram", _solve_f32),
                            ("float64 Gram", _solve_port)):
            print(f"[als_precision] {dev.type} {m}x{n} rank {k}, lam 0, "
                  f"{label}, {name}: rmse/RMS(R) per sweep "
                  f"{history(solve, Rd, V0, args.sweeps)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
