"""Device selection and float32 precision for the port.

Every entry point takes a ``device`` argument and resolves it here: it
defaults to ``cuda`` and raises when no card is present — nothing
quietly carries on on the CPU. The CPU is used only when a caller asks
for it (the tests do).

Float32 products run in full float32 on the card: ALS's exact rank-k
recovery depends on it (a TF32 product keeps about three decimal
digits), the same reason the JAX package pins ``precision=HIGHEST``
on its normal-equation matmuls.

:func:`share_host_threads` divides the host's cores among processes
that run torch's CPU ops side by side (the test runner's workers): one
process at torch's default takes every core, and several such processes
spend their time waiting on each other's OpenMP threads.
"""

from __future__ import annotations

import os

import torch


def set_full_f32_precision() -> None:
    """Turn TF32 off for float32 matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device | None = None
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`, ``cuda`` by default.

    Raises ``RuntimeError`` for a CUDA device when no card is present.
    Sets full float32 matmul precision either way."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False — pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    set_full_f32_precision()
    return dev


def share_host_threads(n_procs: int | str | None) -> int | None:
    """Give torch's CPU ops this process's share of the host's cores,
    ``max(1, os.cpu_count() // n_procs)`` threads, when ``n_procs``
    processes share the host; returns the count set. ``None`` (no
    sharing, as when ``PYTEST_XDIST_WORKER_COUNT`` is unset) leaves
    torch's setting as it is and returns ``None``."""
    if n_procs is None:
        return None
    n = max(1, (os.cpu_count() or 1) // max(1, int(n_procs)))
    torch.set_num_threads(n)
    return n
