"""Device selection and float32 precision for the port.

Every entry point takes a ``device`` argument and resolves it here: it
defaults to ``cuda`` and raises when no card is present — nothing
quietly carries on on the CPU. The CPU is used only when a caller asks
for it (the tests do).

Float32 products run in full float32 on the card: ALS's exact rank-k
recovery depends on it (a TF32 product keeps about three decimal
digits), the same reason the JAX package pins ``precision=HIGHEST``
on its normal-equation matmuls.

Across processes (:func:`..parallel.mesh.multihost_initialize`) each
rank drives the card ``cuda:{local_rank % device_count}``, its local
rank being its place among the ranks of its host, which the ranks find
by trading host names (:func:`host_layout`; :func:`set_process_rank`
records it, and :func:`resolve_device` then maps ``cuda`` to that
card), and :func:`choose_backend` names the ``torch.distributed``
backend: ``nccl`` when every rank on the host has a card of its own,
else ``gloo`` (on the CPU, or when ranks share a card: NCCL refuses two
ranks on one GPU). This is a rule, not a knob.

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


#: this process's rank on its host once it joins a process group
#: (:func:`set_process_rank`); None in a single-process run
_LOCAL_RANK: int | None = None


def set_process_rank(local_rank: int | None) -> None:
    """Record this process's rank on its host (None: no process group);
    :func:`resolve_device` maps ``cuda`` to the rank's card."""
    global _LOCAL_RANK
    _LOCAL_RANK = None if local_rank is None else int(local_rank)


def rank_card(local_rank: int) -> int:
    """The card index a rank drives: ``local_rank % device_count``."""
    return int(local_rank) % max(1, torch.cuda.device_count())


def resolve_device(device: str | torch.device | None = None
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`, ``cuda`` by default; in a
    process group an unindexed ``cuda`` is the rank's card
    (:func:`rank_card`).

    Raises ``RuntimeError`` for a CUDA device when no card is present.
    Sets full float32 matmul precision either way."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False — pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None and _LOCAL_RANK is not None:
        dev = torch.device("cuda", rank_card(_LOCAL_RANK))
    set_full_f32_precision()
    return dev


def host_layout(hosts: list[str], rank: int) -> tuple[int, int]:
    """``(local_rank, local_world_size)`` of ``rank`` from every rank's
    host name in rank order: its place among the ranks of its host, and
    their number."""
    mine = hosts[rank]
    return hosts[:rank].count(mine), hosts.count(mine)


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """The process group's backend for ranks on ``device``'s type:
    ``nccl`` when each of the host's ``local_world_size`` ranks has a
    card of its own, else ``gloo``."""
    if device.type == "cuda" and \
            local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


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
