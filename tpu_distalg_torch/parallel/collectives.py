"""Sums over the mesh axes, in one process or across processes.

Port of ``tpu_distalg/parallel/collectives.py::tree_allreduce_sum``:
each shard's tuple of tensors is summed leaf by leaf in shard order
(0, 1, 2, …), which fixes the float rounding, so a run replays bitwise.
With one shard it returns the shard's own tensors. :func:`model_sum`
is the model axis's psum (``comms.psum(z, MODEL_AXIS)`` in the JAX
package's tensor-parallel SSGD): the slices' partial tensors added in
model order; the model axis never leaves a process.

Across processes (a mesh with ``distributed``) the rule holds for the
GLOBAL shards: a process sends its per-shard partials, never their
local sum, because ``((a+b)+c)+d`` is not ``(a+b)+(c+d)`` in float.
Each psum is one ``all_gather`` of one flat byte buffer holding every
leaf of this process's shards (:func:`gather_shards`); the pieces are
then added in global shard order on the device. So P processes × L
shards equal one process × P·L emulated shards bit for bit. The price
is that an all-gather carries D× the bytes of an allreduce; a
fixed-order reduce that sends less is later work. Under ``gloo`` a
device buffer crosses through a host copy that is made here and
counted, not through gloo's partial CUDA support; under ``nccl`` the
buffer stays on the card. :data:`COUNTERS` holds the collectives, the
bytes this process sent (``(P−1)·B`` for a buffer of B bytes) and the
host copies with their seconds.
"""

from __future__ import annotations

import time

import torch

#: this process's collectives since :func:`reset_counters`
COUNTERS = {"collectives": 0, "bytes_sent": 0, "host_copies": 0,
            "host_copy_seconds": 0.0}

#: bytes each leaf is padded to in the flat buffer, so every leaf's
#: view of the gathered bytes is aligned for its dtype
_ALIGN = 16


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0.0 if k == "host_copy_seconds" else 0


def _exchange(buf: torch.Tensor, n_proc: int) -> list[torch.Tensor]:
    """Every process's uint8 ``buf`` (all of one size), in process order,
    on ``buf``'s device."""
    import torch.distributed as dist

    COUNTERS["collectives"] += 1
    COUNTERS["bytes_sent"] += buf.numel() * (n_proc - 1)
    if buf.device.type == "cpu" or dist.get_backend() == "nccl":
        out = [torch.empty_like(buf) for _ in range(n_proc)]
        dist.all_gather(out, buf)
        return out
    t0 = time.perf_counter()
    host = buf.cpu()
    COUNTERS["host_copy_seconds"] += time.perf_counter() - t0
    out = [torch.empty_like(host) for _ in range(n_proc)]
    dist.all_gather(out, host)
    t0 = time.perf_counter()
    back = torch.cat(out).to(buf.device)
    COUNTERS["host_copy_seconds"] += time.perf_counter() - t0
    COUNTERS["host_copies"] += 2
    return list(back.split(buf.numel()))


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def gather_shards(per_shard, mesh=None) -> list[tuple]:
    """Every global data shard's tuple of leaves, in global shard order.
    ``per_shard`` holds this process's shards (all of them without a
    process group); across processes their leaves travel in one flat
    buffer of one all-gather and come back as views of it."""
    per = [tuple(leaves) for leaves in per_shard]
    if mesh is None or not mesh.distributed:
        return per
    if len(per) != mesh.n_local:
        raise ValueError(f"this process holds {mesh.n_local} shards, got "
                         f"{len(per)} partials")
    parts, layout = [], []
    for leaves in per:
        for x in leaves:
            b = _bytes(x)
            pad = (-b.numel()) % _ALIGN
            parts.append(b)
            if pad:
                parts.append(b.new_zeros(pad))
            layout.append((tuple(x.shape), x.dtype, b.numel(),
                           b.numel() + pad))
    bufs = _exchange(torch.cat(parts), mesh.process_count)
    n_leaves = len(per[0])
    out = []
    for buf in bufs:
        off, leaves = 0, []
        for shape, dtype, nb, stride in layout:
            leaves.append(buf[off:off + nb].view(dtype).reshape(shape))
            off += stride
            if len(leaves) == n_leaves:
                out.append(tuple(leaves))
                leaves = []
    return out


def tree_allreduce_sum(per_shard, mesh=None):
    """``per_shard``: one tuple of tensors per shard (this process's
    shards, with a ``mesh`` that spans processes) → the tuple of
    leafwise sums over every global shard, taken in shard order. Without
    a process group nothing is gathered: the shards are all here."""
    if mesh is not None and mesh.distributed:
        per_shard = gather_shards(per_shard, mesh)
    else:
        per_shard = list(per_shard)
    if not per_shard:
        raise ValueError("tree_allreduce_sum needs at least one shard")
    acc = list(per_shard[0])
    for leaves in per_shard[1:]:
        if len(leaves) != len(acc):
            raise ValueError("shards hold different numbers of leaves")
        acc = [a + b for a, b in zip(acc, leaves)]
    return tuple(acc)


def allgather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-sharded tensor brought together: every process's rows
    along dim 0, in process order (this process's own rows without a
    process group)."""
    if not mesh.distributed:
        return x
    bufs = _exchange(_bytes(x), mesh.process_count)
    return torch.cat([b.view(x.dtype).reshape(x.shape) for b in bufs])


def model_sum(per_slice):
    """``per_slice``: one tensor per model slice → their sum, added in
    model order 0, 1, …"""
    (total,) = tree_allreduce_sum((t,) for t in per_slice)
    return total
