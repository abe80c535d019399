"""The data axis, emulated in one process.

Port of ``tpu_distalg/parallel/mesh.py`` for one card. The JAX package
shards rows over the ``data`` axis of a device mesh; here a
:class:`Mesh` names how many shards the rows are split into and the
one device that holds them all. Shard ``s`` is the ``s``-th of
``n_data`` equal leading slices of a padded row array
(:func:`tpu_distalg_torch.parallel.sharding.parallelize`), and an
allreduce is a sum over the shards in shard order
(:mod:`tpu_distalg_torch.parallel.collectives`). Shards across cards
with ``torch.distributed`` wait for ROADMAP A9; the ``model`` axis
(feature sharding) for B3/B4.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_distalg_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data`` emulated data shards on ``device``."""

    n_data: int
    device: torch.device


def get_mesh(data: int | None = None, model: int = 1, *,
             device: str | torch.device | None = None) -> Mesh:
    """A mesh of ``data`` emulated shards (1 when None) on ``device``
    (``cuda`` unless told ``cpu``)."""
    if model != 1:
        raise NotImplementedError(
            f"model={model}: feature sharding (the model axis) is not "
            f"ported yet (ROADMAP B3/B4)")
    data = 1 if data is None else int(data)
    if data < 1:
        raise ValueError(f"data must be >= 1, got {data}")
    return Mesh(n_data=data, device=resolve_device(device))
