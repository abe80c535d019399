"""The data and model axes, emulated in one process.

Port of ``tpu_distalg/parallel/mesh.py`` for one card. The JAX package
shards rows over the ``data`` axis of a device mesh and, for SSGD's
tensor-parallel split, features over its ``model`` axis; here a
:class:`Mesh` names how many shards each axis has and the one device
that holds them all. Shard (s, m) is row slice ``s`` of model slice
``m``: the ``s``-th of ``n_data`` equal leading slices of a padded row
array (:func:`tpu_distalg_torch.parallel.sharding.parallelize`) within
the ``m``-th of ``n_model`` contiguous column slices
(:func:`tpu_distalg_torch.parallel.sharding.shard_features`). A psum
over either axis is a sum over its shards in shard order
(:mod:`tpu_distalg_torch.parallel.collectives`). The JAX package also
refuses more shards than devices; an emulated mesh has no such limit.
Shards across cards with ``torch.distributed`` wait for ROADMAP A9.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_distalg_torch.utils.device import resolve_device

#: the axis names the rule tables of ``parallel/partition.py`` use, as
#: the JAX package's ``parallel/mesh.py`` spells them
DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data`` × ``n_model`` emulated shards on ``device``."""

    n_data: int
    device: torch.device
    n_model: int = 1


def get_mesh(data: int | None = None, model: int = 1, *,
             device: str | torch.device | None = None) -> Mesh:
    """A mesh of ``data`` (1 when None) × ``model`` emulated shards on
    ``device`` (``cuda`` unless told ``cpu``)."""
    data = 1 if data is None else int(data)
    model = int(model)
    if data < 1:
        raise ValueError(f"data must be >= 1, got {data}")
    if model < 1:
        raise ValueError(f"model must be >= 1, got {model}")
    return Mesh(n_data=data, device=resolve_device(device), n_model=model)
