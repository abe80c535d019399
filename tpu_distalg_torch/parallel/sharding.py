"""Row- and feature-sharded arrays, placed by the rule tables.

Port of ``tpu_distalg/parallel/sharding.py``, as thin callers of the
partition engine (:mod:`.partition`), which holds the one copy of every
layout. :func:`parallelize` pads the rows to a multiple of the data
shard count (``partition.pad_amounts`` under the table's rule for the
leaf) and places them (``partition.put``): shard ``s`` is rows
``[s·n_local, (s+1)·n_local)`` of the padded array, and a process of a
group holds only its shards' rows. A validity mask stands in for the
true length, exactly as in the JAX package. :func:`build_sharded` makes
such an array on the device from a per-row generator, each process only
its own rows, without a host copy. For the model axis,
:func:`pad_features` pads the feature dimension to a multiple of the
slice count (zero columns are inert: their weights and gradients stay
0) and :func:`shard_features` stacks the contiguous column slices that
``partition.shards`` cuts under the ``ssgd_tp`` rule.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.parallel import partition
from tpu_distalg_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def pad_rows(x, multiple: int):
    """Pad axis 0 up to a multiple; return ``(padded, valid_mask)``,
    the mask float32 with 1 for real rows and 0 for padding."""
    x = np.asarray(x)
    n = x.shape[0]
    n_pad = (-n) % multiple
    mask = np.ones((n + n_pad,), dtype=np.float32)
    if n_pad:
        x = np.pad(x, [(0, n_pad)] + [(0, 0)] * (x.ndim - 1))
        mask[n:] = 0.0
    return x, mask


@dataclasses.dataclass
class ShardedMatrix:
    """``data`` the rows of this process's data shards (every shard's
    with one process) on the mesh's device, ``mask`` 1 for their real
    rows; ``n_padded`` counts the rows of all ``n_shards`` shards."""

    data: torch.Tensor
    mask: torch.Tensor
    n_valid: int
    n_shards: int
    n_padded: int


def parallelize(rows, mesh: Mesh, *, dtype=torch.float32,
                table: str = "lr", leaf: str = "X") -> ShardedMatrix:
    """Rows padded as ``table``'s rule for ``leaf`` cuts them and placed
    on the mesh's device in ``dtype``, with their validity mask."""
    rows = np.asarray(rows)
    spec = partition.table(table).spec_for(leaf, rows.shape)
    pads = partition.pad_amounts(rows.shape, spec, mesh)
    n = rows.shape[0]
    padded = np.pad(rows, [(0, int(p)) for p in pads]) if any(pads) \
        else rows
    mask = (np.arange(n + pads[0]) < n).astype(np.float32)
    data = partition.put(np.ascontiguousarray(padded), leaf, table,
                         mesh).to(dtype)
    return ShardedMatrix(data=data,
                         mask=partition.put(mask, "mask", table, mesh),
                         n_valid=int(n), n_shards=mesh.n_data,
                         n_padded=int(mask.shape[0]))


def pad_features(X, mesh: Mesh):
    """``(X padded with zero columns to a multiple of the model slices,
    d_local)`` as numpy, ``d_local`` the width of one model slice."""
    X = np.asarray(X)
    pads = partition.pad_amounts(X.shape, (None, MODEL_AXIS), mesh)
    if any(pads):
        X = np.pad(X, [(0, int(p)) for p in pads])
    return X, X.shape[1] // mesh.n_model


def shard_features(X: torch.Tensor, n_model: int) -> torch.Tensor:
    """The columns of a (n, n_model·d_local) tensor as ``n_model``
    contiguous slices, one (n_model, n, d_local) tensor: slice m is
    columns ``[m·d_local, (m+1)·d_local)``, the model cut of the
    ``ssgd_tp`` rule."""
    n, d = X.shape
    if d % n_model:
        raise ValueError(f"{d} columns do not split into {n_model} slices; "
                         f"pad them first (pad_features)")
    one = Mesh(n_data=1, device=X.device, n_model=n_model)
    (views,) = partition.shards(X, (None, MODEL_AXIS), one).values()
    return torch.stack(views)


def build_sharded(mesh: Mesh, n_rows: int, make_rows, *,
                  row_multiple: int = 1) -> ShardedMatrix:
    """A row-sharded dataset made ON the mesh's device: the sibling of
    :func:`parallelize` that never holds the rows on the host.

    ``make_rows(row_ids)`` takes a shard's global row ids, an int64
    tensor (n_local,) on the device, and returns its (n_local, ...)
    rows or a tuple of such blocks; the content should depend on the
    ids alone, so that the data does not depend on the shard count.
    Rows are padded to a multiple of ``row_multiple × n_shards``; padded
    rows are generated like any other and carry mask 0. Each process
    makes only its own shards' rows (``partition.shards`` of the global
    ids under the data rule)."""
    mult = mesh.n_data * row_multiple
    n_padded = -(-n_rows // mult) * mult
    ids = partition.put(
        torch.arange(n_padded, dtype=torch.int64, device=mesh.device),
        "points", "kmeans", mesh)
    views = partition.shards(ids, (DATA_AXIS,), mesh)
    parts = [make_rows(views[s][0]) for s in mesh.local_data]
    one = len(parts) == 1
    if isinstance(parts[0], (tuple, list)):
        data = tuple(p[0] if one else torch.cat(p) for p in zip(*parts))
    else:
        data = parts[0] if one else torch.cat(parts)
    return ShardedMatrix(data=data, mask=(ids < n_rows).to(torch.float32),
                         n_valid=n_rows, n_shards=mesh.n_data,
                         n_padded=n_padded)
