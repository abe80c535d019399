"""Row- and feature-sharded arrays of the emulated mesh.

Port of ``tpu_distalg/parallel/sharding.py``: :func:`parallelize` pads
the rows to a multiple of the shard count and places them on the
mesh's device; a validity mask stands in for the true length, exactly
as in the JAX package, so shard ``s`` is rows
``[s·n_local, (s+1)·n_local)`` of the padded array.
:func:`build_sharded` makes such an array on the device from a per-row
generator, without a host copy. For the model axis,
:func:`pad_features` pads the feature dimension to a multiple of the
slice count (zero columns are inert: their weights and gradients stay
0) and :func:`shard_features` splits the columns into that many
contiguous slices: the placement the JAX rule tables ``ssgd_tp`` and
``ssgd_feature_sharded`` give X, (data, model), and w, (model,).
These placements are made by hand; the port's rule tables
(``parallel/partition.py``) describe the same layouts, and its tests
hold the two to each other until ROADMAP A9 moves these trainers onto
the tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.parallel.mesh import Mesh


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
    """``data`` (n_padded, ...) on the mesh's device, split into
    ``n_shards`` leading slices; ``mask`` is 1 for real rows."""

    data: torch.Tensor
    mask: torch.Tensor
    n_valid: int
    n_shards: int

    @property
    def n_padded(self) -> int:
        return self.mask.shape[0]


def parallelize(rows, mesh: Mesh, *, dtype=torch.float32) -> ShardedMatrix:
    """Rows padded to a multiple of ``mesh.n_data`` and placed on the
    mesh's device in ``dtype``, with their validity mask."""
    padded, mask = pad_rows(rows, mesh.n_data)
    data = torch.from_numpy(np.ascontiguousarray(padded)).to(
        mesh.device).to(dtype)
    return ShardedMatrix(data=data,
                         mask=torch.from_numpy(mask).to(mesh.device),
                         n_valid=int(np.asarray(rows).shape[0]),
                         n_shards=mesh.n_data)


def pad_features(X, n_model: int):
    """``(X padded with zero columns to a multiple of n_model, d_local)``
    as numpy, ``d_local`` the width of one model slice."""
    X = np.asarray(X)
    d_pad = (-X.shape[1]) % n_model
    if d_pad:
        X = np.pad(X, ((0, 0), (0, d_pad)))
    return X, X.shape[1] // n_model


def shard_features(X: torch.Tensor, n_model: int) -> torch.Tensor:
    """The columns of a (n, n_model·d_local) tensor as ``n_model``
    contiguous slices, one (n_model, n, d_local) tensor: slice m is
    columns ``[m·d_local, (m+1)·d_local)``."""
    n, d = X.shape
    if d % n_model:
        raise ValueError(f"{d} columns do not split into {n_model} slices; "
                         f"pad them first (pad_features)")
    return X.reshape(n, n_model, d // n_model).transpose(0, 1).contiguous()


def build_sharded(mesh: Mesh, n_rows: int, make_rows, *,
                  row_multiple: int = 1) -> ShardedMatrix:
    """A row-sharded dataset made ON the mesh's device: the sibling of
    :func:`parallelize` that never holds the rows on the host.

    ``make_rows(row_ids)`` takes a shard's global row ids, an int64
    tensor (n_local,) on the device, and returns its (n_local, ...)
    rows or a tuple of such blocks; the content should depend on the
    ids alone, so that the data does not depend on the shard count.
    Rows are padded to a multiple of ``row_multiple × n_shards``; padded
    rows are generated like any other and carry mask 0."""
    n_shards = mesh.n_data
    mult = n_shards * row_multiple
    n_padded = -(-n_rows // mult) * mult
    n_local = n_padded // n_shards
    ids = torch.arange(n_padded, dtype=torch.int64, device=mesh.device)
    parts = [make_rows(ids[s * n_local:(s + 1) * n_local])
             for s in range(n_shards)]
    if isinstance(parts[0], (tuple, list)):
        data = tuple(p[0] if n_shards == 1 else torch.cat(p)
                     for p in zip(*parts))
    else:
        data = parts[0] if n_shards == 1 else torch.cat(parts)
    return ShardedMatrix(data=data, mask=(ids < n_rows).to(torch.float32),
                         n_valid=n_rows, n_shards=n_shards)
