"""Per-shard execution: the mapPartitions replacement.

Port of ``tpu_distalg/parallel/spmd.py``. The JAX package wraps a body
in ``shard_map``, and the body sees its shard's block and its index on
the axis (``lax.axis_index``, the index ``mapPartitionsWithIndex``
passes in). Here :func:`data_parallel` runs a body once for each data
shard THIS process holds, in global order, with the shard's global id;
:func:`replica_index` gives that id inside the body. The outputs are the
per-shard partials that :func:`..collectives.tree_allreduce_sum` adds
over every global shard. A body cuts its shard's rows with
:func:`..partition.data_block`: the layout lives in :mod:`.partition`.
"""

from __future__ import annotations

from tpu_distalg_torch.parallel.mesh import DATA_AXIS, Mesh

_CURRENT: list[int] = []


def replica_index(axis_name: str = DATA_AXIS) -> int:
    """The global data shard the running :func:`data_parallel` body is
    computing (≙ the mapPartitionsWithIndex idx)."""
    if axis_name != DATA_AXIS:
        raise ValueError(f"replica_index runs over {DATA_AXIS!r}, not "
                         f"{axis_name!r}")
    if not _CURRENT:
        raise RuntimeError("replica_index() outside a data_parallel body")
    return _CURRENT[-1]


def data_parallel(fn, mesh: Mesh) -> list:
    """``fn(s)`` for each global data shard ``s`` this process holds, in
    order → the list of outputs. Inside ``fn``, :func:`replica_index` is
    ``s``."""
    out = []
    for s in mesh.local_data:
        _CURRENT.append(s)
        try:
            out.append(fn(s))
        finally:
            _CURRENT.pop()
    return out
