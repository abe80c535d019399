"""Sums over the emulated mesh axes.

Port of ``tpu_distalg/parallel/collectives.py::tree_allreduce_sum``:
each shard's tuple of tensors is summed leaf by leaf in shard order
(0, 1, 2, …), which fixes the float rounding, so a run replays bitwise.
With one shard it returns the shard's own tensors. :func:`model_sum`
is the model axis's psum (``comms.psum(z, MODEL_AXIS)`` in the JAX
package's tensor-parallel SSGD): the slices' partial tensors added in
model order.
"""

from __future__ import annotations


def tree_allreduce_sum(per_shard):
    """``per_shard``: one tuple of tensors per shard → the tuple of
    leafwise sums, taken in shard order."""
    per_shard = list(per_shard)
    if not per_shard:
        raise ValueError("tree_allreduce_sum needs at least one shard")
    acc = list(per_shard[0])
    for leaves in per_shard[1:]:
        if len(leaves) != len(acc):
            raise ValueError("shards hold different numbers of leaves")
        acc = [a + b for a, b in zip(acc, leaves)]
    return tuple(acc)


def model_sum(per_slice):
    """``per_slice``: one tensor per model slice → their sum, added in
    model order 0, 1, …"""
    (total,) = tree_allreduce_sum((t,) for t in per_slice)
    return total
