"""Allreduce over the emulated data axis.

Port of ``tpu_distalg/parallel/collectives.py::tree_allreduce_sum``:
each shard's tuple of tensors is summed leaf by leaf in shard order
(0, 1, 2, …), which fixes the float rounding, so a run replays bitwise.
With one shard it returns the shard's own tensors.
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
