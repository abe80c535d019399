"""The two collectives serving needs, on the emulated mesh.

Port of part of ``tpu_distalg/parallel/comms.py``:
:func:`ring_allgather`, the origin-placed ring all-gather that the JAX
package's sharded top-k merge rides (``comms.py:248-290``), and
:func:`merge_topk_pairs_host`, the numpy spelling of the candidate
merge (``comms.py:1134-1156``). On one card the shards' buffers are
already in one memory, so the gather is a stack in shard order. The
sync schedules, the codecs and error feedback wait for ROADMAP A9.
"""

from __future__ import annotations

import numpy as np
import torch


def ring_allgather(per_shard):
    """``per_shard``: one tuple of buffers per shard, in shard order →
    the tuple of shard-major ``(S, …)`` stacks, row j shard j's buffer,
    as the JAX package's ring leaves it on every shard."""
    per_shard = [tuple(bufs) for bufs in per_shard]
    if not per_shard:
        raise ValueError("ring_allgather needs at least one shard")
    if len({len(bufs) for bufs in per_shard}) != 1:
        raise ValueError("shards hold different numbers of buffers")
    return tuple(torch.stack(leaf) for leaf in zip(*per_shard))


def merge_topk_pairs_host(all_vals, all_idx, *, k: int):
    """The numpy spelling of ``ops.topk.merge_topk_pairs``: (S, B, K)
    shard-major stacks of (value, index) pairs → the global top k of
    each row, value descending, ties toward the lower index."""
    v = np.moveaxis(np.asarray(all_vals, np.float32), 0, 1)
    i = np.moveaxis(np.asarray(all_idx, np.int32), 0, 1)
    B = v.shape[0]
    v = v.reshape(B, -1)
    i = i.reshape(B, -1)
    out_v = np.empty((B, k), np.float32)
    out_i = np.empty((B, k), np.int32)
    for b in range(B):
        # lexsort: the LAST key is primary — (-value asc, index asc)
        order = np.lexsort((i[b], -v[b]))[:k]
        out_v[b] = v[b][order]
        out_i[b] = i[b][order]
    return out_v, out_i
