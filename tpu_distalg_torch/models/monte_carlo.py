"""Monte-Carlo π estimation.

Port of ``tpu_distalg/models/monte_carlo.py`` on the emulated data axis
(:mod:`..parallel`). Shard s throws its darts under ``fold_in(root_key(
seed), s)`` in whole chunks (:func:`..ops.sampling.mc_circle_hits_chunked`),
the shards' per-chunk hit vectors are summed in shard order, and the
total is added up in int64 — so the port counts the same darts as the
JAX package and gives the same estimate, bit for bit, from a seed.
In JAX this is XLA code, not a Pallas kernel, so plain torch ops are
its port.
"""

from __future__ import annotations

import dataclasses

from tpu_distalg_torch.ops import sampling
from tpu_distalg_torch.parallel import Mesh, tree_allreduce_sum
from tpu_distalg_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class MonteCarloConfig:
    n: int = 400_000  # monte_carlo.py:13-15 (100000 * n_slices)
    seed: int = 42
    chunk: int = 1 << 20


def per_chunk_hits(mesh: Mesh, config: MonteCarloConfig = MonteCarloConfig()):
    """The shard-summed (n_chunks,) int64 hit counts, on the mesh's
    device, and ``n_used`` = n_shards · n_chunks · per."""
    import torch

    n_shards = mesh.n_data
    per_shard = -(-config.n // n_shards)
    n_chunks, per = sampling.mc_chunk_plan(per_shard, config.chunk)
    key = prng.root_key(config.seed, mesh.device)
    hits = tree_allreduce_sum(
        (sampling.mc_circle_hits_chunked(prng.fold_in(key, s), per_shard,
                                         config.chunk).to(torch.int64),)
        for s in range(n_shards))[0]
    return hits, n_shards * n_chunks * per


def estimate_pi(mesh: Mesh, config: MonteCarloConfig = MonteCarloConfig()):
    """Returns (pi_estimate, n_used). n is rounded up to a multiple of
    the shard count × chunking; all darts are counted."""
    hits, n_used = per_chunk_hits(mesh, config)
    return 4.0 * int(hits.sum()) / float(n_used), n_used
