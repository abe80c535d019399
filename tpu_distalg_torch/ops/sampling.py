"""Minibatch samplers: Bernoulli row masks and block-id draws.

Port of ``tpu_distalg/ops/sampling.py:17-47`` on the port's threefry
(:mod:`tpu_distalg_torch.utils.prng`), so both packages keep the same
rows and draw the same blocks from the same key. The Monte-Carlo
helpers of that module are not ported yet.
"""

from __future__ import annotations

import torch

from tpu_distalg_torch.utils import prng


def bernoulli_mask(key: torch.Tensor, t, n: int, fraction: float,
                   valid: torch.Tensor) -> torch.Tensor:
    """0/1 float32 mask of shape (n,): row kept iff u_i < fraction and
    valid. ``u`` is :func:`prng.uniform` under ``fold_in(key, t)``; the
    comparison is in float32, as JAX compares a float32 array with a
    Python float."""
    u = prng.uniform(prng.step_key(key, t), (n,))
    frac = torch.tensor(fraction, dtype=torch.float32, device=u.device)
    return torch.where(u < frac, 1.0, 0.0) * valid.to(u.device)


def sample_block_ids(base_key: torch.Tensor, n_shards: int, n_blocks: int,
                     n_sampled: int) -> torch.Tensor:
    """Per-shard without-replacement block draw: for each shard s,
    ``fold_in(base_key, s)`` seeds one draw of ``n_blocks`` 32-bit
    words and the positions of the ``n_sampled`` smallest (a stable
    sort, ties to the lower position) are the sampled block ids, local
    to the shard. ``base_key`` may be a batch ``(..., 2)`` of keys
    (one per step); returns ``(..., n_shards, n_sampled)`` int32."""
    shards = torch.arange(n_shards, dtype=torch.int64, device=base_key.device)
    ks = prng.fold_in(base_key.unsqueeze(-2), shards)     # (..., S, 2)
    words = prng.bits(ks, (n_blocks,))                    # (..., S, nb)
    order = torch.argsort(words, dim=-1, stable=True)
    return order[..., :n_sampled].to(torch.int32)
