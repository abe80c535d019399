"""Samplers: Bernoulli row masks, block-id and row-id draws, and the
Monte-Carlo darts.

Port of ``tpu_distalg/ops/sampling.py`` on the port's threefry
(:mod:`tpu_distalg_torch.utils.prng`), so both packages keep the same
rows, draw the same blocks and rows and throw the same darts from the
same key. Plus the ``fixed`` sampler's row draw, which the JAX package
makes inline (``models/ssgd.py:1380-1385``).
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
    return bernoulli_mask_from_uniform(u, fraction_tensor(fraction, u.device),
                                       valid)


def fraction_tensor(fraction: float, device) -> torch.Tensor:
    """The fraction as the float32 tensor the masks compare with."""
    return torch.tensor(fraction, dtype=torch.float32, device=device)


def bernoulli_mask_from_uniform(u: torch.Tensor, frac: torch.Tensor,
                                valid: torch.Tensor) -> torch.Tensor:
    """:func:`bernoulli_mask` from its uniforms ``u`` (drawn ahead, for a
    group of steps at once) and :func:`fraction_tensor`: ``where(u <
    frac, 1, 0) · valid``."""
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


def fixed_row_ids(key: torch.Tensor, t, n_shards: int, n_local: int,
                  b_local: int) -> torch.Tensor:
    """The ``fixed`` sampler's rows of step ``t``: for each shard s, the
    first ``b_local`` entries of ``permutation(fold_in(fold_in(key, t),
    s), n_local)``, local to the shard — a draw without replacement.
    Returns (n_shards, b_local) int64; for a (T,) int64 tensor of steps,
    (T, n_shards, b_local)."""
    shards = torch.arange(n_shards, dtype=torch.int64, device=key.device)
    ks = prng.fold_in(prng.fold_in(key, t).unsqueeze(-2), shards)
    return prng.permutation(ks, n_local)[..., :b_local]


def mc_circle_hits(key: torch.Tensor, n: int) -> torch.Tensor:
    """Darts in the unit circle out of ``n``: x, y a (n, 2) float32
    uniform on [-1, 1) under ``key``, a hit when x·x + y·y <= 1 in
    float32. A batch of keys (..., 2) gives the (...,) counts; int64."""
    xy = prng.uniform(key, (n, 2), -1.0, 1.0)
    return ((xy * xy).sum(dim=-1) <= 1.0).sum(dim=-1)


def mc_chunk_plan(n: int, chunk: int):
    """(n_chunks, darts_per_chunk): the fewest chunks of at most
    ``chunk`` darts that hold ``n``, all of one size (>= n in all)."""
    n_chunks = max(1, -(-n // chunk))
    per = -(-n // n_chunks)
    return n_chunks, per


#: threefry words one group of Monte-Carlo chunks draws at once: each
#: int64 temporary of the hash is then 128 MB, and the few alive at once
#: stay under about 1 GB
MC_WORDS_PER_GROUP = 1 << 24


def mc_circle_hits_chunked(key: torch.Tensor, n: int,
                           chunk: int = 1 << 20) -> torch.Tensor:
    """Per-chunk hit counts, (n_chunks,) int32: chunk i throws ``per``
    darts under ``fold_in(key, i)`` (:func:`mc_chunk_plan`), so all
    ``n_chunks·per`` >= n darts are counted. Chunks are drawn in groups
    of :data:`MC_WORDS_PER_GROUP` words; a chunk's count depends on its
    key alone, not on its group."""
    n_chunks, per = mc_chunk_plan(n, chunk)
    group = max(1, MC_WORDS_PER_GROUP // (2 * per))
    out = torch.empty((n_chunks,), dtype=torch.int32, device=key.device)
    for lo in range(0, n_chunks, group):
        hi = min(lo + group, n_chunks)
        ids = torch.arange(lo, hi, dtype=torch.int64, device=key.device)
        out[lo:hi] = mc_circle_hits(prng.fold_in(key, ids), per).to(
            torch.int32)
    return out
