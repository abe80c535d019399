"""The block draws and the packed layout of the block-sampled trainers,
worked out again from the seed the benchmark hands to the program.

Layout: the training rows, in the order the benchmark made them, are
cut into blocks of ``block_rows`` rows; block ``b`` holds rows
``[b·block_rows, (b+1)·block_rows)``, and the rows past the data (the
padding up to a whole number of blocks, or of ``block_rows × replicas``)
are invalid. With ``R`` replicas, replica ``s`` owns the blocks
``[s·n_blocks, (s+1)·n_blocks)``.

Draw: a step's (or a round's) sample of ``n_sampled`` distinct blocks
out of ``n_blocks`` is the positions of the ``n_sampled`` smallest of
``n_blocks`` threefry words, ties to the lower position. Keys:

  * one replica, step ``t``: ``fold(fold(seed_key, t), 0)``;
  * replicas, round ``t``, replica ``s``:
    ``fold(fold(fold(seed_key, t), 0), s)``; the round's one draw
    serves all of its local steps.
"""

from __future__ import annotations

import torch

from reference import threefry


def padded_rows(n_rows: int, block_rows: int, replicas: int = 1) -> int:
    """Rows after padding to a whole number of ``block_rows × replicas``."""
    mult = block_rows * replicas
    return n_rows + (-n_rows) % mult


def blocks_per_replica(n_rows: int, block_rows: int, replicas: int = 1
                       ) -> int:
    return padded_rows(n_rows, block_rows, replicas) // block_rows // replicas


def sampled_blocks(n_blocks: int, fraction: float) -> int:
    return max(1, round(fraction * n_blocks))


def valid_rows_per_block(n_rows: int, block_rows: int, n_total_blocks: int,
                         device) -> torch.Tensor:
    """(n_total_blocks,) int64: how many rows of each block are data."""
    start = torch.arange(n_total_blocks, dtype=torch.int64,
                         device=device) * block_rows
    return (n_rows - start).clamp(0, block_rows)


def _smallest(keys: torch.Tensor, n_blocks: int, n_sampled: int):
    w = threefry.words(keys, n_blocks)
    return torch.argsort(w, dim=-1, stable=True)[..., :n_sampled]


def step_draws(seed: int, t0: int, steps: int, n_blocks: int,
               n_sampled: int, device, chunk: int = 256) -> torch.Tensor:
    """(steps, n_sampled) int64 block ids of the steps ``t0 …``."""
    key = threefry.seed_key(seed, device)
    out = []
    for lo in range(t0, t0 + steps, chunk):
        ts = torch.arange(lo, min(lo + chunk, t0 + steps),
                          dtype=torch.int64, device=device)
        k = threefry.fold(threefry.fold(key, ts), 0)
        out.append(_smallest(k, n_blocks, n_sampled))
    return torch.cat(out)


def round_draws(seed: int, t0: int, rounds: int, replicas: int,
                n_blocks: int, n_sampled: int, device,
                chunk: int = 256) -> torch.Tensor:
    """(rounds, replicas, n_sampled) int64 GLOBAL block ids of the rounds
    ``t0 …``: replica s's ids are offset by ``s·n_blocks``."""
    key = threefry.seed_key(seed, device)
    reps = torch.arange(replicas, dtype=torch.int64, device=device)
    out = []
    for lo in range(t0, t0 + rounds, chunk):
        ts = torch.arange(lo, min(lo + chunk, t0 + rounds),
                          dtype=torch.int64, device=device)
        k = threefry.fold(threefry.fold(key, ts), 0)
        k = threefry.fold(k.unsqueeze(-2), reps)
        out.append(_smallest(k, n_blocks, n_sampled)
                   + reps[:, None] * n_blocks)
    return torch.cat(out)
