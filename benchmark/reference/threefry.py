"""Threefry-2x32 (Salmon et al., SC'11), written from the published
description for the reference's block draws.

A key is a pair of 32-bit words held in an int64 tensor of shape
``(..., 2)``. ``fold(key, data)`` hashes the counter ``(0, data)`` under
the key; ``words(key, n)`` hashes the counters ``(0, i)`` for ``i < n``
and gives the xor of the two output words. This is the counter scheme
of JAX's partitionable threefry, which the trainers under test key
their minibatch draws on. Plain torch integer ops: the same on the CPU
and on the card.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & M32


def hash2x32(k0, k1, c0, c1):
    """Twenty rounds of threefry-2x32 on the counter ``(c0, c1)`` under
    the key ``(k0, k1)``; int64 tensors of 32-bit words, broadcast."""
    k2 = k0 ^ k1 ^ PARITY
    sched = (k0, k1, k2)
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32
    for block in range(5):
        for r in ROTATIONS[block % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + sched[(block + 1) % 3]) & M32
        x1 = (x1 + sched[(block + 2) % 3] + block + 1) & M32
    return x0, x1


def seed_key(seed: int, device) -> torch.Tensor:
    """The key of an integer seed: high word 0, low word ``seed mod 2³²``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold(key: torch.Tensor, data) -> torch.Tensor:
    """A key per element of ``data`` (an int64 tensor), broadcast
    against the leading dims of ``key``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    d = data.unsqueeze(-1)
    h0, h1 = hash2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(d),
                      d & M32)
    return torch.cat(torch.broadcast_tensors(h0, h1), dim=-1)


def words(key: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., n)`` 32-bit words under each key of ``(..., 2)``."""
    i = torch.arange(int(n), dtype=torch.int64, device=key.device)
    h0, h1 = hash2x32(key[..., 0:1], key[..., 1:2], i >> 32, i & M32)
    return h0 ^ h1
