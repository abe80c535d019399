"""Counter-based PRNG: JAX's threefry2x32, bit for bit, in torch.

Port of ``tpu_distalg/utils/prng.py`` and of the parts of
``jax.random`` it rests on, under ``jax_threefry_partitionable=True``
(the default of jax 0.9):

  * a key is a pair of 32-bit words; :func:`key` splits a seed as
    JAX's ``_threefry_seed`` does: ``(seed >> 32, seed & 0xFFFFFFFF)``
    of a 32-bit seed;
  * :func:`fold_in` is ``threefry2x32(key, (0, data))``;
  * :func:`bits` hashes each element's flat index, split into its high
    and low 32-bit words, and returns ``bits1 ^ bits2``;
  * :func:`uniform` puts the top 23 bits of a word into the mantissa of
    a float in [1, 2) and subtracts 1, as JAX's ``_uniform`` does;
  * :func:`split` is the fold-like split: key i is ``fold_in(key, i)``;
  * :func:`permutation` is JAX's ``_shuffle``: a few rounds of a stable
    sort of the values by fresh 32-bit words;
  * :func:`normal` and :func:`logistic` transform a uniform as
    ``_normal_real`` (√2·erfinv) and ``_logistic`` (log u − log1p(−u))
    do. Their float32 functions are not XLA's: :func:`erfinv` is XLA's
    single-precision polynomial in float32 ops, and the logarithms are
    torch's, so a value may sit up to a few ulp from JAX's (the tests
    hold them within 1e-6 absolute and relative).

So the port draws the same minibatches as the JAX package from the
same seed, and a run of one can be compared with a run of the other
step by step. torch has no full unsigned 32-bit arithmetic, so words
live in int64 tensors masked to 32 bits; that runs alike on the CPU
and on the card. In JAX this is XLA code, not a Pallas kernel, so
plain torch ops are its port. Keys are int64 tensors of shape
``(..., 2)``; a batch of keys gives a batch of draws.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds) of the counter pair
    ``(x1, x2)`` under the key ``(k1, k2)``; every argument is an int64
    tensor of 32-bit words, broadcast together. Returns the pair of
    hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def key(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """The key of an integer seed, as ``jax.random.key(seed)`` with
    JAX's default 32-bit integers: the seed is a 32-bit word, so the
    high word ``seed >> 32`` is 0 and the low word is ``seed mod 2³²``
    (JAX gives ``[0, 4294967295]`` for -1 and ``[0, 5]`` for 2³²+5)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``k`` and a 32-bit integer
    (or an integer tensor, which gives one key per element)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device)
    d = data.unsqueeze(-1) if data.dim() else data
    k1, k2 = k[..., 0:1], k[..., 1:2]
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(d), d & MASK32)
    return torch.cat(torch.broadcast_tensors(y1, y2), dim=-1)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32-bit random words of ``shape`` (int64 tensor), as
    ``jax.random.bits(k, shape)``; a batch of keys ``(..., 2)`` gives
    ``(..., *shape)``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    view = lead + (1,) * len(shape)
    k1 = k[..., 0].reshape(view)
    k2 = k[..., 1].reshape(view)
    idx = idx.reshape(shape)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return b1 ^ b2


def uniform(k: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval), as ``jax.random.uniform``."""
    words = bits(k, shape)
    f = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    out = (f - 1.0) * (hi - lo) + lo
    return torch.maximum(lo, out)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` under ``jax_threefry_partitionable``: the
    counters are the pairs ``(0, i)``, so key i is ``fold_in(k, i)``;
    (..., 2) keys give (..., num, 2)."""
    idx = torch.arange(int(num), dtype=torch.int64, device=k.device)
    return fold_in(k.unsqueeze(-2), idx)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: JAX's ``_shuffle`` of
    ``arange(n)`` (int64). Each of ``ceil(3·ln(max(1, n)) / ln(2³²−1))``
    rounds (float64, as numpy computes it) splits the key, draws a
    32-bit word per position under the second half and sorts the values
    by the words, stably (``lax.sort_key_val`` is stable), so equal
    words keep their order. (..., 2) keys give (..., n)."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK32)))
    x = torch.arange(n, dtype=torch.int64, device=k.device).expand(
        *k.shape[:-1], n)
    for _ in range(rounds):
        halves = split(k)
        k, sub = halves[..., 0, :], halves[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x.contiguous()


#: XLA's float32 ErfInv (Giles' single-precision approximation): the
#: Horner coefficients for w = −log1p(−x²) below 5 and from 5 up
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf⁻¹ as XLA computes it (±1 → ±max float), in float32
    ops on ``x``'s device: within 3 ulp of XLA's on the CPU (a Horner
    step XLA fuses into an FMA rounds once, here twice)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """float32 standard normals, as ``jax.random.normal``: a uniform on
    [nextafter(−1, 0), 1) under ``k``, then √2·erfinv."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    sqrt2 = torch.tensor(np.sqrt(2), dtype=torch.float32, device=k.device)
    return sqrt2 * erfinv(uniform(k, shape, lo, 1.0))


def logistic(k: torch.Tensor, shape) -> torch.Tensor:
    """float32 standard logistic draws, as ``jax.random.logistic``: a
    uniform u on [tiny, 1), then log(u) − log1p(−u)."""
    u = uniform(k, shape, float(torch.finfo(torch.float32).tiny), 1.0)
    return torch.log(u) - torch.log1p(-u)


def root_key(seed: int = 42, device: str | torch.device = "cpu"
             ) -> torch.Tensor:
    return key(seed, device)


def step_key(k: torch.Tensor, t) -> torch.Tensor:
    """Key for iteration t (≙ the reference's ``seed=42 + t``)."""
    return fold_in(k, t)
