"""The port's threefry, samplers and initial weights
(``tpu_distalg_torch/utils/prng.py``, ``ops/sampling.py``,
``ops/logistic.init_weights``) against ``jax.random`` and the JAX
package's ``ops/sampling.py``.

These are integer hashes and exact float constructions, so the port
must equal JAX bit for bit: key words, ``fold_in``, 32-bit ``bits``
(also past 2¹⁶ elements, where the counter's high word starts to
matter only beyond 2³²), float32 ``uniform`` in [0, 1) and [-1, 1),
Bernoulli masks and their kept-row counts, and block-id draws at 1, 4
and 8 shards.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_distalg.ops import logistic as jlogistic
from tpu_distalg.ops import sampling as jsampling
from tpu_distalg.utils import prng as jprng
from tpu_distalg_torch.ops import logistic, sampling
from tpu_distalg_torch.utils import prng
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

SEEDS = [0, 1, 7, 42, 2**31 - 1, 123456789]
SHAPES = [(1,), (7,), (3, 5), (70001,), (2, 40000)]


def _words(key_jax) -> np.ndarray:
    return np.asarray(jax.random.key_data(key_jax)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + [-1, 2**32 + 5])
def test_key_and_fold_in_equal_jax(seed):
    kj, kt = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(kt.numpy(), _words(kj))
    for t in (0, 1, 5, 1499, 2**31 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(kt, t).numpy(), _words(jax.random.fold_in(kj, t)))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_equal_jax(seed):
    kj, kt = jax.random.key(seed), prng.key(seed)
    for shape in SHAPES:
        np.testing.assert_array_equal(
            prng.bits(kt, shape).numpy(),
            np.asarray(jax.random.bits(kj, shape)).astype(np.int64))
        # float32 compared bitwise: XLA's (u − 1)·(max − min) + min may
        # fuse into an FMA, but (max − min) is a power of two here, so
        # fused or not the result is the same float
        for lo, hi in ((0.0, 1.0), (-1.0, 1.0)):
            got = prng.uniform(kt, shape, lo, hi).numpy()
            want = np.asarray(jax.random.uniform(kj, shape, minval=lo,
                                                 maxval=hi))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


def test_batched_keys_equal_vmapped_jax():
    kj = jax.random.key(3)
    ks = jax.vmap(lambda s: jax.random.fold_in(kj, s))(jnp.arange(5))
    kt = prng.fold_in(prng.key(3), torch.arange(5))
    np.testing.assert_array_equal(kt.numpy(), _words(ks))
    bj = jax.vmap(lambda k: jax.random.bits(k, (9, 2)))(ks)
    np.testing.assert_array_equal(prng.bits(kt, (9, 2)).numpy(),
                                  np.asarray(bj).astype(np.int64))


@pytest.mark.parametrize("seed,dim", [(7, 31), (7, 126), (3, 1000)])
def test_init_weights_equal_jax(seed, dim):
    want = np.asarray(jlogistic.init_weights(jprng.root_key(seed), dim))
    got = logistic.init_weights(prng.root_key(seed), dim).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n,fraction", [(398, 0.1), (4096, 0.3),
                                        (70000, 0.05)])
def test_bernoulli_mask_and_counts_equal_jax(n, fraction):
    rng = np.random.default_rng(n)
    valid = (rng.random(n) < 0.9).astype(np.float32)
    kj, kt = jprng.root_key(42), prng.root_key(42)
    for t in (0, 1, 17, 1499):
        want = np.asarray(jsampling.bernoulli_mask(
            kj, t, n, fraction, jnp.asarray(valid)))
        got = sampling.bernoulli_mask(kt, t, n, fraction,
                                      torch.as_tensor(valid)).numpy()
        np.testing.assert_array_equal(got, want)
        assert float(got.sum()) == float(want.sum())


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_sample_block_ids_equal_jax(n_shards):
    kj, kt = jprng.root_key(42), prng.root_key(42)
    for n_blocks, n_sampled in ((128, 13), (25, 2), (7, 7)):
        for t in (0, 3, 999):
            want = np.asarray(jsampling.sample_block_ids(
                jax.random.fold_in(kj, t), n_shards, n_blocks, n_sampled))
            got = sampling.sample_block_ids(prng.fold_in(kt, t), n_shards,
                                            n_blocks, n_sampled)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        # a batch of step keys draws each step's ids at once, as the
        # fused trainers do before their loop
        ts = np.arange(10, 16)
        want = np.asarray(jax.vmap(lambda t: jsampling.sample_block_ids(
            jax.random.fold_in(kj, t), n_shards, n_blocks, n_sampled))(
            jnp.asarray(ts)))
        got = sampling.sample_block_ids(
            prng.fold_in(kt, torch.as_tensor(ts)), n_shards, n_blocks,
            n_sampled)
        np.testing.assert_array_equal(got.numpy(), want)
