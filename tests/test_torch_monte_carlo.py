"""Monte-Carlo π in the port (``tpu_distalg_torch/models/monte_carlo.py``,
``ops/sampling.py``) against the JAX package, and the threefry draws it
and the closure's neighbours rest on (``utils/prng.py``: ``split``,
``permutation``, ``normal``, ``logistic``) against ``jax.random``.

Integer outputs are held bit for bit: the per-chunk hit counts, π and
``n_used`` (π is 4·hits/n_used of equal integers), split keys and
permutations. ``normal`` and ``logistic`` are float32 transforms of an
exactly equal uniform; the port computes erfinv with XLA's polynomial
in float32 ops and the logarithms with torch's, so a value may sit a
few ulp from JAX's: held within 1e-6 absolute and relative, plus, for
``normal``, 4 ulp of the uniform carried through erfinv's slope
√(π/2)·exp(v²/2) (near |u| = 1 a one-ulp difference of x² moves v by up
to ~1e-3; torch's CPU kernels also differ by an ulp from run to run at
a few such elements).
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from tpu_distalg.models import monte_carlo as jmc
from tpu_distalg.ops import sampling as jsampling
from tpu_distalg.parallel import get_mesh as jget_mesh
from tpu_distalg.utils import prng as jprng
from tpu_distalg_torch import cli
from tpu_distalg_torch.models import monte_carlo
from tpu_distalg_torch.ops import sampling
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import prng
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

ROUNDS_N = [1, 2, 1000, 5000, 1 << 22]   # 0, 1, 2 and 3 shuffle rounds


def _words(key_jax) -> np.ndarray:
    return np.asarray(jax.random.key_data(key_jax)).astype(np.int64)


def _normal_tol(v: np.ndarray) -> np.ndarray:
    slope = np.sqrt(np.pi / 2) * np.exp(np.minimum(
        v.astype(np.float64) ** 2 / 2, 80.0))
    return 1e-6 * (1 + np.abs(v)) + 4 * 2.0**-24 * slope


@pytest.mark.parametrize("seed", [0, 9, 2**31 - 1])
def test_split_equals_jax(seed):
    kj, kt = jax.random.key(seed), prng.key(seed)
    for num in (2, 3, 17):
        np.testing.assert_array_equal(prng.split(kt, num).numpy(),
                                      _words(jax.random.split(kj, num)))


@pytest.mark.parametrize("n", ROUNDS_N)
@pytest.mark.parametrize("seed", [0, 5])
def test_permutation_equals_jax(n, seed):
    """Every round count, and at 2²² the 32-bit keys collide, so the
    stable order of equal keys is exercised too."""
    got = prng.permutation(prng.key(seed), n).numpy()
    want = np.asarray(jax.random.permutation(jax.random.key(seed), n))
    np.testing.assert_array_equal(got, want)


def test_permutation_of_a_batch_of_keys_equals_jax():
    kj = jax.random.split(jax.random.key(3), 4)
    got = prng.permutation(prng.split(prng.key(3), 4), 999).numpy()
    for i in range(4):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax.random.permutation(kj[i], 999)))


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_normal_and_logistic_within_tolerance_of_jax(seed):
    kj, kt = jax.random.key(seed), prng.key(seed)
    for shape in ((1,), (30,), (200000,), (7, 30)):
        v = np.asarray(jax.random.normal(kj, shape))
        got = prng.normal(kt, shape).numpy()
        assert got.dtype == np.float32 and got.shape == v.shape
        assert (np.abs(got - v) <= _normal_tol(v)).all()
        lg = np.asarray(jax.random.logistic(kj, shape))
        np.testing.assert_allclose(prng.logistic(kt, shape).numpy(), lg,
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(prng.logistic(kt, ()).numpy(),
                               np.asarray(jax.random.logistic(kj, ())),
                               rtol=1e-6, atol=1e-6)


def _jax_per_chunk(n_shards: int, config) -> np.ndarray:
    per_shard = -(-config.n // n_shards)
    key = jprng.root_key(config.seed)
    return sum(np.asarray(jsampling.mc_circle_hits_chunked(
        jax.random.fold_in(key, s), per_shard, config.chunk)).astype(
            np.int64) for s in range(n_shards))


@pytest.mark.parametrize("chunk", [1 << 20, 1 << 14])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_monte_carlo_equals_jax(n_shards, chunk):
    """Per-chunk hits (summed over the shards), π and n_used, bitwise."""
    cfg = monte_carlo.MonteCarloConfig(n=400_000, chunk=chunk)
    jcfg = jmc.MonteCarloConfig(n=400_000, chunk=chunk)
    hits, n_used = monte_carlo.per_chunk_hits(
        get_mesh(n_shards, device="cpu"), cfg)
    np.testing.assert_array_equal(hits.numpy(), _jax_per_chunk(n_shards,
                                                               jcfg))
    pi, n_used2 = monte_carlo.estimate_pi(get_mesh(n_shards, device="cpu"),
                                          cfg)
    want_pi, want_n = jmc.estimate_pi(jget_mesh(n_shards), jcfg)
    assert (pi, n_used, n_used2) == (want_pi, want_n, want_n)
    assert 3.13 <= pi <= 3.15


def test_monte_carlo_chunk_counts_equal_jax():
    """The chunk kernel itself, past one group of chunks and with a
    remainder: chunk i is keyed fold_in(key, i) whatever the grouping."""
    kt = prng.fold_in(prng.root_key(42), 5)
    kj = jax.random.fold_in(jprng.root_key(42), 5)
    for n, chunk in ((70_001, 1 << 12), (3 << 20, 1 << 20)):
        np.testing.assert_array_equal(
            sampling.mc_circle_hits_chunked(kt, n, chunk).numpy(),
            np.asarray(jsampling.mc_circle_hits_chunked(kj, n, chunk)))
    assert sampling.mc_chunk_plan(400_000, 1 << 14) == \
        jsampling.mc_chunk_plan(400_000, 1 << 14)


def test_monte_carlo_seed_and_chunking(mesh8):
    """As ``tests/test_workloads.py`` holds the JAX package: near π,
    deterministic given the seed, a new seed a new estimate, chunking
    immaterial to the statistics."""
    mesh = get_mesh(8, device="cpu")
    p1, n_used = monte_carlo.estimate_pi(mesh)
    assert n_used >= 400_000 and abs(p1 - np.pi) < 0.02
    assert p1 == monte_carlo.estimate_pi(mesh)[0]
    assert p1 != monte_carlo.estimate_pi(
        mesh, monte_carlo.MonteCarloConfig(seed=7))[0]
    big, _ = monte_carlo.estimate_pi(
        mesh, monte_carlo.MonteCarloConfig(n=200_000, chunk=1 << 20))
    small, _ = monte_carlo.estimate_pi(
        mesh, monte_carlo.MonteCarloConfig(n=200_000, chunk=1 << 12))
    assert abs(big - small) < 0.05


@pytest.mark.parametrize("argv", [["mc", "--n-slices", "1"],
                                  ["mc", "--n-slices", "4"],
                                  ["mc", "--n", "100000", "--mesh-shape",
                                   "2x1"]])
def test_mc_cli_prints_the_jax_line(argv, capsys):
    """``mc`` prints the JAX CLI's line for the same arguments (the
    shard count given: without one the JAX CLI takes every device, the
    port one emulated shard)."""
    from tpu_distalg import cli as jcli

    assert jcli.main(argv) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert cli.main(["--device", "cpu", *argv]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and got.startswith("Pi is roughly 3.1")


def test_mc_cli_refuses_restarts(capsys):
    """``--max-restarts`` is accepted (the estimate is stateless); a plan
    is refused, as ``mc`` has no seam that reads one."""
    assert cli.main(["--device", "cpu", "mc", "--n", "20000",
                     "--max-restarts", "1"]) == 0
    assert capsys.readouterr().out.startswith("Pi is roughly 3.")
    with pytest.raises(SystemExit, match="reads no fault plan"):
        cli.main(["--device", "cpu", "mc", "--max-restarts", "1",
                  "--fault-plan", "seed=1;segment:run@0=kill"])
