"""Monte Carlo, the transitive closure and the threefry permutation on
the card, against the CPU port. Imports neither jax nor
``tpu_distalg``, so it also runs on a machine with only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_closure_card.py

Without a card the tests skip (they hold the card's torch ops to the
CPU's; the CPU port is held to the JAX package in
``tests/test_torch_monte_carlo.py`` and ``tests/test_torch_closure.py``).
Every output here is an integer or a boolean, so the card must equal
the CPU bit for bit: the closure's matrices, pair arrays, rounds and
regrow sequence, the Monte-Carlo chunk counts, and the permutation.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch.models import monte_carlo
from tpu_distalg_torch.models import transitive_closure as tc
from tpu_distalg_torch.ops import sampling
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.telemetry import events as tevents
from tpu_distalg_torch.utils import datasets, prng
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))


@pytest.fixture
def cuda_device():
    """The card, or a skip: these tests compare the card with the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs the card "
                    "paths); the CPU port is held to JAX elsewhere")
    return torch.device("cuda")


GRAPHS = {
    "toy": lambda: datasets.toy_graph_edges(),
    "forest48": lambda: datasets.chain_forest_edges(48),
    "er200": lambda: datasets.erdos_renyi_edges(200, 2.0),
    "dag120": lambda: datasets.closure_dag_edges(120, 5, seed=1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("shards", [1, 4])
def test_dense_closure_on_the_card_equals_the_cpu(graph, shards,
                                                  cuda_device):
    edges = GRAPHS[graph]()
    card = tc.run(edges, get_mesh(data=shards, device=cuda_device))
    cpu = tc.run(edges, get_mesh(data=shards, device="cpu"))
    assert torch.equal(card.paths.cpu(), cpu.paths)
    assert (card.n_paths, card.n_rounds) == (cpu.n_paths, cpu.n_rounds)


@pytest.mark.gpu
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_sparse_auto_on_the_card_equals_the_cpu(graph, cuda_device,
                                                tmp_path):
    """Pairs, rounds and the regrow sequence (from a start capacity of
    16) equal the CPU port's."""
    edges = GRAPHS[graph]()
    runs = {}
    for name, dev in (("card", cuda_device), ("cpu", "cpu")):
        sink = tevents.configure(str(tmp_path / name))
        try:
            res = tc.run_sparse_auto(edges, get_mesh(data=2, device=dev),
                                     start_capacity=16)
        finally:
            tevents.configure(False)
        with open(sink.path) as f:
            grows = [(e["capacity"], e["next_capacity"])
                     for e in map(json.loads, f)
                     if e["ev"] == "closure_capacity_grow"]
        runs[name] = (res, grows)
    (card, g_card), (cpu, g_cpu) = runs["card"], runs["cpu"]
    assert np.array_equal(card.paths, cpu.paths)
    assert (card.n_paths, card.n_rounds) == (cpu.n_paths, cpu.n_rounds)
    assert g_card == g_cpu


@pytest.mark.gpu
def test_sparse_auto_on_the_card_regrows_through_checkpoints(cuda_device,
                                                            tmp_path):
    """A checkpointed attempt that overflowed leaves checkpoints of the
    old capacity; the auto-sizer prunes them and its regrown run equals
    a straight one."""
    edges = datasets.closure_dag_edges(120, 5, seed=1)
    mesh = get_mesh(data=1, device=cuda_device)
    straight = tc.run_sparse_auto(edges, mesh, start_capacity=16)
    ck = str(tmp_path / "ck")
    with pytest.raises(ValueError):   # the start capacity overflows
        tc.run_sparse(edges, mesh, tc.SparseClosureConfig(capacity=2048),
                      checkpoint_dir=ck, checkpoint_every=2)
    resumed = tc.run_sparse_auto(edges, mesh, start_capacity=2048,
                                 checkpoint_dir=ck, checkpoint_every=2)
    assert np.array_equal(resumed.paths, straight.paths)
    assert os.listdir(ck)


@pytest.mark.gpu
def test_monte_carlo_chunks_on_the_card_equal_the_cpu(cuda_device):
    """Hit counts per chunk, bitwise, at chunk 2²⁰ (groups of chunks on
    the card) and 2¹⁴, and π from 4 shards."""
    for chunk in (1 << 20, 1 << 14):
        n = 10 * chunk + 7
        card = sampling.mc_circle_hits_chunked(
            prng.fold_in(prng.root_key(42, cuda_device), 3), n, chunk)
        cpu = sampling.mc_circle_hits_chunked(
            prng.fold_in(prng.root_key(42), 3), n, chunk)
        assert torch.equal(card.cpu(), cpu)
    cfg = monte_carlo.MonteCarloConfig(n=400_000)
    assert monte_carlo.estimate_pi(get_mesh(4, device=cuda_device), cfg) == \
        monte_carlo.estimate_pi(get_mesh(4, device="cpu"), cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 1000, 5000, 1 << 22])
def test_permutation_on_the_card_equals_the_cpu(n, cuda_device):
    """0, 1, 2 and 3 rounds of the stable sort; batched keys too."""
    keys = prng.split(prng.key(11), 3)
    assert torch.equal(prng.permutation(keys.to(cuda_device), n).cpu(),
                       prng.permutation(keys, n))
