"""The graph engine's batch accumulate and sweeps on the card, against
the port's plain versions and its own backends. Imports neither jax nor
``tpu_distalg``, so it also runs on a machine with only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_card.py

Without a card the tests skip (the CPU port is held to the JAX package
in ``tests/test_torch_graphs.py``). Standards: a batch's window
against the plain version on the CPU (``index_add_``'s sequential adds)
within rtol 1e-4 on a hub run of ~196,608 edges (a float32 sum of that
many positive terms in two orders) and 1e-5 elsewhere, and against a
float64 sum of the same products within rtol 1e-6 (B7 sums in tiles:
1.4e-7 measured, PERF.md §6); replays and the backends bit for bit
(B7 sums in a fixed order and the window add has no atomics).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch import graphs
from tpu_distalg_torch.ops import graph as gops
from tpu_distalg_torch.ops import pagerank_kernels as pk
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

#: a staged batch at bench.py's geometry: 3 blocks of 65,536 edges
BATCH = 3 * 65536


@pytest.fixture
def cuda_device():
    """The card, or a skip: these tests compare the card's kernel path
    with its plain version and its own replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs the card "
                    "paths); the CPU port is held to JAX elsewhere")
    return torch.device("cuda")


def _batch(n, V, hub, seed=0):
    """n dst-sorted packed rows: ``hub`` edges into one dst, then short
    runs, then zero-weight padding repeating the last dst."""
    rng = np.random.default_rng(seed)
    rest = n - hub - 1000
    dst = np.sort(np.concatenate([np.full(hub, 40),
                                  rng.integers(41, 41 + rest // 3, rest)]))
    rows = np.zeros((n, 3), np.int32)
    rows[:, 1] = dst[-1]
    rows[:dst.size, 0] = rng.integers(0, V, dst.size)
    rows[:dst.size, 1] = dst
    rows[:dst.size, 2] = rng.random(dst.size).astype(np.float32).view(
        np.int32)
    ranks = rng.random(V).astype(np.float32)
    return torch.from_numpy(rows), torch.from_numpy(ranks)


@pytest.mark.gpu
@pytest.mark.parametrize("hub", [BATCH - 1000, 5000, 1])
def test_batch_accumulate_matches_plain(cuda_device, hub):
    rows, ranks = _batch(BATCH, 1 << 20, hub)
    lo, window = 40, BATCH // 3 + 48
    before = pk.spmv_table.launches
    got = gops.block_contribs(ranks.to(cuda_device), rows.to(cuda_device),
                              lo, window)
    assert pk.spmv_table.launches == before + 1
    plain = gops.block_contribs(ranks, rows, lo, window)
    torch.testing.assert_close(got.cpu(), plain, atol=1e-8,
                               rtol=1e-4 if hub > 100_000 else 1e-5)
    r = rows.numpy()
    exact = np.zeros(window, np.float64)
    np.add.at(exact, r[:, 1] - lo,
              ranks.numpy()[r[:, 0]].astype(np.float64)
              * r[:, 2].view(np.float32))
    np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=1e-6,
                               atol=1e-12)


@pytest.mark.gpu
def test_batch_accumulate_replays_bitwise(cuda_device):
    rows, ranks = _batch(BATCH, 1 << 20, BATCH - 1000)
    rows, ranks = rows.to(cuda_device), ranks.to(cuda_device)
    first = gops.block_contribs(ranks, rows, 40, BATCH)
    for _ in range(100):
        assert torch.equal(gops.block_contribs(ranks, rows, 40, BATCH),
                           first)


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [1, 4])
def test_engine_backends_bitwise_on_the_card(cuda_device, n_shards,
                                             tmp_path):
    path = str(tmp_path / "pl")
    graphs.build_powerlaw_block_cache(
        path, n_vertices=1 << 14, n_shards=n_shards, avg_in_degree=16.0,
        alpha=1.6, seed=2, block_edges=4096)
    mesh = get_mesh(data=n_shards, device=cuda_device)
    cfg = graphs.StreamedPageRankConfig(n_iterations=5)
    ranks = {}
    for backend in ("streamed", "virtual", "resident"):
        gd = graphs.open_graph_dataset(path, mesh, backend=backend)
        ranks[backend] = graphs.run_streamed_pagerank(gd, cfg).ranks
    assert ranks["streamed"].device.type == "cuda"
    assert torch.equal(ranks["streamed"], ranks["virtual"])
    assert torch.equal(ranks["streamed"], ranks["resident"])
    again = graphs.run_streamed_pagerank(graphs.open_graph_dataset(
        path, mesh), cfg).ranks
    assert torch.equal(again, ranks["streamed"])
