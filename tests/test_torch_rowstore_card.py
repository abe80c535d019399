"""The sharded row store's PageRank fleet with its workers on the card (B7
a worker's edge block). Imports neither jax nor ``tpu_distalg``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rowstore_card.py

Without a card the tests skip; the CPU port is held to the JAX package in
``tests/test_torch_rowstore.py``. Standard: B7 sums each run in a fixed
order (no float atomics), so a worker's window sums replay bitwise on
the card, whatever the fill of the pulled rank vector and whatever the
cache's shard count; against the plain version on the CPU they agree
within (E − 1)·2⁻²⁴ relative, E the worker's edges: the bound of a
float32 sum of E nonnegative terms in any order. The PS tier's width
changes no bit of the ranks.

Sizes: the 512-vertex power-law cache of the CPU tests (in-degree 8,
α 1.6, 64-edge blocks) on 1, 2 and 4 shards.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch import graphs
from tpu_distalg_torch.cluster import rowstore
from tpu_distalg_torch.data import cache as dcache
from tpu_distalg_torch.graphs import ingest
from tpu_distalg_torch.ops import pagerank_kernels as pk
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The card, or a skip: the workers were asked for the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fleet's workers run B7 "
                    "there (chip_smoke.py phase 19 runs it at full size)")
    return torch.device("cuda")


def _cache(tmp_path, shards: int) -> str:
    path = str(tmp_path / f"pl{shards}")
    graphs.build_powerlaw_block_cache(
        path, n_vertices=512, n_shards=shards, avg_in_degree=8.0,
        alpha=1.6, seed=3, block_edges=64)
    return path


def _workers(path: str, device):
    mm, header = dcache.open_cache(path, layout=ingest.LAYOUT)
    geom = header["geom"]
    S = int(geom["n_shards"])
    _deg, didx, dmask = ingest.read_aux(path, geom)
    return [rowstore._PrWorker(
        s, dcache.shard_view(mm, S, s), int(geom["lo"][s]),
        int(geom["window"]), int(geom["block_edges"]), didx[s], dmask[s],
        None, device) for s in range(S)]


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_window_sums_replay_bitwise_across_fills(cuda_device, tmp_path,
                                                 shards):
    """Each worker's window sums on the card, for pulled rank vectors of
    fills 1..32 (a vector whose first ``fill`` of every 32 pulled rows
    are nonzero): the same bits on a second call, B7 launched once a
    block, and the plain version's sums within the float32 bound."""
    path = _cache(tmp_path, shards)
    card, cpu = _workers(path, cuda_device), _workers(path, "cpu")
    rng = np.random.default_rng(shards)
    for fill in (1, 2, 7, 16, 31, 32):
        for wc, wp in zip(card, cpu):
            n = wc.pull_idx.shape[0]
            pulled = rng.random(n, dtype=np.float32)
            pulled[np.arange(n) % 32 >= fill] = 0.0
            pk.spmv_table.launches = 0
            a = wc.contribs(pulled)
            assert pk.spmv_table.launches == len(wc.blocks)
            b = wc.contribs(pulled)
            assert a.tobytes() == b.tobytes()
            # nonnegative terms: a float32 sum of E of them in any order
            # is within (E − 1)·2⁻²⁴ of its value
            np.testing.assert_allclose(
                a, wp.contribs(pulled),
                rtol=(wp.src.shape[0] - 1) * 2.0**-24, atol=0)


def test_fleet_ranks_are_bitwise_across_ps_shards(cuda_device, tmp_path):
    """The fleet on the card over 1, 2 and 4 PS shards: the same rank
    bytes and commit digest; within 1e-6 of the port's streamed engine on
    the card at one block a staged step (the fleet's association); Σ
    ranks within 1e-4 of 1; a PS kill replays bitwise."""
    from tpu_distalg_torch.parallel import get_mesh

    path = _cache(tmp_path, 4)
    runs = [rowstore.run_cluster_pagerank(
        path, rowstore.ClusterPageRankConfig(n_iterations=8, ps_shards=p),
        device=cuda_device) for p in (1, 2, 4)]
    assert all(r["ranks"].tobytes() == runs[0]["ranks"].tobytes()
               and r["event_digest"] == runs[0]["event_digest"]
               for r in runs)
    gd = graphs.open_graph_dataset(path, get_mesh(data=4,
                                                  device=cuda_device))
    want = graphs.run_streamed_pagerank(
        gd, graphs.StreamedPageRankConfig(n_iterations=8,
                                          batch_blocks=1)).ranks.cpu()
    assert float(np.abs(runs[0]["ranks"] - want.numpy()).max()) <= 1e-6
    assert abs(float(runs[0]["ranks"].sum(dtype=np.float64)) - 1) <= 1e-4
    killed = rowstore.run_cluster_pagerank(
        path, rowstore.ClusterPageRankConfig(
            n_iterations=8, plan_spec="cluster:ps@3=kill",
            wal_dir=str(tmp_path / "wal")), device=cuda_device)
    assert killed["recoveries"] == 1
    assert killed["ranks"].tobytes() == runs[0]["ranks"].tobytes()
