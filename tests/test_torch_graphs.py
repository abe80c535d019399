"""The port's out-of-core graph engine (``tpu_distalg_torch/graphs/``)
against the JAX package's (``tpu_distalg/graphs/``) on the CPU, and its
own contracts, at ``tests/test_graphs.py``'s shapes (V 512, 64-edge
blocks, 1 and 4 emulated shards).

Standards. Cache bytes (``.bin``, ``.meta.json`` and the three aux
payloads) equal the JAX package's exactly, and each package's engine
opens the other's cache. Ranks, after 5 iterations, within rtol 1e-5 and
atol 1e-8 of JAX's (float32 sums in another order); the resolved combine,
its wire-byte accounting, the block schedule and ``block_contribs``'s
windows equal JAX's (the windows within rtol 1e-6: the same adds, in
XLA's and torch's CPU loops). Within the port, streamed ≡ virtual ≡
resident, a replay and a segmented resume are bit for bit.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_distalg import graphs as jgraphs
from tpu_distalg.graphs import engine as jengine
from tpu_distalg.ops import graph as jgops
from tpu_distalg_torch import cli, faults, graphs
from tpu_distalg_torch.data import cache as dcache
from tpu_distalg_torch.graphs import engine, ingest
from tpu_distalg_torch.models import pagerank
from tpu_distalg_torch.ops import graph as gops
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import checkpoint, datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

RTOL, ATOL = 1e-5, 1e-8
PL = dict(n_vertices=512, avg_in_degree=8.0, alpha=1.6, seed=3,
          block_edges=64)
FILES = (".bin", ".meta.json", "." + ingest.AUX_DEG, "." + ingest.AUX_DIDX,
         "." + ingest.AUX_DMASK)


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.configure(False)


def _mesh(n):
    return get_mesh(data=n, device="cpu")


def _jmesh(n, mesh1, mesh4):
    return {1: mesh1, 4: mesh4}[n]


def _powerlaw(tmp_path, n_shards, name="pl", **kw):
    path = str(tmp_path / name)
    graphs.build_powerlaw_block_cache(path, n_shards=n_shards,
                                      **{**PL, **kw})
    return path


def _same_files(a, b):
    for suf in FILES:
        with open(a + suf, "rb") as f, open(b + suf, "rb") as g:
            assert f.read() == g.read(), suf


def _ranks(path, mesh, backend="streamed", **kw):
    gd = graphs.open_graph_dataset(path, mesh, backend=backend)
    return graphs.run_streamed_pagerank(
        gd, graphs.StreamedPageRankConfig(**{"n_iterations": 5, **kw}))


# ---------------------------------------------------------------- ingest


@pytest.mark.parametrize("graph", ["toy", "er"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_edge_block_cache_bytes_equal_jax(graph, n_shards, tmp_path):
    edges = (datasets.toy_graph_edges() if graph == "toy"
             else datasets.erdos_renyi_edges(300))
    kw = dict(n_shards=n_shards, block_edges=16)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jgraphs.build_edge_block_cache(edges, a, **kw)
    graphs.build_edge_block_cache(edges, b, **kw)
    _same_files(a, b)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_powerlaw_cache_bytes_equal_jax_chunked_by_edges(n_shards,
                                                         tmp_path):
    """97-edge chunks (prime): chunk boundaries fall inside hubs and
    blocks, and the bytes are still JAX's."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(PL, n_shards=n_shards, chunk_edges=97)
    jgraphs.build_powerlaw_block_cache(a, **kw)
    mm, header = graphs.build_powerlaw_block_cache(b, **kw)
    _same_files(a, b)
    E = header["geom"]["n_edges"]
    np.testing.assert_array_equal(
        np.bincount(np.asarray(mm)[:E, 1], minlength=512),
        ingest.powerlaw_in_degree_counts(512, 8.0, 1.6))


def test_each_package_opens_the_others_cache(tmp_path, mesh4):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jgraphs.build_powerlaw_block_cache(a, n_shards=4, **PL)
    graphs.build_powerlaw_block_cache(b, n_shards=4, **PL)
    cfg = dict(n_iterations=3)
    port_on_jax = _ranks(a, _mesh(4), **cfg).ranks.numpy()
    jax_on_port = np.asarray(jgraphs.run_streamed_pagerank(
        jgraphs.open_graph_dataset(b, mesh4),
        jgraphs.StreamedPageRankConfig(**cfg)).ranks)
    np.testing.assert_allclose(port_on_jax, jax_on_port, rtol=RTOL,
                               atol=ATOL)
    # reopening the other's cache through the builder is a cache hit
    _, header = graphs.build_powerlaw_block_cache(a, n_shards=4, **PL)
    assert header == dcache.read_header(a)


def test_reopen_over_other_edges_or_parameters_raises(tmp_path):
    edges = datasets.erdos_renyi_edges(64)
    path = str(tmp_path / "e")
    mm, header = graphs.build_edge_block_cache(edges, path, n_shards=4,
                                               block_edges=16)
    mm2, header2 = graphs.build_edge_block_cache(edges, path, n_shards=4,
                                                 block_edges=16)
    assert header2 == header
    for other, kw in ((edges, dict(block_edges=32)),
                      (edges[:-1], dict(block_edges=16))):
        with pytest.raises(ValueError, match="delete the cache"):
            graphs.build_edge_block_cache(other, path, n_shards=4, **kw)
    with pytest.raises(ValueError, match="built with"):
        graphs.build_powerlaw_block_cache(_powerlaw(tmp_path, 4), n_shards=4,
                                          **{**PL, "seed": 4})


def test_open_refusals_name_the_remedy(tmp_path):
    path = _powerlaw(tmp_path, 4)
    with pytest.raises(ValueError, match="re-ingest"):
        graphs.open_graph_dataset(path, _mesh(8))
    with pytest.raises(ValueError, match="unknown graph data backend"):
        graphs.open_graph_dataset(path, _mesh(4), backend="tiered")
    hdr = dcache.read_header(path)
    hdr["geom"]["bv"] = 99
    bad = _powerlaw(tmp_path, 4, name="bv")
    with open(dcache.meta_path(bad), "w") as f:
        json.dump(hdr, f)
    with pytest.raises(ValueError, match="bv=99.*re-ingest"):
        graphs.open_graph_dataset(bad, _mesh(4))
    os.remove(dcache.aux_path(path, ingest.AUX_DIDX))
    with pytest.raises(FileNotFoundError, match="delete the cache and "
                                                "re-ingest"):
        graphs.open_graph_dataset(path, _mesh(4))


def test_legacy_flat_meta_reopens_and_sweeps_identically(tmp_path):
    path = _powerlaw(tmp_path, 4)
    ref = _ranks(path, _mesh(4), n_iterations=3).ranks
    geom = dcache.read_header(path)["geom"]
    with open(dcache.meta_path(path), "w") as f:
        json.dump(geom, f)
    with pytest.raises(ValueError, match="legacy header"):
        graphs.open_graph_dataset(path, _mesh(4))
    gd = graphs.open_graph_dataset(path, _mesh(4), legacy_geom=geom)
    out = graphs.run_streamed_pagerank(
        gd, graphs.StreamedPageRankConfig(n_iterations=3)).ranks
    assert torch.equal(out, ref)


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize("combine", ["sparse", "dense"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_engine_matches_jax(n_shards, combine, tmp_path, mesh1, mesh4):
    path = _powerlaw(tmp_path, n_shards)
    got = _ranks(path, _mesh(n_shards), combine=combine)
    want = jgraphs.run_streamed_pagerank(
        jgraphs.open_graph_dataset(path, _jmesh(n_shards, mesh1, mesh4)),
        jgraphs.StreamedPageRankConfig(n_iterations=5, combine=combine))
    assert got.combine == want.combine == combine
    assert got.comm_stats == want.comm_stats
    np.testing.assert_allclose(got.ranks.numpy(), np.asarray(want.ranks),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got.ranks.sum()), 1.0, atol=1e-5)


def test_resolve_combine_and_block_schedule_equal_jax():
    for k in (1, 7, 100, 4096):
        for length in (8, 512, 10**6):
            for n in (1, 2, 4, 8):
                assert engine.resolve_combine("auto", k, length, n) == \
                    jengine.resolve_combine("auto", k, length, n)
    assert engine.resolve_combine("dense", 1, 10**6, 4) == "dense"
    for n_blocks in (1, 7, 12, 8190):
        for n_shards in (1, 4):
            for bb in (1, 3, 4, 5):
                np.testing.assert_array_equal(
                    engine._block_schedule(n_blocks, n_shards, bb),
                    jengine._block_schedule(n_blocks, n_shards, bb))


def test_block_contribs_matches_jax():
    """Two batches of one dst-sorted edge list: a 90-edge run into one
    dst crosses from the first into the second, and the second ends in
    padding rows (zero weight, the last real dst)."""
    rng = np.random.default_rng(4)
    V, lo, window, n = 200, 30, 48, 128
    dst = np.sort(np.concatenate([rng.integers(lo, lo + 40, 150),
                                  np.full(90, lo + 20)]))
    src = rng.integers(0, V, dst.size)
    w = rng.random(dst.size).astype(np.float32)
    rows = np.zeros((2 * n, 3), np.int32)
    rows[:, 1] = dst[-1]
    rows[:dst.size, 0], rows[:dst.size, 1] = src, dst
    rows[:dst.size, 2] = w.view(np.int32)
    head = dst[n - 1]
    assert (dst[n - 2:n + 2] == head).all()  # the run crosses batches
    ranks = rng.random(V).astype(np.float32)
    total = 0
    for b in range(2):
        batch = rows[b * n:(b + 1) * n]
        got = gops.block_contribs(torch.from_numpy(ranks),
                                  torch.from_numpy(batch), lo, window)
        want = jgops.block_contribs(jnp.asarray(ranks), jnp.asarray(batch),
                                    lo, window)
        assert got.shape == (window,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)
        total = total + got.numpy()
    want = np.zeros(window, np.float64)
    np.add.at(want, dst - lo, ranks[src].astype(np.float64) * w)
    np.testing.assert_allclose(total, want, rtol=1e-5)


def test_backends_bitwise_equal(tmp_path):
    path = _powerlaw(tmp_path, 4)
    ranks = {b: _ranks(path, _mesh(4), backend=b).ranks
             for b in ("streamed", "virtual", "resident")}
    assert torch.equal(ranks["streamed"], ranks["virtual"])
    assert torch.equal(ranks["streamed"], ranks["resident"])


def test_replay_and_segmented_resume_bitwise(tmp_path):
    path = _powerlaw(tmp_path, 4)
    gd = graphs.open_graph_dataset(path, _mesh(4))
    cfg = graphs.StreamedPageRankConfig(n_iterations=6)
    straight = graphs.run_streamed_pagerank(gd, cfg).ranks
    assert torch.equal(graphs.run_streamed_pagerank(gd, cfg).ranks, straight)
    ck = str(tmp_path / "ck")
    seg = graphs.run_streamed_pagerank(gd, cfg, checkpoint_dir=ck,
                                       checkpoint_every=2)
    assert torch.equal(seg.ranks, straight)
    # stopped after 4 of 6 sweeps, then resumed from the checkpoint
    ck2 = str(tmp_path / "ck2")
    graphs.run_streamed_pagerank(
        gd, graphs.StreamedPageRankConfig(n_iterations=4),
        checkpoint_dir=ck2, checkpoint_every=2)
    assert checkpoint.latest_step(ck2) == 4
    resumed = graphs.run_streamed_pagerank(gd, cfg, checkpoint_dir=ck2,
                                           checkpoint_every=2)
    assert torch.equal(resumed.ranks, straight)


def test_engine_agrees_with_the_resident_csr_path(tmp_path):
    """The same deduped ER graph through the engine (blocked partials,
    the sparse or dense combine) and through ``models/pagerank``'s
    standard mode (one B7 sweep a shard)."""
    rng = np.random.default_rng(0)
    V, E = 300, 2000
    edges = np.stack([rng.integers(0, V, E), rng.integers(0, V, E)],
                     1).astype(np.int64)
    path = str(tmp_path / "e")
    graphs.build_edge_block_cache(edges, path, n_shards=4, block_edges=64,
                                  n_vertices=V)
    ref = pagerank.run(edges, _mesh(4), pagerank.PageRankConfig(
        n_iterations=10, mode="standard"), n_vertices=V).ranks
    for combine in ("sparse", "dense"):
        got = _ranks(path, _mesh(4), n_iterations=10, combine=combine)
        np.testing.assert_allclose(got.ranks.numpy(), ref.numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_data_seams_fire_on_the_streamed_path(tmp_path):
    """The staged batches pass the data subsystem's seams: a planned
    OSError at ``data:gather`` and at ``data:h2d`` reaches the sweep."""
    path = _powerlaw(tmp_path, 4)
    for point in ("data:gather", "data:h2d"):
        faults.configure(f"seed=5;{point}@1=oserror")
        with pytest.raises(OSError):
            _ranks(path, _mesh(4), n_iterations=1)
        assert faults.active().fired == [(point, 1, "oserror")]


# ------------------------------------------------------------------- CLI


@pytest.mark.parametrize("backend", ["streamed", "virtual"])
def test_cli_engine_backends(backend, tmp_path, capsys):
    argv = ["--device", "cpu", "pagerank", "--data-backend", backend,
            "--n-vertices", "512", "--n-slices", "4", "--block-edges",
            "256", "--n-iterations", "3", "--stream-cache",
            str(tmp_path / "c")]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len([x for x in out if " has rank: " in x]) == 10
    assert out[-1].startswith("[pagerank] 3 iterations in ")
    assert f"[{backend} engine, combine=" in out[-1]
    assert out[-1].endswith(" B]")
    edges = datasets.erdos_renyi_edges(512)
    gd = graphs.open_graph_dataset(str(tmp_path / "c"), _mesh(4))
    assert gd.n_edges == gops.prepare_edges(edges, 512).n_edges


def test_cli_engine_refuses_the_reference_mode():
    with pytest.raises(SystemExit, match="reference-parity mode is "
                                         "resident-only"):
        cli.main(["--device", "cpu", "pagerank", "--data-backend",
                  "virtual", "--mode", "reference"])
