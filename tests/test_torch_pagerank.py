"""The port's PageRank slice (``tpu_distalg_torch/models/pagerank.py``,
its CLI subcommand and ``convert.pagerank_state_from_jax``) against the
JAX package's ``models/pagerank.py`` on the CPU.

Both packages sweep the same deduplicated, dst-sorted edges from the
same numpy graphs; the JAX package runs its Pallas kernels in interpret
mode on the 8-device CPU mesh, the port its kernels' plain versions on
8 emulated shards. They add in different orders, so ranks are held to
rtol 1e-5, atol 1e-8, as ``tests/test_pallas_pagerank.py`` holds the JAX
sweeps to each other. The reference-mode toy graph must give the
recorded golden to 1e-5, and the has_rank masks must be equal.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg.models import pagerank as jpagerank
from tpu_distalg.ops import graph as jgops
from tpu_distalg_torch import cli, convert, faults
from tpu_distalg_torch.models import pagerank
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import checkpoint, datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

GOLDEN = [0.38891305880091237, 0.214416470596171, 0.3966704706029163]
V, E, ITERS = 4096, 65536, 8
TOL = dict(rtol=1e-5, atol=1e-8)


def _random_edges(v, e, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, size=e), rng.integers(0, v, size=e)],
                    axis=1).astype(np.int64)


def _port(edges, n_shards=8, n_vertices=None, **cfg):
    return pagerank.run(edges, get_mesh(data=n_shards, device="cpu"),
                        pagerank.PageRankConfig(**cfg), n_vertices)


@pytest.fixture(scope="module")
def graph():
    return _random_edges(V, E, 5)


def _jax_standard(edges, mesh8, scatter):
    """JAX's standard-mode ranks; its 'pallas' plan at this size needs
    the small chunk geometry of ``test_standard_mode_pallas_matches_xla``
    (the default geometry plans nothing for a graph this small)."""
    cfg = jpagerank.PageRankConfig(n_iterations=ITERS, mode="standard",
                                   scatter=scatter)
    if scatter != "pallas":
        return np.asarray(jpagerank.run(edges, mesh8, cfg, V).ranks)
    el = jgops.prepare_edges(edges, V)
    de = jpagerank.prepare_device_edges(el, mesh8, plan_chunk=128,
                                        plan_blk=2)
    assert de.plan is not None
    fn = jpagerank.make_run_fn(mesh8, cfg, V, de.plan)
    return np.asarray(fn(de.src, de.dst, de.w_e, de.emask, de.has_out,
                         de.n_ref)[0])


@pytest.mark.parametrize("scatter", ["auto", "spmv", "pallas", "xla"])
def test_standard_mode_matches_jax(graph, mesh8, scatter):
    want = _jax_standard(graph, mesh8, scatter)
    got = _port(graph, n_vertices=V, n_iterations=ITERS, mode="standard",
                scatter=scatter)
    assert got.ranks.dtype == torch.float32 and got.ranks.shape == (V,)
    np.testing.assert_allclose(got.ranks.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.has_rank.numpy(), np.ones(V))
    np.testing.assert_allclose(float(got.ranks.sum()), 1.0, rtol=1e-4)


def test_standard_mode_without_dangling_redistribution(graph, mesh8):
    cfg = dict(n_iterations=ITERS, mode="standard", scatter="xla",
               redistribute_dangling=False)
    want = jpagerank.run(graph[:5000], mesh8,
                         jpagerank.PageRankConfig(**cfg), V)
    got = _port(graph[:5000], n_vertices=V, **cfg)
    np.testing.assert_allclose(got.ranks.numpy(), np.asarray(want.ranks),
                               **TOL)
    assert float(got.ranks.sum()) < 0.99  # the sinks' mass leaks


def test_reference_mode_toy_golden_and_duplicates():
    """The recorded output of the reference (``pagerank.py:66-68``);
    duplicate edges change nothing (``links.distinct()``)."""
    edges = datasets.toy_graph_edges()
    res = _port(edges)
    np.testing.assert_allclose(res.ranks.numpy(), GOLDEN, atol=1e-5)
    np.testing.assert_array_equal(res.has_rank.numpy(), [1.0, 1.0, 1.0])
    doubled = _port(np.concatenate([edges, edges, edges[:2]]))
    np.testing.assert_array_equal(doubled.ranks.numpy(), res.ranks.numpy())


@pytest.mark.parametrize("edges,n_iter", [
    (np.array([[0, 1], [1, 2]]), 3),
    (_random_edges(600, 900, 3), 10)], ids=["chain", "sparse-600"])
def test_reference_mode_matches_jax(edges, n_iter, mesh8):
    """Sinks keep no rank and their mass vanishes; vertices that receive
    nothing drop out, as in the JAX package."""
    want = jpagerank.run(edges, mesh8,
                         jpagerank.PageRankConfig(n_iterations=n_iter))
    got = _port(edges, n_iterations=n_iter)
    np.testing.assert_allclose(got.ranks.numpy(), np.asarray(want.ranks),
                               **TOL)
    np.testing.assert_array_equal(got.has_rank.numpy(),
                                  np.asarray(want.has_rank))
    assert float(got.ranks.sum()) < 1.0


@pytest.mark.parametrize("mode,scatter", [("standard", "auto"),
                                          ("standard", "pallas"),
                                          ("reference", "auto")])
def test_one_shard_matches_four(graph, mode, scatter):
    one = _port(graph, 1, V, n_iterations=ITERS, mode=mode, scatter=scatter)
    four = _port(graph, 4, V, n_iterations=ITERS, mode=mode,
                 scatter=scatter)
    np.testing.assert_allclose(one.ranks.numpy(), four.ranks.numpy(), **TOL)
    np.testing.assert_array_equal(one.has_rank.numpy(),
                                  four.has_rank.numpy())


@pytest.mark.parametrize("mode", ["standard", "reference"])
def test_segmented_run_is_bitwise_straight(graph, mode, tmp_path):
    """Checkpointed segments (3 + 3 + 3 + 1), and a resume of a 6-
    iteration run to 10, equal the straight 10-iteration run bit for
    bit; the other mode's checkpoint is refused."""
    cfg = pagerank.PageRankConfig(n_iterations=10, mode=mode)
    mesh = get_mesh(data=2, device="cpu")
    straight = pagerank.run(graph, mesh, cfg, V)
    seg = pagerank.run(graph, mesh, cfg, V, checkpoint_dir=str(tmp_path / "a"),
                       checkpoint_every=3)
    np.testing.assert_array_equal(seg.ranks.numpy(), straight.ranks.numpy())
    np.testing.assert_array_equal(seg.has_rank.numpy(),
                                  straight.has_rank.numpy())
    assert checkpoint.latest_step(str(tmp_path / "a")) == 10
    part = pagerank.PageRankConfig(n_iterations=6, mode=mode)
    pagerank.run(graph, mesh, part, V, checkpoint_dir=str(tmp_path / "b"),
                 checkpoint_every=4)
    resumed = pagerank.run(graph, mesh, cfg, V,
                           checkpoint_dir=str(tmp_path / "b"),
                           checkpoint_every=4)
    np.testing.assert_array_equal(resumed.ranks.numpy(),
                                  straight.ranks.numpy())
    other = "reference" if mode == "standard" else "standard"
    with pytest.raises(ValueError, match="incompatible"):
        pagerank.run(graph, mesh, pagerank.PageRankConfig(
            n_iterations=12, mode=other), V,
            checkpoint_dir=str(tmp_path / "b"))


@pytest.mark.parametrize("mode", ["reference", "standard"])
def test_state_from_jax_continues_the_jax_run(graph, mesh8, mode):
    """4 JAX iterations, carried across by
    ``convert.pagerank_state_from_jax``, then 6 port iterations, match a
    10-iteration JAX run."""
    edges = graph if mode == "standard" else _random_edges(600, 900, 3)
    el = jgops.prepare_edges(edges)
    de = jpagerank.prepare_device_edges(el, mesh8, build_plan=False)
    args = (de.src, de.dst, de.w_e, de.emask, de.has_out, de.n_ref)

    def jax_run(n):
        fn = jpagerank.make_run_fn(mesh8, jpagerank.PageRankConfig(
            n_iterations=n, mode=mode, scatter="auto"), el.n_vertices)
        return fn(*args)

    r4, h4 = jax_run(4)
    ranks0, has0 = convert.pagerank_state_from_jax(np.asarray(r4),
                                                   np.asarray(h4),
                                                   device="cpu")
    got = pagerank.run(edges, get_mesh(data=8, device="cpu"),
                       pagerank.PageRankConfig(n_iterations=6, mode=mode),
                       ranks0=ranks0, has_rank0=has0)
    r10, h10 = jax_run(10)
    np.testing.assert_allclose(got.ranks.numpy(), np.asarray(r10), **TOL)
    np.testing.assert_array_equal(got.has_rank.numpy(), np.asarray(h10))
    with pytest.raises(ValueError, match="only 0 and 1"):
        convert.pagerank_state_from_jax(np.ones(3), np.full(3, 0.5),
                                        device="cpu")


def test_config_checks_and_backends():
    mesh = get_mesh(device="cpu")
    with pytest.raises(ValueError, match="only applies to mode"):
        pagerank.make_run_fn(mesh, pagerank.PageRankConfig(scatter="xla"), 8)
    with pytest.raises(ValueError, match="unknown scatter"):
        pagerank.make_run_fn(mesh, pagerank.PageRankConfig(
            mode="standard", scatter="dense"), 8)
    with pytest.raises(ValueError, match="unknown mode"):
        pagerank.make_run_fn(mesh, pagerank.PageRankConfig(mode="x"), 8)
    for backend in ("resident", "streamed", "virtual"):
        assert pagerank.choose_data_backend(backend) == backend
    with pytest.raises(ValueError, match="unknown data backend"):
        pagerank.choose_data_backend("tiered")


def _cli_ranks(capsys, *args):
    assert cli.main(["--device", "cpu", "pagerank", *args]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    ranks = {int(line.split()[0]): float(line.split()[-1].rstrip("."))
             for line in lines if " has rank: " in line}
    return lines, ranks


def test_cli_pagerank_prints_the_golden(capsys, tmp_path):
    lines, ranks = _cli_ranks(capsys)
    assert lines[0].startswith("[pagerank] prep: ")
    assert list(ranks) == [2, 0, 1]  # highest rank first
    np.testing.assert_allclose([ranks[v] for v in range(3)], GOLDEN,
                               atol=1e-5)
    assert lines[-1].startswith("[pagerank] 10 iterations in ")
    assert lines[-1].endswith(" iter/s)")
    path = tmp_path / "toy.txt"
    path.write_text("# the toy graph\n0 1\n0 2\n1 2\n2 0\n")
    _, from_file = _cli_ranks(capsys, "--edge-file", str(path),
                              "--checkpoint-dir", str(tmp_path / "ck"),
                              "--checkpoint-every", "4")
    assert from_file == ranks
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 10


def test_cli_pagerank_standard_and_refusals(capsys):
    lines, ranks = _cli_ranks(capsys, "--n-vertices", "4096", "--mode",
                              "standard", "--n-slices", "2")
    assert len(ranks) == 10
    want = _port(datasets.erdos_renyi_edges(4096), 2, 4096, mode="standard")
    top = np.argsort(-want.ranks.numpy())[:10]
    assert list(ranks) == top.tolist()
    for flag, msg in ((["--max-restarts", "1", "--fault-plan",
                        "seed=1;cluster:wal@0=oserror"], "cluster runtime"),
                      (["--data-backend", "streamed", "--mode", "reference"],
                       "reference-parity mode is resident-only")):
        with pytest.raises(SystemExit, match=msg):
            cli.main(["--device", "cpu", "pagerank", *flag])


def test_cli_pagerank_max_restarts_recovers_a_killed_write(capsys, tmp_path):
    """``--max-restarts 1`` wraps the run in ``run_with_restarts``: a
    killed checkpoint write restarts once from the step before and
    prints the undisturbed run's ranks."""
    _, want = _cli_ranks(capsys)
    try:
        lines, ranks = _cli_ranks(
            capsys, "--checkpoint-dir", str(tmp_path), "--checkpoint-every",
            "4", "--max-restarts", "1", "--fault-plan",
            "seed=1;ckpt:write@1=kill")
    finally:
        faults.configure(False)
    assert any(ln.startswith("[restart 1/1] InjectedKill") for ln in lines)
    assert ranks == want
    assert checkpoint.latest_step(str(tmp_path)) == 10
