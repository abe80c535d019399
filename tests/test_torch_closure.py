"""The transitive closure in the port
(``tpu_distalg_torch/models/transitive_closure.py``, ``ops/graph.py``,
``utils/datasets.py``) against the JAX package, the ``closure`` CLI,
and the checkpoint ``prune`` its auto-sizer depends on.

Every output is an integer or a boolean, so the port must equal JAX
exactly: the dense (V_pad, V_pad) matrices, the sparse pair arrays in
their order, ``n_paths``, ``n_rounds``, the overflow error at the same
capacity, and the auto-sizer's regrow sequence (its
``closure_capacity_grow`` events). Segmented runs equal straight ones,
and a run stopped by ``max_iterations`` resumes from its checkpoints
(as ``tests/test_checkpoint_resume.py:403-450`` and
``tests/test_partition.py:459-520`` hold the JAX package).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import bench
from tpu_distalg.models import transitive_closure as jtc
from tpu_distalg.telemetry import events as jevents
from tpu_distalg.utils import datasets as jdatasets
from tpu_distalg_torch import cli, faults
from tpu_distalg_torch.models import transitive_closure as tc
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.telemetry import events as tevents
from tpu_distalg_torch.utils import checkpoint as ckpt
from tpu_distalg_torch.utils import datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

GRAPHS = {
    "toy": (lambda: datasets.toy_graph_edges(), 8, 9),
    "chain4": (lambda: np.array([[0, 1], [1, 2], [2, 3]]), 8, 6),
    "cycle2": (lambda: np.array([[0, 1], [1, 0]]), 8, 4),
    "forest48": (lambda: datasets.chain_forest_edges(48), 4, 168),
    "er200": (lambda: datasets.erdos_renyi_edges(200, 2.0), 8, None),
}
SPARSE = {
    **GRAPHS,
    "dag120": (lambda: datasets.closure_dag_edges(120, 5, seed=1), 8, 4285),
    "hub": (lambda: np.stack([np.zeros(300, np.int64),
                              np.arange(1, 301)], axis=1), 8, 300),
}


@pytest.fixture(scope="module")
def jmeshes():
    from tpu_distalg.parallel import get_mesh as jget_mesh

    return {n: jget_mesh(data=n) for n in (1, 2, 4, 8)}


def test_dataset_helpers_equal_jax_and_bench():
    np.testing.assert_array_equal(datasets.chain_forest_edges(50, 7),
                                  jdatasets.chain_forest_edges(50, 7))
    np.testing.assert_array_equal(datasets.chain_forest_edges(1),
                                  jdatasets.chain_forest_edges(1))
    e = datasets.closure_dag_edges(300, 6, seed=2)
    np.testing.assert_array_equal(e, bench.closure_dag_edges(300, 6, seed=2))
    assert datasets.closure_host_count(300, e) == \
        bench.closure_host_count(300, e)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_dense_closure_equals_jax(graph, jmeshes):
    make, shards, want = GRAPHS[graph]
    edges = make()
    got = tc.run(edges, get_mesh(shards, device="cpu"))
    ref = jtc.run(edges, jmeshes[shards])
    np.testing.assert_array_equal(got.paths.numpy(), np.asarray(ref.paths))
    assert (got.n_paths, got.n_rounds) == (ref.n_paths, ref.n_rounds)
    if want is not None:
        assert got.n_paths == want
    if graph == "chain4":
        assert got.n_rounds <= 3


@pytest.mark.parametrize("graph", sorted(SPARSE))
def test_sparse_closure_equals_jax(graph, jmeshes):
    """Pair arrays in order, counts and rounds. The ER graph's and the
    DAG's closures overflow the default capacity, so they run at
    capacity V², as the JAX package's own sparse-vs-dense test does."""
    make, shards, want = SPARSE[graph]
    edges = make()
    cap = {"er200": 200 * 200, "dag120": 120 * 120}.get(graph)
    cfg = tc.SparseClosureConfig(capacity=cap)
    jcfg = jtc.SparseClosureConfig(capacity=cap)
    got = tc.run_sparse(edges, get_mesh(shards, device="cpu"), cfg)
    ref = jtc.run_sparse(edges, jmeshes[shards], jcfg)
    np.testing.assert_array_equal(got.paths, np.asarray(ref.paths))
    assert (got.n_paths, got.n_rounds) == (ref.n_paths, ref.n_rounds)
    if want is not None:
        assert got.n_paths == want
    dense = tc.run(edges, get_mesh(1, device="cpu"))
    V = int(edges.max()) + 1
    assert set(map(tuple, got.paths.tolist())) == \
        set(zip(*np.nonzero(dense.paths.numpy()[:V, :V])))


def test_sparse_exact_capacity_fit_and_overflow_equal_jax(jmeshes):
    """A closure that fills the buffer exactly is complete; one that
    does not fit raises JAX's error at the same capacity."""
    edges = datasets.chain_forest_edges(16, 16)     # closure C(16,2) = 120
    got = tc.run_sparse(edges, get_mesh(8, device="cpu"),
                        tc.SparseClosureConfig(capacity=120))
    assert got.n_paths == 120
    chain = np.stack([np.arange(63), np.arange(1, 64)], axis=1)
    for C, J in ((128, None), (2048, 300), (600, None)):
        msgs = []
        for run, cfg, mesh in (
                (tc.run_sparse, tc.SparseClosureConfig(capacity=C,
                                                       join_capacity=J),
                 get_mesh(8, device="cpu")),
                (jtc.run_sparse, jtc.SparseClosureConfig(capacity=C,
                                                         join_capacity=J),
                 jmeshes[8])):
            with pytest.raises(ValueError, match="capacity") as ei:
                run(chain, mesh, cfg)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def _grows(directory: str) -> list:
    out = []
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            out += [(e["capacity"], e["next_capacity"])
                    for e in map(json.loads, f)
                    if e["ev"] == "closure_capacity_grow"]
    return out


@pytest.mark.parametrize("graph", ["dag120", "er200", "forest48"])
def test_auto_regrow_sequence_equals_jax(graph, jmeshes, tmp_path):
    make, _, _ = SPARSE[graph]
    edges = make()
    seqs, results = [], []
    for ev, run, mesh in ((tevents, tc.run_sparse_auto,
                           get_mesh(4, device="cpu")),
                          (jevents, jtc.run_sparse_auto, jmeshes[4])):
        d = str(tmp_path / ev.__name__.split(".")[0])
        ev.configure(d)
        try:
            res = run(edges, mesh, start_capacity=16)
        finally:
            ev.configure(False)
        seqs.append(_grows(d))
        results.append(res)
    assert seqs[0] == seqs[1] and seqs[0]
    np.testing.assert_array_equal(results[0].paths,
                                  np.asarray(results[1].paths))
    assert results[0].n_rounds == results[1].n_rounds


def test_auto_refuses_past_the_budget_as_jax(jmeshes):
    edges = datasets.closure_dag_edges(200, 5, seed=0)
    msgs = []
    for run, mesh in ((tc.run_sparse_auto, get_mesh(4, device="cpu")),
                      (jtc.run_sparse_auto, jmeshes[4])):
        with pytest.raises(ValueError) as ei:
            run(edges, mesh, n_vertices=200, budget_bytes=1 << 14)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "refused" in msgs[0]


def test_dense_segmented_and_resume(tmp_path):
    mesh = get_mesh(4, device="cpu")
    edges = datasets.chain_forest_edges(48)
    straight = tc.run(edges, mesh)
    seg = tc.run(edges, mesh, checkpoint_dir=str(tmp_path / "a"),
                 checkpoint_every=2)
    assert torch.equal(seg.paths, straight.paths)
    assert (seg.n_paths, seg.n_rounds) == (straight.n_paths,
                                           straight.n_rounds)
    d = str(tmp_path / "b")
    tc.run(edges, mesh, tc.ClosureConfig(max_iterations=3),
           checkpoint_dir=d, checkpoint_every=2)
    resumed = tc.run(edges, mesh, checkpoint_dir=d, checkpoint_every=2)
    assert torch.equal(resumed.paths, straight.paths)
    assert resumed.n_rounds == straight.n_rounds


def test_sparse_segmented_and_resume(tmp_path):
    mesh = get_mesh(4, device="cpu")
    edges = datasets.chain_forest_edges(48)
    straight = tc.run_sparse(edges, mesh)
    seg = tc.run_sparse(edges, mesh, checkpoint_dir=str(tmp_path / "a"),
                        checkpoint_every=2)
    np.testing.assert_array_equal(seg.paths, straight.paths)
    assert seg.n_rounds == straight.n_rounds
    d = str(tmp_path / "b")
    tc.run_sparse(edges, mesh, tc.SparseClosureConfig(max_iterations=3),
                  checkpoint_dir=d, checkpoint_every=2)
    resumed = tc.run_sparse(edges, mesh, checkpoint_dir=d,
                            checkpoint_every=2)
    np.testing.assert_array_equal(resumed.paths, straight.paths)
    assert resumed.n_rounds == straight.n_rounds


def test_checkpoint_state_keeps_bool_and_int_leaves(tmp_path):
    """A closure checkpoint restores its bool paths and int64 counters
    unchanged (``guard_finite`` passes over non-float leaves)."""
    mesh = get_mesh(2, device="cpu")
    edges = datasets.chain_forest_edges(20, 5)
    d = str(tmp_path / "ck")
    tc.run(edges, mesh, tc.ClosureConfig(max_iterations=2),
           checkpoint_dir=d, checkpoint_every=1)
    payload, step = ckpt.restore(d)
    paths, old, cnt, it = payload["state"]
    assert payload["tag"] == "closure_dense" and step == 2
    assert paths.dtype == np.bool_ and paths.shape == (20, 20)
    assert old.dtype == cnt.dtype == it.dtype == np.int64
    assert int(it) == 2 and int(cnt) == int(paths.sum())


@pytest.mark.parametrize("start", [None, 16, 8])
def test_auto_completes_through_checkpoints(start, jmeshes, tmp_path):
    """An overflowed checkpointed attempt's files are pruned (ROADMAP C6)
    and the regrown run completes, as ``tests/test_partition.py:475``."""
    edges = datasets.closure_dag_edges(120, 5, seed=1)
    kw = {} if start is None else {"start_capacity": start}
    got = tc.run_sparse_auto(edges, get_mesh(4, device="cpu"), n_vertices=120,
                             checkpoint_dir=str(tmp_path / "ck"),
                             checkpoint_every=4, **kw)
    assert got.n_paths == bench.closure_host_count(120, edges)
    ref = jtc.run_sparse_auto(edges, jmeshes[4], n_vertices=120, **kw)
    np.testing.assert_array_equal(got.paths, np.asarray(ref.paths))


@pytest.mark.parametrize("keep,left", [(0, []), (1, [6]), (3, [2, 4, 6])])
def test_prune_keeps_the_newest(keep, left, tmp_path):
    """``keep=0`` deletes every checkpoint, as the JAX package's prune
    does (ROADMAP C6: ``steps[:-0]`` is the empty list)."""
    d = str(tmp_path / "ck")
    for step in (2, 4, 6):
        ckpt.save(d, "t", [np.zeros(3)], step, accs=np.zeros(1))
    ckpt.prune(d, keep=keep)
    assert sorted(int(f[5:-4]) for f in os.listdir(d)) == left


@pytest.mark.parametrize("argv", [
    ["closure", "--n-slices", "1"],
    ["closure", "--n-slices", "4", "--n-vertices", "200"],
    ["closure", "--n-slices", "2", "--n-vertices", "64", "--sparse"],
    ["closure", "--mesh-shape", "2x1", "--n-vertices", "40", "--sparse",
     "--capacity", "4096"],
])
def test_closure_cli_prints_the_jax_line(argv, capsys, tmp_path):
    from tpu_distalg import cli as jcli

    assert jcli.main(argv) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert cli.main(["--device", "cpu", *argv, "--checkpoint-dir",
                     str(tmp_path / "ck")]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and got.startswith("The original graph has")


def test_closure_cli_refuses_restarts_and_two_geometries(capsys, tmp_path):
    """``--max-restarts`` is accepted: a checkpointed run killed at its
    second segment restarts and prints the toy graph's 9 paths; two
    geometries are still refused."""
    assert cli.main(["--device", "cpu", "closure", "--max-restarts", "2",
                     "--checkpoint-dir", str(tmp_path / "ck"),
                     "--checkpoint-every", "1", "--fault-plan",
                     "seed=1;segment:run@1=kill"]) == 0
    faults.configure(False)
    out = capsys.readouterr().out
    assert "[restart 1/2] InjectedKill" in out
    assert out.strip().splitlines()[-1].startswith(
        "The original graph has 9 paths")
    with pytest.raises(SystemExit, match="--mesh-shape and --n-slices"):
        cli.main(["--device", "cpu", "closure", "--n-slices", "2",
                  "--mesh-shape", "2x1"])
