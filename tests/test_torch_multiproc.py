"""The port's data axis across processes (``torch.distributed`` over
gloo, on the CPU) against one process, and against the JAX package.

A spawned pair of processes, each holding 2 of 4 emulated data shards,
runs every workload that crosses processes: Monte-Carlo π, full-batch
LR, SSGD on ``bernoulli``, ``fixed``, ``fused_gather``, ``fused`` and
the tp split on a 2×2 mesh, MA/BMUF/EASGD on ``bernoulli``,
``fused_gather`` and ``fused_train``, k-means (torch ops and the fused
fit) and PageRank in modes ``auto``, ``pallas`` and ``xla``. Rank 0
also runs each on one process × 4 emulated shards at the same thread
count. The psum sends every shard's partials and adds them in global
shard order, so the two must be equal BIT FOR BIT, and the replicated
results equal on both ranks. Each also matches the JAX package's
in-process run on a 4-device data mesh within ROADMAP C's standards.

The worker is this file run as a script (``worker`` mode) with the repo
on ``PYTHONPATH``; it imports neither jax nor ``tpu_distalg``. One pair
runs every workload, to spend one start-up; library pairs meet through
a ``file://`` rendezvous in ``tmp_path``, and only the CLI test takes a
free TCP port. Each child takes its share of this worker's threads.

Shapes: breast cancer (398 training rows) over 4 shards is the smallest
set on which every sampler draws something in every shard at the
configured fractions; 30 SSGD steps is before the float32 runs part
from JAX (ROADMAP C), 5 rounds the local-update family's standard; a
2,000-point mixture and a 300-vertex, 2,000-edge graph give each shard
a non-trivial slice.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240
FUSED = dict(fused_pack=4, gather_block_rows=32, shuffle_seed=0)
SSGD_STEPS, ROUNDS = 30, 5
KM = dict(n=2000, k=4, dim=4, iters=6)
PR_V, PR_E, PR_ITERS = 300, 2000, 10

#: (name, SSGD config fields, mesh shape) of the SSGD runs
SSGD_RUNS = (
    ("ssgd_bernoulli", dict(), (4, 1)),
    ("ssgd_fixed", dict(sampler="fixed"), (4, 1)),
    ("ssgd_fused_gather", dict(sampler="fused_gather", **FUSED), (4, 1)),
    ("ssgd_fused", dict(sampler="fused", fused_block_rows=64, **FUSED),
     (4, 1)),
    ("ssgd_tp_2x2", dict(sampler="fused_gather", feature_sharded=True,
                         **FUSED), (2, 2)),
)
LOCAL_RUNS = tuple(
    (f"{fam}_{smp}", fam, smp) for fam in ("ma", "bmuf", "easgd")
    for smp in ("bernoulli", "fused_gather", "fused_train"))
PR_RUNS = (("pagerank_auto", "standard", "auto"),
           ("pagerank_pallas", "standard", "pallas"),
           ("pagerank_xla", "standard", "xla"),
           ("pagerank_reference", "reference", "auto"))
#: results each process holds only its rows of (k-means assignments,
#: the replicas' models, which the ``local_sgd`` table cuts over data);
#: every process holds the rest in full
ROW_SHARDED = ({("kmeans", "assignments"), ("kmeans_fused", "assignments")}
               | {(name, "ws") for name, _, _ in LOCAL_RUNS})


# ------------------------------------------------------------- worker


def _edges() -> np.ndarray:
    rng = np.random.default_rng(5)
    return rng.integers(0, PR_V, size=(PR_E, 2)).astype(np.int64)


def _workloads(mesh, mesh_2x2) -> dict:
    """Every workload on ``mesh`` (4 data shards) → {name: {key:
    array}}, host copies."""
    from tpu_distalg_torch.models import (
        bmuf,
        easgd,
        kmeans,
        logistic_regression,
        ma,
        monte_carlo,
        pagerank,
        ssgd,
    )
    from tpu_distalg_torch.parallel import parallelize, partition
    from tpu_distalg_torch.utils import datasets

    def host(t):
        return t.detach().cpu().numpy().copy()

    data = datasets.breast_cancer_split()
    out = {}
    hits, n_used = monte_carlo.per_chunk_hits(
        mesh, monte_carlo.MonteCarloConfig(n=400_000))
    pi, _ = monte_carlo.estimate_pi(mesh,
                                    monte_carlo.MonteCarloConfig(n=400_000))
    out["mc"] = {"hits": host(hits), "n_used": np.int64(n_used),
                 "pi": np.float64(pi)}
    r = logistic_regression.train(
        *data, mesh, logistic_regression.LRConfig(n_iterations=SSGD_STEPS))
    out["lr"] = {"w": host(r.w), "accs": host(r.accs)}
    for name, fields, shape in SSGD_RUNS:
        m = mesh_2x2 if shape == (2, 2) else mesh
        r = ssgd.train(*data, m, ssgd.SSGDConfig(n_iterations=SSGD_STEPS,
                                                 **fields))
        out[name] = {"w": host(r.w), "accs": host(r.accs)}
    families = {"ma": (ma, "MAConfig"), "bmuf": (bmuf, "BMUFConfig"),
                "easgd": (easgd, "EASGDConfig")}
    for name, fam, smp in LOCAL_RUNS:
        mod, cls = families[fam]
        cfg = getattr(mod, cls)(n_iterations=ROUNDS, sampler=smp, **FUSED)
        r = mod.train(*data, mesh, cfg)
        out[name] = {"w": host(r.w), "ws": host(r.ws), "accs": host(r.accs)}
    pts = datasets.gaussian_mixture(KM["n"], k=KM["k"], dim=KM["dim"])
    cfg = kmeans.KMeansConfig(k=KM["k"], n_iterations=KM["iters"])
    r = kmeans.fit(pts, mesh, cfg)
    out["kmeans"] = {"centers": host(r.centers),
                     "assignments": host(r.assignments)}
    ps = parallelize(pts, mesh, table="kmeans", leaf="points")
    out["kmeans"]["points_gathered"] = partition.gather(
        {"points": ps.data}, "kmeans", mesh)["points"]
    X2, m2 = kmeans.pack_device(mesh, ps.data, ps.mask, dim=KM["dim"],
                                k=KM["k"])
    c, a, _ = kmeans.make_fit_fn_fused(mesh, cfg, KM["dim"])(
        X2, m2, kmeans.init_centers(pts, KM["k"], cfg.seed))
    out["kmeans_fused"] = {"centers": host(c), "assignments": host(a)}
    for name, mode, scatter in PR_RUNS:
        r = pagerank.run(_edges(), mesh, pagerank.PageRankConfig(
            n_iterations=PR_ITERS, mode=mode, scatter=scatter), PR_V)
        out[name] = {"ranks": host(r.ranks), "has_rank": host(r.has_rank)}
    return out


def _refusals(mesh) -> dict:
    """What a process group refuses, as 1 when it raised naming its
    reason, and the ring, which no longer refuses: 1 when it ran on this
    process's rows."""
    from tpu_distalg_torch.parallel import get_mesh, ring_attention

    got = {}
    try:
        get_mesh(3, device="cpu")
    except ValueError as e:
        got["uneven"] = int("do not split evenly" in str(e))
    q = torch.zeros((8, 1, 4))
    got["ring"] = int(ring_attention(q, q, q, mesh).shape == q.shape)
    return {"refusals": {k: np.int64(v) for k, v in got.items()}}


def _worker(rank: int, world: int, init: str, outdir: str, procs: int,
            plan: str) -> None:
    from tpu_distalg_torch.parallel import Mesh, get_mesh
    from tpu_distalg_torch.parallel import mesh as pmesh

    share_host_threads(procs)
    pmesh.emulate_devices(2)
    pmesh.multihost_initialize(init, world, rank, device="cpu", timeout=60)
    try:
        if plan == "raise" and rank == 1:
            raise RuntimeError("rank 1 fails on purpose")
        mesh = get_mesh(device="cpu")          # 2 shards a process
        assert (mesh.n_data, mesh.n_local, mesh.distributed) == (4, 2, True)
        multi = _workloads(mesh, get_mesh(2, 2, device="cpu"))
        multi.update(_refusals(mesh))
        flat = {f"multi/{n}/{k}": v for n, d in multi.items()
                for k, v in d.items()}
        if rank == 0:
            one = Mesh(n_data=4, device=torch.device("cpu"))
            single = _workloads(one, Mesh(n_data=2, device=one.device,
                                          n_model=2))
            flat.update({f"single/{n}/{k}": v for n, d in single.items()
                         for k, v in d.items()})
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **flat)
    finally:
        pmesh.shutdown()


# -------------------------------------------------------------- parent


def _threads_share() -> int:
    """Processes among which the host's cores are shared: this test
    worker's share, halved for the pair."""
    return 2 * int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)


def _spawn_pair(cmd_for_rank, timeout=SPAWN_TIMEOUT_S):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(cmd_for_rank(r), cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def _worker_cmd(tmp_path, plan):
    init = f"file://{tmp_path / 'rendezvous'}"
    return lambda r: [sys.executable, os.path.abspath(__file__), "worker",
                      str(r), "2", init, str(tmp_path),
                      str(_threads_share()), plan]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pair's results: ``(rank0, rank1)`` dicts of name → key →
    array, rank 0's with the one-process results under ``single``."""
    tmp = tmp_path_factory.mktemp("multiproc")
    rcs, outs = _spawn_pair(_worker_cmd(tmp, "main"))
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
    loaded = []
    for r in (0, 1):
        with np.load(tmp / f"rank{r}.npz") as z:
            loaded.append({k: z[k] for k in z.files})
    return loaded


NAMES = (["mc", "lr"] + [n for n, _, _ in SSGD_RUNS]
         + [n for n, _, _ in LOCAL_RUNS] + ["kmeans", "kmeans_fused"]
         + [n for n, _, _ in PR_RUNS])


def _keys(run: dict, prefix: str, name: str) -> dict:
    p = f"{prefix}/{name}/"
    return {k[len(p):]: v for k, v in run.items() if k.startswith(p)}


@pytest.mark.parametrize("name", NAMES)
def test_two_processes_equal_one_bitwise(runs, name):
    """2 processes × 2 shards = 1 process × 4 shards, bit for bit; the
    replicated results are equal on both ranks, and the row-sharded
    ones (k-means assignments, the replicas' models) are each rank's own
    rows."""
    r0, r1 = runs
    single = _keys(r0, "single", name)
    m0, m1 = _keys(r0, "multi", name), _keys(r1, "multi", name)
    assert single and set(single) == set(m0) == set(m1)
    for key, want in single.items():
        if (name, key) in ROW_SHARDED:
            got = np.concatenate([m0[key], m1[key]])
        else:
            assert m0[key].tobytes() == m1[key].tobytes(), key
            got = m0[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), (name, key)


def test_data_parallel_runs_each_held_shard_with_its_global_id():
    """In one process every shard is held: the body sees shards 0..3 in
    order, through its argument and ``replica_index``."""
    from tpu_distalg_torch.parallel import get_mesh, spmd

    mesh = get_mesh(4, device="cpu")
    got = spmd.data_parallel(lambda s: (s, spmd.replica_index()), mesh)
    assert got == [(s, s) for s in range(4)]
    with pytest.raises(RuntimeError, match="outside"):
        spmd.replica_index()


@pytest.mark.parametrize("hosts,cards,backend,layout", [
    (["a", "b"], 1, "nccl", [(0, 1), (0, 1)]),
    (["a", "a"], 1, "gloo", [(0, 2), (1, 2)]),
    (["a", "a"], 2, "nccl", [(0, 2), (1, 2)]),
    (["a", "b", "a", "b"], 1, "gloo", [(0, 2), (0, 2), (1, 2), (1, 2)]),
], ids=["2-hosts-1-card", "1-host-shared-card", "1-host-2-cards",
        "2-hosts-2-ranks-1-card"])
def test_backend_follows_the_ranks_on_each_host(monkeypatch, hosts, cards,
                                                backend, layout):
    """The host names the ranks trade decide the local ranks and the
    backend: NCCL when no two ranks of a host share a card, so one rank
    a host on one-card hosts takes NCCL, not gloo. Two and four ranks
    over one and two hosts are the fewest that tell a shared host from
    a shared card; ``device_count`` is mocked, no group is made."""
    from tpu_distalg_torch.utils import device as udevice

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got = [udevice.host_layout(hosts, r) for r in range(len(hosts))]
    assert got == layout
    assert {udevice.choose_backend(torch.device("cuda"), lw)
            for _, lw in got} == {backend}
    assert [udevice.rank_card(lr) for lr, _ in got] == [
        lr % cards for lr, _ in layout]
    assert udevice.choose_backend(torch.device("cpu"), 1) == "gloo"


def test_host_names_are_traded_through_the_store(monkeypatch):
    """Rank 0 of two reads rank 1's host name from the rendezvous store
    (an in-memory store standing in for the file or TCP one, rank 1's
    entry written ahead) and writes its own there."""
    import torch.distributed as dist

    from tpu_distalg_torch.parallel import mesh as pmesh

    store = dist.HashStore()
    dist.PrefixStore("tda/hosts", store).set("1", "host-b")
    monkeypatch.setattr(pmesh.socket, "gethostname", lambda: "host-a")
    assert pmesh._host_names(store, 0, 2) == ["host-a", "host-b"]
    assert dist.PrefixStore("tda/hosts", store).get("0") == b"host-a"


def test_a_process_group_refuses_what_waits_for_a9(runs):
    """Inside the group: a data axis the processes do not divide refuses
    with its reason; the rings, which waited for ROADMAP A9, run on each
    process's rows (``tests/test_torch_multiproc_stream.py`` holds them
    to one process)."""
    for r in runs:
        ref = _keys(r, "multi", "refusals")
        assert {k: int(v) for k, v in ref.items()} == {"uneven": 1,
                                                       "ring": 1}


# ---------------------------------------------------------- against JAX


def _jax_mesh(data, model=1):
    import jax

    from tpu_distalg.parallel import get_mesh as jget_mesh

    return jget_mesh(data=data, model=model,
                     devices=jax.devices()[:data * model])


def _close_w(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def test_mc_matches_jax(runs):
    """Integer draws: exact."""
    from tpu_distalg.models import monte_carlo as jmc

    pi, n_used = jmc.estimate_pi(_jax_mesh(4),
                                 jmc.MonteCarloConfig(n=400_000))
    got = _keys(runs[0], "multi", "mc")
    assert float(got["pi"]) == pi and int(got["n_used"]) == n_used


def test_lr_matches_jax(runs):
    """1e-5 of max|w| (``tests/test_torch_lr.py``'s standard); the
    accuracies within one test row."""
    from tpu_distalg.models import logistic_regression as jlr
    from tpu_distalg.utils import datasets as jdatasets

    data = jdatasets.breast_cancer_split()
    want = jlr.train(*data, _jax_mesh(4),
                     jlr.LRConfig(n_iterations=SSGD_STEPS))
    got = _keys(runs[0], "multi", "lr")
    _close_w(got["w"], want.w, 1e-5)
    np.testing.assert_allclose(got["accs"], np.asarray(want.accs),
                               atol=1.01 / len(data[3]))


@pytest.mark.parametrize("name,fields,shape",
                         [r for r in SSGD_RUNS if r[0] != "ssgd_fused"],
                         ids=[r[0] for r in SSGD_RUNS
                              if r[0] != "ssgd_fused"])
def test_ssgd_matches_jax(runs, name, fields, shape):
    """1e-4 of max|w| at 30 steps, the accuracies equal. (``fused``
    has no JAX counterpart here: the TPU draws B5's mask on its core.)"""
    import warnings

    from tpu_distalg.models import ssgd as jssgd
    from tpu_distalg.utils import datasets as jdatasets

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # coarse-fraction geometry warn
        want = jssgd.train(*jdatasets.breast_cancer_split(),
                           _jax_mesh(*shape), jssgd.SSGDConfig(
                               n_iterations=SSGD_STEPS, **fields))
    got = _keys(runs[0], "multi", name)
    _close_w(got["w"], want.w, 1e-4)
    np.testing.assert_array_equal(got["accs"], np.asarray(want.accs))


@pytest.mark.parametrize("name,fam,smp", LOCAL_RUNS,
                         ids=[r[0] for r in LOCAL_RUNS])
def test_local_update_matches_jax(runs, name, fam, smp):
    """1e-5 of max|w| after 5 rounds (``fused_train`` through B2's plain
    version), center and replicas (each rank holds its own two)."""
    import importlib
    import warnings

    from tpu_distalg.utils import datasets as jdatasets

    mod = importlib.import_module(f"tpu_distalg.models.{fam}")
    cls = {"ma": "MAConfig", "bmuf": "BMUFConfig",
           "easgd": "EASGDConfig"}[fam]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = mod.train(*jdatasets.breast_cancer_split(), _jax_mesh(4),
                         getattr(mod, cls)(n_iterations=ROUNDS, sampler=smp,
                                           **FUSED))
    got = _keys(runs[0], "multi", name)
    _close_w(got["w"], want.w, 1e-5)
    _close_w(np.concatenate([_keys(r, "multi", name)["ws"] for r in runs]),
             want.ws, 1e-5)


@pytest.mark.parametrize("name", ["kmeans", "kmeans_fused"])
def test_kmeans_matches_jax(runs, name):
    """Centres within rtol 5e-6 + atol 1e-5 of JAX's fit (the fused fit
    assigns in float32, as JAX's torch-op-like fit does, on points this
    well separated)."""
    from tpu_distalg.models import kmeans as jkmeans
    from tpu_distalg.utils import datasets as jdatasets

    pts = jdatasets.gaussian_mixture(KM["n"], k=KM["k"], dim=KM["dim"])
    want = jkmeans.fit(pts, _jax_mesh(4), jkmeans.KMeansConfig(
        k=KM["k"], n_iterations=KM["iters"]))
    got = _keys(runs[0], "multi", name)
    np.testing.assert_allclose(got["centers"], np.asarray(want.centers),
                               rtol=5e-6, atol=1e-5)


@pytest.mark.parametrize("name,mode,scatter", PR_RUNS,
                         ids=[r[0] for r in PR_RUNS])
def test_pagerank_matches_jax(runs, name, mode, scatter):
    """rtol 1e-5, atol 1e-8 against JAX's XLA sweep of the same mode."""
    from tpu_distalg.models import pagerank as jpagerank

    want = jpagerank.run(_edges(), _jax_mesh(4), jpagerank.PageRankConfig(
        n_iterations=PR_ITERS, mode=mode,
        scatter="xla" if mode == "standard" else "auto"), PR_V)
    got = _keys(runs[0], "multi", name)
    np.testing.assert_allclose(got["ranks"], np.asarray(want.ranks),
                               rtol=1e-5, atol=1e-8)


# ------------------------------------------------------------- the CLI


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_mc_two_processes_print_jax_line():
    """``--emulate 4 --multihost`` over 2 processes: 8 shards, the same
    ``Pi is roughly`` line on both, equal to JAX's at 8 shards."""
    from tpu_distalg.models import monte_carlo as jmc

    coord = f"127.0.0.1:{_free_port()}"
    rcs, outs = _spawn_pair(lambda r: [
        sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
        "--emulate", "4", "--multihost", "--coordinator-address", coord,
        "--num-processes", "2", "--process-id", str(r), "mc", "--n",
        "400000"])
    lines = []
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
        lines += [ln for ln in out.splitlines()
                  if ln.startswith("Pi is roughly")]
    pi, _ = jmc.estimate_pi(_jax_mesh(8), jmc.MonteCarloConfig(n=400_000))
    assert lines == [f"Pi is roughly {pi:f}"] * 2


@pytest.mark.parametrize("argv", [
    ["als"], ["closure"], ["serve", "--artifact", "a"],
    ["kmeans", "--data-backend", "streamed", "--stream-cache", "c"],
    ["pagerank", "--data-backend", "virtual"],
    ["ssgd", "--stream-cache", "c"],
], ids=["als", "closure", "serve", "kmeans-streamed", "pagerank-virtual",
        "ssgd-stream"])
def test_cli_refuses_under_multihost_naming_a9(argv, monkeypatch):
    """What the CLI refused under ``--multihost`` naming ROADMAP A9
    before joining any group now goes on to join it (the join is
    stubbed here; ``tests/test_torch_multiproc_models.py`` and
    ``tests/test_torch_multiproc_stream.py`` run these commands on a
    pair)."""
    from tpu_distalg_torch import cli
    from tpu_distalg_torch.parallel import mesh as pmesh

    class Joined(Exception):
        pass

    def join(*a, **kw):
        raise Joined

    monkeypatch.setattr(pmesh, "multihost_initialize", join)
    with pytest.raises(Joined):
        cli.main(["--device", "cpu", "--multihost", "--coordinator-address",
                  "127.0.0.1:1", "--num-processes", "2", "--process-id",
                  "0", *argv])


def test_cli_needs_a_coordinator_for_the_rank_flags(capsys):
    """The JAX CLI's words (``tpu_distalg/cli.py:825-831``)."""
    from tpu_distalg_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--multihost", "--num-processes", "2",
                  "mc"])
    assert e.value.code == 2
    assert ("--num-processes/--process-id require --coordinator-address "
            "(omit all three to auto-detect)") in capsys.readouterr().err


def test_a_rank_that_raises_fails_both(tmp_path):
    """Rank 1 raises after joining; rank 0, waiting in its first
    collective, fails too, well inside the 60 s collective timeout."""
    import time

    t0 = time.monotonic()
    rcs, outs = _spawn_pair(_worker_cmd(tmp_path, "raise"), timeout=120)
    assert rcs[0] != 0 and rcs[1] != 0, outs
    assert "rank 1 fails on purpose" in outs[1]
    assert time.monotonic() - t0 < 100


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
            int(sys.argv[6]), sys.argv[7])
