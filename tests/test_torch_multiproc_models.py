"""Reshard, ALS, sharded serving and the transitive closure across
processes (``torch.distributed`` over gloo, on the CPU) against one
process, and against the JAX package.

A spawned pair of processes, each holding 2 of 4 emulated data shards
(one data shard × 2 model slices on the 2×2 meshes), runs:

  * ALS on 4×1 and 2×2 meshes, straight and in segments through a shared
    directory, and checkpoints handed from the pair to one process and
    back; a directory past ``n_iterations`` or of another shape raises
    on both ranks (ROADMAP C7);
  * the train→serve seam: the pair's U rows (cut unevenly at the true
    m) resharded ``als_train`` → ``als_serve`` and back, equal to
    ``host_gather_reshard`` bitwise, with the bytes each rank sent;
  * serving on the 2×2 mesh, sparse (the training result through the
    seam) and dense (the pair's artifact): process 0 leads, process 1
    follows; replies at every fill from 1 to max-batch and under a
    closed loop, equal on both ranks and to one process bit for bit;
    a follower that raises fails the leader too;
  * the dense closure, the sparse closure, ``run_sparse_auto`` regrowing
    through a shared checkpoint directory, and a dense run checkpointed
    by the pair and finished by one process.

Rank 0 also runs each on one process at the same thread count (torch's
CPU reductions change with it): every add keeps the one-process order,
so the two must be equal BIT FOR BIT. A group of 3 processes × 2 shards
runs the sparse closure against one process × 6.

The worker is this file run as a script with the repo on ``PYTHONPATH``;
it imports neither jax nor ``tpu_distalg``. Groups meet through a
``file://`` rendezvous in ``tmp_path``; the CLI test takes free TCP
ports. Shapes: m = 62 rows (4 shards pad them to 64, so the second
process keeps 30 rows of U and the seam gathers unevenly), n = 50, rank
4, 3 sweeps; graphs of 40 to 60 vertices.
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
ALS = dict(lam=0.01, m=62, n=50, k=4, n_iterations=3)
#: (name, mesh shape) of the ALS fits
ALS_MESHES = (("als_4x1", (4, 1)), ("als_2x2", (2, 2)))
MAX_BATCH, K_TOP, LOOP_REQUESTS = 4, 5, 24
#: the closure graphs' vertex counts; the DAG's sparse buffers hold
#: 1200 paths (its closure has 1136: a pair's slices take 600 and 536,
#: three processes' 400, 400 and 336) and 10,000 join candidates
DAG_V, ER_V, FOREST_V = 60, 40, 48
DAG_SPARSE = dict(capacity=1200, join_capacity=10_000)


def _host(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(
        t, torch.Tensor) else t).copy()


def _graphs():
    from tpu_distalg_torch.utils import datasets

    return {"er": datasets.erdos_renyi_edges(ER_V, 2.0),
            "forest": datasets.chain_forest_edges(FOREST_V),
            "dag": datasets.closure_dag_edges(DAG_V, 5, seed=1)}


# ------------------------------------------------------------- worker


def _als(mesh, tmp: str, tag: str) -> dict:
    """ALS straight and in segments (shared directory) on ``mesh``."""
    from tpu_distalg_torch.models import als

    out = {}
    for name, shape in ALS_MESHES:
        m = _reshape(mesh, shape)
        r = als.fit(m, als.ALSConfig(**ALS))
        seg = als.fit(m, als.ALSConfig(**ALS), checkpoint_dir=os.path.join(
            tmp, f"{tag}_{name}"), checkpoint_every=2)
        out[name] = {"U": _host(r.U), "V": _host(r.V),
                     "rmse": _host(r.rmse_history)}
        out[f"{name}_seg"] = {"U": _host(seg.U), "V": _host(seg.V),
                              "rmse": _host(seg.rmse_history)}
    return out


def _reshape(mesh, shape):
    """The mesh of ``shape`` in this process group (or one process)."""
    import dataclasses

    from tpu_distalg_torch.parallel import get_mesh

    if mesh.distributed:
        return get_mesh(shape[0], shape[1], device="cpu")
    return dataclasses.replace(mesh, n_data=shape[0], n_model=shape[1])


def _reshard(mesh) -> dict:
    """The seam: ALS's U (this process's rows, cut at the true m) and V
    resharded to ``als_serve`` and back, beside the host baseline, and
    the bytes the first reshard sent."""
    from tpu_distalg_torch.models import als
    from tpu_distalg_torch.parallel import collectives, partition

    r = als.fit(mesh, als.ALSConfig(**ALS))
    tree = {"U": r.U, "V": r.V}
    sent0 = collectives.COUNTERS["bytes_sent"]
    serve = partition.reshard(tree, "als_train", "als_serve", mesh)
    sent = collectives.COUNTERS["bytes_sent"] - sent0
    base = partition.host_gather_reshard(tree, "als_serve", mesh,
                                         src_tbl="als_train")
    back = partition.reshard(serve, "als_serve", "als_train", mesh)
    back_base = partition.host_gather_reshard(serve, "als_train", mesh,
                                              src_tbl="als_serve")
    return {"reshard": {
        "serve_U": _host(serve["U"]), "serve_V": _host(serve["V"]),
        "base_U": _host(base["U"]), "base_V": _host(base["V"]),
        "back_U": _host(back["U"]), "back_base_U": _host(back_base["U"]),
        "sent": np.int64(sent), "own_rows": np.int64(r.U.shape[0])}}


def _c7(mesh, tmp: str, rank: int) -> dict:
    """ROADMAP C7 in a process group: a directory holding a later step,
    and one holding another shape, raise on every rank."""
    import dataclasses

    import torch.distributed as dist

    from tpu_distalg_torch.models import als

    got = {}
    cfg = als.ALSConfig(**ALS)
    late = os.path.join(tmp, "c7_late")
    als.fit(mesh, cfg, checkpoint_dir=late, checkpoint_every=3)
    dist.barrier()
    try:
        als.fit(mesh, dataclasses.replace(cfg, n_iterations=2),
                checkpoint_dir=late)
        got["past"] = 0
    except ValueError as e:
        got["past"] = int("past n_iterations" in str(e))
    try:
        als.fit(mesh, dataclasses.replace(cfg, k=3, n_iterations=4),
                checkpoint_dir=late)
        got["shape"] = 0
    except ValueError as e:
        got["shape"] = int("incompatible" in str(e))
    return {"c7": {k: np.int64(v) for k, v in got.items()}}


def _handoff(mesh, one, tmp: str, rank: int) -> tuple[dict, dict]:
    """ALS and the dense closure written by the pair and finished by one
    process, and ALS written by one process and finished by the pair."""
    import dataclasses

    import torch.distributed as dist

    from tpu_distalg_torch.models import als
    from tpu_distalg_torch.models import transitive_closure as tc

    multi, single = {}, {}
    cfg = als.ALSConfig(**ALS)
    short = dataclasses.replace(cfg, n_iterations=2)
    d = os.path.join(tmp, "als_by_pair")
    als.fit(mesh, short, checkpoint_dir=d, checkpoint_every=2)
    dist.barrier()
    edges = _graphs()["er"]
    dc = os.path.join(tmp, "closure_by_pair")
    tc.run(edges, mesh, tc.ClosureConfig(max_iterations=2),
           checkpoint_dir=dc, checkpoint_every=1)
    dist.barrier()
    if rank == 0:
        r = als.fit(one, cfg, checkpoint_dir=d, checkpoint_every=2)
        single["als_pair_to_one"] = {"U": _host(r.U), "V": _host(r.V)}
        c = tc.run(edges, one, checkpoint_dir=dc, checkpoint_every=1)
        single["closure_pair_to_one"] = {
            "paths": _host(c.paths), "n": np.int64(c.n_paths),
            "rounds": np.int64(c.n_rounds)}
        d1 = os.path.join(tmp, "als_by_one")
        als.fit(one, short, checkpoint_dir=d1, checkpoint_every=2)
    dist.barrier()
    r = als.fit(mesh, cfg, checkpoint_dir=os.path.join(tmp, "als_by_one"),
                checkpoint_every=2)
    multi["als_one_to_pair"] = {"U": _host(r.U), "V": _host(r.V)}
    return multi, single


def _serving(mesh22, one22, tmp: str, rank: int, U_one=None) -> tuple:
    """Sparse serving from the training result (the reshard seam) and
    dense serving from the pair's artifact, led by process 0."""
    from tpu_distalg_torch import serve
    from tpu_distalg_torch.models import als

    d = os.path.join(tmp, "als_artifact")
    res = als.fit(mesh22, als.ALSConfig(**ALS), checkpoint_dir=d,
                  checkpoint_every=3)
    ids = np.random.default_rng(7).integers(0, ALS["m"], size=LOOP_REQUESTS)
    multi, single = {}, {}
    for merge in ("sparse", "dense"):
        cfg = serve.ServeConfig(max_batch=MAX_BATCH, max_delay_ms=1.0,
                                k_top=K_TOP, merge=merge)
        server = serve.Server(mesh22, cfg)
        if merge == "sparse":
            server.add_model(serve.als_model(res.U, res.V, mesh22,
                                             k_top=K_TOP, merge=merge))
        else:
            server.add_artifact(d, name="als")
        got = {}
        if server.leader:
            for f in range(1, MAX_BATCH + 1):
                reps = server.dispatch("als", list(ids[:f]))
                got[f"fill{f}_v"] = np.stack([v for v, _ in reps])
                got[f"fill{f}_i"] = np.stack([i for _, i in reps])
            out, info = serve.run_closed_loop(server, "als", list(ids),
                                              concurrency=3)
            assert info["ok"] == len(ids), info
            got["loop_v"] = np.stack([v for v, _ in out])
            got["loop_i"] = np.stack([i for _, i in out])
            server.close()
        else:
            seen = []
            server.follow(lambda name, packed, reps: seen.append(
                (packed[:len(reps)].copy(), reps)))
            for f in range(1, MAX_BATCH + 1):
                packed, reps = seen[f - 1]
                assert list(packed) == list(ids[:f])
                got[f"fill{f}_v"] = np.stack([v for v, _ in reps])
                got[f"fill{f}_i"] = np.stack([i for _, i in reps])
            by_id = {}
            for packed, reps in seen[MAX_BATCH:]:
                for uid, rep in zip(packed, reps):
                    by_id[int(uid)] = rep
            got["loop_v"] = np.stack([by_id[int(u)][0] for u in ids])
            got["loop_i"] = np.stack([by_id[int(u)][1] for u in ids])
            got["batches"] = np.int64(len(seen))
        multi[f"serve_{merge}"] = got
        if U_one is not None:
            model = serve.als_model(*U_one, one22, k_top=K_TOP, merge=merge)
            ref = {}
            for f in range(1, MAX_BATCH + 1):
                reps = model.predict_batch(list(ids[:f]), MAX_BATCH)
                ref[f"fill{f}_v"] = np.stack([v for v, _ in reps])
                ref[f"fill{f}_i"] = np.stack([i for _, i in reps])
            reps = [model.predict_one(u, MAX_BATCH) for u in ids]
            ref["loop_v"] = np.stack([v for v, _ in reps])
            ref["loop_i"] = np.stack([i for _, i in reps])
            single[f"serve_{merge}"] = ref
    return multi, single


def _closures(mesh, tmp: str, tag: str, six: bool = False) -> dict:
    """The dense and sparse closures (auto regrowing through a shared
    directory) on ``mesh`` → {name: {key: array}}."""
    from tpu_distalg_torch.models import transitive_closure as tc

    g = _graphs()
    out = {}
    if not six:
        r = tc.run(g["er"], mesh)
        out["closure_dense"] = {"paths": _host(r.paths),
                                "n": np.int64(r.n_paths),
                                "rounds": np.int64(r.n_rounds)}
        r = tc.run(g["er"], mesh, checkpoint_dir=os.path.join(
            tmp, f"{tag}_dense_seg"), checkpoint_every=2)
        out["closure_dense_seg"] = {"paths": _host(r.paths),
                                    "n": np.int64(r.n_paths),
                                    "rounds": np.int64(r.n_rounds)}
        r = tc.run_sparse_auto(g["forest"], mesh, start_capacity=16,
                               checkpoint_dir=os.path.join(
                                   tmp, f"{tag}_auto"), checkpoint_every=2)
        out["closure_auto"] = {"pairs": r.paths, "n": np.int64(r.n_paths),
                               "rounds": np.int64(r.n_rounds)}
    r = tc.run_sparse(g["dag"], mesh, tc.SparseClosureConfig(**DAG_SPARSE))
    out["closure_sparse"] = {"pairs": r.paths, "n": np.int64(r.n_paths),
                             "rounds": np.int64(r.n_rounds)}
    return out


def _serve_fail(mesh) -> None:
    """The follower raises on the first batch the leader sends; the
    leader's next batch then fails, and so does its process."""
    from tpu_distalg_torch import serve

    server = serve.Server(mesh, serve.ServeConfig(max_batch=2))
    server.add_model(serve.lr_model(np.ones(3, np.float32), device="cpu"))
    if not server.leader:
        def fail(name, packed, replies):
            raise RuntimeError("the follower fails on purpose")

        server.follow(fail)
    for _ in range(2):
        server.dispatch("lr", [np.zeros(3, np.float32)])
    server.close()


def _worker(rank: int, world: int, init: str, outdir: str, procs: int,
            mode: str) -> None:
    from tpu_distalg_torch.models import als
    from tpu_distalg_torch.parallel import Mesh, get_mesh
    from tpu_distalg_torch.parallel import mesh as pmesh

    share_host_threads(procs)
    pmesh.emulate_devices(2)
    pmesh.multihost_initialize(init, world, rank, device="cpu", timeout=120)
    try:
        mesh = get_mesh(device="cpu")          # 2 shards a process
        one = Mesh(n_data=mesh.n_data, device=torch.device("cpu"))
        flat = {}

        def add(prefix, results):
            flat.update({f"{prefix}/{n}/{k}": v for n, d in results.items()
                         for k, v in d.items()})

        if mode == "serve_fail":
            _serve_fail(get_mesh(2, device="cpu"))
        elif mode == "three":
            add("multi", _closures(mesh, outdir, "m", six=True))
            if rank == 0:
                add("single", _closures(one, outdir, "s", six=True))
        else:
            add("multi", _als(mesh, outdir, "pair"))
            add("multi", _reshard(mesh))
            add("multi", _c7(mesh, outdir, rank))
            multi, single = _handoff(mesh, one, outdir, rank)
            add("multi", multi)
            add("multi", _closures(mesh, outdir, "pair"))
            mesh22 = get_mesh(2, 2, device="cpu")
            one22 = Mesh(n_data=2, device=one.device, n_model=2)
            U_one = None
            if rank == 0:
                add("single", single)
                add("single", _als(one, outdir, "one"))
                add("single", _reshard(one))
                add("single", _closures(one, outdir, "one"))
                r = als.fit(one22, als.ALSConfig(**ALS))
                U_one = (r.U, r.V)
            multi, single = _serving(mesh22, one22, outdir, rank, U_one)
            add("multi", multi)
            add("single", single)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **flat)
    finally:
        pmesh.shutdown()


# -------------------------------------------------------------- parent


def _threads_share(world: int) -> int:
    return world * int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)


def _spawn(cmd_for_rank, world: int, timeout=SPAWN_TIMEOUT_S):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(cmd_for_rank(r), cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
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


def _group(tmp, world: int, mode: str) -> list[dict]:
    init = f"file://{tmp / 'rendezvous'}"
    rcs, outs = _spawn(lambda r: [
        sys.executable, os.path.abspath(__file__), "worker", str(r),
        str(world), init, str(tmp), str(_threads_share(world)), mode],
        world)
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
    loaded = []
    for r in range(world):
        with np.load(tmp / f"rank{r}.npz") as z:
            loaded.append({k: z[k] for k in z.files})
    return loaded


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pair's results: ``(rank0, rank1)`` dicts of name/key →
    array, rank 0's with the one-process results under ``single``."""
    return _group(tmp_path_factory.mktemp("multiproc_models"), 2, "main")


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    return _group(tmp_path_factory.mktemp("multiproc_models3"), 3, "three")


def _keys(run: dict, prefix: str, name: str) -> dict:
    p = f"{prefix}/{name}/"
    return {k[len(p):]: v for k, v in run.items() if k.startswith(p)}


#: results each process holds only its rows of
ROW_SHARDED = ({(f"{n}{s}", "U") for n, _ in ALS_MESHES
                for s in ("", "_seg")}
               | {("closure_dense", "paths"), ("closure_dense_seg", "paths"),
                  ("closure_auto", "pairs"), ("closure_sparse", "pairs"),
                  ("reshard", "back_U"), ("reshard", "back_base_U")})
NAMES = ([n + s for n, _ in ALS_MESHES for s in ("", "_seg")]
         + ["closure_dense", "closure_dense_seg", "closure_auto",
            "closure_sparse"])


def _assert_equal_one_process(runs, name, single_name=None):
    single = _keys(runs[0], "single", single_name or name)
    parts = [_keys(r, "multi", name) for r in runs]
    assert single and all(set(single) == set(p) for p in parts)
    for key, want in single.items():
        if (name, key) in ROW_SHARDED:
            got = np.concatenate([p[key] for p in parts])
        else:
            for p in parts[1:]:
                assert p[key].tobytes() == parts[0][key].tobytes(), key
            got = parts[0][key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), (name, key)


@pytest.mark.parametrize("name", NAMES)
def test_two_processes_equal_one_bitwise(runs, name):
    """2 processes × 2 shards (or 1 × 2 model slices on 2×2) = 1 process
    × the same mesh, bit for bit: ALS straight and segmented through the
    shared directory, the dense and sparse closures, and the auto
    closure regrowing through its checkpoints; U's rows and the
    closures' rows and pairs are each rank's own, the rest equal on both
    ranks."""
    _assert_equal_one_process(runs, name)


def test_segmented_als_equals_straight(runs):
    for r in runs:
        for name, _ in ALS_MESHES:
            a, b = _keys(r, "multi", name), _keys(r, "multi", f"{name}_seg")
            for key in a:
                assert a[key].tobytes() == b[key].tobytes(), (name, key)


@pytest.mark.parametrize("key", ["serve_U", "serve_V", "back_U"])
def test_reshard_equals_host_gather_on_every_rank(runs, key):
    """``reshard`` = ``host_gather_reshard`` bitwise on both ranks, both
    ways across the seam; the serving layout's U is the one process's
    whole U on both ranks."""
    base = {"serve_U": "base_U", "serve_V": "base_V",
            "back_U": "back_base_U"}[key]
    parts = [_keys(r, "multi", "reshard") for r in runs]
    for got in parts:
        assert got[key].tobytes() == got[base].tobytes()
    want = _keys(runs[0], "single", "reshard")[key]
    got = (np.concatenate([p[key] for p in parts])
           if ("reshard", key) in ROW_SHARDED else parts[1][key])
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_reshard_counts_the_bytes_a_rank_sent(runs):
    """The seam's bytes a rank sends at 2 processes: the row counts of
    the cut leaves (8 B), the gather's own counts (8 B) and U's rows
    padded to the larger block (32 rows × rank 4 × 4 B); the second
    rank holds the 30 rows below m = 62."""
    for r in runs:
        got = _keys(r, "multi", "reshard")
        assert int(got["sent"]) == 8 + 8 + 32 * ALS["k"] * 4
    assert [int(_keys(r, "multi", "reshard")["own_rows"]) for r in runs] \
        == [32, 30]


def test_c7_refusals_raise_on_every_rank(runs):
    for r in runs:
        assert {k: int(v) for k, v in _keys(r, "multi", "c7").items()} == {
            "past": 1, "shape": 1}


def test_checkpoints_cross_between_two_processes_and_one(runs):
    """ALS and the dense closure written by the pair and finished by one
    process, ALS written by one process and finished by the pair: each
    equals one process's straight run bitwise."""
    r0, r1 = runs
    als_want = _keys(r0, "single", "als_4x1")
    got = _keys(r0, "single", "als_pair_to_one")
    for key in ("U", "V"):
        assert got[key].tobytes() == als_want[key].tobytes(), key
    pair = [_keys(r, "multi", "als_one_to_pair") for r in runs]
    assert np.concatenate([p["U"] for p in pair]).tobytes() == \
        als_want["U"].tobytes()
    assert all(p["V"].tobytes() == als_want["V"].tobytes() for p in pair)
    c_want = _keys(r0, "single", "closure_dense")
    c_got = _keys(r0, "single", "closure_pair_to_one")
    for key in c_want:
        assert c_got[key].tobytes() == c_want[key].tobytes(), key


@pytest.mark.parametrize("merge", ["sparse", "dense"])
@pytest.mark.parametrize("part", ["fill", "loop"])
def test_served_replies_equal_on_both_ranks_and_one_process(runs, merge,
                                                            part):
    """Every fill from 1 to max-batch and a closed loop over 3 workers:
    the follower's replies, computed from the batches the leader sent,
    equal the leader's and one process's bit for bit."""
    name = f"serve_{merge}"
    want = _keys(runs[0], "single", name)
    keys = [k for k in want if k.startswith(part)]
    assert keys
    for r in runs:
        got = _keys(r, "multi", name)
        for key in keys:
            assert got[key].tobytes() == want[key].tobytes(), (name, key)
    assert int(_keys(runs[1], "multi", name)["batches"]) >= MAX_BATCH + \
        LOOP_REQUESTS // MAX_BATCH


def test_a_failing_follower_fails_the_leader(tmp_path):
    """A follower that raises leaves the group; the leader's next
    broadcast fails and its process exits non-zero too, well inside the
    collective timeout."""
    import time

    t0 = time.monotonic()
    init = f"file://{tmp_path / 'rendezvous'}"
    rcs, outs = _spawn(lambda r: [
        sys.executable, os.path.abspath(__file__), "worker", str(r), "2",
        init, str(tmp_path), str(_threads_share(2)), "serve_fail"], 2,
        timeout=120)
    assert rcs[0] != 0 and rcs[1] != 0, outs
    assert "the follower fails on purpose" in outs[1]
    assert time.monotonic() - t0 < 100


def test_three_processes_sparse_closure_equals_one(three):
    """3 processes × 2 shards = one process × 6: the pairs (each rank's
    slice of the buffer, in order), the count and the rounds; every
    rank holds some of the 1136 pairs."""
    _assert_equal_one_process(three, "closure_sparse")
    assert [len(_keys(r, "multi", "closure_sparse")["pairs"])
            for r in three] == [400, 400, 336]


# ---------------------------------------------------------- against JAX


def _jax_mesh(data, model=1):
    import jax

    from tpu_distalg.parallel import get_mesh as jget_mesh

    return jget_mesh(data=data, model=model,
                     devices=jax.devices()[:data * model])


@pytest.mark.parametrize("name,shape", ALS_MESHES,
                         ids=[n for n, _ in ALS_MESHES])
def test_als_across_processes_matches_jax(runs, name, shape):
    """ROADMAP C's standard at lam 0.01: the rmse history within 4e-6,
    U (both ranks' rows) and V within 3e-5 of their largest entry."""
    from tpu_distalg.models import als as jals

    j = jals.fit(_jax_mesh(*shape), jals.ALSConfig(**ALS))
    parts = [_keys(r, "multi", name) for r in runs]
    np.testing.assert_allclose(parts[0]["rmse"], np.asarray(j.rmse_history),
                               rtol=0, atol=4e-6)
    for mine, ref in ((np.concatenate([p["U"] for p in parts]), j.U),
                      (parts[0]["V"], j.V)):
        ref = np.asarray(ref)
        assert mine.shape == ref.shape
        np.testing.assert_allclose(mine, ref, rtol=0,
                                   atol=3e-5 * np.abs(ref).max())


def test_sparse_closure_slices_split_over_the_pair(runs):
    assert [len(_keys(r, "multi", "closure_sparse")["pairs"])
            for r in runs] == [600, 536]


def test_closures_across_processes_match_jax(runs):
    """The pairs, counts and rounds exactly (the dense matrix too)."""
    from tpu_distalg.models import transitive_closure as jtc

    g = _graphs()
    jm = _jax_mesh(4)
    ref = jtc.run(g["er"], jm)
    got = [_keys(r, "multi", "closure_dense") for r in runs]
    np.testing.assert_array_equal(np.concatenate([p["paths"] for p in got]),
                                  np.asarray(ref.paths))
    assert (int(got[0]["n"]), int(got[0]["rounds"])) == (ref.n_paths,
                                                         ref.n_rounds)
    for name, want in (
            ("closure_sparse", jtc.run_sparse(
                g["dag"], jm, jtc.SparseClosureConfig(**DAG_SPARSE))),
            ("closure_auto", jtc.run_sparse_auto(g["forest"], jm,
                                                 start_capacity=16))):
        got = [_keys(r, "multi", name) for r in runs]
        np.testing.assert_array_equal(
            np.concatenate([p["pairs"] for p in got]), np.asarray(want.paths))
        assert (int(got[0]["n"]), int(got[0]["rounds"])) == (
            want.n_paths, want.n_rounds)


# ------------------------------------------------------------- the CLI


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(*argv):
    coord = f"127.0.0.1:{_free_port()}"
    return _spawn(lambda r: [
        sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
        "--emulate", "2", "--multihost", "--coordinator-address", coord,
        "--num-processes", "2", "--process-id", str(r), *argv], 2)


def _one(*argv):
    (rc,), (out,) = _spawn(lambda r: [
        sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
        "--emulate", "4", *argv], 1)
    assert rc == 0, out[-4000:]
    return out


def _lines(out: str, *starts) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith(starts)]


def test_cli_als_then_serve_under_multihost(tmp_path):
    """``als --checkpoint-dir D`` on the pair prints one process's rmse
    lines on both ranks; ``serve --artifact D`` on the pair serves every
    request (the leader's lines), the follower running its batches."""
    d = str(tmp_path / "als")
    als_argv = ["als", "--m", "62", "--n", "50", "--k", "4",
                "--n-iterations", "3", "--mesh-shape", "4x2",
                "--checkpoint-dir", d]
    rcs, outs = _pair(*als_argv)
    want = _lines(_one(*als_argv[:-1], str(tmp_path / "one")),
                  "iterations:")
    assert len(want) == 3
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
        assert _lines(out, "iterations:") == want
        assert f"artifact_path: {d}" in out
    rcs, outs = _pair("serve", "--artifact", d, "--requests", "32",
                      "--model-slices", "2", "--max-batch", "4")
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
    assert "[serve] als: 32/32 replies" in outs[0], outs[0][-4000:]
    assert "[serve] follower 1: ran" in outs[1], outs[1][-4000:]


@pytest.mark.parametrize("argv", [
    ["closure", "--n-vertices", "48", "--sparse"],
    ["closure", "--n-vertices", "40"],
], ids=["sparse", "dense"])
def test_cli_closure_under_multihost(argv):
    rcs, outs = _pair(*argv)
    want = _lines(_one(*argv), "The original graph has")
    assert len(want) == 1
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
        assert _lines(out, "The original graph has") == want


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
            int(sys.argv[6]), sys.argv[7])
