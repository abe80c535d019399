"""The port's serving slice (``tpu_distalg_torch/serve/``, ``convert.py``,
``cli.py``) against the JAX package, end to end on the CPU.

The slice as a whole: factors trained by the JAX package are carried
across as numpy arrays and served by both packages; the replies agree
by the tie-tolerance rule (values within rtol 1e-5 of the largest
score, indices equal wherever a score is farther than that from both
neighbours), because the two libraries sum the scores in different
orders. Within the port, batched replies equal unbatched ones bitwise.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_distalg import serve as jserve
from tpu_distalg.models import als as jals
from tpu_distalg_torch import convert, serve
from tpu_distalg_torch.models import als
from tpu_distalg_torch.ops import topk
from tpu_distalg_torch.serve.batcher import (
    MicroBatcher,
    ServeClosedError,
    ServeOverloadError,
)
from tpu_distalg_torch.utils import checkpoint
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 7


@pytest.fixture
def cpu1():
    """A one-shard mesh on the CPU."""
    from tpu_distalg_torch.parallel import get_mesh

    return get_mesh(device="cpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_jax_trained_factors_served_by_both_packages_agree(mesh1, cpu1):
    res = jals.fit(mesh1, jals.ALSConfig(m=64, n=200, k=8, n_iterations=3))
    U_np, V_np = np.asarray(res.U), np.asarray(res.V)
    U, V = convert.als_params_from_jax(U_np, V_np, device="cpu")
    assert U.is_contiguous() and V.is_contiguous()
    mine = serve.als_model(U, V, cpu1, k_top=K)
    ref = jserve.als_model(U_np, V_np, mesh1, k_top=K + 1)
    rng = np.random.default_rng(11)
    ids = [np.int32(i) for i in rng.integers(0, 64, size=32)]
    got = mine.predict_batch(ids, 32)
    want = ref.predict_batch(ids, 32)
    topk.assert_topk_close(
        np.stack([v for v, _ in got]), np.stack([i for _, i in got]),
        np.stack([v for v, _ in want]), np.stack([i for _, i in want]))
    assert mine.meta["n_items"] == 200 and mine.meta["n_users"] == 64


def test_batched_replies_equal_unbatched_bitwise(cpu1):
    rng = np.random.default_rng(2)
    U = rng.normal(size=(32, 16)).astype(np.float32)
    V = rng.normal(size=(200, 16)).astype(np.float32)
    V[180:] = 0.0  # a zero-padded tail is detected and never served
    model = serve.als_model(U, V, cpu1, k_top=K)
    assert model.meta["n_items"] == 180
    ids = [np.int64(i) for i in rng.integers(0, 32, size=5)]
    for p, (bv, bi) in zip(ids, model.predict_batch(ids, 8)):
        uv, ui = model.predict_one(p, 8)
        assert np.array_equal(bv, uv) and np.array_equal(bi, ui)
        assert bi.dtype == np.int32 and bi.max() < 180
    with pytest.raises(ValueError, match="out of range"):
        model.predict_one(np.int64(32), 8)


def test_server_closed_loop_over_a_saved_artifact(tmp_path, cpu1):
    d = str(tmp_path / "ck")
    res = als.fit(cpu1, als.ALSConfig(m=40, n=150, k=6, n_iterations=2),
                  checkpoint_dir=d)
    srv = serve.Server(cpu1, serve.ServeConfig(max_batch=8, max_delay_ms=2.0,
                                               k_top=K))
    try:
        model = srv.add_artifact(d)
        with pytest.raises(ValueError, match="already served"):
            srv.add_artifact(d)
        with pytest.raises(KeyError, match="no served model"):
            srv.submit("nope", 0)
        rng = np.random.default_rng(5)
        ids = list(rng.integers(0, 40, size=48))
        results, info = serve.run_closed_loop(srv, "als", ids,
                                              concurrency=4)
        assert info["ok"] == len(ids) and info["failed"] == 0
        want_v, want_i = topk.matmul_topk_reference(
            res.U[ids].contiguous(), res.V, 0, 150, k=K)
        for r, (v, i) in enumerate(results):
            assert np.array_equal(v, want_v[r].numpy())
            assert np.array_equal(i, want_i[r].numpy())
        assert model.meta["n_users"] == 40
        s = srv.emit_counters()
        assert s["replies"] == len(ids) and s["shed"] == 0
        assert 1 <= s["batches"] <= len(ids)
        assert s["p99_ms"] >= s["p50_ms"] >= 0 and s["qps"] > 0
    finally:
        srv.close()


def test_two_models_under_many_clients_lose_no_reply(cpu1):
    """Stress: 32 client threads (more than the cores) against two
    served models at once, with a short switch interval, so every
    shared counter sees interleaved updates; each reply must match its
    own request and the stats must add up."""
    rng = np.random.default_rng(6)
    factors = {name: (rng.normal(size=(50, 8)).astype(np.float32),
                      rng.normal(size=(90, 8)).astype(np.float32))
               for name in ("a", "b")}
    srv = serve.Server(cpu1, serve.ServeConfig(max_batch=4, max_delay_ms=1.0,
                                               queue_depth=512, k_top=3))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for name, (U, V) in factors.items():
            srv.add_model(serve.als_model(U, V, cpu1, k_top=3, name=name))
        ids = list(rng.integers(0, 50, size=160))
        out = {}
        lock = threading.Lock()

        def drive(name):
            res = serve.run_closed_loop(srv, name, ids, concurrency=16)
            with lock:
                out[name] = res

        drivers = [threading.Thread(target=drive, args=(n,), daemon=True)
                   for n in factors]
        for t in drivers:
            t.start()
        for t in drivers:
            t.join(60.0)
        assert not any(t.is_alive() for t in drivers)
    finally:
        sys.setswitchinterval(old)
        srv.close()
    for name, (U, V) in factors.items():
        results, info = out[name]
        assert info["ok"] == len(ids) and info["failed"] == 0
        want_v, want_i = topk.matmul_topk_reference(
            torch.as_tensor(U[ids]), torch.as_tensor(V), 0, 90, k=3)
        for r, (v, i) in enumerate(results):
            assert np.array_equal(v, want_v[r].numpy())
            assert np.array_equal(i, want_i[r].numpy())
    s = srv.stats()
    assert s["requests"] == s["replies"] == 2 * len(ids)
    assert sum(m["batches"] for m in s["models"].values()) == s["batches"]


def test_kmeans_and_lr_adapters_equal_the_jax_adapters():
    """Centres and weights carried through convert.py and served by
    both packages: k-means replies (int32 cluster ids) equal on
    separated points, LR probabilities within 1e-6 (two sigmoids);
    within the port, batched replies equal unbatched ones bitwise."""
    rng = np.random.default_rng(4)
    centers = (10.0 * rng.permutation(5)[:, None]
               + rng.normal(size=(5, 6))).astype(np.float32)
    pts = (centers[rng.integers(0, 5, 40)]
           + 0.5 * rng.normal(size=(40, 6))).astype(np.float32)
    c = convert.kmeans_params_from_jax(centers, device="cpu")
    mine = serve.kmeans_model(c, device="cpu")
    ref = jserve.kmeans_model(centers)
    assert mine.meta["k"] == 5 and mine.meta["dim"] == 6
    got = mine.predict_batch(list(pts[:16]), 16)
    want = ref.predict_batch(list(pts[:16]), 16)
    assert all(g.dtype == np.int32 for g in got)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    for p, b in zip(pts[:5], mine.predict_batch(list(pts[:5]), 8)):
        assert np.array_equal(b, mine.predict_one(p, 8))
    with pytest.raises(ValueError, match="shape"):
        mine.predict_one(pts[0][:3], 8)

    w_np = rng.normal(size=6).astype(np.float32)
    w = convert.ssgd_params_from_jax(w_np, device="cpu")
    mine = serve.lr_model(w, device="cpu")
    ref = jserve.lr_model(w_np)
    assert mine.meta["d"] == 6 and mine.kind == "lr"
    got = np.stack(mine.predict_batch(list(pts[:16]), 16))
    want = np.stack(ref.predict_batch(list(pts[:16]), 16))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for p, b in zip(pts[:5], mine.predict_batch(list(pts[:5]), 8)):
        assert np.array_equal(b, mine.predict_one(p, 8))


def test_server_serves_kmeans_and_ssgd_artifacts(tmp_path):
    """Training checkpoints of both workloads open by their tags
    (``kmeans_fixed``, ``ssgd:bernoulli``) and serve under load; every
    reply equals the model's own unbatched answer."""
    from tpu_distalg_torch.models import kmeans, ssgd
    from tpu_distalg_torch.ops import kmeans as kops
    from tpu_distalg_torch.ops import logistic
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    mesh = get_mesh(data=1, device="cpu")
    pts = datasets.gaussian_mixture(2000, k=3, dim=4, seed=2)
    km_dir, lr_dir = str(tmp_path / "km"), str(tmp_path / "lr")
    km = kmeans.fit(pts, mesh, kmeans.KMeansConfig(k=3, n_iterations=4),
                    checkpoint_dir=km_dir, checkpoint_every=2)
    data = datasets.breast_cancer_split()
    lr = ssgd.train(*data, mesh, ssgd.SSGDConfig(n_iterations=20),
                    checkpoint_dir=lr_dir, checkpoint_every=10)
    srv = serve.Server(mesh, serve.ServeConfig(max_batch=8,
                                               max_delay_ms=2.0))
    try:
        m_km = srv.add_artifact(km_dir)
        m_lr = srv.add_artifact(lr_dir)
        assert (m_km.kind, m_km.name, m_km.meta["k"]) == ("kmeans",
                                                          "kmeans", 3)
        assert (m_lr.kind, m_lr.name, m_lr.meta["d"]) == ("lr", "ssgd", 31)
        replies, info = serve.run_closed_loop(srv, "kmeans", list(pts[:64]),
                                              concurrency=4)
        assert info["ok"] == 64 and info["failed"] == 0
        want = kops.assign_clusters(torch.as_tensor(pts[:64]), km.centers)
        np.testing.assert_array_equal(np.stack(replies), want.numpy())
        rows = list(data[2][:48])
        replies, info = serve.run_closed_loop(srv, "ssgd", rows,
                                              concurrency=4)
        assert info["ok"] == 48 and info["failed"] == 0
        for r, reply in zip(rows, replies):
            assert np.array_equal(reply, m_lr.predict_one(r, 8))
        want = logistic.predict_proba(torch.as_tensor(data[2][:48]), lr.w)
        np.testing.assert_allclose(np.stack(replies), want.numpy(), rtol=0,
                                   atol=1e-6)
    finally:
        srv.close()


@pytest.mark.parametrize("tag", ["pagerank_standard", "closure"])
def test_load_artifact_rejects_unported_adapters(tmp_path, tag, cpu1):
    """Workloads without a serving adapter (the JAX package has none
    for them either) are refused by name."""
    checkpoint.save(str(tmp_path), tag, [np.ones(3, np.float32)], step=1)
    with pytest.raises(ValueError, match="no serving adapter"):
        serve.load_artifact(str(tmp_path), cpu1)


def test_lone_request_dispatches_by_deadline():
    b = MicroBatcher("t", lambda ps: [p * 2 for p in ps],
                     max_batch=64, max_delay_ms=25.0)
    try:
        t0 = time.perf_counter()
        assert b.submit(21).result(timeout=5.0) == 42
        assert time.perf_counter() - t0 < 2.0
        s = b.snapshot()
        assert (s.batches, s.replies) == (1, 1)
    finally:
        b.close()


def test_burst_coalesces_by_size():
    b = MicroBatcher("t", lambda ps: list(ps), max_batch=4,
                     max_delay_ms=2000.0)
    try:
        replies = [b.submit(j) for j in range(8)]
        assert [r.result(timeout=5.0) for r in replies] == list(range(8))
        s = b.snapshot()
        assert (s.batches, s.replies) == (2, 8)  # no deadline waits
    finally:
        b.close()


def test_full_queue_sheds_and_keeps_serving():
    entered, release = threading.Event(), threading.Event()

    def predict(ps):
        entered.set()
        assert release.wait(10.0)
        return list(ps)

    b = MicroBatcher("t", predict, max_batch=1, max_delay_ms=1.0,
                     queue_depth=2)
    try:
        first = b.submit(0)
        assert entered.wait(5.0)  # the dispatch thread is inside predict
        queued = [b.submit(j) for j in (1, 2)]
        shed = b.submit(3)        # the queue (depth 2) is full
        assert isinstance(shed.error, ServeOverloadError)
        with pytest.raises(ServeOverloadError):
            shed.result(timeout=1.0)
        release.set()
        assert first.result(timeout=5.0) == 0
        assert [r.result(timeout=5.0) for r in queued] == [1, 2]
        assert b.submit(4).result(timeout=5.0) == 4
        s = b.snapshot()
        assert s.shed == 1 and s.replies == 4
    finally:
        release.set()
        b.close()


def test_close_fails_what_is_queued():
    entered, release = threading.Event(), threading.Event()

    def predict(ps):
        entered.set()
        assert release.wait(10.0)
        return list(ps)

    b = MicroBatcher("t", predict, max_batch=1, max_delay_ms=1.0,
                     queue_depth=4)
    try:
        first = b.submit(0)
        assert entered.wait(5.0)
        queued = [b.submit(j) for j in (1, 2)]
        b.close(timeout=0.2)  # the loop is parked in predict: drain now
        for r in queued:
            assert isinstance(r.error, ServeClosedError)
        assert isinstance(b.submit(3).error, ServeClosedError)
        release.set()
        assert first.result(timeout=5.0) == 0
    finally:
        release.set()
        b.close()


def test_cli_trains_then_serves_the_artifact(tmp_path):
    ck = str(tmp_path / "ck")
    base = [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu"]
    out = subprocess.run(
        base + ["als", "--m", "64", "--n", "200", "--k", "8",
                "--n-iterations", "3", "--checkpoint-dir", ck],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert [ln.split(",")[0] for ln in lines[:3]] == [
        f"iterations: {t}" for t in range(3)]
    hist = [float(ln.split("rmse: ")[1]) for ln in lines[:3]]
    # the JAX package's `tda als` prints 0.194606, 0.037895, 0.031110
    np.testing.assert_allclose(hist, [0.194606, 0.037895, 0.031110],
                               rtol=1e-4)
    assert lines[-1] == f"artifact_path: {ck}"
    out = subprocess.run(
        base + ["serve", "--artifact", ck, "--requests", "64",
                "--max-batch", "8"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "[serve] als: 64/64 replies at " in out.stdout
    assert "[serve] total: 64 replies in " in out.stdout


def test_port_imports_nothing_of_jax():
    """Every module of the port, and chip_smoke.py, import cleanly in a
    fresh interpreter that never loads jax or tpu_distalg."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_distalg_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'tpu_distalg', 'flax'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('tpu_distalg_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
