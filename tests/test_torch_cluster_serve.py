"""The port's serving plane (``tpu_distalg_torch/cluster/serve.py`` and
``router.py``) against the JAX package's, on the CPU.

The dispatch policies, the adapters and the plan scoping are plain
Python in both packages and are held equal on the same inputs and seeds.
Replicas here score on the CPU through the plain versions (B9's
``matmul_topk_reference``, the serving predictors), in fixed-shape
blocks: a reply is bitwise the same whatever the batch fill, the replica
count or a re-route, and a sharded fleet's merged replies are bitwise a
single replica's. The replies are held to the JAX package's
``HostModel`` by ``ops/topk.assert_topk_close`` (ALS), within 1e-6
(LR) and to the nearest centre up to rounding ties (k-means). The
router's frames are the JAX package's: a JAX router drives port
replicas. Hot swap, the dense fallback, WAL recovery on the same port,
the chaos drill and the command line's replica and router roles run end
to end.

Sizes: JAX's test geometry — k-means 8 × 16 centres with 40-160
requests, ALS 24 users × 300 items rank 8 over 1 and 3 shards, 24
requests, k 10; fleets of 2-3 thread replicas, one run with process
replicas.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tpu_distalg.cluster import router as jrouter
from tpu_distalg.cluster import serve as jserve
from tpu_distalg_torch import faults
from tpu_distalg_torch.cluster import router, serve
from tpu_distalg_torch.cluster.router import (ConsistentHashPolicy,
                                              LeastLoadedPolicy, Router,
                                              RouterConfig, make_policy)
from tpu_distalg_torch.ops import topk
from tpu_distalg_torch.telemetry import events as tevents
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.configure(False)


def _kmeans_center(seed=7, k=8, dim=16):
    rng = np.random.default_rng(seed)
    return {"centers": rng.normal(size=(k, dim)).astype(np.float32)}


def _als_center(seed=5, m_users=24, n_items=300, rank=8):
    rng = np.random.default_rng(seed)
    return {"U": rng.normal(size=(m_users, rank)).astype(np.float32),
            "V": rng.normal(size=(n_items, rank)).astype(np.float32)}


def _fleet(cfg, center, **kw):
    return serve.ServeFleet(cfg, center, device="cpu", **kw).start()


# ------------------------------------------------------------- policies

def test_make_policy_mapping():
    assert isinstance(make_policy("consistent_hash"), ConsistentHashPolicy)
    assert isinstance(make_policy("least_loaded"), LeastLoadedPolicy)


def test_least_loaded_ties_replay_with_jaxs_picks():
    alive = [0, 1, 2]
    assert LeastLoadedPolicy(seed=5).pick(alive, {0: 3, 1: 0, 2: 2}) == 1
    loads = {0: 0, 1: 0, 2: 0}
    q, j = LeastLoadedPolicy(seed=5), jrouter.LeastLoadedPolicy(seed=5)
    mine = [q.pick(alive, loads) for _ in range(48)]
    assert mine == [j.pick(alive, loads) for _ in range(48)]
    assert len(set(mine)) == 3


def test_consistent_hash_remaps_only_a_dead_replicas_arcs():
    """A death remaps only the dead replica's keys, with JAX's picks on
    the same seed, keyed and keyless."""
    p, jp = ConsistentHashPolicy(seed=0), jrouter.ConsistentHashPolicy(0)
    alive = [0, 1, 2]
    loads = {r: 0 for r in alive}
    keys = [f"user{i}" for i in range(256)]
    owner = {k: p.pick(alive, loads, key=k) for k in keys}
    assert owner == {k: jp.pick(alive, loads, key=k) for k in keys}
    assert set(owner.values()) == {0, 1, 2}
    owner2 = {k: p.pick([0, 2], loads, key=k) for k in keys}
    assert owner2 == {k: jp.pick([0, 2], loads, key=k) for k in keys}
    for k in keys:
        assert owner2[k] == owner[k] if owner[k] != 1 else owner2[k] != 1
    q, jq = ConsistentHashPolicy(seed=3), jrouter.ConsistentHashPolicy(3)
    assert [q.pick(alive, loads) for _ in range(32)] == \
        [jq.pick(alive, loads) for _ in range(32)]


# ----------------------------------------------- adapters and plan scope

def test_center_of_state_and_scoped_plan_spec_are_jaxs():
    for root, state in (("ssgd", [np.ones((5,), np.float64)]),
                        ("kmeans_minibatch", [np.ones((3, 2))]),
                        ("als", [np.ones((4, 2)), np.ones((6, 2))])):
        kind, center = serve.center_of_state(root, state)
        jkind, jcenter = jserve.center_of_state(root, state)
        assert kind == jkind and set(center) == set(jcenter)
        for k in center:
            assert center[k].dtype == np.float32
            assert center[k].tobytes() == jcenter[k].tobytes()
    with pytest.raises(ValueError, match="no serving-plane adapter"):
        serve.center_of_state("pagerank", [np.ones(3)])
    for spec in ("seed=3;cluster:replica@7=kill;cluster:rpc@p0.02=oserror",
                 "seed=3;cluster:rpc@p0.02=oserror", None):
        assert serve.scoped_plan_spec(spec) == jserve.scoped_plan_spec(spec)
    assert "cluster:rpc" not in serve.scoped_plan_spec(
        "seed=3;cluster:replica@7=kill;cluster:rpc@p0.02=oserror")


# --------------------------------------------------- the replica model

@pytest.mark.parametrize("kind,merge", [("lr", None), ("kmeans", None),
                                        ("als", "sparse"), ("als", "dense")])
def test_a_replys_bits_do_not_depend_on_its_batch(kind, merge):
    """Scored alone, in a full block, past a block boundary or among
    other rows, a row's reply bits are the same."""
    rng = np.random.default_rng(4)
    if kind == "als":
        center, x = _als_center(), np.arange(24, dtype=np.int64) % 24
        x = np.concatenate([x, x[:17]])      # 41 rows: two blocks
    elif kind == "lr":
        center = {"w": rng.normal(size=(31,)).astype(np.float32)}
        x = rng.normal(size=(41, 31)).astype(np.float32)
    else:
        center = _kmeans_center()
        x = rng.normal(size=(41, 16)).astype(np.float32)
    m = serve.ReplicaModel(kind, center, merge=merge or "sparse",
                           device="cpu")
    whole = m.score_frame({"x": x})
    for r in (0, 5, 31, 40):
        one = m.score_frame({"x": x[r:r + 1]})
        for name, arr in whole.items():
            assert arr[r].tobytes() == one[name][0].tobytes(), (name, r)


def test_replica_on_a_missing_card_raises(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.ReplicaModel("kmeans", _kmeans_center())


# ------------------------------------------------------- routed scoring

def test_routed_kmeans_round_trip_bitwise():
    """Through the wire and the micro-batcher, every request gets the
    replica model's bits, stamped with the version; against JAX's
    ``HostModel`` the chosen centre is a nearest one (the port computes
    distances by ``|p|² − 2p·c + |c|²``, JAX per row by differences)."""
    center = _kmeans_center()
    X = np.random.default_rng(1).normal(size=(40, 16)).astype(np.float32)
    want = serve.ReplicaModel("kmeans", center, device="cpu").score_frame(
        {"x": X})["y"]
    fleet = _fleet(serve.FleetConfig(kind="kmeans", n_replicas=2,
                                     version=3, max_delay_ms=1.0), center)
    try:
        results, info = serve.run_fleet_closed_loop(fleet, list(X),
                                                    concurrency=4)
    finally:
        fleet.stop()
    assert info["failed"] == 0 and info["ok"] == len(X)
    assert info["availability"] == 1.0
    assert info["p99_ms"] >= info["p50_ms"] > 0
    got = np.asarray([v for v, _ver, _rid in results])
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert all(ver == 3 for _v, ver, _r in results)
    assert {rid for _v, _ver, rid in results} <= {0, 1}
    jy = jserve.HostModel("kmeans", center).score_frame({"x": X})["y"]
    d = ((X[:, None, :] - center["centers"][None]) ** 2).sum(-1)
    picked = d[np.arange(len(X)), got]
    assert np.all(picked <= d[np.arange(len(X)), jy] * (1 + 1e-5))


def test_routed_lr_round_trip_against_jax():
    rng = np.random.default_rng(2)
    center = {"w": rng.normal(size=(31,)).astype(np.float32)}
    X = rng.normal(size=(24, 31)).astype(np.float32)
    fleet = _fleet(serve.FleetConfig(kind="lr", n_replicas=2,
                                     max_delay_ms=1.0), center)
    try:
        results, info = serve.run_fleet_closed_loop(fleet, list(X),
                                                    concurrency=3)
    finally:
        fleet.stop()
    assert info["failed"] == 0
    got = np.asarray([v for v, _ver, _rid in results])
    want = jserve.HostModel("lr", center).score_frame({"x": X})["y"]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ------------------------------------ sharded == single, both merges

@pytest.mark.parametrize("merge", ["sparse", "dense"])
def test_sharded_topk_bitwise_vs_single_with_jaxs_wire_accounting(
        merge, tmp_path):
    """A 3-shard fleet's merged top-k is bitwise the 1-shard fleet's,
    the candidate bytes the router pulls are JAX's closed form, and the
    replies hold to JAX's ``HostModel`` by the tie rule."""
    n_items, k_top, n_req = 300, 10, 24
    center = _als_center(n_items=n_items)
    payloads = [np.int32(i) for i in range(n_req)]
    tevents.configure(str(tmp_path / "tel"))
    try:
        outs, wire = {}, {}
        for n_rep in (1, 3):
            before = tevents.get_sink().counters().get(
                "serve.cluster_merge_bytes_wire", 0)
            fleet = _fleet(serve.FleetConfig(
                kind="als", n_replicas=n_rep, sharded=True, merge=merge,
                k_top=k_top, max_delay_ms=1.0, version=1), center)
            try:
                results, info = serve.run_fleet_closed_loop(
                    fleet, payloads, concurrency=4)
            finally:
                fleet.stop()
            assert info["failed"] == 0 and info["ok"] == n_req
            outs[n_rep] = results
            wire[n_rep] = tevents.get_sink().counters().get(
                "serve.cluster_merge_bytes_wire", 0) - before
    finally:
        tevents.configure(False)
    for (v1, ver1, _), (v3, ver3, _) in zip(outs[1], outs[3]):
        assert v1[0].tobytes() == v3[0].tobytes()
        assert v1[1].tobytes() == v3[1].tobytes()
        assert v1[1].dtype == np.int32 and v1[0].dtype == np.float32
        assert ver1 == ver3 == 1
    if merge == "sparse":
        per_shard = {1: n_req * k_top * 8, 3: n_req * k_top * 8 * 3}
    else:
        span = 3 * serve.SCORE_BLOCK
        n_pad = -(-n_items // span) * span
        per_shard = {1: n_req * n_pad * 4, 3: n_req * n_pad * 4}
    assert wire == per_shard
    ref = jserve.HostModel("als", center, k_top=k_top + 1).score_frame(
        {"x": np.arange(n_req)})
    topk.assert_topk_close(np.stack([v[0] for v, _, _ in outs[3]]),
                           np.stack([v[1] for v, _, _ in outs[3]]),
                           ref["vals"], ref["idx"])


def test_a_jax_router_drives_port_replicas():
    """The JAX package's router over the port's replicas (the same
    frames): its merged replies are the port router's, bit for bit."""
    center = _als_center()
    reps = [serve.Replica(s, serve.ReplicaModel(
        "als", center, shard=s, n_shards=2, device="cpu"),
        version=1).start() for s in range(2)]
    addrs = tuple(("127.0.0.1", r.port) for r in reps)
    got = {}
    try:
        for name, mod in (("port", router), ("jax", jrouter)):
            r = mod.Router(mod.RouterConfig(replicas=addrs, mode="sharded",
                                            max_delay_ms=1.0)).start()
            try:
                got[name] = [r.request(np.int32(i)) for i in range(12)]
            finally:
                r.stop()
    finally:
        for rep in reps:
            rep.stop()
    for (a, va, _), (b, vb, _) in zip(got["port"], got["jax"]):
        assert a[0].tobytes() == b[0].tobytes()
        assert a[1].tobytes() == b[1].tobytes()
        assert va == vb == 1


# ------------------------------------------------------------- hot swap

def test_hot_swap_drops_nothing_and_versions_only_rise():
    """Publishes land during a concurrent burst: every request answered,
    each reply version-stamped, a replica's stamps never move back, and
    the int8 spec rides the compressed delta path."""
    center = _kmeans_center()
    X = np.random.default_rng(2).normal(size=(160, 16)).astype(np.float32)
    fleet = _fleet(serve.FleetConfig(kind="kmeans", n_replicas=3,
                                     version=1, comm="int8",
                                     max_delay_ms=1.0), center)
    swaps = []
    try:
        def publisher():
            for v in range(2, 6):
                time.sleep(0.02)
                swaps.append(fleet.publish(
                    {"centers": center["centers"] + np.float32(v)}, v))

        pub = threading.Thread(target=publisher, daemon=True)
        pub.start()
        results, info = serve.run_fleet_closed_loop(fleet, list(X),
                                                    concurrency=8)
        pub.join(timeout=10.0)
        final = fleet.request(X[0])
        st = fleet.stats()
    finally:
        fleet.stop()
    assert info["failed"] == 0 and info["availability"] == 1.0
    assert final[1] == st["version"] == 5
    assert len(swaps) == 4
    for pub_res in swaps:
        assert pub_res["swapped"] == [0, 1, 2]
        assert all(m == "delta" for m in pub_res["modes"].values())
    assert {ver for _v, ver, _r in results} <= {1, 2, 3, 4, 5}
    conc = info["concurrency"]
    for w in range(conc):
        last = {}
        for j in range(w, len(X), conc):
            _v, ver, rid = results[j]
            assert ver >= last.get(rid, 0)
            last[rid] = ver


def test_hot_swap_dense_fallback_without_a_codec():
    center = _kmeans_center()
    fleet = _fleet(serve.FleetConfig(kind="kmeans", n_replicas=2,
                                     version=1, comm="dense",
                                     max_delay_ms=1.0), center)
    try:
        pub = fleet.publish({"centers": center["centers"] * np.float32(2)},
                            2)
        out = fleet.request(np.zeros((16,), np.float32))
    finally:
        fleet.stop()
    assert pub["swapped"] == [0, 1]
    assert all(m == "dense" for m in pub["modes"].values())
    assert out[1] == 2


# ------------------------------------------------------- WAL recovery

def test_router_wal_recovery_rebinds_the_same_port(tmp_path):
    """A fresh router over the crashed one's WAL rebinds the same port,
    restores the published version and serves at once; the JAX
    package's router reads the same WAL to the same state."""
    wal_dir = str(tmp_path / "router_wal")
    center = _kmeans_center()
    X = np.random.default_rng(3).normal(size=(12, 16)).astype(np.float32)
    fleet = _fleet(serve.FleetConfig(kind="kmeans", n_replicas=2,
                                     version=1, wal_dir=wal_dir,
                                     max_delay_ms=1.0), center)
    r2 = None
    try:
        port0 = fleet.router.port
        _, info = serve.run_fleet_closed_loop(fleet, list(X))
        assert info["failed"] == 0
        fleet.publish({"centers": center["centers"] + np.float32(1)}, 2)
        want = fleet.request(X[0])
        fleet.router.slam()
        r2 = Router(RouterConfig(wal_dir=wal_dir)).start()
        assert r2.recovered and r2.port == port0 and r2.version == 2
        got = r2.request(X[0])
        assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
        assert got[1] == 2
        records, _ = jrouter.cluster_wal.WriteAheadLog.replay(wal_dir,
                                                              1 << 60)
        kinds = [k for k, _m, _a in records]
        assert kinds[0] == "base" and "publish" in kinds
    finally:
        if r2 is not None:
            r2.stop()
        fleet.stop()


# ----------------------------------------------------------- chaos

def test_chaos_cluster_serve_kill_and_rpc_grid(tmp_path):
    """A replica killed mid-burst plus an rpc oserror storm: replies
    bitwise the undisturbed run's, availability in the band, and the
    kill fired (JAX ``test_chaos_cluster_serve_kill_and_rpc_grid``)."""
    from tpu_distalg_torch.faults import chaos
    from tpu_distalg_torch.parallel import get_mesh

    res = chaos.run_chaos(
        "cluster_serve", get_mesh(data=1, device="cpu"),
        plan="seed=3;cluster:replica@7=kill;cluster:rpc@p0.02=oserror",
        workdir=str(tmp_path))
    assert res.equal, res.verdict()
    assert ("cluster:replica", 7, "kill") in res.fired
    assert "OK" in res.verdict()


# ------------------------------------------------------ command line

def _spawn(args, env):
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
         "cluster", *args], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    import select

    if not select.select([proc.stdout], [], [], 120.0)[0]:
        proc.kill()
        raise AssertionError(f"{args[:2]} never announced its port")
    line = proc.stdout.readline().strip()
    assert " listening on " in line, line
    return proc, int(line.rsplit(":", 1)[1])


def test_cli_replica_and_router_roles(tmp_path):
    """``cluster --role replica`` processes serving an ALS artifact over
    2 shards behind a ``--role router`` process: a ``RouterClient``'s
    replies are a single in-process replica's, bit for bit."""
    from tpu_distalg_torch.utils import checkpoint

    center = _als_center()
    ckpt = str(tmp_path / "als")
    checkpoint.save(ckpt, "als", [center["U"], center["V"]], 1)
    env = dict(os.environ, TDA_TELEMETRY_DIR="", TDA_FAULT_PLAN="")
    procs = []
    try:
        ports = []
        for s in range(2):
            p, port = _spawn(["--role", "replica", "--slot", str(s),
                              "--artifact", ckpt, "--replica-shards", "2",
                              "--shard", str(s), "--deadline", "120"], env)
            procs.append(p)
            ports.append(port)
        p, rport = _spawn(
            ["--role", "router", "--serve-mode", "sharded", "--replicas",
             ",".join(f"127.0.0.1:{q}" for q in ports), "--deadline",
             "120"], env)
        procs.append(p)
        client = router.RouterClient("127.0.0.1", rport, deadline=30.0)
        try:
            got = [client.request(np.int32(i)) for i in range(8)]
        finally:
            client.close()
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=30)
    one = serve.ReplicaModel("als", center, device="cpu").score_frame(
        {"x": np.arange(8)})
    for i, (value, version, rid) in enumerate(got):
        assert value[0].tobytes() == one["vals"][i].tobytes()
        assert value[1].tobytes() == one["idx"][i].tobytes()
        assert rid == -1


def test_process_replica_killed_mid_burst(tmp_path):
    """Process replicas (``python -m tpu_distalg_torch.cli --device cpu
    cluster --role replica``), the first under a scoped ``kill`` after 3
    batches: the router re-routes, every reply is the undisturbed
    bits."""
    from tpu_distalg_torch.utils import checkpoint

    center = _kmeans_center()
    ckpt = str(tmp_path / "km")
    checkpoint.save(ckpt, "kmeans_lloyd", [center["centers"]], 1)
    X = np.random.default_rng(9).normal(size=(64, 16)).astype(np.float32)
    fleet = serve.ServeFleet(
        serve.FleetConfig(kind="kmeans", n_replicas=2, artifact=ckpt,
                          fault_slot=0, max_delay_ms=1.0),
        spawn="process", plan_spec="seed=1;cluster:replica@3=kill",
        device="cpu").start()
    try:
        results, info = serve.run_fleet_closed_loop(
            fleet, list(X), concurrency=4, retries=5, retry_backoff_s=0.05)
        st = fleet.stats()
    finally:
        fleet.stop()
    assert info["failed"] == 0 and st["dead"] == [0]
    assert st["reroutes"] >= 1
    want = serve.ReplicaModel("kmeans", center, device="cpu").score_frame(
        {"x": X})["y"]
    assert np.array_equal(np.asarray([v for v, _, _ in results]), want)


def test_report_renders_the_cluster_serve_line(tmp_path):
    from tpu_distalg_torch.telemetry import report

    tdir = tmp_path / "tel"
    tevents.configure(str(tdir))
    center = _kmeans_center()
    try:
        fleet = _fleet(serve.FleetConfig(kind="kmeans", n_replicas=2,
                                         max_delay_ms=1.0), center)
        try:
            serve.run_fleet_closed_loop(
                fleet, [np.zeros(16, np.float32)] * 8, concurrency=2)
            fleet.router.emit_gauges()
        finally:
            fleet.stop()
    finally:
        tevents.configure(False)
    out = report.render(report.summarize(report.load_events(str(tdir))))
    assert "cluster serve: 8 request(s)" in out
