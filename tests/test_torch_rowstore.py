"""The port's sharded row store (``tpu_distalg_torch/cluster/rowstore.py``,
``ps.py``'s rowstore mode, ``models/als.fit_rowstore``) against the JAX
package's, on the CPU.

The store is host numpy in both packages, so its merges, versions and
pulls are held bitwise to JAX's on the same pushes, and its frames byte
for byte. A rowstore SSGD cluster's center is bitwise the replicated
mode's (every LR push touches every row). Cluster PageRank's workers run
their windows through B7's plain version here: the ranks are within 1e-6
of the port's graph engine and within rtol 1e-5 / atol 1e-8 of JAX's
fleet on the same cache, with JAX's event digest; the WAL's row-redo
records replay bitwise, in the port and in the JAX package. ALS with V
in the store is held to JAX's within ROADMAP C's ALS bounds.

Sizes: JAX's test geometry — stores of 4-11 rows, the 512-vertex
power-law cache of 4 shards with 64-edge blocks (a strict subset of
ranks pulled a worker), clusters of 3 slots × 6 windows on 512 rows,
ALS 48 × 320 rank 5 at density 0.03 under a 200-row budget.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest

from tpu_distalg import cluster as jclus
from tpu_distalg import faults as jfaults
from tpu_distalg.cluster import ps as jps
from tpu_distalg.cluster import rowstore as jrowstore
from tpu_distalg.cluster import transport as jtransport
from tpu_distalg.cluster import worker as jworker
from tpu_distalg.parallel import comms as jcomms
from tpu_distalg_torch import cli
from tpu_distalg_torch import cluster as clus
from tpu_distalg_torch import faults
from tpu_distalg_torch.cluster import ps as psmod
from tpu_distalg_torch.cluster import rowstore, transport, worker
from tpu_distalg_torch.parallel import comms, get_mesh
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

#: JAX ``tests/test_rowstore.py:235``'s SSP cluster
CFG = dict(n_slots=3, n_windows=6, staleness=3, heartbeat_timeout=5.0)
N_ROWS, TEST_ROWS = 512, 256
#: the port's SSGD center against JAX's, a fraction of max|w| (the
#: trainers agree within 1e-5 over a few windows, ROADMAP C)
CENTER_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.configure(False)
    jfaults.configure(False)


def _contribs(rng, shape, n_slots, window):
    """[(slot, base, delta)] with a spread of ages."""
    return [(s, max(0, window - (s % 3)),
             {"w": rng.normal(size=shape).astype(np.float32)})
            for s in range(n_slots)]


# ------------------------------------------------------------ the store

def test_whole_leaf_merge_is_the_replicated_ps_and_jaxs():
    """Full-row pushes with mixed ages: the row store holds the bytes of
    the replicated PS, and of the JAX package's store."""
    rng = np.random.default_rng(7)
    d = 11
    center = {"w": rng.normal(size=(d, 2)).astype(np.float32)}
    rep = psmod.ParameterServer(center, table="lr", n_shards=3)
    store = rowstore.RowStore(center, table="lr", n_shards=3)
    theirs = jrowstore.RowStore(center, table="lr", n_shards=3)
    rows = np.arange(d, dtype=np.int64)
    for w in range(5):
        contribs = _contribs(rng, (d, 2), 3, w)
        rep.merge(w, contribs)
        pushes = [(s, {"w": (rows, delta["w"], base)})
                  for s, base, delta in contribs]
        assert store.merge_rows(w, pushes) == theirs.merge_rows(w, pushes)
    got = store.snapshot()["w"].tobytes()
    assert got == rep.snapshot()["w"].tobytes()
    assert got == theirs.snapshot()["w"].tobytes()
    assert np.array_equal(store.row_versions("w"), theirs.row_versions("w"))


@pytest.mark.parametrize("mode", ["replicated", "rowstore"])
def test_ps_modes_merge_as_jaxs(mode):
    """``ParameterServer(mode=...)`` fed the coordinator's ``[(slot,
    base, delta)]`` (no ``.rows``: whole leaves): the records, versions
    and center equal JAX's, and the rowstore mode equals the replicated
    one bitwise."""
    rng = np.random.default_rng(3)
    center = {"w": rng.normal(size=(9, 3)).astype(np.float32)}
    mine = psmod.ParameterServer(center, table="lr", n_shards=2, mode=mode)
    theirs = jps.ParameterServer(center, table="lr", n_shards=2, mode=mode)
    rep = psmod.ParameterServer(center, table="lr", n_shards=2)
    for w in range(4):
        contribs = _contribs(rng, (9, 3), 3, w)
        assert mine.merge(w, contribs) == theirs.merge(w, contribs)
        rep.merge(w, contribs)
    assert mine.snapshot()["w"].tobytes() == \
        theirs.snapshot()["w"].tobytes() == rep.snapshot()["w"].tobytes()
    assert mine.version == theirs.version == 4


def test_partial_merges_versions_and_pulls_are_jaxs():
    """Sparse pushes of random rows at per-row bases across several
    commits: every snapshot, version vector and pull (values and
    versions, in the caller's row order) equals JAX's store's; rows
    nobody touched keep their bytes and version 0."""
    rng = np.random.default_rng(1)
    center = {"w": rng.normal(size=(23, 3)).astype(np.float32)}
    mine = rowstore.RowStore(center, table="lr", n_shards=3, decay=0.7)
    theirs = jrowstore.RowStore(center, table="lr", n_shards=3, decay=0.7)
    for win in range(1, 6):
        pushes = []
        for s in range(3):
            rows = np.sort(rng.choice(20, size=6, replace=False))
            vbase = rng.integers(max(0, win - 3), win + 1, size=6)
            pushes.append((s, {"w": (
                rows.astype(np.int64),
                rng.normal(size=(6, 3)).astype(np.float32), vbase)}))
        assert mine.merge_rows(win, pushes) == theirs.merge_rows(win,
                                                                 pushes)
        assert mine.snapshot()["w"].tobytes() == \
            theirs.snapshot()["w"].tobytes()
        ask = rng.permutation(23)[:9].astype(np.int64)
        a, b = mine.pull_rows("w", ask), theirs.pull_rows("w", ask)
        assert a[0].tobytes() == b[0].tobytes()
        assert np.array_equal(a[1], b[1])
    vers = mine.row_versions("w")
    assert np.array_equal(vers, theirs.row_versions("w"))
    assert (vers[20:] == 0).all()
    assert mine.snapshot()["w"][20:].tobytes() == center["w"][20:].tobytes()
    assert mine.version == theirs.version == 6


def test_row_staleness_gate_refuses_as_jax_does():
    center = {"w": np.zeros((6, 2), np.float32)}
    rows = np.arange(3, dtype=np.int64)
    delta = np.ones((3, 2), np.float32)
    msgs = []
    for mod in (rowstore, jrowstore):
        store = mod.RowStore(center, table="lr", n_shards=2, staleness=2)
        store.merge_rows(2, [(0, {"w": (rows, delta, 0)})])   # age 2
        before = store.snapshot()["w"].tobytes()
        with pytest.raises(mod.RowStalenessError) as e:
            store.merge_rows(3, [(0, {"w": (rows, delta, 0)})])  # age 3
        assert store.snapshot()["w"].tobytes() == before
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_per_row_vbase_weights_rows_independently():
    """JAX ``test_per_row_vbase_weights_rows_independently``: two
    contributions at different bases weight each row by its own
    ``decay**age``."""
    decay = 0.5
    center = {"w": np.zeros((4, 1), np.float32)}
    rows = np.array([0, 1], np.int64)
    got = []
    for mod in (rowstore, jrowstore):
        store = mod.RowStore(center, table="lr", n_shards=2, decay=decay)
        store.merge_rows(2, [
            (0, {"w": (rows, np.zeros((2, 1), np.float32), 2)}),
            (1, {"w": (rows, np.ones((2, 1), np.float32),
                       np.array([0, 1], np.int64))}),
        ])
        got.append(store.snapshot()["w"])
    assert got[0].tobytes() == got[1].tobytes()
    w2 = np.float32(decay) ** np.float32(2)
    assert float(got[0][0, 0]) == float(w2 / np.float32(1.0 + float(w2)))


# ------------------------------------------------------------- frames

@pytest.mark.parametrize("comm", ["dense", "int8", "topk:0.25"])
def test_row_push_and_pull_frames_are_jaxs_bytes(comm):
    """A sparse row push (rows + values or codec parts) and a row pull
    encode to the JAX package's frame bytes, and decode to the same
    rows and values."""
    rng = np.random.default_rng(5)
    rows = np.sort(rng.choice(100, size=17, replace=False)).astype(np.int64)
    vals = rng.normal(size=(17,)).astype(np.float32)
    codec = comms.make_host_codec(comm)
    jcodec = jcomms.make_host_codec(comm)
    a = rowstore.encode_row_push(codec, "ranks", rows, vals, 3, 1)
    b = jrowstore.encode_row_push(jcodec, "ranks", rows, vals, 3, 1)
    meta = {"slot": 1, "window": 3, "base": 3}
    assert transport.encode_frame("rowpush", meta, a) == \
        jtransport.encode_frame("rowpush", meta, b)
    m, arrs = rowstore.frame_roundtrip("rowpush", meta, a,
                                       counter="rowstore.wire_push_bytes")
    assert m == meta
    idx, got = rowstore.decode_row_push(codec, "ranks", arrs, 17)
    jidx, want = jrowstore.decode_row_push(jcodec, "ranks", b, 17)
    assert np.array_equal(idx, rows) and np.array_equal(jidx, rows)
    assert got.tobytes() == want.tobytes()
    pull = {"ranks.rows": rows, "ranks.val": vals}
    pmeta = {"slot": 0, "window": 2, "rows": 17}
    assert transport.encode_frame("rowpull", pmeta, pull) == \
        jtransport.encode_frame("rowpull", pmeta, pull)
    assert rowstore.strip_row_arrays(a)[1]["ranks"].tobytes() == \
        rows.tobytes()


def test_ps_point_compiles_as_jaxs():
    plan = faults.FaultPlan.parse("seed=3;cluster:ps@2=kill;cluster:ps@4=hang")
    jplan = jfaults.FaultPlan.parse(plan.spec())
    got = rowstore.compile_point_schedule("cluster:ps", 6, plan=plan)
    assert np.array_equal(got, jrowstore.compile_point_schedule(
        "cluster:ps", 6, plan=jplan))
    assert float(got[2, 0]) == rowstore.KILL_CELL
    with pytest.raises(ValueError):
        faults.FaultPlan.parse("cluster:ps@1=oserror")


# ------------------------------------------------ the SSGD cluster

def _cluster(mod, **over):
    kw = {"device": "cpu"} if mod is clus else {}
    return mod.run_local_cluster(mod.ClusterConfig(
        **CFG, train=mod.TrainTask(n_rows=N_ROWS, test_rows=TEST_ROWS),
        **over), spawn="thread", timeout=180.0, **kw)


@pytest.mark.parametrize("comm", ["dense", "int8"])
def test_rowstore_cluster_center_is_the_replicated_ones(comm):
    """The thread-mode SSP cluster under ``--ps-mode rowstore`` lands the
    bit-identical center of the replicated run (JAX
    ``test_ssp_cluster_rowstore_center_bitwise_equals_replicated``),
    and the JAX package's event digest."""
    rep = _cluster(clus, comm=comm)
    row = _cluster(clus, comm=comm, ps_mode="rowstore")
    theirs = _cluster(jclus, comm=comm, ps_mode="rowstore")
    assert rep["version"] == row["version"] == CFG["n_windows"]
    assert np.asarray(rep["center"]["w"]).tobytes() == \
        np.asarray(row["center"]["w"]).tobytes()
    assert clus.event_digest(row) == jclus.local.event_digest(theirs)


def test_unknown_ps_mode_is_refused_in_jaxs_words():
    msgs = []
    for mod, ps in ((clus, psmod), (jclus, jps)):
        with pytest.raises(ValueError) as a:
            mod.ClusterConfig(ps_mode="sharded")
        with pytest.raises(ValueError) as b:
            ps.ParameterServer({"w": np.zeros((4, 1), np.float32)},
                               mode="columnstore")
        msgs.append((str(a.value), str(b.value)))
    assert msgs[0] == msgs[1]


def _mixed(coord_mod, worker_mod):
    """``coord_mod``'s coordinator in rowstore mode with three of
    ``worker_mod``'s workers on threads."""
    cfg = coord_mod.ClusterConfig(
        **CFG, ps_mode="rowstore", comm="int8",
        train=coord_mod.TrainTask(n_rows=N_ROWS, test_rows=TEST_ROWS))
    coord = coord_mod.Coordinator(cfg).start()
    kw = {"device": "cpu"} if worker_mod is worker else {}
    threads = [threading.Thread(
        target=worker_mod.run_worker, args=("127.0.0.1", coord.port),
        kwargs={"slot": s, **kw}, daemon=True) for s in range(3)]
    try:
        for t in threads:
            t.start()
        res = coord.wait(timeout=120.0)
        for t in threads:
            t.join(timeout=30)
    finally:
        coord.stop()
    return res


@pytest.mark.parametrize("coord_mod,worker_mod", [(jclus, worker),
                                                  (clus, jworker)],
                         ids=["jax-coordinator", "jax-workers"])
def test_mixed_rowstore_clusters_join(coord_mod, worker_mod):
    """A JAX coordinator in rowstore mode takes port workers, and the
    port's coordinator JAX workers: the run ends with the all-JAX
    run's digest and its center within ``CENTER_TOL`` (int8 wire:
    the codec sees last-bit differences, so within 1e-3)."""
    res = _mixed(coord_mod, worker_mod)
    want = _mixed(jclus, jworker)
    assert res["version"] == want["version"] == CFG["n_windows"]
    digest = (clus.event_digest if coord_mod is clus
              else jclus.local.event_digest)
    assert digest(res) == jclus.local.event_digest(want)
    w, v = np.asarray(res["center"]["w"]), np.asarray(want["center"]["w"])
    assert np.max(np.abs(w - v)) <= 1e-3 * np.max(np.abs(v))


def test_cli_cluster_rowstore_runs(capsys):
    rc = cli.main(["--device", "cpu", "cluster", "--role", "local",
                   "--spawn", "thread", "--workers", "2", "--n-windows",
                   "4", "--n-rows", "512", "--ps-mode", "rowstore"])
    assert rc == 0
    assert '"version": 4' in capsys.readouterr().out


# ---------------------------------------------------- cluster PageRank

@pytest.fixture(scope="module")
def powerlaw(tmp_path_factory):
    """JAX ``tests/test_rowstore.py:263``'s cache: 512 vertices over 4
    shards, in-degree 8, α 1.6, 64-edge blocks."""
    from tpu_distalg_torch import graphs

    path = str(tmp_path_factory.mktemp("rowstore") / "pl")
    graphs.build_powerlaw_block_cache(
        path, n_vertices=512, n_shards=4, avg_in_degree=8.0, alpha=1.6,
        seed=3, block_edges=64)
    return path


def test_cluster_pagerank_matches_engine_and_jaxs_fleet(powerlaw):
    """Within 1e-6 of the port's streamed engine (the same blocked
    association), within rtol 1e-5 / atol 1e-8 of JAX's fleet with its
    event digest, pulling strictly fewer rank rows than dense
    replication, under a row budget below the vertex count."""
    from tpu_distalg_torch import graphs

    gd = graphs.open_graph_dataset(powerlaw, get_mesh(data=4, device="cpu"),
                                   backend="streamed")
    want = graphs.run_streamed_pagerank(
        gd, graphs.StreamedPageRankConfig(n_iterations=8)).ranks.numpy()
    cfg = dict(n_iterations=8, model_budget_rows=480)
    res = rowstore.run_cluster_pagerank(
        powerlaw, rowstore.ClusterPageRankConfig(**cfg), device="cpu")
    theirs = jrowstore.run_cluster_pagerank(
        powerlaw, jrowstore.ClusterPageRankConfig(**cfg))
    assert res["version"] == 8
    assert float(np.max(np.abs(res["ranks"] - want))) <= 1e-6
    np.testing.assert_allclose(res["ranks"], theirs["ranks"], rtol=1e-5,
                               atol=1e-8)
    assert abs(float(np.sum(res["ranks"], dtype=np.float64)) - 1.0) <= 1e-4
    assert res["event_digest"] == theirs["event_digest"]
    for key in ("sparse_pull_fraction", "peak_pull_rows", "n_vertices",
                "n_workers"):
        assert res[key] == theirs[key], key
    assert 0.0 < res["sparse_pull_fraction"] < 1.0
    assert res["peak_pull_rows"] <= 480 < 512
    with pytest.raises(RuntimeError, match="model budget"):
        rowstore.run_cluster_pagerank(
            powerlaw, rowstore.ClusterPageRankConfig(
                n_iterations=1, model_budget_rows=100), device="cpu")


def test_wal_row_redo_replays_bitwise_in_both_packages(powerlaw, tmp_path):
    """Re-opening the fleet on a WAL that holds every commit replays the
    identical ranks and digest without an iteration; the JAX package's
    fleet replays the port's WAL to the same ranks too (the records are
    its bytes, the apply its numpy)."""
    wal_dir = str(tmp_path / "wal")
    first = rowstore.run_cluster_pagerank(
        powerlaw, rowstore.ClusterPageRankConfig(n_iterations=5,
                                                 wal_dir=wal_dir),
        device="cpu")
    replay = rowstore.run_cluster_pagerank(
        powerlaw, rowstore.ClusterPageRankConfig(n_iterations=5,
                                                 wal_dir=wal_dir),
        device="cpu")
    theirs = jrowstore.run_cluster_pagerank(
        powerlaw, jrowstore.ClusterPageRankConfig(n_iterations=5,
                                                  wal_dir=wal_dir))
    assert replay["version"] == first["version"] == theirs["version"] == 5
    assert replay["ranks"].tobytes() == first["ranks"].tobytes() == \
        theirs["ranks"].tobytes()
    assert replay["event_digest"] == first["event_digest"] == \
        theirs["event_digest"]


#: JAX ``tests/test_rowstore.py:318``'s grid
GRID = [
    ("dense", "cluster:ps@2=kill", "cluster:ps"),
    ("dense", "seed=7;cluster:worker@3=kill", "cluster:worker"),
    ("int8",
     "seed=5;cluster:worker@3=kill;cluster:coordinator@1=kill;"
     "cluster:ps@4=kill;cluster:rpc@2=oserror", "cluster:ps"),
]


@pytest.mark.parametrize("comm,plan,must_fire", GRID)
def test_chaos_rowstore_grid_is_bitwise_and_fires_as_jax(
        tmp_path, comm, plan, must_fire):
    from tpu_distalg.faults import chaos as jchaos
    from tpu_distalg_torch.faults import chaos

    res = chaos.run_chaos("rowstore", get_mesh(data=1, device="cpu"),
                          plan=plan, workdir=str(tmp_path / "port"),
                          comm=comm)
    want = jchaos.run_chaos("rowstore", None, plan=plan,
                            workdir=str(tmp_path / "jax"), comm=comm)
    assert res.equal, res.verdict()
    assert res.fired == want.fired
    assert any(p == must_fire for p, _h, _k in res.fired), res.fired


def test_cli_chaos_rowstore(capsys):
    rc = cli.main(["--device", "cpu", "chaos", "--workload", "rowstore",
                   "--comm", "int8", "--fault-plan", "cluster:ps@2=kill"])
    assert rc == 0
    assert "[chaos] OK: rowstore recovered bitwise-equal" in \
        capsys.readouterr().out


# ------------------------------------------------------------ ALS

def test_fit_rowstore_against_jaxs_under_a_row_budget():
    """JAX ``test_als_rowstore_trains_under_row_budget`` at lam 0.01:
    the pulls and pushes, the budget and the untouched rows are JAX's
    exactly; the rmse history within 4e-6 and U, V within 3e-5 of
    max|U|, max|V| (ROADMAP C's ALS bounds: float64 solves in another
    order)."""
    from tpu_distalg.models import als as jals
    from tpu_distalg_torch.models import als

    cfg = dict(m=48, n=320, k=5, n_iterations=6, lam=0.01, seed=2)
    kw = dict(density=0.03, ps_shards=3, user_block=8,
              model_budget_rows=200)
    res = als.fit_rowstore(als.ALSConfig(**cfg), device="cpu", **kw)
    want = jals.fit_rowstore(jals.ALSConfig(**cfg), **kw)
    for key in ("peak_pull_rows", "sparse_pull_fraction", "rows_pulled",
                "rows_pushed"):
        assert res[key] == want[key], key
    assert res["peak_pull_rows"] <= 200 < 320
    assert np.array_equal(res["row_versions"], want["row_versions"])
    assert (res["row_versions"] == 0).any() and \
        (res["row_versions"] > 0).any()
    assert float(np.max(np.abs(res["rmse_history"]
                               - want["rmse_history"]))) <= 4e-6
    assert res["rmse_history"][-1] < res["rmse_history"][0]
    for name in ("U", "V"):
        assert res[name].shape == want[name].shape
        assert float(np.max(np.abs(res[name] - want[name]))) <= \
            3e-5 * float(np.max(np.abs(want[name])))
    with pytest.raises(RuntimeError, match="model budget"):
        als.fit_rowstore(als.ALSConfig(**cfg), device="cpu",
                         **{**kw, "model_budget_rows": 20})


# ------------------------------------------------------------ report

def test_report_renders_the_rowstore_line(tmp_path, powerlaw):
    """JAX ``test_report_renders_rowstore_line`` on the port's report,
    and the line from a real cluster PageRank's telemetry."""
    from tpu_distalg_torch.telemetry import events, report

    evts = [
        {"ev": "counters", "counters": {
            "rowstore.rows_pulled": 800, "rowstore.pull_rows_dense": 2000,
            "rowstore.rows_pushed": 300, "rowstore.wire_push_bytes": 10_000,
            "rowstore.wire_pull_bytes": 30_000,
            "rowstore.wire_dense_bytes": 200_000,
            "rowstore.rpc_retries": 2}},
        {"ev": "gauge", "name": "rowstore.max_row_staleness", "value": 1},
    ]
    out = report.render(report.summarize(evts))
    assert "rowstore:" in out and "40%" in out
    assert "2 rpc retr" in out and "max row staleness 1" in out
    tdir = tmp_path / "tel"
    events.configure(str(tdir))
    try:
        rowstore.run_cluster_pagerank(
            powerlaw, rowstore.ClusterPageRankConfig(n_iterations=2),
            device="cpu")
    finally:
        events.configure(False)
    assert report.report_main([str(tdir)]) == 0
