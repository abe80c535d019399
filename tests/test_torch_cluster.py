"""The port's cluster runtime (``tpu_distalg_torch/cluster/``) against the
JAX package's (``tpu_distalg/cluster/``), on the CPU, thread mode.

Every live case runs both packages' clusters on the same config and
plan in the same test (JAX ``tests/test_cluster.py:417-891`` and
``:1036-1212``), and holds the port to JAX's:
  * the merge and membership sequences exactly, through
    ``event_digest`` (plus ``version``, ``gen``, the merge count and the
    respawns);
  * the center within ``CENTER_TOL`` of max|w|: the trainers agree with
    the JAX package's within 1e-5 of max|w| over a few windows, not
    bitwise (ROADMAP C), and a window's delta is a few steps;
    under a compressed wire within ``COMPRESSED_TOL``, because a codec
    turns a last-bit difference into a whole quantization step;
  * the port's own center bitwise where a run is held against another
    port run (a replay, a recovered coordinator against an undisturbed
    one).
The ``cluster:rpc`` storm fires by a live probability on every frame,
so where it lands (and a readmission it may cause) depends on timing in
both packages; there the runs are held to completion and retry evidence,
as JAX's own test holds them.

Mixed clusters are the wire's cross-check: a port worker joins the JAX
coordinator and a JAX worker joins the port's, and each run ends with
the all-JAX run's digest. One process-mode run goes through the command
line with a real ``kill -9``.

Geometry: 3 slots, 8 windows, s 3, 512 + 256 rows × 30 features + bias
(JAX's tests use 1024 rows; the sequences do not depend on the rows,
and half keeps the pair of runs about a second).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tpu_distalg import cluster as jclus
from tpu_distalg import faults as jfaults
from tpu_distalg.cluster import local as jlocal
from tpu_distalg.cluster import transport as jtransport
from tpu_distalg.cluster import worker as jworker
from tpu_distalg.parallel import comms as jcomms
from tpu_distalg_torch import cluster as clus
from tpu_distalg_torch import faults
from tpu_distalg_torch.cluster import local, transport, wal, worker
from tpu_distalg_torch.faults.chaos import SSP_CHAOS_ACC_BAND
from tpu_distalg_torch.parallel import comms
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS, TEST_ROWS = 512, 256
CFG = dict(n_slots=3, n_windows=8, staleness=3, heartbeat_timeout=3.0,
           checkpoint_every=3)
#: the port's center against JAX's, a fraction of max|w|
CENTER_TOL = 1e-5
#: the same under a compressed wire: a codec turns a last-bit difference
#: in a delta into another stochastic rounding or another top-k choice,
#: a whole quantization step of that element (int8: max|delta| / 127)
COMPRESSED_TOL = 1e-3


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.configure(False)
    jfaults.configure(False)


def _config(mod, **over):
    return mod.ClusterConfig(**{
        **CFG, **over,
        "train": mod.TrainTask(n_rows=N_ROWS, test_rows=TEST_ROWS)})


def _run(mod, plan=None, *, checkpoint_dir=None, live=False, **over):
    """One thread-mode cluster of ``mod`` (the port's on the CPU).
    ``live`` also arms the plan in the package's registry (the
    ``cluster:rpc`` seam fires live, not from a compiled schedule)."""
    launch = {k: over.pop(k) for k in ("rejoin_after",) if k in over}
    cfg = _config(mod, plan_spec=plan, checkpoint_dir=checkpoint_dir,
                  **over)
    flt = faults if mod is clus else jfaults
    if live:
        flt.configure(plan)
    try:
        if mod is clus:
            return clus.run_local_cluster(cfg, spawn="thread",
                                          timeout=180.0, device="cpu",
                                          **launch)
        return jclus.run_local_cluster(cfg, spawn="thread", timeout=180.0,
                                       **launch)
    finally:
        if live:
            flt.configure(False)


def _digest(res, mod=clus):
    return (local if mod is clus else jlocal).event_digest(res)


def _hold(port, jax_, tol=CENTER_TOL):
    """The port's run against JAX's on the same config and plan."""
    assert _digest(port) == _digest(jax_, jclus)
    for key in ("version", "gen", "respawns", "restarts"):
        assert port[key] == jax_[key], key
    assert len(port["merge_sequence"]) == len(jax_["merge_sequence"])
    w, jw = port["center"]["w"], jax_["center"]["w"]
    assert w.dtype == jw.dtype == np.float32
    assert np.abs(w - jw).max() <= tol * np.abs(jw).max()


def _pair(tmp_path=None, **kw):
    out = []
    for tag, mod in (("port", clus), ("jax", jclus)):
        if tmp_path is not None:
            kw["checkpoint_dir"] = str(tmp_path / tag)
        out.append(_run(mod, **kw))
    _hold(*out, tol=CENTER_TOL if kw.get("comm", "dense") == "dense"
          else COMPRESSED_TOL)
    return out


@pytest.fixture(scope="module")
def undisturbed():
    return _pair()


def _same_center(a, b):
    assert a["center"]["w"].tobytes() == b["center"]["w"].tobytes()


# ------------------------------------------------------ elastic runs

def test_undisturbed_equals_jax(undisturbed):
    res, _ = undisturbed
    assert res["version"] == 8
    for _w, applied, skipped in res["merge_sequence"]:
        assert applied == ((0, 0), (1, 0), (2, 0)) and skipped == ()
    assert res["membership_sequence"] == [
        ("join", 0, 0), ("join", 1, 0), ("join", 2, 0)]
    assert res["accuracy"] > 0.65
    assert sorted(res["worker_stats"]) == [0, 1, 2]
    assert all(s["pushes"] == 8 for s in res["worker_stats"].values())


def test_kill_one_mid_window_and_rejoin_equals_jax(undisturbed):
    # cell 10 = (window 3, slot 1) at 3 slots
    res, _ = _pair(plan="seed=7;cluster:worker@10=kill", rejoin_after=2)
    assert res["respawns"] == 1
    assert ("leave", 1, 3) in res["membership_sequence"]
    assert ("join", 1, 5) in res["membership_sequence"]
    by_window = {w: a for w, a, _ in res["merge_sequence"]}
    assert by_window[3] == by_window[4] == ((0, 0), (2, 0))
    assert by_window[5] == ((0, 0), (1, 0), (2, 0))
    assert abs(res["accuracy"]
               - undisturbed[0]["accuracy"]) <= SSP_CHAOS_ACC_BAND


def test_straggle_skips_then_delivers_staler_equals_jax():
    """Cell 13 = (window 4, slot 1): a skip at 4, an age-1 delivery at
    5; the straggle runs ``ssp.straggle_work`` on the worker's device."""
    res, _ = _pair(plan="seed=7;cluster:worker@13=straggle:30")
    by_window = {w: (a, s) for w, a, s in res["merge_sequence"]}
    assert by_window[4] == (((0, 0), (2, 0)), (1,))
    assert (1, 1) in by_window[5][0]
    assert res["worker_stats"][1]["skips"] == 1


def test_local_sgd_workers_equal_jax():
    """``algo="local_sgd"``: each window one MA round of s local steps
    (the round id is the sampling key), under a straggle."""
    cfgs = []
    for mod in (clus, jclus):
        cfg = _config(mod, n_windows=6,
                      plan_spec="seed=7;cluster:worker@7=straggle:30")
        cfg.train.algo = "local_sgd"
        cfgs.append(cfg)
    res = clus.run_local_cluster(cfgs[0], spawn="thread", timeout=180.0,
                                 device="cpu")
    _hold(res, jclus.run_local_cluster(cfgs[1], spawn="thread",
                                       timeout=180.0))
    assert res["worker_stats"][1]["skips"] == 1


def test_same_plan_replays_bitwise():
    plan = "seed=7;cluster:worker@10=kill;cluster:worker@22=straggle:30"
    a = _run(clus, plan, rejoin_after=2)
    b = _run(clus, plan, rejoin_after=2)
    assert a["merge_sequence"] == b["merge_sequence"]
    assert a["membership_sequence"] == b["membership_sequence"]
    _same_center(a, b)
    _hold(a, _run(jclus, plan, rejoin_after=2))


def test_straggle_on_final_window_records_the_loss_equals_jax():
    res, _ = _pair(plan="seed=7;cluster:worker@22=straggle:30")
    assert {w: s for w, _, s in res["merge_sequence"]}[7] == (1,)
    assert res["worker_stats"][1]["undelivered_windows"] == 1
    assert res["worker_stats"][0]["undelivered_windows"] == 0


def test_restart_policy_equals_jax(tmp_path):
    res, _ = _pair(tmp_path, plan="seed=7;cluster:worker@10=kill",
                   policy="restart")
    assert res["restarts"] == 1 and res["respawns"] == 0
    assert res["accuracy"] > 0.65


def _late_join(mod):
    cfg = _config(mod, n_windows=10)
    coord = mod.Coordinator(cfg).start()
    thread_worker = (local if mod is clus else jlocal)._ThreadWorker
    kw = {"device": "cpu"} if mod is clus else {}
    try:
        coord.hold_admission(3, 3)
        ws = [thread_worker("127.0.0.1", coord.port, s, **kw)
              for s in (0, 1)]
        deadline = time.monotonic() + 120
        while coord.version < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert coord.version == 3    # the hold stalls the clock there
        ws.append(thread_worker("127.0.0.1", coord.port, 2, **kw))
        res = coord.wait(timeout=120.0)
        for w in ws:
            w.join(timeout=30)
    finally:
        coord.stop()
    return res


def test_late_join_equals_jax():
    res, jres = _late_join(clus), _late_join(jclus)
    assert _digest(res) == _digest(jres, jclus)
    assert res["version"] == 10 and res["gen"] == jres["gen"]
    late = [e for e in res["membership_sequence"]
            if e[0] == "join" and e[1] == 2]
    assert late == [("join", 2, 3)]
    for w, applied, _ in res["merge_sequence"]:
        assert (2 in [s for s, _a in applied]) == (w >= 3)


def _partitioned(mod, tmod):
    """Slot 1 joins over a raw socket and goes silent without closing
    it; the heartbeat scan declares it dead."""
    cfg = _config(mod, n_slots=2, n_windows=6, heartbeat_timeout=1.0)
    coord = mod.Coordinator(cfg).start()
    kw = {"device": "cpu"} if mod is clus else {}
    try:
        w0 = (local if mod is clus else jlocal)._ThreadWorker(
            "127.0.0.1", coord.port, 0, **kw)
        sock = tmod.connect("127.0.0.1", coord.port)
        kind, _, _ = tmod.request(sock, "join", {"slot": 1})
        assert kind == "welcome"
        res = coord.wait(timeout=120.0)
        w0.join(timeout=30)
        sock.close()
    finally:
        coord.stop()
    return res


def test_heartbeat_timeout_detects_partitioned_worker_equals_jax():
    res = _partitioned(clus, transport)
    jres = _partitioned(jclus, jtransport)
    assert res["version"] == jres["version"] == 6
    assert ("leave", 1, 0) in res["membership_sequence"]
    assert res["membership_sequence"] == jres["membership_sequence"]


def _fencing(mod, tmod):
    """A partitioned predecessor's late frames neither act on nor keep
    alive the slot's replacement; returns what each step observed."""
    coord = mod.Coordinator(_config(mod, n_slots=1, n_windows=4,
                                    heartbeat_timeout=30.0)).start()
    seen = []
    try:
        zombie = tmod.connect("127.0.0.1", coord.port)
        kind, meta, _ = tmod.request(zombie, "join", {"slot": 0})
        old_inc = int(meta["incarnation"])
        seen.append((kind, old_inc))
        zombie.close()
        deadline = time.monotonic() + 30
        while coord.slots[0].status == "active" and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        repl = tmod.connect("127.0.0.1", coord.port)
        kind, meta2, _ = tmod.request(repl, "join", {"slot": 0})
        seen.append((kind, int(meta2["incarnation"]) > old_inc))
        late = tmod.connect("127.0.0.1", coord.port)
        k, m, _ = tmod.request(late, "skip", {"slot": 0, "inc": old_inc,
                                              "window": 0})
        seen.append((k, m.get("error")))
        before = coord.slots[0].last_beat
        tmod.request(late, "beat", {"slot": 0, "inc": old_inc})
        seen.append(coord.slots[0].last_beat == before)
        late.close()
        time.sleep(0.2)
        seen.append(coord.slots[0].status)
        repl.close()
    finally:
        coord.stop()
    return seen


def test_zombie_incarnation_is_fenced_equals_jax():
    seen = _fencing(clus, transport)
    assert seen == _fencing(jclus, jtransport)
    assert seen[1:] == [("welcome", True), ("error", "stale slot"), True,
                        "active"]


def test_worker_rpc_raises_on_error_reply(monkeypatch):
    """A fenced-out worker's poll answered ("error", ...) surfaces as a
    link failure, not as data the gate spins on."""
    orig = worker._Link.request

    def poison(self, kind, meta, arrays=None, **kw):
        if kind == "poll":
            return "error", {"error": "stale slot"}, {}
        return orig(self, kind, meta, arrays, **kw)

    monkeypatch.setattr(worker._Link, "request", poison)
    monkeypatch.setattr(worker, "GATE_DEADLINE_SECONDS", 5.0)
    coord = clus.Coordinator(_config(clus, n_slots=1, n_windows=4,
                                     heartbeat_timeout=30.0)).start()
    try:
        with pytest.raises(transport.TransportClosed,
                           match="poll rejected: stale slot"):
            worker.run_worker("127.0.0.1", coord.port, slot=0, admit_at=2,
                              device="cpu")
    finally:
        coord.stop()


@pytest.mark.parametrize("over", [{"policy": "bsp"}, {"n_slots": 0},
                                  {"staleness": 0},
                                  {"pull_refresh_windows": 0},
                                  {"comm": "bucketed"}])
def test_config_refusals_equal_jax(over):
    msgs = []
    for mod in (clus, jclus):
        with pytest.raises(ValueError) as e:
            _config(mod, **over)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_unported_modes_and_devices_refuse(monkeypatch):
    """``rowstore`` configures as in the JAX package (the welcome carries
    it to the workers); a worker or launcher asked for a card that is
    not there raises instead of running on the CPU."""
    assert _config(clus, ps_mode="rowstore").ps_mode == \
        _config(jclus, ps_mode="rowstore").ps_mode == "rowstore"
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        clus.run_local_cluster(_config(clus), spawn="thread")
    with pytest.raises(Exception, match="is_available"):
        worker.run_worker("127.0.0.1", 1, device="cuda")


def test_checkpoint_resume_rejects_foreign_tag(tmp_path):
    from tpu_distalg_torch.utils import checkpoint

    checkpoint.save(str(tmp_path), "ssgd:bsp", [np.zeros(3, np.float32)],
                    4)
    with pytest.raises(ValueError, match="fresh directory"):
        clus.Coordinator(_config(clus, checkpoint_dir=str(tmp_path)))


# ---------------------------------------------- coordinator crashes

def test_coordinator_kill_recovers_bitwise_equals_jax(undisturbed,
                                                      tmp_path):
    """A coordinator kill mid-window (pushes buffered, commit not yet
    durable): respawn on the same port, WAL replay, the workers resume
    their incarnations. The port's center is its undisturbed run's bit
    for bit, and the digest JAX's."""
    res, jres = _pair(tmp_path, plan="seed=7;cluster:coordinator@4=kill",
                      heartbeat_timeout=15.0)
    assert res["coordinator_recoveries"] == jres[
        "coordinator_recoveries"] == 1
    assert len(res["recovery_ms"]) == 1 and res["recovery_ms"][0] > 0
    assert res["wal_records_replayed"] > 0
    assert _digest(res) == _digest(undisturbed[0])
    _same_center(res, undisturbed[0])
    assert sum(s.get("reconnects", 0)
               for s in res["worker_stats"].values()) >= 1
    assert all(s.get("readmissions", 0) == 0
               for s in res["worker_stats"].values())
    # the center checkpoints are the port's npz files, under the WAL
    names = sorted(os.listdir(tmp_path / "port"))
    assert "wal" in names and any(n.endswith(".npz") for n in names)


def test_coordinator_kill_with_straggle_replays_bitwise(tmp_path):
    plan = "seed=7;cluster:coordinator@4=kill;cluster:worker@13=straggle:30"
    a = _run(clus, plan, checkpoint_dir=str(tmp_path / "a"),
             heartbeat_timeout=15.0)
    b = _run(clus, plan, checkpoint_dir=str(tmp_path / "b"),
             heartbeat_timeout=15.0)
    assert a["coordinator_recoveries"] == 1
    assert _digest(a) == _digest(b)
    _same_center(a, b)
    by_window = {w: (ap, sk) for w, ap, sk in a["merge_sequence"]}
    assert by_window[4][1] == (1,) and (1, 1) in by_window[5][0]


def test_coordinator_kill_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _run(clus, "seed=7;cluster:coordinator@4=kill")


def test_recovered_coordinator_keeps_fencing_and_resumes(tmp_path):
    cfg = _config(clus, n_slots=1, n_windows=4,
                  checkpoint_dir=str(tmp_path), heartbeat_timeout=30.0)
    coord = clus.Coordinator(cfg).start()
    sock = transport.connect("127.0.0.1", coord.port)
    kind, meta, _ = transport.request(sock, "join", {"slot": 0})
    inc, gen0 = int(meta["incarnation"]), int(meta["gen"])
    coord.stop()
    sock.close()
    coord2 = clus.Coordinator(cfg).start()
    try:
        assert coord2.recovered
        assert coord2.slots[0].status == "active"
        assert coord2.slots[0].incarnation == inc
        late = transport.connect("127.0.0.1", coord2.port)
        k, m, _ = transport.request(
            late, "skip", {"slot": 0, "inc": inc + 7, "window": 0})
        assert k == "error" and "stale" in m["error"]
        late.close()
        re = transport.connect("127.0.0.1", coord2.port)
        k2, m2, _ = transport.request(
            re, "join", {"slot": 0, "inc": inc, "resume": True})
        assert k2 == "welcome" and m2.get("resume") is True
        assert int(m2["gen"]) == gen0 and int(m2["incarnation"]) == inc
        assert len([e for e in coord2.events if e[0] == "join"]) == 1
        re.close()
    finally:
        coord2.stop()


def test_committed_window_repush_is_deduped_by_digest(tmp_path):
    cfg = _config(clus, n_slots=1, n_windows=4,
                  checkpoint_dir=str(tmp_path), heartbeat_timeout=30.0)
    coord = clus.Coordinator(cfg).start()
    try:
        sock = transport.connect("127.0.0.1", coord.port)
        kind, meta, center = transport.request(sock, "join", {"slot": 0})
        ident = {"slot": 0, "inc": int(meta["incarnation"])}
        delta = {"w": np.full_like(center["w"], 0.25)}
        k, m, arrays = transport.request(
            sock, "push", dict(ident, window=0, base=0), delta)
        assert k == "center" and int(m["version"]) == 1
        after = arrays["w"].copy()
        k2, m2, arrays2 = transport.request(
            sock, "push", dict(ident, window=0, base=0), delta)
        assert k2 == "center" and int(m2["version"]) == 1
        assert np.array_equal(arrays2["w"], after)
        k3, m3, _ = transport.request(
            sock, "push", dict(ident, window=0, base=0),
            {"w": np.full_like(center["w"], 9.0)})
        assert k3 == "error" and "digest" in m3["error"]
        sock.close()
    finally:
        coord.stop()


def test_redial_races_eof_sweep_without_burning_an_epoch():
    cfg = _config(clus, n_slots=1, n_windows=4, heartbeat_timeout=30.0)
    coord = clus.Coordinator(cfg).start()
    try:
        sock = transport.connect("127.0.0.1", coord.port)
        _, meta, _ = transport.request(sock, "join", {"slot": 0})
        inc, gen0 = int(meta["incarnation"]), int(meta["gen"])
        sock.close()
        deadline = time.monotonic() + 10
        while coord.slots[0].suspect_at is None and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        assert coord.slots[0].suspect_at is not None
        re = transport.connect("127.0.0.1", coord.port)
        k, m, _ = transport.request(
            re, "join", {"slot": 0, "inc": inc, "resume": True})
        assert k == "welcome" and m.get("resume") is True
        assert int(m["gen"]) == gen0
        assert coord.slots[0].suspect_at is None
        time.sleep(cfg.reconnect_grace + 0.5)
        assert coord.slots[0].status == "active"
        assert not any(e[0] == "leave" for e in coord.events)
        re.close()
    finally:
        coord.stop()


def test_rpc_oserror_storm_retries_and_completes():
    """Torn connections by a live probability on every frame: both
    packages' links and heartbeats re-dial through it and complete
    (where a fire lands is timing, so the sequences are not held)."""
    retried = 0
    for seed in (3, 5, 9):
        plan = f"seed={seed};cluster:rpc@p0.05=oserror"
        res = _run(clus, plan, live=True, n_windows=6)
        assert res["version"] == 6
        assert _run(jclus, plan, live=True, n_windows=6)["version"] == 6
        retried = sum(s.get("reconnects", 0) + s.get("heartbeat_retries", 0)
                      for s in res["worker_stats"].values())
        if retried:
            break
    assert retried >= 1


def test_heartbeat_link_survives_transient_beat_failures():
    calls = {"n": 0}
    coord = clus.Coordinator(_config(clus, n_slots=1, n_windows=2)).start()
    try:
        def flaky_connect(host, port, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("first dial torn")
            return transport.connect(host, port, **kw)

        stats = {"heartbeat_retries": 0}
        hb = worker._HbLink("127.0.0.1", coord.port, flaky_connect,
                            {"slot": 0, "inc": 0}, 5.0, stats)
        hb.beat()
        assert stats["heartbeat_retries"] == 1 and hb.sock is not None
        hb.beat()
        assert stats["heartbeat_retries"] == 1
        hb.close()
    finally:
        coord.stop()


# ------------------------------------------------- compressed wires

@pytest.fixture(scope="module", params=["int8:5", "topk:0.25"])
def compressed(request):
    return request.param, _pair(comm=request.param)


def test_compressed_wire_equals_jax_and_compresses(compressed,
                                                   undisturbed):
    comm, (res, jres) = compressed
    assert abs(res["accuracy"]
               - undisturbed[0]["accuracy"]) <= SSP_CHAOS_ACC_BAND
    for s in res["worker_stats"].values():
        assert s["pushes"] == s["delta_pulls"] == s["async_pushes"] == 8
        assert s["dense_pulls"] == 0
    for slot, s in res["worker_stats"].items():
        j = jres["worker_stats"][slot]
        assert (s["delta_pulls"], s["dense_pulls"]) == (j["delta_pulls"],
                                                        j["dense_pulls"])


def test_compressed_coordinator_kill_recovers_bitwise(compressed,
                                                      tmp_path):
    comm, (und, _) = compressed
    res = _run(clus, "seed=7;cluster:coordinator@4=kill", comm=comm,
               checkpoint_dir=str(tmp_path), heartbeat_timeout=15.0)
    assert res["coordinator_recoveries"] == 1
    assert _digest(res) == _digest(und)
    _same_center(res, und)
    assert all(s["dense_pulls"] == 0 for s in res["worker_stats"].values())


def test_compressed_rpc_oserror_recovers_bitwise(compressed):
    """One torn connection (hit 40, a live seam): the link resumes and
    re-delivers the same frames, so center and sequences are the
    undisturbed run's, in both packages."""
    comm, (und, jund) = compressed
    plan = "seed=11;cluster:rpc@40=oserror"
    res = _run(clus, plan, live=True, comm=comm)
    assert _digest(res) == _digest(und)
    _same_center(res, und)
    jres = _run(jclus, plan, live=True, comm=comm)
    assert _digest(jres, jclus) == _digest(res)


def test_compressed_seq_spelling_disables_the_overlap():
    res = _run(clus, comm="int8:5@seq")
    assert res["version"] == 8
    for s in res["worker_stats"].values():
        assert s["async_pushes"] == 0 and s["delta_pulls"] == 8


def test_version_delta_pull_falls_back_to_snapshot(tmp_path):
    cfg = _config(clus, n_slots=1, n_windows=6, comm="int8:5",
                  checkpoint_dir=str(tmp_path), heartbeat_timeout=30.0)
    coord = clus.Coordinator(cfg).start()
    try:
        sock = transport.connect("127.0.0.1", coord.port)
        _, meta, center = transport.request(sock, "join", {"slot": 0})
        ident = {"slot": 0, "inc": int(meta["incarnation"])}
        codec = comms.make_host_codec("int8:5")
        delta = {"w": np.full_like(center["w"], 0.125)}
        arrays, _ = comms.encode_tree(codec, delta, None,
                                      comms.PUSH_SEED_TAG, 0, 0)
        k, m, arrs = transport.request(
            sock, "push", dict(ident, window=0, base=0, have=-1), arrays)
        assert k == "center" and m["mode"] == "dense" and int(m["cv"]) == 1
        assert arrs["w"].dtype == np.float32
        arrays2, _ = comms.encode_tree(codec, delta, None,
                                       comms.PUSH_SEED_TAG, 0, 1)
        k2, m2, arrs2 = transport.request(
            sock, "push", dict(ident, window=1, base=1, have=1), arrays2)
        assert k2 == "center" and m2["mode"] == "delta"
        assert int(m2["cv"]) == 2 and arrs2["w.q"].dtype == np.int8
        # the port's codec bytes are the JAX package's
        jarrays, _ = jcomms.encode_tree(jcomms.make_host_codec("int8:5"),
                                        delta, None, jcomms.PUSH_SEED_TAG,
                                        0, 1)
        assert {k: v.tobytes() for k, v in arrays2.items()} == \
            {k: v.tobytes() for k, v in jarrays.items()}
        sock.close()
    finally:
        coord.stop()


def test_pull_refresh_cadence_equals_jax():
    from tpu_distalg_torch.cluster.coordinator import PULL_REFRESH_WINDOWS

    windows = PULL_REFRESH_WINDOWS + 2
    res, _ = _pair(comm="int8:5", n_slots=1, n_windows=windows)
    s = res["worker_stats"][0]
    assert s["pushes"] == windows
    assert (s["dense_pulls"], s["delta_pulls"]) == (1, windows - 1)


def test_wal_commit_records_carry_the_compressed_bytes(tmp_path):
    res = _run(clus, comm="int8:5", n_windows=4,
               checkpoint_dir=str(tmp_path), heartbeat_timeout=15.0)
    assert res["version"] == 4
    wal_dir = os.path.join(str(tmp_path), "wal")
    commits = []
    for b in wal.segment_bases(wal_dir):
        segment, _ = wal.read_segment(wal._segment_path(wal_dir, b))
        commits += [r for r in segment if r[0] == "commit"]
    assert commits
    for _k, meta, arrays in commits:
        for c in meta["contribs"]:
            assert arrays[f"{c['slot']}/w.q"].dtype == np.int8
            assert f"{c['slot']}/w.scale" in arrays
            assert f"{c['slot']}/w" not in arrays


# --------------------------------------------------- mixed clusters

class _Worker:
    """``worker_mod``'s ``run_worker`` on a thread, as the launchers'
    ``_ThreadWorker`` runs it: a kill cell slams its sockets."""

    def __init__(self, worker_mod, tmod, port, slot, **kw):
        self.result = None
        self._lock = threading.Lock()
        self._socks = []

        def connect(*a, **k):
            sock = tmod.connect(*a, **k)
            self._socks.append(sock)
            return sock

        def die():
            for sock in self._socks:
                for fn in (lambda: sock.shutdown(2), sock.close):
                    try:
                        fn()
                    except OSError:
                        pass
            raise worker_mod.WorkerKilled()

        def run():
            try:
                got = worker_mod.run_worker(
                    "127.0.0.1", port, slot=slot, die=die, connect=connect,
                    **kw)
            except worker_mod.WorkerKilled:
                got = "killed"
            with self._lock:
                self.result = got

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()


def _mixed(coord_mod, worker_mod):
    """``coord_mod``'s coordinator with ``worker_mod``'s workers (thread
    mode), under a kill of (window 3, slot 1) rejoining at window 5 and
    a straggle of (window 7, slot 1)."""
    plan = "seed=7;cluster:worker@10=kill;cluster:worker@22=straggle:30"
    coord = coord_mod.Coordinator(_config(coord_mod, plan_spec=plan)).start()
    tmod = transport if worker_mod is worker else jtransport
    kw = {"device": "cpu"} if worker_mod is worker else {}
    try:
        coord.hold_admission(5, 3)
        ws = [_Worker(worker_mod, tmod, coord.port, s, **kw)
              for s in range(3)]
        ws[1].thread.join(timeout=120)
        assert ws[1].result == "killed"
        ws.append(_Worker(worker_mod, tmod, coord.port, 1, rejoin=True,
                          admit_at=5, **kw))
        res = coord.wait(timeout=120.0)
        for w in ws:
            w.thread.join(timeout=30)
    finally:
        coord.stop()
    return res


@pytest.fixture(scope="module")
def all_jax():
    """The mixed clusters' reference: JAX's coordinator and workers."""
    return _mixed(jclus, jworker)


def test_port_worker_joins_jax_coordinator(all_jax):
    res = _mixed(jclus, worker)
    assert res["version"] == all_jax["version"] == 8
    assert _digest(res, jclus) == _digest(all_jax, jclus)


def test_jax_worker_joins_port_coordinator(all_jax):
    res = _mixed(clus, jworker)
    assert res["version"] == 8
    assert _digest(res) == _digest(all_jax, jclus)


# ------------------------------------------------------ process mode

def test_process_mode_kill9_rejoin_digest_equals_thread_mode(tmp_path):
    """``python -m tpu_distalg_torch.cli --device cpu cluster --role
    local --spawn process``: worker processes on the CPU, one killed by
    a real ``kill -9`` at (window 4, slot 1) and its replacement
    admitted at window 7; the result line's digest is the thread-mode
    run's, and ``tda report`` merges the coordinator's and each
    worker's telemetry directory."""
    plan = "seed=7;cluster:worker@13=kill"
    tdir = tmp_path / "tel"
    env = dict(os.environ, TDA_TELEMETRY_DIR="", TDA_FAULT_PLAN="")
    r = subprocess.run(
        [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
         "cluster", "--role", "local", "--spawn", "process",
         "--workers", "3", "--n-windows", "8", "--sync", "ssp:3",
         "--heartbeat-timeout", "10", "--n-rows", str(N_ROWS),
         "--deadline", "240", "--fault-plan", plan,
         "--telemetry-dir", str(tdir)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("cluster_result: ")][-1]
    got = json.loads(line[len("cluster_result: "):])
    cfg = clus.ClusterConfig(
        n_slots=3, n_windows=8, staleness=3, heartbeat_timeout=10.0,
        plan_spec=plan, train=clus.TrainTask(n_rows=N_ROWS))
    want = clus.run_local_cluster(cfg, spawn="thread", timeout=180.0,
                                  device="cpu")
    assert got["respawns"] == want["respawns"] == 1
    assert (got["version"], got["gen"], got["merges"]) == (
        want["version"], want["gen"], len(want["merge_sequence"]))
    assert got["event_digest"] == _digest(want)
    # (the processes' torch thread counts differ from this one's, so
    # their float sums may too: accuracy within a point, not equal)
    assert abs(got["accuracy"] - want["accuracy"]) <= 0.01
    assert sorted(os.listdir(tdir))[0] == "coordinator"
    assert {"worker-0", "worker-1", "worker-2"} <= set(os.listdir(tdir))
    from tpu_distalg_torch.telemetry import report

    lines = []
    assert report.report_main([str(tdir)], out=lines.append) == 0
    text = "\n".join(lines)
    assert "worker-1" in text and "cluster." in text
