"""The port's recovery stack (``faults/``, ``telemetry/supervisor.py``,
``utils/checkpoint.py``) on the CPU, against the JAX package's where a
comparison means something.

  * the registry reads every point of the JAX package, cluster
    serving's ``cluster:replica`` included;
  * ``supervised``: retries only what ``retry_on`` names, re-raises the
    last real error, a deadline becomes ``TimeoutError``, and its events
    are JAX's (JAX ``tests/test_faults.py:172-210``);
  * the ``backend:init`` grid {oserror, hang, corrupt, kill} with a fake
    ``init_fn``: the same fires and value as JAX's ``init_backend``;
    ``fallback="cpu"`` is refused and exhaustion raises;
  * the ``ckpt:write`` and ``ckpt:read`` kinds, quarantine and
    ``restore_newest_with_fallback``;
  * ``run_with_restarts``' policy: configuration errors are not retried,
    ``Preempted`` never spends the budget, a quarantine is free;
  * preemption in process (JAX ``tests/test_faults.py:471-531``): a
    pending request exits at the next boundary after its save with rc
    75, the resumed run equals a straight one bit for bit, and a request
    in the last segment lets the run finish; the SSP window loop alike.

Shapes: breast cancer on 8 emulated shards, 90 SSGD steps in segments
of 30 (JAX's chaos size), and 16 or 32 SSP ticks (windows of 4) on 4
shards.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from tpu_distalg import faults as jfaults
from tpu_distalg.telemetry import events as jevents
from tpu_distalg.telemetry import supervisor as jsupervisor
from tpu_distalg_torch import faults
from tpu_distalg_torch.faults import preempt
from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.telemetry import events, supervisor
from tpu_distalg_torch.utils import checkpoint, datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

#: a kind each non-cluster point takes
POINT_KINDS = {"ckpt:write": "oserror", "ckpt:read": "corrupt",
               "cache:write": "hang", "data:gather": "kill",
               "data:h2d": "oserror", "backend:init": "hang",
               "segment:run": "kill", "shard:straggle": "straggle",
               "shard:leave": "leave"}
CLUSTER_KINDS = {"cluster:worker": "kill", "cluster:rpc": "oserror",
                 "cluster:coordinator": "hang", "cluster:wal": "corrupt",
                 "cluster:replica": "kill", "cluster:ps": "hang"}


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.configure(False)
    jfaults.configure(False)
    preempt.reset()
    events.configure(False)
    jevents.configure(False)


@pytest.fixture(scope="module")
def data():
    return datasets.breast_cancer_split()


def _read_events(directory):
    out = []
    for name in sorted(os.listdir(directory)):
        if name.startswith("events-") and name.endswith(".jsonl"):
            with open(os.path.join(directory, name)) as f:
                out += [json.loads(ln) for ln in f if ln.strip()]
    return out


# ------------------------------------------------------------ registry

def test_points_are_jax_less_the_cluster():
    """Every point of the JAX package has a seam in the port, cluster
    serving's ``cluster:replica`` (``cluster/serve.py``) included: the
    point set is JAX's and every point's plan configures."""
    assert faults.POINTS == jfaults.POINTS
    assert set(faults.POINTS) == set(POINT_KINDS) | set(CLUSTER_KINDS)
    for point, kind in {**POINT_KINDS, **CLUSTER_KINDS}.items():
        assert faults.configure(f"seed=1;{point}@0={kind}") is not None
    faults.configure(False)


@pytest.mark.parametrize("point", sorted(POINT_KINDS))
def test_every_non_cluster_point_is_accepted(point):
    reg = faults.configure(f"seed=1;{point}@0={POINT_KINDS[point]}")
    assert reg is not None and faults.enabled()


@pytest.mark.parametrize("point", sorted(CLUSTER_KINDS))
def test_cluster_points_are_refused_naming_a12(point, monkeypatch):
    """The cluster's points are read (``tpu_distalg_torch/cluster/``,
    ``cluster:replica`` by a serving replica's score seam): a plan with
    one configures from the argument and from the environment, and fires
    on JAX's hit."""
    plan = f"seed=1;ckpt:write@0=oserror;{point}@0={CLUSTER_KINDS[point]}"
    assert faults.configure(plan) is not None and faults.enabled()
    assert faults.active().plan.spec() == \
        jfaults.FaultPlan.parse(plan).spec()
    faults.configure(False)
    monkeypatch.setenv(faults.ENV_PLAN, plan)
    assert faults.configure() is not None


# ---------------------------------------------------------- supervised

def _flaky(n_fail, exc=OSError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n_fail:
            raise exc("transient")
        return "v"
    return fn, calls


def test_supervised_retries_only_retry_on():
    fn, calls = _flaky(2)
    sleeps = []
    assert supervisor.supervised(
        fn, phase="ckpt:write", retries=4, backoff=0.5, backoff_cap=0.5,
        jitter=0.0, retry_on=(OSError,), sleep=sleeps.append,
        log=lambda m: None) == "v"
    assert calls["n"] == 3 and sleeps == [0.5, 0.5]
    fn, calls = _flaky(5, TypeError)
    with pytest.raises(TypeError):
        supervisor.supervised(fn, phase="x", retries=5,
                              retry_on=(OSError,), sleep=lambda s: None,
                              log=lambda m: None)
    assert calls["n"] == 1


def test_supervised_exhaustion_reraises_last_real_error():
    def dead():
        raise OSError("still broken")

    with pytest.raises(OSError, match="still broken"):
        supervisor.supervised(dead, phase="cache:write", retries=2,
                              backoff=0.0, sleep=lambda s: None,
                              log=lambda m: None)


def test_supervised_timeout_without_error_cls_is_timeout_error():
    import time

    with pytest.raises(TimeoutError, match="deadline"):
        supervisor.supervised(lambda: time.sleep(5.0), phase="x",
                              timeout=0.05, retries=0, log=lambda m: None)


def test_supervised_events_are_jax_s(tmp_path):
    """One flaky call under both packages writes the same events, field
    for field but the clock and the process's fields."""
    seqs = []
    for pkg_events, pkg_sup, d in ((events, supervisor, tmp_path / "p"),
                                   (jevents, jsupervisor, tmp_path / "j")):
        pkg_events.configure(str(d))
        fn, _ = _flaky(2)
        pkg_sup.supervised(fn, phase="ckpt:write", retries=2, backoff=0.1,
                           backoff_cap=0.1, jitter=0.0, retry_on=(OSError,),
                           sleep=lambda s: None, log=lambda m: None,
                           failure_counter="ckpt.write_failures")
        pkg_events.configure(False)
        seqs.append([{k: v for k, v in e.items()
                      if k not in ("t_wall", "t_mono", "run", "pid", "host",
                                   "seconds", "argv")}
                     for e in _read_events(d)])
    assert seqs[0] == seqs[1]
    assert [e["ev"] for e in seqs[0]].count("supervised") == 3


# ------------------------------------------------------ backend:init grid

BACKEND_INIT_PLANS = {
    "oserror": ("seed=4;backend:init@0=oserror", None),
    "hang": ("seed=4;backend:init@0=hang:0.3", 0.05),
    "corrupt": ("seed=4;backend:init@0=corrupt", None),
    "kill": ("seed=4;backend:init@0=kill", None),
}


@pytest.mark.parametrize("kind", sorted(BACKEND_INIT_PLANS))
def test_backend_init_grid_matches_jax(kind):
    plan, timeout = BACKEND_INIT_PLANS[kind]
    got = {}
    for name, pkg_faults, pkg_sup in (("port", faults, supervisor),
                                      ("jax", jfaults, jsupervisor)):
        pkg_faults.configure(plan)
        value = pkg_sup.init_backend(
            init_fn=lambda: ["dev0", "dev1"], timeout=timeout, retries=10,
            backoff=0.0, sleep=lambda s: None, log=lambda m: None)
        got[name] = (value, list(pkg_faults.active().fired))
        pkg_faults.configure(False)
    assert got["port"] == got["jax"]
    assert got["port"][1] == [("backend:init", 0, kind)]


def test_init_backend_refuses_the_cpu_fallback():
    with pytest.raises(ValueError, match="no device fallback"):
        supervisor.init_backend(fallback="cpu", init_fn=lambda: "dev")


def test_init_backend_exhaustion_raises_and_a_callable_fallback_runs(
        tmp_path):
    events.configure(str(tmp_path))

    def dead():
        raise OSError("no card")

    with pytest.raises(supervisor.BackendUnavailableError, match="no card"):
        supervisor.init_backend(init_fn=dead, retries=1, backoff=0.0,
                                sleep=lambda s: None, log=lambda m: None)

    def spare():
        return "spare"

    assert supervisor.init_backend(
        init_fn=dead, retries=0, fallback=spare, log=lambda m: None) == "spare"
    events.configure(False)
    evs = [e["ev"] for e in _read_events(tmp_path)]
    assert evs.count("backend_unavailable") == 1
    assert evs.count("degraded") == 1
    assert evs.count("backend_retry") == 1


def test_init_backend_default_resolves_the_device():
    import torch

    assert supervisor.init_backend(device="cpu") == torch.device("cpu")


# ------------------------------------------------ checkpoint write / read

STATE = (np.arange(6, dtype=np.float32).reshape(2, 3), np.int64(7))


def _save(d, step=1):
    return checkpoint.save(str(d), "t", STATE, step,
                           accs=np.ones(3, np.float32))


@pytest.mark.parametrize("kind", ["oserror", "hang"])
def test_ckpt_write_transients_are_absorbed_in_place(kind, tmp_path):
    faults.configure(f"seed=5;ckpt:write@0={kind}:0.01")
    _save(tmp_path)
    assert faults.active().fired == [("ckpt:write", 0, kind)]
    payload, step = checkpoint.restore(str(tmp_path))
    assert step == 1 and payload["tag"] == "t"
    np.testing.assert_array_equal(payload["state"][0], STATE[0])


def test_ckpt_write_corrupt_lands_on_disk_and_is_caught(tmp_path):
    faults.configure("seed=5;ckpt:write@0=corrupt")
    _save(tmp_path)
    faults.configure(False)
    with pytest.raises(checkpoint.CorruptCheckpointError, match="CRC32"):
        checkpoint.restore(str(tmp_path))


def test_ckpt_write_kill_raises_and_leaves_no_file(tmp_path):
    faults.configure("seed=5;ckpt:write@0=kill")
    with pytest.raises(faults.InjectedKill):
        _save(tmp_path)
    assert checkpoint.list_steps(str(tmp_path)) == []
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("kind,err", [
    ("oserror", faults.InjectedOSError),
    ("corrupt", checkpoint.CorruptCheckpointError),
    ("kill", faults.InjectedKill)])
def test_ckpt_read_faults(kind, err, tmp_path):
    _save(tmp_path)
    faults.configure(f"seed=5;ckpt:read@0={kind}")
    with pytest.raises(err):
        checkpoint.restore(str(tmp_path))
    payload, _ = checkpoint.restore(str(tmp_path))   # hit 1: intact
    np.testing.assert_array_equal(payload["state"][0], STATE[0])


def test_quarantine_and_fallback_to_the_older_step(tmp_path):
    _save(tmp_path, 1)
    _save(tmp_path, 2)
    path = os.path.join(tmp_path, "step_2.npz")
    with open(path, "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff\xff\xff")
    payload, step = checkpoint.restore_newest_with_fallback(
        str(tmp_path), logger=lambda m: None)
    assert step == 1 and os.path.exists(path + ".corrupt")
    assert checkpoint.list_steps(str(tmp_path)) == [1]
    assert checkpoint.quarantine(path) is True     # already gone: done
    os.remove(os.path.join(tmp_path, "step_1.npz"))
    assert checkpoint.restore_newest_with_fallback(str(tmp_path)) is None


# --------------------------------------------------- run_with_restarts

@pytest.mark.parametrize("exc", [ValueError, TypeError, FileNotFoundError])
def test_config_errors_are_never_retried(exc):
    calls = {"n": 0}

    def run_once():
        calls["n"] += 1
        raise exc("config")

    with pytest.raises(exc):
        checkpoint.run_with_restarts(run_once, max_restarts=5,
                                     logger=lambda m: None)
    assert calls["n"] == 1


def test_preempted_never_burns_restart_budget():
    calls = {"n": 0}

    def run_once():
        calls["n"] += 1
        raise preempt.Preempted(step=10)

    with pytest.raises(preempt.Preempted):
        checkpoint.run_with_restarts(run_once, max_restarts=5,
                                     logger=lambda m: None)
    assert calls["n"] == 1


def test_quarantine_is_free_and_budget_exhaustion_raises(tmp_path):
    for step in (1, 2, 3):
        _save(tmp_path, step)
    paths = [os.path.join(tmp_path, f"step_{s}.npz") for s in (3, 2)]
    events.configure(str(tmp_path / "tel"))
    calls = {"n": 0}

    def run_once():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise checkpoint.CorruptCheckpointError(paths[calls["n"] - 1],
                                                    "torn")
        if calls["n"] == 3:
            raise RuntimeError("device lost")
        return "done"

    logs = []
    assert checkpoint.run_with_restarts(run_once, max_restarts=1,
                                        logger=logs.append) == "done"
    assert checkpoint.list_steps(str(tmp_path)) == [1]
    assert sum(m.startswith("[restart 1/1]") for m in logs) == 1

    def always():
        raise RuntimeError("still lost")

    with pytest.raises(RuntimeError, match="still lost"):
        checkpoint.run_with_restarts(always, max_restarts=1,
                                     logger=lambda m: None)
    with pytest.raises(checkpoint.CorruptCheckpointError):
        checkpoint.run_with_restarts(
            lambda: (_ for _ in ()).throw(
                checkpoint.CorruptCheckpointError(paths[0], "torn")),
            max_restarts=0)
    events.configure(False)
    evs = [e["ev"] for e in _read_events(tmp_path / "tel")]
    assert evs.count("quarantine") == 2
    assert evs.count("restart") == 2
    assert evs.count("restart_budget_exhausted") == 1


# ------------------------------------------------------------ preemption

def test_preempt_request_exits_at_boundary_and_resumes_bitwise(data,
                                                               tmp_path):
    mesh = get_mesh(data=8, device="cpu")
    cfg = ssgd.SSGDConfig(n_iterations=90)
    d = str(tmp_path / "ck")
    straight = ssgd.train(*data, mesh, cfg)
    preempt.request()
    with pytest.raises(preempt.Preempted) as ei:
        ssgd.train(*data, mesh, cfg, checkpoint_dir=d, checkpoint_every=30)
    assert ei.value.step == 30 and ei.value.code == faults.PREEMPTED_RC
    assert checkpoint.latest_step(d) == 30
    preempt.reset()
    resumed = ssgd.train(*data, mesh, cfg, checkpoint_dir=d,
                         checkpoint_every=30)
    np.testing.assert_array_equal(straight.w.numpy(), resumed.w.numpy())
    np.testing.assert_array_equal(straight.accs.numpy(),
                                  resumed.accs.numpy())


def test_preempt_on_final_segment_completes_normally(data, tmp_path):
    preempt.request()
    res = ssgd.train(*data, get_mesh(data=8, device="cpu"),
                     ssgd.SSGDConfig(n_iterations=30),
                     checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=30)
    assert res.accs.shape == (30,)


def test_ssp_window_loop_exits_75_and_resumes_bitwise(data, tmp_path):
    """``membership.run_elastic`` stops at the window boundary after the
    save, and the resumed run equals a straight one."""
    mesh = get_mesh(data=4, device="cpu")
    cfg = ssgd.SSGDConfig(n_iterations=32, sync="ssp:4")
    d = str(tmp_path / "ck")
    straight = ssgd.train(*data, mesh, cfg)
    preempt.request()
    with pytest.raises(preempt.Preempted) as ei:
        ssgd.train(*data, mesh, cfg, checkpoint_dir=d, checkpoint_every=8)
    assert ei.value.code == 75 and ei.value.step == 8   # 2 windows of 4
    preempt.reset()
    resumed = ssgd.train(*data, mesh, cfg, checkpoint_dir=d,
                         checkpoint_every=8)
    np.testing.assert_array_equal(straight.w.numpy(), resumed.w.numpy())
    np.testing.assert_array_equal(straight.accs.numpy(),
                                  resumed.accs.numpy())


def test_segment_run_fires_per_segment_and_window(data, tmp_path):
    """``segment:run`` counts one invocation per segment (JAX's count),
    and a killed segment resumes bitwise under run_with_restarts."""
    mesh = get_mesh(data=8, device="cpu")
    cfg = ssgd.SSGDConfig(n_iterations=90)
    straight = ssgd.train(*data, mesh, cfg)
    faults.configure("seed=1;segment:run@1=kill")
    got = checkpoint.run_with_restarts(
        lambda: ssgd.train(*data, mesh, cfg,
                           checkpoint_dir=str(tmp_path / "a"),
                           checkpoint_every=30),
        max_restarts=1, logger=lambda m: None)
    assert faults.active().fired == [("segment:run", 1, "kill")]
    assert faults.active().hits("segment:run") == 4
    np.testing.assert_array_equal(straight.w.numpy(), got.w.numpy())
    faults.configure("seed=1;segment:run@*=hang:0.0")
    ssgd.train(*data, get_mesh(data=4, device="cpu"),
               ssgd.SSGDConfig(n_iterations=16, sync="ssp:4"),
               checkpoint_dir=str(tmp_path / "b"), checkpoint_every=8)
    assert faults.active().hits("segment:run") == 2   # 2 segments of 8
