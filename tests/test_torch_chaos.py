"""The port's chaos harness (``tpu_distalg_torch/faults/chaos.py``, ``tda
chaos``) held against the JAX package's on the CPU.

For each plan of JAX's fault grid (``tests/test_faults.py:221-420``:
the ``ckpt:write``, ``cache:write``, ``data:gather`` and SSP tables and
the replay plan), and for one plan on each workload the grid leaves out
(``ssgd``, ``kmeans``, ``als``, ``pagerank_stream``, ``serve``), both
packages run the workload undisturbed and under the plan on the same
shard count. The port's verdict must be ``equal``, its ``fired`` list
JAX's item for item and its restart count JAX's. Every seam fires on the
invocation JAX's fires on, so the lists agree exactly. One cell is not
equal in either package: SSP's "both" plan (JAX marks it slow) ends
outside the band, by the same margin in both, and is held to JAX's
verdict.

Final leaves: a recovered run equals its undisturbed run bit for bit
(that is the verdict), so the port's undisturbed leaves are held to
JAX's undisturbed leaves, computed once per workload in a module
fixture, within the standards the parity tests state (ROADMAP C): LR
and SSGD w within 1e-4 of max|w| with equal accuracy histories, k-means
rtol 5e-6 + atol 1e-5, ALS the rmse history within 4e-6 and U, V within
3e-5 of their largest entry, PageRank rtol 1e-5 + atol 1e-8, served LR
replies within 1e-6. The SSP workload's faults change its trajectory,
so there both packages' runs under the plan are compared.

Shapes are JAX's chaos defaults: breast cancer on 8 shards (60 LR
steps, 90 SSGD), 4000 mixture points, ALS 100 × 500 rank 10 for 6
sweeps, 4096 virtual points on 4 shards, a 2048-vertex power-law graph,
SSP 64 or 96 ticks on 4 shards.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from tpu_distalg import faults as jfaults
from tpu_distalg.faults import chaos as jchaos
from tpu_distalg.utils import checkpoint as jckpt
from tpu_distalg_torch import cli, faults
from tpu_distalg_torch.faults import chaos
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import checkpoint
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

CKPT_WRITE_PLANS = {
    "oserror": "seed=5;ckpt:write@1=oserror",
    "hang": "seed=5;ckpt:write@1=hang:0.05",
    "corrupt": "seed=5;ckpt:write@1=corrupt;segment:run@2=kill",
    "kill": "seed=5;ckpt:write@1=kill",
}
CACHE_WRITE_PLANS = {
    "oserror": "seed=6;cache:write@0=oserror",
    "hang": "seed=6;cache:write@0=hang:0.05",
    "corrupt": "seed=6;cache:write@0=corrupt",
    "kill": "seed=6;cache:write@0=kill",
}
DATA_GATHER_PLANS = {
    "oserror": "seed=8;data:gather@1=oserror",
    "hang": "seed=8;data:gather@1=hang:0.3",
    "corrupt": "seed=8;data:gather@1=corrupt",
    "kill": "seed=8;data:gather@1=kill",
}
#: plan and run length per SSP grid cell. JAX marks "both" slow, and
#: there both packages end outside the band by the same margin (their
#: replays are bitwise, their tail accuracies equal): the case holds
#: the port to JAX's verdict (ROADMAP C)
SSP_BOTH_VERDICT = ["band:tail_acc (|Δ|=0.1350 > 0.12)"]
SSP_PLANS = {
    "straggle": ("seed=9;shard:straggle@p0.2=straggle:25", 64),
    "leave": ("seed=9;shard:leave@p0.04=leave:2", 96),
    "both": ("seed=9;shard:straggle@p0.15=straggle:25;"
             "shard:leave@p0.04=leave:2", 96),
}
REPLAY_PLAN = "seed=13;ckpt:write@1=oserror;segment:run@2=kill"
#: one plan on each workload the grid leaves out (chip_smoke.py phase 17
#: runs the same ones on the card), and its shard count
WORKLOAD_PLANS = {
    "ssgd": ("seed=13;ckpt:write@1=oserror;segment:run@2=kill", 8),
    "kmeans": ("seed=5;ckpt:write@1=corrupt;segment:run@2=kill", 8),
    "als": ("seed=5;ckpt:write@1=kill;ckpt:read@0=oserror", 8),
    "pagerank_stream": ("seed=8;data:gather@3=oserror;segment:run@1=kill",
                        4),
    "serve": ("seed=3;ckpt:read@0=corrupt;data:gather@2=oserror", 8),
}


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.configure(False)
    jfaults.configure(False)


def _jmesh(n, request):
    return request.getfixturevalue({8: "mesh8", 4: "mesh4"}[n])


def _pmesh(n):
    return get_mesh(data=n, device="cpu")


_UNDISTURBED: dict = {}


def _undisturbed(workload, n, request, tmp_path_factory, *, plan=None,
                 n_iterations=None, checkpoint_every=None):
    """(port leaves, JAX leaves) of one run each, cached per module: the
    undisturbed run, or with ``plan`` the run under it."""
    key = (workload, n, plan, n_iterations)
    if key not in _UNDISTURBED:
        out = []
        for pkg, pkg_faults, mesh in (
                (chaos, faults, _pmesh(n)),
                (jchaos, jfaults, _jmesh(n, request))):
            work = tmp_path_factory.mktemp("leaves")
            run = pkg._make_runner(workload, mesh, n_iterations,
                                   checkpoint_every, str(work))
            pkg_faults.configure(plan if plan else False)
            try:
                res = run(str(work / "ck"))
            finally:
                pkg_faults.configure(False)
            out.append(pkg._leaves(workload, res))
        _UNDISTURBED[key] = tuple(out)
    return _UNDISTURBED[key]


def _close(what, got, want, *, rtol=0.0, atol=0.0, of_max=None):
    if of_max is not None:
        atol = of_max * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _hold_leaves(workload, port, jax_):
    if workload in ("lr", "ssgd", "ssp"):
        _close("w", port["w"], jax_["w"], of_max=1e-4)
        np.testing.assert_array_equal(port["accs"], jax_["accs"])
    elif workload in ("kmeans", "kmeans_stream"):
        _close("centers", port["centers"], jax_["centers"], rtol=5e-6,
               atol=1e-5)
    elif workload == "als":
        _close("rmse", port["rmse_history"], jax_["rmse_history"],
               atol=4e-6)
        for name in ("U", "V"):
            _close(name, port[name], jax_[name], of_max=3e-5)
    elif workload == "pagerank_stream":
        _close("ranks", port["ranks"], jax_["ranks"], rtol=1e-5, atol=1e-8)
    elif workload == "serve":
        _close("replies", port["replies"], jax_["replies"], atol=1e-6)


def _both(workload, n, plan, request, tmp_path, *, verdict=(), **kw):
    """Each package's run_chaos on one workload, plan and shard count;
    ``verdict`` is the mismatch list both must give (none: equal)."""
    got = chaos.run_chaos(workload, _pmesh(n), plan=plan,
                          workdir=str(tmp_path / "port"), **kw)
    want = jchaos.run_chaos(workload, _jmesh(n, request), plan=plan,
                            workdir=str(tmp_path / "jax"), **kw)
    assert got.fired, "the plan never fired — the grid cell is untested"
    assert got.mismatched == want.mismatched == list(verdict), (
        got.verdict(), want.verdict())
    assert got.equal == (not verdict)
    assert got.fired == want.fired
    assert got.restarts_logged == want.restarts_logged
    return got


@pytest.mark.parametrize("kind", sorted(CKPT_WRITE_PLANS))
def test_chaos_ckpt_write_matches_jax(kind, request, tmp_path,
                                      tmp_path_factory):
    _both("lr", 8, CKPT_WRITE_PLANS[kind], request, tmp_path)
    _hold_leaves("lr", *_undisturbed("lr", 8, request, tmp_path_factory))


@pytest.mark.parametrize("kind", sorted(CACHE_WRITE_PLANS))
def test_chaos_cache_write_matches_jax(kind, tmp_path):
    from tpu_distalg.data import cache as jcache
    from tpu_distalg_torch.data import cache as pcache

    def make_build(mod):
        def build(path):
            header = mod.make_header(
                layout="points_valid_f32", dtype=np.float32, shape=(64, 5),
                geom={"seed": 1})

            def write_bin(mm):
                mm[:] = np.arange(64 * 5, dtype=np.float32).reshape(64, 5)

            return mod.build_cache(path, header=header, write_bin=write_bin)
        return build

    out = {}
    for name, mod, pkg_faults, ck in (("port", pcache, faults, checkpoint),
                                      ("jax", jcache, jfaults, jckpt)):
        build = make_build(mod)
        ref_mm, _ = build(str(tmp_path / name / "ref"))
        pkg_faults.configure(CACHE_WRITE_PLANS[kind])
        logs = []
        got_mm, _ = ck.run_with_restarts(
            lambda: build(str(tmp_path / name / "chaos")), max_restarts=2,
            logger=logs.append)
        fired = list(pkg_faults.active().fired)
        pkg_faults.configure(False)
        np.testing.assert_array_equal(np.asarray(ref_mm), np.asarray(got_mm))
        out[name] = (fired, len(logs), np.asarray(got_mm).copy())
    assert out["port"][0] == out["jax"][0] == [("cache:write", 0, kind)]
    assert out["port"][1] == out["jax"][1]
    np.testing.assert_array_equal(out["port"][2], out["jax"][2])


@pytest.mark.parametrize("kind", sorted(DATA_GATHER_PLANS))
def test_chaos_data_gather_matches_jax(kind, request, tmp_path,
                                       tmp_path_factory):
    got = _both("kmeans_stream", 4, DATA_GATHER_PLANS[kind], request,
                tmp_path)
    if kind == "hang":
        assert got.restarts_logged == 0  # waited, not killed
    _hold_leaves("kmeans_stream",
                 *_undisturbed("kmeans_stream", 4, request, tmp_path_factory))


@pytest.mark.parametrize("kind", sorted(SSP_PLANS))
def test_chaos_ssp_grid_matches_jax(kind, request, tmp_path,
                                    tmp_path_factory):
    plan, iters = SSP_PLANS[kind]
    _both("ssp", 4, plan, request, tmp_path, n_iterations=iters,
          checkpoint_every=iters // 4,
          verdict=SSP_BOTH_VERDICT if kind == "both" else ())
    _hold_leaves("ssp", *_undisturbed(
        "ssp", 4, request, tmp_path_factory, plan=plan, n_iterations=iters,
        checkpoint_every=iters // 4))


def test_replay_plan_matches_jax(request, tmp_path, tmp_path_factory):
    got = _both("lr", 8, REPLAY_PLAN, request, tmp_path)
    again = chaos.run_chaos("lr", _pmesh(8), plan=REPLAY_PLAN,
                            workdir=str(tmp_path / "again"))
    assert again.fired == got.fired == [("ckpt:write", 1, "oserror"),
                                        ("segment:run", 2, "kill")]
    _hold_leaves("lr", *_undisturbed("lr", 8, request, tmp_path_factory))


@pytest.mark.parametrize("workload", sorted(WORKLOAD_PLANS))
def test_each_workload_matches_jax(workload, request, tmp_path,
                                   tmp_path_factory):
    plan, n = WORKLOAD_PLANS[workload]
    _both(workload, n, plan, request, tmp_path)
    _hold_leaves(workload,
                 *_undisturbed(workload, n, request, tmp_path_factory))


def test_cli_chaos_subcommand(tmp_path, capsys):
    assert cli.main(["--device", "cpu", "chaos", "--workload", "lr",
                     "--n-slices", "8", "--n-iterations", "40",
                     "--checkpoint-every", "20", "--workdir", str(tmp_path),
                     "--fault-plan", "seed=1;ckpt:write@0=oserror"]) == 0
    assert "[chaos] OK" in capsys.readouterr().out


def test_cli_chaos_mismatch_is_rc_1_and_keeps_the_workdir(monkeypatch,
                                                          capsys):
    """A broken recovery path (here: leaves forced apart) gives rc 1 and
    keeps the temporary work directory for inspection."""
    real = chaos._leaves
    seen = {"n": 0}

    def drift(workload, res):
        out = real(workload, res)
        seen["n"] += 1
        if seen["n"] == 2:
            out = {k: v + 1 for k, v in out.items()}
        return out

    monkeypatch.setattr(chaos, "_leaves", drift)
    rc = cli.main(["--device", "cpu", "chaos", "--workload", "lr",
                   "--n-slices", "2", "--n-iterations", "20",
                   "--checkpoint-every", "10",
                   "--fault-plan", "seed=1;ckpt:write@0=oserror"])
    assert rc == 1
    captured = capsys.readouterr()
    assert "[chaos] MISMATCH: lr diverged in w, accs" in captured.out
    kept = captured.err.split("scratch kept for debugging: ")[1].strip()
    assert os.path.isdir(kept)
    import shutil

    shutil.rmtree(kept)


def test_cli_chaos_requires_a_plan(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    with pytest.raises(SystemExit, match="fault schedule"):
        cli.main(["--device", "cpu", "chaos", "--workload", "lr"])


@pytest.mark.parametrize("workload", chaos.CLUSTER_WORKLOADS)
def test_cluster_workloads_refuse_naming_a12(workload, tmp_path):
    assert workload in chaos.WORKLOADS
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        chaos.run_chaos(workload, _pmesh(1), plan="seed=1",
                        workdir=str(tmp_path))
    with pytest.raises(SystemExit, match="ROADMAP A12"):
        cli.main(["--device", "cpu", "chaos", "--workload", workload,
                  "--fault-plan", "seed=1;segment:run@0=kill"])


@pytest.mark.parametrize("flag", [["--spawn", "process"],
                                  ["--comm", "int8"]])
def test_cli_chaos_refuses_the_cluster_options(flag):
    """``--spawn`` and ``--comm`` set the cluster workloads' workers and
    wire; with no cluster runtime a non-default value is refused, not
    ignored."""
    with pytest.raises(SystemExit, match="--spawn and --comm.*ROADMAP A12"):
        cli.main(["--device", "cpu", "chaos", "--workload", "lr", *flag,
                  "--fault-plan", "seed=1;segment:run@0=kill"])
