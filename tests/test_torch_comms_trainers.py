"""The SGD family's trainers under a sync schedule (``models/ssgd.py``,
``models/local_sgd.py`` and its presets, ``models/logistic_regression.py``
with ``comm`` other than ``dense``) against the JAX package on the CPU,
and the CLI's ``--comm``, ``--sync`` and ``--fault-plan``.

The schedules equal JAX's bitwise on equal inputs
(``tests/test_torch_comms.py``); the trainers' inputs differ by the
order in which the two packages' matrix-vector products add, so runs
are held at 5 steps or rounds within 1e-5 of the largest |w| (1e-4 for
the replicas of a ``topk`` round, whose one-entry selections amplify
that difference), before SGD on the unnormalised breast-cancer features
parts the trajectories. ``fused`` and the local-update ``fused_train``
run only on a TPU in the JAX package, so they are held against the
port's own runs: ``topk:1.0`` sends every entry and equals ``dense``
bitwise, ``bucketed`` within 1e-6, and ``int8`` by the reference
task's band over a full run. The comparison task of ``bench.py``
(4096/1024 normalised rows) converges under every schedule: at 300
iterations the port's final accuracies equal JAX's for all six.
"""

from __future__ import annotations

import os
import dataclasses
import importlib
import re
import warnings

import jax
import numpy as np
import pytest
import torch

from tpu_distalg.models import logistic_regression as jlr
from tpu_distalg.models import ssgd as jssgd
from tpu_distalg.parallel import get_mesh as jget_mesh
from tpu_distalg_torch import cli, faults
from tpu_distalg_torch.models import logistic_regression as lr
from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import checkpoint, datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

FUSED = dict(fused_pack=4, gather_block_rows=32, shuffle_seed=0)
SCHEDULES = ("int8", "topk:0.05", "bucketed")
FAMILY = (("ma", "MAConfig"), ("bmuf", "BMUFConfig"),
          ("easgd", "EASGDConfig"))


@pytest.fixture(autouse=True)
def _clean():
    """The CLI's --fault-plan configures the process-global registry."""
    yield
    faults.configure(False)


@pytest.fixture(scope="module")
def data():
    return datasets.breast_cancer_split()


def _mesh(n):
    return jget_mesh(data=n, devices=jax.devices()[:n])


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # coarse-fraction geometry warn
        return fn(*a, **kw)


def _close(got, want, rel):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


# ------------------------------------------------------------ vs JAX


@pytest.mark.parametrize("comm", SCHEDULES)
@pytest.mark.parametrize("sampler", ["bernoulli", "fused_gather"])
def test_ssgd_under_schedule_equals_jax(data, sampler, comm):
    kw = {} if sampler == "bernoulli" else dict(sampler=sampler, **FUSED)
    want = _quiet(jssgd.train, *data, _mesh(4),
                  jssgd.SSGDConfig(n_iterations=5, comm=comm, **kw))
    got = _quiet(ssgd.train, *data, get_mesh(4, device="cpu"),
                 ssgd.SSGDConfig(n_iterations=5, comm=comm, **kw))
    _close(got.w.numpy(), want.w, 1e-5)
    np.testing.assert_array_equal(got.accs.numpy(), np.asarray(want.accs))


@pytest.mark.parametrize("comm", SCHEDULES)
@pytest.mark.parametrize("sampler", ["bernoulli", "fused_gather"])
@pytest.mark.parametrize("name,cls", FAMILY)
def test_local_family_under_schedule_equals_jax(data, name, cls, sampler,
                                                comm):
    jmod = importlib.import_module(f"tpu_distalg.models.{name}")
    pmod = importlib.import_module(f"tpu_distalg_torch.models.{name}")
    kw = {} if sampler == "bernoulli" else dict(sampler=sampler, **FUSED)
    want = _quiet(jmod.train, *data, _mesh(4), getattr(jmod, cls)(
        n_iterations=5, comm=comm, **kw))
    got = _quiet(pmod.train, *data, get_mesh(4, device="cpu"),
                 getattr(pmod, cls)(n_iterations=5, comm=comm, **kw))
    _close(got.w.numpy(), want.w, 1e-5)
    _close(got.ws.numpy(), want.ws, 1e-4 if comm.startswith("topk")
           else 1e-5)


@pytest.mark.parametrize("comm", SCHEDULES + ("bf16", "hier"))
def test_lr_under_schedule_equals_jax(data, comm):
    want = jlr.train(*data, _mesh(4), jlr.LRConfig(n_iterations=5,
                                                   comm=comm))
    got = lr.train(*data, get_mesh(4, device="cpu"),
                   lr.LRConfig(n_iterations=5, comm=comm))
    _close(got.w.numpy(), want.w, 1e-5)
    np.testing.assert_array_equal(got.accs.numpy(), np.asarray(want.accs))


def test_comparison_task_band_equals_jax():
    """bench.py's converging comparison task at 150 iterations, the
    shortest run that shows the band: every schedule's final accuracy
    equals JAX's and lies within 2/1024 of dense (measured on the CPU at
    1500 iterations: JAX and the port both end at 0.765625 for dense,
    0.764648 bf16, 0.767578 topk — a spread of 0.00293)."""
    X, y = datasets.synthetic_two_class(4096 + 1024, 30, seed=0)
    X = datasets.add_bias_column(X)
    task = (X[:4096], y[:4096], X[4096:], y[4096:])
    accs = {}
    for comm in ("dense", "bucketed", "bf16", "int8", "topk", "hier"):
        want = jssgd.train(*task, _mesh(4), jssgd.SSGDConfig(
            n_iterations=150, comm=comm, eval_every=15))
        got = ssgd.train(*task, get_mesh(4, device="cpu"), ssgd.SSGDConfig(
            n_iterations=150, comm=comm, eval_every=15))
        assert got.final_acc == want.final_acc, comm
        accs[comm] = got.final_acc
    assert max(abs(a - accs["dense"]) for a in accs.values()) <= 2 / 1024


# ---------------------------------------------- replay and checkpoints


@pytest.mark.parametrize("comm", ["topk:0.05", "int8"])
@pytest.mark.parametrize("kind", ["ssgd", "ssgd_fused_gather", "ma", "lr"])
def test_replay_and_segmented_equal_straight(data, tmp_path, kind, comm):
    """A replay is bitwise; a run in segments equals a straight one
    bitwise, the topk residual carried in the checkpoint (and nonzero
    there)."""
    m4 = get_mesh(4, device="cpu")
    if kind.startswith("ssgd"):
        kw = dict(sampler="fused_gather", **FUSED) if "fused" in kind else {}
        mod, cfg = ssgd, ssgd.SSGDConfig(n_iterations=40, comm=comm, **kw)
    elif kind == "ma":
        from tpu_distalg_torch.models import ma

        mod, cfg = ma, ma.MAConfig(n_iterations=12, comm=comm)
    else:
        mod, cfg = lr, lr.LRConfig(n_iterations=40, comm=comm)
    every = cfg.n_iterations // 4
    a = _quiet(mod.train, *data, m4, cfg)
    b = _quiet(mod.train, *data, m4, cfg)
    d = str(tmp_path / "ck")
    c = _quiet(mod.train, *data, m4, cfg, checkpoint_dir=d,
               checkpoint_every=every)
    for r in (b, c):
        assert torch.equal(r.w, a.w)
        assert torch.equal(r.accs, a.accs)
    payload, step = checkpoint.restore(d)
    assert step == cfg.n_iterations
    assert f"comm={comm}" in payload["tag"]
    res = payload["state"][-1]
    assert res.shape[0] == 4
    assert (res.shape[1] > 0 and np.abs(res).max() > 0) == \
        comm.startswith("topk")
    # a resume from the half-way checkpoint continues to the same end
    d2 = str(tmp_path / "half")
    _quiet(mod.train, *data, m4, dataclasses.replace(
        cfg, n_iterations=cfg.n_iterations // 2), checkpoint_dir=d2,
        checkpoint_every=every)
    e = _quiet(mod.train, *data, m4, cfg, checkpoint_dir=d2,
               checkpoint_every=every)
    assert torch.equal(e.w, a.w)


def test_schedule_checkpoint_refuses_another_schedule(data, tmp_path):
    m4 = get_mesh(4, device="cpu")
    d = str(tmp_path / "ck")
    ssgd.train(*data, m4, ssgd.SSGDConfig(n_iterations=8, comm="topk:0.05"),
               checkpoint_dir=d, checkpoint_every=4)
    with pytest.raises(ValueError, match="incompatible"):
        ssgd.train(*data, m4, ssgd.SSGDConfig(n_iterations=16, comm="int8"),
                   checkpoint_dir=d, checkpoint_every=4)


# ---------------------------------- paths the JAX package runs on a TPU


@pytest.mark.parametrize("sampler", ["fused", "fused_train"])
def test_tpu_only_paths_against_the_ports_dense_run(data, sampler):
    """``fused`` (SSGD) and ``fused_train`` (MA): ``topk:1.0`` sends
    every entry, so it equals dense bitwise; ``bucketed`` adds the ring's
    way, within 1e-6 of the largest |w| after 40 steps (3 rounds of MA:
    its 5 local steps a round amplify a difference in the last bit to
    5% of |w| by round 40)."""
    m4 = get_mesh(4, device="cpu")
    if sampler == "fused":
        mod = ssgd

        def cfg(comm):
            return ssgd.SSGDConfig(n_iterations=40, sampler="fused",
                                   fused_pack=4, fused_block_rows=64,
                                   comm=comm)
    else:
        from tpu_distalg_torch.models import ma as mod

        def cfg(comm):
            return mod.MAConfig(n_iterations=3, sampler="fused_train",
                                comm=comm, **FUSED)
    dense = _quiet(mod.train, *data, m4, cfg("dense"))
    full = _quiet(mod.train, *data, m4, cfg("topk:1.0"))
    ring = _quiet(mod.train, *data, m4, cfg("bucketed"))
    assert torch.equal(full.w, dense.w)
    _close(ring.w.numpy(), dense.w.numpy(), 1e-6)


@pytest.mark.parametrize("sampler,band", [("fused", 0.92),
                                          ("fused_train", 0.85)])
def test_tpu_only_paths_reach_the_band_under_int8(data, sampler, band):
    """Under int8 on 4 shards the reference task reaches the JAX
    package's band (SSGD 0.92, first at step 273 of 400; MA the
    reference's golden 0.853801, first at round 7 of 100)."""
    m4 = get_mesh(4, device="cpu")
    if sampler == "fused":
        res = ssgd.train(*data, m4, ssgd.SSGDConfig(
            n_iterations=400, sampler="fused", fused_pack=4,
            fused_block_rows=64, comm="int8"))
    else:
        from tpu_distalg_torch.models import ma

        res = _quiet(ma.train, *data, m4, ma.MAConfig(
            n_iterations=100, sampler="fused_train", gather_block_rows=64,
            fused_pack=4, shuffle_seed=0, comm="int8"))
    assert float(res.accs.max()) >= band


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("kw", [dict(sampler="fused_train"),
                                dict(sampler="fixed"),
                                dict(use_pallas=True)])
def test_schedule_refusals_in_jax_words(data, kw):
    cfg = dict(n_iterations=4, comm="int8", **kw)
    with pytest.raises(ValueError) as want:
        jssgd.train(*data, _mesh(4), jssgd.SSGDConfig(**cfg))
    with pytest.raises(ValueError) as got:
        ssgd.train(*data, get_mesh(4, device="cpu"), ssgd.SSGDConfig(**cfg))
    assert str(got.value) == str(want.value)


def test_no_a9_refusal_left(data):
    """Every schedule and sync spelling trains (no NotImplementedError
    naming ROADMAP A9)."""
    m2 = get_mesh(2, device="cpu")
    for comm in ("dense", "bucketed:8", "hier", "bf16", "int8:3@seq",
                 "topk:0.2@ov"):
        ssgd.train(*data, m2, ssgd.SSGDConfig(n_iterations=2, comm=comm,
                                              sync="ssp:2"))
        lr.train(*data, m2, lr.LRConfig(n_iterations=2, comm=comm))


# ----------------------------------------------------------------- CLI


def _cli(capsys, *argv):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli.main(["--device", "cpu", *argv]) == 0
    return capsys.readouterr()


LINES = (r"^Final acc: \d\.\d{6}$",
         r"^\[(ssgd|ma|lr)\] \d+ iterations in \d+\.\d{3}s "
         r"\(\d+\.\d steps/s\)$")


@pytest.mark.parametrize("argv", [
    ("ssgd", "--n-slices", "4", "--sampler", "fused_gather", "--fused-pack",
     "4", "--gather-block-rows", "32", "--shuffle-seed", "0", "--comm",
     "int8", "--quiet"),
    ("ssgd", "--n-slices", "4", "--sync", "ssp:4", "--fault-plan",
     "seed=7;shard:straggle@p0.25=straggle:8", "--quiet"),
    ("ma", "--n-slices", "4", "--comm", "topk:0.05", "--quiet"),
    ("lr", "--comm", "bf16", "--quiet")])
def test_cli_prints_the_jax_summary_lines(capsys, argv):
    """Each command runs and prints JAX's two summary lines (its
    ``_report_optimizer`` format) and nothing else on stdout."""
    out = _cli(capsys, *argv).out.strip().splitlines()
    assert len(out) == 2, out
    for line, pat in zip(out, LINES):
        assert re.match(pat, line), line


def test_cli_fault_plan_refuses_a_point_without_seam(capsys):
    with pytest.raises(SystemExit, match="ROADMAP A12"):
        cli.main(["--device", "cpu", "ssgd", "--n-iterations", "2",
                  "--fault-plan", "seed=1;ckpt:write@1=oserror"])
    with pytest.raises(SystemExit, match="ROADMAP A12"):
        cli.main(["--device", "cpu", "lr", "--max-restarts", "1"])


PLAN = "seed=7;shard:straggle@p0.25=straggle:8"


@pytest.mark.parametrize("argv,env", [
    (("ssgd", "--n-iterations", "2", "--fault-plan", PLAN), False),
    (("ma", "--n-iterations", "2", "--comm", "int8", "--fault-plan",
      PLAN), False),
    (("lr", "--n-iterations", "2", "--fault-plan", PLAN), False),
    (("mc", "--n", "1000"), True),
    (("kmeans", "--n-iterations", "1"), True)],
    ids=["ssgd-bsp", "ma-bsp", "lr", "mc-env", "kmeans-env"])
def test_cli_refuses_a_plan_the_run_never_reads(argv, env, monkeypatch):
    """Only the SSP runs of SSGD and the local-update family compile a
    plan: elsewhere a plan, from --fault-plan or $TDA_FAULT_PLAN, exits
    before training, naming ROADMAP A12."""
    if env:
        monkeypatch.setenv(faults.ENV_PLAN, PLAN)
    with pytest.raises(SystemExit, match="reads no fault plan.*ROADMAP A12"):
        cli.main(["--device", "cpu", *argv])
