"""The port's stale-synchronous layer (``tpu_distalg_torch/parallel/
ssp.py``, ``membership.py``, ``faults/registry.py`` and the SSP paths of
``models/ssgd.py`` and ``models/local_sgd.py``) against the JAX
package's ``tests/test_ssp.py`` behaviours on the CPU.

The schedules (straggle cells, membership epochs) are compiled from the
same plan in the same probe order, so they are compared exactly. The
SSP window loop is driven on both sides from the same state over the
same straggle schedule: its integers (clocks, pending flags, base
generations, gated counts, age traces) are compared exactly; the
weights within 1e-5 of the largest |w| (the two packages' matrix-vector
products add in other orders). Replay, segmented = straight, resume and
the s = 1 parity are the port's own, bitwise.
"""

from __future__ import annotations

import importlib
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from tpu_distalg import faults as jfaults
from tpu_distalg.models import easgd as jeasgd
from tpu_distalg.models import ssgd as jssgd
from tpu_distalg.parallel import get_mesh as jget_mesh
from tpu_distalg.parallel import membership as jmembership
from tpu_distalg.parallel import parallelize as jparallelize
from tpu_distalg.parallel import partition as jpartition
from tpu_distalg.parallel import ssp as jssp
from tpu_distalg_torch import faults
from tpu_distalg_torch.models import bmuf, easgd, ma, ssgd
from tpu_distalg_torch.parallel import get_mesh, membership, parallelize
from tpu_distalg_torch.parallel import ssp as pssp
from tpu_distalg_torch.telemetry import events
from tpu_distalg_torch.utils import datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

STRAGGLE_PLAN = "seed=7;shard:straggle@p0.2=straggle:25"
FULL_PLAN = STRAGGLE_PLAN + ";shard:leave@p0.05=leave:2"
BENCH_PLAN = "seed=7;shard:straggle@p0.25=straggle:800"
FUSED = dict(fused_pack=4, gather_block_rows=32, shuffle_seed=0)


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.configure(False)
    jfaults.configure(False)
    events.configure(False)


@pytest.fixture(scope="module")
def data():
    return datasets.breast_cancer_split()


def _mesh(n):
    return jget_mesh(data=n, devices=jax.devices()[:n])


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # coarse-fraction geometry warn
        return fn(*a, **kw)


# ------------------------------------------------------- specs, grids


@pytest.mark.parametrize("text", [None, "", "bsp", "ssp", "ssp:8",
                                  "ssp:8:0.7", "ssp::0.25", "ssp:1:1.0"])
def test_syncspec_parse_equals_jax(text):
    want, got = jssp.SyncSpec.parse(text), pssp.SyncSpec.parse(text)
    assert (got.mode, got.staleness, got.decay, got.is_ssp, got.spec()) == \
        (want.mode, want.staleness, want.decay, want.is_ssp, want.spec())
    assert pssp.SyncSpec.parse(got) is got


@pytest.mark.parametrize("text", ["asp", "bsp:8", "ssp:0", "ssp:4:0",
                                  "ssp:4:1.5", "ssp:4:0.5:1"])
def test_syncspec_errors_in_jax_words(text):
    with pytest.raises(ValueError) as want:
        jssp.SyncSpec.parse(text)
    with pytest.raises(ValueError) as got:
        pssp.SyncSpec.parse(text)
    assert str(got.value) == str(want.value)


def test_window_grid_weights_and_tick_expansion_equal_jax():
    for n, s in ((0, 4), (1, 4), (15, 4), (16, 4), (1500, 8), (7, 1)):
        assert pssp.window_grid(n, s) == jssp.window_grid(n, s)
    ages = np.array([0, 1, 3, 2, 5], np.int32)
    act = np.array([True, True, False, True, True])
    took = np.array([True, False, True, True, True])
    for decay in (0.5, 1.0):
        want = np.asarray(jssp.staleness_weights(
            jax.numpy.asarray(ages), jax.numpy.asarray(act),
            jax.numpy.asarray(took), decay))
        got = pssp.staleness_weights(torch.from_numpy(ages),
                                     torch.from_numpy(act),
                                     torch.from_numpy(took), decay)
        np.testing.assert_array_equal(got.numpy(), want)
    wa = np.array([0.5, 0.75, 0.8], np.float32)
    for s, n in ((4, 12), (4, 10), (4, 0), (1, 3)):
        np.testing.assert_array_equal(
            ssgd.window_accs_to_ticks(wa, s, n),
            jssgd.window_accs_to_ticks(wa, s, n))
    stats = ([1.0, 3.0], [0.5, 1.25])
    assert pssp.observed_staleness(*stats) == jssp.observed_staleness(*stats)


# --------------------------------------------------- plans, schedules


@pytest.mark.parametrize("plan", [BENCH_PLAN,
                                  BENCH_PLAN.replace("seed=7", "seed=3"),
                                  "seed=11;shard:straggle@p0.15=straggle:30",
                                  "seed=2;shard:straggle@5=straggle;"
                                  "shard:straggle@p0.5=straggle:3"])
def test_straggle_schedule_equals_jax(plan):
    """The (ticks, shards) schedule equals JAX's exactly, compiled from
    an explicit plan and from the configured one (which also mirrors
    the fires into the live ledger)."""
    want = jssp.compile_straggle_schedule(
        200, 4, plan=jfaults.FaultPlan.parse(plan))
    got = pssp.compile_straggle_schedule(200, 4,
                                         plan=faults.FaultPlan.parse(plan))
    np.testing.assert_array_equal(got, want)
    reg = faults.configure(plan)
    np.testing.assert_array_equal(pssp.compile_straggle_schedule(200, 4),
                                  want)
    assert reg.hits("shard:straggle") == 0
    assert len(reg.fired) == int(np.count_nonzero(want))


@pytest.mark.parametrize("plan,n_win,n", [
    ("seed=1;shard:leave@3=leave:2", 6, 2),
    ("seed=1;shard:leave@*=leave:1", 3, 2),
    ("seed=7;shard:leave@p0.05=leave:2", 188, 4),
    ("seed=3;shard:leave@p0.2=leave:3.5", 40, 8)])
def test_compile_epochs_equals_jax(plan, n_win, n):
    want = jmembership.compile_epochs(n_win, n,
                                      plan=jfaults.FaultPlan.parse(plan))
    got = membership.compile_epochs(n_win, n,
                                    plan=faults.FaultPlan.parse(plan))
    assert [(e.gen, e.start, e.end, e.active) for e in got] == \
        [(e.gen, e.start, e.end, e.active) for e in want]
    assert all(e.n_active >= 1 for e in got)


def test_fault_plan_spellings_and_registry_equal_jax(tmp_path):
    spec = ("seed=5;shard:straggle@p0.3=straggle:4;shard:straggle@2="
            "straggle;shard:leave@*=leave:1.5")
    assert faults.FaultPlan.parse(spec).spec() == \
        jfaults.FaultPlan.parse(spec).spec()
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"seed": 5, "rules": [
        {"point": "shard:straggle", "hit": "*", "kind": "straggle",
         "arg": 3}]}))
    assert faults.FaultPlan.parse(str(path)).spec() == \
        jfaults.FaultPlan.parse(str(path)).spec()
    a = faults.FaultRegistry(faults.FaultPlan.parse(spec))
    b = jfaults.FaultRegistry(jfaults.FaultPlan.parse(spec))
    for point in ("shard:straggle", "shard:leave") * 20:
        assert a.probe(point) == b.probe(point)
    assert a.fired == b.fired
    for bad in ("ckpt:write@1=straggle", "shard:leave@1=oserror",
                "nowhere@1=kill", "shard:straggle@p2=straggle"):
        with pytest.raises(ValueError) as want:
            jfaults.FaultPlan.parse(f"seed=1;{bad}")
        with pytest.raises(ValueError) as got:
            faults.FaultPlan.parse(f"seed=1;{bad}")
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("plan", ["seed=1;cluster:rpc@1=oserror",
                                  "seed=1;cluster:ps@*=hang:0.1",
                                  "seed=1;shard:leave@1=leave;"
                                  "cluster:replica@p0.2=kill"])
def test_plan_without_a_port_seam_is_refused(plan, monkeypatch):
    """A rule at a point the port has no seam for (the cluster
    runtime's) would never fire: configure refuses it, naming ROADMAP
    A12, from the argument and from ``$TDA_FAULT_PLAN``."""
    with pytest.raises(ValueError, match="cluster runtime.*ROADMAP A12"):
        faults.configure(plan)
    monkeypatch.setenv(faults.ENV_PLAN, plan)
    with pytest.raises(ValueError, match="cluster runtime.*ROADMAP A12"):
        faults.configure()
    assert faults.active() is None


# ----------------------------------------- the window loop against JAX


def _drive_jax(mesh, cfg, data, extra, meta=None, X2=None):
    d = (meta["d_total"] if meta else data[0].shape[1])
    n = int(mesh.shape["data"])
    if meta is None:
        Xs, ys = jparallelize(data[0], mesh), jparallelize(data[1], mesh)
        args, n_padded = (Xs.data, ys.data, Xs.mask), Xs.n_padded
    else:
        dummy = jax.numpy.zeros((n,), jax.numpy.float32)
        args, n_padded = (X2, dummy, dummy), meta["n_padded"]
    w0 = np.asarray(jssgd.logistic.init_weights(
        jssgd.prng.root_key(cfg.init_seed), data[0].shape[1]), np.float32)
    w0 = np.pad(w0, (0, d - w0.shape[0]))
    st = jpartition.ensure(dict(zip(
        ("w", "clocks", "pend", "basegen", "wl", "accd", "res"),
        jssgd.ssp_init_state(mesh, cfg, d, w=w0))), "ssgd", mesh)
    n_win = extra.shape[0]
    fn = jssgd.make_ssp_train_fn(mesh, cfg, n_padded, d,
                                 active=(True,) * n, n_win_seg=n_win,
                                 total_ticks=cfg.n_iterations, meta=meta)
    Xte = jax.numpy.zeros((1, d), jax.numpy.float32)
    yte = jax.numpy.zeros((1,), jax.numpy.float32)
    out = fn(*args, Xte, yte, st["w"], st["clocks"], st["pend"],
             st["basegen"], st["wl"], st["accd"], st["res"],
             jax.numpy.asarray(extra), jax.numpy.int32(0))
    return [np.asarray(x) for x in out], w0


def _drive_port(n, cfg, data, extra, w0, meta=None, X2=None):
    from tpu_distalg_torch.parallel import partition

    mesh = get_mesh(n, device="cpu")
    d = w0.shape[0]
    if meta is None:
        Xs = parallelize(data[0], mesh)
        ys = parallelize(np.asarray(data[1], np.float32), mesh)
        args, n_padded = (Xs.data, ys.data, Xs.mask), Xs.n_padded
    else:
        args, n_padded = (X2, None, None), meta["n_padded"]
    st = partition.place(dict(zip(
        ("w", "clocks", "pend", "basegen", "wl", "accd", "res"),
        ssgd.ssp_init_state(mesh, cfg, d, w=w0))), "ssgd", mesh)
    fn = ssgd.make_ssp_train_fn(mesh, cfg, n_padded, d, active=(True,) * n,
                                n_win_seg=extra.shape[0],
                                total_ticks=cfg.n_iterations, meta=meta)
    out = fn(*args, torch.zeros((1, d)), torch.zeros((1,)), st["w"],
             st["clocks"], st["pend"], st["basegen"], st["wl"], st["accd"],
             st["res"], extra, 0)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("sampler", ["bernoulli", "fused_gather"])
@pytest.mark.parametrize("comm", ["dense", "topk:0.1", "int8"])
def test_ssp_window_loop_equals_jax(data, sampler, comm):
    """ssp:4 on 4 shards under a straggle plan, 6 windows: the clocks,
    pending flags, base generations, gated counts and age traces equal
    JAX's exactly; w, the local models and the deltas within 1e-5 of the
    largest |w|."""
    kw = {} if sampler == "bernoulli" else dict(sampler=sampler, **FUSED)
    T, s = 24, 4
    jcfg = jssgd.SSGDConfig(n_iterations=T, sync=f"ssp:{s}", comm=comm,
                            eval_test=False, **kw)
    pcfg = ssgd.SSGDConfig(n_iterations=T, sync=f"ssp:{s}", comm=comm,
                           eval_test=False, **kw)
    extra = pssp.compile_straggle_schedule(
        T, 4, plan=faults.FaultPlan.parse(
            "seed=7;shard:straggle@p0.3=straggle:5")).reshape(T // s, s, 4)
    meta = X2 = jX2 = None
    if sampler != "bernoulli":
        _, jX2, _, meta = _quiet(jssgd.prepare_fused, data[0], data[1],
                                 _mesh(4), jcfg)
        _, X2, _, pmeta = _quiet(ssgd.prepare_fused, data[0], data[1],
                                 get_mesh(4, device="cpu"), pcfg)
        assert pmeta == meta
    want, w0 = _quiet(_drive_jax, _mesh(4), jcfg, data, extra, meta, jX2)
    got = _quiet(_drive_port, 4, pcfg, data, extra, w0, meta, X2)
    # (w, clocks, pend, basegen, wl, accd, res, accs, amax, amean, gated)
    for i in (1, 2, 3, 8, 9, 10):
        np.testing.assert_array_equal(got[i], want[i], err_msg=str(i))
    scale = float(np.abs(want[0]).max())
    for i in (0, 4, 5, 6):
        np.testing.assert_allclose(got[i], want[i], rtol=0,
                                   atol=1e-5 * scale, err_msg=str(i))
    assert got[3].min() >= 0 and got[10].sum() >= 0


def test_ssp_trainer_equals_jax_under_full_plan(data):
    """The whole driver, epochs included, on bernoulli: the same
    accuracy history, w within 1e-5 of the largest |w|."""
    cfg = dict(n_iterations=32, sync="ssp:4")
    jfaults.configure(FULL_PLAN)
    want = jssgd.train(*data, _mesh(4), jssgd.SSGDConfig(**cfg))
    faults.configure(FULL_PLAN)
    got = ssgd.train(*data, get_mesh(4, device="cpu"),
                     ssgd.SSGDConfig(**cfg))
    np.testing.assert_array_equal(got.accs.numpy(), np.asarray(want.accs))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-5 * float(np.abs(want.w).max()))


# ------------------------------------------------ the port's own runs


@pytest.mark.parametrize("kw", [{}, dict(sampler="fused_gather", **FUSED),
                                dict(comm="topk:0.1"),
                                dict(sampler="fused", fused_pack=4,
                                     fused_block_rows=64, comm="int8")])
def test_ssp_replay_segmented_and_resume_bitwise(data, tmp_path, kw):
    cfg = ssgd.SSGDConfig(n_iterations=32, sync="ssp:4", **kw)
    m4 = get_mesh(4, device="cpu")
    runs = []
    for ckpt in (None, None, str(tmp_path / "seg")):
        faults.configure(FULL_PLAN)
        runs.append(_quiet(ssgd.train, *data, m4, cfg, checkpoint_dir=ckpt,
                           checkpoint_every=8))
    for r in runs[1:]:
        assert torch.equal(r.w, runs[0].w)
        assert torch.equal(r.accs, runs[0].accs)
    # a run stopped after 16 ticks resumes to the straight one: the
    # schedules of the first 16 ticks are the same probes in both
    d = str(tmp_path / "resume")
    faults.configure(FULL_PLAN)
    _quiet(ssgd.train, *data, m4, ssgd.SSGDConfig(n_iterations=16,
                                                  sync="ssp:4", **kw),
           checkpoint_dir=d, checkpoint_every=8)
    faults.configure(FULL_PLAN)
    resumed = _quiet(ssgd.train, *data, m4, cfg, checkpoint_dir=d,
                     checkpoint_every=8)
    assert torch.equal(resumed.w, runs[0].w)
    assert torch.equal(resumed.accs, runs[0].accs)


def test_ssp_renegotiates_and_equals_jax_integers(data, tmp_path, capsys):
    """A checkpoint written on 4 shards resumed on 3 renegotiates (the
    line names it); the renegotiated state's integers equal JAX's, and
    the sequence replays bitwise."""
    d = str(tmp_path / "ck")
    m4, m3 = get_mesh(4, device="cpu"), get_mesh(3, device="cpu")
    ssgd.train(*data, m4, ssgd.SSGDConfig(n_iterations=16, sync="ssp:4"),
               checkpoint_dir=d, checkpoint_every=8)
    from tpu_distalg_torch.utils import checkpoint as ckpt

    payload, start = ckpt.restore(d)
    assert int(payload["shards"]) == 4 and start == 4
    saved = payload["state"]
    cfg3 = ssgd.SSGDConfig(n_iterations=32, sync="ssp:4")
    got = ssgd.ssp_init_state(m3, cfg3, saved[0].shape[0], w=saved[0],
                              clocks=membership.redistribute_clocks(
                                  saved[1], 3), win0=start)
    want = jssgd.ssp_init_state(
        _mesh(3), jssgd.SSGDConfig(n_iterations=32, sync="ssp:4"),
        saved[0].shape[0], w=saved[0],
        clocks=jmembership.redistribute_clocks(saved[1], 3), win0=start)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    res = ssgd.train(*data, m3, cfg3, checkpoint_dir=d, checkpoint_every=8)
    assert res.accs.shape == (32,)
    assert "ring renegotiated: 4 -> 3" in capsys.readouterr().err
    d2 = str(tmp_path / "ck2")
    ssgd.train(*data, m4, ssgd.SSGDConfig(n_iterations=16, sync="ssp:4"),
               checkpoint_dir=d2, checkpoint_every=8)
    res2 = ssgd.train(*data, m3, cfg3, checkpoint_dir=d2, checkpoint_every=8)
    assert torch.equal(res.w, res2.w)


def test_ssp_checkpoint_refuses_another_bound_and_bsp(data, tmp_path):
    m4 = get_mesh(4, device="cpu")
    d = str(tmp_path / "ck")
    ssgd.train(*data, m4, ssgd.SSGDConfig(n_iterations=16, sync="ssp:4"),
               checkpoint_dir=d, checkpoint_every=8)
    with pytest.raises(ValueError, match="workload"):
        ssgd.train(*data, m4, ssgd.SSGDConfig(n_iterations=32,
                                              sync="ssp:8"),
                   checkpoint_dir=d, checkpoint_every=8)
    d2 = str(tmp_path / "bsp")
    ssgd.train(*data, m4, ssgd.SSGDConfig(n_iterations=16),
               checkpoint_dir=d2, checkpoint_every=8)
    with pytest.raises(ValueError, match="workload"):
        ssgd.train(*data, m4, ssgd.SSGDConfig(n_iterations=32,
                                              sync="ssp:4"),
                   checkpoint_dir=d2, checkpoint_every=8)


@pytest.mark.parametrize("kw", [{}, dict(sampler="fused_gather", **FUSED),
                                dict(sampler="fused", fused_pack=4,
                                     fused_block_rows=64)])
def test_s1_ssp_equals_bsp_bitwise(data, kw):
    """The port's own s = 1 standard: one shard, ``ssp:1:1.0``, the
    update is w − upd on both paths, so SSP equals BSP bitwise (the
    JAX pin misses its own 8-ulp bound, ROADMAP C). ``fused`` runs only
    on a TPU in the JAX package; this holds its SSP path to the port's
    own BSP run."""
    m1 = get_mesh(1, device="cpu")
    bsp = _quiet(ssgd.train, *data, m1, ssgd.SSGDConfig(n_iterations=40,
                                                         **kw))
    ssp = _quiet(ssgd.train, *data, m1, ssgd.SSGDConfig(n_iterations=40,
                                                         sync="ssp:1:1.0",
                                                         **kw))
    assert torch.equal(bsp.w, ssp.w)
    assert torch.equal(bsp.accs, ssp.accs)


def test_bsp_straggler_arm_is_bitwise_plain_bsp(data):
    cfg = ssgd.SSGDConfig(n_iterations=24, eval_test=False)
    m4 = get_mesh(4, device="cpu")
    Xs = parallelize(data[0], m4)
    ys = parallelize(np.asarray(data[1], np.float32), m4)
    extra = pssp.compile_straggle_schedule(
        24, 4, plan=faults.FaultPlan.parse(STRAGGLE_PLAN))
    d = data[0].shape[1]
    te = (torch.zeros((1, d)), torch.zeros((1,)))
    w0 = torch.zeros((d,))
    a = ssgd.make_bsp_straggler_fn(m4, cfg, Xs.n_padded, extra)(
        Xs.data, ys.data, Xs.mask, *te, w0)
    b = ssgd.make_train_fn(m4, cfg, Xs.n_padded)(Xs.data, ys.data,
                                                  Xs.mask, *te, w0)
    assert torch.equal(a[0], b[0])


def test_ssp_counters_and_epoch_events(data, tmp_path):
    sink = events.configure(str(tmp_path))
    faults.configure(FULL_PLAN)
    ssgd.train(*data, get_mesh(4, device="cpu"),
               ssgd.SSGDConfig(n_iterations=64, sync="ssp:4"))
    counters = sink.counters()
    events.configure(False)
    assert counters["ssp.merges"] == 16
    assert counters["ssp.membership_epochs"] >= 2
    assert counters["ssp.straggle_ticks"] > 0
    assert counters["comm.syncs"] == 16
    lines = [json.loads(x) for name in os.listdir(tmp_path)
             for x in open(tmp_path / name)]
    kinds = {e["ev"] for e in lines}
    assert {"membership_epoch", "fault_injected", "gauge"} <= kinds


# ---------------------------------------------- the local-update family


@pytest.mark.parametrize("name,mod,cls", [("ma", ma, "MAConfig"),
                                          ("bmuf", bmuf, "BMUFConfig"),
                                          ("easgd", easgd, "EASGDConfig")])
def test_local_sgd_ssp_replay_segmented_and_jax(data, tmp_path, name, mod,
                                                cls):
    """Under the full plan: replay and segmented equal straight bitwise;
    against JAX the accuracy history is equal and w within 1e-5 of the
    largest |w| at 24 rounds."""
    cfg = getattr(mod, cls)(n_iterations=24, sync="ssp:4")
    m4 = get_mesh(4, device="cpu")
    runs = []
    for ckpt in (None, None, str(tmp_path / "seg")):
        faults.configure(FULL_PLAN)
        runs.append(mod.train(*data, m4, cfg, checkpoint_dir=ckpt,
                              checkpoint_every=8))
    for r in runs[1:]:
        assert torch.equal(r.w, runs[0].w) and torch.equal(r.ws, runs[0].ws)
        assert torch.equal(r.accs, runs[0].accs)
    jmod = importlib.import_module(f"tpu_distalg.models.{name}")
    jfaults.configure(FULL_PLAN)
    want = jmod.train(*data, _mesh(4), getattr(jmod, cls)(n_iterations=24,
                                                          sync="ssp:4"))
    np.testing.assert_array_equal(runs[0].accs.numpy(),
                                  np.asarray(want.accs))
    np.testing.assert_allclose(runs[0].w.numpy(), np.asarray(want.w),
                               rtol=0,
                               atol=1e-5 * float(np.abs(want.w).max()))


def test_easgd_rejoiner_does_not_gate_the_mesh(data, tmp_path):
    """EASGD never resyncs, so the epoch hook bumps a rejoining replica's
    frozen clock: with no straggle rules a healthy run gates no tick,
    as in the JAX package."""
    sink = events.configure(str(tmp_path))
    faults.configure("seed=3;shard:leave@1=leave:4")
    easgd.train(*data, get_mesh(4, device="cpu"),
                easgd.EASGDConfig(n_iterations=32, sync="ssp:4"))
    counters = sink.counters()
    events.configure(False)
    assert counters.get("ssp.membership_epochs", 0) >= 2
    assert counters.get("ssp.gated_ticks", 0) == 0
    jfaults.configure("seed=3;shard:leave@1=leave:4")
    want = jeasgd.train(*data, _mesh(4),
                        jeasgd.EASGDConfig(n_iterations=32, sync="ssp:4"))
    faults.configure("seed=3;shard:leave@1=leave:4")
    got = easgd.train(*data, get_mesh(4, device="cpu"),
                      easgd.EASGDConfig(n_iterations=32, sync="ssp:4"))
    np.testing.assert_array_equal(got.accs.numpy(), np.asarray(want.accs))


# ----------------------------------------------------------- refusals


@pytest.mark.parametrize("kw", [dict(sampler="fused_train"),
                                dict(sampler="fixed"),
                                dict(use_pallas=True)])
def test_ssgd_ssp_refusals_in_jax_words(data, kw):
    cfg = dict(n_iterations=8, sync="ssp:4", **kw)
    with pytest.raises(ValueError) as want:
        jssgd.train(*data, _mesh(4), jssgd.SSGDConfig(**cfg))
    with pytest.raises(ValueError) as got:
        ssgd.train(*data, get_mesh(4, device="cpu"), ssgd.SSGDConfig(**cfg))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sampler", ["fused_gather", "fused_train"])
def test_local_sgd_ssp_refusal_in_jax_words(data, sampler):
    from tpu_distalg.models import bmuf as jbmuf

    with pytest.raises(ValueError) as want:
        jbmuf.train(*data, _mesh(4), jbmuf.BMUFConfig(
            n_iterations=8, sync="ssp:4", sampler=sampler))
    with pytest.raises(ValueError) as got:
        bmuf.train(*data, get_mesh(4, device="cpu"), bmuf.BMUFConfig(
            n_iterations=8, sync="ssp:4", sampler=sampler))
    assert str(got.value) == str(want.value)
