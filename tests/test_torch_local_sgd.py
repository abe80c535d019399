"""The port's local-update family (``tpu_distalg_torch/models/
{local_sgd,ma,bmuf,easgd}.py`` and the ``ma``, ``bmuf``, ``easgd``
subcommands) against the JAX package's ``models/local_sgd.py`` on the
CPU.

Both packages draw the same initial state, Bernoulli masks and block
ids from the same seeds (compared exactly), so their rounds can be
compared one by one. JAX's kernels B1 and B2 run in interpret mode on
the conftest's 4-device mesh, the port's plain versions on the CPU.
The two add in other orders, and SGD on the unnormalised breast-cancer
features amplifies such differences about 1.9× a round
(``tests/test_mega_kernel.py``), so trajectories are held at 5 rounds
and convergence by the tail of a full run (the last 50 rounds), never
by the last round alone.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_distalg.models import bmuf as jbmuf
from tpu_distalg.models import easgd as jeasgd
from tpu_distalg.models import local_sgd as jlocal
from tpu_distalg.models import ma as jma
from tpu_distalg.models.ssgd import fused_gather_geometry as jgeometry
from tpu_distalg.ops import logistic as jlogistic
from tpu_distalg.ops import sampling as jsampling
from tpu_distalg.parallel import parallelize as jparallelize
from tpu_distalg.utils import prng as jprng
from tpu_distalg_torch.models import bmuf, easgd, local_sgd, ma
from tpu_distalg_torch.parallel import get_mesh, parallelize
from tpu_distalg_torch.utils import checkpoint, datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSED = dict(fused_pack=4, gather_block_rows=32, shuffle_seed=0)
#: (name, port module, JAX module, config class name)
FAMILY = (("ma", ma, jma, "MAConfig"), ("bmuf", bmuf, jbmuf, "BMUFConfig"),
          ("easgd", easgd, jeasgd, "EASGDConfig"))
SAMPLERS = (("bernoulli", {}), ("fused_gather", FUSED),
            ("fused_train", FUSED))
#: the tail of a full run over which convergence is read, and the bands
#: (the reference's MA golden 0.853801; BMUF and EASGD 0.929825)
TAIL = 50
BAND = {"ma": 0.85, "bmuf": 0.92, "easgd": 0.92}


@pytest.fixture(scope="module")
def data():
    return datasets.breast_cancer_split()


def _cfg(mod, cls, **kw):
    return getattr(mod, cls)(**kw)


def _port(data, n_replicas, mod, config, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # coarse-fraction geometry warn
        return mod.train(*data, get_mesh(data=n_replicas, device="cpu"),
                         config, **kw)


def _jax(data, mesh, mod, config):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mod.train(*data, mesh, config)


# ------------------------------------------------------ integer parity


@pytest.mark.parametrize("name,mod,jmod,cls", FAMILY + (
    ("bmuf-zero-delta", bmuf, jbmuf, "BMUFConfig"),))
def test_initial_state_equals_jax_in_both_layouts(data, mesh4, name, mod,
                                                  jmod, cls):
    """w0, the (R, D) replicas and BMUF's δ equal JAX's bit for bit: the
    fused layout against ``local_sgd.prepare_fused`` (X2 too), the plain
    layout against the draws of ``local_sgd.train`` (``:996-1007``)."""
    kw = dict(random_delta_init=False) if name == "bmuf-zero-delta" else {}
    X, y = data[0], data[1]
    D = X.shape[1]
    cfg_j = _cfg(jmod, cls, sampler="fused_train", **FUSED, **kw)
    cfg_p = _cfg(mod, cls, sampler="fused_train", **FUSED, **kw)
    mesh = get_mesh(data=4, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, X2_j, w0_j, ws0_j, d0_j, meta_j = jlocal.prepare_fused(
            X, y, mesh4, cfg_j)
        _, X2, w0, ws0, d0, meta = local_sgd.prepare_fused(X, y, mesh,
                                                           cfg_p)
    assert meta == meta_j
    np.testing.assert_array_equal(X2.numpy(), np.asarray(X2_j))
    for got, want in ((w0, w0_j), (ws0, ws0_j), (d0, d0_j)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((d0 != 0).any()) == (name == "bmuf")
    k = jprng.root_key(cfg_j.init_seed)
    w0_p, ws0_p, d0_p = local_sgd.init_state(cfg_p, D, D, 4, "cpu")
    np.testing.assert_array_equal(w0_p.numpy(), np.asarray(
        jlogistic.init_weights(jax.random.fold_in(k, 0), D)))
    np.testing.assert_array_equal(ws0_p.numpy(), np.asarray(
        jax.random.uniform(jax.random.fold_in(k, 1), (4, D), minval=-1.0,
                           maxval=1.0)))
    np.testing.assert_array_equal(d0_p.numpy(), np.asarray(
        jax.random.uniform(jax.random.fold_in(k, 2), (D,), minval=-1.0,
                           maxval=1.0) if name == "bmuf"
        else jnp.zeros((D,))))


@pytest.mark.parametrize("resample", [False, True])
def test_round_masks_equal_jax(data, mesh4, resample):
    """The ``bernoulli`` masks of a round: one draw keyed on t broadcast
    over L, or one a local step keyed on t·L + l (``local_sgd.py:546-
    561``), over the padded rows of 4 shards; exact."""
    cfg = ma.MAConfig(resample_per_local_step=resample)
    valid_j = jparallelize(data[0], mesh4).mask
    valid = parallelize(data[0], get_mesh(data=4, device="cpu")).mask
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    key, L, n = jprng.root_key(cfg.seed), cfg.n_local_iterations, len(valid)
    for t in (0, 1, 37, 299):
        got = local_sgd.round_masks(cfg, t, valid)
        steps = [t * L + l for l in range(L)] if resample else [t] * L
        want = np.stack([np.asarray(jsampling.bernoulli_mask(
            key, s, n, cfg.mini_batch_fraction, valid_j)) for s in steps])
        assert got.shape == (L, n)
        np.testing.assert_array_equal(got.numpy(), want)
        assert resample or bool((got == got[0]).all())


@pytest.mark.parametrize("resample", [False, True])
def test_block_ids_equal_jax(data, resample):
    """The (T, L, S, n_s) block ids of ``fused_gather``/``fused_train``,
    keyed on ``fold_in(fold_in(key, t), l)`` and the shard, the one draw
    of a round broadcast over L without resampling; exact, for absolute
    round ids past 0 as a resumed segment draws them."""
    cfg = ma.MAConfig(sampler="fused_gather", resample_per_local_step=resample,
                      **FUSED)
    mesh = get_mesh(data=4, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, meta = local_sgd.pack(data[0], data[1], mesh, cfg)
        n_blocks, n_s = jgeometry(cfg, meta, 4)
    ts = torch.arange(40, 47)
    got = local_sgd.block_draws(cfg, 4, n_blocks, n_s, ts)
    L = cfg.n_local_iterations
    key = jprng.root_key(cfg.seed)
    want = jax.vmap(lambda t: jax.vmap(lambda l: jsampling.sample_block_ids(
        jax.random.fold_in(jax.random.fold_in(key, t), l), 4, n_blocks, n_s))(
        jnp.arange(L if resample else 1)))(jnp.arange(40, 47))
    want = np.broadcast_to(np.asarray(want), (7, L, 4, n_s))
    assert got.shape == (7, L, 4, n_s) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.min()) >= 0 and int(got.max()) < n_blocks
    assert resample == bool((got[:, 1:] != got[:, :1]).any())


# -------------------------------------------------------- float parity


@pytest.mark.parametrize("sampler,fkw", SAMPLERS,
                         ids=[s for s, _ in SAMPLERS])
@pytest.mark.parametrize("name,mod,jmod,cls", FAMILY,
                         ids=[f[0] for f in FAMILY])
def test_five_rounds_match_jax(data, mesh4, name, mod, jmod, cls, sampler,
                               fkw):
    """5 rounds on 4 replicas: the center and every replica within 1e-5
    of the largest entry (measured: at most 2e-6), the accuracy
    histories equal."""
    kw = dict(n_iterations=5, sampler=sampler, **fkw)
    want = _jax(data, mesh4, jmod, _cfg(jmod, cls, **kw))
    got = _port(data, 4, mod, _cfg(mod, cls, **kw))
    w_j, ws_j = np.asarray(want.w), np.asarray(want.ws)
    assert got.w.shape == w_j.shape and got.ws.shape == ws_j.shape == (4, 31)
    scale = max(float(np.abs(w_j).max()), float(np.abs(ws_j).max()))
    np.testing.assert_allclose(got.w.numpy(), w_j, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.ws.numpy(), ws_j, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_array_equal(got.accs.numpy(), np.asarray(want.accs))


@pytest.mark.parametrize("n_replicas,sampler,fkw", [
    (4, "bernoulli", {}), (4, "fused_train", FUSED), (1, "fused_train",
                                                      FUSED)],
    ids=["bernoulli-4", "fused_train-4", "fused_train-1"])
def test_resampled_and_single_replica_rounds_match_jax(data, mesh1, mesh4,
                                                       n_replicas, sampler,
                                                       fkw):
    """``resample_per_local_step`` (a draw a local step) on 4 replicas,
    and MA on one replica as bench.py runs it on one chip; 5 rounds,
    tolerances as above."""
    mesh = {1: mesh1, 4: mesh4}[n_replicas]
    kw = dict(n_iterations=5, sampler=sampler,
              resample_per_local_step=n_replicas == 4, **fkw)
    want = _jax(data, mesh, jma, jma.MAConfig(**kw))
    got = _port(data, n_replicas, ma, ma.MAConfig(**kw))
    w_j = np.asarray(want.w)
    scale = max(float(np.abs(w_j).max()),
                float(np.abs(np.asarray(want.ws)).max()))
    np.testing.assert_allclose(got.w.numpy(), w_j, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.ws.numpy(), np.asarray(want.ws), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_array_equal(got.accs.numpy(), np.asarray(want.accs))


@pytest.mark.parametrize("name,mod,jmod,cls", FAMILY,
                         ids=[f[0] for f in FAMILY])
def test_fused_train_equals_fused_gather(data, name, mod, jmod, cls):
    """Within the port: B2's one launch a replica a round is the per-step
    path within atol 1e-3 after 5 rounds on 4 replicas (the JAX
    package's own standard, ``tests/test_mega_kernel.py``); the two
    round the update differently (η/n·g against η·(g/n))."""
    base = dict(n_iterations=5, eval_test=False, **FUSED)
    r_mega = _port(data, 4, mod, _cfg(mod, cls, sampler="fused_train",
                                      **base))
    r_step = _port(data, 4, mod, _cfg(mod, cls, sampler="fused_gather",
                                      **base))
    np.testing.assert_allclose(r_mega.w.numpy(), r_step.w.numpy(), atol=1e-3)
    np.testing.assert_allclose(r_mega.ws.numpy(), r_step.ws.numpy(),
                               atol=1e-3)


# --------------------------------------------------------- convergence


def _tail(accs) -> tuple[float, float]:
    tail = np.asarray(accs)[-TAIL:]
    return float(tail.max()), float(tail.mean())


@pytest.mark.parametrize("name,mod,jmod,cls", FAMILY,
                         ids=[f[0] for f in FAMILY])
def test_full_runs_converge_beside_a_live_jax_run(data, mesh4, name, mod,
                                                  jmod, cls):
    """The presets' full runs (300 rounds; EASGD 1500) on 4 replicas,
    ``bernoulli``: the best accuracy of the last 50 rounds in the band
    on both packages, and the port's mean over them within 0.02 of the
    JAX run's (measured: MA 0.9033 / 0.9051, BMUF 0.9160 / 0.9087, EASGD
    0.9367 / 0.9303). BMUF is held to this live run and the band, not to
    the 0.9415 pin that ``tests/test_optimizers.py`` skips here."""
    want = _tail(_jax(data, mesh4, jmod, _cfg(jmod, cls)).accs)
    got = _port(data, 4, mod, _cfg(mod, cls))
    n = 1500 if name == "easgd" else 300
    assert got.accs.shape == (n,)
    best, mean = _tail(got.accs)
    assert best >= BAND[name] and want[0] >= BAND[name], (best, want)
    assert abs(mean - want[1]) <= 0.02, (mean, want)


@pytest.mark.parametrize("sampler", ["fused_gather", "fused_train"])
@pytest.mark.parametrize("name,mod,cls", [f[:2] + f[3:] for f in FAMILY],
                         ids=[f[0] for f in FAMILY])
def test_fused_full_runs_converge(data, name, mod, cls, sampler):
    """The fused samplers' full runs on 4 replicas (fused_pack 4,
    gather_block_rows 32): the last 50 rounds reach the band and their
    mean is above MA's reference golden 0.853801 (measured 0.897–0.936)."""
    res = _port(data, 4, mod, _cfg(mod, cls, sampler=sampler, **FUSED))
    best, mean = _tail(res.accs)
    assert best >= BAND[name] and mean >= 0.85, (best, mean)


# ---------------------------------------------------- segments, replays


@pytest.mark.parametrize("sampler,fkw", SAMPLERS,
                         ids=[s for s, _ in SAMPLERS])
@pytest.mark.parametrize("name,mod,cls", [
    ("bmuf", bmuf, "BMUFConfig"), ("easgd", easgd, "EASGDConfig")])
def test_segmented_run_equals_straight_run(data, tmp_path, name, mod, cls,
                                           sampler, fkw):
    """30 rounds in segments of 12 (the carry: center, replicas, δ) equal
    a straight run bit for bit; a second call resumes at the end, and a
    run cut at round 24 resumes to the same result."""
    cfg = _cfg(mod, cls, n_iterations=30, sampler=sampler, **fkw)
    straight = _port(data, 4, mod, cfg)
    seg = _port(data, 4, mod, cfg, checkpoint_dir=str(tmp_path / "a"),
                checkpoint_every=12)
    for got in (seg, _port(data, 4, mod, cfg,
                           checkpoint_dir=str(tmp_path / "a"),
                           checkpoint_every=12)):
        np.testing.assert_array_equal(got.w.numpy(), straight.w.numpy())
        np.testing.assert_array_equal(got.ws.numpy(), straight.ws.numpy())
        np.testing.assert_array_equal(got.accs.numpy(),
                                      straight.accs.numpy())
    _port(data, 4, mod, dataclasses.replace(cfg, n_iterations=24),
          checkpoint_dir=str(tmp_path / "b"), checkpoint_every=12)
    assert checkpoint.latest_step(str(tmp_path / "b")) == 24
    resumed = _port(data, 4, mod, cfg, checkpoint_dir=str(tmp_path / "b"),
                    checkpoint_every=12)
    np.testing.assert_array_equal(resumed.ws.numpy(), straight.ws.numpy())
    np.testing.assert_array_equal(resumed.accs.numpy(),
                                  straight.accs.numpy())
    with pytest.raises(ValueError, match="incompatible"):
        _port(data, 4, ma, ma.MAConfig(n_iterations=30, sampler=sampler,
                                       **fkw),
              checkpoint_dir=str(tmp_path / "b"), checkpoint_every=12)


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("change,exc,match", [
    (dict(comm="zstd"), ValueError, "unknown comm schedule"),
    (dict(comm="topk:0", sampler="fused_train"), ValueError,
     "topk_fraction must be in"),
    (dict(sync="ssp:0"), ValueError, "staleness bound must be >= 1"),
    (dict(sync="ssp:4", sampler="fused_train"), ValueError,
     "the fused kernels stay BSP"),
    (dict(sync="ssp:4", sampler="fused_gather"), ValueError,
     "composes with the 'bernoulli' sampler"),
    (dict(sampler="nope"), ValueError, "unknown sampler"),
    (dict(sampler="fused_train", gather_block_rows=30, fused_pack=4),
     ValueError, "multiple of pack"),
], ids=["comm", "comm-fused", "ssp", "ssp-fused_train", "ssp-fused_gather",
        "sampler", "geometry"])
def test_refusals(data, mesh4, change, exc, match):
    """The port refuses what the JAX package refuses, in its words: a
    bad schedule or sync spelling, SSP on a fused sampler, an unknown
    sampler, a block geometry (no ROADMAP A9 refusal is left)."""
    with pytest.raises(exc, match=match):
        _port(data, 4, ma, ma.MAConfig(n_iterations=2, **change))
    if exc is ValueError:
        with pytest.raises(ValueError, match=match):
            _jax(data, mesh4, jma, jma.MAConfig(n_iterations=2, **change))


def test_easgd_derives_alpha_and_beta(data):
    """EASGD's α = η·ρ on the frozen config (``easgd.py:24``), β = R·α
    unless given: with β = 0 the center never moves."""
    cfg = easgd.EASGDConfig(eta=0.2, rho=0.5)
    assert cfg.elastic_alpha == pytest.approx(0.1)
    assert easgd.EASGDConfig(elastic_alpha=0.3).elastic_alpha == 0.3
    assert local_sgd._derive_beta(cfg, 4) == pytest.approx(0.4)
    res = _port(data, 2, easgd, easgd.EASGDConfig(n_iterations=3, beta=0.0))
    w0, _, _ = local_sgd.init_state(easgd.EASGDConfig(), 31, 31, 2, "cpu")
    np.testing.assert_array_equal(res.w.numpy(), w0.numpy())


# ------------------------------------------------------------------ CLI


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
         *args], capture_output=True, text=True, timeout=300, env=env,
        cwd=REPO)


@pytest.mark.parametrize("name,mod,cls,sampler,fkw", [
    ("ma", ma, "MAConfig", "bernoulli", {}),
    ("bmuf", bmuf, "BMUFConfig", "fused_train", FUSED),
    ("easgd", easgd, "EASGDConfig", "fused_gather", FUSED)],
    ids=["ma", "bmuf", "easgd"])
def test_cli_lines(data, tmp_path, name, mod, cls, sampler, fkw):
    """The JAX CLI's lines, the library's weights and accuracy; segmented
    through --checkpoint-dir."""
    flags = [f"--{k.replace('_', '-')}={v}" for k, v in fkw.items()]
    out = _cli(name, "--n-slices", "4", "--n-iterations", "40",
               "--sampler", sampler, *flags, "--checkpoint-dir",
               str(tmp_path), "--checkpoint-every", "16")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("Final w: [")
    w = np.asarray(eval(lines[0][len("Final w: "):]), np.float32)
    want = _port(data, 4, mod, _cfg(mod, cls, n_iterations=40,
                                    sampler=sampler, **fkw))
    np.testing.assert_array_equal(w, want.w.numpy())
    assert lines[1] == f"Final acc: {want.final_acc:.6f}"
    assert lines[2].startswith(f"[{name}] 40 iterations in ")
    assert checkpoint.latest_step(str(tmp_path)) == 40


@pytest.mark.parametrize("name,mod,cls,sampler,fkw", [
    ("ma", ma, "MAConfig", "bernoulli", {}),
    ("bmuf", bmuf, "BMUFConfig", "fused_train", FUSED),
    ("easgd", easgd, "EASGDConfig", "fused_gather", FUSED)],
    ids=["ma", "bmuf", "easgd"])
def test_cli_max_restarts_recovers_a_killed_write(data, tmp_path, name, mod,
                                                  cls, sampler, fkw):
    """``--max-restarts 1`` wraps the run in ``run_with_restarts``: a
    killed checkpoint write restarts once from the step before, and the
    weights equal the library's undisturbed run bit for bit."""
    flags = [f"--{k.replace('_', '-')}={v}" for k, v in fkw.items()]
    out = _cli(name, "--n-slices", "4", "--n-iterations", "40",
               "--sampler", sampler, *flags, "--checkpoint-dir",
               str(tmp_path), "--checkpoint-every", "16",
               "--max-restarts", "1", "--fault-plan",
               "seed=1;ckpt:write@1=kill")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("[restart 1/1] InjectedKill")
    w = np.asarray(eval(lines[1][len("Final w: "):]), np.float32)
    want = _port(data, 4, mod, _cfg(mod, cls, n_iterations=40,
                                    sampler=sampler, **fkw))
    np.testing.assert_array_equal(w, want.w.numpy())
    assert lines[2] == f"Final acc: {want.final_acc:.6f}"
    assert checkpoint.latest_step(str(tmp_path)) == 40


@pytest.mark.parametrize("args,match", [
    (("ma", "--mega-steps", "5"), "--mega-steps applies to ssgd only"),
    (("bmuf", "--comm", "zstd"), "unknown comm schedule"),
    (("easgd", "--sync", "bsp:2"), "only 'ssp' takes arguments"),
    (("ma", "--max-restarts", "1", "--fault-plan",
      "seed=1;cluster:worker@0=kill"), "cluster runtime")],
    ids=["mega-steps", "comm", "sync", "max-restarts"])
def test_cli_refusals(args, match):
    out = _cli(*args, "--quiet")
    assert out.returncode != 0
    assert match in out.stderr
