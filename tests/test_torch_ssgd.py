"""The port's SSGD slice (``tpu_distalg_torch/models/ssgd.py``, its CLI
subcommand, datasets, metrics and checkpoints) against the JAX
package's ``models/ssgd.py`` on the CPU.

Both packages draw the same minibatches from the same seeds (their
threefry bits are equal), so their trajectories can be compared step
by step. They add in different orders (XLA's dots and psum against
torch's), and SGD on the unnormalised breast-cancer features amplifies
such differences (``tests/test_mega_kernel.py`` measures about 1.9×
per round), so the weights after 60 steps are held to 1e-4 of their
largest entry (measured: at most 2.1e-5). The accuracy histories must
be equal: both count the same test predictions and scale by
float32(1/n) as XLA does.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_distalg.models import ssgd as jssgd
from tpu_distalg.utils import datasets as jdatasets
from tpu_distalg.utils import metrics as jmetrics
from tpu_distalg_torch import convert
from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import checkpoint, datasets, metrics
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSED = dict(fused_pack=4, gather_block_rows=32, shuffle_seed=0)
CFG_MEGA = ssgd.SSGDConfig(n_iterations=60, eval_test=False,
                           sampler="fused_train", mega_steps=20, **FUSED)


@pytest.fixture(scope="module")
def data():
    return datasets.breast_cancer_split()


def _port(data, n_shards, config, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # coarse-fraction geometry warn
        return ssgd.train(*data, get_mesh(data=n_shards, device="cpu"),
                          config, **kw)


def test_breast_cancer_split_equals_sklearn():
    """The bundled CSV and the numpy split equal scikit-learn's
    ``train_test_split(test_size=0.3, random_state=0)``."""
    for got, want in zip(datasets.breast_cancer_split(),
                         jdatasets.breast_cancer_split()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards,config", [
    (1, ssgd.SSGDConfig(n_iterations=60)),
    (4, ssgd.SSGDConfig(n_iterations=60)),
    (1, ssgd.SSGDConfig(n_iterations=60, use_pallas=True,
                        pallas_block_rows=128)),
    (4, ssgd.SSGDConfig(n_iterations=60, use_pallas=True,
                        pallas_block_rows=128)),
    (1, ssgd.SSGDConfig(n_iterations=60, lam=0.01, eval_every=7)),
    (1, ssgd.SSGDConfig(n_iterations=60, sampler="fused_gather", **FUSED)),
    (4, ssgd.SSGDConfig(n_iterations=60, sampler="fused_gather", **FUSED)),
    (1, dataclasses.replace(CFG_MEGA, eval_test=True, eval_every=20)),
], ids=["bernoulli-1", "bernoulli-4", "pallas-1", "pallas-4", "l2-eval7",
        "fused_gather-1", "fused_gather-4", "fused_train-1"])
def test_train_matches_jax(data, mesh1, mesh4, n_shards, config):
    mesh = {1: mesh1, 4: mesh4}[n_shards]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jssgd.train(*data, mesh,
                           jssgd.SSGDConfig(**dataclasses.asdict(config)))
    got = _port(data, n_shards, config)
    w_j = np.asarray(want.w)
    assert got.w.shape == w_j.shape and got.w.dtype == torch.float32
    np.testing.assert_allclose(got.w.numpy(), w_j, rtol=0,
                               atol=1e-4 * float(np.abs(w_j).max()))
    np.testing.assert_array_equal(got.accs.numpy(), np.asarray(want.accs))


@pytest.mark.parametrize("x_dtype,tol", [("float32", 1e-5),
                                         ("bfloat16", 2e-2)])
def test_fused_train_matches_fused_gather(data, x_dtype, tol):
    """Within the port: the one-launch schedule is the per-step path
    (as ``tests/test_mega_kernel.py`` holds the JAX package: rtol and
    atol 1e-5 in float32, 2e-2 in bfloat16)."""
    cfg = dataclasses.replace(CFG_MEGA, x_dtype=x_dtype)
    w_mega = _port(data, 1, cfg).w.numpy()
    w_step = _port(data, 1, dataclasses.replace(
        cfg, sampler="fused_gather")).w.numpy()
    assert np.isfinite(w_mega).all()
    np.testing.assert_allclose(w_mega, w_step, rtol=tol, atol=tol)


@pytest.mark.parametrize("config,every", [
    (ssgd.SSGDConfig(n_iterations=60, eval_every=7), 25),
    (ssgd.SSGDConfig(n_iterations=60, sampler="fused_gather", **FUSED), 25),
    (CFG_MEGA, 20),
], ids=["bernoulli", "fused_gather", "fused_train"])
def test_segmented_run_equals_straight_run(data, tmp_path, config, every):
    straight = _port(data, 1, config)
    seg = _port(data, 1, config, checkpoint_dir=str(tmp_path),
                checkpoint_every=every)
    np.testing.assert_array_equal(seg.w.numpy(), straight.w.numpy())
    np.testing.assert_array_equal(seg.accs.numpy(), straight.accs.numpy())
    # a second call finds the finished run on disk and resumes at its end
    again = _port(data, 1, config, checkpoint_dir=str(tmp_path),
                  checkpoint_every=every)
    np.testing.assert_array_equal(again.w.numpy(), straight.w.numpy())


def test_resume_from_a_middle_checkpoint_is_bitwise(data, tmp_path):
    cfg = ssgd.SSGDConfig(n_iterations=60, sampler="fused_gather", **FUSED)
    straight = _port(data, 1, cfg)
    _port(data, 1, dataclasses.replace(cfg, n_iterations=40),
          checkpoint_dir=str(tmp_path), checkpoint_every=20)
    assert checkpoint.latest_step(str(tmp_path)) == 40
    resumed = _port(data, 1, cfg, checkpoint_dir=str(tmp_path),
                    checkpoint_every=20)
    np.testing.assert_array_equal(resumed.w.numpy(), straight.w.numpy())
    with pytest.raises(ValueError, match="incompatible"):
        _port(data, 1, dataclasses.replace(cfg, sampler="bernoulli"),
              checkpoint_dir=str(tmp_path), checkpoint_every=20)


@pytest.mark.parametrize("config", [
    ssgd.SSGDConfig(n_iterations=1500, sampler="fused_gather", **FUSED),
    ssgd.SSGDConfig(n_iterations=1500, sampler="fused_train",
                    mega_steps=125, eval_every=125, **FUSED),
], ids=["fused_gather", "fused_train"])
def test_reference_accuracy_band(data, config):
    """The reference's SSGD reaches 0.929825 on this task; the JAX
    package's own convergence tests hold its fused samplers to >= 0.92
    (``tests_tpu/test_tpu_numerics.py``)."""
    res = _port(data, 1, config)
    assert res.accs.shape == (1500,)
    assert res.final_acc >= 0.92, res.final_acc


def test_fused_train_validation(data):
    """The JAX package's errors (``tests/test_mega_kernel.py``)."""
    with pytest.raises(ValueError, match="single-data-shard"):
        _port(data, 4, CFG_MEGA)
    with pytest.raises(ValueError, match="lam=0"):
        _port(data, 1, dataclasses.replace(CFG_MEGA, lam=0.01))
    with pytest.raises(ValueError, match="divisible"):
        _port(data, 1, dataclasses.replace(CFG_MEGA, n_iterations=61))
    with pytest.raises(ValueError, match="segment boundaries"):
        _port(data, 1, dataclasses.replace(CFG_MEGA, eval_test=True,
                                           eval_every=1))
    with pytest.raises(ValueError, match="checkpoint_every"):
        _port(data, 1, CFG_MEGA, checkpoint_dir="/nonexistent/mega_ckpt",
              checkpoint_every=30)
    with pytest.raises(ValueError, match="eval_every"):
        _port(data, 1, ssgd.SSGDConfig(n_iterations=5, eval_every=0))
    with pytest.raises(ValueError, match="unknown sampler"):
        _port(data, 1, ssgd.SSGDConfig(sampler="nope"))


@pytest.mark.parametrize("change,item", [
    (dict(comm="bucketed"), None),
    (dict(sampler="virtual"), "unknown sampler 'virtual'"),
    (dict(comm="int8"), None), (dict(sync="ssp:4"), None)],
    ids=["bucketed-trains", "virtual-A10", "int8-trains", "ssp-trains"])
def test_configs_train_or_name_their_item(data, change, item):
    """``virtual`` (A10, ported) trains through ``models/ssgd_virtual``,
    and ``ssgd.train`` refuses it in the JAX package's words; the
    schedules and SSP train (against the JAX package in
    ``tests/test_torch_comms_trainers.py`` and
    ``tests/test_torch_ssp.py``)."""
    if item is not None:
        with pytest.raises(ValueError, match=item):
            _port(data, 1, ssgd.SSGDConfig(n_iterations=5, **change))
        return
    res = _port(data, 1, ssgd.SSGDConfig(n_iterations=5, **change))
    assert res.accs.shape == (5,) and bool(torch.isfinite(res.w).all())


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
         "ssgd", *args], capture_output=True, text=True, timeout=300,
        env=env, cwd=REPO)


def test_cli_ssgd_lines(data, tmp_path):
    """The JAX CLI's output lines; --mega-steps is auto-picked (300
    iterations in segments of 150 → 75) and the final accuracy is the
    library's."""
    out = _cli("--n-iterations", "300", "--sampler", "fused_train",
               "--fused-pack", "4", "--gather-block-rows", "32",
               "--shuffle-seed", "0", "--checkpoint-dir", str(tmp_path),
               "--checkpoint-every", "150")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("Final w: [")
    w = np.asarray(eval(lines[0][len("Final w: "):]), np.float32)
    want = _port(data, 1, ssgd.SSGDConfig(
        n_iterations=300, sampler="fused_train", mega_steps=75,
        eval_every=75, **FUSED))
    np.testing.assert_array_equal(w, want.w.numpy())
    assert lines[1] == f"Final acc: {want.final_acc:.6f}"
    assert lines[2].startswith("[ssgd] 300 iterations in ")
    assert checkpoint.latest_step(str(tmp_path)) == 300
    out = _cli("--n-iterations", "10", "--mega-steps", "5", "--quiet")
    assert out.returncode != 0
    assert "--mega-steps applies to sampler=fused_train only" in out.stderr


def test_ssgd_params_from_jax(data, mesh1):
    """JAX-trained weights cross as numpy: float32 as they are, bf16 as
    uint16 bits; with meta they come back in the augmented layout."""
    res = jssgd.train(*data, mesh1, jssgd.SSGDConfig(n_iterations=20,
                                                     eval_test=False))
    w_np = np.asarray(res.w)
    w = convert.ssgd_params_from_jax(w_np, device="cpu")
    np.testing.assert_array_equal(w.numpy(), w_np)
    bits = np.asarray(res.w.astype(jnp.bfloat16)).view(np.uint16)
    wb = convert.ssgd_params_from_jax(bits, device="cpu")
    np.testing.assert_array_equal(
        wb.numpy(), np.asarray(res.w.astype(jnp.bfloat16), np.float32))
    meta = dict(d_total=64, y_col=31, v_col=32)
    wa = convert.ssgd_params_from_jax(w_np, meta, device="cpu")
    assert wa.shape == (64,) and float(wa[31:].abs().max()) == 0.0
    np.testing.assert_array_equal(wa[:31].numpy(), w_np)
    # the port's held-out accuracy of the JAX weights is JAX's
    X_te, y_te = (torch.as_tensor(a) for a in data[2:])
    assert float(metrics.binary_accuracy(X_te @ w, y_te)) == float(
        jmetrics.binary_accuracy(jnp.asarray(data[2]) @ res.w,
                                 jnp.asarray(data[3])))
    with pytest.raises(ValueError, match="want"):
        convert.ssgd_params_from_jax(w_np[:5], meta, device="cpu")


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    v = rng.random(50)
    np.testing.assert_array_equal(metrics.ewma(v), jmetrics.ewma(v))
    logits = rng.normal(size=171).astype(np.float32)
    labels = (rng.random(171) < 0.5).astype(np.float32)
    assert float(metrics.binary_accuracy(
        torch.as_tensor(logits), torch.as_tensor(labels))) == float(
        jmetrics.binary_accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    with pytest.raises(FloatingPointError, match="non-finite"):
        metrics.guard_finite(torch.tensor([1.0, float("nan")]), "w")
