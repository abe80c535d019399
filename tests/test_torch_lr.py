"""The port's full-batch logistic regression
(``tpu_distalg_torch/models/logistic_regression.py`` and the ``lr``
subcommand) against the JAX package's ``models/logistic_regression.py``
on the CPU.

Full-batch gradient descent draws nothing, so both packages walk the
same path from the same initial weights; they add in other orders, and
the raw-sum update (``w ← w − η·Σg``, weights past 10⁴) amplifies the
difference slowly. The weights are held at 400 steps (measured: 2.4e-7
of the largest entry at most, up to 400 steps on 8 shards) and the full
1500-step run by the tail of its accuracy: the JAX test of the
reference's 0.941520 (``tests/test_optimizers.py``) is skipped in this
container, as its BLAS walks another 1500-step trajectory.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_distalg.models import logistic_regression as jlr
from tpu_distalg_torch.models import logistic_regression as lr
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import checkpoint, datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: steps at the end of the full run over which its accuracy is read
TAIL = 200


@pytest.fixture(scope="module")
def data():
    return datasets.breast_cancer_split()


def _port(data, n_shards, config, **kw):
    return lr.train(*data, get_mesh(data=n_shards, device="cpu"), config,
                    **kw)


@pytest.mark.parametrize("n_shards", [1, 8])
def test_lr_matches_jax(data, mesh1, mesh8, n_shards):
    """400 steps: the weights within 1e-5 of the largest entry; the
    accuracy histories equal but at most 2 steps, where one test row
    sits on the decision boundary and the two differ by its one
    prediction (measured: 1 step of 400 on one shard, none on 8)."""
    cfg = lr.LRConfig(n_iterations=400)
    want = jlr.train(*data, {1: mesh1, 8: mesh8}[n_shards],
                     jlr.LRConfig(n_iterations=400))
    got = _port(data, n_shards, cfg)
    w_j = np.asarray(want.w)
    assert got.w.shape == w_j.shape == (31,)
    np.testing.assert_allclose(got.w.numpy(), w_j, rtol=0,
                               atol=1e-5 * float(np.abs(w_j).max()))
    diff = np.abs(got.accs.numpy() - np.asarray(want.accs))
    assert (diff > 0).sum() <= 2
    np.testing.assert_allclose(diff, 0, atol=1.01 / len(data[3]))


def test_lr_full_run_in_the_band_beside_jax(data, mesh8):
    """1500 steps on 8 shards: the best accuracy of the last 200 steps
    at or above 0.92 (the reference's 0.941520 band) on both packages,
    the port's mean over them within 0.01 of the JAX run's (measured
    equal, 0.9137721)."""
    want = np.asarray(jlr.train(*data, mesh8, jlr.LRConfig()).accs)[-TAIL:]
    got = _port(data, 8, lr.LRConfig()).accs.numpy()
    assert got.shape == (1500,)
    assert got[-TAIL:].max() >= 0.92 and want.max() >= 0.92
    assert abs(float(got[-TAIL:].mean()) - float(want.mean())) <= 0.01


def test_lr_segmented_equals_straight(data, tmp_path):
    cfg = lr.LRConfig(n_iterations=90)
    straight = _port(data, 2, cfg)
    for _ in range(2):   # the second call resumes at the end
        seg = _port(data, 2, cfg, checkpoint_dir=str(tmp_path),
                    checkpoint_every=40)
        np.testing.assert_array_equal(seg.w.numpy(), straight.w.numpy())
        np.testing.assert_array_equal(seg.accs.numpy(),
                                      straight.accs.numpy())
    assert checkpoint.latest_step(str(tmp_path)) == 90


def test_lr_comm_trains_and_refuses_unknown(data):
    """LR trains under a schedule, int8 here (held against
    the JAX package in ``tests/test_torch_comms_trainers.py``), and an
    unknown schedule raises the JAX package's ValueError."""
    res = _port(data, 2, lr.LRConfig(n_iterations=3, comm="int8"))
    assert res.accs.shape == (3,) and bool(np.isfinite(res.w.numpy()).all())
    with pytest.raises(ValueError, match="unknown comm schedule"):
        _port(data, 2, lr.LRConfig(n_iterations=3, comm="zstd"))


def test_cli_lr_lines(data):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
         "lr", "--n-iterations", "120", "--n-slices", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    w = np.asarray(eval(lines[0][len("Final w: "):]), np.float32)
    want = _port(data, 4, lr.LRConfig(n_iterations=120))
    np.testing.assert_array_equal(w, want.w.numpy())
    assert lines[1] == f"Final acc: {want.final_acc:.6f}"
    assert lines[2].startswith("[lr] 120 iterations in ")
