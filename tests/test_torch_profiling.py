"""The profiler entry point and the plots (``tpu_distalg_torch/utils/
profiling.py``, ``utils/metrics.py``'s ``StepTimer`` and
``display_clusters``, the command line's ``--profile DIR`` and ``kmeans
--plot``) on the CPU, against the JAX package's where it has a
counterpart.

A trace here holds CPU activity only (there is no card); the card's
kernels in a trace are ``chip_smoke.py`` phase 18's to check. Sizes are
the smallest runs of each command (a few steps), since the property is
what the files hold, not how long the run takes.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from tpu_distalg.utils import metrics as jmetrics
from tpu_distalg.utils import profiling as jprofiling
from tpu_distalg_torch import cli
from tpu_distalg_torch.utils import metrics, profiling
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))


def _trace_names(directory) -> set:
    files = glob.glob(os.path.join(str(directory),
                                   "*" + profiling.TRACE_SUFFIX))
    assert len(files) == 1, files
    with open(files[0]) as f:
        doc = json.load(f)
    return {e.get("name") for e in doc["traceEvents"] if e.get("ph") == "X"}


@pytest.mark.parametrize("cmd,ops", [
    (["ssgd", "--n-iterations", "5", "--quiet"],
     {"aten::sigmoid", "aten::mv"}),
    (["kmeans", "--n-points", "300", "--n-iterations", "3"],
     {"aten::sum"})])
def test_profile_flag_writes_a_trace_of_the_run(cmd, ops, tmp_path):
    """``--profile DIR`` wraps the run: one Chrome trace in DIR, its
    block labelled ``cli:<subcommand>``, holding the run's ops."""
    rc = cli.main(["--device", "cpu", "--profile", str(tmp_path), *cmd])
    assert rc == 0
    names = _trace_names(tmp_path)
    assert f"cli:{cmd[0]}" in names
    assert ops <= names


def test_maybe_trace_without_a_directory_is_a_no_op(tmp_path):
    with profiling.maybe_trace(None):
        torch.ones(3).sum()
    with profiling.maybe_trace(str(tmp_path / "t"), cuda=False,
                               name="block") as prof:
        torch.ones(3).sum()
    assert prof is not None and "block" in _trace_names(tmp_path / "t")


def test_steps_per_sec_stats_keys_equal_jax():
    """The same arguments and the same stats dict; the port waits for
    the card (a synchronize) where JAX fetches a leaf."""
    import jax.numpy as jnp

    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    rate, stats, out = profiling.steps_per_sec(
        fn, torch.ones(4), steps=10, repeats=4, chain=2, with_stats=True,
        with_output=True)
    jrate, jstats, jout = jprofiling.steps_per_sec(
        lambda x: x * 2, jnp.ones(4), steps=10, repeats=4, chain=2,
        with_stats=True, with_output=True)
    assert sorted(stats) == sorted(jstats)
    assert (stats["repeats"], stats["chain"]) == (jstats["repeats"],
                                                  jstats["chain"]) == (4, 2)
    assert stats["min"] <= stats["median"] <= stats["best"] == round(rate, 2)
    assert len(calls) == 1 + 4 * 2          # one warm call, then chains
    assert torch.equal(out, torch.full((4,), 2.0))
    assert isinstance(profiling.steps_per_sec(fn, torch.ones(1), steps=1,
                                              repeats=1, warmup=False),
                      float)


def test_step_timer_waits_and_times():
    with metrics.StepTimer() as t:
        time.sleep(0.02)
        t.result = {"w": torch.ones(3)}
    assert t.elapsed >= 0.02
    with metrics.StepTimer() as t2:
        pass
    assert 0 <= t2.elapsed < 1.0
    with pytest.raises(KeyError):
        with metrics.StepTimer() as t3:
            raise KeyError("boom")
    assert t3.elapsed >= 0


def test_display_clusters_writes_a_png_like_jax(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(40, 2)).astype(np.float32)
    lab = (pts[:, 0] > 0).astype(np.int64)
    metrics.display_clusters(pts, lab, str(tmp_path / "p.png"), k=2)
    jmetrics.display_clusters(pts, lab, str(tmp_path / "j.png"), k=2)
    for name in ("p.png", "j.png"):
        with open(tmp_path / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    msgs = []
    for mod in (metrics, jmetrics):
        with pytest.raises(ValueError) as e:
            mod.display_clusters(np.zeros((3, 3)), np.zeros(3),
                                 str(tmp_path / "x.png"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_plots_without_matplotlib_name_it(monkeypatch, tmp_path):
    """The card's machine has no matplotlib: asking for a plot there
    raises an ImportError that names the package."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        metrics.display_clusters(np.zeros((3, 2)), np.zeros(3),
                                 str(tmp_path / "x.png"))
    with pytest.raises(ImportError, match="matplotlib"):
        metrics.draw_acc_plot([0.5, 0.6], str(tmp_path / "y.png"))


def test_kmeans_plot_flag(tmp_path, capsys):
    """``kmeans --plot`` on the reference's toy matrix saves the scatter
    (JAX ``cli.py:1400-1411``); with ``--scale-points`` it says why it
    did not."""
    path = tmp_path / "k.png"
    assert cli.main(["--device", "cpu", "kmeans", "--plot", str(path)]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        f"saved plot: {path}"
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert cli.main(["--device", "cpu", "kmeans", "--scale-points", "2000",
                     "--dim", "2", "--k", "2", "--n-iterations", "2",
                     "--plot", str(tmp_path / "s.png")]) == 0
    assert "--plot ignored with --scale-points" in capsys.readouterr().out
    assert not (tmp_path / "s.png").exists()
