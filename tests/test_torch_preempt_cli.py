"""Preemption of a checkpointed command-line run of the port, in a
subprocess on the CPU (JAX ``tests/test_faults.py:471-531`` holds the
same contract in process).

``python -m tpu_distalg_torch.cli --device cpu ssgd --checkpoint-dir D``
is sent SIGTERM once its first checkpoint is on disk. It must finish the
segment it is in, save it, exit with rc 75 and leave a ``preempted``
event in its telemetry. Re-running the same command resumes from that
checkpoint and exits 0, and its final checkpoint is bit for bit an
undisturbed run's. A ``segment:run@*=hang`` rule keeps each segment
long enough to signal into; it changes no number.

Every child runs torch on one thread: the CPU's reductions depend on
the thread count, and the undisturbed run must add as the others do.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

from tpu_distalg_torch.utils import checkpoint
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
#: 4 segments of 10 steps; each segment waits 0.5 s at its seam
ARGS = ["ssgd", "--n-iterations", "40", "--checkpoint-every", "10",
        "--quiet"]
HANG = "seed=1;segment:run@*=hang:0.5"


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("TDA_FAULT_PLAN", None)
    env.pop("TDA_TELEMETRY_DIR", None)
    return env


def _cmd(ckpt_dir, *extra):
    return [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
            *ARGS, "--checkpoint-dir", str(ckpt_dir), *extra]


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=TIMEOUT_S, env=_env(), cwd=REPO)


def _final(ckpt_dir):
    payload, step = checkpoint.restore(str(ckpt_dir))
    return step, payload["state"], payload["accs"]


def _assert_same(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2], want[2])


def test_sigterm_exits_75_and_the_rerun_resumes_bitwise(tmp_path):
    ref = _run(_cmd(tmp_path / "ref"))
    assert ref.returncode == 0, ref.stderr[-3000:]
    d, tel = tmp_path / "ck", tmp_path / "tel"
    cmd = _cmd(d, "--fault-plan", HANG, "--telemetry-dir", str(tel))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(),
                            cwd=REPO)
    try:
        t_end = time.monotonic() + TIMEOUT_S
        while checkpoint.latest_step(str(d)) is None:
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < t_end, "no checkpoint appeared"
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 75, err[-3000:]
    assert "[preempted] checkpoint saved at step" in err
    step = checkpoint.latest_step(str(d))
    assert 10 <= step < 40
    evts = []
    for name in sorted(os.listdir(tel)):
        with open(tel / name) as f:
            evts += [json.loads(ln) for ln in f if ln.strip()]
    pre = [e for e in evts if e["ev"] == "preempted"]
    assert len(pre) == 1 and pre[0]["step"] == step
    assert pre[0]["signals"] == [int(signal.SIGTERM)]
    again = _run(cmd)
    assert again.returncode == 0, again.stderr[-3000:]
    _assert_same(_final(d), _final(tmp_path / "ref"))
