"""Restarts and preemption across processes: two command-line processes
over gloo (``--multihost``, 2 emulated data shards each) against one
process holding 4, undisturbed, on the CPU.

The checkpoint directory is shared and process 0 its one writer, so
``ckpt:write`` fires there only, while ``segment:run`` fires on every
process at the same segment. Either way both ranks must raise at the
same boundary (a failed write travels in the boundary's all-gather), so
they restart together under ``--max-restarts`` and end with the
undisturbed run's final checkpoint bit for bit. A SIGTERM to rank 1
alone stops both ranks with rc 75 at the same boundary, and the re-run
of both resumes bit for bit.

Every child runs torch on one thread (the CPU's reductions depend on the
thread count).
"""

from __future__ import annotations

import os
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from tpu_distalg_torch.utils import checkpoint
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
#: 4 segments of 10 steps
ARGS = ["ssgd", "--n-iterations", "40", "--checkpoint-every", "10",
        "--quiet"]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("TDA_FAULT_PLAN", None)
    env.pop("TDA_TELEMETRY_DIR", None)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair_cmds(ckpt_dir, *extra):
    coord = f"127.0.0.1:{_free_port()}"
    return [[sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
             "--emulate", "2", "--multihost", "--coordinator-address", coord,
             "--num-processes", "2", "--process-id", str(r), *ARGS,
             "--checkpoint-dir", str(ckpt_dir), *extra] for r in range(2)]


def _start(cmds):
    return [subprocess.Popen(c, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=_env(),
                             cwd=REPO) for c in cmds]


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def _final(ckpt_dir):
    payload, step = checkpoint.restore(str(ckpt_dir))
    return step, payload["state"], payload["accs"]


def _assert_same(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The undisturbed run of one process × 4 shards."""
    d = tmp_path_factory.mktemp("one")
    out = subprocess.run(
        [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
         "--emulate", "4", *ARGS, "--checkpoint-dir", str(d)],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=_env(),
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return _final(d)


@pytest.mark.parametrize("plan", ["seed=1;segment:run@2=kill",
                                  "seed=1;ckpt:write@1=kill"],
                         ids=["segment-run-kill", "ckpt-write-kill"])
def test_both_ranks_restart_together_and_end_bitwise(one, tmp_path, plan):
    d = tmp_path / "ck"
    rcs, outs = _wait(_start(_pair_cmds(d, "--max-restarts", "2",
                                        "--fault-plan", plan)))
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-3000:]
        assert out.count("[restart 1/2]") == 1, out[-3000:]
        assert "[restart 2/2]" not in out, out[-3000:]
    _assert_same(_final(d), one)


def test_sigterm_to_one_rank_stops_both_at_one_boundary(one, tmp_path):
    d = tmp_path / "ck"
    plan = ["--fault-plan", "seed=1;segment:run@*=hang:0.5"]
    procs = _start(_pair_cmds(d, *plan))
    try:
        t_end = time.monotonic() + TIMEOUT_S
        while checkpoint.latest_step(str(d)) is None:
            assert all(p.poll() is None for p in procs), "a rank ended"
            assert time.monotonic() < t_end, "no checkpoint appeared"
            time.sleep(0.02)
        procs[1].send_signal(signal.SIGTERM)
    finally:
        rcs, outs = _wait(procs)
    assert rcs == [75, 75], [o[-3000:] for o in outs]
    steps = [re.search(r"\[preempted\] checkpoint saved at step (\d+)", o)
             for o in outs]
    assert all(steps), outs
    assert steps[0].group(1) == steps[1].group(1)
    assert checkpoint.latest_step(str(d)) == int(steps[0].group(1)) < 40
    rcs, outs = _wait(_start(_pair_cmds(d, *plan)))
    assert rcs == [0, 0], [o[-3000:] for o in outs]
    _assert_same(_final(d), one)
