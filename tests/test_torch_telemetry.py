"""The port's telemetry (``tpu_distalg_torch/telemetry/``) against the
JAX package's on the CPU: the event schema, the heartbeat's stall line,
and ``report.summarize`` equal to JAX's on a directory either package
wrote, so ``tda report`` reads both. ``tda report`` on a missing path
exits 2 with one line on stderr."""

from __future__ import annotations

import json
import os

import pytest

from tpu_distalg.telemetry import events as jevents
from tpu_distalg.telemetry import report as jreport
from tpu_distalg_torch import cli, faults
from tpu_distalg_torch.telemetry import events, heartbeat, report
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

#: the fields of every line, in both packages
BASE_KEYS = {"ev", "t_wall", "t_mono", "run", "pid", "host"}


@pytest.fixture(autouse=True)
def _clean():
    yield
    events.configure(False)
    jevents.configure(False)
    faults.configure(False)


def _lines(directory):
    out = []
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            out += [json.loads(ln) for ln in f if ln.strip()]
    return out


def _session(ev_mod, directory):
    """One run's worth of the recovery shell's events."""
    ev_mod.configure(str(directory))
    with ev_mod.span("cli:ssgd"):
        ev_mod.mark("segment:ssgd@0")
        ev_mod.emit("fault_injected", point="ckpt:write", hit=1,
                    kind="oserror", arg=None)
        ev_mod.counter("faults.injected")
        ev_mod.emit("supervised", phase="ckpt:write", attempt=1, of=3,
                    outcome="error", seconds=0.001, error="x")
        ev_mod.emit("restart", attempt=1, of=2, error="InjectedKill: x")
        ev_mod.counter("restarts")
        ev_mod.emit("quarantine", path="d/step_2.npz")
        ev_mod.emit("checkpoint_saved", step=30, tag="ssgd")
        ev_mod.counter("checkpoints_saved", 2)
        ev_mod.emit("backend_init", phase="backend_init", attempt=1, of=2,
                    outcome="timeout", seconds=0.05, error="hung")
        ev_mod.emit("stall", phase="backend_init", seconds_since_mark=0.1,
                    stall_after=0.05)
        ev_mod.emit("heartbeat", phase="segment:ssgd@0",
                    seconds_since_mark=0.2, counters={"restarts": 1})
        ev_mod.gauge("serve.p99_ms", 1.5)
        ev_mod.emit("preempted", step=40, tag="ssgd", signals=[15])
    ev_mod.configure(False)


def test_event_schema_is_jax_s(tmp_path):
    _session(events, tmp_path / "p")
    _session(jevents, tmp_path / "j")
    got, want = _lines(tmp_path / "p"), _lines(tmp_path / "j")
    assert [e["ev"] for e in got] == [e["ev"] for e in want]
    for g, w in zip(got, want):
        assert BASE_KEYS <= set(g)
        assert set(g) == set(w), g["ev"]
    assert got[0]["ev"] == "run_start" and "argv" in got[0]
    assert [e["ev"] for e in got[-2:]] == ["counters", "run_end"]
    assert got[-2]["counters"] == {"faults.injected": 1, "restarts": 1,
                                   "checkpoints_saved": 2}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_summarize_equals_jax_s(writer, tmp_path):
    _session(jevents if writer == "jax" else events, tmp_path)
    got = report.summarize(report.load_events(str(tmp_path)))
    want = jreport.summarize(jreport.load_events(str(tmp_path)))
    assert got == want
    assert got["restarts"] == 1
    assert got["preemptions"] == [{"step": 40, "tag": "ssgd"}]
    assert report.render(got) == jreport.render(want)


def test_report_renders_a_port_run(tmp_path, capsys):
    """A chaos run through the port's CLI with ``--telemetry-dir``, then
    ``tda report`` on it."""
    tel = str(tmp_path / "tel")
    assert cli.main(["--device", "cpu", "chaos", "--workload", "lr",
                     "--n-slices", "2", "--n-iterations", "60",
                     "--checkpoint-every", "20", "--telemetry-dir", tel,
                     "--workdir", str(tmp_path / "w"), "--fault-plan",
                     "seed=7;ckpt:write@1=corrupt;segment:run@2=kill"]) == 0
    events.configure(False)
    capsys.readouterr()
    assert cli.main(["report", tel]) == 0
    out = capsys.readouterr().out
    assert "injected faults: 2 (ckpt:write#1=corrupt, segment:run#2=kill)" \
        in out
    assert "restarts: 1  quarantines: 1" in out


def test_report_on_a_missing_path_is_rc_2_and_one_line(tmp_path, capsys):
    assert cli.main(["report", str(tmp_path / "nowhere")]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    lines = captured.err.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("tda report: ")


def test_heartbeat_flags_one_stall_per_frozen_mark(tmp_path):
    events.configure(str(tmp_path))
    events.mark("segment:lr@0")
    t0 = events.last_mark()[0]
    clock = {"now": t0 + 1.0}
    hb = heartbeat.Heartbeat(interval=1.0, stall_after=5.0,
                             now=lambda: clock["now"])
    stalls = []
    hb.on_stall = lambda phase, age: stalls.append((phase, round(age)))
    hb.beat()
    clock["now"] = t0 + 10.0
    hb.beat()
    hb.beat()                       # the same frozen mark: no second stall
    events.mark("segment:lr@20")
    clock["now"] = events.last_mark()[0] + 1.0
    hb.beat()
    events.configure(False)
    assert stalls == [("segment:lr@0", 10)]
    assert (hb.n_beats, hb.n_stalls) == (4, 1)
    lines = [e for e in _lines(tmp_path) if e["ev"] in ("heartbeat", "stall")]
    assert [e["ev"] for e in lines] == ["heartbeat", "heartbeat", "stall",
                                        "heartbeat", "heartbeat"]
    stall = lines[2]
    assert stall["phase"] == "segment:lr@0" and stall["stall_after"] == 5.0
    assert stall["seconds_since_mark"] == pytest.approx(10.0)


def test_start_heartbeat_only_when_it_would_do_anything(tmp_path):
    assert heartbeat.start_heartbeat() is None
    events.configure(str(tmp_path))
    hb = heartbeat.start_heartbeat(interval=60.0)
    try:
        assert hb is not None and hb.n_beats == 1
    finally:
        hb.stop()
