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


# ------------------------------------------------------------ program spans

SSGD_FINE = {"ssgd.build": 1, "ssgd.draws": 1, "ssgd.launch": 2,
             "ssgd.eval": 2, "ssgd.guard": 1}


def _fused_train_call():
    """One CPU ``train_prepared`` call of ``fused_train``: 250 steps, two
    launches of 125 (B2's plain version), each evaluated; the rows
    packed outside the call."""
    import numpy as np
    import torch

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import get_mesh

    rng = np.random.default_rng(3)
    X = rng.normal(size=(2048, 7)).astype(np.float32)
    y = (rng.random(2048) < 0.5).astype(np.float32)
    mesh = get_mesh(data=1, device="cpu")
    cfg = ssgd.SSGDConfig(sampler="fused_train", n_iterations=250,
                          mega_steps=125, eval_every=125,
                          gather_block_rows=64)
    _, X2, w0, meta = ssgd.prepare_fused(X, y, mesh, cfg)
    X_te = torch.zeros((128, meta["d_total"]))
    X_te[:, :7] = torch.from_numpy(X[:128])
    X_te[:, 7] = 1.0
    return ssgd.train_prepared(mesh, cfg, X2, w0, meta, X_te,
                               torch.from_numpy(y[:128]))


def _counts(spans) -> dict:
    out: dict = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def test_span_off_writes_records_and_calls_nothing(monkeypatch):
    import tracemalloc

    import torch

    with events.recording():
        pass                        # empties the buffer

    def no_torch(*a, **k):
        raise AssertionError("an idle span called torch")

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        no_torch)
    monkeypatch.setattr(torch.cuda, "is_initialized", no_torch)
    idle = events.span("ssgd.call")
    assert events.span("ssgd.launch", fine=True, x=1) is idle
    with idle:
        with events.span("ssgd.eval", fine=True):
            pass
    assert events.last_mark()[1] == "ssgd.eval"
    assert events.recorded() == [] and events.get_sink() is None

    def loop(n):
        for _ in range(n):
            with events.span("ssgd.launch", fine=True):
                pass

    loop(100)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        loop(5000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, events.__file__)]
    grown = [d for d in after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno") if d.count_diff > 0]
    assert grown == []


def test_recording_counts_and_nests_a_fused_train_call():
    plain = _fused_train_call()
    with events.recording():
        res = _fused_train_call()
    spans = events.recorded()
    assert _counts(spans) == dict(SSGD_FINE, **{
        "ssgd.call": 1, "ssgd.prepare": 1, "pack.host": 1, "pack.h2d": 1})
    (call,) = events.recorded("ssgd.call")
    assert call.parent is None and call.fields["steps"] == 250
    for s in spans:
        assert s.ok and s.t0 <= s.t1 and s.device_s is None   # no card
        if s.name in SSGD_FINE:
            assert s.parent is call
            assert call.t0 <= s.t0 and s.t1 <= call.t1
        elif s.name.startswith("pack."):
            assert s.parent.name == "ssgd.prepare"
    launches = events.recorded("ssgd.launch")
    evals = events.recorded("ssgd.eval")
    assert launches[0].t1 <= evals[0].t0 <= launches[1].t0
    assert res.w.equal(plain.w) and res.accs.equal(plain.accs)


def test_profiler_trace_holds_the_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with events.recording():
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fused_train_call()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    got = {n: names.count(n) for n in set(names)}
    assert got == dict(SSGD_FINE, **{
        "ssgd.call": 1, "ssgd.prepare": 1, "pack.host": 1, "pack.h2d": 1})
    assert _counts(events.recorded()) == got   # recorded under the profiler


def test_profile_flag_trace_holds_the_spans(tmp_path):
    """``--profile DIR`` on the CLI: the trace carries the call's spans
    (``bernoulli``: a draw and a launch a step)."""
    assert cli.main(["--device", "cpu", "--profile", str(tmp_path),
                     "ssgd", "--n-iterations", "5", "--quiet"]) == 0
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("ssgd.call") == 1
    assert names.count("ssgd.launch") == 5
    assert names.count("ssgd.draws") == 6
    assert names.count("ssgd.guard") == 1


def test_sink_writes_the_call_with_its_children(tmp_path, capsys):
    events.configure(str(tmp_path))
    _fused_train_call()
    events.configure(False)
    lines = [e for e in _lines(tmp_path) if e["ev"].startswith("span_")]
    assert [(e["ev"], e["name"]) for e in lines] == [
        ("span_start", "ssgd.prepare"), ("span_end", "ssgd.prepare"),
        ("span_start", "ssgd.call"), ("span_end", "ssgd.call")]
    assert set(lines[1]["children"]) == {"pack.host", "pack.h2d"}
    end = lines[3]
    assert end["ok"] and end["sampler"] == "fused_train"
    assert {k: n for k, (n, _) in end["children"].items()} == SSGD_FINE
    assert sum(s for _, s in end["children"].values()) <= end["seconds"]
    capsys.readouterr()
    assert cli.main(["report", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "  ssgd.call: " in out and "over 1 span(s)" in out
    assert "    ssgd.launch: " in out and "over 2 span(s)" in out


def test_failing_call_span_writes_and_records_the_error(tmp_path):
    events.configure(str(tmp_path))
    with pytest.raises(ValueError), events.recording():
        with events.span("ssgd.call"):
            with events.span("ssgd.launch", fine=True):
                raise ValueError("boom")
    events.configure(False)
    (end,) = [e for e in _lines(tmp_path) if e["ev"] == "span_end"]
    assert end["ok"] is False and end["error"] == "ValueError: boom"
    assert end["children"]["ssgd.launch"][0] == 1
    assert [s.ok for s in events.recorded()] == [False, False]


def test_recording_counts_a_local_sgd_round_loop():
    import numpy as np
    import torch

    from tpu_distalg_torch.models import local_sgd
    from tpu_distalg_torch.parallel import get_mesh

    rng = np.random.default_rng(5)
    X = rng.normal(size=(2048, 7)).astype(np.float32)
    y = (rng.random(2048) < 0.5).astype(np.float32)
    mesh = get_mesh(data=2, device="cpu")
    cfg = local_sgd.LocalSGDConfig(n_iterations=3, n_local_iterations=2,
                                   sampler="fused_train",
                                   gather_block_rows=64)
    fn, X2, w0, ws0, delta0, meta = local_sgd.prepare_fused(X, y, mesh, cfg)
    X_te = torch.zeros((128, meta["d_total"]))
    X_te[:, :7] = torch.from_numpy(X[:128])
    with events.recording():
        fn(X2, X_te, torch.from_numpy(y[:128]), w0, ws0, delta0)
    spans = events.recorded()
    assert _counts(spans) == {
        "local_sgd.call": 1, "local_sgd.draws": 1,
        "local_sgd.local_steps": 3, "local_sgd.average": 3,
        "local_sgd.combine": 3, "local_sgd.eval": 3}
    (call,) = events.recorded("local_sgd.call")
    assert all(s.parent is call for s in spans if s is not call)


def test_importing_telemetry_imports_no_torch():
    """Importing the package, and an idle span, load no torch: a span
    finds torch in ``sys.modules`` once a trainer has loaded it."""
    import subprocess
    import sys

    code = ("import sys, tpu_distalg_torch.telemetry as t; "
            "t.span('x').__enter__(); print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=os.path.dirname(
                             os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "False"


def test_recorded_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(events, "MAX_RECORDED", 3)
    with events.recording():
        for i in range(5):
            with events.span(f"s{i}"):
                pass
    assert [s.name for s in events.recorded()] == ["s2", "s3", "s4"]


def test_recording_from_many_threads_keeps_every_span():
    """More threads than cores open spans at once under a short switch
    interval: none is lost, and each nests under its own thread's."""
    import sys
    import threading

    n_threads, per = 4 * (os.cpu_count() or 1), 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            with events.span(f"outer{k}"):
                for _ in range(per):
                    with events.span("inner", fine=True):
                        pass

        with events.recording():
            threads = [threading.Thread(target=work, args=(k,), daemon=True)
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    inner = events.recorded("inner")
    assert len(inner) == n_threads * per
    assert all(s.parent.name.startswith("outer") for s in inner)
    by_outer = _counts(s.parent for s in inner)
    assert set(by_outer.values()) == {per}
