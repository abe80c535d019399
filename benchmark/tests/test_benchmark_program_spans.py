"""The readers of the program's spans (``ssgd_draws_pct``,
``ssgd_eval_pct``, ``ssgd_host_waits_per_call``) on a made-up trace and
a made-up buffer of recorded spans; each reads nothing (None) where the
program recorded no span, as the MA driver, a run without a card or a
program without the spans leaves it."""

import types

import pytest

from harness.registry import Registry
from harness.trace import Trace
from tpu_distalg_torch.telemetry import events


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


# a window of 10 ms holding two SSGD calls
EVENTS = [
    _ev("bench.window", "user_annotation", 0, 10_000),
    _ev("ssgd.call", "user_annotation", 100, 4_000),
    _ev("ssgd.call", "user_annotation", 5_000, 4_000),
    _ev("ssgd.draws", "user_annotation", 200, 500),
    _ev("train_ring_kernel", "kernel", 800, 3_000),
    _ev("train_ring_kernel", "kernel", 5_800, 3_000),
    _ev("cudaStreamSynchronize", "cuda_runtime", 1_000, 2_000),
    _ev("cudaMemcpy", "cuda_runtime", 3_500, 10),
    _ev("cudaMemcpyAsync", "cuda_runtime", 3_600, 10),   # not a wait
    _ev("cudaStreamSynchronize", "cuda_runtime", 6_000, 2_000),
    _ev("cudaDeviceSynchronize", "cuda_runtime", 9_500, 400),  # between
]


def _span(name, device_s):
    return types.SimpleNamespace(name=name, device_s=device_s)


@pytest.fixture
def buffer(monkeypatch):
    """Put ``spans`` in place of the program's recorded buffer."""
    spans = []

    def recorded(name=None):
        return [s for s in spans if name is None or s.name == name]

    monkeypatch.setattr(events, "recorded", recorded)
    return spans


def _ctx(events_=EVENTS):
    return {"trace": Trace(events_)}


@pytest.mark.parametrize("metric,span", [("ssgd_draws_pct", "ssgd.draws"),
                                         ("ssgd_eval_pct", "ssgd.eval")])
def test_span_share_of_the_window(metric, span, buffer):
    read = Registry().reader(metric)
    assert read(_ctx()) is None                   # nothing recorded
    buffer += [_span(span, 1e-3), _span("ssgd.launch", 5e-3),
               _span(span, 0.5e-3)]
    assert read(_ctx()) == pytest.approx(15.0)    # 1.5 ms of 10 ms
    assert read({"trace": None}) is None
    buffer.append(_span(span, None))              # a span off the card
    assert read(_ctx()) is None


@pytest.mark.parametrize("metric", ["ssgd_draws_pct", "ssgd_eval_pct"])
def test_span_share_without_the_programs_buffer(metric, monkeypatch):
    """A program from before the buffer: the reader reads nothing and
    does not raise."""
    monkeypatch.delattr(events, "recorded")
    assert Registry().reader(metric)(_ctx()) is None


@pytest.mark.parametrize("metric", ["ssgd_draws_pct", "ssgd_eval_pct"])
def test_span_share_of_a_cpu_recording(metric):
    """Spans recorded without a card carry no device seconds."""
    with events.recording():
        with events.span("ssgd.call"):
            for name in ("ssgd.draws", "ssgd.eval"):
                with events.span(name, fine=True):
                    pass
    assert Registry().reader(metric)(_ctx()) is None


def test_host_waits_inside_the_calls():
    read = Registry().reader("ssgd_host_waits_per_call")
    # two syncs and one synchronous copy inside the calls; the copy
    # queued without a wait and the sync between calls do not count
    assert read(_ctx()) == pytest.approx(1.5)


def test_host_waits_without_calls_or_device_ops():
    read = Registry().reader("ssgd_host_waits_per_call")
    no_calls = [e for e in EVENTS if e["name"] != "ssgd.call"]
    assert read(_ctx(no_calls)) is None
    no_device = [e for e in EVENTS if e["cat"] != "kernel"]
    assert read(_ctx(no_device)) is None
    assert read({"trace": None}) is None
