"""The trace reduction and the per-layer readers on a made-up trace (the
CPU has no device operations to trace)."""

import pytest

from harness.registry import Registry
from harness.trace import Trace, short_name


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _ev("bench.window", "user_annotation", 1000, 1000),
    _ev("void ns::train_ring_kernel<bf16, 2, 2>(ns::Args, int)", "kernel",
        1050, 450),
    _ev("void ns::train_ring_kernel<bf16, 2, 2>(ns::Args, int)", "kernel",
        1600, 200),
    _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1650, 250),
    _ev("gemv", "kernel", 1950, 100),       # runs past the window's end
    _ev("aten::argsort", "cpu_op", 1500, 90),
    _ev("cudaLaunchKernel", "cuda_runtime", 1540, 20),
    _ev("outside", "kernel", 3000, 10),
]


def test_busy_is_the_union_inside_the_window():
    tr = Trace(EVENTS)
    assert tr.window_s == pytest.approx(1e-3)
    # [1050,1500] + [1600,1900] + [1950,2000]
    assert tr.busy_s() == pytest.approx(800e-6)
    assert tr.device_time("train_ring_kernel") == pytest.approx(650e-6)
    assert len(tr.device_ops) == 4


def test_gaps_are_named_by_the_innermost_host_event():
    gaps = Trace(EVENTS).idle_gaps()
    assert gaps[0] == ["host: cudaLaunchKernel", pytest.approx(100e-6)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert sum(g[1] for g in gaps) == pytest.approx(200e-6)
    assert gaps[1][0] == "host: between recorded ops"


def test_top_ops_by_short_name():
    top = Trace(EVENTS).top_ops()
    assert top[0] == ["ns::train_ring_kernel<bf16, 2, 2>",
                      pytest.approx(650e-6)]
    assert short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def test_readers_on_a_made_up_window():
    reg = Registry()
    cfg = reg.config("higgs-lr")
    pk = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}
    rows, steps = 1_049_600 * 10, 10
    ctx = {"trace": Trace(EVENTS), "peaks": pk, "config": cfg,
           "spans": {"prepare": 1.5}, "setup_s": 20.0,
           "window": {"seconds": 1e-3, "steps": steps, "rows": rows,
                      "rounds": 4, "launches": 1}}
    bound = (rows * 30 * 2 + steps * 8 * 29) / 3.35e12
    assert reg.reader("step_mfu_pct")(ctx) == pytest.approx(100 * bound / 1e-3)
    assert reg.reader("fused_train_gathered_roofline")(ctx) == \
        pytest.approx(100 * bound / 650e-6)
    assert reg.reader("device_idle_pct")(ctx) == pytest.approx(20.0)
    assert reg.reader("ma_device_ops_per_round")(ctx) == 1.0
    assert reg.reader("prepare_s")(ctx) == 1.5
    assert reg.reader("train_rows_per_s")(ctx) is None   # a traced window
    ctx["peaks"] = None
    assert reg.reader("fused_train_gathered_roofline")(ctx) is None
