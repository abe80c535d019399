"""``correct`` comes out false for the control and for each fault a
training cell can have, at a size a test run holds (the CPU, the port's
plain path), judged by the full-size cells' limits.

The control is the reference put in the program's place one precision
below the configuration's (float8 e4m3 for bfloat16). The faults are
planted in the program under the harness: a step that returns its state
unchanged, half of every batch left out (the mean over the rest), and
the average across replicas left out."""

import pytest
import torch

import calibrate
from reference import compare

CELLS = ["tiny-lr.ssgd", "tiny-lr.ma4"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_reference_faults_fail(tiny, cell):
    limits = tiny.limits(cell)
    reads = {r["side"]: r["numbers"]
             for r in calibrate.readings(tiny, cell, 2**31 + 3, "cpu")
             if "numbers" in r}
    assert compare.judge(reads.pop("program"), limits)[0]
    assert set(reads) >= {"control", "half_batch"}
    for side, numbers in reads.items():
        assert not compare.judge(numbers, limits)[0], side


def _half_batch(orig):
    def broken(X2, w0, block_idx, **kw):
        return orig(X2, w0, block_idx[:, :max(1, block_idx.shape[1] // 2)],
                    **kw)
    return broken


def _unchanged(orig):
    def broken(X2, w0, block_idx, **kw):
        orig(X2, w0, block_idx, **kw)
        return w0.clone()
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_program_faults_fail(run_tiny, monkeypatch, cell, fault):
    from tpu_distalg_torch.ops import ssgd_kernels

    assert run_tiny(cell)["correct"]
    monkeypatch.setattr(ssgd_kernels, "fused_train_gathered",
                        fault(ssgd_kernels.fused_train_gathered))
    res = run_tiny(cell)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_exchange_left_out_fails(run_tiny, monkeypatch):
    from tpu_distalg_torch.models import local_sgd

    orig = local_sgd.tree_allreduce_sum

    def no_exchange(parts, mesh):
        parts = list(parts)
        return tuple(x * len(parts) for x in parts[0])

    monkeypatch.setattr(local_sgd, "tree_allreduce_sum", no_exchange)
    res = run_tiny("tiny-lr.ma4")
    assert res["correct"] is False
    monkeypatch.setattr(local_sgd, "tree_allreduce_sum", orig)
    assert run_tiny("tiny-lr.ma4")["correct"]


@pytest.mark.gpu
def test_cells_correct_on_the_card():
    """One short run of each committed cell on the card, untraced."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import time

    from harness.cell import run_cell
    from harness.registry import Registry

    reg = Registry()
    for w in reg.bench["workloads"]:
        res = run_cell(reg, w["name"], seed=2**31 + 17, seconds=2.0,
                       trace=False, device="cuda",
                       t_start=time.perf_counter())
        assert res["correct"], (w["name"], res["checks"])
