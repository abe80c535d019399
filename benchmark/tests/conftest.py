"""Fixtures of the benchmark's CPU tests: the harness on the path, and a
tiny copy of the benchmark (the committed drivers, metrics and traffic,
a small configuration) in a temporary folder."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELLS = {"tiny-lr.ssgd": "higgs-lr.ssgd", "tiny-lr.ma4": "higgs-lr.ma4"}


def make_tiny(tmp: str):
    """A checkout-like folder whose benchmark holds one small
    configuration, the committed mixes shortened, and a cell of each;
    each cell judged by the limits of the full-size cell it stands for.
    Returns the Registry."""
    from harness.registry import Registry

    b = os.path.join(tmp, "benchmark")
    for d in ("drivers", "metrics", "traffic", "limits"):
        shutil.copytree(os.path.join(BENCH_DIR, d), os.path.join(b, d))
    os.makedirs(os.path.join(b, "configs"))
    with open(os.path.join(BENCH_DIR, "configs", "higgs-lr.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny-lr", n_train=40000, n_test=2000, n_features=8)
    with open(os.path.join(b, "configs", "tiny-lr.json"), "w") as f:
        json.dump(cfg, f)
    for t in ("ssgd", "ma4"):
        p = os.path.join(b, "traffic", t + ".json")
        with open(p) as f:
            tr = json.load(f)
        tr.update(gather_block_rows=64, mega_steps=5, segment_steps=20,
                  segment_rounds=6, trace_segments=2)
        with open(p, "w") as f:
            json.dump(tr, f)
    for tiny, full in TINY_CELLS.items():
        shutil.copy(os.path.join(b, "limits", full + ".json"),
                    os.path.join(b, "limits", tiny + ".json"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [dict(bench["configs"][0], name="tiny-lr",
                             file="benchmark/configs/tiny-lr.json")]
    bench["workloads"] = [
        dict(name=c, config="tiny-lr", traffic=c.split(".")[1], chips=1,
             why="a small copy for the CPU tests") for c in TINY_CELLS]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return Registry(root=tmp, bench_dir=b)


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(str(tmp_path))


@pytest.fixture
def run_tiny(tiny):
    """run(cell, trace=False, seed=...) → the result object of a CPU run."""
    import time

    from harness.cell import run_cell

    def run(cell, *, trace=False, seed=2**31 + 11, seconds=0.3):
        return run_cell(tiny, cell, seed=seed, seconds=seconds, trace=trace,
                        device="cpu", t_start=time.perf_counter())

    return run
