"""Readings that a cell's limits are set from (not run by the benchmark's
own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds <s1,s2,...> \\
        [--out FILE]

For each seed, in one process: the cell's set-up (the program's first
steps and first whole call, as a run makes them), then the numbers that
decide ``correct`` for

  * ``program``: the program against the reference (the lower reading);
  * ``control``: the reference in the configuration's
    ``control_precision`` (one step below its precision) put in the
    program's place;
  * ``half_batch``: the reference with half of every batch left out, the
    mean taken over the rest;
  * ``no_exchange`` (cells with replicas): the reference with the
    round's average left out, the center taken from replica 0.

A step that returns its state unchanged reads 1 on ``grad1_gap`` by the
measure and needs no run. One JSON line a seed and reading, with the
weights each number was read from, so that a number defined anew can
be read again from them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)


def _vectors(side: dict) -> dict:
    return {"first": [w.tolist() for w in side["first"]],
            "segment": side["segment"].tolist(), "acc": side["acc"]}


def readings(reg, cell_name: str, seed: int, device) -> list:
    import torch

    from harness.cell import Spans

    cell = reg.cell(cell_name)
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    drv = reg.driver(traffic["driver"]).Driver(config, traffic, seed,
                                               torch.device(device))
    drv.setup(Spans())
    drv.free()
    ref = drv.reference()
    sides = {"program": drv.prog,
             "control": drv.reference(config["control_precision"]),
             "half_batch": drv.reference(keep=0.5)}
    if traffic.get("replicas", 1) > 1:
        sides["no_exchange"] = drv.reference(exchange=False)
    out = [{"cell": cell_name, "seed": seed, "side": k,
            "numbers": drv.numbers(v, ref), "vectors": _vectors(v)}
           for k, v in sides.items()]
    out.append({"cell": cell_name, "seed": seed, "side": "reference",
                "vectors": _vectors(ref), "w0": drv.task["w0"].tolist()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from harness.registry import Registry

    reg = Registry()
    out = open(args.out, "a") if args.out else sys.stdout
    try:
        for s in args.seeds.split(","):
            for line in readings(reg, args.workload, int(s), "cuda"):
                print(json.dumps(line), file=out, flush=True)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
