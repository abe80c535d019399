"""The benchmark of ``tpu_distalg_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell's parts are found by name
(``harness/registry.py``). With ``--trace 0`` the last line of standard
output carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a traced slice of the window. Without a
card, or with fewer cards than the cell asks for, or with JAX or the
JAX package loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness.cell import ForbiddenImport, print_result, run_cell
    from harness.registry import Registry

    reg = Registry()
    chips = reg.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result = run_cell(reg, args.workload, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device="cuda", t_start=T_START)
    except ForbiddenImport as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
