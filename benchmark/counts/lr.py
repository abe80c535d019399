"""The work of logistic-regression SGD steps, counted from the
configuration's logical shapes, and the least time a card could take
for it.

A step over ``rows`` rows of ``n_features`` features reads each row's
features, its bias column and its label once in ``x_dtype`` (the
packed layout's validity and padding columns are the program's and are
not counted), and reads and writes the float32 weights once each:

    bytes = rows·(n_features + 2)·size(x_dtype) + 2·4·(n_features + 1)

and takes ``4·rows·(n_features + 1)`` operations (the forward and the
backward products; the sigmoid and the update are left out). The
arithmetic is float32 on the card's CUDA cores, so its peak is the
float32 rate; the byte term binds by tenfold at these shapes.
"""

from __future__ import annotations

import json
import os

_SIZES = {"float32": 4, "bfloat16": 2, "float16": 2}


def peaks(device_kind: str) -> dict | None:
    """The published peaks of a card, or None for a card not listed."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f).get(device_kind)


def sgd_work(n_features: int, x_dtype: str, rows: int, steps: int):
    """(operations, bytes) of ``steps`` steps over ``rows`` rows in all."""
    d = n_features + 1
    ops = 4 * rows * d
    nbytes = rows * (d + 1) * _SIZES[x_dtype] + steps * 2 * 4 * d
    return ops, nbytes


def bound_s(ops: int, nbytes: int, pk: dict) -> float:
    """The least time: the larger of operations over the float32 peak
    and bytes over the memory's."""
    return max(ops / pk["fp32_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])


def window_bound_s(ctx) -> float | None:
    """The least time for the steps of ``ctx``'s window (a reader's
    context), or None where the card's peaks or the steps are unknown."""
    w, pk = ctx["window"], ctx["peaks"]
    if pk is None or not w["steps"]:
        return None
    ops, nbytes = sgd_work(ctx["config"]["n_features"],
                           ctx["config"]["x_dtype"], w["rows"], w["steps"])
    return bound_s(ops, nbytes, pk)
