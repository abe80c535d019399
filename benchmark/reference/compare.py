"""The numbers that decide ``correct`` for a training cell.

A parameter vector is read as its leaves: the feature weights and the
bias. For a pair of vectors (the program's and the reference's) the gap
of a leaf is ``|‖p_leaf‖ − ‖r_leaf‖|``, and its difference
``‖p_leaf − r_leaf‖``, each over the larger of the reference's norm of
that leaf and of the median leaf (with an even count of leaves, the mean
of the middle two: with two leaves a small bias is not measured against
its own norm alone, where one float32 ulp of a weight near 1 is a large
share of a small change); a number is the worst leaf's. A leaf whose
reference gradient is under a thousandth of the median leaf's is left
out: it moves by round-off alone.

  * ``loss_gap``: the worst relative gap of the mean log-loss of each
    of the first steps' rows at the weights that step produced;
  * ``grad1_gap``: the gap of the first gradient as the update got it,
    ``(w0 − w1)/η``;
  * ``change3_gap``: the gap of the change after the first three steps;
  * ``segment_diff``: the difference of the change over the first whole
    call of the window's size (a gap of norms misses a change that
    turns without growing);
  * ``acc_gap``: the held-out accuracies' difference there (read, not
    compared: it tells the control from the program on no seed).
"""

from __future__ import annotations

import statistics

import torch

from reference import lr

#: a leaf whose reference gradient norm is under this share of the
#: median leaf's is left out of every gap
SILENT_LEAF = 1e-3


def leaves(v: torch.Tensor, n_features: int) -> dict:
    """The leaves of a bias-last (or augmented) parameter vector."""
    v = v.to(torch.float64)
    return {"weights": v[:n_features], "bias": v[n_features:n_features + 1]}


def moving_leaves(ref_grad: torch.Tensor, n_features: int) -> list:
    norms = {k: float(x.norm()) for k, x in leaves(ref_grad,
                                                  n_features).items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= SILENT_LEAF * med]


def leaf_gap(prog: torch.Tensor, ref: torch.Tensor, n_features: int,
             keep: list) -> float:
    p, r = leaves(prog, n_features), leaves(ref, n_features)
    rn = {k: float(r[k].norm()) for k in keep}
    med = statistics.median(rn.values())
    return max(abs(float(p[k].norm()) - rn[k]) / max(rn[k], med, 1e-300)
               for k in keep)


def leaf_diff(prog: torch.Tensor, ref: torch.Tensor, n_features: int,
              keep: list) -> float:
    p, r = leaves(prog, n_features), leaves(ref, n_features)
    rn = {k: float(r[k].norm()) for k in keep}
    med = statistics.median(rn.values())
    return max(float((p[k] - r[k]).norm()) / max(rn[k], med, 1e-300)
               for k in keep)


def training_numbers(*, n_features: int, eta: float, w0, prog: dict,
                     ref: dict, batches) -> dict:
    """``prog`` and ``ref`` hold ``first`` (the weights after each of the
    first steps), ``segment`` (after the first whole call of the
    window's size) and ``acc`` (held-out accuracy there); ``batches``
    the rows of each first step. Returns the numbers compared."""
    w0 = w0.to(torch.float32)
    d = n_features + 1
    p_first = [w[:d] for w in prog["first"]]
    r_first = ref["first"]
    g_ref = (w0 - r_first[0]) / eta
    keep = moving_leaves(g_ref, n_features)
    loss_gap = 0.0
    for (x, y), wp, wr in zip(batches, p_first, r_first):
        lr_ = lr.log_loss(wr, x, y)
        loss_gap = max(loss_gap, abs(lr.log_loss(wp, x, y) - lr_) / lr_)
    return {
        "loss_gap": loss_gap,
        "grad1_gap": leaf_gap((w0 - p_first[0]) / eta, g_ref, n_features,
                              keep),
        "change3_gap": leaf_gap(p_first[-1] - w0, r_first[-1] - w0,
                                n_features, keep),
        "segment_diff": leaf_diff(prog["segment"][:d] - p_first[-1],
                                  ref["segment"] - r_first[-1], n_features,
                                  keep),
        "acc_gap": abs(prog["acc"] - ref["acc"]),
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that has a limit within it, {name: {"value",
    "limit"}} of those numbers). A number that is missing or not finite
    fails."""
    out, ok = {}, True
    for k, lim in limits.items():
        v = numbers.get(k, float("nan"))
        out[k] = {"value": v, "limit": lim}
        if not v <= lim:
            ok = False
    return ok, out
