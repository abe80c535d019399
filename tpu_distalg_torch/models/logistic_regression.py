"""Full-batch distributed logistic regression.

Port of ``tpu_distalg/models/logistic_regression.py``: every step sums
the logistic gradient over all rows, shard by shard, adds the shards in
shard order (the reference's treeAggregate) and takes the reference's
unaveraged update ``w ← w − η·Σg`` (``logistic_regression.py:84``).
JAX's ``lax.scan`` over the steps is a Python loop here; the steps draw
nothing, so a segmented run equals a straight one bit for bit. No
kernel runs on this path (the JAX package has none for it either).

With ``comm`` other than ``dense`` the (Σg, count) sync runs the
schedule of :mod:`tpu_distalg_torch.parallel.comms` (``:55-190``): the
step id keys the int8 rounding, and the error-feedback residual (zero
width for stateless schedules) rides the carry and the checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.ops import logistic
from tpu_distalg_torch.parallel import (
    Mesh,
    parallelize,
    partition,
    spmd,
    tree_allreduce_sum,
)
from tpu_distalg_torch.utils import metrics, prng


@dataclasses.dataclass(frozen=True)
class LRConfig:
    """The JAX package's fields and defaults (knob names follow the
    reference's ``logistic_regression.py:17-19``)."""

    n_iterations: int = 1500
    eta: float = 0.1
    seed: int = 42
    init_seed: int = 7
    comm: str = "dense"


@dataclasses.dataclass
class TrainResult:
    w: torch.Tensor
    accs: torch.Tensor  # per-step test accuracy

    @property
    def final_acc(self) -> float:
        return float(self.accs[-1])


def _comm_sync(mesh: Mesh, config: LRConfig, d: int):
    from tpu_distalg_torch.parallel import comms

    return comms.make_sync(config.comm, mesh,
                           (comms.leaf((d,)), comms.leaf(())))


def make_train_fn(mesh: Mesh, config: LRConfig, *, d: int | None = None):
    """The step loop: call as ``fn(X, y, valid, X_test, y_test, w0,
    t0=0)`` → ``(w, accs)`` with X, y, valid the padded arrays of
    :func:`parallelize` (shard s holds rows ``[s·n_local,
    (s+1)·n_local)``). With ``comm`` other than ``dense`` pass ``d``
    (the feature width) and call ``fn(X, y, valid, X_test, y_test, w0,
    res0, t0=0)`` → ``(w, accs, res)``."""
    def partials(X, y, valid, w):
        # this process's shards' (Σg, count), in global shard order
        return spmd.data_parallel(lambda s: logistic.grad_sum(
            partition.data_block(X, s, mesh),
            partition.data_block(y, s, mesh), w,
            partition.data_block(valid, s, mesh)), mesh)

    if config.comm != "dense":
        if d is None:
            raise ValueError(
                f"comm={config.comm!r} needs the feature width: call "
                "make_train_fn(mesh, config, d=X.shape[1]) "
                "(lr.train does this for you)")
        sync = _comm_sync(mesh, config, d)

        def train_comm(X, y, valid, X_test, y_test, w0, res0, t0=0):
            w, res = w0, res0
            accs = []
            for t in range(t0, t0 + config.n_iterations):
                (g, _), res = sync.reduce(partials(X, y, valid, w), res, t)
                w = w - config.eta * g
                accs.append(metrics.binary_accuracy(X_test @ w, y_test))
            accs = (torch.stack(accs) if accs else torch.zeros(
                (0,), dtype=torch.float32, device=w0.device))
            return w, accs, res

        return train_comm

    def train(X, y, valid, X_test, y_test, w0, t0=0):
        del t0  # full-batch GD draws nothing; kept for segment symmetry
        w = w0
        accs = []
        for _ in range(config.n_iterations):
            g, _ = tree_allreduce_sum(partials(X, y, valid, w), mesh)
            w = w - config.eta * g  # logistic_regression.py:84, raw sum
            accs.append(metrics.binary_accuracy(X_test @ w, y_test))
        accs = (torch.stack(accs) if accs
                else torch.zeros((0,), dtype=torch.float32, device=w0.device))
        return w, accs

    return train


def train(X_train, y_train, X_test, y_test, mesh: Mesh,
          config: LRConfig = LRConfig(), *,
          checkpoint_dir: str | None = None,
          checkpoint_every: int = 500) -> TrainResult:
    """End-to-end on the mesh's device; with ``checkpoint_dir``, in
    segments of ``checkpoint_every`` steps saved after each (the carry
    is w; with a ``comm`` schedule, w and the residual) and resumed
    from the newest."""
    Xs = parallelize(X_train, mesh, table="lr", leaf="X")
    ys = parallelize(np.asarray(y_train, np.float32), mesh, table="lr",
                     leaf="y")
    w0 = logistic.init_weights(prng.root_key(config.init_seed, mesh.device),
                               X_train.shape[1])
    data = (Xs.data, ys.data, Xs.mask,
            torch.as_tensor(np.asarray(X_test, np.float32)).to(mesh.device),
            torch.as_tensor(np.asarray(y_test, np.float32)).to(mesh.device))
    if config.comm != "dense":
        return _train_comm(mesh, config, data, w0, X_train.shape[1],
                           checkpoint_dir, checkpoint_every)
    if checkpoint_dir is None:
        w, accs = make_train_fn(mesh, config)(*data, w0)
        metrics.guard_finite(w, "LR weights")
        return TrainResult(w=w, accs=accs)

    from tpu_distalg_torch.utils import checkpoint as ckpt

    def run_seg(fn, state, t0):
        w, accs = fn(*data, state[0], t0=t0)
        return (w,), accs

    (w,), accs, _ = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, config.n_iterations,
        make_seg_fn=lambda seg: make_train_fn(
            mesh, dataclasses.replace(config, n_iterations=seg)),
        run_seg=run_seg, state0=(w0,), tag="lr", mesh=mesh)
    return TrainResult(w=w, accs=torch.from_numpy(accs))


def _train_comm(mesh: Mesh, config: LRConfig, data, w0, d: int,
                checkpoint_dir, checkpoint_every) -> TrainResult:
    """``comm`` schedules (``logistic_regression.py:150-184``): the
    residual is placed by the ``lr`` rule table and carried with w."""
    from tpu_distalg_torch.parallel import comms

    sync = _comm_sync(mesh, config, d)
    res0 = partition.place({"res": sync.init_state()}, "lr", mesh)["res"]
    if checkpoint_dir is None:
        w, accs, _ = make_train_fn(mesh, config, d=d)(*data, w0, res0)
        comms.emit_sync_counters(sync, config.n_iterations)
        metrics.guard_finite(w, "LR weights")
        return TrainResult(w=w, accs=accs)

    from tpu_distalg_torch.utils import checkpoint as ckpt

    def run_seg(fn, state, t0):
        w, res = state
        res = partition.place({"res": res}, "lr", mesh)["res"]
        w, accs, res = fn(*data, w, res, t0=t0)
        return (w, res), accs

    (w, _), accs, start = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, config.n_iterations,
        make_seg_fn=lambda seg: make_train_fn(
            mesh, dataclasses.replace(config, n_iterations=seg), d=d),
        run_seg=run_seg, state0=(w0, res0), tag=f"lr:comm={config.comm}",
        mesh=mesh, sharded=(False, True))
    # only the syncs this process ran (a resume skips the rest)
    comms.emit_sync_counters(sync, config.n_iterations - start)
    return TrainResult(w=w, accs=torch.from_numpy(accs))
