"""The local-update family: model averaging, BMUF and EASGD.

Port of ``tpu_distalg/models/local_sgd.py`` on the emulated data axis
(:mod:`..parallel`). Each of the ``R = mesh.n_data`` replicas holds its
own model and its own shard of the rows. A round: every replica starts
from the center ``w`` (``resync``) or from its own model, takes
``n_local_iterations`` (L) minibatch-SGD steps on its shard,

    w_l ← w_l − η·g/max(count, 1) − α·(w_l − w),

then the replicas' models are added in shard order and divided by R
(the JAX package's ``pmean``), and :func:`_make_combine` updates the
center: MA takes the average, BMUF filters it through a block momentum
``δ ← μ·δ + ζ·(w_avg − w); w ← w + δ``, EASGD blends ``w ← (1 − β)·w +
β·w_avg``. JAX's ``lax.scan`` over the rounds is a Python loop here that
makes no host sync; draws key on the absolute round id, so a segmented
run replays a straight one bit for bit. Samplers:

  * ``bernoulli``: a threefry Bernoulli mask over all rows, keyed on the
    round ``t`` (every local step of a round reuses it, as the
    reference does) or, with ``resample_per_local_step``, on
    ``t·L + l``; the gradient in plain torch;
  * ``fused_gather``: the rows packed once with y and validity
    (``ssgd_kernels.pack_augmented``, block rows ``gather_block_rows ×
    R``); every (round, local step, replica) block draw is made in one
    batched call before the loop, keyed on ``fold_in(fold_in(key, t),
    l)`` and the replica (without resampling, one draw a round serves
    all L steps); each local step is one launch of kernel B1
    (``fused_grad_sum_gathered``) over the replica's sampled blocks;
  * ``fused_train``: the same draws, and each replica's L local steps
    of a round in one launch of kernel B2 (``fused_train_gathered``),
    with the round's center as the elastic pull's target: R launches a
    round, one replica after another on one stream.

All replicas share one packed X2; replica s owns the blocks
``[s·n_blocks, (s+1)·n_blocks)`` of it, so its local block ids are made
global by adding ``s·n_blocks`` (the rows each replica reads are the
ones the JAX package's ``shard_map`` gives it).

Not ported yet, raising NotImplementedError with their ROADMAP item:
``comm`` other than ``dense`` and ``sync`` other than ``bsp`` (A9:
``make_ssp_train_fn``, ``_train_ssp``, ``_comm_sync``, ``_train_comm``).
The JAX package's own ValueErrors come first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.models.ssgd import fused_gather_geometry
from tpu_distalg_torch.ops import logistic, sampling, ssgd_kernels
from tpu_distalg_torch.parallel import Mesh, parallelize, tree_allreduce_sum
from tpu_distalg_torch.utils import metrics, prng


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    """The JAX package's fields and defaults (knob names follow the
    reference's ``ma.py:19-23``, ``bmuf.py:19-25``, ``easgd.py:19-25``)."""

    n_iterations: int = 300          # global rounds
    n_local_iterations: int = 5      # local steps per round
    eta: float = 0.1
    mini_batch_fraction: float = 0.1
    # round-level combine: 'average' (MA) | 'bmuf' | 'easgd'
    global_update: str = "average"
    resync: bool = True              # every replica starts at the center
    elastic_alpha: float = 0.0       # EASGD α = η·ρ (easgd.py:24)
    mu: float = 0.9                  # BMUF momentum (bmuf.py:24)
    zeta: float = 0.1                # BMUF block learning rate (bmuf.py:25)
    beta: float | None = None        # EASGD center rate; None → R·α
    resample_per_local_step: bool = False
    random_delta_init: bool = True   # BMUF δ ~ U[-1, 1) (bmuf.py:95)
    seed: int = 42
    init_seed: int = 7
    eval_test: bool = True
    sampler: str = "bernoulli"
    x_dtype: str = "float32"
    fused_pack: int = 16
    gather_block_rows: int = 1024
    shuffle_seed: int | None = None
    comm: str = "dense"
    sync: str = "bsp"


@dataclasses.dataclass
class TrainResult:
    w: torch.Tensor
    ws: torch.Tensor   # the replicas' final models (R, D)
    accs: torch.Tensor

    @property
    def final_acc(self) -> float:
        return float(self.accs[-1])


_SAMPLERS = ("bernoulli", "fused_gather", "fused_train")


def _check_sync_sampler(config: LocalSGDConfig) -> None:
    """The JAX package's refusal of SSP with a fused sampler, in its
    words (``local_sgd.py:188-196``)."""
    if str(config.sync).split(":")[0] == "ssp" and \
            config.sampler != "bernoulli":
        raise ValueError(
            f"sync={config.sync!r} (stale-synchronous) composes with "
            f"the 'bernoulli' sampler — got sampler="
            f"{config.sampler!r}; the fused kernels stay BSP")


def _check_config(config: LocalSGDConfig) -> None:
    """The JAX package's ValueErrors first, then NotImplementedError for
    what this port does not cover yet."""
    _check_sync_sampler(config)
    if config.sync != "bsp":
        raise NotImplementedError(
            f"sync={config.sync!r}: stale-synchronous local rounds are not "
            f"ported yet (ROADMAP A9); use sync='bsp'")
    if config.sampler not in _SAMPLERS:
        raise ValueError(f"unknown sampler {config.sampler!r}")
    if config.comm != "dense":
        raise NotImplementedError(
            f"comm={config.comm!r}: the round-combine schedules are not "
            f"ported yet (ROADMAP A9); use comm='dense'")
    if config.global_update not in ("average", "bmuf", "easgd"):
        raise ValueError(config.global_update)


def _derive_beta(config: LocalSGDConfig, n_replicas: int) -> float:
    return (config.beta if config.beta is not None
            else n_replicas * config.elastic_alpha)  # easgd.py:25


def _make_combine(config: LocalSGDConfig, beta: float):
    """The round-level combine shared by every sampler: the one place
    the MA, BMUF and EASGD center updates live. ``(w, delta) =
    combine(w, w_avg, delta)``."""

    def combine(w, w_avg, delta):
        if config.global_update == "average":
            return w_avg, delta
        if config.global_update == "bmuf":
            delta = config.mu * delta + config.zeta * (w_avg - w)
            return w + delta, delta  # bmuf.py:113-114
        if config.global_update == "easgd":
            return (1 - beta) * w + beta * w_avg, delta  # easgd.py:106
        raise ValueError(config.global_update)

    return combine


def _build_rounds(config: LocalSGDConfig, n_replicas: int, local_models,
                  prep_xs=None):
    """The round loop shared by every sampler: ``local_models(data,
    payload, ws, w)`` → the replicas' models after the round's local
    steps, a list of R (D,) tensors; then their average (added in shard
    order, divided by R), the combine and the evaluation.
    ``prep_xs(ts)`` maps the absolute round ids to the per-round
    payloads, all drawn before the loop; without it the payload is the
    round id. Returns ``train(data, X_test, y_test, w0, ws0, delta0,
    t0=0)`` → ``(w, ws, delta, accs)``."""
    combine = _make_combine(config, _derive_beta(config, n_replicas))

    def train(data, X_test, y_test, w0, ws0, delta0, t0=0):
        T = config.n_iterations
        dev = w0.device
        ts = torch.arange(t0, t0 + T, dtype=torch.int64, device=dev)
        payloads = prep_xs(ts) if prep_xs is not None else range(t0, t0 + T)
        w, ws, delta = w0, ws0, delta0
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        accs = []
        for i in range(T):
            per = local_models(data, payloads[i], ws, w)
            (total,) = tree_allreduce_sum((w_l,) for w_l in per)
            ws = torch.stack(per)
            w, delta = combine(w, total / n_replicas, delta)
            accs.append(metrics.binary_accuracy(X_test @ w, y_test)
                        if config.eval_test else zero)
        accs = (torch.stack(accs) if accs
                else torch.zeros((0,), dtype=torch.float32, device=dev))
        return w, ws, delta, accs

    return train


def _local_step(config: LocalSGDConfig, w_l, w, g, cnt):
    """``update_local_w`` (``ma.py:39-43``) and the elastic pull
    (``easgd.py:41-45``)."""
    g_mean = g / torch.clamp_min(cnt, 1.0)
    return w_l - config.eta * g_mean - config.elastic_alpha * (w_l - w)


def round_masks(config: LocalSGDConfig, t: int, valid: torch.Tensor
                ) -> torch.Tensor:
    """The ``bernoulli`` sampler's (L, n) masks of round ``t`` over all
    n rows (``local_sgd.py:546-561``): one threefry draw keyed on ``t``
    that every local step of the round reuses (the reference's
    ``sample(False, frac, 42+t)`` inside its local loop, ``ma.py:98-99``)
    or, with ``resample_per_local_step``, one keyed on ``t·L + l`` for
    step l."""
    L, n = config.n_local_iterations, valid.shape[0]
    key = prng.root_key(config.seed, valid.device)
    if config.resample_per_local_step:
        return torch.stack([
            sampling.bernoulli_mask(key, t * L + l, n,
                                    config.mini_batch_fraction, valid)
            for l in range(L)])
    mask = sampling.bernoulli_mask(key, t, n, config.mini_batch_fraction,
                                   valid)
    return mask.expand(L, n)


def make_train_fn(mesh: Mesh, config: LocalSGDConfig, n_padded: int):
    """The ``bernoulli`` trainer: call as ``fn(X, y, valid, X_test,
    y_test, w0, ws0, delta0, t0=0)`` → ``(w, ws, delta, accs)`` with X,
    y, valid the padded arrays of :func:`parallelize` (replica s holds
    rows ``[s·n_local, (s+1)·n_local)``)."""
    _check_config(config)
    R = mesh.n_data
    n_local = n_padded // R

    def local_models(data, t, ws, w):
        X, y, valid = data
        masks = round_masks(config, t, valid)
        per = []
        for s in range(R):
            rows = slice(s * n_local, (s + 1) * n_local)
            w_l = w if config.resync else ws[s]
            for l in range(config.n_local_iterations):
                g, cnt = logistic.grad_sum(X[rows], y[rows], w_l,
                                           masks[l, rows])
                w_l = _local_step(config, w_l, w, g, cnt)
            per.append(w_l)
        return per

    rounds = _build_rounds(config, R, local_models)

    def train(X, y, valid, X_test, y_test, w0, ws0, delta0, t0=0):
        return rounds((X, y, valid), X_test, y_test, w0, ws0, delta0, t0)

    return train


def block_draws(config: LocalSGDConfig, n_replicas: int, n_blocks: int,
                n_sampled: int, ts: torch.Tensor) -> torch.Tensor:
    """Every (round, local step, replica) block draw of the rounds
    ``ts`` in one batched call: (T, L, R, n_s) int32 ids local to each
    replica's ``n_blocks`` blocks, keyed as the JAX package keys them
    (``local_sgd.py:648-669``): ``sample_block_ids(fold_in(fold_in(key,
    t), l), R, …)``. Without resampling the one draw of a round
    (``l = 0``) is broadcast over its L steps."""
    L = config.n_local_iterations
    n_draws = L if config.resample_per_local_step else 1
    key = prng.root_key(config.seed, ts.device)
    keys = prng.fold_in(prng.fold_in(key, ts).unsqueeze(-2),
                        torch.arange(n_draws, device=ts.device))
    ids = sampling.sample_block_ids(keys, n_replicas, n_blocks, n_sampled)
    return ids.expand(ts.shape[0], L, n_replicas, n_sampled)


def make_train_fn_fused(mesh: Mesh, config: LocalSGDConfig, meta: dict):
    """The packed-layout trainers (``fused_gather``, ``fused_train``):
    call as ``fn(X2, X_test, y_test, w0, ws0, delta0, t0=0)`` → ``(w,
    ws, delta, accs)`` with the augmented (d_total,) center, (R, d_total)
    replicas and (d_total,) δ; X_test padded to d_total with zero
    columns. Unlike SSGD's one-launch schedule, ``fused_train`` composes
    with R > 1: local steps touch no other replica, and the round-end
    average is unchanged."""
    _check_config(config)
    if config.sampler not in ("fused_gather", "fused_train"):
        raise ValueError(f"sampler={config.sampler!r} is not a packed-"
                         f"layout sampler")
    R = mesh.n_data
    n_blocks, n_sampled = fused_gather_geometry(config, meta, R)
    d_t = meta["d_total"]
    col_keep = (torch.arange(d_t, device=mesh.device)
                < meta["y_col"]).to(torch.float32)
    kargs = dict(pack=meta["pack"], d_total=d_t, y_col=meta["y_col"],
                 v_col=meta["v_col"],
                 gather_block_rows=config.gather_block_rows)
    offsets = (torch.arange(R, dtype=torch.int32, device=mesh.device)
               * n_blocks)[:, None, None]

    def prep_xs(ts):
        # (T, R, L, n_s) global ids: replica s's L × n_s ids of a round
        # are one contiguous (L, n_s) block, as B2 takes them
        ids = block_draws(config, R, n_blocks, n_sampled,
                          ts).transpose(1, 2)
        return (ids + offsets).contiguous()

    if config.sampler == "fused_train":
        def local_models(X2, ids, ws, w):
            # each replica's L local steps are one launch of B2: the SGD
            # update and the elastic pull toward the round's center
            # run in the kernel (easgd.py:41-45, ma.py:98-102)
            return [ssgd_kernels.fused_train_gathered(
                        X2, w if config.resync else ws[s], ids[s],
                        eta=config.eta, alpha=config.elastic_alpha,
                        center=w, **kargs)
                    for s in range(R)]
    else:
        def local_models(X2, ids, ws, w):
            per = []
            for s in range(R):
                w_l = w if config.resync else ws[s]
                for l in range(config.n_local_iterations):
                    g, cnt = ssgd_kernels.fused_grad_sum_gathered(
                        X2, w_l, ids[s, l], **kargs)
                    w_l = _local_step(config, w_l, w, g * col_keep, cnt)
                per.append(w_l)
            return per

    return _build_rounds(config, R, local_models, prep_xs)


def init_state(config: LocalSGDConfig, d: int, d_total: int,
               n_replicas: int, device) -> tuple:
    """``(w0, ws0, delta0)`` as the JAX package draws them
    (``local_sgd.py:996-1007``, ``:823-843``): the center
    ``init_weights(fold_in(k, 0), d)``, the replicas ~ U[-1, 1) of shape
    (R, d) under ``fold_in(k, 1)`` (``ma.py:86``) and, for BMUF with
    ``random_delta_init``, δ ~ U[-1, 1) of (d,) under ``fold_in(k, 2)``
    (``bmuf.py:95``), ``k`` the key of ``init_seed``; each placed in the
    first d of ``d_total`` columns (the y/v/pad columns stay zero)."""
    k_init = prng.root_key(config.init_seed, device)
    w0 = torch.zeros((d_total,), dtype=torch.float32, device=device)
    w0[:d] = logistic.init_weights(prng.fold_in(k_init, 0), d)
    ws0 = torch.zeros((n_replicas, d_total), dtype=torch.float32,
                      device=device)
    ws0[:, :d] = prng.uniform(prng.fold_in(k_init, 1), (n_replicas, d),
                              -1.0, 1.0)
    delta0 = torch.zeros((d_total,), dtype=torch.float32, device=device)
    if config.global_update == "bmuf" and config.random_delta_init:
        delta0[:d] = prng.uniform(prng.fold_in(k_init, 2), (d,), -1.0, 1.0)
    return w0, ws0, delta0


def pack(X_train, y_train, mesh: Mesh, config: LocalSGDConfig):
    """(X2, meta): (X, y, validity) packed once in the kernels' layout on
    the mesh's device, block rows ``gather_block_rows × R`` so that each
    replica's rows are whole blocks (``local_sgd.py:813-819``)."""
    n = X_train.shape[0]
    return ssgd_kernels.pack_augmented(
        np.asarray(X_train), np.asarray(y_train), np.ones(n, np.float32),
        dtype=config.x_dtype, pack=config.fused_pack,
        block_rows=config.gather_block_rows * mesh.n_data,
        shuffle_seed=config.shuffle_seed, device=mesh.device)


def prepare_fused(X_train, y_train, mesh: Mesh, config: LocalSGDConfig):
    """One-time set-up of the fused samplers: pack the rows
    (:func:`pack`), draw the initial state (:func:`init_state`) and build
    the trainer. Returns ``(fn, X2, w0, ws0, delta0, meta)``; call as
    ``fn(X2, X_test_padded, y_test, w0, ws0, delta0)``."""
    X2, meta = pack(X_train, y_train, mesh, config)
    w0, ws0, delta0 = init_state(config, X_train.shape[1], meta["d_total"],
                                 mesh.n_data, mesh.device)
    return (make_train_fn_fused(mesh, config, meta), X2, w0, ws0, delta0,
            meta)


def _segmented(config: LocalSGDConfig, make_fn, data, state0,
               checkpoint_dir, checkpoint_every):
    """Run in checkpointed segments; the carry is ``(w, ws, delta)``."""
    from tpu_distalg_torch.utils import checkpoint as ckpt

    def run_seg(fn, state, t0):
        w, ws, delta, accs = fn(*data, *state, t0=t0)
        return (w, ws, delta), accs

    tag = f"local_sgd:{config.global_update}"
    if config.sampler != "bernoulli":
        tag += f":{config.sampler}"
    (w, ws, _), accs, _ = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, config.n_iterations,
        make_seg_fn=lambda seg: make_fn(
            dataclasses.replace(config, n_iterations=seg)),
        run_seg=run_seg, state0=state0, tag=tag)
    return w, ws, torch.from_numpy(accs)


def train(X_train, y_train, X_test, y_test, mesh: Mesh,
          config: LocalSGDConfig = LocalSGDConfig(), *,
          checkpoint_dir: str | None = None,
          checkpoint_every: int = 100) -> TrainResult:
    """End-to-end local-update training on the mesh's device; with
    ``checkpoint_dir``, in segments of ``checkpoint_every`` rounds saved
    after each (the carry: the center, the replicas and BMUF's δ) and
    resumed from the newest, bitwise equal to a straight run. The result
    holds the original-width (d,) center and (R, d) replicas."""
    _check_config(config)
    d = X_train.shape[1]
    X_te = np.asarray(X_test, np.float32)
    y_te = torch.as_tensor(np.asarray(y_test, np.float32)).to(mesh.device)
    if config.sampler == "bernoulli":
        Xs = parallelize(X_train, mesh,
                         dtype=ssgd_kernels.as_dtype(config.x_dtype))
        ys = parallelize(np.asarray(y_train, np.float32), mesh)
        state0 = init_state(config, d, d, mesh.n_data, mesh.device)
        data = (Xs.data, ys.data, Xs.mask,
                torch.as_tensor(X_te).to(mesh.device), y_te)

        def make_fn(cfg):
            return make_train_fn(mesh, cfg, Xs.n_padded)
    else:
        X2, meta = pack(X_train, y_train, mesh, config)
        state0 = init_state(config, d, meta["d_total"], mesh.n_data,
                            mesh.device)
        data = (X2, torch.as_tensor(np.pad(
            X_te, ((0, 0), (0, meta["d_total"] - d)))).to(mesh.device), y_te)

        def make_fn(cfg):
            return make_train_fn_fused(mesh, cfg, meta)
    if checkpoint_dir is None:
        w, ws, _, accs = make_fn(config)(*data, *state0)
        metrics.guard_finite((w, ws), "local-SGD models")
    else:
        w, ws, accs = _segmented(config, make_fn, data, state0,
                                 checkpoint_dir, checkpoint_every)
    return TrainResult(w=w[:d], ws=ws[:, :d], accs=accs)
