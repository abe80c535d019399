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
ones the JAX package's ``shard_map`` gives it). Across processes a
process holds its replicas' rows and runs their local steps
(:func:`..parallel.spmd.data_parallel`) and keeps their models, the
rows of ``ws`` that the ``local_sgd`` table cuts over the data axis;
the round's average gathers every replica's model
(:func:`..parallel.collectives.tree_allreduce_sum`) and adds them in
replica order, so the center is equal on every process.

With ``comm`` other than ``dense`` the round-end average runs the
schedule of :mod:`tpu_distalg_torch.parallel.comms` on every sampler
(``local_sgd.py:111-167``, ``:498-891``; under ``fused_train``: R
launches of B2, then the schedule's combine); its residual rides the
carry and the checkpoint. With ``sync='ssp[:s[:decay]]'`` the
``bernoulli`` sampler runs windows of ``s`` rounds between
staleness-weighted merges under the seeded straggle and membership
schedules (:func:`make_ssp_train_fn`, ``:199-497``); the fused samplers
stay BSP, refused in the JAX package's words.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.models.ssgd import fused_gather_geometry
from tpu_distalg_torch.ops import logistic, sampling, ssgd_kernels
from tpu_distalg_torch.parallel import (
    DATA_AXIS,
    Mesh,
    parallelize,
    partition,
    spmd,
    tree_allreduce_sum,
)
from tpu_distalg_torch.telemetry import events as tevents
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
    ws: torch.Tensor   # this process's replicas' final models (R/P, D)
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
    """The JAX package's ValueErrors."""
    from tpu_distalg_torch.parallel import comms, ssp

    _check_sync_sampler(config)
    ssp.SyncSpec.parse(config.sync)
    comms.CommSpec.parse(config.comm)
    if config.sampler not in _SAMPLERS:
        raise ValueError(f"unknown sampler {config.sampler!r}")
    if config.global_update not in ("average", "bmuf", "easgd"):
        raise ValueError(config.global_update)


def _comm_sync(mesh: Mesh, config: LocalSGDConfig, d: int):
    """The round combine's CommSync: one (d,) leaf, the replica's model
    being averaged (``local_sgd.py:158``)."""
    from tpu_distalg_torch.parallel import comms

    return comms.make_sync(config.comm, mesh, (comms.leaf((d,)),))


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


def _build_rounds(config: LocalSGDConfig, mesh: Mesh, local_models,
                  prep_xs=None, sync=None):
    """The round loop shared by every sampler: ``local_models(data,
    payload, ws, w)`` → this process's replicas' models after the
    round's local steps, a list of (D,) tensors, which become its rows
    of ``ws``; then the average of every replica's model (gathered
    across processes, added in shard order, divided by R), the combine
    and the evaluation.
    ``prep_xs(ts)`` maps the absolute round ids to the per-round
    payloads, all drawn before the loop; without it the payload is the
    round id. Returns ``train(data, X_test, y_test, w0, ws0, delta0,
    t0=0)`` → ``(w, ws, delta, accs)``; with ``sync`` (a CommSync) the
    average is the schedule's ``reduce_mean`` keyed on the round id, and
    ``train(data, X_test, y_test, w0, ws0, delta0, res0, t0=0)`` →
    ``(w, ws, delta, res, accs)``. A call is the ``local_sgd.call``
    span; the draws and, each round, the local steps, the average, the
    combine and the evaluation are its fine spans ``local_sgd.draws``,
    ``.local_steps``, ``.average``, ``.combine`` and ``.eval``."""
    n_replicas = mesh.n_data
    combine = _make_combine(config, _derive_beta(config, n_replicas))

    def rounds(data, X_test, y_test, w0, ws0, delta0, res0, t0=0):
        with tevents.span("local_sgd.call", update=config.global_update,
                          rounds=config.n_iterations):
            T = config.n_iterations
            dev = w0.device
            with tevents.span("local_sgd.draws", fine=True):
                ts = torch.arange(t0, t0 + T, dtype=torch.int64, device=dev)
                payloads = (prep_xs(ts) if prep_xs is not None
                            else range(t0, t0 + T))
            w, ws, delta, res = w0, ws0, delta0, res0
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            accs = []
            for i in range(T):
                with tevents.span("local_sgd.local_steps", fine=True):
                    per = local_models(data, payloads[i], ws, w)
                with tevents.span("local_sgd.average", fine=True):
                    if sync is None:
                        (total,) = tree_allreduce_sum(
                            ((w_l,) for w_l in per), mesh)
                        w_avg = total / n_replicas
                    else:
                        (w_avg,), res = sync.reduce_mean(
                            [(w_l,) for w_l in per], res, t0 + i)
                with tevents.span("local_sgd.combine", fine=True):
                    ws = torch.stack(per)
                    w, delta = combine(w, w_avg, delta)
                if config.eval_test:
                    with tevents.span("local_sgd.eval", fine=True):
                        accs.append(metrics.binary_accuracy(X_test @ w, y_test))
                else:
                    accs.append(zero)
            accs = (torch.stack(accs) if accs
                    else torch.zeros((0,), dtype=torch.float32, device=dev))
            return w, ws, delta, res, accs

    if sync is not None:
        return rounds

    def train(data, X_test, y_test, w0, ws0, delta0, t0=0):
        w, ws, delta, _, accs = rounds(data, X_test, y_test, w0, ws0,
                                       delta0, None, t0)
        return w, ws, delta, accs

    return train


def _local_step(config: LocalSGDConfig, w_l, w, g, cnt):
    """``update_local_w`` (``ma.py:39-43``) and the elastic pull
    (``easgd.py:41-45``)."""
    g_mean = g / torch.clamp_min(cnt, 1.0)
    return w_l - config.eta * g_mean - config.elastic_alpha * (w_l - w)


def round_masks(config: LocalSGDConfig, t: int, valid: torch.Tensor,
                mesh: Mesh | None = None) -> torch.Tensor:
    """The ``bernoulli`` sampler's (L, n) masks of round ``t`` over all
    n rows (``local_sgd.py:546-561``): one threefry draw keyed on ``t``
    that every local step of the round reuses (the reference's
    ``sample(False, frac, 42+t)`` inside its local loop, ``ma.py:98-99``)
    or, with ``resample_per_local_step``, one keyed on ``t·L + l`` for
    step l. With a ``mesh`` that spans processes, ``valid`` holds this
    process's rows: the draw covers every row and keeps those."""
    L, n_held = config.n_local_iterations, valid.shape[0]
    n = n_held if mesh is None else n_held // mesh.n_local * mesh.n_data
    key = prng.root_key(config.seed, valid.device)
    if config.resample_per_local_step:
        return torch.stack([
            sampling.bernoulli_mask(key, t * L + l, n,
                                    config.mini_batch_fraction, valid, mesh)
            for l in range(L)])
    mask = sampling.bernoulli_mask(key, t, n, config.mini_batch_fraction,
                                   valid, mesh)
    return mask.expand(L, n_held)


def _sync_for(mesh: Mesh, config: LocalSGDConfig, d: int | None):
    if config.comm == "dense":
        return None
    if d is None:
        raise ValueError(
            f"comm={config.comm!r} needs the model width: call "
            "make_train_fn(mesh, config, n_padded, d=D) "
            "(local_sgd.train does this for you)")
    return _comm_sync(mesh, config, d)


def make_train_fn(mesh: Mesh, config: LocalSGDConfig, n_padded: int, *,
                  d: int | None = None):
    """The ``bernoulli`` trainer: call as ``fn(X, y, valid, X_test,
    y_test, w0, ws0, delta0, t0=0)`` → ``(w, ws, delta, accs)`` with X,
    y, valid the padded arrays of :func:`parallelize` (replica s holds
    rows ``[s·n_local, (s+1)·n_local)``) and ws0 placed by
    :func:`placed_state`. With ``comm`` other than
    ``dense`` pass ``d`` and call ``fn(X, y, valid, X_test, y_test, w0,
    ws0, delta0, res0, t0=0)`` → ``(w, ws, delta, res, accs)``."""
    _check_config(config)
    sync = _sync_for(mesh, config, d)
    del n_padded   # the rows come from valid, this process's

    def local_models(data, t, ws, w):
        X, y, valid = data
        masks = round_masks(config, t, valid, mesh)

        def one(s):
            X_s = partition.data_block(X, s, mesh)
            y_s = partition.data_block(y, s, mesh)
            m_s = partition.data_block(masks, s, mesh, dim=1)
            w_l = w if config.resync else ws[partition.held_index(s, mesh)]
            for l in range(config.n_local_iterations):
                g, cnt = logistic.grad_sum(X_s, y_s, w_l, m_s[l])
                w_l = _local_step(config, w_l, w, g, cnt)
            return w_l

        return spmd.data_parallel(one, mesh)

    rounds = _build_rounds(config, mesh, local_models, sync=sync)

    if sync is not None:
        def train_comm(X, y, valid, X_test, y_test, w0, ws0, delta0, res0,
                       t0=0):
            return rounds((X, y, valid), X_test, y_test, w0, ws0, delta0,
                          res0, t0)

        return train_comm

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
    ws, delta, accs)`` with the augmented (d_total,) center, this
    process's (R/P, d_total) replicas (:func:`placed_state`) and
    (d_total,) δ; X_test padded to d_total with zero
    columns. Unlike SSGD's one-launch schedule, ``fused_train`` composes
    with R > 1: local steps touch no other replica, and the round-end
    average is unchanged. With ``comm`` other than ``dense``: ``fn(X2,
    X_test, y_test, w0, ws0, delta0, res0, t0=0)`` → ``(w, ws, delta,
    res, accs)``."""
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
    offsets = (torch.arange(mesh.n_local, dtype=torch.int32,
                            device=mesh.device) * n_blocks)[:, None, None]

    def prep_xs(ts):
        # (T, replicas held, L, n_s) ids into this process's X2: replica
        # s's L × n_s ids of a round are one contiguous (L, n_s) block,
        # as B2 takes them; the draws are keyed on the global replica
        ids = block_draws(config, R, n_blocks, n_sampled,
                          ts).transpose(1, 2)
        held = partition.local_block(ids, (None, DATA_AXIS), mesh)
        return (held + offsets).contiguous()

    if config.sampler == "fused_train":
        def local_models(X2, ids, ws, w):
            # each replica's L local steps are one launch of B2: the SGD
            # update and the elastic pull toward the round's center
            # run in the kernel (easgd.py:41-45, ma.py:98-102)
            def one(s):
                i = partition.held_index(s, mesh)
                return ssgd_kernels.fused_train_gathered(
                    X2, w if config.resync else ws[i], ids[i],
                    eta=config.eta, alpha=config.elastic_alpha, center=w,
                    **kargs)

            return spmd.data_parallel(one, mesh)
    else:
        def local_models(X2, ids, ws, w):
            def one(s):
                i = partition.held_index(s, mesh)
                w_l = w if config.resync else ws[i]
                ids_s = ids[i]
                for l in range(config.n_local_iterations):
                    g, cnt = ssgd_kernels.fused_grad_sum_gathered(
                        X2, w_l, ids_s[l], **kargs)
                    w_l = _local_step(config, w_l, w, g * col_keep, cnt)
                return w_l

            return spmd.data_parallel(one, mesh)

    return _build_rounds(config, mesh, local_models, prep_xs,
                         sync=_sync_for(mesh, config, d_t))


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


def placed_state(state: tuple, mesh: Mesh) -> tuple:
    """``(w0, ws0, delta0)`` of :func:`init_state` placed by the
    ``local_sgd`` table: this process's rows of the replicas (all R
    with one process), the center and δ whole."""
    w0, ws0, delta0 = state
    return w0, partition.put(ws0, "ws", "local_sgd", mesh), delta0


def pack(X_train, y_train, mesh: Mesh, config: LocalSGDConfig):
    """(X2, meta): (X, y, validity) packed once in the kernels' layout on
    the mesh's device, block rows ``gather_block_rows × R`` so that each
    replica's rows are whole blocks (``local_sgd.py:813-819``)."""
    n = X_train.shape[0]
    return ssgd_kernels.pack_augmented(
        np.asarray(X_train), np.asarray(y_train), np.ones(n, np.float32),
        dtype=config.x_dtype, pack=config.fused_pack,
        block_rows=config.gather_block_rows * mesh.n_data,
        shuffle_seed=config.shuffle_seed, mesh=mesh, table="local_sgd")


def prepare_fused(X_train, y_train, mesh: Mesh, config: LocalSGDConfig):
    """One-time set-up of the fused samplers: pack the rows
    (:func:`pack`), draw the initial state (:func:`init_state`) and build
    the trainer. Returns ``(fn, X2, w0, ws0, delta0, meta)``; call as
    ``fn(X2, X_test_padded, y_test, w0, ws0, delta0)``."""
    X2, meta = pack(X_train, y_train, mesh, config)
    w0, ws0, delta0 = placed_state(init_state(
        config, X_train.shape[1], meta["d_total"], mesh.n_data, mesh.device),
        mesh)
    return (make_train_fn_fused(mesh, config, meta), X2, w0, ws0, delta0,
            meta)


def _segmented(config: LocalSGDConfig, make_fn, data, state0,
               checkpoint_dir, checkpoint_every, *, mesh: Mesh | None = None):
    """Run in checkpointed segments; the carry is ``(w, ws, delta)``,
    with a ``comm`` schedule ``(w, ws, delta, residual)`` (the residual
    placed by the ``local_sgd`` table). Returns ``(w, ws, accs,
    start)``."""
    from tpu_distalg_torch.utils import checkpoint as ckpt

    def run_seg(fn, state, t0):
        if len(state) == 4:
            state = (*state[:3], partition.place(
                {"res": state[3]}, "local_sgd", mesh)["res"])
            w, ws, delta, res, accs = fn(*data, *state, t0=t0)
            return (w, ws, delta, res), accs
        w, ws, delta, accs = fn(*data, *state, t0=t0)
        return (w, ws, delta), accs

    tag = f"local_sgd:{config.global_update}"
    if config.sampler != "bernoulli":
        tag += f":{config.sampler}"
    if config.comm != "dense":
        tag += f":comm={config.comm}"
    state, accs, start = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, config.n_iterations,
        make_seg_fn=lambda seg: make_fn(
            dataclasses.replace(config, n_iterations=seg)),
        run_seg=run_seg, state0=state0, tag=tag, mesh=mesh,
        sharded=(False, True, False, True))
    return state[0], state[1], torch.from_numpy(accs), start


def train(X_train, y_train, X_test, y_test, mesh: Mesh,
          config: LocalSGDConfig = LocalSGDConfig(), *,
          checkpoint_dir: str | None = None,
          checkpoint_every: int = 100) -> TrainResult:
    """End-to-end local-update training on the mesh's device; with
    ``checkpoint_dir``, in segments of ``checkpoint_every`` rounds saved
    after each (the carry: the center, the replicas and BMUF's δ) and
    resumed from the newest, bitwise equal to a straight run. The result
    holds the original-width (d,) center and (R, d) replicas. A ``comm``
    schedule adds the residual to the carry; ``sync='ssp…'`` trains in
    windows (:func:`_train_ssp`)."""
    from tpu_distalg_torch.parallel import comms, ssp

    tevents.mark(f"local_sgd:{config.global_update}", emit_event=False)
    _check_config(config)
    if ssp.SyncSpec.parse(config.sync).is_ssp:
        return _train_ssp(X_train, y_train, X_test, y_test, mesh, config,
                          checkpoint_dir=checkpoint_dir,
                          checkpoint_every=checkpoint_every)
    d = X_train.shape[1]
    X_te = np.asarray(X_test, np.float32)
    y_te = torch.as_tensor(np.asarray(y_test, np.float32)).to(mesh.device)
    if config.sampler == "bernoulli":
        Xs = parallelize(X_train, mesh,
                         dtype=ssgd_kernels.as_dtype(config.x_dtype),
                         table="local_sgd")
        ys = parallelize(np.asarray(y_train, np.float32), mesh,
                         table="local_sgd", leaf="y")
        state0 = placed_state(init_state(config, d, d, mesh.n_data,
                                         mesh.device), mesh)
        data = (Xs.data, ys.data, Xs.mask,
                torch.as_tensor(X_te).to(mesh.device), y_te)

        def make_fn(cfg):
            return make_train_fn(mesh, cfg, Xs.n_padded, d=d)
    else:
        X2, meta = pack(X_train, y_train, mesh, config)
        state0 = placed_state(init_state(config, d, meta["d_total"],
                                         mesh.n_data, mesh.device), mesh)
        data = (X2, torch.as_tensor(np.pad(
            X_te, ((0, 0), (0, meta["d_total"] - d)))).to(mesh.device), y_te)

        def make_fn(cfg):
            return make_train_fn_fused(mesh, cfg, meta)
    sync = None
    if config.comm != "dense":
        sync = _comm_sync(mesh, config, state0[0].shape[0])
        state0 = (*state0, partition.place(
            {"res": sync.init_state()}, "local_sgd", mesh)["res"])
    start = 0
    if checkpoint_dir is None:
        w, ws, *_, accs = make_fn(config)(*data, *state0)
        metrics.guard_finite((w, ws), "local-SGD models")
    else:
        w, ws, accs, start = _segmented(config, make_fn, data, state0,
                                        checkpoint_dir, checkpoint_every,
                                        mesh=mesh)
    if sync is not None:
        # only the rounds this process ran (a resume skips the rest)
        comms.emit_sync_counters(sync, config.n_iterations - start)
    return TrainResult(w=w[:d], ws=ws[:, :d], accs=accs)


# -------------------------------------------- stale-synchronous rounds


def make_ssp_train_fn(mesh: Mesh, config: LocalSGDConfig, n_padded: int,
                      d: int, *, active: tuple[bool, ...], n_win_seg: int,
                      total_rounds: int):
    """The local-update family's SSP window loop (``local_sgd.py:199``):
    ``s`` rounds of L local steps between combines. A replica straggled
    by the schedule skips the round (its interference work runs
    instead); the window-end merge is a staleness-weighted model average
    (weight ``decay**windows_stale``) through the sync's schedule,
    feeding the usual MA/BMUF/EASGD combine. With ``resync``, replicas
    adopt the center at the window start unless straggled there.

    Call as ``fn(X, y, valid, X_test, y_test, w0, ws0, delta0, clocks0,
    stale0, res0, extra_seg, win0)`` → ``(w, ws, delta, clocks, stale,
    res, win_accs, ages_max, ages_mean, gated)``. Across processes the
    clocks, staleness and weights are whole (R,) vectors every process
    computes alike; ``ws`` and the residual are this process's rows, and
    it runs its own replicas' rounds and straggle work only."""
    from tpu_distalg_torch.parallel import ssp as pssp

    spec = pssp.SyncSpec.parse(config.sync)
    s = spec.staleness
    L = config.n_local_iterations
    R = mesh.n_data
    mine = slice(mesh.local_data.start, mesh.local_data.stop)
    dev = mesh.device
    n_local = n_padded // R
    sync = _comm_sync(mesh, config, d)
    combine = _make_combine(config, _derive_beta(config, R))
    active_np = np.asarray(active, bool)
    act = torch.as_tensor(active_np, device=dev)
    big = 1 << 30

    def train(X, y, valid, X_test, y_test, w0, ws0, delta0, clocks0,
              stale0, res0, extra_seg, win0):
        extra_seg = np.asarray(extra_seg, np.int32)
        rounds = win0 * s + np.arange(n_win_seg * s).reshape(n_win_seg, s)
        roundv = rounds < total_rounds
        free = roundv[:, :, None] & active_np & (extra_seg == 0)
        counted = roundv[:, :, None] & active_np
        adopt = (active_np & (extra_seg[:, 0] == 0) if config.resync
                 else np.zeros((n_win_seg, R), bool))
        free_d, counted_d, adopt_d, busy_d, extra_d = (
            torch.as_tensor(a, device=dev)
            for a in (free, counted, adopt, extra_seg[:, -1] > 0,
                      extra_seg))
        w, ws, delta, clocks, stale, res = (w0, ws0, delta0, clocks0,
                                            stale0, res0)
        accs, amax, amean, gated_w = [], [], [], []
        for i in range(n_win_seg):
            winid = win0 + i
            wl = torch.where(adopt_d[i][mine, None], w[None, :], ws)
            max_c = torch.where(act, clocks, -big).max()
            clocks_adj = torch.where(adopt_d[i], max_c, clocks).to(
                clocks.dtype)
            min_known = torch.where(act, clocks_adj, big).min()
            my_clock = clocks_adj
            gated_ct = torch.zeros((R,), dtype=torch.int32, device=dev)
            for r in range(s):
                if extra_seg[i, r, mine].any():
                    pssp.entangle(wl, pssp.straggle_work(
                        extra_d[i, r, mine]))
                gated = (my_clock - min_known) >= s
                do = free_d[i, r] & ~gated
                masks = round_masks(config, int(rounds[i, r]), valid, mesh)
                new = []
                for j in range(wl.shape[0]):
                    rows = slice(j * n_local, (j + 1) * n_local)
                    w_j = wl[j]
                    for li in range(L):
                        g, cnt = logistic.grad_sum(X[rows], y[rows], w_j,
                                                   masks[li, rows])
                        w_j = _local_step(config, w_j, w, g, cnt)
                    new.append(w_j)
                wl = torch.where(do[mine, None], torch.stack(new), wl)
                my_clock = my_clock + do.to(my_clock.dtype)
                gated_ct = gated_ct + (counted_d[i, r] & gated).to(
                    torch.int32)
            stepped = my_clock > clocks_adj
            fresh = act & stepped & ~busy_d[i]
            stale = torch.where(fresh, torch.zeros_like(stale), stale + 1)
            wts = pssp.staleness_weights(stale, act, act, spec.decay)
            wsum = wts.sum()
            contrib = wts[mine, None] * wl
            (summed,), res = sync.reduce(
                [(contrib[j],) for j in range(contrib.shape[0])], res, winid)
            w_avg = summed / torch.clamp_min(wsum, 1e-12)
            ages_obs = torch.where(act, stale, torch.zeros_like(stale))
            n_act = act.to(torch.float32).sum()
            amax.append(ages_obs.max().to(torch.float32))
            amean.append(ages_obs.to(torch.float32).sum()
                         / torch.clamp_min(n_act, 1.0))
            gated_w.append(gated_ct.sum())
            clocks, ws = my_clock, wl
            w, delta = combine(w, w_avg, delta)
            accs.append(metrics.binary_accuracy(X_test @ w, y_test)
                        if config.eval_test else
                        torch.zeros((), dtype=torch.float32, device=dev))

        def stack(xs, dtype):
            return (torch.stack(xs) if xs
                    else torch.zeros((0,), dtype=dtype, device=dev))

        return (w, ws, delta, clocks, stale, res,
                stack(accs, torch.float32), stack(amax, torch.float32),
                stack(amean, torch.float32), stack(gated_w, torch.int64))

    return train


def _train_ssp(X_train, y_train, X_test, y_test, mesh: Mesh,
               config: LocalSGDConfig, *, checkpoint_dir: str | None = None,
               checkpoint_every: int = 100) -> TrainResult:
    """The SSP driver of the family (``local_sgd.py:356-495``) over the
    state (w, ws, delta, clocks, stale, residual), elastic through
    :func:`..parallel.membership.run_elastic`: a resume on another
    shard count re-derives the replicas from the replicated center."""
    from tpu_distalg_torch.models.ssgd import window_accs_to_ticks
    from tpu_distalg_torch.parallel import comms, membership
    from tpu_distalg_torch.parallel import ssp as pssp

    spec = pssp.SyncSpec.parse(config.sync)
    s = spec.staleness
    T = config.n_iterations
    D = X_train.shape[1]
    R = mesh.n_data
    dev = mesh.device
    Xs = parallelize(X_train, mesh,
                     dtype=ssgd_kernels.as_dtype(config.x_dtype))
    ys = parallelize(np.asarray(y_train, np.float32), mesh)
    X_te = torch.as_tensor(np.asarray(X_test, np.float32)).to(dev)
    y_te = torch.as_tensor(np.asarray(y_test, np.float32)).to(dev)
    w0, ws0, delta0 = init_state(config, D, D, R, dev)
    n_win, padded = pssp.window_grid(T, s)
    extra = pssp.compile_straggle_schedule(padded, R)
    extra[T:] = 0  # pad rounds do not exist: no interference, no busy
    extra = extra.reshape(n_win, s, R)
    sync = _comm_sync(mesh, config, D)

    def renegotiate(saved_leaves, saved_shards, start_win):
        del saved_shards, start_win
        w = np.asarray(saved_leaves[0], np.float32)
        return (w, np.tile(w, (R, 1)),
                np.asarray(saved_leaves[2], np.float32),
                np.asarray(membership.redistribute_clocks(
                    saved_leaves[3], R), np.int32),
                np.zeros((R,), np.int32),
                np.asarray(sync.init_state()))

    def make_seg_fn(active, n_win_seg):
        return make_ssp_train_fn(mesh, config, Xs.n_padded, D,
                                 active=active, n_win_seg=n_win_seg,
                                 total_rounds=T)

    def on_epoch(state, prev, cur):
        """A rejoining replica is current, not a straggler: its clock
        froze while it was away, and (EASGD never resyncs) nothing in
        the window would bump it, so it takes the continuing replicas'
        top clock here or the gate would serialize the mesh onto it."""
        w, ws, delta, clocks, stale, res = state
        clocks = np.array(torch.as_tensor(clocks).cpu(), np.int32)
        rejoined = [k for k in range(R) if cur.active[k]
                    and not prev.active[k]]
        if rejoined:
            cont = [k for k in range(R) if cur.active[k] and prev.active[k]]
            top = int(clocks[cont].max()) if cont else int(clocks.max())
            clocks[rejoined] = top
        return (w, ws, delta, clocks, stale, res)

    def run_seg(fn, state, win0, n_win_seg, epoch):
        del epoch
        st = partition.place(
            dict(zip(("w", "ws", "delta", "clocks", "stale", "res"), state)),
            "local_sgd", mesh)
        out = fn(Xs.data, ys.data, Xs.mask, X_te, y_te, st["w"], st["ws"],
                 st["delta"], st["clocks"], st["stale"], st["res"],
                 extra[win0:win0 + n_win_seg], win0)
        return out[:6], out[6:]

    # whole host arrays, which run_seg places (this process's replicas)
    state0 = (w0, ws0.cpu().numpy(), delta0, np.zeros((R,), np.int32),
              np.zeros((R,), np.int32), np.asarray(sync.init_state()))
    state, outs, start, epochs = membership.run_elastic(
        checkpoint_dir, max(1, checkpoint_every // s), n_win, R,
        make_seg_fn=make_seg_fn, run_seg=run_seg, state0=state0,
        renegotiate=renegotiate, on_epoch=on_epoch,
        tag=(f"local_sgd:{spec.spec()}:{config.global_update}"
             f":comm={config.comm}"),
        ticks_per_window=s, mesh=mesh,
        # the replicas and the residual are this process's rows
        sharded=(False, True, False, False, False, True))
    w = torch.as_tensor(state[0]).to(dev)
    ws = torch.as_tensor(state[1]).to(dev)
    metrics.guard_finite((w, ws), "local-SGD (ssp) models")
    accs = (window_accs_to_ticks(outs[0], s, T) if outs
            else np.zeros((T,), np.float32))
    stats = pssp.observed_staleness(outs[1] if outs else [],
                                    outs[2] if outs else [])
    pssp.emit_ssp_counters(
        spec, stats, straggle_ticks=int(np.count_nonzero(extra)),
        gated_ticks=int(np.asarray(outs[3]).sum()) if outs else 0,
        epochs=len(epochs))
    comms.emit_sync_counters(sync, n_win - start)
    return TrainResult(w=w, ws=ws, accs=torch.from_numpy(accs))
