"""SSGD — synchronous minibatch SGD logistic regression.

Port of ``tpu_distalg/models/ssgd.py`` for the BSP trainer with a dense
gradient sync, on the emulated data axis (:mod:`..parallel`). Each
step samples a minibatch, sums ``(Σ gradient, count)`` per shard, adds
the shards in shard order (the reference's treeAggregate) and updates
``w ← w − η·(g/max(count, 1) + λ·reg(w))``. JAX's ``lax.scan`` over the
steps is a Python loop here; sampling keys on the absolute step id, so
a segmented run replays a straight one bit for bit. Samplers:

  * ``bernoulli``: a threefry Bernoulli mask over all rows (the
    reference's ``sample(False, frac, 42+t)``), the gradient in plain
    torch or, with ``use_pallas``, through kernel B6
    (``ssgd_kernels.fused_grad_sum``);
  * ``fused_gather``: rows packed once with y and validity
    (``ssgd_kernels.pack_augmented``); every step's block ids are drawn
    in one batched call before the loop, and kernel B1
    (``fused_grad_sum_gathered``) reads only the sampled blocks. For
    ``n_shards > 1`` shard s draws ids local to its slice: global block
    = s·n_blocks + id;
  * ``fused``: the packed rows again, but kernel B5
    (``fused_grad_sum_packed``) passes over ALL of a shard's rows and
    draws the Bernoulli mask itself from (step + seed, shard, row);
  * ``fused_train``: ``fused_gather``'s sampling and update, with every
    ``mega_steps`` steps in one launch of kernel B2
    (``fused_train_gathered``); one shard, ``lam = 0``, evaluation at
    launch boundaries only.

Not ported yet, raising NotImplementedError with their ROADMAP item:
the ``fixed`` and ``virtual`` samplers, ``comm`` other
than ``dense`` and ``sync`` other than ``bsp`` (A9), and
``feature_sharded`` (B3/B4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.ops import logistic, sampling, ssgd_kernels
from tpu_distalg_torch.parallel import Mesh, parallelize, tree_allreduce_sum
from tpu_distalg_torch.utils import metrics, prng


@dataclasses.dataclass(frozen=True)
class SSGDConfig:
    """The JAX package's fields and defaults (knob names follow the
    reference's ``ssgd.py:17-21``)."""

    n_iterations: int = 1500
    eta: float = 0.1
    mini_batch_fraction: float = 0.1
    lam: float = 0.0
    reg_type: str = "l2"
    elastic_alpha: float = 0.0
    seed: int = 42
    init_seed: int = 7
    eval_test: bool = True
    eval_every: int = 1
    x_dtype: str = "float32"
    use_pallas: bool = False
    pallas_block_rows: int = 2048
    sampler: str = "bernoulli"
    fused_pack: int = 16
    fused_block_rows: int = 8192
    gather_block_rows: int = 1024
    mega_steps: int = 125
    shuffle_seed: int | None = None
    feature_sharded: bool = False
    comm: str = "dense"
    sync: str = "bsp"


@dataclasses.dataclass
class TrainResult:
    w: torch.Tensor
    accs: torch.Tensor

    @property
    def final_acc(self) -> float:
        return float(self.accs[-1])


_SAMPLERS = ("bernoulli", "fixed", "fused", "fused_gather", "fused_train",
             "virtual")
_NOT_PORTED = {
    "fixed": "the 'fixed' row-gather sampler is not ported yet "
             "(ROADMAP A3)",
    "virtual": "sampler='virtual' (rows regenerated on the device) is "
               "not ported yet (ROADMAP A10)",
}


def _check_ported(config: SSGDConfig) -> None:
    """Raise NotImplementedError for what this slice does not cover."""
    if config.sampler not in _SAMPLERS:
        raise ValueError(f"unknown sampler {config.sampler!r}")
    if config.sampler in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[config.sampler])
    if config.comm != "dense":
        raise NotImplementedError(
            f"comm={config.comm!r}: the gradient-sync schedules are not "
            f"ported yet (ROADMAP A9); use comm='dense'")
    if config.sync != "bsp":
        raise NotImplementedError(
            f"sync={config.sync!r}: stale-synchronous training is not "
            f"ported yet (ROADMAP A9); use sync='bsp'")
    if config.feature_sharded:
        raise NotImplementedError(
            "feature_sharded: the model axis and kernels B3/B4 are not "
            "ported yet (ROADMAP A9, B3/B4)")


def _build_scan(config: SSGDConfig, sample_and_grad, prep_xs=None):
    """The step loop shared by every per-step sampler:
    ``sample_and_grad(X, y, valid, w, payload)`` → global (Σ grad,
    count), then the reference's update and evaluation. ``prep_xs(ts)``
    maps the absolute step ids to the per-step payloads (all drawn
    before the loop); without it the payload is the step id."""
    if config.eval_every < 1:
        raise ValueError(
            f"eval_every must be >= 1, got {config.eval_every}")

    def train(X, y, valid, X_test, y_test, w0, t0=0, acc0=0.0):
        T = config.n_iterations
        ts = torch.arange(t0, t0 + T, dtype=torch.int64, device=w0.device)
        payloads = prep_xs(ts) if prep_xs is not None else range(t0, t0 + T)
        w = w0
        last = torch.as_tensor(acc0, dtype=torch.float32).to(w0.device)
        zero = torch.zeros((), dtype=torch.float32, device=w0.device)
        accs = []
        for i in range(T):
            t = t0 + i
            g, cnt = sample_and_grad(X, y, valid, w, payloads[i])
            n_batch = torch.clamp_min(cnt, 1.0)
            reg = logistic.reg_gradient(w, config.reg_type,
                                        config.elastic_alpha)
            w = w - config.eta * (g / n_batch + config.lam * reg)
            if not config.eval_test:
                last = zero
            elif config.eval_every == 1 or t % config.eval_every == 0:
                last = metrics.binary_accuracy(X_test @ w, y_test)
            accs.append(last)
        accs = (torch.stack(accs) if accs
                else torch.zeros((0,), dtype=torch.float32,
                                 device=w0.device))
        return w, accs

    return train


def make_train_fn(mesh: Mesh, config: SSGDConfig, n_padded: int):
    """The ``bernoulli`` trainer: call as ``fn(X, y, valid, X_test,
    y_test, w0, t0=0, acc0=0.0)`` → ``(w, accs)`` with X, y, valid the
    padded arrays of :func:`parallelize`."""
    if config.sampler in ("fused", "fused_gather"):
        raise ValueError(
            f"sampler={config.sampler!r} packs labels into X — build via "
            "make_train_fn_fused(mesh, config, meta) with meta from "
            "ssgd_kernels.pack_augmented, or use ssgd.train()")
    _check_ported(config)
    if config.sampler != "bernoulli":
        raise ValueError(f"unknown sampler {config.sampler!r}")
    n_shards = mesh.n_data
    n_local = n_padded // n_shards
    key = prng.root_key(config.seed, mesh.device)

    def local_grad(X, y, mask, w):
        if config.use_pallas:
            return ssgd_kernels.fused_grad_sum(
                X, y, mask, w, block_rows=config.pallas_block_rows)
        return logistic.grad_sum(X, y, w, mask)

    def sample_and_grad(X, y, valid, w, t):
        mask = sampling.bernoulli_mask(key, t, n_padded,
                                       config.mini_batch_fraction, valid)
        return tree_allreduce_sum(
            local_grad(X[s * n_local:(s + 1) * n_local],
                       y[s * n_local:(s + 1) * n_local],
                       mask[s * n_local:(s + 1) * n_local], w)
            for s in range(n_shards))

    return _build_scan(config, sample_and_grad)


def fused_gather_geometry(config: SSGDConfig, meta: dict, n_shards: int):
    """Per-shard block geometry of the block samplers: (blocks per
    shard, blocks sampled per shard per step)."""
    if config.gather_block_rows % meta["pack"]:
        raise ValueError(
            f"gather_block_rows={config.gather_block_rows} must be a "
            f"multiple of pack={meta['pack']}")
    bp = config.gather_block_rows // meta["pack"]
    n2_local = (meta["n_padded"] // meta["pack"]) // n_shards
    n_blocks = n2_local // bp
    if n_blocks * bp != n2_local:
        raise ValueError(
            f"gather_block_rows={config.gather_block_rows} must divide "
            f"the per-shard row count {n2_local * meta['pack']}; re-pack "
            f"with block_rows a multiple of gather_block_rows × n_shards")
    n_sampled = max(1, round(config.mini_batch_fraction * n_blocks))
    warn_quantized_fraction(
        "fused_gather", n_blocks, n_sampled, config.mini_batch_fraction,
        "lower gather_block_rows or fused_pack for a finer grid")
    return n_blocks, n_sampled


def warn_quantized_fraction(prefix: str, n_blocks: int, n_sampled: int,
                            frac: float, remedy: str) -> None:
    """Warn when the block grid moves the minibatch fraction by more
    than 25%."""
    eff = n_sampled / n_blocks
    if abs(eff - frac) > 0.25 * frac:
        import warnings

        warnings.warn(
            f"{prefix}: {n_blocks} blocks/shard quantizes the minibatch "
            f"fraction to {eff:.3f} (configured {frac}); {remedy}",
            stacklevel=3)


def _kernel_args(config: SSGDConfig, meta: dict) -> dict:
    return dict(pack=meta["pack"], d_total=meta["d_total"],
                y_col=meta["y_col"], v_col=meta["v_col"],
                gather_block_rows=config.gather_block_rows)


def make_train_fn_fused(mesh: Mesh, config: SSGDConfig, meta: dict):
    """The packed-layout trainers (``fused``, ``fused_gather``,
    ``fused_train``): call as ``fn(X2, None, None, X_test, y_test, w0, t0=0, acc0=0.0)``
    → ``(w, accs)`` with the augmented (d_total,) weights; the y/v/pad
    columns of the gradient are zeroed every step."""
    _check_ported(config)
    n_shards = mesh.n_data
    if config.sampler == "fused_train":
        return _make_train_fn_mega(mesh, config, meta, n_shards)
    col_keep = (torch.arange(meta["d_total"], device=mesh.device)
                < meta["y_col"]).to(torch.float32)
    if config.sampler == "fused":
        return _build_scan(config, _fused_sample_and_grad(
            config, meta, n_shards, col_keep))
    if config.sampler != "fused_gather":
        raise ValueError(f"sampler={config.sampler!r} is not a packed-"
                         f"layout sampler")
    n_blocks, n_sampled = fused_gather_geometry(config, meta, n_shards)
    key = prng.root_key(config.seed, mesh.device)
    kargs = _kernel_args(config, meta)
    offsets = (torch.arange(n_shards, dtype=torch.int32, device=mesh.device)
               * n_blocks)[:, None]

    def prep_xs(ts):
        # every (step, shard) draw in one batched call, keyed on the
        # absolute step; ids made global: shard s owns blocks
        # [s·n_blocks, (s+1)·n_blocks)
        ids = sampling.sample_block_ids(prng.fold_in(key, ts), n_shards,
                                        n_blocks, n_sampled)
        return (ids + offsets).contiguous()           # (T, S, ns)

    def sample_and_grad(X2, y, valid, w, ids):
        del y, valid  # labels and validity ride inside X2
        per = []
        for s in range(n_shards):
            g, cnt = ssgd_kernels.fused_grad_sum_gathered(X2, w, ids[s],
                                                          **kargs)
            per.append((g * col_keep, cnt))
        return tree_allreduce_sum(per)

    return _build_scan(config, sample_and_grad, prep_xs=prep_xs)


def _fused_sample_and_grad(config: SSGDConfig, meta: dict, n_shards: int,
                           col_keep):
    """``fused``: each shard's rows go whole through kernel B5, keyed on
    the absolute step plus the seed and on the shard, so a segmented
    run draws what a straight one draws."""
    n2_local = (meta["n_padded"] // meta["pack"]) // n_shards
    kargs = dict(pack=meta["pack"], d_total=meta["d_total"],
                 y_col=meta["y_col"], v_col=meta["v_col"],
                 fraction=config.mini_batch_fraction,
                 block_rows=config.fused_block_rows)

    def sample_and_grad(X2, y, valid, w, t):
        del y, valid  # labels and validity ride inside X2
        per = []
        for s in range(n_shards):
            g, cnt = ssgd_kernels.fused_grad_sum_packed(
                X2[s * n2_local:(s + 1) * n2_local], w, t + config.seed, s,
                **kargs)
            per.append((g * col_keep, cnt))
        return tree_allreduce_sum(per)

    return sample_and_grad


def _make_train_fn_mega(mesh: Mesh, config: SSGDConfig, meta: dict,
                        n_shards: int):
    """``fused_train``: ``fused_gather``'s draws and update, with every
    ``mega_steps`` steps in one launch of kernel B2; accuracy at launch
    boundaries, carried between them as in the JAX package."""
    n_blocks, n_sampled = fused_gather_geometry(config, meta, n_shards)
    if n_shards != 1:
        raise ValueError(
            "sampler='fused_train' fuses the whole schedule into one "
            "kernel launch, so there is no per-step cross-shard psum: "
            "it is the single-data-shard (dp=1) specialization. Use "
            "'fused_gather' on multi-shard data meshes.")
    if config.lam != 0.0:
        raise ValueError(
            "sampler='fused_train' supports lam=0 only (the reference "
            "default, ssgd.py:21); use 'fused_gather' for regularized "
            "runs")
    if config.mega_steps < 1:
        raise ValueError(
            f"mega_steps must be >= 1, got {config.mega_steps}")
    T = config.n_iterations
    mega = min(config.mega_steps, T)
    if T % mega:
        raise ValueError(
            f"sampler='fused_train' needs n_iterations ({T}) divisible "
            f"by mega_steps ({mega})")
    if config.eval_test and config.eval_every != mega:
        raise ValueError(
            "sampler='fused_train' evaluates at kernel-segment "
            f"boundaries only: set eval_every == mega_steps ({mega}) "
            "or eval_test=False")
    key = prng.root_key(config.seed, mesh.device)
    kargs = _kernel_args(config, meta)

    def train(X2, y, valid, X_test, y_test, w0, t0=0, acc0=0.0):
        del y, valid
        ts = torch.arange(t0, t0 + T, dtype=torch.int64, device=w0.device)
        idx = sampling.sample_block_ids(
            prng.fold_in(key, ts), 1, n_blocks, n_sampled,
        ).reshape(T // mega, mega, n_sampled).contiguous()
        w = w0
        seg_accs = []
        for seg in range(T // mega):
            w = ssgd_kernels.fused_train_gathered(X2, w, idx[seg],
                                                  eta=config.eta, **kargs)
            seg_accs.append(
                metrics.binary_accuracy(X_test @ w, y_test)
                if config.eval_test else
                torch.zeros((), dtype=torch.float32, device=w0.device))
        seg_accs = torch.stack(seg_accs)
        if config.eval_test:
            # position t carries the last accuracy computed at or
            # before t (launch ends), starting from acc0
            prev = torch.cat([torch.as_tensor(
                acc0, dtype=torch.float32).to(w0.device).reshape(1),
                seg_accs[:-1]])
            accs = prev.repeat_interleave(mega)
            accs[mega - 1::mega] = seg_accs
        else:
            accs = torch.zeros((T,), dtype=torch.float32, device=w0.device)
        return w, accs

    return train


def fused_train_segment_lengths(checkpoint_dir, checkpoint_every: int,
                                n_iterations: int) -> set[int]:
    """The distinct segment lengths a checkpointed run will execute,
    a resume from the step on disk included."""
    from tpu_distalg_torch.utils import checkpoint as ckpt

    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    start = (ckpt.latest_step(checkpoint_dir) or 0) if checkpoint_dir \
        else 0
    lens: set[int] = set()
    t = min(start, n_iterations)
    while t < n_iterations:
        seg = min(checkpoint_every, n_iterations - t)
        lens.add(seg)
        t += seg
    return lens


def _acc_carrying_run_seg(*data_args):
    """Segment runner: state = (w, last_acc); resuming with ``acc0``
    keeps eval_every > 1 histories equal across segment boundaries."""

    def run_seg(fn, state, t0):
        w, acc0 = state
        w, accs = fn(*data_args, w, t0=t0, acc0=acc0)
        return (w, accs[-1]), accs

    return run_seg


def train(X_train, y_train, X_test, y_test, mesh: Mesh,
          config: SSGDConfig = SSGDConfig(), *,
          checkpoint_dir: str | None = None,
          checkpoint_every: int = 500) -> TrainResult:
    """End-to-end training on the mesh's device; with ``checkpoint_dir``,
    in segments of ``checkpoint_every`` steps that are saved after each
    and resumed from the newest (bitwise equal to a straight run)."""
    _check_ported(config)
    if config.sampler in ("fused", "fused_gather", "fused_train"):
        return _train_fused(X_train, y_train, X_test, y_test, mesh, config,
                            checkpoint_dir=checkpoint_dir,
                            checkpoint_every=checkpoint_every)
    d_orig = X_train.shape[1]
    Xs = parallelize(X_train, mesh,
                     dtype=ssgd_kernels.as_dtype(config.x_dtype))
    ys = parallelize(np.asarray(y_train, np.float32), mesh)
    w0 = logistic.init_weights(prng.root_key(config.init_seed, mesh.device),
                               d_orig)
    X_te = torch.as_tensor(np.asarray(X_test, np.float32)).to(mesh.device)
    y_te = torch.as_tensor(np.asarray(y_test, np.float32)).to(mesh.device)
    data = (Xs.data, ys.data, Xs.mask, X_te, y_te)
    if checkpoint_dir is None:
        fn = make_train_fn(mesh, config, Xs.n_padded)
        w, accs = fn(*data, w0)
        metrics.guard_finite(w, "SSGD weights")
        return TrainResult(w=w[:d_orig], accs=accs)

    from tpu_distalg_torch.utils import checkpoint as ckpt

    (w, _), accs, _ = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, config.n_iterations,
        make_seg_fn=lambda seg: make_train_fn(
            mesh, dataclasses.replace(config, n_iterations=seg),
            Xs.n_padded),
        run_seg=_acc_carrying_run_seg(*data),
        state0=(w0, torch.zeros((), dtype=torch.float32,
                                device=mesh.device)),
        tag=f"ssgd:{config.sampler}")
    return TrainResult(w=w[:d_orig], accs=torch.from_numpy(accs))


def prepare_fused(X_train, y_train, mesh: Mesh, config: SSGDConfig):
    """Pack (X, y, validity) once into the kernels' layout on the mesh's
    device, build the augmented initial weights and the trainer.
    Returns ``(fn, X2, w0, meta)``; call as ``fn(X2, None, None,
    X_test_padded, y_test, w0)``."""
    n_shards = mesh.n_data
    d_orig = X_train.shape[1]
    n = X_train.shape[0]
    block = (config.gather_block_rows
             if config.sampler in ("fused_gather", "fused_train")
             else config.fused_block_rows)
    X2, meta = ssgd_kernels.pack_augmented(
        np.asarray(X_train), np.asarray(y_train), np.ones(n, np.float32),
        dtype=config.x_dtype, pack=config.fused_pack,
        block_rows=block * n_shards, shuffle_seed=config.shuffle_seed,
        device=mesh.device)
    w0 = torch.zeros((meta["d_total"],), dtype=torch.float32,
                     device=mesh.device)
    w0[:d_orig] = logistic.init_weights(
        prng.root_key(config.init_seed, mesh.device), d_orig)
    fn = make_train_fn_fused(mesh, config, meta)
    return fn, X2, w0, meta


def _train_fused(X_train, y_train, X_test, y_test, mesh: Mesh,
                 config: SSGDConfig, *, checkpoint_dir: str | None = None,
                 checkpoint_every: int = 500) -> TrainResult:
    """Packed-layout training: the augmented weights are carried and
    X_test is padded with zero columns to match (the y/v/pad entries of
    w stay zero, so the padded product equals the unpadded one)."""
    d_orig = X_train.shape[1]
    fn, X2, w0, meta = prepare_fused(X_train, y_train, mesh, config)
    X_te = torch.as_tensor(np.pad(
        np.asarray(X_test, np.float32),
        ((0, 0), (0, meta["d_total"] - d_orig)))).to(mesh.device)
    y_te = torch.as_tensor(np.asarray(y_test, np.float32)).to(mesh.device)
    if checkpoint_dir is None:
        w, accs = fn(X2, None, None, X_te, y_te, w0)
        metrics.guard_finite(w, "SSGD (fused) weights")
        return TrainResult(w=w[:d_orig], accs=accs)

    from tpu_distalg_torch.utils import checkpoint as ckpt

    if config.sampler == "fused_train":
        # validate every segment length up front, a resume's included,
        # so that a run cannot fail on them half-way
        for seg in sorted(fused_train_segment_lengths(
                checkpoint_dir, checkpoint_every, config.n_iterations)):
            mega = min(config.mega_steps, seg)
            if seg % mega:
                raise ValueError(
                    f"sampler='fused_train': checkpoint segment of {seg} "
                    f"steps is not divisible by mega_steps "
                    f"({config.mega_steps}); choose checkpoint_every and "
                    f"n_iterations as multiples of mega_steps")
            if config.eval_test and config.eval_every != mega:
                raise ValueError(
                    f"sampler='fused_train' with eval_test: a checkpoint "
                    f"segment of {seg} steps evaluates at its launch "
                    f"boundary mega=min(mega_steps, seg)={mega}, but "
                    f"eval_every={config.eval_every} — make n_iterations "
                    f"and checkpoint_every multiples of mega_steps and "
                    f"set eval_every == mega_steps, or eval_test=False")

    (w, _), accs, _ = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, config.n_iterations,
        make_seg_fn=lambda seg: make_train_fn_fused(
            mesh, dataclasses.replace(config, n_iterations=seg), meta),
        run_seg=_acc_carrying_run_seg(X2, None, None, X_te, y_te),
        state0=(w0, torch.zeros((), dtype=torch.float32,
                                device=mesh.device)),
        tag=f"ssgd:{config.sampler}")
    return TrainResult(w=w[:d_orig], accs=torch.from_numpy(accs))
