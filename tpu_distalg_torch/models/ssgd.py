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
    launch boundaries only;
  * ``fixed``: each shard gathers exactly ``round(frac·n_local)`` of its
    rows a step, the head of a threefry permutation keyed on (step,
    shard) (:func:`..ops.sampling.fixed_row_ids`), and sums their
    gradient in plain torch, as the JAX package does (no kernel).

:func:`prepare_fused_synthetic` builds the packed rows of the
two-class task on the device, chunk by chunk
(:func:`..utils.datasets.synthetic_two_class_rows`), for the scale path.

With ``feature_sharded`` (the JAX package's tensor-parallel split, on
a mesh with ``n_model > 1``) the features are split into ``n_model``
contiguous slices (:func:`tpu_distalg_torch.parallel.shard_features`)
and each slice owns its part of w and of the gradient; z is the sum of
the slices' partial products in model order
(:func:`tpu_distalg_torch.parallel.model_sum`):

  * ``bernoulli``: z = Σ_m X_m·w_m in plain torch, then each slice's
    gradient Xᵀ_m·resid, summed over the data shards in shard order;
  * ``fused_gather``: each model slice is packed on its own with the y/v
    columns replicated and the same row shuffle
    (:func:`prepare_fused_tp`), into one (n_model, n2, P·D) tensor; each
    step, per data shard and slice, kernel B3 (``fused_forward_gathered``)
    gives the partial z and y/v, the partials are summed in model order,
    ``resid = (σ(z) − y)·v``, and kernel B4 (``fused_backward_gathered``)
    gives the slice's gradient. The sampled blocks are read twice. w is
    the JAX package's flat (n_model·D,) concatenation of the slices.

Not ported yet, raising NotImplementedError with their ROADMAP item:
the ``virtual`` sampler (A10), ``comm`` other than ``dense`` and
``sync`` other than ``bsp`` (A9). The JAX package's refusals of
``feature_sharded`` with other samplers, ``use_pallas``, a ``comm``
schedule or SSP, and of ``fixed`` with a ``comm`` schedule, SSP or
``use_pallas``, raise its ValueErrors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.ops import logistic, sampling, ssgd_kernels
from tpu_distalg_torch.parallel import (
    Mesh,
    model_sum,
    pad_features,
    parallelize,
    shard_features,
    tree_allreduce_sum,
)
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
    "virtual": "sampler='virtual' (rows regenerated on the device) is "
               "not ported yet (ROADMAP A10)",
}


def _check_feature_sharded(config: SSGDConfig) -> None:
    """The JAX package's refusals of ``feature_sharded``, in its words
    (``ssgd.py:277-285``, ``:331-337``, ``:357-365``, ``:1474-1480``),
    before anything the port does not cover is refused."""
    if not config.feature_sharded:
        return
    if config.comm != "dense":
        raise ValueError(
            "comm != 'dense' does not compose with feature_sharded "
            "(the tp split's model-axis matvec psum is activation "
            "traffic, not a gradient sync); run the comm schedules on "
            "a pure-dp mesh")
    if config.sync.split(":")[0] == "ssp":
        raise ValueError(
            f"sync={config.sync!r} (stale-synchronous) composes with "
            f"the 'bernoulli', 'fused' and 'fused_gather' samplers on "
            f"a pure-dp mesh — got sampler={config.sampler!r} "
            f"use_pallas={config.use_pallas} "
            f"feature_sharded={config.feature_sharded}; 'fused_train' "
            f"(no per-window collective exists inside the megakernel), "
            f"'fixed' and the tp split stay BSP")
    if config.sampler in ("fused", "fused_train"):
        raise ValueError(
            "feature_sharded composes with sampler='fused_gather' or "
            f"'bernoulli', not '{config.sampler}'")
    if config.sampler != "fused_gather" and (
            config.sampler != "bernoulli" or config.use_pallas):
        raise ValueError(
            "feature_sharded composes with the 'bernoulli' sampler "
            "(plain torch) or sampler='fused_gather' (the "
            "two-pass kernel path, via ssgd.train / "
            "make_train_fn_fused_tp) — not with "
            f"sampler={config.sampler!r} use_pallas={config.use_pallas}")


def _check_fixed(config: SSGDConfig) -> None:
    """The JAX package's refusals of a ``comm`` schedule and of SSP with
    ``fixed``, in its words (``ssgd.py:338-346``, ``:357-365``), before
    anything the port does not cover is refused."""
    if config.sampler != "fixed":
        return
    if config.comm != "dense":
        raise ValueError(
            f"comm={config.comm!r} applies to the per-step gradient "
            f"sync, which sampler={config.sampler!r} does not expose "
            "('fused_train' fuses whole segments into one launch with "
            "no per-step collective; 'fixed' is the measured-slower "
            "legacy gather path) — use 'bernoulli', 'fused' or "
            "'fused_gather'")
    if config.sync.split(":")[0] == "ssp":
        raise ValueError(
            f"sync={config.sync!r} (stale-synchronous) composes with "
            f"the 'bernoulli', 'fused' and 'fused_gather' samplers on "
            f"a pure-dp mesh — got sampler={config.sampler!r} "
            f"use_pallas={config.use_pallas} "
            f"feature_sharded={config.feature_sharded}; 'fused_train' "
            f"(no per-window collective exists inside the megakernel), "
            f"'fixed' and the tp split stay BSP")


def _check_ported(config: SSGDConfig) -> None:
    """Raise NotImplementedError for what this slice does not cover."""
    _check_fixed(config)
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
    padded arrays of :func:`parallelize`. With ``feature_sharded``, X is
    the (n_model, n_padded, d_local) tensor of
    :func:`~tpu_distalg_torch.parallel.shard_features` and w the
    (n_model·d_local,) weights."""
    if config.sampler in ("fused", "fused_gather"):
        raise ValueError(
            f"sampler={config.sampler!r} packs labels into X — build via "
            "make_train_fn_fused(mesh, config, meta) with meta from "
            "ssgd_kernels.pack_augmented, or use ssgd.train()")
    _check_feature_sharded(config)
    _check_ported(config)
    if config.feature_sharded:
        return _make_train_fn_tp(mesh, config, n_padded)
    if config.sampler == "fixed":
        return _make_train_fn_fixed(mesh, config, n_padded)
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


#: int64 words of one group of ``fixed`` draws (steps × shards × rows):
#: the steps of a group are drawn in one batched call, and each int64
#: temporary of the hash then stays near 128 MB
FIXED_WORDS_PER_GROUP = 1 << 24


class _GroupedDraws:
    """Step i's payload of ``draw(ts[lo:hi])``, the steps drawn a group
    of ``group`` at a time as the loop reaches them."""

    def __init__(self, draw, ts, group: int):
        self.draw, self.ts, self.group = draw, ts, group
        self.lo, self.block = None, None

    def __getitem__(self, i: int):
        lo = i - i % self.group
        if lo != self.lo:
            self.lo, self.block = lo, None   # free the last group first
            self.block = self.draw(self.ts[lo:lo + self.group])
        return self.block[i - lo]


def _make_train_fn_fixed(mesh: Mesh, config: SSGDConfig, n_padded: int):
    """``fixed``: each step, shard s gathers the ``b_local =
    max(1, round(frac·n_local))`` rows of
    :func:`..ops.sampling.fixed_row_ids` (without replacement; padding
    rows carry zero validity) and sums their gradient and count in plain
    torch; the shards are added in shard order (``ssgd.py:1354-1390``).
    The draws of :data:`FIXED_WORDS_PER_GROUP` words' worth of steps
    are made in one call, keyed on the absolute steps."""
    if config.use_pallas:
        raise ValueError(
            "use_pallas applies to the 'bernoulli' sampler only; the "
            "'fixed' sampler's gather path does not use the fused kernel")
    n_shards = mesh.n_data
    n_local = n_padded // n_shards
    b_local = max(1, round(config.mini_batch_fraction * n_local))
    key = prng.root_key(config.seed, mesh.device)
    group = max(1, FIXED_WORDS_PER_GROUP // (n_shards * n_local))

    def prep_xs(ts):
        return _GroupedDraws(lambda t: sampling.fixed_row_ids(
            key, t, n_shards, n_local, b_local), ts, group)

    def sample_and_grad(X, y, valid, w, idx):
        per = []
        for s in range(n_shards):
            rows = idx[s] + s * n_local
            per.append(logistic.grad_sum(X[rows], y[rows], w, valid[rows]))
        return tree_allreduce_sum(per)

    return _build_scan(config, sample_and_grad, prep_xs=prep_xs)


def _make_train_fn_tp(mesh: Mesh, config: SSGDConfig, n_padded: int):
    """dp×tp ``bernoulli``: rows over the data shards, features over the
    model slices. Per data shard, z = Σ_m X_m·w_m in model order, then
    each slice's gradient X_mᵀ·resid; the shards' gradients and counts
    are added in shard order (``ssgd.py:902-936``)."""
    n_data, n_model = mesh.n_data, mesh.n_model
    n_local = n_padded // n_data
    key = prng.root_key(config.seed, mesh.device)

    def sample_and_grad(X, y, valid, w, t):
        mask = sampling.bernoulli_mask(key, t, n_padded,
                                       config.mini_batch_fraction, valid)
        w_m = w.view(n_model, -1)
        per = []
        for s in range(n_data):
            rows = slice(s * n_local, (s + 1) * n_local)
            Xs = [X[m, rows].to(torch.promote_types(X.dtype, w.dtype))
                  for m in range(n_model)]
            z = model_sum(Xs[m] @ w_m[m] for m in range(n_model))
            resid = (torch.sigmoid(z) - y[rows]) * mask[rows]
            per.append(tuple(x.T @ resid for x in Xs) + (mask[rows].sum(),))
        *g, cnt = tree_allreduce_sum(per)
        return torch.cat(g), cnt

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
    if config.feature_sharded:
        raise ValueError("feature_sharded: build the two-pass trainer with "
                         "make_train_fn_fused_tp(mesh, config, meta), meta "
                         "from prepare_fused_tp, or use ssgd.train()")
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
    prep_xs = _block_draws(mesh, config, meta)
    kargs = _kernel_args(config, meta)

    def sample_and_grad(X2, y, valid, w, ids):
        del y, valid  # labels and validity ride inside X2
        per = []
        for s in range(n_shards):
            g, cnt = ssgd_kernels.fused_grad_sum_gathered(X2, w, ids[s],
                                                          **kargs)
            per.append((g * col_keep, cnt))
        return tree_allreduce_sum(per)

    return _build_scan(config, sample_and_grad, prep_xs=prep_xs)


def _block_draws(mesh: Mesh, config: SSGDConfig, meta: dict):
    """``fused_gather``'s ``prep_xs``: every (step, data shard) block draw
    in one batched call, keyed on the absolute step, the ids made global
    (shard s owns blocks ``[s·n_blocks, (s+1)·n_blocks)``) → (T, S, ns)."""
    n_shards = mesh.n_data
    n_blocks, n_sampled = fused_gather_geometry(config, meta, n_shards)
    key = prng.root_key(config.seed, mesh.device)
    offsets = (torch.arange(n_shards, dtype=torch.int32, device=mesh.device)
               * n_blocks)[:, None]

    def prep_xs(ts):
        ids = sampling.sample_block_ids(prng.fold_in(key, ts), n_shards,
                                        n_blocks, n_sampled)
        return (ids + offsets).contiguous()

    return prep_xs


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


def make_train_fn_fused_tp(mesh: Mesh, config: SSGDConfig, meta: dict):
    """The dp×tp ``fused_gather`` trainer, the two-pass split: call as
    ``fn(X2, None, None, X_test, y_test, w0, t0=0, acc0=0.0)`` →
    ``(w, accs)`` with X2 the (n_model, n2, P·D) slices and w the
    (n_model·D,) weights of :func:`prepare_fused_tp`.

    The one-pass kernel B1 cannot split the features: the residual needs
    the whole ``z = Σ_m X_m·w_m``. So every step, per data shard s and
    model slice m, kernel B3 gives the slice's partial z and y/v over the
    sampled blocks; the partials are added in model order; ``resid =
    (σ(z) − y)·v``; kernel B4 gives the slice's gradient, its y/v/pad
    entries zeroed. The shards' gradients and counts are added in shard
    order. The block ids of every step are drawn before the loop, as
    ``fused_gather`` draws them, so both read the same blocks; the
    sampled blocks are read twice a step (``ssgd.py:1278-1351``)."""
    _check_ported(config)
    n_data, n_model = mesh.n_data, meta["n_model"]
    if mesh.n_model != n_model:
        raise ValueError(f"meta packs {n_model} model slices, the mesh has "
                         f"{mesh.n_model}")
    d_t, P = meta["d_total"], meta["pack"]
    col_keep = (torch.arange(d_t, device=mesh.device)
                < meta["y_col"]).to(torch.float32)
    prep_xs = _block_draws(mesh, config, meta)
    kargs = _kernel_args(config, meta)
    bargs = dict(pack=P, d_total=d_t,
                 gather_block_rows=config.gather_block_rows)

    def sample_and_grad(X2, y, valid, w, ids):
        del y, valid  # labels and validity ride inside every slice
        w_m = w.view(n_model, d_t)
        per = []
        for s in range(n_data):
            zyv = [ssgd_kernels.fused_forward_gathered(X2[m], w_m[m], ids[s],
                                                       **kargs)
                   for m in range(n_model)]
            z = model_sum(zv[:, :P] for zv in zyv)
            y_s, v_s = zyv[0][:, P:2 * P], zyv[0][:, 2 * P:]
            resid = ((torch.sigmoid(z) - y_s) * v_s).contiguous()
            per.append(tuple(
                ssgd_kernels.fused_backward_gathered(X2[m], resid, ids[s],
                                                     **bargs) * col_keep
                for m in range(n_model)) + (v_s.sum(dim=1).sum(),))
        *g, cnt = tree_allreduce_sum(per)
        return torch.cat(g), cnt

    return _build_scan(config, sample_and_grad, prep_xs=prep_xs)


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
    and resumed from the newest (bitwise equal to a straight run). With
    ``feature_sharded`` the features are split over ``mesh.n_model``
    slices (padded with zero columns to a multiple of it); the result's
    w is in the original layout."""
    _check_feature_sharded(config)
    _check_ported(config)
    if config.sampler in ("fused", "fused_gather", "fused_train"):
        train_fn = _train_fused_tp if config.feature_sharded else _train_fused
        return train_fn(X_train, y_train, X_test, y_test, mesh, config,
                        checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every)
    d_orig = X_train.shape[1]
    if config.feature_sharded:
        # zero feature columns are inert: zero gradient, w stays at w0
        X_train, _ = pad_features(np.asarray(X_train, np.float32),
                                  mesh.n_model)
        X_test, _ = pad_features(np.asarray(X_test, np.float32),
                                 mesh.n_model)
    Xs = parallelize(X_train, mesh,
                     dtype=ssgd_kernels.as_dtype(config.x_dtype))
    ys = parallelize(np.asarray(y_train, np.float32), mesh)
    w0 = logistic.init_weights(prng.root_key(config.init_seed, mesh.device),
                               X_train.shape[1])
    X_te = torch.as_tensor(np.asarray(X_test, np.float32)).to(mesh.device)
    y_te = torch.as_tensor(np.asarray(y_test, np.float32)).to(mesh.device)
    X_data = (shard_features(Xs.data, mesh.n_model) if config.feature_sharded
              else Xs.data)
    data = (X_data, ys.data, Xs.mask, X_te, y_te)
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


def prepare_fused_synthetic(n_rows: int, n_features: int, mesh: Mesh,
                            config: SSGDConfig, *, data_seed: int = 0,
                            separation: float = 2.0,
                            chunk_rows: int = 1 << 20):
    """:func:`prepare_fused` for the two-class task made ON the device
    (``ssgd.py:1623-1693``): host memory stays O(1) in ``n_rows``.
    Rows are padded to a multiple of ``max(block, pack)·n_shards``;
    each shard's rows are made in chunks of ``chunk_rows``, halved
    until it divides the shard's rows and the pack, by
    :func:`..utils.datasets.synthetic_two_class_rows` from their global
    ids, and written in X's dtype as ``[features | 1 | y | valid |
    0…]`` (padding rows are made too, with valid 0). Returns ``(fn, X2,
    w0, meta)`` like :func:`prepare_fused`."""
    from tpu_distalg_torch.utils import datasets

    n_shards = mesh.n_data
    pk = config.fused_pack
    d = n_features + 1  # + the bias column (ssgd.py:83-84)
    d_t, y_col, v_col = ssgd_kernels.packed_dims(d, pk)
    block = (config.gather_block_rows
             if config.sampler in ("fused_gather", "fused_train")
             else config.fused_block_rows)
    mult = max(block, pk) * n_shards
    n_t = n_rows + ((-n_rows) % mult)
    n_local = n_t // n_shards
    chunk = min(chunk_rows, n_local)
    while chunk and (n_local % chunk or chunk % pk):
        chunk //= 2
    if chunk == 0:
        raise ValueError(
            f"cannot chunk n_local={n_local} rows by pack={pk}")
    make_rows = datasets.synthetic_two_class_rows(n_features, data_seed,
                                                  separation)
    dev = mesh.device
    X2 = torch.empty((n_t // pk, pk * d_t),
                     dtype=ssgd_kernels.as_dtype(config.x_dtype), device=dev)
    rows = X2.view(n_t, d_t)
    for lo in range(0, n_t, chunk):   # shard s owns rows [s·n_local, …)
        ids = torch.arange(lo, lo + chunk, dtype=torch.int64, device=dev)
        X, y = make_rows(ids)
        out = torch.zeros((chunk, d_t), dtype=torch.float32, device=dev)
        out[:, :n_features] = X
        out[:, n_features] = 1.0
        out[:, y_col] = y
        out[:, v_col] = (ids < n_rows).to(torch.float32)
        rows[lo:lo + chunk] = out
    meta = dict(pack=pk, d_total=d_t, y_col=y_col, v_col=v_col,
                n_padded=n_t)
    w0 = torch.zeros((d_t,), dtype=torch.float32, device=dev)
    w0[:d] = logistic.init_weights(prng.root_key(config.init_seed, dev), d)
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


def prepare_fused_tp(X_train, y_train, mesh: Mesh, config: SSGDConfig):
    """The dp×tp set-up of ``fused_gather`` (``ssgd.py:1210-1258``): the
    features, padded with zero columns to a multiple of ``mesh.n_model``,
    split into slices of ``d_local``; each slice is packed on its own by
    :func:`~tpu_distalg_torch.ops.ssgd_kernels.pack_augmented` with the
    y/v columns replicated, the same ``shuffle_seed`` and block rows
    ``gather_block_rows × n_data``, so slot (i, p) holds the same row in
    every slice. Each slice goes to the device in X's dtype before the
    next is packed. Returns ``(fn, X2, w0, meta)``: X2 (n_model, n2, P·D),
    w0 the (n_model·D,) concatenation of the slices' augmented weights
    (the initial weights over the padded width, placed per slice, zero
    at every y/v/pad column), meta :func:`pack_augmented`'s with
    ``n_model``, ``d_local`` and ``d_orig``."""
    n_data, n_model = mesh.n_data, mesh.n_model
    n, d_orig = X_train.shape
    X_np, d_l = pad_features(np.asarray(X_train, np.float32), n_model)
    y_np, valid = np.asarray(y_train), np.ones(n, np.float32)
    X2 = meta = None
    for m in range(n_model):
        X2_m, meta = ssgd_kernels.pack_augmented(
            X_np[:, m * d_l:(m + 1) * d_l], y_np, valid,
            dtype=config.x_dtype, pack=config.fused_pack,
            block_rows=config.gather_block_rows * n_data,
            shuffle_seed=config.shuffle_seed, device=mesh.device)
        if X2 is None:
            X2 = torch.empty((n_model, *X2_m.shape), dtype=X2_m.dtype,
                             device=mesh.device)
        X2[m] = X2_m
        del X2_m
    d_t = meta["d_total"]
    meta = dict(meta, n_model=n_model, d_local=d_l, d_orig=d_orig)
    w_init = torch.zeros((n_model * d_l,), dtype=torch.float32,
                         device=mesh.device)
    w_init[:d_orig] = logistic.init_weights(
        prng.root_key(config.init_seed, mesh.device), d_orig)
    w0 = torch.zeros((n_model, d_t), dtype=torch.float32, device=mesh.device)
    w0[:, :d_l] = w_init.view(n_model, d_l)
    fn = make_train_fn_fused_tp(mesh, config, meta)
    return fn, X2, w0.reshape(-1), meta


def tp_augment_test_matrix(X_test, meta: dict, *,
                           device: str | torch.device | None = None):
    """Test features in the slices' concatenated augmented layout
    (n, n_model·D), zero at every y/v/pad column (whose weights are held
    at zero, so the padded product equals the original)."""
    from tpu_distalg_torch.utils.device import resolve_device

    d_t, d_l, n_model = meta["d_total"], meta["d_local"], meta["n_model"]
    X_np = np.asarray(X_test, np.float32)
    out = np.zeros((X_np.shape[0], n_model * d_t), np.float32)
    for m in range(n_model):
        width = min(d_l, max(0, X_np.shape[1] - m * d_l))
        out[:, m * d_t:m * d_t + width] = X_np[:, m * d_l:m * d_l + width]
    return torch.from_numpy(out).to(resolve_device(device))


def tp_extract_weights(w, meta: dict) -> torch.Tensor:
    """The original-layout (d_orig,) weights from the slices'
    concatenated augmented vector (inverse of :func:`prepare_fused_tp`'s
    placement)."""
    d_t, d_l = meta["d_total"], meta["d_local"]
    return w.view(meta["n_model"], d_t)[:, :d_l].reshape(-1)[
        :meta["d_orig"]].contiguous()


def train_prepared_tp(mesh: Mesh, config: SSGDConfig, X2, w0, meta: dict,
                      X_te, y_te, *, checkpoint_dir: str | None = None,
                      checkpoint_every: int = 500):
    """Run the dp×tp ``fused_gather`` trainer on :func:`prepare_fused_tp`'s
    X2 and w0 → ``(w, accs)`` in the augmented layout; with
    ``checkpoint_dir``, in segments saved under the tag
    ``ssgd:fused_gather:tp`` (bitwise equal to a straight run)."""
    if checkpoint_dir is None:
        w, accs = make_train_fn_fused_tp(mesh, config, meta)(
            X2, None, None, X_te, y_te, w0)
        metrics.guard_finite(w, "SSGD (fused tp) weights")
        return w, accs

    from tpu_distalg_torch.utils import checkpoint as ckpt

    (w, _), accs, _ = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, config.n_iterations,
        make_seg_fn=lambda seg: make_train_fn_fused_tp(
            mesh, dataclasses.replace(config, n_iterations=seg), meta),
        run_seg=_acc_carrying_run_seg(X2, None, None, X_te, y_te),
        state0=(w0, torch.zeros((), dtype=torch.float32,
                                device=mesh.device)),
        tag=f"ssgd:{config.sampler}:tp")
    return w, torch.from_numpy(accs)


def _train_fused_tp(X_train, y_train, X_test, y_test, mesh: Mesh,
                    config: SSGDConfig, *, checkpoint_dir: str | None = None,
                    checkpoint_every: int = 500) -> TrainResult:
    """dp×tp ``fused_gather`` training (``ssgd.py:1716-1749``)."""
    _, X2, w0, meta = prepare_fused_tp(X_train, y_train, mesh, config)
    X_te = tp_augment_test_matrix(X_test, meta, device=mesh.device)
    y_te = torch.as_tensor(np.asarray(y_test, np.float32)).to(mesh.device)
    w, accs = train_prepared_tp(mesh, config, X2, w0, meta, X_te, y_te,
                                checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every)
    return TrainResult(w=tp_extract_weights(w, meta), accs=accs)
