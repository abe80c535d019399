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

With ``comm`` other than ``dense`` (``bernoulli``, ``fused_gather`` and
``fused``) the per-step (Σg, count) sync runs the schedule of
:mod:`tpu_distalg_torch.parallel.comms` (``ssgd.py:134-205``,
``:853-900``, ``:1018-1116``); its error-feedback residual rides the
carry and the checkpoint (:func:`_train_steps`). With
``sync='ssp[:s[:decay]]'`` the same samplers train stale-synchronously
(:func:`make_ssp_train_fn`, ``ssgd.py:368-851``): windows of ``s`` local
ticks, one merge a window, the straggle and membership schedules
compiled from the seeded fault plan, elastic epochs and renegotiated
resumes through :func:`..parallel.membership.run_elastic`. Every
decision of a window (clocks, gates, deliveries) stays on the device:
each tick computes every shard's gradient and masks the update.

The ``virtual`` sampler (rows regenerated a step from their ids) is
``models/ssgd_virtual.py`` and the streamed trainer (rows staged from
host memory or disk) ``models/ssgd_stream.py``, as in the JAX package;
the streamed trainer shares :func:`gathered_per_shard` and
:func:`_build_scan` with ``fused_gather``. The JAX package's refusals
(``feature_sharded`` with other samplers, ``use_pallas``, a ``comm``
schedule or SSP; ``fixed`` and ``fused_train`` with a schedule or SSP;
``use_pallas`` with either; ``virtual`` in these builders) raise its
ValueErrors.
"""

from __future__ import annotations

import dataclasses
import functools

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


def _check_comm_sampler(config: SSGDConfig) -> None:
    """The JAX package's refusals of a schedule where no per-step
    collective exists, in its words (``ssgd.py:326-346``)."""
    if config.comm == "dense":
        return
    if config.feature_sharded:
        raise ValueError(
            "comm != 'dense' does not compose with feature_sharded "
            "(the tp split's model-axis matvec psum is activation "
            "traffic, not a gradient sync); run the comm schedules on "
            "a pure-dp mesh")
    if config.sampler in ("fused_train", "fixed"):
        raise ValueError(
            f"comm={config.comm!r} applies to the per-step gradient "
            f"sync, which sampler={config.sampler!r} does not expose "
            "('fused_train' fuses whole segments into one launch with "
            "no per-step collective; 'fixed' is the measured-slower "
            "legacy gather path) — use 'bernoulli', 'fused' or "
            "'fused_gather'")


def _check_sync_sampler(config: SSGDConfig) -> None:
    """The JAX package's refusal of SSP off its samplers, in its words
    (``ssgd.py:349-365``)."""
    from tpu_distalg_torch.parallel import ssp as pssp

    if not pssp.SyncSpec.parse(config.sync).is_ssp:
        return
    if config.sampler not in ("bernoulli", "fused", "fused_gather") \
            or config.use_pallas or config.feature_sharded:
        raise ValueError(
            f"sync={config.sync!r} (stale-synchronous) composes with "
            f"the 'bernoulli', 'fused' and 'fused_gather' samplers on "
            f"a pure-dp mesh — got sampler={config.sampler!r} "
            f"use_pallas={config.use_pallas} "
            f"feature_sharded={config.feature_sharded}; 'fused_train' "
            f"(no per-window collective exists inside the megakernel), "
            f"'fixed' and the tp split stay BSP")


def _check_ported(config: SSGDConfig) -> None:
    """The JAX package's refusals of a sampler, a schedule or SSP. The
    ``virtual`` sampler trains through ``models/ssgd_virtual.py``; the
    builders here refuse it, as the JAX package's do."""
    _check_fixed(config)
    if config.sampler not in _SAMPLERS:
        raise ValueError(f"unknown sampler {config.sampler!r}")
    _check_comm_sampler(config)
    _check_sync_sampler(config)


def _comm_sync(mesh: Mesh, config: SSGDConfig, d: int):
    """The trainer's one CommSync over the (Σ grad, count) pair
    (``ssgd.py:134``)."""
    from tpu_distalg_torch.parallel import comms

    return comms.make_sync(config.comm, mesh,
                           (comms.leaf((d,)), comms.leaf(())))


def _ssp_comm_sync(mesh: Mesh, config: SSGDConfig, d: int):
    """The SSP merge's CommSync: one (d,) leaf, the staleness-weighted
    delta (``ssgd.py:147``); the clocks are integers and stay exact."""
    from tpu_distalg_torch.parallel import comms

    return comms.make_sync(config.comm, mesh, (comms.leaf((d,)),))


def _build_scan(config: SSGDConfig, sample_and_grad, prep_xs=None,
                sync=None):
    """The step loop shared by every per-step sampler:
    ``sample_and_grad(X, y, valid, w, payload)`` → global (Σ grad,
    count), then the reference's update and evaluation. ``prep_xs(ts)``
    maps the absolute step ids to the per-step payloads (all drawn
    before the loop); without it the payload is the step id.

    With ``sync``, a schedule's CommSync (``ssgd.py:159``),
    ``sample_and_grad`` returns the shards' (Σ grad, count) pairs
    instead; they go through ``sync.reduce`` with the regularization
    gradient as its ``compute`` thunk, and the error-feedback residual
    rides the loop: call ``train(..., w0, res0, t0=0, acc0=0.0)`` →
    ``(w, accs, res)``."""
    if config.eval_every < 1:
        raise ValueError(
            f"eval_every must be >= 1, got {config.eval_every}")

    def train(X, y, valid, X_test, y_test, w0, res0=None, t0=0, acc0=0.0):
        T = config.n_iterations
        ts = torch.arange(t0, t0 + T, dtype=torch.int64, device=w0.device)
        payloads = prep_xs(ts) if prep_xs is not None else range(t0, t0 + T)
        w, res = w0, res0
        last = torch.as_tensor(acc0, dtype=torch.float32).to(w0.device)
        zero = torch.zeros((), dtype=torch.float32, device=w0.device)
        accs = []
        for i in range(T):
            t = t0 + i
            out = sample_and_grad(X, y, valid, w, payloads[i])
            reg = functools.partial(logistic.reg_gradient, w,
                                    config.reg_type, config.elastic_alpha)
            if sync is None:
                (g, cnt), reg = out, reg()
            else:
                (g, cnt), res, reg = sync.reduce(out, res, t, compute=reg)
            n_batch = torch.clamp_min(cnt, 1.0)
            w = w - config.eta * (g / n_batch + config.lam * reg)
            if not config.eval_test:
                last = zero
            elif config.eval_every == 1 or t % config.eval_every == 0:
                last = metrics.binary_accuracy(X_test @ w, y_test)
            accs.append(last)
        accs = (torch.stack(accs) if accs
                else torch.zeros((0,), dtype=torch.float32,
                                 device=w0.device))
        return (w, accs) if sync is None else (w, accs, res)

    return train


def make_train_fn(mesh: Mesh, config: SSGDConfig, n_padded: int, *,
                  d: int | None = None):
    """The ``bernoulli`` trainer: call as ``fn(X, y, valid, X_test,
    y_test, w0, t0=0, acc0=0.0)`` → ``(w, accs)`` with X, y, valid the
    padded arrays of :func:`parallelize`. With ``feature_sharded``, X is
    the (n_model, n_padded, d_local) tensor of
    :func:`~tpu_distalg_torch.parallel.shard_features` and w the
    (n_model·d_local,) weights. With ``comm`` other than ``dense`` pass
    ``d`` (w's length) and call ``fn(X, y, valid, X_test, y_test, w0,
    res0, t0=0, acc0=0.0)`` → ``(w, accs, res)``."""
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
    sync = None
    if config.comm != "dense":
        if d is None:
            raise ValueError(
                f"comm={config.comm!r} needs the feature width: call "
                "make_train_fn(mesh, config, n_padded, d=X.shape[1]) "
                "(ssgd.train does this for you)")
        if config.use_pallas:
            raise ValueError(
                "comm != 'dense' composes with the XLA 'bernoulli' path "
                "or the fused kernels, not use_pallas=True")
        sync = _comm_sync(mesh, config, d)
    n_shards = mesh.n_data
    n_local = n_padded // n_shards
    key = prng.root_key(config.seed, mesh.device)
    frac = sampling.fraction_tensor(config.mini_batch_fraction, mesh.device)

    def local_grad(X, y, mask, w):
        if config.use_pallas:
            return ssgd_kernels.fused_grad_sum(
                X, y, mask, w, block_rows=config.pallas_block_rows)
        return logistic.grad_sum(X, y, w, mask)

    def sample_and_grad(X, y, valid, w, payload):
        _, u = payload
        mask = sampling.bernoulli_mask_from_uniform(u, frac, valid)
        per = [local_grad(X[s * n_local:(s + 1) * n_local],
                          y[s * n_local:(s + 1) * n_local],
                          mask[s * n_local:(s + 1) * n_local], w)
               for s in range(n_shards)]
        return per if sync is not None else tree_allreduce_sum(per)

    return _build_scan(config, sample_and_grad,
                       prep_xs=_bernoulli_draws(key, n_padded), sync=sync)


#: int64 words of one group of ``fixed`` draws (steps × shards × rows):
#: the steps of a group are drawn in one batched call, and each int64
#: temporary of the hash then stays near 128 MB
FIXED_WORDS_PER_GROUP = 1 << 24


def _bernoulli_draws(key, n_padded: int):
    """``bernoulli``'s ``prep_xs``: step i's payload is (its absolute
    step, the (n_padded,) uniforms of its mask), the uniforms drawn for
    :data:`FIXED_WORDS_PER_GROUP` words' worth of steps in one call (a
    draw depends only on its key and counter, so the masks equal one
    draw a step's bitwise)."""
    group = max(1, FIXED_WORDS_PER_GROUP // max(1, n_padded))

    def prep_xs(ts):
        draws = _GroupedDraws(
            lambda t: prng.uniform(prng.step_key(key, t), (n_padded,)), ts,
            group)
        return _WithSteps(draws, ts.cpu().tolist())

    return prep_xs


class _WithSteps:
    """Step i's payload as ``(absolute step, draws[i])``."""

    def __init__(self, draws, steps: list):
        self.draws, self.steps = draws, steps

    def __getitem__(self, i: int):
        return self.steps[i], self.draws[i]


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
        per_shard = _fused_per_shard(config, meta, n_shards, col_keep)
        prep_xs = None
    elif config.sampler == "fused_gather":
        prep_xs = _block_draws(mesh, config, meta)
        gathered = gathered_per_shard(config, meta, col_keep)

        def per_shard(X2, w, ids):
            return gathered([X2] * n_shards, w, ids)
    else:
        raise ValueError(f"sampler={config.sampler!r} is not a packed-"
                         f"layout sampler")
    sync = (None if config.comm == "dense"
            else _comm_sync(mesh, config, meta["d_total"]))

    def sample_and_grad(X2, y, valid, w, payload):
        del y, valid  # labels and validity ride inside X2
        per = per_shard(X2, w, payload)
        return per if sync is not None else tree_allreduce_sum(per)

    return _build_scan(config, sample_and_grad, prep_xs=prep_xs, sync=sync)


def gathered_per_shard(config: SSGDConfig, meta: dict, col_keep):
    """``fused_gather``'s gradient, shared with the streamed trainer
    (``models/ssgd_stream.py``): ``per_shard(X2s, w, ids)`` → each
    shard's (Σ grad, count) from kernel B1 over the blocks ``ids[s]`` of
    ``X2s[s]`` (the whole X2 with global ids here, a staged batch with
    the identity ids there), the y/v/pad columns zeroed."""
    kargs = _kernel_args(config, meta)

    def per_shard(X2s, w, ids):
        return [(g * col_keep, cnt) for g, cnt in (
            ssgd_kernels.fused_grad_sum_gathered(X2s[s], w, ids[s], **kargs)
            for s in range(len(ids)))]

    return per_shard


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


def _fused_per_shard(config: SSGDConfig, meta: dict, n_shards: int,
                     col_keep):
    """``fused``: each shard's rows go whole through kernel B5, keyed on
    the absolute step plus the seed and on the shard, so a segmented
    run draws what a straight one draws. ``per_shard(X2, w, t)`` → the
    shards' (Σ grad, count), the y/v/pad columns zeroed."""
    n2_local = (meta["n_padded"] // meta["pack"]) // n_shards
    kargs = dict(pack=meta["pack"], d_total=meta["d_total"],
                 y_col=meta["y_col"], v_col=meta["v_col"],
                 fraction=config.mini_batch_fraction,
                 block_rows=config.fused_block_rows)

    def per_shard(X2, w, t):
        per = []
        for s in range(n_shards):
            g, cnt = ssgd_kernels.fused_grad_sum_packed(
                X2[s * n2_local:(s + 1) * n2_local], w, t + config.seed, s,
                **kargs)
            per.append((g * col_keep, cnt))
        return per

    return per_shard


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
    w is in the original layout. With ``comm`` other than ``dense`` the
    carry adds the error-feedback residual; with ``sync='ssp…'`` training
    runs in windows (:func:`_train_ssp`)."""
    from tpu_distalg_torch.parallel import ssp as pssp
    from tpu_distalg_torch.telemetry import events as tevents

    tevents.mark(f"ssgd:{config.sampler}", emit_event=False)
    _check_feature_sharded(config)
    _check_ported(config)
    if pssp.SyncSpec.parse(config.sync).is_ssp:
        return _train_ssp(X_train, y_train, X_test, y_test, mesh, config,
                          checkpoint_dir=checkpoint_dir,
                          checkpoint_every=checkpoint_every)
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
    return _train_steps(
        mesh, config, d_orig, data, w0,
        make_fn=lambda seg: make_train_fn(
            mesh, dataclasses.replace(config, n_iterations=seg),
            Xs.n_padded, d=d_orig),
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        crop=d_orig, what="SSGD weights")


def _train_steps(mesh: Mesh, config: SSGDConfig, d: int, data_args, w0, *,
                 make_fn, checkpoint_dir, checkpoint_every, crop: int,
                 what: str, fn=None) -> TrainResult:
    """The training driver of ``bernoulli`` and the packed samplers,
    straight or in checkpointed segments (``ssgd.py:1550-1588``). The
    carry is (w, last accuracy); with ``comm`` other than ``dense`` it
    also holds the error-feedback residual (zero-width when the
    schedule is stateless, as in JAX), placed by the ``ssgd`` table, so
    a resumed ``topk`` run replays bitwise."""
    from tpu_distalg_torch.parallel import comms, partition

    sync = None if config.comm == "dense" else _comm_sync(mesh, config, d)

    def place(res):
        return [partition.place({"res": r}, "ssgd", mesh)["res"]
                for r in res]

    res0 = () if sync is None else tuple(place([sync.init_state()]))
    if checkpoint_dir is None:
        fn = fn if fn is not None else make_fn(config.n_iterations)
        w, accs, *_ = fn(*data_args, w0, *res0)
        start = 0
        metrics.guard_finite(w, what)
    else:
        from tpu_distalg_torch.utils import checkpoint as ckpt

        def run_seg(seg_fn, state, t0):
            w, acc0, *res = state
            w, accs, *res = seg_fn(*data_args, w, *place(res), t0=t0,
                                   acc0=acc0)
            return (w, accs[-1], *res), accs

        (w, *_), accs, start = ckpt.run_segmented(
            checkpoint_dir, checkpoint_every, config.n_iterations,
            make_seg_fn=make_fn, run_seg=run_seg,
            state0=(w0, torch.zeros((), dtype=torch.float32,
                                    device=mesh.device), *res0),
            tag=f"ssgd:{config.sampler}" + (
                "" if sync is None else f":comm={config.comm}"))
        accs = torch.from_numpy(accs)
    if sync is not None:
        # only the syncs this process ran (a resume skips the rest)
        comms.emit_sync_counters(sync, config.n_iterations - start)
    return TrainResult(w=w[:crop], accs=accs)


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
    if checkpoint_dir is not None and config.sampler == "fused_train":
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
    return _train_steps(
        mesh, config, meta["d_total"], (X2, None, None, X_te, y_te), w0,
        make_fn=lambda seg: make_train_fn_fused(
            mesh, dataclasses.replace(config, n_iterations=seg), meta),
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        crop=d_orig, what="SSGD (fused) weights", fn=fn)


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


# ------------------------------------------------- stale-synchronous SSGD


def _ssp_tick_grads(mesh: Mesh, config: SSGDConfig, n_padded: int,
                    meta: dict | None):
    """The per-tick payloads and gradients of the SSP window
    (``ssgd.py:419-484``): ``payloads(ts)`` draws the ticks ``ts`` of a
    segment at once, ``grads(X, y, wl, payload_t)`` gives every shard's
    (Σ grad, count) at its own local model → ((S, D), (S,)). Draws are
    made a window at a time (``ts`` the window's ticks)."""
    S = mesh.n_data
    key = prng.root_key(config.seed, mesh.device)
    if meta is None:
        n_local = n_padded // S

        def payloads(ts, valid):
            return sampling.bernoulli_mask(key, ts, n_padded,
                                           config.mini_batch_fraction, valid)

        def grads(X, y, wl, mask):
            per = [logistic.grad_sum(X[s * n_local:(s + 1) * n_local],
                                     y[s * n_local:(s + 1) * n_local], wl[s],
                                     mask[s * n_local:(s + 1) * n_local])
                   for s in range(S)]
            return (torch.stack([g for g, _ in per]),
                    torch.stack([c for _, c in per]))

        return payloads, grads
    col_keep = (torch.arange(meta["d_total"], device=mesh.device)
                < meta["y_col"]).to(torch.float32)
    if config.sampler == "fused_gather":
        draw = _block_draws(mesh, config, meta)
        kargs = _kernel_args(config, meta)

        def payloads(ts, valid):
            del valid                          # validity rides X2
            return draw(ts)

        def grads(X2, y, wl, ids):
            per = [ssgd_kernels.fused_grad_sum_gathered(X2, wl[s], ids[s],
                                                        **kargs)
                   for s in range(S)]
            return (torch.stack([g for g, _ in per]) * col_keep,
                    torch.stack([c for _, c in per]))

        return payloads, grads
    n2_local = (meta["n_padded"] // meta["pack"]) // S
    kargs = dict(pack=meta["pack"], d_total=meta["d_total"],
                 y_col=meta["y_col"], v_col=meta["v_col"],
                 fraction=config.mini_batch_fraction,
                 block_rows=config.fused_block_rows)

    def payloads(ts, valid):
        del valid
        return ts.tolist()

    def grads(X2, y, wl, t):
        per = [ssgd_kernels.fused_grad_sum_packed(
                   X2[s * n2_local:(s + 1) * n2_local], wl[s],
                   t + config.seed, s, **kargs)
               for s in range(S)]
        return (torch.stack([g for g, _ in per]) * col_keep,
                torch.stack([c for _, c in per]))

    return payloads, grads


def make_ssp_train_fn(mesh: Mesh, config: SSGDConfig, n_padded: int, d: int,
                      *, active: tuple[bool, ...], n_win_seg: int,
                      total_ticks: int, meta: dict | None = None):
    """The SSP window loop (``ssgd.py:368-617``), one function per
    (active set, segment window count). Call as ``fn(X, y, valid, X_test,
    y_test, w0, clocks0, pend0, basegen0, wl0, accd0, res0, extra_seg,
    win0)`` with ``extra_seg`` the segment's (n_win_seg, s, S) host
    straggle schedule and ``win0`` its first window → ``(w, clocks,
    pend, basegen, wl, accd, res, win_accs, ages_max, ages_mean,
    gated)``, the last four (n_win_seg,) tensors.

    Per window: shards with nothing pending adopt the center (base
    generation = this window, clock to the head of the pack); each of
    the ``s`` ticks is a local SGD step on every shard, masked where the
    straggle schedule claims the tick or the gate trips (own clock minus
    the window-start active minimum ≥ the bound); at the boundary the
    shards not straggling deliver their accumulated update weighted
    ``decay**age``, the clocks are combined and the center moves by the
    weighted average, through the sync's schedule. With ``meta`` the
    tick's gradient runs kernel B1 (``fused_gather``) or B5 (``fused``)
    once a shard. The host reads nothing back inside the loop: the
    schedule's masks and the straggle launches come from host data, the
    clocks and gates stay on the device."""
    from tpu_distalg_torch.parallel import ssp as pssp

    spec = pssp.SyncSpec.parse(config.sync)
    s = spec.staleness
    S = mesh.n_data
    dev = mesh.device
    sync = _ssp_comm_sync(mesh, config, d)
    payloads, grads = _ssp_tick_grads(mesh, config, n_padded, meta)
    active_np = np.asarray(active, bool)
    act = torch.as_tensor(active_np, device=dev)
    big = 1 << 30

    def train(X, y, valid, X_test, y_test, w0, clocks0, pend0, basegen0,
              wl0, accd0, res0, extra_seg, win0):
        extra_seg = np.asarray(extra_seg, np.int32)
        ticks = win0 * s + np.arange(n_win_seg * s).reshape(n_win_seg, s)
        tickv = ticks < total_ticks
        # host-known parts of every tick's `do` and of the boundary,
        # sent to the card once a segment
        free = tickv[:, :, None] & active_np & (extra_seg == 0)
        counted = tickv[:, :, None] & active_np
        busy = extra_seg[:, -1] > 0
        free_d, counted_d, busy_d, extra_d = (
            torch.as_tensor(a, device=dev)
            for a in (free, counted, busy, extra_seg))
        ticks_d = torch.as_tensor(ticks, dtype=torch.int64, device=dev)
        w, clocks, pend, basegen, wl, accd, res = (
            w0, clocks0, pend0, basegen0, wl0, accd0, res0)
        accs, amax, amean, gated_w = [], [], [], []
        for i in range(n_win_seg):
            winid = win0 + i
            adopt = act & ~pend
            basegen = torch.where(adopt, winid, basegen).to(torch.int32)
            max_c = torch.where(act, clocks, -big).max()
            clocks_adj = torch.where(adopt, max_c, clocks).to(clocks.dtype)
            min_known = torch.where(act, clocks_adj, big).min()
            fresh = (act & ~pend)[:, None]
            wl = torch.where(fresh, w[None, :], wl)
            accd = torch.where(fresh, torch.zeros_like(accd), accd)
            my_clock = clocks_adj
            gated_ct = torch.zeros((S,), dtype=torch.int32, device=dev)
            pay = payloads(ticks_d[i], valid)
            for k in range(s):
                if extra_seg[i, k].any():
                    # the straggler's work: its value never enters the state
                    pssp.entangle(wl, pssp.straggle_work(extra_d[i, k]))
                gated = (my_clock - min_known) >= s
                do = free_d[i, k] & ~gated
                g, cnt = grads(X, y, wl, pay[k])
                reg = logistic.reg_gradient(wl, config.reg_type,
                                            config.elastic_alpha)
                upd = config.eta * (g / torch.clamp_min(cnt, 1.0)[:, None]
                                    + config.lam * reg)
                dof = do.to(torch.float32)[:, None]
                wl = wl - dof * upd
                accd = accd - dof * upd
                my_clock = my_clock + do.to(my_clock.dtype)
                gated_ct = gated_ct + (counted_d[i, k] & gated).to(
                    torch.int32)
            clocks_new = my_clock
            stepped = clocks_new > clocks_adj
            pend2 = (pend | stepped) & act
            deliver = pend2 & ~busy_d[i] & act
            ages = torch.clamp_min(winid - basegen, 0)
            wts = pssp.staleness_weights(ages, act, deliver, spec.decay)
            wsum = wts.sum()
            contrib = wts[:, None] * accd
            (summed,), res_new = sync.reduce(
                [(contrib[j],) for j in range(S)], res, winid)
            # a merge nobody delivered to changes nothing, the residual
            # a stateful schedule flushed into it included
            delivered_any = wsum > 0
            w = w + torch.where(
                delivered_any,
                summed / torch.clamp_min(wsum, 1e-12),
                torch.zeros_like(summed))
            res = torch.where(delivered_any, res_new, res) \
                if res_new is not None else res
            ages_obs = torch.where(deliver, ages, torch.zeros_like(ages))
            n_del = deliver.to(torch.float32).sum()
            amax.append(ages_obs.max().to(torch.float32))
            amean.append(ages_obs.to(torch.float32).sum()
                         / torch.clamp_min(n_del, 1.0))
            gated_w.append(gated_ct.sum())
            pend = pend2 & ~deliver
            accd = torch.where(deliver[:, None], torch.zeros_like(accd),
                               accd)
            clocks = clocks_new
            accs.append(metrics.binary_accuracy(X_test @ w, y_test)
                        if config.eval_test else
                        torch.zeros((), dtype=torch.float32, device=dev))

        def stack(xs, dtype):
            return (torch.stack(xs) if xs
                    else torch.zeros((0,), dtype=dtype, device=dev))

        return (w, clocks, pend, basegen, wl, accd, res,
                stack(accs, torch.float32), stack(amax, torch.float32),
                stack(amean, torch.float32), stack(gated_w, torch.int64))

    return train


def ssp_init_state(mesh: Mesh, config: SSGDConfig, d: int, *, w=None,
                   clocks=None, win0: int = 0):
    """The host SSP carry (``ssgd.py:620``), in call order: ``(w,
    clocks, pending, base_gen, local_models, accumulated_deltas,
    ef_residual)`` — for step 0 and for a renegotiated resume alike."""
    n_shards = mesh.n_data
    sync = _ssp_comm_sync(mesh, config, d)
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = (np.zeros((d,), np.float32) if w is None
         else np.asarray(w, np.float32))
    clocks = (np.zeros((n_shards,), np.int32) if clocks is None
              else np.asarray(clocks, np.int32))
    return (w, clocks,
            np.zeros((n_shards,), bool),
            np.full((n_shards,), int(win0), np.int32),
            np.tile(w, (n_shards, 1)),
            np.zeros((n_shards, d), np.float32),
            np.asarray(sync.init_state()))


def make_bsp_straggler_fn(mesh: Mesh, config: SSGDConfig, n_padded: int,
                          extra):
    """The straggler bench's BSP arm (``ssgd.py:646``): the ``bernoulli``
    trainer of :func:`make_train_fn`, bitwise, with each step's straggle
    work (``extra`` (n_ticks, S), from
    :func:`..parallel.ssp.compile_straggle_schedule`) run before the
    step's sum, so the step waits for it. Returns ``fn(X, y, valid,
    X_test, y_test, w0)`` → ``(w, accs)``."""
    from tpu_distalg_torch.parallel import ssp as pssp

    extra = np.asarray(extra, np.int32)
    extra_d = torch.as_tensor(extra, device=mesh.device)
    S = mesh.n_data
    n_local = n_padded // S
    key = prng.root_key(config.seed, mesh.device)
    frac = sampling.fraction_tensor(config.mini_batch_fraction, mesh.device)

    def sample_and_grad(X, y, valid, w, payload):
        t, u = payload
        mask = sampling.bernoulli_mask_from_uniform(u, frac, valid)
        dummy = (pssp.straggle_work(extra_d[t]) if extra[t].any()
                 else None)
        per = [(pssp.entangle(g, dummy), cnt) for g, cnt in (
            logistic.grad_sum(X[s * n_local:(s + 1) * n_local],
                              y[s * n_local:(s + 1) * n_local], w,
                              mask[s * n_local:(s + 1) * n_local])
            for s in range(S))]
        return tree_allreduce_sum(per)

    return _build_scan(config, sample_and_grad,
                       prep_xs=_bernoulli_draws(key, n_padded))


def window_accs_to_ticks(win_accs, s: int, n_ticks: int) -> np.ndarray:
    """Per-window accuracies → the per-tick history (``ssgd.py:696``):
    tick t carries the last merge's accuracy (0 before the first), the
    final tick the final merge's."""
    win_accs = np.asarray(win_accs, np.float32)
    if win_accs.size == 0 or n_ticks <= 0:
        return np.zeros((max(0, n_ticks),), np.float32)
    prev = np.concatenate([[np.float32(0.0)], win_accs[:-1]])
    accs = np.repeat(prev, s)
    accs[s - 1::s] = win_accs
    accs = accs[:n_ticks]
    accs[-1] = win_accs[-1]
    return accs


def _train_ssp(X_train, y_train, X_test, y_test, mesh: Mesh,
               config: SSGDConfig, *, checkpoint_dir: str | None = None,
               checkpoint_every: int = 500) -> TrainResult:
    """Stale-synchronous training (``ssgd.py:717-850``): the data packed
    or split as the sampler wants it, then :func:`train_prepared_ssp`."""
    from tpu_distalg_torch.parallel import ssp as pssp

    spec = pssp.SyncSpec.parse(config.sync)
    d_orig = X_train.shape[1]
    dev = mesh.device
    y_te = torch.as_tensor(np.asarray(y_test, np.float32)).to(dev)
    if config.sampler in ("fused", "fused_gather"):
        _, X2, w0, meta = prepare_fused(X_train, y_train, mesh, config)
        data = (X2, None, None)
        X_te = torch.as_tensor(np.pad(
            np.asarray(X_test, np.float32),
            ((0, 0), (0, meta["d_total"] - d_orig)))).to(dev)
        tag = f"ssgd:{config.sampler}:{spec.spec()}:comm={config.comm}"
        n_padded = meta["n_padded"]
    else:
        meta = None
        Xs = parallelize(X_train, mesh,
                         dtype=ssgd_kernels.as_dtype(config.x_dtype))
        ys = parallelize(np.asarray(y_train, np.float32), mesh)
        data = (Xs.data, ys.data, Xs.mask)
        X_te = torch.as_tensor(np.asarray(X_test, np.float32)).to(dev)
        w0 = logistic.init_weights(prng.root_key(config.init_seed, dev),
                                   d_orig)
        tag = f"ssgd:{spec.spec()}:comm={config.comm}"
        n_padded = Xs.n_padded
    res, _ = train_prepared_ssp(
        mesh, config, data, X_te, y_te, w0, n_padded=n_padded, meta=meta,
        tag=tag, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every)
    return TrainResult(w=res.w[:d_orig], accs=res.accs)


def train_prepared_ssp(mesh: Mesh, config: SSGDConfig, data, X_te, y_te,
                       w0, *, n_padded: int, meta: dict | None = None,
                       tag: str | None = None,
                       checkpoint_dir: str | None = None,
                       checkpoint_every: int = 500):
    """Stale-synchronous training on prepared data (``data`` = (X, y,
    valid) of :func:`parallelize`, or (X2, None, None) with ``meta`` for
    the packed samplers; ``w0`` the initial weights in that layout): the
    straggle schedule and the membership epochs from the active fault
    plan, segments through :func:`..parallel.membership.run_elastic`
    (checkpointed every ``checkpoint_every // s`` windows; a resume on
    another shard count renegotiates). A replay under the same plan is
    bitwise equal. Returns ``(TrainResult, epochs)`` with w in the
    layout of ``w0``."""
    from tpu_distalg_torch.parallel import comms, membership, partition
    from tpu_distalg_torch.parallel import ssp as pssp

    spec = pssp.SyncSpec.parse(config.sync)
    s = spec.staleness
    T = config.n_iterations
    S = mesh.n_data
    d = int(w0.shape[0])
    if tag is None:
        tag = (f"ssgd:{config.sampler}:" if meta is not None
               else "ssgd:") + f"{spec.spec()}:comm={config.comm}"
    n_win, padded_ticks = pssp.window_grid(T, s)
    extra = pssp.compile_straggle_schedule(padded_ticks, S)
    extra[T:] = 0  # pad ticks do not exist: no interference, no busy
    extra = extra.reshape(n_win, s, S)
    sync = _ssp_comm_sync(mesh, config, d)

    def fresh_state(w_host, clocks, win0: int):
        return ssp_init_state(mesh, config, d, w=w_host, clocks=clocks,
                              win0=win0)

    def renegotiate(saved_leaves, saved_shards, start_win):
        del saved_shards
        return fresh_state(
            saved_leaves[0],
            membership.redistribute_clocks(saved_leaves[1], S), start_win)

    def make_seg_fn(active, n_win_seg):
        return make_ssp_train_fn(mesh, config, n_padded, d, active=active,
                                 n_win_seg=n_win_seg, total_ticks=T,
                                 meta=meta)

    def run_seg(fn, state, win0, n_win_seg, epoch):
        del epoch
        st = partition.place(
            dict(zip(("w", "clocks", "pend", "basegen", "wl", "accd",
                      "res"), state)), "ssgd", mesh)
        out = fn(*data, X_te, y_te, st["w"], st["clocks"], st["pend"],
                 st["basegen"], st["wl"], st["accd"], st["res"],
                 extra[win0:win0 + n_win_seg], win0)
        return out[:7], out[7:]

    state, outs, start, epochs = membership.run_elastic(
        checkpoint_dir, max(1, checkpoint_every // s), n_win, S,
        make_seg_fn=make_seg_fn, run_seg=run_seg,
        state0=fresh_state(w0, np.zeros(S, np.int32), 0),
        renegotiate=renegotiate, tag=tag, ticks_per_window=s)
    w = torch.as_tensor(state[0]).to(mesh.device)
    metrics.guard_finite(w, "SSGD (ssp) weights")
    accs = (window_accs_to_ticks(outs[0], s, T) if outs
            else np.zeros((T,), np.float32))
    stats = pssp.observed_staleness(outs[1] if outs else [],
                                    outs[2] if outs else [])
    pssp.emit_ssp_counters(
        spec, stats, straggle_ticks=int(np.count_nonzero(extra)),
        gated_ticks=int(np.asarray(outs[3]).sum()) if outs else 0,
        epochs=len(epochs))
    comms.emit_sync_counters(sync, n_win - start)
    return TrainResult(w=w, accs=torch.from_numpy(accs)), epochs
