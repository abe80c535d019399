"""Streamed host → device SSGD: datasets of arbitrary bytes bigger than
the card's memory.

Port of ``tpu_distalg/models/ssgd_stream.py``. The rows sit packed in
the ``fused_gather`` layout in host memory or on disk (a memmap, such
as ``utils/datasets.streamed_packed_cache``'s), behind a
:class:`~tpu_distalg_torch.data.ShardedDataset`. Each step draws the
same blocks ``fused_gather`` draws (threefry keyed on the absolute step,
:func:`make_host_sampler`, hashed on the mesh's device for a run's
steps at once and copied to the host), the data subsystem's
pipeline gathers them into a pinned buffer on its producer thread and
copies them to the card on a side stream (gather(t+2) ∥ H2D(t+1) ∥
compute(t)), and kernel B1 runs on each shard's staged rows with the
identity block index. The gradient and the update are the resident
``fused_gather`` path's own code (``models/ssgd.gathered_per_shard``
and ``_build_scan``), and B1's launch plan depends only on the sampled
row count, the row width, the dtype and the card, so the weights equal
a resident ``fused_gather`` run on the same bytes bit for bit, on the
CPU and on the card.

Checkpoint/resume: sampling is keyed on absolute steps, so a segmented
run (``run_segmented``, tag ``ssgd_stream``) equals a straight one.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.data import ShardedDataset, make_host_block_sampler
from tpu_distalg_torch.data.sharded import host_bits
from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.models.ssgd import SSGDConfig, TrainResult
from tpu_distalg_torch.ops import logistic, ssgd_kernels
from tpu_distalg_torch.parallel import Mesh, tree_allreduce_sum
from tpu_distalg_torch.utils import metrics, prng


def pack_host(X, y, mesh: Mesh, config: SSGDConfig):
    """Pack (X, y) into the fused layout as a host numpy array (float32,
    or bfloat16 as its uint16 bits), never on the device; the layout and
    shuffle of :func:`ssgd.prepare_fused`, so a resident copy trains the
    same under ``fused_gather``. Returns ``(X2_host, meta)``."""
    n = np.asarray(y).shape[0]
    X2, meta = ssgd_kernels.pack_augmented(
        np.asarray(X), np.asarray(y), np.ones(n, np.float32),
        dtype=config.x_dtype, pack=config.fused_pack,
        block_rows=config.gather_block_rows * mesh.n_data,
        shuffle_seed=config.shuffle_seed, device="cpu")
    return host_bits(X2), meta


def make_host_sampler(seed: int, n_shards: int, n_blocks: int,
                      n_sampled: int, device="cpu"):
    """The ``fused_gather`` block draw for the host's gathers, the data
    subsystem's :func:`~tpu_distalg_torch.data.make_host_block_sampler`
    (hashed on ``device``)."""
    return make_host_block_sampler(seed, n_shards, n_blocks, n_sampled,
                                   device)


def host_block_ids(config: SSGDConfig, n_shards: int, n_blocks: int,
                   n_sampled: int, ts) -> np.ndarray:
    """One-shot :func:`make_host_sampler` draw for the steps ``ts``."""
    return make_host_sampler(config.seed, n_shards, n_blocks, n_sampled)(ts)


def _stream_grads(mesh: Mesh, config: SSGDConfig, meta: dict,
                  n_sampled: int):
    """``grads(staged, w)`` → the global (Σ grad, count) of one staged
    batch (S, n_sampled·bp, pack·d_total): B1 on each shard's rows with
    the identity block index, summed in shard order."""
    col_keep = (torch.arange(meta["d_total"], device=mesh.device)
                < meta["y_col"]).to(torch.float32)
    per_shard = ssgd.gathered_per_shard(config, meta, col_keep)
    ident = torch.arange(n_sampled, dtype=torch.int32,
                         device=mesh.device).expand(mesh.n_data, n_sampled)

    def grads(staged, w):
        return tree_allreduce_sum(per_shard(staged, w, ident))

    return grads


def make_step_fn(mesh: Mesh, config: SSGDConfig, meta: dict,
                 n_sampled: int):
    """``step(staged, w) -> w`` over one staged batch: B1 on the staged
    rows, then the resident path's update (``ssgd._build_scan``)."""
    grads = _stream_grads(mesh, config, meta, n_sampled)
    one = ssgd._build_scan(
        dataclasses.replace(config, n_iterations=1, eval_test=False),
        lambda X, y, valid, w, _: grads(X, w))

    def step(staged, w):
        return one(staged, None, None, None, None, w)[0]

    return step


class _InOrder:
    """Step i's payload: the i-th staged batch of a stream, asked for in
    order."""

    def __init__(self, batches):
        self._it, self._i = iter(batches), 0

    def __getitem__(self, i: int):
        if i != self._i:
            raise IndexError(f"stream batch {i} asked for after "
                             f"{self._i - 1}: batches come in order")
        self._i += 1
        return next(self._it)


class StreamTrainer:
    """The streamed training loop over a packed host (or memmap) matrix:
    build once, then :meth:`run` segments. ``dataset`` is its
    :class:`~tpu_distalg_torch.data.ShardedDataset` (storage, gather,
    H2D and the pipeline); what is here is SSGD's step and
    evaluation."""

    def __init__(self, X2_host, meta: dict, mesh: Mesh,
                 config: SSGDConfig, X_test=None, y_test=None):
        n_shards = mesh.n_data
        n2 = X2_host.shape[0]
        if n2 % n_shards:
            raise ValueError(
                f"packed rows {n2} not divisible by {n_shards} shards "
                "— pack with block_rows=gather_block_rows*n_shards "
                "(pack_host does)")
        self.meta, self.mesh, self.config = meta, mesh, config
        self.bp = config.gather_block_rows // meta["pack"]
        self.n_shards = n_shards
        if isinstance(X2_host, np.ndarray):
            self.dataset = ShardedDataset(X2_host, mesh, block_rows=self.bp,
                                          meta=meta)
        else:
            self.dataset = ShardedDataset.from_array(
                X2_host, mesh, block_rows=self.bp, meta=meta)
        n_blocks, n_sampled = ssgd.fused_gather_geometry(config, meta,
                                                         n_shards)
        if n_blocks != self.dataset.n_blocks:
            raise ValueError(
                f"meta n_padded={meta['n_padded']} disagrees with the "
                f"host matrix ({n2} packed rows)")
        self.n_blocks, self.n_sampled = n_blocks, n_sampled
        self._draw = make_host_sampler(config.seed, n_shards, n_blocks,
                                       n_sampled, mesh.device)
        self._grads = _stream_grads(mesh, config, meta, n_sampled)
        self._eval = (None, None)
        if config.eval_test:
            if X_test is None:
                raise ValueError("eval_test=True needs X_test/y_test")
            Xt = np.asarray(X_test, np.float32)
            Xt = np.pad(Xt, ((0, 0), (0, meta["d_total"] - Xt.shape[1])))
            self._eval = (torch.from_numpy(Xt).to(mesh.device),
                          torch.as_tensor(np.asarray(y_test, np.float32)
                                          ).to(mesh.device))
        self.h2d_bytes_per_step = self.dataset.h2d_bytes_per_step(n_sampled)

    def block_ids(self, t0: int, n_steps: int) -> np.ndarray:
        """The local block ids of steps ``[t0, t0 + n_steps)``."""
        return self._draw(np.arange(t0, t0 + n_steps))

    def run(self, w, t0: int, n_steps: int, acc0=0.0):
        """``n_steps`` streamed steps from absolute step ``t0``:
        ``(w, accs)`` with the resident path's ``eval_every`` semantics
        (``acc0`` carries the last accuracy across segments). The
        batches come from the prefetch pipeline in the serial path's
        order; on any exit its producer is stopped and joined."""
        from tpu_distalg_torch.telemetry import events as tevents

        ids = self.block_ids(t0, n_steps)
        cfg = dataclasses.replace(self.config, n_iterations=n_steps)

        def sample_and_grad(X, y, valid, w, staged):
            tevents.mark("ssgd_stream:step", emit_event=False)
            return self._grads(staged, w)

        with contextlib.closing(self.dataset.stream(ids)) as batches:
            fn = ssgd._build_scan(cfg, sample_and_grad,
                                  prep_xs=lambda ts: _InOrder(batches))
            return fn(None, None, None, *self._eval, w, t0=t0, acc0=acc0)


def train(X2_host, meta: dict, mesh: Mesh, config: SSGDConfig,
          X_test=None, y_test=None, w0=None, *,
          checkpoint_dir: str | None = None,
          checkpoint_every: int = 500) -> TrainResult:
    """End-to-end streamed run, straight or in checkpointed segments
    (bitwise equal: sampling is keyed on absolute steps). ``w0``
    defaults to the resident path's augmented initial weights; the
    result's w is cut to the packed feature width."""
    from tpu_distalg_torch.telemetry import events as tevents

    tevents.mark("ssgd_stream:train", emit_event=False)
    trainer = StreamTrainer(X2_host, meta, mesh, config, X_test, y_test)
    d = meta["y_col"]  # the feature width inside the packed row
    if w0 is None:
        d0 = X_test.shape[1] if X_test is not None else d
        w0 = torch.zeros((meta["d_total"],), dtype=torch.float32,
                         device=mesh.device)
        w0[:d0] = logistic.init_weights(
            prng.root_key(config.init_seed, mesh.device), d0)
    if checkpoint_dir is None:
        w, accs = trainer.run(w0, 0, config.n_iterations)
        metrics.guard_finite(w, "streamed SSGD weights")
        return TrainResult(w=w[:d], accs=accs)

    from tpu_distalg_torch.utils import checkpoint as ckpt

    def run_seg(seg_len, state, t0):
        w, acc = state
        w, accs = trainer.run(w, t0, seg_len, acc0=acc)
        return (w, accs[-1] if len(accs) else acc), accs

    (w, _), accs, _ = ckpt.run_segmented(
        checkpoint_dir, checkpoint_every, config.n_iterations,
        make_seg_fn=lambda seg: seg,  # a segment is its length
        run_seg=run_seg,
        state0=(w0, torch.zeros((), dtype=torch.float32,
                                device=mesh.device)),
        tag="ssgd_stream")
    return TrainResult(w=w[:d], accs=torch.from_numpy(accs))
