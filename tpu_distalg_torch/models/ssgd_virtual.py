"""SSGD over a virtual dataset: a logical row count unbounded by the
card's memory.

Port of ``tpu_distalg/models/ssgd_virtual.py``. Rows are never stored:
the counter-based generator
(:func:`..utils.datasets.synthetic_two_class_rows`) defines a row by its
global id, so each step regenerates exactly the sampled blocks on the
device. The sampling is ``fused_gather``'s (the same block draw, keyed
on the absolute step, so a run replays and resumes), the gradient the
``bernoulli`` path's (``ops/logistic.grad_sum``; the JAX package runs no
Pallas kernel here, so torch ops are its port), and the update
``models/ssgd._build_scan``'s. A row costs its threefry bits and
transforms instead of a read: compute-bound where ``fused_gather`` is
bound by bytes, but unbounded in ``n_rows``.

Across processes every process draws the blocks of every shard and
regenerates its own shards' rows (``mesh.local_data``); the gradient
psum adds every shard's partials in global shard order, so P processes
× L shards equal one process × P·L bit for bit.

Row ids keep the JAX package's int32 range: it refuses a grid of
padded rows at or past 2³¹ − 1 − 2²⁰, and draws the held-out rows at
ids ``2³¹ − 1 − n_test`` up, although torch could count past them.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_distalg_torch.data import block_geometry
from tpu_distalg_torch.models.ssgd import (
    SSGDConfig,
    TrainResult,
    _build_scan,
    warn_quantized_fraction,
)
from tpu_distalg_torch.ops import logistic, sampling
from tpu_distalg_torch.parallel import Mesh, tree_allreduce_sum
from tpu_distalg_torch.utils import prng

#: ids past this many padded rows are refused (the JAX package's int32
#: row ids, with the held-out anchor's headroom)
MAX_PADDED_ROWS = 2 ** 31 - 1 - 2 ** 20
#: rows regenerated at a time (bounds the threefry temporaries)
_ROWS_PER_DRAW = 1 << 21


@dataclasses.dataclass(frozen=True)
class VirtualData:
    """Geometry of a two-class dataset generated on the fly."""

    n_rows: int                 # logical rows (any size)
    n_features: int = 30        # generated features (bias appended)
    data_seed: int = 0
    separation: float = 2.0

    @property
    def d(self) -> int:
        return self.n_features + 1


def _geometry(config: SSGDConfig, data: VirtualData, n_shards: int):
    """``(rows_per_shard, n_blocks, n_sampled)``: the block grid of
    :func:`..data.block_geometry` over the virtual rows, padded to whole
    blocks a shard (padding rows are masked by ``row_id >= n_rows``)."""
    rows_per_shard, n_blocks, n_sampled = block_geometry(
        data.n_rows, config.gather_block_rows, n_shards,
        config.mini_batch_fraction)
    warn_quantized_fraction(
        "virtual", n_blocks, n_sampled, config.mini_batch_fraction,
        "lower gather_block_rows for a finer grid")
    return rows_per_shard, n_blocks, n_sampled


def _make_rows(data: VirtualData):
    from tpu_distalg_torch.utils import datasets

    make_rows = datasets.synthetic_two_class_rows(
        data.n_features, seed=data.data_seed, separation=data.separation)

    def rows(ids: torch.Tensor):
        """(X with the bias column, y) of the global row ids."""
        parts = [make_rows(ids[lo:lo + _ROWS_PER_DRAW])
                 for lo in range(0, ids.shape[0], _ROWS_PER_DRAW)]
        X = torch.cat([p[0] for p in parts])
        y = torch.cat([p[1] for p in parts])
        return torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                        device=X.device)], dim=1), y

    return rows


def make_train_fn(mesh: Mesh, config: SSGDConfig, data: VirtualData):
    """The virtual trainer, with the other SSGD builders' contract:
    ``train(X, y, valid, X_test, y_test, w0, t0=0, acc0=0.0)`` →
    ``(w, accs)``; X, y and valid are ignored (there is no resident
    dataset), the test matrix comes from :func:`heldout_set`."""
    if config.sampler != "virtual":
        raise ValueError(
            f"make_train_fn(virtual) got sampler={config.sampler!r}")
    n_shards = mesh.n_data
    rows_per_shard, n_blocks, n_sampled = _geometry(config, data, n_shards)
    if n_shards * rows_per_shard >= MAX_PADDED_ROWS:
        raise ValueError(
            f"virtual dataset of {n_shards * rows_per_shard} padded "
            "rows exceeds the int32 row-id space (~2.1B); shard over "
            "more hosts or split the id space into epochs")
    br = config.gather_block_rows
    rows = _make_rows(data)
    key = prng.root_key(config.seed, mesh.device)
    offsets = torch.arange(br, dtype=torch.int64, device=mesh.device)

    def prep_xs(ts):
        # every (step, shard) block draw in one batched call, as
        # fused_gather draws them
        return sampling.sample_block_ids(prng.fold_in(key, ts), n_shards,
                                         n_blocks, n_sampled)

    def sample_and_grad(X, y, valid, w, idx):
        del X, y, valid  # nothing resident
        per = []
        for s in mesh.local_data:
            ids = (s * rows_per_shard + idx[s].to(torch.int64)[:, None] * br
                   + offsets[None, :]).reshape(-1)
            Xb, yb = rows(ids)
            mask = (ids < data.n_rows).to(torch.float32)
            per.append(logistic.grad_sum(Xb, yb, w, mask))
        return tree_allreduce_sum(per, mesh)

    return _build_scan(config, sample_and_grad, prep_xs=prep_xs)


def heldout_set(data: VirtualData, n_test: int = 4096,
                device: str | torch.device = "cpu"):
    """Fresh rows of the same generator at ids ``2³¹ − 1 − n_test`` up,
    past every shard's padded training range: ``(X with bias, y)``."""
    ids = torch.arange(n_test, dtype=torch.int64, device=device) + (
        2 ** 31 - 1 - n_test)
    return _make_rows(data)(ids)


def train(mesh: Mesh, config: SSGDConfig, data: VirtualData,
          n_test: int = 4096) -> TrainResult:
    """End-to-end: build, the reference's init (``2·ranf − 1``), run,
    evaluated on a held-out generated set."""
    fn = make_train_fn(mesh, config, data)
    X_test, y_test = heldout_set(data, n_test, mesh.device)
    w0 = logistic.init_weights(prng.root_key(config.init_seed, mesh.device),
                               data.d)
    w, accs = fn(None, None, None, X_test, y_test, w0)
    return TrainResult(w=w, accs=accs)
