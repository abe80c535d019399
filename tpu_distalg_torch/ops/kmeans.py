"""Lloyd's-algorithm ops: the plain PyTorch math of k-means.

Port of ``tpu_distalg/ops/kmeans.py``: the batched squared-distance
argmin that replaces the reference's per-point ``closest_center`` loop,
the keyed reduction ``(Σ points, count)`` per cluster that replaces its
``reduceByKey``, and the centre update. In JAX these are XLA code, not
Pallas kernels, so plain torch ops are their port; float32 products run
in full float32 (:mod:`tpu_distalg_torch.utils.device`).
"""

from __future__ import annotations

import torch


def assign_clusters(points: torch.Tensor, centers: torch.Tensor
                    ) -> torch.Tensor:
    """Index of the nearest centre per point: the argmin over the
    expansion ``|p|² − 2p·cᵀ + |c|²``, the first minimum on ties (the
    reference scans with a strict ``<``). int64, shape (n,)."""
    d2 = (torch.sum(points * points, dim=1, keepdim=True)
          - 2.0 * points @ centers.T
          + torch.sum(centers * centers, dim=1)[None, :])
    return torch.argmin(d2, dim=1)


def cluster_stats(points: torch.Tensor, mask: torch.Tensor,
                  assign: torch.Tensor, k: int):
    """``(Σ points (k, dim), count (k,))`` per cluster over the rows
    whose mask is 1. For ``k <= 128`` a masked one-hot matmul,
    ``(onehot ⊙ mask)ᵀ · points``, as in the JAX package; above it an
    ``index_add_`` (on the card that adds with float atomics, in no
    fixed order). Counts are float32 sums of the mask."""
    if k <= 128:
        om = (assign[:, None] == torch.arange(k, device=points.device)
              [None, :]).to(points.dtype) * mask[:, None]
        return om.T @ points, om.to(torch.float32).sum(dim=0)
    sums = torch.zeros((k, points.shape[1]), dtype=points.dtype,
                       device=points.device).index_add_(
        0, assign, points * mask[:, None])
    counts = torch.zeros((k,), dtype=mask.dtype,
                         device=points.device).index_add_(0, assign, mask)
    return sums, counts


def update_centers(sums: torch.Tensor, counts: torch.Tensor,
                   old_centers: torch.Tensor) -> torch.Tensor:
    """Mean per cluster; a cluster without points keeps its old centre
    (the reference overwrites only the ids it collected)."""
    means = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, means, old_centers)
