"""The k-means CUDA kernel (``tpu_distalg_torch/csrc/kmeans.cu``, B10)
against its plain PyTorch version, on the card. Imports neither jax nor
``tpu_distalg``, so it also runs on a machine with only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kmeans_card.py

Without a card the tests skip (a CUDA kernel has no CPU mode); the
plain version is held to the JAX package in
``tests/test_torch_kmeans_kernels.py``.

Two kinds of case. "exact": points and centres with entries in
{-3..3}, so every distance and every sum is an exact float32 integer
whatever its order, ties included (both sides take the first minimum):
sums and counts must be equal bit for bit. "mixture": centres on a
lattice of pitch 10 with N(0, 0.5²) noise around them, so no point lies
within 9 standard deviations of a boundary and both sides assign alike:
counts must be equal and sums agree within rtol 1e-5 (plus 1e-5 of the
largest sum, for entries that cancel), the float32 sums being taken in
another order. A fixed input must replay bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch.models import kmeans
from tpu_distalg_torch.ops import kmeans as kops
from tpu_distalg_torch.ops import kmeans_kernels as kk
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

#: (n, dim, k): every dpad and lane width, the shared-tile plan (k 256 at
#: dim 2), centres outside shared memory (k 256 at dim 128), n a multiple
#: of nothing
SHAPES = [(777, 11, 5), (5003, 2, 2), (8192, 16, 8), (3001, 64, 3),
          (1500, 128, 8), (4099, 2, 256), (2050, 16, 256), (700, 128, 256),
          (40000, 16, 8), (1, 3, 2)]


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def lattice_mixture(rng, n, dim, k):
    """Separated data: centre c sits at 10 × (the digits of c in the
    smallest base that gives k distinct lattice points), points are a
    centre plus N(0, 0.5²) noise."""
    base = 2
    while base ** dim < k:
        base += 1
    digits = [(np.arange(k) // base ** j) % base if base ** j < k
              else np.zeros(k, np.int64) for j in range(dim)]
    centers = (10.0 * np.stack(digits, axis=1)).astype(np.float32)
    pts = centers[rng.integers(0, k, n)] + 0.5 * rng.normal(size=(n, dim))
    return pts.astype(np.float32), centers


def _case(rng, n, dim, k, case):
    if case == "exact":
        pts = rng.integers(-3, 4, size=(n, dim)).astype(np.float32)
        centers = rng.integers(-3, 4, size=(k, dim)).astype(np.float32)
    else:
        pts, centers = lattice_mixture(rng, n, dim, k)
    mask = np.ones(n, np.float32)
    mask[n - n // 10:] = 0.0                       # a masked tail
    mask[rng.integers(0, n, n // 7)] = 0.0         # and scattered rows
    return pts, mask, centers


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["exact", "mixture"])
@pytest.mark.parametrize("n,dim,k", SHAPES)
def test_fused_cluster_stats_b10_on_card(n, dim, k, case, cuda_device):
    rng = np.random.default_rng(n + dim + k)
    pts, mask, centers = _case(rng, n, dim, k, case)
    X2, m2 = kk.pack_points(pts, mask, dim=dim, k=k, device=cuda_device)
    c = torch.as_tensor(centers, device=cuda_device)
    before = kk.fused_cluster_stats.launches
    sums, counts = kk.fused_cluster_stats(X2, m2, c, dim=dim, k=k)
    torch.cuda.synchronize()
    assert kk.fused_cluster_stats.launches == before + 1
    r_sums, r_counts = kk.cluster_stats_reference(X2, m2, c, dim=dim, k=k)
    assert sums.shape == (k, dim) and counts.shape == (k,)
    assert torch.equal(counts, r_counts)
    assert float(counts.sum()) == float(mask.sum())
    if case == "exact":
        assert torch.equal(sums, r_sums)
    else:
        atol = 1e-5 * float(r_sums.abs().max())
        assert torch.allclose(sums, r_sums, rtol=1e-5, atol=atol)
    s2, c2 = kk.fused_cluster_stats(X2, m2, c, dim=dim, k=k)
    assert torch.equal(sums, s2) and torch.equal(counts, c2)


@pytest.mark.gpu
def test_tie_break_first_minimum_and_empty_cluster(cuda_device):
    """Duplicate centres: the first takes the point (the reference
    scans with a strict <); a centre no point is nearest to gets a zero
    sum and a zero count."""
    pts = np.array([[1.0, 1.0], [5.0, 5.0]], np.float32)
    centers = np.array([[1.0, 1.0], [1.0, 1.0], [5.0, 5.0], [90.0, 90.0]],
                       np.float32)
    X2, m2 = kk.pack_points(pts, np.ones(2, np.float32), dim=2, k=4,
                            device=cuda_device)
    sums, counts = kk.fused_cluster_stats(
        X2, m2, torch.as_tensor(centers, device=cuda_device), dim=2, k=4)
    assert counts.tolist() == [1.0, 0.0, 1.0, 0.0]
    assert sums.tolist() == [[1.0, 1.0], [0.0, 0.0], [5.0, 5.0], [0.0, 0.0]]


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [1, 4])
def test_fused_fit_on_card_matches_torch_op_fit(n_shards, cuda_device):
    """Lloyd through B10 equals Lloyd through torch ops on separated
    data (centres within 1e-4: the sums differ only in their order),
    takes one launch per shard and iteration, and replays bit for bit."""
    rng = np.random.default_rng(5)
    pts, _ = lattice_mixture(rng, 20001, 8, 4)
    mesh = get_mesh(data=n_shards, device=cuda_device)
    cfg = kmeans.KMeansConfig(k=4, n_iterations=6, seed=3)
    c0 = kmeans.init_centers(pts, 4, cfg.seed)
    from tpu_distalg_torch.parallel import parallelize

    ps = parallelize(pts, mesh)
    want, a_want, _ = kmeans.make_fit_fn(mesh, cfg)(ps.data, ps.mask, c0)
    X2, m2 = kmeans.pack_device(mesh, ps.data, ps.mask, dim=8, k=4)
    fit = kmeans.make_fit_fn_fused(mesh, cfg, 8)
    before = kk.fused_cluster_stats.launches
    got, assign, n_run = fit(X2, m2, c0)
    assert kk.fused_cluster_stats.launches == before + 6 * n_shards
    assert n_run == 6
    assert torch.allclose(got, want, rtol=0, atol=1e-4)
    keep = m2.reshape(-1) > 0
    assert torch.equal(assign[keep], a_want[ps.mask > 0])
    again, _, _ = fit(X2, m2, c0)
    assert torch.equal(got, again)
    assert torch.equal(kops.assign_clusters(ps.data, got), a_want)


@pytest.mark.gpu
def test_cuda_tensors_never_take_the_plain_version(cuda_device):
    """What the kernel does not take raises on the card, where the
    plain version would have computed it."""
    c = torch.zeros((2, 16), device=cuda_device)
    X2 = torch.zeros((0, 128), device=cuda_device)
    m2 = torch.zeros((0, 8), device=cuda_device)
    with pytest.raises(ValueError, match="1 <= n"):
        kk.fused_cluster_stats(X2, m2, c, dim=16, k=2)
    with pytest.raises(ValueError, match="operands on"):
        kk.fused_cluster_stats(torch.zeros((4, 128), device=cuda_device),
                               torch.zeros((4, 8), device=cuda_device),
                               c.cpu(), dim=16, k=2)
