"""The port's k-means ops and kernel B10's plain version
(``tpu_distalg_torch/ops/kmeans.py``, ``ops/kmeans_kernels.py``) against
the JAX package's ``ops/kmeans.py`` and its Pallas kernel in interpret
mode (``ops/pallas_kmeans.py``), on the CPU.

Both packages get the same numpy points, masks and centres; the packed
arrays come from the JAX package's ``pack_points`` and go to both. On
the CPU the port's wrapper runs its plain version. Counts are integers
and must be equal wherever the two sides assign alike; sums are float32
taken in different orders, held to rtol 1e-6 plus 1e-6 of the largest
sum, for sums of N(0, 1) terms that cancel (the ops), or rtol 1e-5 / atol
1e-4 (the kernel, the JAX test's own bound).

One documented difference: the TPU kernel compares distances rounded
to the bf16 grid, the port compares the float32 expansion (the
contract of ``assign_clusters``). On separated data both agree; on
overlapping data the kernel is held to the float32 contract and the JAX
kernel only where the two assignments agree.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_distalg.ops import kmeans as jkops
from tpu_distalg.ops import pallas_kmeans as jpk
from tpu_distalg_torch.ops import kmeans as kops
from tpu_distalg_torch.ops import kmeans_kernels as kk
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

#: the geometries of tests/test_pallas_kmeans.py
GEOMETRIES = [(8192, 16, 8), (777, 11, 5), (5000, 2, 2), (3000, 64, 3)]


def _separated(rng, n, dim, k):
    """Centres 10 apart along a diagonal lattice, N(0, 0.5²) noise: no
    point near a boundary, so float32 and bf16-grid assignments agree."""
    base = 2
    while base ** dim < k:
        base += 1
    digits = [(np.arange(k) // base ** j) % base if base ** j < k
              else np.zeros(k, np.int64) for j in range(dim)]
    centers = (10.0 * np.stack(digits, axis=1)).astype(np.float32)
    pts = centers[rng.integers(0, k, n)] + 0.5 * rng.normal(size=(n, dim))
    return pts.astype(np.float32), centers


def _overlapping(rng, n, dim, k):
    """The JAX test's data: points and centres N(0, 9)."""
    return ((rng.normal(size=(n, dim)) * 3).astype(np.float32),
            (rng.normal(size=(k, dim)) * 3).astype(np.float32))


def _mask(n):
    mask = np.ones(n, np.float32)
    mask[-n // 10:] = 0.0
    return mask


@pytest.mark.parametrize("n,dim,k", GEOMETRIES)
def test_assign_clusters_equals_jax(n, dim, k):
    rng = np.random.default_rng(n)
    pts, centers = _separated(rng, n, dim, k)
    got = kops.assign_clusters(torch.as_tensor(pts), torch.as_tensor(centers))
    want = jkops.assign_clusters(jnp.asarray(pts), jnp.asarray(centers))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_assign_clusters_ties_take_the_first_minimum():
    """Crafted ties, exact in float32: duplicate centres, and a point
    midway between two centres."""
    pts = np.array([[1.0, 1.0], [5.0, 5.0], [3.0, 3.0], [0.0, 4.0]],
                   np.float32)
    centers = np.array([[1.0, 1.0], [1.0, 1.0], [5.0, 5.0], [5.0, 5.0],
                        [4.0, 0.0]], np.float32)
    got = kops.assign_clusters(torch.as_tensor(pts), torch.as_tensor(centers))
    want = jkops.assign_clusters(jnp.asarray(pts), jnp.asarray(centers))
    np.testing.assert_array_equal(got.numpy(), [0, 2, 0, 0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [5, 128, 200])
def test_cluster_stats_equals_jax_in_both_branches(k):
    """k <= 128: the one-hot matmul; above: the scatter-add."""
    rng = np.random.default_rng(k)
    n, dim = 3000, 7
    pts = rng.normal(size=(n, dim)).astype(np.float32)
    assign = rng.integers(0, k, n)
    mask = _mask(n)
    got_s, got_c = kops.cluster_stats(
        torch.as_tensor(pts), torch.as_tensor(mask),
        torch.as_tensor(assign), k)
    want_s, want_c = jkops.cluster_stats(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(assign), k)
    assert got_s.shape == (k, dim) and got_c.shape == (k,)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    want_s = np.asarray(want_s)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want_s).max()))


def test_update_centers_keeps_an_empty_clusters_centre():
    sums = np.array([[0.0, 0.0], [3.0, 6.0], [1.0, 1.0]], np.float32)
    counts = np.array([0.0, 3.0, 1.0], np.float32)
    old = np.array([[5.0, 5.0], [1.0, 1.0], [9.0, 9.0]], np.float32)
    got = kops.update_centers(*(torch.as_tensor(a)
                                for a in (sums, counts, old)))
    want = jkops.update_centers(*(jnp.asarray(a)
                                  for a in (sums, counts, old)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  [[5.0, 5.0], [1.0, 2.0], [1.0, 1.0]])


@pytest.mark.parametrize("n,dim,k", GEOMETRIES)
def test_packed_layout_is_the_jax_layout(n, dim, k):
    """The port's (dpad, pp) are JAX's, and its pack_points equals the
    head of JAX's (which pads on to a block multiple)."""
    assert kk.packed_geometry(dim, k) == jpk.packed_geometry(dim, k)[:2]
    rng = np.random.default_rng(n)
    pts, _ = _overlapping(rng, n, dim, k)
    X2j, m2j = jpk.pack_points(pts, _mask(n), dim=dim, k=k, block_rows=8)
    X2, m2 = kk.pack_points(pts, _mask(n), dim=dim, k=k, device="cpu")
    np.testing.assert_array_equal(X2.numpy(), np.asarray(X2j)[:X2.shape[0]])
    np.testing.assert_array_equal(m2.numpy(), np.asarray(m2j)[:m2.shape[0]])
    assert float(np.asarray(m2j)[m2.shape[0]:].sum()) == 0.0


def _both(pts, mask, centers, dim, k):
    """JAX's packed arrays through JAX's kernel (interpret mode) and
    through the port's wrapper."""
    X2j, m2j = jpk.pack_points(pts, mask, dim=dim, k=k, block_rows=64)
    want = jpk.fused_cluster_stats(X2j, m2j, jnp.asarray(centers), dim=dim,
                                   k=k, block_rows=64, interpret=True)
    got = kk.fused_cluster_stats(
        torch.from_numpy(np.array(X2j)), torch.from_numpy(np.array(m2j)),
        torch.as_tensor(centers), dim=dim, k=k)
    return got, want


@pytest.mark.parametrize("n,dim,k", GEOMETRIES)
def test_fused_cluster_stats_equals_jax_on_separated_data(n, dim, k):
    rng = np.random.default_rng(n + 1)
    pts, centers = _separated(rng, n, dim, k)
    (sums, counts), (j_sums, j_counts) = _both(pts, _mask(n), centers, dim, k)
    assert sums.shape == (k, dim) and counts.shape == (k,)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(j_sums),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,dim,k", GEOMETRIES)
def test_fused_cluster_stats_holds_the_float32_contract(n, dim, k):
    """On overlapping data the port's kernel contract is
    cluster_stats(assign_clusters) in float32; JAX's kernel (bf16-grid
    comparisons) is compared only on the rows both assign alike."""
    rng = np.random.default_rng(n + 2)
    pts, centers = _overlapping(rng, n, dim, k)
    mask = _mask(n)
    (sums, counts), _ = _both(pts, mask, centers, dim, k)
    a32 = kops.assign_clusters(torch.as_tensor(pts),
                               torch.as_tensor(centers))
    r_sums, r_counts = kops.cluster_stats(
        torch.as_tensor(pts), torch.as_tensor(mask), a32, k)
    np.testing.assert_array_equal(counts.numpy(), r_counts.numpy())
    np.testing.assert_allclose(sums.numpy(), r_sums.numpy(), rtol=1e-5,
                               atol=1e-4)
    # the JAX package's own float32 assignment agrees with the port's
    a_jax = np.asarray(jkops.assign_clusters(jnp.asarray(pts),
                                             jnp.asarray(centers)))
    np.testing.assert_array_equal(a32.numpy(), a_jax)
    # the documented difference: the bf16 grid moves a few boundary
    # points (the JAX test allows up to 2%); on the rest both kernels
    # give the same statistics
    p, c = jnp.asarray(pts), jnp.asarray(centers)
    d2 = (jnp.sum(p * p, axis=1, keepdims=True)
          - 2.0 * jnp.einsum("nd,kd->nk", p, c)
          + jnp.sum(c * c, axis=1)[None, :])
    a16 = np.asarray(jnp.argmin(
        d2.astype(jnp.bfloat16).astype(jnp.float32), axis=1))
    same = a16 == a32.numpy()
    assert same.mean() > 0.98, same.mean()
    (s_same, c_same), (j_sums, j_counts) = _both(
        pts, mask * same, centers, dim, k)
    np.testing.assert_array_equal(c_same.numpy(), np.asarray(j_counts))
    np.testing.assert_allclose(s_same.numpy(), np.asarray(j_sums),
                               rtol=1e-5, atol=1e-4)


def test_fused_cluster_stats_duplicate_centres_first_minimum():
    pts = np.array([[1.0, 1.0], [5.0, 5.0]], np.float32)
    centers = np.array([[1.0, 1.0], [1.0, 1.0], [5.0, 5.0]], np.float32)
    (_, counts), (_, j_counts) = _both(pts, np.ones(2, np.float32), centers,
                                       2, 3)
    np.testing.assert_array_equal(counts.numpy(), [1.0, 0.0, 1.0])
    np.testing.assert_array_equal(np.asarray(j_counts), [1.0, 0.0, 1.0])


@pytest.mark.parametrize("dim,k,match", [(129, 2, "dim <= 128"),
                                         (0, 2, "dim <= 128"),
                                         (16, 257, "k <= 256"),
                                         (16, 0, "k <= 256")])
def test_packed_geometry_limits(dim, k, match):
    with pytest.raises(ValueError, match=match):
        kk.packed_geometry(dim, k)


def test_fused_cluster_stats_shape_contract():
    X2 = torch.zeros((4, 128))
    m2 = torch.zeros((4, 8))
    c = torch.zeros((3, 16))
    kk.fused_cluster_stats(X2, m2, c, dim=16, k=3)
    with pytest.raises(ValueError, match="incompatible"):
        kk.fused_cluster_stats(X2, torch.zeros((4, 4)), c, dim=16, k=3)
    with pytest.raises(ValueError, match="incompatible"):
        kk.fused_cluster_stats(X2, m2, torch.zeros((3, 8)), dim=16, k=3)
    with pytest.raises(ValueError, match="float32"):
        kk.fused_cluster_stats(X2.double(), m2, c, dim=16, k=3)


@pytest.mark.parametrize("k,dpad", [(8, 16), (2, 8), (256, 8), (256, 16),
                                    (64, 32), (256, 128), (1, 128),
                                    (128, 64)])
def test_kernel_plan_fits_the_card(k, dpad):
    """The launch geometry the wrapper hands the CUDA kernel: shared
    memory within the 227 KB a block may take, rows per block a
    multiple of what a block's warps load at once, and a function of
    the shapes alone."""
    plan = kk.kernel_plan(k, dpad)
    vectors = dpad // 4
    assert plan.vectors_per_lane in (1, 2, 4)
    assert plan.vectors_per_lane <= vectors
    rows_at_once = 32 // (vectors // plan.vectors_per_lane)
    assert 1 <= plan.warps <= 8
    assert plan.tiles_per_warp in (1, rows_at_once)
    smem = (plan.warps * plan.tiles_per_warp * k * (dpad + 4) * 4
            + (k + 3) // 4 * 16 + (k * dpad * 4 if plan.cen_in_smem else 0))
    assert smem <= kk.SMEM_LIMIT
    assert plan.rows_per_block % (
        plan.warps * rows_at_once
        * (kk.VECTORS_IN_FLIGHT // plan.vectors_per_lane)) == 0
    assert plan.rows_per_block >= 4096
    assert plan == kk.kernel_plan(k, dpad)
    assert plan.n_blocks(plan.rows_per_block + 1) == 2
    if (k, dpad) == (8, 16):        # the main path's shape: 2 lanes a row
        assert plan == kk.KernelPlan(4, 2, 16, 4096, True)
    if (k, dpad) == (256, 16):      # one shared tile a warp, in turns
        assert (plan.vectors_per_lane, plan.tiles_per_warp) == (1, 1)
    if (k, dpad) == (256, 128):     # one tile, centres in device memory
        assert (plan.warps, plan.tiles_per_warp, plan.cen_in_smem) == (
            1, 1, False)
