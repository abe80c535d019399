"""The port's k-means slice (``tpu_distalg_torch/models/kmeans.py``, its
datasets, ``build_sharded``, the converter and the CLI subcommand)
against the JAX package's ``models/kmeans.py`` on the CPU.

Both packages get the same numpy points and the same initial centres
(``init_centers`` draws from the same numpy stream). They add in
different orders (XLA's one-hot matmul and psum against torch's), so
centres are held to 1e-5 after a few Lloyd iterations on separated
data, where no assignment can flip. The fused fit is held to the JAX
package's fused fit within 0.05, the JAX test's own bound: the TPU
kernel assigns on the bf16 grid, the port in float32. The port's
``gaussian_mixture_rows`` draws its own values (same contract, other
bits), so it is tested for its contract, not against JAX's numbers.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_distalg.models import kmeans as jkmeans
from tpu_distalg.parallel import parallelize as jparallelize
from tpu_distalg.utils import datasets as jdatasets
from tpu_distalg_torch import convert
from tpu_distalg_torch.models import kmeans
from tpu_distalg_torch.ops import kmeans as kops
from tpu_distalg_torch.parallel import build_sharded, get_mesh, parallelize
from tpu_distalg_torch.utils import checkpoint, datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(n_shards=1):
    return get_mesh(data=n_shards, device="cpu")


def _blobs(seed, n, dim, k):
    """The JAX fused-fit test's data: k blobs 8 apart on the diagonal."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(size=(n // k, dim)).astype(np.float32) + 8.0 * c
        for c in range(k)])


def _sorted(centers):
    c = np.asarray(centers)
    return c[np.lexsort(c.T[::-1])]


def test_datasets_equal_jax():
    np.testing.assert_array_equal(datasets.toy_kmeans_matrix(),
                                  jdatasets.toy_kmeans_matrix())
    got = datasets.gaussian_mixture(4096, k=4, seed=3)
    want = jdatasets.gaussian_mixture(4096, k=4, seed=3)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,seed", [(2, 42), (5, 0), (8, 7)])
def test_init_centers_equals_jax(k, seed):
    pts = datasets.gaussian_mixture(500, k=4, dim=3, seed=1)
    np.testing.assert_array_equal(kmeans.init_centers(pts, k, seed),
                                  jkmeans.init_centers(pts, k, seed))


def test_toy_matrix_equals_jax(mesh8):
    """The reference's 6x2 matrix: cluster means (1, 2) and (10, 2)."""
    pts = datasets.toy_kmeans_matrix()
    want = jkmeans.fit(pts, mesh8)
    got = kmeans.fit(pts, _mesh())
    np.testing.assert_allclose(got.centers.numpy(),
                               np.asarray(want.centers), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_sorted(got.centers),
                               [[1.0, 2.0], [10.0, 2.0]], atol=1e-5)
    assert got.n_iterations_run == want.n_iterations_run == 5
    np.testing.assert_array_equal(got.assignments.numpy()[:6],
                                  np.asarray(want.assignments)[:6])


@pytest.mark.parametrize("n_shards", [1, 4])
def test_fixed_mode_equals_jax(mesh8, n_shards):
    pts = _blobs(1, 4096, 8, 4)
    cfg = dict(k=4, n_iterations=6, seed=3)
    c0 = kmeans.init_centers(pts, 4, 3)
    ps_j = jparallelize(pts, mesh8)
    want, a_want, n_want = jkmeans.make_fit_fn(
        mesh8, jkmeans.KMeansConfig(**cfg))(ps_j.data, ps_j.mask, c0)
    mesh = _mesh(n_shards)
    ps = parallelize(pts, mesh)
    got, assign, n_run = kmeans.make_fit_fn(
        mesh, kmeans.KMeansConfig(**cfg))(ps.data, ps.mask, c0)
    assert n_run == int(n_want) == 6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(a_want))


@pytest.mark.parametrize("n_shards", [1, 4])
def test_fused_fit_equals_jax_fused_fit(mesh8, n_shards):
    """B10's plain version through make_fit_fn_fused against JAX's
    Pallas kernel in interpret mode through its make_fit_fn_fused."""
    pts = _blobs(1, 4096, 8, 4)
    cfg = dict(k=4, n_iterations=6, seed=3)
    c0 = kmeans.init_centers(pts, 4, 3)
    ps_j = jparallelize(pts, mesh8)
    X2j, m2j = jkmeans.pack_device(mesh8, ps_j.data, ps_j.mask, dim=8, k=4,
                                   block_rows=64)
    want, _, n_want = jkmeans.make_fit_fn_fused(
        mesh8, jkmeans.KMeansConfig(**cfg), 8, block_rows=64)(X2j, m2j, c0)
    mesh = _mesh(n_shards)
    ps = parallelize(pts, mesh)
    X2, m2 = kmeans.pack_device(mesh, ps.data, ps.mask, dim=8, k=4)
    got, assign, n_run = kmeans.make_fit_fn_fused(
        mesh, kmeans.KMeansConfig(**cfg), 8)(X2, m2, c0)
    assert n_run == int(n_want) == 6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=0.05)
    # and within the port the fused fit is the torch-op fit; the plain
    # version adds a cluster's 1024 rows one after another where the
    # matmul adds them blocked (measured 1.2e-6 relative on coordinates
    # near 20), hence rtol 5e-6 beside the atol
    plain, a_plain, _ = kmeans.make_fit_fn(
        mesh, kmeans.KMeansConfig(**cfg))(ps.data, ps.mask, c0)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=5e-6,
                               atol=1e-5)
    keep = m2.reshape(-1) > 0
    np.testing.assert_array_equal(assign[keep].numpy(),
                                  a_plain[ps.mask > 0].numpy())


def test_pack_device_pads_each_shard():
    """Ragged shards and a dim below dpad: every shard packs its own
    slice, padding rows carry mask 0; nothing to pad gives a view."""
    mesh = _mesh(4)
    pts = np.arange(4 * 37 * 3, dtype=np.float32).reshape(4 * 37, 3)
    ps = parallelize(pts, mesh)
    X2, m2 = kmeans.pack_device(mesh, ps.data, ps.mask, dim=3, k=2)
    assert X2.shape == (4 * 3, 128) and m2.shape == (4 * 3, 16)
    rows = X2.reshape(4, 48, 8)
    np.testing.assert_array_equal(rows[:, :37, :3].reshape(-1, 3).numpy(),
                                  pts)
    assert float(rows[:, 37:].abs().max()) == 0.0
    assert float(rows[:, :, 3:].abs().max()) == 0.0
    np.testing.assert_array_equal(
        m2.reshape(4, 48).numpy(),
        np.tile(np.r_[np.ones(37), np.zeros(11)], (4, 1)))
    flat = torch.zeros((64, 16))
    X2v, _ = kmeans.pack_device(_mesh(), flat, torch.ones(64), dim=16, k=8)
    assert X2v.data_ptr() == flat.data_ptr()


def test_converge_mode_stops_where_jax_stops(mesh8):
    pts = datasets.gaussian_mixture(4096, k=4, seed=3)
    cfg = dict(k=4, converge_dist=1e-3, seed=0)
    want = jkmeans.fit(pts, mesh8, jkmeans.KMeansConfig(**cfg))
    got = kmeans.fit(pts, _mesh(), kmeans.KMeansConfig(**cfg))
    assert 0 < got.n_iterations_run < 1000
    assert got.n_iterations_run == want.n_iterations_run
    np.testing.assert_allclose(got.centers.numpy(),
                               np.asarray(want.centers), rtol=0, atol=1e-4)


def test_shard_count_does_not_change_the_fit():
    pts = _blobs(2, 4000, 4, 4)
    cfg = kmeans.KMeansConfig(k=4, n_iterations=5, seed=1)
    one = kmeans.fit(pts, _mesh(1), cfg)
    four = kmeans.fit(pts, _mesh(4), cfg)
    np.testing.assert_allclose(four.centers.numpy(), one.centers.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(four.assignments.numpy()[:4000],
                                  one.assignments.numpy()[:4000])


@pytest.mark.parametrize("converge", [False, True],
                         ids=["fixed", "converge"])
def test_segmented_run_equals_straight_run(tmp_path, converge):
    pts = datasets.gaussian_mixture(3000, k=4, seed=3)
    cfg = kmeans.KMeansConfig(k=4, n_iterations=7, seed=0,
                              converge_dist=1e-3 if converge else None)
    straight = kmeans.fit(pts, _mesh(), cfg)
    seg = kmeans.fit(pts, _mesh(), cfg, checkpoint_dir=str(tmp_path),
                     checkpoint_every=3)
    np.testing.assert_array_equal(seg.centers.numpy(),
                                  straight.centers.numpy())
    np.testing.assert_array_equal(seg.assignments.numpy(),
                                  straight.assignments.numpy())
    assert seg.n_iterations_run == straight.n_iterations_run
    payload, step = checkpoint.restore(str(tmp_path))
    assert payload["tag"] == ("kmeans_converge" if converge
                              else "kmeans_fixed")
    np.testing.assert_array_equal(payload["state"][0],
                                  straight.centers.numpy())
    # a second call resumes at the end (converge mode: stop_when holds)
    again = kmeans.fit(pts, _mesh(), cfg, checkpoint_dir=str(tmp_path),
                       checkpoint_every=3)
    np.testing.assert_array_equal(again.centers.numpy(),
                                  straight.centers.numpy())
    assert again.n_iterations_run == straight.n_iterations_run
    assert checkpoint.latest_step(str(tmp_path)) == step
    with pytest.raises(ValueError, match="incompatible"):
        kmeans.fit(pts, _mesh(), kmeans.KMeansConfig(
            k=4, n_iterations=50, seed=0,
            converge_dist=None if converge else 1e-3),
            checkpoint_dir=str(tmp_path), checkpoint_every=3)


def test_gaussian_mixture_rows_contract():
    """A row depends on (seed, row id) alone; rows are a true mean plus
    unit noise; the means are N(0, spread²)."""
    make_rows, true_centers = datasets.gaussian_mixture_rows(
        k=4, dim=6, seed=3, spread=8.0)
    ids = torch.arange(20000)
    rows = make_rows(ids)
    assert rows.shape == (20000, 6) and rows.dtype == torch.float32
    perm = torch.randperm(20000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(make_rows(ids[perm]), rows[perm])
    assert torch.equal(make_rows(ids[5000:5100]), rows[5000:5100])
    other, _ = datasets.gaussian_mixture_rows(k=4, dim=6, seed=4)
    assert not torch.equal(other(ids[:100]), rows[:100])
    centers = true_centers()
    assert centers.shape == (4, 6)
    assign = kops.assign_clusters(rows, centers)
    noise = rows - centers[assign]
    # 120,000 unit normals: mean within 4σ/√n, variance within 2%
    assert abs(float(noise.mean())) < 4.0 / np.sqrt(120000)
    assert abs(float(noise.var()) - 1.0) < 0.02
    share = torch.bincount(assign, minlength=4).double() / 20000
    assert float((share - 0.25).abs().max()) < 4 * np.sqrt(0.1875 / 20000)
    wide = datasets.gaussian_mixture_rows(k=256, dim=16, seed=0,
                                          spread=8.0)[1]()
    assert abs(float(wide.std()) - 8.0) < 0.5


@pytest.mark.parametrize("n_shards", [1, 4])
def test_build_sharded_pads_and_masks(n_shards):
    make_rows, _ = datasets.gaussian_mixture_rows(k=2, dim=3, seed=1)
    mesh = _mesh(n_shards)
    ps = build_sharded(mesh, 1001, make_rows, row_multiple=8)
    mult = 8 * n_shards
    assert ps.n_padded == -(-1001 // mult) * mult and ps.n_valid == 1001
    assert ps.n_shards == n_shards
    np.testing.assert_array_equal(
        ps.mask.numpy(), (np.arange(ps.n_padded) < 1001).astype(np.float32))
    # the data does not depend on the shard count
    assert torch.equal(ps.data, make_rows(torch.arange(ps.n_padded)))
    pair = build_sharded(mesh, 10, lambda ids: (ids.float(), ids * 2))
    assert isinstance(pair.data, tuple)
    np.testing.assert_array_equal(pair.data[1].numpy()[:10],
                                  2 * np.arange(10))


def test_init_centers_from_rows_are_dataset_rows():
    """The regenerated centres ARE rows of the dataset, at the ids the
    JAX package would draw."""
    make_rows, _ = datasets.gaussian_mixture_rows(k=2, dim=3, seed=1)
    c0 = kmeans.init_centers_from_rows(make_rows, 1000, 5, seed=7)
    assert c0.shape == (5, 3)
    all_rows = make_rows(torch.arange(1000))
    rng = np.random.default_rng(7)
    ids = []
    while len(ids) < 5:
        ids += [i for i in rng.integers(0, 1000, size=5).tolist()
                if i not in ids]
    assert torch.equal(c0, all_rows[torch.as_tensor(ids[:5])])
    with pytest.raises(ValueError, match="distinct rows"):
        kmeans.init_centers_from_rows(make_rows, 3, 5, seed=7)
    with pytest.raises(ValueError, match="unknown init"):
        kmeans.init_centers_scaled(make_rows, 1000,
                                   kmeans.KMeansConfig(init="nope"))


def _recovered(centers, want):
    d = np.linalg.norm(np.asarray(centers)[:, None, :]
                       - np.asarray(want)[None, :, :], axis=-1)
    return sorted(d.argmin(axis=1).tolist()), float(d.min(axis=1).max())


@pytest.mark.parametrize("n_shards", [1, 4])
def test_fit_scaled_farthest_init_recovers_k8(n_shards, tmp_path):
    """The JAX package's scale-path test (tests/test_workloads.py): all
    8 mixture means found within 0.15 from a farthest-point init."""
    make_rows, true_centers = datasets.gaussian_mixture_rows(
        k=8, dim=8, seed=5, spread=8.0)
    cfg = kmeans.KMeansConfig(k=8, n_iterations=10, seed=0, init="farthest")
    res = kmeans.fit_scaled(_mesh(n_shards), 100_000, make_rows, cfg)
    found, worst = _recovered(res.centers, true_centers())
    assert found == list(range(8)) and worst < 0.15, (found, worst)
    assert res.assignments.shape == (100_000,)
    if n_shards == 1:
        seg = kmeans.fit_scaled(_mesh(), 100_000, make_rows, cfg,
                                checkpoint_dir=str(tmp_path),
                                checkpoint_every=4)
        assert torch.equal(seg.centers, res.centers)


def test_minibatch_entry_points_name_their_roadmap_item():
    """The minibatch entry points (A10's rows, ported) run over a
    ShardedDataset: the init, a step, a fit (against the JAX package and
    across backends in ``tests/test_torch_data.py``)."""
    from tpu_distalg_torch.data import builders

    cfg = kmeans.KMeansConfig(k=2)
    ds, _ = builders.gaussian_points_dataset(_mesh(), 512, dim=3, k=2,
                                             block_rows=64, backend="virtual")
    c0 = kmeans.init_centers_from_dataset(ds, 2, 0)
    assert c0.shape == (2, 3)
    step = kmeans.make_minibatch_step_fn(_mesh(), 2, 3)
    centers, seen = step(ds.stage(np.zeros((1, 2), np.int64)), c0,
                         torch.zeros(2))
    assert float(seen.sum()) == 128
    res = kmeans.fit_minibatch(ds, cfg, n_steps=3, centers0=c0)
    assert res.centers.shape == (2, 3) and res.n_iterations_run == 3


def test_kmeans_params_from_jax(mesh8):
    """JAX-trained centres cross as numpy and continue in the port."""
    pts = _blobs(3, 2048, 4, 4)
    want = jkmeans.fit(pts, mesh8, jkmeans.KMeansConfig(k=4, seed=1))
    c = convert.kmeans_params_from_jax(np.asarray(want.centers),
                                       device="cpu")
    assert c.dtype == torch.float32 and c.is_contiguous()
    np.testing.assert_array_equal(c.numpy(), np.asarray(want.centers))
    np.testing.assert_array_equal(
        kops.assign_clusters(torch.as_tensor(pts), c).numpy(),
        np.asarray(want.assignments)[:2048])
    with pytest.raises(ValueError, match="want"):
        convert.kmeans_params_from_jax(np.zeros(3), device="cpu")


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
         "kmeans", *args], capture_output=True, text=True, timeout=300,
        env=env, cwd=REPO)


def test_cli_kmeans_lines(tmp_path):
    """The JAX CLI's output lines on the toy matrix and on the scale
    path; the knobs that wait for other slices exit naming them."""
    out = _cli()
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "Final centers: [[1.0, 2.0], [10.0, 2.0]]"
    assert lines[1] == "iterations run: 5"
    out = _cli("--scale-points", "20000", "--dim", "4", "--k", "3",
               "--n-iterations", "4", "--n-slices", "2",
               "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "iterations run: 4"
    assert checkpoint.latest_step(str(tmp_path)) == 4
    out = _cli("--minibatch-steps", "3", "--n-points", "5000",
               "--block-rows", "256")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == (
        "minibatch steps run: 3 (backend=resident)")
    for args, item in ((("--data-backend", "streamed"),
                        "needs --stream-cache"),
                       (("--max-restarts", "1"), "A12")):
        out = _cli(*args)
        assert out.returncode != 0 and item in out.stderr
