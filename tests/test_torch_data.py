"""The port's out-of-core data subsystem (``tpu_distalg_torch/data/``)
against the JAX package's (``tpu_distalg/data/``) on the CPU, and its
own contracts.

Standards. Cache bytes and headers, builder bytes and host block draws
equal the JAX package's exactly (numpy and exact int64 threefry on both
sides); each package opens the other's caches. Within the port, staged
batches are bitwise equal across the three backends, a stream yields the
serial path's batches in order, and minibatch k-means and streamed ALS
are bitwise equal across backends. Against JAX's live runs: k-means
centres within rtol 5e-6 + atol 1e-5; streamed ALS at lam 0.01 within
4e-6 in rmse and 3e-5 of the largest |U|, |V| (the port's Gram and solve
run in float64, JAX's in float32: ROADMAP C's standards).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_distalg import data as jdata
from tpu_distalg.data import builders as jbuilders
from tpu_distalg.data import cache as jcache
from tpu_distalg.models import als as jals
from tpu_distalg.models import kmeans as jkmeans
from tpu_distalg.utils import datasets as jdatasets
from tpu_distalg_torch import cli, faults
from tpu_distalg_torch.data import (
    Prefetcher,
    ProducerDiedError,
    ShardedDataset,
    block_geometry,
    builders,
    make_host_block_sampler,
)
from tpu_distalg_torch.data import cache as dcache
from tpu_distalg_torch.data.sharded import host_bits
from tpu_distalg_torch.models import als, kmeans
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.telemetry import events as tevents
from tpu_distalg_torch.utils import datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    """Fault plans and telemetry are process-global."""
    yield
    faults.configure(False)
    tevents.configure(False)


def _mesh(n=4):
    return get_mesh(data=n, device="cpu")


# ---------------------------------------------------------------- cache


def _tiny_header(n=32, pd=4):
    return dcache.make_header(layout="rows_test", dtype=np.float32,
                              shape=(n, pd), geom={"n": n, "pd": pd,
                                                   "seed": 3})


def _write_rows(mm):
    mm[:] = np.arange(mm.size, dtype=np.float32).reshape(mm.shape)


def test_cache_header_roundtrip(tmp_path):
    path = str(tmp_path / "c")
    mm, hdr = dcache.build_cache(path, header=_tiny_header(),
                                 write_bin=_write_rows)
    assert hdr == _tiny_header() == jcache.make_header(
        layout="rows_test", dtype=np.float32, shape=(32, 4),
        geom={"n": 32, "pd": 4, "seed": 3})
    mm2, hdr2 = dcache.open_cache(path, layout="rows_test",
                                  expect_geom=_tiny_header()["geom"])
    assert hdr2 == hdr
    np.testing.assert_array_equal(np.asarray(mm), np.asarray(mm2))
    with pytest.raises(ValueError):
        mm2[0, 0] = 1.0   # read-only


def test_cache_version_rejected(tmp_path):
    path = str(tmp_path / "c")
    dcache.build_cache(path, header=_tiny_header(), write_bin=_write_rows)
    hdr = dcache.read_header(path)
    hdr["version"] = 99
    with open(dcache.meta_path(path), "w") as f:
        json.dump(hdr, f)
    with pytest.raises(ValueError, match="version"):
        dcache.open_cache(path)


def test_cache_layout_and_geom_rejected(tmp_path):
    path = str(tmp_path / "c")
    dcache.build_cache(path, header=_tiny_header(), write_bin=_write_rows)
    with pytest.raises(ValueError, match="layout"):
        dcache.open_cache(path, layout="something_else")
    with pytest.raises(ValueError, match="built with"):
        dcache.open_cache(path, expect_geom={"n": 64})
    with open(dcache.meta_path(path), "w") as f:
        json.dump(dict(_tiny_header(), format="other"), f)
    with pytest.raises(ValueError, match="not a tda-packed-cache"):
        dcache.open_cache(path)


def test_cache_legacy_flat_meta_accepted(tmp_path):
    """A pre-versioned cache (its flat geometry as the whole meta.json)
    reopens instead of being rebuilt, in both packages alike."""
    path = str(tmp_path / "c")
    geom = {"n_rows": 8, "seed": 0}
    np.arange(16, dtype=np.float32).reshape(8, 2).tofile(
        dcache.bin_path(path))
    with open(dcache.meta_path(path), "w") as f:
        json.dump(geom, f)
    mm, hdr = dcache.open_cache(path, legacy_geom=geom)
    assert mm is None and hdr == jcache.open_cache(path, legacy_geom=geom)[1]
    assert hdr["version"] == 1 and hdr["geom"] == geom
    with pytest.raises(ValueError, match="legacy"):
        dcache.open_cache(path, legacy_geom={"n_rows": 9})


def test_cache_bin_without_meta_is_incomplete(tmp_path):
    path = str(tmp_path / "c")
    np.zeros(4, np.float32).tofile(dcache.bin_path(path))
    assert not dcache.exists(path)
    with pytest.raises(FileNotFoundError, match="complete"):
        dcache.open_cache(path)


def test_cache_shard_slicing():
    assert dcache.shard_rows(32, 4, 2) == jcache.shard_rows(32, 4, 2) == (
        16, 24)
    with pytest.raises(ValueError, match="divide"):
        dcache.shard_rows(33, 4, 0)
    mm = np.arange(32)[:, None] * np.ones((1, 2))
    np.testing.assert_array_equal(dcache.shard_view(mm, 4, 1), mm[8:16])


def test_cache_concurrent_two_process_build(tmp_path):
    """Two processes build one path at once: both succeed (PID/uuid tmp
    names, the last rename wins) and the survivor holds the bytes either
    would write; no tmp file is left."""
    path = str(tmp_path / "race")
    prog = (
        "import numpy as np\n"
        "from tpu_distalg_torch.data import cache as dcache\n"
        "hdr = dcache.make_header(layout='rows_test', dtype=np.float32,"
        " shape=(64, 8), geom={'seed': 5})\n"
        "def wb(mm):\n"
        "    mm[:] = np.random.default_rng(5).random(mm.shape,"
        " dtype=np.float32)\n"
        f"mm, _ = dcache.build_cache({path!r}, header=hdr, write_bin=wb)\n"
        "print(float(np.asarray(mm).sum()))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", prog], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    mm, _ = dcache.open_cache(path, layout="rows_test")
    np.testing.assert_array_equal(
        np.asarray(mm),
        np.random.default_rng(5).random((64, 8), dtype=np.float32))
    assert [p for p in os.listdir(tmp_path) if ".tmp." in p] == []


def test_cache_write_fault_is_retried(tmp_path):
    """``cache:write`` is a seam: a transient OSError on one attempt is
    retried in place (the build is deterministic), and one on every
    attempt raises after BUILD_RETRIES retries, leaving no tmp file."""
    sink = tevents.configure(str(tmp_path / "tel"))
    faults.configure("seed=1;cache:write@0=oserror")
    mm, _ = dcache.build_cache(str(tmp_path / "c"), header=_tiny_header(),
                               write_bin=_write_rows)
    np.testing.assert_array_equal(
        np.asarray(mm), np.arange(128, dtype=np.float32).reshape(32, 4))
    assert faults.active().hits("cache:write") == 2
    assert sink.counters()["cache.write_failures"] == 1
    faults.configure("seed=1;cache:write@*=oserror")
    with pytest.raises(faults.InjectedOSError):
        dcache.build_cache(str(tmp_path / "d"), header=_tiny_header(),
                           write_bin=_write_rows)
    assert faults.active().hits("cache:write") == dcache.BUILD_RETRIES + 1
    assert not dcache.exists(str(tmp_path / "d"))
    assert [p for p in os.listdir(tmp_path) if ".tmp." in p] == []


@pytest.mark.parametrize("kind", ["points", "rank_k", "packed"])
def test_each_package_opens_the_others_cache(tmp_path, kind, mesh4):
    """A cache written by the JAX package opens in the port and one
    written by the port opens in the JAX package, bfloat16 included (as
    uint16 bits in the port: the card's machine has no ml_dtypes)."""
    def build(mod, path):
        if kind == "points":
            return mod[0].gaussian_points_dataset(
                mod[1], 1000, dim=3, k=2, seed=4, block_rows=16,
                backend="streamed", path=path)[0].storage
        if kind == "rank_k":
            return mod[0].rank_k_rows_dataset(
                mod[1], 50, 12, 3, seed=4, block_rows=8,
                backend="streamed", path=path)[0].storage
        return mod[2].streamed_packed_cache(
            path, n_rows=4096, n_features=7, n_shards=4, pack=4,
            gather_block_rows=64, seed=2, chunk_rows=1024, n_test=64)[0]

    port = (builders, _mesh(), datasets)
    jax_ = (jbuilders, mesh4, jdatasets)
    for name, writer, reader in (("by_jax", jax_, port),
                                 ("by_port", port, jax_)):
        path = str(tmp_path / name)
        wrote = np.asarray(build(writer, path))
        read = np.asarray(build(reader, path))   # reopens, does not build
        if wrote.dtype != read.dtype:            # bfloat16 vs its bits
            wrote, read = (a.view(np.uint16) for a in (wrote, read))
        np.testing.assert_array_equal(read, wrote)
    assert dcache.read_header(str(tmp_path / "by_port")) == \
        jcache.read_header(str(tmp_path / "by_jax"))


# ------------------------------------------------------------ builders


@pytest.mark.parametrize("kind", ["points", "rank_k"])
def test_builder_bytes_equal_jax(tmp_path, kind, mesh4):
    """Both builders' ``.bin`` and ``meta.json`` equal the JAX package's
    byte for byte (padded to the block grid, m not a multiple of it),
    and every backend holds the same bytes."""
    if kind == "points":
        kw = dict(dim=5, k=3, seed=7, spread=6.0, block_rows=32)
        args, fn, jfn = (1000,), builders.gaussian_points_dataset, \
            jbuilders.gaussian_points_dataset
    else:
        kw = dict(seed=3, noise_sigma=0.1, block_rows=8)
        args, fn, jfn = (90, 40, 5), builders.rank_k_rows_dataset, \
            jbuilders.rank_k_rows_dataset
    ds, truth = fn(_mesh(), *args, backend="streamed",
                   path=str(tmp_path / "p"), **kw)
    jds, jtruth = jfn(mesh4, *args, backend="streamed",
                      path=str(tmp_path / "j"), **kw)
    for suffix in (".bin", ".meta.json"):
        with open(str(tmp_path / "p") + suffix, "rb") as f:
            mine = f.read()
        with open(str(tmp_path / "j") + suffix, "rb") as f:
            assert mine == f.read(), suffix
    pairs = zip(truth, jtruth) if kind == "rank_k" else [(truth, jtruth)]
    for a, b in pairs:
        np.testing.assert_array_equal(a, b)
    for backend in ("resident", "virtual"):
        other = fn(_mesh(), *args, backend=backend, **kw)[0]
        held = (other.storage.numpy() if backend == "resident"
                else other.storage)
        np.testing.assert_array_equal(held, np.asarray(ds.storage))
    assert ds.meta == dict(jds.meta)


def test_streamed_packed_cache_bytes_equal_jax(tmp_path):
    """The streamed SSGD cache (bf16 bits made in uint16): .bin,
    meta.json and the held-out split equal the JAX package's."""
    kw = dict(n_rows=4 * 32 * 4 * 8, n_features=15, n_shards=4, pack=4,
              gather_block_rows=32, seed=3, x_dtype="bfloat16",
              chunk_rows=4096, n_test=512)
    X2, meta, (Xt, yt) = datasets.streamed_packed_cache(
        str(tmp_path / "p"), **kw)
    jX2, jmeta, (jXt, jyt) = jdatasets.streamed_packed_cache(
        str(tmp_path / "j"), **kw)
    assert X2.dtype == np.uint16 and meta == jmeta
    for suffix in (".bin", ".meta.json"):
        with open(str(tmp_path / "p") + suffix, "rb") as f:
            mine = f.read()
        with open(str(tmp_path / "j") + suffix, "rb") as f:
            assert mine == f.read(), suffix
    np.testing.assert_array_equal(Xt, jXt)
    np.testing.assert_array_equal(yt, jyt)
    t, jt = (np.load(str(tmp_path / s) + ".test.npz") for s in ("p", "j"))
    np.testing.assert_array_equal(t["w_true"], jt["w_true"])
    with pytest.raises(ValueError, match="multiple of"):
        datasets.streamed_packed_cache(str(tmp_path / "x"),
                                       **dict(kw, n_rows=4096 + 16))
    with pytest.raises(ValueError, match="2-byte"):
        datasets.streamed_packed_cache(str(tmp_path / "x"),
                                       **dict(kw, x_dtype="float32"))


# ------------------------------------------------- ShardedDataset core


def _packed_matrix(n2=64, pd=8, seed=0):
    return np.random.default_rng(seed).random((n2, pd)).astype(np.float32)


def _three_backends(tmp_path, arr, block_rows, dtype=None):
    """The same rows behind each backend; ``dtype`` names the rows' type
    in the cache header when ``arr`` holds their bits (bfloat16)."""
    mesh = _mesh()
    hdr = dcache.make_header(layout="rows_test", dtype=dtype or arr.dtype,
                             shape=arr.shape, geom={"seed": 0})
    path = str(tmp_path / "ds")

    def wb(mm):
        mm[:] = arr

    dcache.build_cache(path, header=hdr, write_bin=wb)
    return {
        "resident": ShardedDataset.from_array(arr, mesh,
                                              block_rows=block_rows,
                                              backend="resident"),
        "virtual": ShardedDataset.from_array(arr, mesh,
                                             block_rows=block_rows),
        "streamed": ShardedDataset.from_cache(path, mesh,
                                              block_rows=block_rows,
                                              layout="rows_test"),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_batches_bitwise_equal_across_backends(tmp_path, dtype):
    """Whichever backend holds the bytes, the staged batch is the same
    tensor (bfloat16 rows as uint16 bits on the host), and it is the
    hand gather: shard s, block b = storage rows [s·16 + b·4, … + 4)."""
    arr = _packed_matrix()
    if dtype == "bfloat16":
        arr = host_bits(torch.from_numpy(arr).to(torch.bfloat16))
    dss = _three_backends(tmp_path, arr, block_rows=4, dtype=dtype)
    ids = np.array([[0, 3], [1, 1], [2, 0], [3, 2]])
    staged = {k: ds.stage(ids) for k, ds in dss.items()}
    assert dss["streamed"].backend == "streamed"
    for k, t in staged.items():
        assert t.dtype == getattr(torch, dtype) and t.shape == (4, 8, 8), k
        assert torch.equal(t.view(torch.int32 if dtype == "float32"
                                  else torch.int16),
                           staged["resident"].view(
                               torch.int32 if dtype == "float32"
                               else torch.int16))
    want = torch.from_numpy(arr[16 + 4:16 + 8]).view(getattr(torch, dtype))
    assert torch.equal(staged["virtual"][1, :4], want)
    assert dss["virtual"].h2d_bytes_per_step(2) == 4 * 2 * 4 * 8 * (
        arr.dtype.itemsize)
    assert dss["resident"].h2d_bytes_per_step(2) == 0


@pytest.mark.parametrize("backend", ["resident", "virtual", "streamed"])
def test_stream_order_matches_serial_stage(tmp_path, backend):
    ds = _three_backends(tmp_path, _packed_matrix(), block_rows=4)[backend]
    ids = np.array([[[0], [1], [2], [3]], [[3], [2], [1], [0]],
                    [[1], [1], [1], [1]]])
    got = list(ds.stream(ids))
    assert len(got) == 3
    for g, i in zip(got, ids):
        assert torch.equal(g, ds.stage(i))


def test_dataset_shape_validation():
    with pytest.raises(ValueError, match="divisible"):
        ShardedDataset.from_array(_packed_matrix(n2=62), _mesh(),
                                  block_rows=4)
    with pytest.raises(ValueError, match="block_rows"):
        ShardedDataset.from_array(_packed_matrix(), _mesh(), block_rows=5)
    with pytest.raises(ValueError, match="backend"):
        ShardedDataset.from_array(_packed_matrix(), _mesh(), block_rows=4,
                                  backend="cloud")
    with pytest.raises(ValueError, match="from_cache"):
        ShardedDataset.from_array(_packed_matrix(), _mesh(), block_rows=4,
                                  backend="streamed")
    with pytest.raises(ValueError, match="resident backend needs"):
        ShardedDataset(_packed_matrix(), _mesh(), block_rows=4,
                       backend="resident")
    ds = ShardedDataset.from_array(_packed_matrix(), _mesh(), block_rows=4)
    with pytest.raises(ValueError, match="outside"):
        ds.stage(np.array([[4], [0], [0], [0]]))
    with pytest.raises(ValueError, match="block ids"):
        ds.stage(np.array([[0], [0]]))
    res = ShardedDataset.from_array(_packed_matrix(), _mesh(), block_rows=4,
                                    backend="resident")
    with pytest.raises(ValueError, match="on device"):
        res.gather(np.zeros((4, 1), np.int64))


@pytest.mark.parametrize("args", [(10_001, 256, 8, 0.05), (1024, 64, 4, None),
                                  (10 ** 9, 131072, 1, 0.01), (7, 4, 3, 1.0)])
def test_block_geometry_shared_grid(args):
    got = block_geometry(*args)
    assert got == jdata.block_geometry(*args)
    rows, blocks, sampled = got
    assert rows % args[1] == 0 and rows * args[2] >= args[0]
    assert blocks == rows // args[1]
    assert sampled == (None if args[3] is None
                       else max(1, round(args[3] * blocks)))


@pytest.mark.parametrize("geom", [(42, 4, 100, 3), (7, 1, 16384, 4),
                                  (0, 8, 33, 33), (5, 2, 1, 1)])
def test_host_block_draws_equal_jax(geom):
    """The host sampler's ids equal JAX's ``make_host_block_sampler``
    exactly (the port's threefry is exact int64 arithmetic)."""
    ts = np.array([0, 1, 2, 17, 1499, 123456])
    got = make_host_block_sampler(*geom)(ts)
    want = jdata.make_host_block_sampler(*geom)(ts)
    assert got.dtype == np.int32 and got.shape == (6, geom[1], geom[3])
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ pipeline


def test_prefetch_error_propagates(tmp_path):
    """A producer exception surfaces in the consumer within the prefetch
    depth instead of hanging the queue."""
    ds = _three_backends(tmp_path, _packed_matrix(), block_rows=4)["virtual"]
    real = ds.gather
    calls = {"n": 0}

    def bad_gather(ids_step, out=None):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("gather exploded")
        return real(ids_step, out)

    ds.gather = bad_gather
    ids = np.tile(np.arange(4).reshape(1, 4, 1), (6, 1, 1))
    seen = 0
    with pytest.raises(RuntimeError, match="gather exploded"):
        for _ in ds.stream(ids):
            seen += 1
    assert seen <= 3


def test_prefetcher_early_close_joins():
    with Prefetcher(lambda i: i, 100) as pf:
        assert pf.get() == 0
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()
    with Prefetcher(lambda i: i, 0) as empty:
        with pytest.raises(ProducerDiedError, match="never started"):
            empty.get()


@pytest.mark.parametrize("backend", ["virtual", "streamed"])
def test_data_gather_kill_raises_producer_died(tmp_path, backend):
    """``data:gather@N=kill`` kills the producer silently; the consumer's
    liveness check turns it into ProducerDiedError when it asks for the
    batch that never comes."""
    ds = _three_backends(tmp_path, _packed_matrix(), block_rows=4)[backend]
    faults.configure("seed=3;data:gather@2=kill")
    ids = np.tile(np.arange(4).reshape(1, 4, 1), (5, 1, 1))
    seen = 0
    with pytest.raises(ProducerDiedError, match="died"):
        for _ in ds.stream(ids):
            seen += 1
    assert seen == 1   # batch 1 waits in the queue while batch 0 computes
    assert faults.active().fired == [("data:gather", 2, "kill")]


def test_data_h2d_fault_reaches_the_consumer(tmp_path):
    ds = _three_backends(tmp_path, _packed_matrix(), block_rows=4)["virtual"]
    faults.configure("seed=3;data:h2d@1=oserror")
    ids = np.tile(np.arange(4).reshape(1, 4, 1), (4, 1, 1))
    with pytest.raises(faults.InjectedOSError, match="data:h2d#1"):
        list(ds.stream(ids))


def test_stream_telemetry(tmp_path):
    """Each gather and H2D is a span, the data.* counters add batches
    and bytes, and a finished stream emits one data_pipeline event."""
    sink = tevents.configure(str(tmp_path / "tel"))
    ds = _three_backends(tmp_path, _packed_matrix(), block_rows=4)["streamed"]
    ids = np.tile(np.arange(4).reshape(1, 4, 1), (3, 1, 1))
    assert len(list(ds.stream(ids))) == 3
    counters = sink.counters()
    path = sink.path
    tevents.configure(False)
    with open(path) as f:
        evs = [json.loads(line) for line in f]
    spans = [e["name"] for e in evs if e["ev"] == "span_end"]
    assert spans.count("data:gather") == 3 and spans.count("data:h2d") == 3
    assert counters["data.gather_batches"] == 3
    assert counters["data.h2d_bytes"] == 3 * 4 * 4 * 8 * 4
    pipe = [e for e in evs if e["ev"] == "data_pipeline"]
    assert len(pipe) == 1 and pipe[0]["steps"] == 3
    assert pipe[0]["bytes"] == 3 * 4 * 4 * 8 * 4


# ------------------------------------- workload backend equivalence


def test_kmeans_minibatch_backend_equivalence_and_jax(tmp_path, mesh4):
    """resident == virtual == streamed centres bit for bit; JAX's
    minibatch run on the same bytes within rtol 5e-6 + atol 1e-5; every
    true mean found."""
    res = {}
    for be in ("resident", "virtual", "streamed"):
        ds, truth = builders.gaussian_points_dataset(
            _mesh(), 4096, dim=4, k=3, seed=7, block_rows=64, backend=be,
            path=str(tmp_path / "pts") if be == "streamed" else None)
        r = kmeans.fit_minibatch(ds, kmeans.KMeansConfig(k=3, seed=1),
                                 n_steps=20, mini_batch_blocks=2)
        assert r.n_iterations_run == 20 and r.assignments.shape == (0,)
        res[be] = r.centers
    assert torch.equal(res["resident"], res["virtual"])
    assert torch.equal(res["virtual"], res["streamed"])
    jds, _ = jbuilders.gaussian_points_dataset(
        mesh4, 4096, dim=4, k=3, seed=7, block_rows=64, backend="streamed",
        path=str(tmp_path / "jpts"))
    want = jkmeans.fit_minibatch(jds, jkmeans.KMeansConfig(k=3, seed=1),
                                 n_steps=20, mini_batch_blocks=2)
    np.testing.assert_allclose(res["streamed"].numpy(),
                               np.asarray(want.centers), rtol=5e-6,
                               atol=1e-5)
    c0 = kmeans.init_centers_from_dataset(ds, 3, 1)
    np.testing.assert_array_equal(
        c0.numpy(), np.asarray(jkmeans.init_centers_from_dataset(jds, 3, 1)))
    d = np.linalg.norm(res["streamed"].numpy()[:, None] - truth[None],
                       axis=-1)
    assert sorted(d.argmin(axis=1).tolist()) == [0, 1, 2]
    assert float(d.min(axis=1).max()) < 1.0
    with pytest.raises(ValueError, match="first block"):
        kmeans.init_centers_from_dataset(ds, 65, 1)


def test_als_streamed_backend_equivalence_and_jax(tmp_path, mesh4):
    """virtual == streamed == resident bit for bit (U, V, rmse); JAX's
    fit_streamed on the same bytes within 4e-6 in rmse and 3e-5 of the
    largest |U|, |V|; the port's resident mesh fit within float
    tolerance (the blocked contraction reorders additions). m is not a
    multiple of the block grid: the zero padding rows are inert."""
    cfg = als.ALSConfig(m=90, n=40, k=5, lam=0.01, n_iterations=4, seed=0)
    outs = {}
    for be in ("resident", "virtual", "streamed"):
        ds, _ = builders.rank_k_rows_dataset(
            _mesh(), cfg.m, cfg.n, cfg.k, seed=cfg.seed, block_rows=8,
            backend=be, path=str(tmp_path / "als") if be == "streamed"
            else None)
        assert ds.n2 == 96   # 90 → 96: 4 shards × 8-row blocks
        outs[be] = als.fit_streamed(ds, cfg)
    for be in ("virtual", "streamed"):
        for f in ("U", "V", "rmse_history"):
            assert torch.equal(getattr(outs[be], f),
                               getattr(outs["resident"], f)), (be, f)
    assert outs["streamed"].U.shape == (cfg.m, cfg.k)
    jds, _ = jbuilders.rank_k_rows_dataset(
        mesh4, cfg.m, cfg.n, cfg.k, seed=0, block_rows=8, backend="streamed",
        path=str(tmp_path / "jals"))
    want = jals.fit_streamed(jds, jals.ALSConfig(
        m=90, n=40, k=5, lam=0.01, n_iterations=4, seed=0))
    got = outs["streamed"]
    np.testing.assert_allclose(got.rmse_history.numpy(),
                               np.asarray(want.rmse_history), rtol=0,
                               atol=4e-6)
    for mine, theirs in ((got.U, want.U), (got.V, want.V)):
        theirs = np.asarray(theirs)
        assert np.abs(mine.numpy() - theirs).max() <= 3e-5 * np.abs(
            theirs).max()
    resident = als.fit(_mesh(), cfg, als.synthesize_rank_k(cfg))
    np.testing.assert_allclose(got.rmse_history.numpy(),
                               resident.rmse_history.numpy(), rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_allclose(got.U.numpy(), resident.U.numpy(), rtol=2e-3,
                               atol=2e-4)


def test_als_rmse_every_zero_evaluates_once():
    cfg = als.ALSConfig(m=32, n=16, k=3, lam=0.0, n_iterations=3)
    ds, _ = builders.rank_k_rows_dataset(_mesh(), 32, 16, 3, seed=0,
                                         block_rows=4, backend="virtual")
    assert als.fit_streamed(ds, cfg, rmse_every=0).rmse_history.shape == (1,)
    assert als.fit_streamed(ds, cfg, rmse_every=2).rmse_history.shape == (2,)
    every = als.fit_streamed(ds, cfg).rmse_history
    assert every.shape == (3,)
    once = als.fit_streamed(ds, cfg, rmse_every=0).rmse_history
    assert torch.equal(once[-1], every[-1])


# ------------------------------------------------------------------ CLI


@pytest.mark.parametrize("argv,tail", [
    (["kmeans", "--data-backend", "virtual", "--n-points", "3000", "--k",
      "3", "--dim", "4", "--block-rows", "64", "--minibatch-steps", "5"],
     "minibatch steps run: 5 (backend=virtual)"),
    (["kmeans", "--data-backend", "streamed", "--stream-cache", "{tmp}/p",
      "--scale-points", "3000", "--k", "3", "--dim", "4", "--block-rows",
      "64"], "minibatch steps run: 100 (backend=streamed)"),
    (["als", "--data-backend", "virtual", "--m", "40", "--n", "24", "--k",
      "3", "--n-iterations", "2", "--block-rows", "8"],
     "iterations: 1, rmse: "),
    (["als", "--data-backend", "streamed", "--stream-cache", "{tmp}/r",
      "--m", "40", "--n", "24", "--k", "3", "--n-iterations", "2",
      "--block-rows", "8", "--rmse-every", "0"], "iterations: 0, rmse: ")],
    ids=["kmeans-virtual", "kmeans-streamed", "als-virtual", "als-streamed"])
def test_cli_data_backends(argv, tail, tmp_path, capsys):
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    assert cli.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith(tail), out
    if "als" in argv and "--rmse-every" in argv:
        assert len(out) == 1


@pytest.mark.parametrize("argv,msg", [
    (["kmeans", "--data-backend", "streamed"], "needs --stream-cache"),
    (["als", "--data-backend", "streamed"], "needs --stream-cache"),
    (["kmeans", "--minibatch-steps", "3", "--checkpoint-dir", "x"],
     "not supported by the minibatch engine"),
    (["als", "--data-backend", "virtual", "--checkpoint-dir", "x"],
     "not supported by the streamed ALS"),
    # the graph slice is ported: its engine refuses the reference mode
    pytest.param(["pagerank", "--data-backend", "streamed", "--mode",
                  "reference"], "resident-only", id="argv4-graph slice"),
    (["kmeans", "--fault-plan", "seed=1;data:gather@1=kill"],
     "reads no fault plan"),
    (["kmeans", "--data-backend", "virtual", "--fault-plan",
      "seed=1;shard:leave@1=leave"], "reads no rule at shard:leave")])
def test_cli_data_refusals(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        cli.main(["--device", "cpu", *argv])


def test_cli_data_plan_fires(capsys):
    """A plan at the data seams is read by a data run: a retried
    ``data:gather`` hang slows nothing but fires."""
    assert cli.main(["--device", "cpu", "kmeans", "--data-backend",
                     "virtual", "--n-points", "2000", "--k", "2", "--dim",
                     "3", "--block-rows", "64", "--minibatch-steps", "3",
                     "--fault-plan", "seed=2;data:gather@1=hang:0.01"]) == 0
    assert faults.active().fired == [("data:gather", 1, "hang")]
    assert "minibatch steps run: 3" in capsys.readouterr().out
