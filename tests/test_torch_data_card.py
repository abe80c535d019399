"""The data subsystem's pinned pipeline and the streamed SSGD step on the
card, against the port's own resident and serial paths. Imports neither
jax nor ``tpu_distalg``, so it also runs on a machine with only the
port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_data_card.py

Without a card the tests skip (the CPU port is held to the JAX package
in ``tests/test_torch_data.py`` and ``tests/test_torch_ssgd_stream.py``).
Copies are exact and B1 launches the same plan for a staged batch as for
the resident rows, so every comparison here is bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch.data import (
    ShardedDataset,
    cache,
    make_host_block_sampler,
    sharded,
)
from tpu_distalg_torch.models import ssgd, ssgd_stream
from tpu_distalg_torch.ops import ssgd_kernels
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))


@pytest.fixture
def cuda_device():
    """The card, or a skip: these tests compare the card's pipeline with
    its resident and serial paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs the card "
                    "paths); the CPU port is held to JAX elsewhere")
    return torch.device("cuda")


def _rows(n2, pd, dtype, seed=0):
    a = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n2, pd)).astype(np.float32)).to(dtype)
    return sharded.host_bits(a)


def _backends(tmp_path, arr, dtype, mesh, block_rows):
    hdr = cache.make_header(layout="rows_test", dtype=(
        "bfloat16" if dtype == torch.bfloat16 else arr.dtype),
        shape=arr.shape, geom={})

    def wb(mm):
        mm[:] = arr

    cache.build_cache(str(tmp_path / "c"), header=hdr, write_bin=wb)
    return {"resident": ShardedDataset.from_array(
                arr, mesh, block_rows=block_rows, backend="resident",
                dtype=dtype),
            "virtual": ShardedDataset.from_array(arr, mesh,
                                                 block_rows=block_rows,
                                                 dtype=dtype),
            "streamed": ShardedDataset.from_cache(str(tmp_path / "c"), mesh,
                                                  block_rows=block_rows)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shards", [1, 4])
def test_pinned_staging_equals_resident_take(tmp_path, cuda_device, dtype,
                                             shards):
    """The host backends' pinned gather + side-stream copy stage the same
    tensor on the card as the resident take, serially and streamed."""
    mesh = get_mesh(data=shards, device=cuda_device)
    arr = _rows(shards * 64 * 16, 40, dtype)
    dss = _backends(tmp_path, arr, dtype, mesh, block_rows=64)
    ids = np.random.default_rng(1).integers(0, 16, size=(20, shards, 3))
    want = [dss["resident"].stage(i) for i in ids]
    for name in ("virtual", "streamed"):
        ds = dss[name]
        for i, w in zip(ids, want):
            got = ds.stage(i)
            assert got.device.type == "cuda" and got.dtype == dtype
            assert torch.equal(got, w), name
        for g, w in zip(ds.stream(ids), want):
            assert torch.equal(g, w), name
        assert ds.pinned_buffers == sharded.PINNED_BUFFERS


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shards", [1, 4])
def test_streamed_b1_steps_equal_resident(cuda_device, x_dtype, shards):
    """Streamed SSGD on the card (pinned pipeline, B1 on each staged
    batch) equals resident ``fused_gather`` on the same bytes bit for
    bit, with B1 launched steps × shards times on each."""
    X, y, Xt, yt = datasets.breast_cancer_split()
    mesh = get_mesh(data=shards, device=cuda_device)
    cfg = ssgd.SSGDConfig(n_iterations=60, sampler="fused_gather",
                          gather_block_rows=32, fused_pack=4, shuffle_seed=0,
                          eval_every=10, mini_batch_fraction=0.25,
                          x_dtype=x_dtype)
    b1 = ssgd_kernels.fused_grad_sum_gathered
    b1.launches = 0
    resident = ssgd.train(X, y, Xt, yt, mesh, cfg)
    assert b1.launches == 60 * shards
    X2h, meta = ssgd_stream.pack_host(X, y, mesh, cfg)
    b1.launches = 0
    streamed = ssgd_stream.train(X2h, meta, mesh, cfg, Xt, yt)
    assert b1.launches == 60 * shards
    assert torch.equal(resident.w, streamed.w)
    assert torch.equal(resident.accs, streamed.accs)


@pytest.mark.gpu
def test_stream_200_steps_equal_serial_stage(cuda_device):
    """The allocator and event race test: 200 streamed batches of 8 MB,
    each read by a kernel queued behind a sleep (so copies run ahead of
    the compute that reads the earlier batches), equal the serial
    path's, batch for batch."""
    mesh = get_mesh(data=2, device=cuda_device)
    arr = _rows(2 * 256 * 64, 512, torch.float32, seed=3)
    ds = ShardedDataset.from_array(arr, mesh, block_rows=256)
    ids = np.random.default_rng(2).integers(0, 64, size=(200, 2, 8))
    probe = torch.linspace(-1, 1, 512, device=cuda_device)

    def reduce(t):
        torch.cuda._sleep(200_000)        # compute lags the copies
        return (t @ probe).sum(dim=1)

    streamed = [reduce(b) for b in ds.stream(ids)]
    serial = [reduce(ds.stage(i)) for i in ids]
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(streamed, serial)):
        assert torch.equal(a, b), k


@pytest.mark.gpu
def test_host_residency_never_exceeds_three_pinned_buffers(cuda_device):
    """A stream of 200 batches gathers into at most three pinned host
    buffers, reused in turn, each rewritten only after its copy
    finished."""
    mesh = get_mesh(data=1, device=cuda_device)
    ds = ShardedDataset.from_array(_rows(4096, 256, torch.float32), mesh,
                                   block_rows=64)
    seen, held = set(), []
    real = ds.host_batch

    def spy(ids_step):
        slot = real(ids_step)
        assert slot.event is None or slot.event.query()
        seen.add(slot.array.ctypes.data)
        held.append(ds.pinned_buffers)
        return slot

    ds.host_batch = spy
    ids = np.random.default_rng(4).integers(0, 64, size=(200, 1, 4))
    for b in ds.stream(ids):
        (b * 2).sum()
    assert len(seen) <= sharded.PINNED_BUFFERS
    assert max(held) <= sharded.PINNED_BUFFERS


@pytest.mark.gpu
@pytest.mark.parametrize("geom", [(42, 1, 16384, 4), (7, 4, 300, 33)])
def test_block_draws_on_the_card_equal_the_cpu(cuda_device, geom):
    """The trainers hash their block draws on the card: the ids equal the
    CPU's (and so the JAX package's) exactly, a group of steps at a
    time."""
    ts = np.arange(3000, 3100)
    card = make_host_block_sampler(*geom, device=cuda_device)(ts)
    cpu = make_host_block_sampler(*geom)(ts)
    assert card.dtype == np.int32
    np.testing.assert_array_equal(card, cpu)
