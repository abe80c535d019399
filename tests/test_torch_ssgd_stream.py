"""The port's streamed host → device SSGD (``tpu_distalg_torch/models/
ssgd_stream.py``) on the CPU: against the port's resident
``fused_gather`` bit for bit, and against the JAX package's
``ssgd_stream`` (its interpret-mode kernel) within tolerance.

Standards. The streamed trainer runs B1's plain version on each staged
batch with the identity block index and shares the resident path's
gradient and update code, so its weights and accuracy histories equal a
resident ``fused_gather`` run's bit for bit (the JAX package's own
contract, ``tests/test_ssgd_stream.py:25``), straight, segmented and
resumed. Against JAX's live run on breast cancer: 30 steps within 1e-4
of the largest |w| with equal accuracy histories (ROADMAP C: the SSGD
standard, held before the float32 trajectories part).
"""

from __future__ import annotations

import os
import dataclasses

import numpy as np
import pytest
import torch

from tpu_distalg.models import ssgd as jssgd
from tpu_distalg.models import ssgd_stream as jstream
from tpu_distalg_torch import cli
from tpu_distalg_torch.models import ssgd, ssgd_stream
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))


@pytest.fixture(scope="module")
def data():
    return datasets.breast_cancer_split()


def _cfg(**kw):
    base = dict(n_iterations=60, sampler="fused_gather",
                gather_block_rows=32, fused_pack=4, shuffle_seed=0,
                eval_every=10, mini_batch_fraction=0.25)
    base.update(kw)
    return ssgd.SSGDConfig(**base)


def _mesh(n):
    return get_mesh(data=n, device="cpu")


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shards", [1, 4])
def test_stream_bitwise_equals_resident_fused_gather(data, x_dtype, shards):
    """Same packing, the same threefry block draws made on the host, B1
    over the staged blocks: the weights and accuracies equal resident
    ``fused_gather`` bit for bit."""
    X, y, Xt, yt = data
    cfg = _cfg(x_dtype=x_dtype)
    resident = ssgd.train(X, y, Xt, yt, _mesh(shards), cfg)
    X2h, meta = ssgd_stream.pack_host(X, y, _mesh(shards), cfg)
    assert isinstance(X2h, np.ndarray)   # never on the device
    assert X2h.dtype == (np.uint16 if x_dtype == "bfloat16" else np.float32)
    streamed = ssgd_stream.train(X2h, meta, _mesh(shards), cfg, Xt, yt)
    assert torch.equal(resident.w, streamed.w)
    assert torch.equal(resident.accs, streamed.accs)


def test_stream_memmap_source(data, tmp_path):
    """A disk memmap trains as the in-memory array does."""
    X, y, Xt, yt = data
    cfg = _cfg(n_iterations=30)
    X2h, meta = ssgd_stream.pack_host(X, y, _mesh(4), cfg)
    path = tmp_path / "packed.bin"
    mm = np.memmap(path, dtype=X2h.dtype, mode="w+", shape=X2h.shape)
    mm[:] = X2h
    mm.flush()
    ro = np.memmap(path, dtype=X2h.dtype, mode="r", shape=X2h.shape)
    trainer = ssgd_stream.StreamTrainer(ro, meta, _mesh(4), cfg, Xt, yt)
    assert trainer.dataset.backend == "streamed"
    a = ssgd_stream.train(X2h, meta, _mesh(4), cfg, Xt, yt)
    b = ssgd_stream.train(ro, meta, _mesh(4), cfg, Xt, yt)
    assert torch.equal(a.w, b.w)


def test_stream_segmented_equals_straight(data, tmp_path):
    X, y, Xt, yt = data
    cfg = _cfg()
    X2h, meta = ssgd_stream.pack_host(X, y, _mesh(4), cfg)
    straight = ssgd_stream.train(X2h, meta, _mesh(4), cfg, Xt, yt)
    seg = ssgd_stream.train(X2h, meta, _mesh(4), cfg, Xt, yt,
                            checkpoint_dir=str(tmp_path / "ck"),
                            checkpoint_every=25)
    assert torch.equal(straight.w, seg.w)
    assert torch.equal(straight.accs, seg.accs)


def test_stream_resume_from_checkpoint(data, tmp_path):
    """A run stopped after its first segment resumes from the directory
    and ends where a straight run ends."""
    X, y, Xt, yt = data
    d = str(tmp_path / "ck")
    X2h, meta = ssgd_stream.pack_host(X, y, _mesh(4), _cfg())
    ssgd_stream.train(X2h, meta, _mesh(4), _cfg(n_iterations=30), Xt, yt,
                      checkpoint_dir=d, checkpoint_every=30)
    resumed = ssgd_stream.train(X2h, meta, _mesh(4), _cfg(), Xt, yt,
                                checkpoint_dir=d, checkpoint_every=30)
    straight = ssgd_stream.train(X2h, meta, _mesh(4), _cfg(), Xt, yt)
    assert torch.equal(straight.w, resumed.w)


def test_stream_matches_jax(data, mesh4):
    """30 steps on 4 shards beside the JAX package's streamed trainer:
    the packed bytes are equal, the weights within 1e-4 of the largest
    |w|, the accuracy histories equal."""
    X, y, Xt, yt = data
    cfg = _cfg(n_iterations=30, x_dtype="float32")
    jcfg = jssgd.SSGDConfig(**dataclasses.asdict(cfg))
    X2h, meta = ssgd_stream.pack_host(X, y, _mesh(4), cfg)
    jX2h, jmeta = jstream.pack_host(X, y, mesh4, jcfg)
    assert meta == jmeta
    np.testing.assert_array_equal(X2h, np.asarray(jX2h))
    got = ssgd_stream.train(X2h, meta, _mesh(4), cfg, Xt, yt)
    want = jstream.train(np.asarray(jX2h), jmeta, mesh4, jcfg, Xt, yt)
    w = np.asarray(want.w)
    assert np.abs(got.w.numpy() - w).max() <= 1e-4 * np.abs(w).max()
    np.testing.assert_array_equal(got.accs.numpy(), np.asarray(want.accs))
    tr = ssgd_stream.StreamTrainer(X2h, meta, _mesh(4), cfg, Xt, yt)
    want = jstream.host_block_ids(jcfg, 4, tr.n_blocks, tr.n_sampled,
                                  np.arange(5, 12))
    np.testing.assert_array_equal(tr.block_ids(5, 7), want)
    np.testing.assert_array_equal(ssgd_stream.host_block_ids(
        cfg, 4, tr.n_blocks, tr.n_sampled, np.arange(5, 12)), want)


def test_make_step_fn_equals_a_run(data):
    """One ``make_step_fn`` step a staged batch, in order, is the
    trainer's run (eval off)."""
    X, y, Xt, yt = data
    cfg = _cfg(n_iterations=8, eval_test=False)
    X2h, meta = ssgd_stream.pack_host(X, y, _mesh(2), cfg)
    tr = ssgd_stream.StreamTrainer(X2h, meta, _mesh(2), cfg)
    w0 = torch.linspace(-1, 1, meta["d_total"])
    want, accs = tr.run(w0, 3, 8)
    assert torch.equal(accs, torch.zeros(8))
    step = ssgd_stream.make_step_fn(_mesh(2), cfg, meta, tr.n_sampled)
    w = w0
    for staged in tr.dataset.stream(tr.block_ids(3, 8)):
        w = step(staged, w)
    assert torch.equal(w, want)


def test_streamed_packed_cache_trains_to_the_teacher(tmp_path):
    """The disk cache reopens with equal bytes, refuses another
    geometry, and its rows train to within 0.02 of the teacher's own
    held-out accuracy (the ceiling saved with the cache)."""
    path = str(tmp_path / "ds")
    kw = dict(n_shards=4, pack=4, gather_block_rows=32, seed=3,
              x_dtype="bfloat16", chunk_rows=4096, n_test=512)
    X2, meta, (Xt, yt) = datasets.streamed_packed_cache(
        path, n_rows=4 * 32 * 4 * 8, n_features=15, **kw)
    X2b, meta_b, _ = datasets.streamed_packed_cache(
        path, n_rows=4 * 32 * 4 * 8, n_features=15, **kw)
    assert meta == meta_b
    np.testing.assert_array_equal(np.asarray(X2), np.asarray(X2b))
    with pytest.raises(ValueError, match="cache"):
        datasets.streamed_packed_cache(path, n_rows=4 * 32 * 4 * 8,
                                       n_features=14, **kw)
    cfg = _cfg(n_iterations=500, eta=0.5, shuffle_seed=None,
               mini_batch_fraction=0.2, eval_every=50)
    res = ssgd_stream.train(X2, meta, _mesh(4), cfg, Xt, yt)
    t = np.load(path + ".test.npz")
    teacher = np.mean((Xt @ t["w_true"] > 0) == (yt > 0.5))
    assert res.final_acc > teacher - 0.02


def test_stream_shard_mismatch_rejected(data):
    X, y, Xt, yt = data
    cfg = _cfg()
    X2h, meta = ssgd_stream.pack_host(X, y, _mesh(4), cfg)
    with pytest.raises(ValueError, match="divisible"):
        ssgd_stream.StreamTrainer(X2h[:-1], meta, _mesh(4), cfg, Xt, yt)
    with pytest.raises(ValueError, match="eval_test"):
        ssgd_stream.StreamTrainer(X2h, meta, _mesh(4), cfg)
    with pytest.raises(ValueError, match="disagrees"):
        ssgd_stream.StreamTrainer(X2h[:X2h.shape[0] // 2], meta, _mesh(4),
                                  cfg, Xt, yt)


def test_cli_ssgd_stream_cache(tmp_path, capsys):
    """``ssgd --stream-cache`` makes the cache and trains from it; the
    JAX CLI's refusals hold (``tpu_distalg/cli.py:1181-1198``)."""
    base = ["--device", "cpu", "ssgd", "--stream-cache",
            str(tmp_path / "s"), "--stream-rows", "65536",
            "--gather-block-rows", "256", "--n-slices", "2"]
    assert cli.main(base + ["--n-iterations", "20", "--quiet"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("Final acc: ")
    assert lines[1].startswith("[ssgd] 20 iterations in ")
    for extra, msg in ((["--mega-steps", "5"], "--mega-steps applies"),
                       (["--comm", "int8"], "--comm applies"),
                       (["--sync", "ssp:4"], "--sync ssp applies")):
        with pytest.raises(SystemExit, match=msg):
            cli.main(base + extra)
