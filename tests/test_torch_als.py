"""The port's ALS (``tpu_distalg_torch/models/als.py``, ``ops/linalg.py``)
and its artifacts (``utils/checkpoint.py``) against the JAX package.

Both packages get the same numpy inputs. Tolerances: the two libraries
take matmul sums in different orders, and the port solves its k×k Gram
in float64 where the JAX package stays in float32, so results agree to
a few float32 ulp per operation, which three sweeps grow to about 1e-5
relative. Hence rtol 1e-5 for one linear-algebra call and, at
lam=0.01, rtol 1e-4 on the rmse history and atol 1e-4·max|·| on U and
V. At lam=0 the rmse falls to float32 rounding noise after the first
sweep (about 1e-4 here), where the two histories differ by 2-5x and U,
V themselves are fixed only up to the conditioning of the
unregularised Gram; there both runs are held to exact recovery instead.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
from tpu_distalg.models import als as jals
from tpu_distalg.ops import linalg as jlinalg
from tpu_distalg.parallel import get_mesh as jax_mesh
from tpu_distalg_torch.models import als
from tpu_distalg_torch.ops import linalg
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import checkpoint, device
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

#: the emulated data × model meshes the fit is held to JAX's on
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (2, 4)]


@pytest.fixture
def cpu1():
    """A one-shard mesh on the CPU."""
    return get_mesh(device="cpu")


def _cfgs(lam):
    kw = dict(lam=lam, m=64, n=200, k=8, n_iterations=3)
    return jals.ALSConfig(**kw), als.ALSConfig(**kw)


def test_synthesize_rank_k_equals_jax():
    jc, pc = _cfgs(0.01)
    assert np.array_equal(jals.synthesize_rank_k(jc),
                          als.synthesize_rank_k(pc))


def test_linalg_matches_jax():
    rng = np.random.default_rng(0)
    F = rng.random((50, 8), dtype=np.float32)
    R = rng.random((30, 50), dtype=np.float32)
    U = rng.random((30, 8), dtype=np.float32)
    G_j = np.array(jlinalg.gram(F, 0.01, 50))  # writable copy
    G_p = linalg.regularise(linalg.gram_part(torch.as_tensor(F)), 0.01,
                            50).numpy()
    np.testing.assert_allclose(G_p, G_j, rtol=1e-5)
    S_j = np.asarray(jlinalg.solve_factor_block(G_j, F, R))
    Ft = torch.as_tensor(F)
    S_p = linalg.solve_rhs(torch.linalg.cholesky(torch.as_tensor(
        G_j, dtype=torch.float64)), Ft.T @ torch.as_tensor(R).T).numpy()
    np.testing.assert_allclose(S_p, S_j, rtol=1e-5,
                               atol=1e-5 * np.abs(S_j).max())
    e_j = float(jlinalg.rmse(R, U, F))
    e_p = float(torch.sqrt(linalg.sq_err(
        torch.as_tensor(R), torch.as_tensor(U), Ft) / R.size))
    assert e_p == pytest.approx(e_j, rel=1e-5)


def test_fit_matches_jax_with_ridge(mesh1, cpu1):
    jc, pc = _cfgs(0.01)
    j = jals.fit(mesh1, jc)
    p = als.fit(cpu1, pc)
    np.testing.assert_allclose(p.rmse_history.numpy(),
                               np.asarray(j.rmse_history), rtol=1e-4)
    for mine, ref in ((p.U, j.U), (p.V, j.V)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_fit_matches_jax_exact_recovery_without_ridge(mesh1, cpu1):
    jc, pc = _cfgs(0.0)
    R = als.synthesize_rank_k(pc)
    rms = float(np.sqrt(np.mean(np.square(R, dtype=np.float64))))
    j = jals.fit(mesh1, jc)
    p = als.fit(cpu1, pc)
    for hist in (np.asarray(j.rmse_history), p.rmse_history.numpy()):
        assert hist.shape == (3,)
        assert np.all(hist < 1e-3 * rms)
    for U, V in ((np.asarray(j.U), np.asarray(j.V)),
                 (p.U.numpy(), p.V.numpy())):
        assert np.abs(U @ V.T - R).max() < 1e-3 * np.abs(R).max()


def test_fit_saves_the_serving_artifact(tmp_path, cpu1):
    cfg = als.ALSConfig(m=20, n=30, k=4, n_iterations=2)
    res = als.fit(cpu1, cfg, checkpoint_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_2.npz"]
    payload, step = checkpoint.restore(str(tmp_path))
    assert step == 2 and payload["tag"] == "als"
    U, V = payload["state"]
    assert np.array_equal(U, res.U.numpy())
    assert np.array_equal(V, res.V.numpy())


def test_checkpoint_detects_corruption_and_names_foreign_format(tmp_path):
    d = str(tmp_path / "ck")
    rng = np.random.default_rng(1)
    leaves = [rng.random((5, 3), dtype=np.float32),
              np.arange(4, dtype=np.int32)]
    path = checkpoint.save(d, "als", leaves, step=7)
    payload, step = checkpoint.restore(d)
    assert step == 7 and payload["tag"] == "als"
    for got, want in zip(payload["state"], leaves):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[40] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(checkpoint.CorruptCheckpointError, match="CRC32"):
        checkpoint.restore(d)
    with open(path, "wb") as f:
        f.write(bytes(raw[:-12]))
    with pytest.raises(checkpoint.CorruptCheckpointError, match="footer"):
        checkpoint.restore(d)
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    (jax_dir / "step_3.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="msgpack"):
        checkpoint.restore(str(jax_dir))


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        als.fit(get_mesh(), als.ALSConfig(m=8, n=8, k=2, n_iterations=1))
    assert device.resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


# ------------------------------------------------- the data × model mesh


@pytest.mark.parametrize("data,model", MESHES)
def test_mesh_fit_matches_jax_with_ridge(data, model):
    """The fit on an emulated data × model mesh against the JAX package's
    on the same mesh shape of host devices, at lam=0.01: the rmse
    history within 4e-6, U and V within 3e-5 of their largest entry
    (ROADMAP C: the two libraries' sums in other orders, the port's Gram
    in float64)."""
    kw = dict(lam=0.01, m=64, n=200, k=8, n_iterations=3)
    j = jals.fit(jax_mesh(data=data, model=model,
                          devices=jax.devices()[:data * model]),
                 jals.ALSConfig(**kw))
    p = als.fit(get_mesh(data, model, device="cpu"), als.ALSConfig(**kw))
    np.testing.assert_allclose(p.rmse_history.numpy(),
                               np.asarray(j.rmse_history), rtol=0, atol=4e-6)
    for mine, ref in ((p.U, j.U), (p.V, j.V)):
        ref = np.asarray(ref)
        assert mine.shape == ref.shape
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                   atol=3e-5 * np.abs(ref).max())


def test_model_axis_pads_n_and_engages():
    """n = 30 on a 4-way model axis pads to 32 (inert zero columns) and
    matches the 4×1 run (JAX ``tests/test_data.py:326``)."""
    cfg = als.ALSConfig(m=24, n=30, k=3, lam=0.01, n_iterations=4, seed=2)
    mesh = get_mesh(2, 4, device="cpu")
    assert als.model_padded_n(cfg, mesh) == 32
    R = als.synthesize_rank_k(cfg)
    res = als.fit(mesh, cfg, R)
    assert res.V.shape == (30, 3) and res.U.shape == (24, 3)
    base = als.fit(get_mesh(4, 1, device="cpu"), cfg, R)
    np.testing.assert_allclose(res.final_rmse, base.final_rmse, rtol=1e-3,
                               atol=1e-5)


def test_unpadded_r_disengages_with_a_warning():
    """``make_fit_fn`` handed an R whose columns the model axis does not
    divide warns, holds V whole and still fits (JAX
    ``tests/test_data.py:347``)."""
    cfg = als.ALSConfig(m=8, n=30, k=3, n_iterations=1)
    fn = als.make_fit_fn(get_mesh(2, 4, device="cpu"), cfg)
    R = torch.as_tensor(als.synthesize_rank_k(cfg))
    V0 = torch.as_tensor(
        np.random.default_rng(0).random((30, 3), dtype=np.float32))
    with pytest.warns(UserWarning, match="DISENGAGED"):
        U, V, errs = fn(R, torch.zeros((8, 3)), V0)
    assert V.shape == (30, 3) and bool(torch.isfinite(errs).all())


@pytest.mark.parametrize("n", [512, 500])
def test_model_axis_converges_without_ridge(n):
    """n = 512 and 500 (padded to 504) on 2×4 at lam=0 reach exact
    recovery (JAX ``tests/test_workloads.py:263-278``)."""
    cfg = als.ALSConfig(m=64, n=n, k=8, n_iterations=6, lam=0.0)
    res = als.fit(get_mesh(2, 4, device="cpu"), cfg)
    assert res.final_rmse < 1e-2
    assert res.V.shape == (n, 8)


def test_segmented_fit_equals_straight_bitwise(tmp_path):
    """Six sweeps in segments of two, stopped after the first segment
    and resumed, equal a straight run bit for bit (JAX
    ``tests/test_checkpoint_resume.py:174``); the artifact holds U and V
    at their padded shapes."""
    mesh = get_mesh(2, 4, device="cpu")
    cfg = als.ALSConfig(m=63, n=198, k=8, n_iterations=6)
    straight = als.fit(mesh, cfg)
    d = str(tmp_path / "als")
    first = als.fit(mesh, dataclasses.replace(cfg, n_iterations=2),
                    checkpoint_dir=d, checkpoint_every=2)
    assert checkpoint.latest_step(d) == 2
    np.testing.assert_array_equal(first.rmse_history.numpy(),
                                  straight.rmse_history.numpy()[:2])
    seg = als.fit(mesh, cfg, checkpoint_dir=d, checkpoint_every=2)
    for a, b in ((straight.U, seg.U), (straight.V, seg.V),
                 (straight.rmse_history, seg.rmse_history)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    payload, step = checkpoint.restore(d)
    assert step == 6 and payload["tag"] == "als"
    U, V = payload["state"]
    assert U.shape == (64, 8) and V.shape == (200, 8)
    assert np.array_equal(U[:63], seg.U.numpy()) and not U[63:].any()
    assert np.array_equal(V[:198], seg.V.numpy()) and not V[198:].any()


# ------------------------------------ C7: a checkpoint directory reused


def _c7_cfg(**kw):
    return als.ALSConfig(m=20, n=30, k=4, **kw)


def test_refit_with_fewer_sweeps_into_a_used_directory_raises(tmp_path,
                                                              cpu1):
    """C7: a second fit into a directory that holds a later checkpoint
    used to write its own beside it, so serving restored the first run's
    newer step. It raises with the JAX package's words, and leaves the
    directory as it was."""
    d = str(tmp_path)
    als.fit(cpu1, _c7_cfg(n_iterations=4), checkpoint_dir=d)
    with pytest.raises(ValueError, match="at step 4, past n_iterations=2"):
        als.fit(cpu1, _c7_cfg(n_iterations=2, seed=5), checkpoint_dir=d)
    assert sorted(os.listdir(d)) == ["step_4.npz"]


@pytest.mark.parametrize("other", ["tag", "shape", "mesh"])
def test_refit_over_another_checkpoint_is_incompatible(tmp_path, cpu1,
                                                       other):
    """C7: a checkpoint of another workload, of another rank, or written
    from a 2×4 mesh (U's rows padded to 2, V's to 4) raises
    ``run_segmented``'s "incompatible" error on a 1×1 resume."""
    d = str(tmp_path)
    cfg = als.ALSConfig(m=21, n=30, k=4, n_iterations=1)
    if other == "tag":
        checkpoint.save(d, "kmeans_fixed", [np.zeros((21, 4), np.float32),
                                            np.zeros((30, 4), np.float32)],
                        step=1, accs=np.zeros(1, np.float32))
    elif other == "shape":
        als.fit(cpu1, dataclasses.replace(cfg, k=3), checkpoint_dir=d)
    else:
        als.fit(get_mesh(2, 4, device="cpu"), cfg, checkpoint_dir=d)
    with pytest.raises(ValueError, match="incompatible"):
        als.fit(cpu1, dataclasses.replace(cfg, n_iterations=3),
                checkpoint_dir=d)


def test_refit_into_its_own_directory_resumes(tmp_path, cpu1):
    """C7: a checkpoint at a step <= n_iterations resumes; the newest
    file is the run's own, and it serves the resumed factors."""
    d = str(tmp_path)
    straight = als.fit(cpu1, _c7_cfg(n_iterations=5))
    als.fit(cpu1, _c7_cfg(n_iterations=3), checkpoint_dir=d,
            checkpoint_every=3)
    res = als.fit(cpu1, _c7_cfg(n_iterations=5), checkpoint_dir=d,
                  checkpoint_every=3)
    np.testing.assert_array_equal(res.V.numpy(), straight.V.numpy())
    payload, step = checkpoint.restore(d)
    assert step == 5
    np.testing.assert_array_equal(payload["state"][1], straight.V.numpy())


def test_unported_backends_name_their_item():
    """``fit_rowstore`` (V in the cluster's row store; held to JAX's in
    ``tests/test_torch_rowstore.py``) and ``fit_streamed`` (A10's rows,
    ``tests/test_torch_data.py``) run: the smallest fit of each."""
    from tpu_distalg_torch.data import builders

    ds, _ = builders.rank_k_rows_dataset(get_mesh(device="cpu"), 16, 8, 2,
                                         block_rows=4, backend="virtual")
    res = als.fit_streamed(ds, als.ALSConfig(k=2, n_iterations=2))
    assert res.U.shape == (16, 2) and res.rmse_history.shape == (2,)
    got = als.fit_rowstore(als.ALSConfig(m=16, n=40, k=2, n_iterations=2),
                           density=0.2, user_block=4, device="cpu")
    assert got["U"].shape == (16, 2) and got["V"].shape == (40, 2)
    assert got["rmse_history"].shape == (2,)
    assert np.isfinite(got["rmse_history"]).all()
