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

import os

import numpy as np
import pytest
import torch

from tpu_distalg.models import als as jals
from tpu_distalg.ops import linalg as jlinalg
from tpu_distalg_torch.models import als
from tpu_distalg_torch.ops import linalg
from tpu_distalg_torch.utils import checkpoint, device


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
    G_p = linalg.gram(torch.as_tensor(F), 0.01, 50).numpy()
    np.testing.assert_allclose(G_p, G_j, rtol=1e-5)
    S_j = np.asarray(jlinalg.solve_factor_block(G_j, F, R))
    S_p = linalg.solve_factor_block(torch.as_tensor(G_j), torch.as_tensor(F),
                                    torch.as_tensor(R)).numpy()
    np.testing.assert_allclose(S_p, S_j, rtol=1e-5,
                               atol=1e-5 * np.abs(S_j).max())
    e_j = float(jlinalg.rmse(R, U, F))
    e_p = float(linalg.rmse(torch.as_tensor(R), torch.as_tensor(U),
                            torch.as_tensor(F)))
    assert e_p == pytest.approx(e_j, rel=1e-5)


def test_fit_matches_jax_with_ridge(mesh1):
    jc, pc = _cfgs(0.01)
    j = jals.fit(mesh1, jc)
    p = als.fit(pc, device="cpu")
    np.testing.assert_allclose(p.rmse_history.numpy(),
                               np.asarray(j.rmse_history), rtol=1e-4)
    for mine, ref in ((p.U, j.U), (p.V, j.V)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_fit_matches_jax_exact_recovery_without_ridge(mesh1):
    jc, pc = _cfgs(0.0)
    R = als.synthesize_rank_k(pc)
    rms = float(np.sqrt(np.mean(np.square(R, dtype=np.float64))))
    j = jals.fit(mesh1, jc)
    p = als.fit(pc, device="cpu")
    for hist in (np.asarray(j.rmse_history), p.rmse_history.numpy()):
        assert hist.shape == (3,)
        assert np.all(hist < 1e-3 * rms)
    for U, V in ((np.asarray(j.U), np.asarray(j.V)),
                 (p.U.numpy(), p.V.numpy())):
        assert np.abs(U @ V.T - R).max() < 1e-3 * np.abs(R).max()


def test_fit_saves_the_serving_artifact(tmp_path):
    cfg = als.ALSConfig(m=20, n=30, k=4, n_iterations=2)
    res = als.fit(cfg, device="cpu", checkpoint_dir=str(tmp_path))
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
        als.fit(als.ALSConfig(m=8, n=8, k=2, n_iterations=1))
    assert device.resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
