"""The port's virtual SSGD (``tpu_distalg_torch/models/ssgd_virtual.py``:
rows regenerated from their ids every step, nothing resident) against
the JAX package's ``ssgd_virtual`` on the CPU.

Standards. Block draws and held-out ids equal JAX's exactly; generated
rows within the synthesis standard of ``tests/test_torch_ssgd_fixed.py``
(the port's normals sit a few ulp from JAX's); weights after 40 steps
within 1e-4 of the largest |w| with equal accuracy histories (ROADMAP
C's SSGD standard). Within the port, runs replay and resume bit for bit.
"""

from __future__ import annotations

import os
import dataclasses

import numpy as np
import pytest
import torch

from tpu_distalg.models import ssgd as jssgd
from tpu_distalg.models import ssgd_virtual as jvirtual
from tpu_distalg_torch.models import ssgd, ssgd_virtual
from tpu_distalg_torch.ops import logistic
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import datasets, prng
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))


def _cfg(**kw):
    base = dict(n_iterations=300, sampler="virtual", eta=0.5,
                mini_batch_fraction=0.05, gather_block_rows=256,
                eval_every=50)
    base.update(kw)
    return ssgd.SSGDConfig(**base)


def _mesh(n):
    return get_mesh(data=n, device="cpu")


@pytest.mark.parametrize("n_rows,shards", [(65536, 4), (10_001, 8)],
                         ids=["65536-rows-4-shards", "odd-rows-8-shards"])
def test_virtual_matches_jax(n_rows, shards, mesh4, mesh8):
    """40 steps against the JAX package's run: weights within 1e-4 of
    the largest |w|, accuracy histories equal. The odd row count pads
    the last blocks; padded ids are masked in both."""
    cfg = _cfg(n_iterations=40, eval_every=10)
    kw = dict(n_rows=n_rows, n_features=20, data_seed=0)
    got = ssgd_virtual.train(_mesh(shards), cfg,
                             ssgd_virtual.VirtualData(**kw), n_test=512)
    want = jvirtual.train(mesh4 if shards == 4 else mesh8,
                          jssgd.SSGDConfig(**dataclasses.asdict(cfg)),
                          jvirtual.VirtualData(**kw), n_test=512)
    w = np.asarray(want.w)
    assert np.abs(got.w.numpy() - w).max() <= 1e-4 * np.abs(w).max()
    np.testing.assert_array_equal(got.accs.numpy(), np.asarray(want.accs))


def test_virtual_geometry_and_heldout_equal_jax():
    """The block grid, the int32 refusal's reach and the held-out rows:
    ids at 2³¹ − 1 − n_test up, past every training id."""
    cfg = _cfg(mini_batch_fraction=0.01, gather_block_rows=131072)
    data = ssgd_virtual.VirtualData(n_rows=10 ** 9, n_features=30)
    jdata = jvirtual.VirtualData(n_rows=10 ** 9, n_features=30)
    jcfg = jssgd.SSGDConfig(**dataclasses.asdict(cfg))
    assert ssgd_virtual._geometry(cfg, data, 1) == jvirtual._geometry(
        jcfg, jdata, 1) == (1_000_079_360, 7630, 76)
    X, y = ssgd_virtual.heldout_set(data, 64)
    jX, jy = jvirtual.heldout_set(jdata, 64)
    jX = np.asarray(jX)
    assert X.shape == (64, 31) and bool((X[:, -1] == 1).all())
    tol = 1e-6 * (1 + np.abs(jX)) + 4 * 2.0 ** -24 * np.sqrt(
        np.pi / 2) * np.exp(np.minimum(jX.astype(np.float64) ** 2 / 2, 80))
    assert (np.abs(X.numpy() - jX) <= tol).all()
    ids = torch.arange(64) + (2 ** 31 - 1 - 64)
    make_rows = datasets.synthetic_two_class_rows(30)
    assert torch.equal(make_rows(ids)[1], y)
    assert int((y.numpy() != np.asarray(jy)).sum()) <= 1


def test_virtual_converges_and_is_deterministic():
    data = ssgd_virtual.VirtualData(n_rows=65536, n_features=20, data_seed=0)
    res = ssgd_virtual.train(_mesh(8), _cfg(n_iterations=100), data)
    assert res.final_acc > 0.7   # the Bayes band at separation 2 is ~0.8
    res2 = ssgd_virtual.train(_mesh(8), _cfg(n_iterations=100), data)
    assert torch.equal(res.w, res2.w)


def test_virtual_segmented_run_is_bitwise():
    """Sampling keys on the absolute step, so 30 + 30 steps with the
    weights carried equal 60 straight steps bit for bit."""
    data = ssgd_virtual.VirtualData(n_rows=32768, n_features=16, data_seed=1)
    X_t, y_t = ssgd_virtual.heldout_set(data, 512)
    w0 = logistic.init_weights(prng.root_key(7), data.d)
    fn = ssgd_virtual.make_train_fn(_mesh(8), _cfg(n_iterations=60), data)
    w_straight, _ = fn(None, None, None, X_t, y_t, w0)
    half = ssgd_virtual.make_train_fn(_mesh(8), _cfg(n_iterations=30), data)
    w_a, _ = half(None, None, None, X_t, y_t, w0, t0=0)
    w_b, _ = half(None, None, None, X_t, y_t, w_a, t0=30)
    assert torch.equal(w_straight, w_b)


def test_virtual_odd_row_count_masks_padding():
    """Every block sampled on a row count off the grid: the padded ids
    are masked, so each step counts exactly the logical rows."""
    data = ssgd_virtual.VirtualData(n_rows=10_001, n_features=8, data_seed=2)
    cfg = _cfg(n_iterations=20, mini_batch_fraction=1.0)
    res = ssgd_virtual.train(_mesh(8), cfg, data, n_test=256)
    assert bool(torch.isfinite(res.w).all())
    counts = []
    fn = ssgd_virtual.make_train_fn(_mesh(8), dataclasses.replace(
        cfg, n_iterations=1, eta=0.0), data)
    orig = logistic.grad_sum

    def spy(X, y, w, mask):
        counts.append(float(mask.sum()))
        return orig(X, y, w, mask)

    logistic.grad_sum = spy
    try:
        fn(None, None, None, *ssgd_virtual.heldout_set(data, 8),
           torch.zeros(data.d))
    finally:
        logistic.grad_sum = orig
    assert len(counts) == 8 and sum(counts) == 10_001


def test_virtual_coarse_fraction_warns():
    data = ssgd_virtual.VirtualData(n_rows=8 * 256 * 50, n_features=8)
    with pytest.warns(UserWarning, match="quantizes the minibatch"):
        ssgd_virtual.make_train_fn(_mesh(8), _cfg(mini_batch_fraction=0.01),
                                   data)


def test_virtual_rejects_wrong_sampler(mesh8):
    """The virtual builder takes sampler='virtual' only, and the resident
    builders refuse 'virtual', in the JAX package's words."""
    with pytest.raises(ValueError, match="sampler") as got:
        ssgd_virtual.make_train_fn(
            _mesh(8), ssgd.SSGDConfig(sampler="fused_gather"),
            ssgd_virtual.VirtualData(n_rows=1024))
    with pytest.raises(ValueError) as want:
        jvirtual.make_train_fn(mesh8, jssgd.SSGDConfig(sampler="fused_gather"),
                               jvirtual.VirtualData(n_rows=1024))
    assert str(got.value) == str(want.value)
    X, y, Xt, yt = datasets.breast_cancer_split()
    with pytest.raises(ValueError, match="unknown sampler 'virtual'"):
        ssgd.train(X, y, Xt, yt, _mesh(1),
                   ssgd.SSGDConfig(n_iterations=2, sampler="virtual"))


def test_virtual_rejects_int32_overflow(mesh8):
    """Past ~2.1B padded rows the JAX package's int32 ids would wrap; the
    port keeps its refusal, in its words."""
    with pytest.raises(ValueError, match="int32") as got:
        ssgd_virtual.make_train_fn(
            _mesh(8), _cfg(), ssgd_virtual.VirtualData(n_rows=3_000_000_000))
    with pytest.raises(ValueError) as want:
        jvirtual.make_train_fn(
            mesh8, jssgd.SSGDConfig(**dataclasses.asdict(_cfg())),
            jvirtual.VirtualData(n_rows=3_000_000_000))
    assert str(got.value) == str(want.value)
    edge = ssgd_virtual.MAX_PADDED_ROWS - 256   # a grid just under it
    ssgd_virtual.make_train_fn(_mesh(1), _cfg(mini_batch_fraction=1e-6),
                               ssgd_virtual.VirtualData(n_rows=edge))
