"""SSGD's scale data paths on the card: the on-device synthesis of the
two-class rows, the ``fixed`` sampler, and kernel B1 on an X2 past 2³¹
elements. Imports neither jax nor ``tpu_distalg``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scale_card.py

Without a card the tests skip (a CUDA kernel has no CPU mode); the CPU
port is held to the JAX package in ``tests/test_torch_ssgd_fixed.py``.
Standards: synthetic X within 1e-6 absolute and relative plus 4 ulp of
the uniform carried through erfinv's slope, as on the CPU against JAX
(torch's float32 ``log1p`` on the card may sit an ulp from the CPU's,
and near |u| = 1 erfinv magnifies that); y equal apart from rows whose
margin is within 1e-4 of 0; integer draws bitwise; 5 ``fixed`` steps
within 1e-5 of the largest weight; B1 within 1e-5 of the largest entry
of the plain version's gradient (its float32 sums run in another
order), the count exact, and bit for bit on a replay.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.ops import sampling
from tpu_distalg_torch.ops import ssgd_kernels as tk
from tpu_distalg_torch.parallel import get_mesh, parallelize
from tpu_distalg_torch.utils import datasets, prng
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

ROW_TOL, UNIFORM_ULPS, MARGIN = 1e-6, 4, 1e-4


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _exempt(ids: torch.Tensor) -> np.ndarray:
    """Rows whose label may flip: |margin| <= MARGIN on the CPU."""
    X, _ = datasets.synthetic_two_class_rows(30, 0)(ids)
    w_true = prng.normal(prng.fold_in(prng.root_key(0), 0), (30,))
    noise = prng.logistic(prng.fold_in(prng.fold_in(prng.fold_in(
        prng.root_key(0), 1), ids), 7), ())
    margin = (X @ w_true).numpy() * (2.0 / np.sqrt(30.0)) + noise.numpy()
    return np.abs(margin) <= MARGIN


def _tol(v: np.ndarray) -> np.ndarray:
    slope = np.sqrt(np.pi / 2) * np.exp(np.minimum(
        v.astype(np.float64) ** 2 / 2, 80.0))
    return ROW_TOL * (1 + np.abs(v)) + UNIFORM_ULPS * 2.0**-24 * slope


@pytest.mark.gpu
@pytest.mark.parametrize("lo", [0, 99_995_904])
def test_synthetic_rows_on_the_card_match_the_cpu(lo, cuda_device):
    make_rows = datasets.synthetic_two_class_rows(30, 0)
    ids = torch.arange(lo, lo + 4096, dtype=torch.int64)
    Xc, yc = make_rows(ids.to(cuda_device))
    Xh, yh = make_rows(ids)
    Xc, Xh = Xc.cpu().numpy(), Xh.numpy()
    assert (np.abs(Xc - Xh) <= _tol(Xh)).all()
    assert ((yc.cpu().numpy() == yh.numpy()) | _exempt(ids)).all()


@pytest.mark.gpu
def test_prepare_fused_synthetic_on_the_card(cuda_device):
    """The packed rows on the card: the layout and meta of the CPU
    port's, the bias, valid and padding columns exactly, X within the
    tolerance once both are rounded to bf16 (one bf16 ulp)."""
    cfg = ssgd.SSGDConfig(sampler="fused_gather", gather_block_rows=1024,
                          x_dtype="bfloat16", eval_test=False)
    _, X2c, w0c, mc = ssgd.prepare_fused_synthetic(
        20000, 30, get_mesh(2, device=cuda_device), cfg)
    _, X2h, w0h, mh = ssgd.prepare_fused_synthetic(
        20000, 30, get_mesh(2, device="cpu"), cfg)
    assert mc == mh and X2c.shape == X2h.shape
    assert torch.equal(w0c.cpu(), w0h)
    rc = X2c.view(-1, mc["d_total"]).float().cpu()
    rh = X2h.view(-1, mh["d_total"]).float()
    yc = mc["y_col"]
    assert torch.equal(rc[:, 30:yc], rh[:, 30:yc])
    assert torch.equal(rc[:, yc + 1:], rh[:, yc + 1:])
    same = (rc[:, yc] == rh[:, yc]).numpy()
    assert (same | _exempt(torch.arange(rc.shape[0]))).all()
    diff = (rc[:, :30] - rh[:, :30]).abs()
    assert bool((diff <= rh[:, :30].abs() * 2.0**-7 + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 8])
def test_fixed_draws_and_steps_on_the_card_equal_the_cpu(shards,
                                                         cuda_device):
    X, y = datasets.synthetic_two_class(50000, 30, seed=1)
    X = datasets.add_bias_column(X)
    key = prng.root_key(42)
    for t in (0, 1, 77):
        n_local = -(-50000 // shards)
        b = max(1, round(0.1 * n_local))
        assert torch.equal(
            sampling.fixed_row_ids(key.to(cuda_device), t, shards, n_local,
                                   b).cpu(),
            sampling.fixed_row_ids(key, t, shards, n_local, b))
    cfg = ssgd.SSGDConfig(n_iterations=5, sampler="fixed", eval_test=False)
    out = {}
    for dev in (cuda_device, "cpu"):
        mesh = get_mesh(shards, device=dev)
        Xs, ys = parallelize(X, mesh), parallelize(y, mesh)
        fn = ssgd.make_train_fn(mesh, cfg, Xs.n_padded)
        w0 = ssgd.logistic.init_weights(prng.root_key(7, dev), 31)
        te = (torch.zeros((1, 31), device=dev), torch.zeros((1,), device=dev))
        out[str(dev)] = fn(Xs.data, ys.data, Xs.mask, *te, w0)[0].cpu()
    want = out["cpu"]
    assert float((out["cuda"] - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_b1_past_two_to_the_31_elements(cuda_device):
    """B1 on an X2 of more than 2³¹ + 2²⁰ bf16 elements (rows of 40, pack
    16: 1280-byte packed rows), the sampled blocks including the last;
    against the plain version, and bit for bit on a replay."""
    D, P, gbr = 40, 16, 8192
    n_rows = -(-((1 << 31) + (1 << 20)) // D // gbr) * gbr
    need = n_rows * D * 2
    free, _ = torch.cuda.mem_get_info(cuda_device)
    if free < 8 << 30:
        pytest.skip(f"needs 8 GB of free device memory for a {need}-byte X2 "
                    f"and its fill; {free} bytes free")
    X2 = torch.empty((n_rows // P, P * D), dtype=torch.bfloat16,
                     device=cuda_device)
    rows = X2.view(n_rows, D)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    step = 1 << 22
    for lo in range(0, n_rows, step):
        hi = min(lo + step, n_rows)
        rows[lo:hi] = torch.randn((hi - lo, D), generator=g,
                                  device=cuda_device).to(torch.bfloat16)
    rows[:, 33] = (torch.arange(n_rows, device=cuda_device) % 2).to(
        torch.bfloat16)                                  # y
    rows[:, 34] = 1.0                                    # valid
    rows[:, 35:] = 0.0
    n_blocks = n_rows // gbr
    assert X2.numel() > (1 << 31) + (1 << 20)
    cross = (1 << 31) // D // gbr   # the block holding element 2³¹
    ids = torch.tensor([n_blocks - 1, 0, n_blocks // 2, cross, n_blocks - 2,
                        n_blocks - 1],
                       dtype=torch.int32, device=cuda_device)
    w = torch.randn((D,), generator=g, device=cuda_device) * 0.1
    kw = dict(pack=P, d_total=D, y_col=33, v_col=34, gather_block_rows=gbr)
    g1, c1 = tk.fused_grad_sum_gathered(X2, w, ids, **kw)
    gr, cr = tk.grad_sum_gathered_reference(X2, w, ids, **kw)
    assert float(c1) == float(cr) == ids.numel() * gbr
    err = float((g1[:33] - gr[:33]).abs().max())
    assert err <= 1e-5 * float(gr[:33].abs().max())
    g2, c2 = tk.fused_grad_sum_gathered(X2, w, ids, **kw)
    assert torch.equal(g1, g2) and torch.equal(c1, c2)
