"""Kernel B5's plain version (``ssgd_kernels.grad_sum_packed_reference``)
and the ``fused`` sampler of ``tpu_distalg_torch/models/ssgd.py`` on the
CPU.

The JAX kernel (``pallas_kernels.fused_grad_sum_packed``) draws its
Bernoulli mask from the TPU's on-core generator and has no interpret
mode, so its bits exist only on a TPU. The port draws the mask with
threefry, keyed ``(uint32(t), uint32(shard))`` with the row's index in
the shard as the counter, so these tests hold the port to what the JAX
package can compute here: its ``logistic.grad_sum`` fed the port's own
mask, and the contract of the JAX package's TPU test (the gradient is
an unbiased estimate of frac × the full gradient). On the CPU the
wrapper runs the plain version.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_distalg.ops import logistic as jlogistic
from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.ops import ssgd_kernels as tk
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import datasets, prng
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAC = 0.1


@pytest.fixture(scope="module")
def data():
    return datasets.breast_cancer_split()


def _packed(n, d, dtype, pack=16, block=512, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    X2, meta = tk.pack_augmented(X, y, np.ones(n, np.float32), dtype=dtype,
                                 pack=pack, block_rows=block, device="cpu")
    w = np.zeros(meta["d_total"], np.float32)
    w[:d] = rng.normal(size=d).astype(np.float32) * 0.1
    kw = dict(pack=pack, d_total=meta["d_total"], y_col=meta["y_col"],
              v_col=meta["v_col"], block_rows=block)
    return X, y, X2, meta, torch.as_tensor(w), kw


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2.0**-8)])
@pytest.mark.parametrize("n,d,t,shard", [(3000, 30, 5, 0), (700, 61, 1541, 3)])
def test_gradient_equals_jax_grad_sum_under_the_ports_mask(n, d, t, shard,
                                                           dtype, tol):
    """float32: rtol 1e-5 of the largest entry (the two add in other
    orders). bfloat16: JAX gets the upcast values and keeps a float32
    residual, the port rounds each residual to bf16 (relative 2⁻⁹ at
    most), so the gradient is held to 2⁻⁸ of its largest entry."""
    X, y, X2, meta, w, kw = _packed(n, d, dtype, seed=n)
    g, cnt = tk.fused_grad_sum_packed(X2, w, t, shard, fraction=FRAC, **kw)
    n_t = meta["n_padded"]
    keep = tk.packed_keep_mask(t, shard, n_t, FRAC)
    rows = X2.reshape(n_t, -1).to(torch.float32).numpy()
    valid = rows[:, meta["v_col"]]
    mask = keep.numpy().astype(np.float32) * valid
    wq = w.to(X2.dtype).to(torch.float32).numpy()
    want_g, want_c = jlogistic.grad_sum(
        jnp.asarray(rows[:, :d]), jnp.asarray(rows[:, meta["y_col"]]),
        jnp.asarray(wq[:d]), jnp.asarray(mask))
    assert g.shape == (meta["d_total"],) and g.dtype == torch.float32
    assert float(cnt) == float(want_c) == float(mask.sum())
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(g.numpy()[:d], want_g, rtol=0,
                               atol=tol * float(np.abs(want_g).max()))
    # pad rows (valid 0) are never counted, whatever their bits
    assert float(mask[n:].sum()) == 0.0 and keep[n:].any()


def test_mask_is_prng_bits_under_the_documented_key():
    """Row i is kept iff element i of prng.bits under the key
    (uint32(t), uint32(shard)) is below min(int(frac·2³²), 2³² − 1)."""
    t, shard, n = 1541, 3, 5000
    key = torch.tensor([t, shard], dtype=torch.int64)
    want = prng.bits(key, (n,)) < int(FRAC * 2.0**32)
    assert torch.equal(tk.packed_keep_mask(t, shard, n, FRAC), want)
    # the words are 32-bit: t and shard wrap
    assert torch.equal(tk.packed_keep_mask(t + 2**32, shard - 2**32, n,
                                           FRAC), want)
    assert tk.packed_threshold(1.0) == 2**32 - 1
    assert tk.packed_threshold(0.0) == 0
    assert not tk.packed_keep_mask(t, shard, n, 0.0).any()
    # a prefix of a longer draw: the mask of a row does not depend on
    # how many rows follow it
    assert torch.equal(tk.packed_keep_mask(t, shard, 2 * n, FRAC)[:n], want)


@pytest.mark.parametrize("frac", [0.03, 0.1, 0.5])
def test_kept_fraction_within_four_sigma(frac):
    n = 200_000
    kept = float(tk.packed_keep_mask(7, 0, n, frac).sum())
    assert abs(kept - frac * n) < 4 * np.sqrt(frac * (1 - frac) * n)


def test_masks_differ_across_steps_and_shards_and_replay():
    n = 4096
    base = tk.packed_keep_mask(10, 0, n, FRAC)
    assert torch.equal(base, tk.packed_keep_mask(10, 0, n, FRAC))
    for t, shard in ((11, 0), (10, 1), (0, 10)):
        other = tk.packed_keep_mask(t, shard, n, FRAC)
        # two independent Bernoulli(0.1) masks share about 1% of rows
        assert float((base & other).sum()) < 0.03 * n
        assert not torch.equal(base, other)


def test_gradient_is_an_unbiased_estimate():
    """The JAX TPU test's contract (tests_tpu/test_tpu_numerics.py):
    the mean of g/count over many steps is the full-batch mean gradient
    within 20 standard errors."""
    n, d, T = 1 << 13, 30, 300
    X, y, X2, meta, w, kw = _packed(n, d, "float32", block=8192)
    acc = torch.zeros(meta["d_total"])
    for t in range(T):
        g, cnt = tk.fused_grad_sum_packed(X2, w, t, 0, fraction=FRAC, **kw)
        acc += g / torch.clamp_min(cnt, 1.0)
    g_full, cnt = jlogistic.grad_sum(jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(w.numpy()[:d]),
                                     jnp.ones(n))
    se = float(np.std(X) * 0.5 / np.sqrt(FRAC * n * T))
    np.testing.assert_allclose((acc / T).numpy()[:d],
                               np.asarray(g_full / cnt), atol=20 * se)


def test_wrapper_checks_its_contract():
    _, _, X2, meta, w, kw = _packed(700, 30, "float32")
    with pytest.raises(ValueError, match="fraction"):
        tk.fused_grad_sum_packed(X2, w, 0, 0, fraction=1.5, **kw)
    with pytest.raises(ValueError, match="incompatible"):
        tk.fused_grad_sum_packed(X2[:3], w, 0, 0, fraction=FRAC, **kw)
    with pytest.raises(ValueError, match="w_aug"):
        tk.fused_grad_sum_packed(X2, w[:5], 0, 0, fraction=FRAC, **kw)


def _train(data, n_shards, config, **kw):
    return ssgd.train(*data, get_mesh(data=n_shards, device="cpu"), config,
                      **kw)


@pytest.mark.parametrize("n_shards,x_dtype", [(1, "float32"), (4, "float32"),
                                              (1, "bfloat16")])
def test_fused_sampler_reaches_the_reference_band(data, n_shards, x_dtype):
    """bench.py's convergence schedule for this sampler: 1500 steps at
    the defaults; the JAX package holds it to >= 0.92 on a TPU (the
    reference reaches 0.929825)."""
    res = _train(data, n_shards, ssgd.SSGDConfig(
        n_iterations=1500, sampler="fused", x_dtype=x_dtype))
    assert res.accs.shape == (1500,) and res.w.shape == (31,)
    assert res.final_acc >= 0.92, res.final_acc


def test_fused_sampler_segmented_equals_straight(data, tmp_path):
    """The mask keys off the absolute step, so a checkpointed run (and
    a resume from its middle) equals a straight one bit for bit."""
    cfg = ssgd.SSGDConfig(n_iterations=60, sampler="fused", eval_every=7)
    straight = _train(data, 1, cfg)
    seg = _train(data, 1, cfg, checkpoint_dir=str(tmp_path),
                 checkpoint_every=25)
    np.testing.assert_array_equal(seg.w.numpy(), straight.w.numpy())
    np.testing.assert_array_equal(seg.accs.numpy(), straight.accs.numpy())
    mid = tmp_path / "mid"
    _train(data, 1, dataclasses.replace(cfg, n_iterations=40),
           checkpoint_dir=str(mid), checkpoint_every=20)
    resumed = _train(data, 1, cfg, checkpoint_dir=str(mid),
                     checkpoint_every=20)
    np.testing.assert_array_equal(resumed.w.numpy(), straight.w.numpy())


def test_fused_sampler_draws_per_shard_and_seed(data):
    """Shards draw their own masks (another shard count, another
    trajectory), and the seed moves the draw."""
    # 64-row blocks: four shards of 128 rows each hold real rows (at the
    # default 8192 the 398 rows all sit in shard 0, which draws alike)
    cfg = ssgd.SSGDConfig(n_iterations=20, sampler="fused", eval_test=False,
                          fused_pack=4, fused_block_rows=64)
    one = _train(data, 1, cfg).w
    assert not torch.equal(one, _train(data, 4, cfg).w)
    assert not torch.equal(
        one, _train(data, 1, dataclasses.replace(cfg, seed=43)).w)
    assert torch.equal(one, _train(data, 1, cfg).w)
    with pytest.raises(ValueError, match="make_train_fn_fused"):
        ssgd.make_train_fn(get_mesh(data=1, device="cpu"), cfg, 512)


def test_cli_ssgd_sampler_fused(data):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
         "ssgd", "--sampler", "fused", "--n-iterations", "40", "--quiet"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    want = _train(data, 1, ssgd.SSGDConfig(n_iterations=40, sampler="fused"))
    lines = out.stdout.strip().splitlines()
    assert lines[0] == f"Final acc: {want.final_acc:.6f}"
    assert lines[1].startswith("[ssgd] 40 iterations in ")
