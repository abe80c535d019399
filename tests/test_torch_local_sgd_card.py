"""The local-update family (``tpu_distalg_torch/models/local_sgd.py``) on
the card, through kernels B1 and B2. Imports neither jax nor
``tpu_distalg``, so it also runs on a machine with only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_local_sgd_card.py

Without a card the tests skip (a CUDA kernel has no CPU mode); the CPU
port is held to the JAX package in ``tests/test_torch_local_sgd.py``.
A ``fused_train`` round is R launches of B2 in turn on one stream, each
with its own start and the round's center as the elastic pull's
target, on B2's one cached workspace: the card runs are held to the
same trainer on the CPU (the plain B2 per replica) within 1e-5 of the
largest entry in float32 and 1e-3 in bfloat16 (a residual rounded to
bf16 can land one bf16 ulp apart after float32 sums in two orders, and
later steps carry that), and a fixed seed replays bit for bit.
"""

from __future__ import annotations

import os
import dataclasses

import numpy as np
import pytest
import torch

from tpu_distalg_torch.models import bmuf, easgd, local_sgd, ma
from tpu_distalg_torch.ops import ssgd_kernels as tk
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

ROWS, FEATURES, GBR, PACK, ROUNDS = 65536, 30, 1024, 16, 3
TOL = {"float32": 1e-5, "bfloat16": 1e-3}


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _close(got, want, rel):
    tol = rel * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol, f"max |err| {err} > {tol}"


def _setup(dev, config, n_replicas):
    """The trainer, packed rows and initial state on ``dev``."""
    X, y = datasets.synthetic_two_class(ROWS, FEATURES, seed=0)
    mesh = get_mesh(data=n_replicas, device=dev)
    fn, X2, w0, ws0, d0, meta = local_sgd.prepare_fused(X, y, mesh, config)
    te = (torch.zeros((1, meta["d_total"]), device=dev),
          torch.zeros((1,), device=dev))
    return lambda: fn(X2, *te, w0, ws0, d0)


def _config(mod, cls, sampler, x_dtype, **kw):
    return getattr(mod, cls)(
        n_iterations=ROUNDS, sampler=sampler, x_dtype=x_dtype,
        fused_pack=PACK, gather_block_rows=GBR, shuffle_seed=0,
        eval_test=False, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mod,cls", [(ma, "MAConfig"), (bmuf, "BMUFConfig"),
                                     (easgd, "EASGDConfig")])
def test_fused_train_on_four_replicas_equals_the_plain_b2(mod, cls, x_dtype,
                                                          cuda_device):
    """Three rounds of 5 local steps (EASGD: with α = 0.01 and no resync)
    on 4 replicas: the card's center and replicas against the same
    trainer on the CPU, where each replica's round is the plain B2; then
    the card run again, bit for bit."""
    cfg = _config(mod, cls, "fused_train", x_dtype, n_local_iterations=5)
    card = _setup(cuda_device, cfg, 4)
    w, ws, delta, _ = card()
    cw, cws, cdelta, _ = _setup("cpu", cfg, 4)()
    for got, want in ((w, cw), (ws, cws), (delta, cdelta)):
        _close(got.cpu(), want, TOL[x_dtype])
    w2, ws2, _, _ = card()
    assert torch.equal(w, w2) and torch.equal(ws, ws2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_for_replicas_in_turn_on_one_stream(dtype, cuda_device):
    """B2 for 4 replicas with different starts, centers, pulls and step
    counts, one after another on one stream (its cached workspace), each
    against the plain version; then in the reverse order, bit for bit
    the first results."""
    X, y = datasets.synthetic_two_class(ROWS, FEATURES, seed=1)
    X2, meta = tk.pack_augmented(X, y, np.ones(ROWS, np.float32),
                                 dtype=dtype, pack=PACK, block_rows=GBR,
                                 device=cuda_device)
    kw = dict(pack=PACK, d_total=meta["d_total"], y_col=meta["y_col"],
              v_col=meta["v_col"], gather_block_rows=GBR)
    n_blocks, d = meta["n_padded"] // GBR, FEATURES
    rng = np.random.default_rng(2)
    calls = []
    for T, n_s, alpha in ((5, 6, 0.0), (1, 2, 0.01),
                          (9, 13, 0.3), (5, 1, 0.01)):
        w0 = torch.zeros(meta["d_total"], device=cuda_device)
        ctr = torch.zeros_like(w0)
        w0[:d] = torch.as_tensor(rng.uniform(-1, 1, d).astype(np.float32))
        ctr[:d] = torch.as_tensor(rng.uniform(-1, 1, d).astype(np.float32))
        ids = torch.as_tensor(np.stack([
            rng.permutation(n_blocks)[:n_s] for _ in range(T)]).astype(
                np.int32), device=cuda_device)
        calls.append((w0, ctr, ids, alpha))
    first = []
    for w0, ctr, ids, alpha in calls:
        got = tk.fused_train_gathered(X2, w0, ids, eta=0.1, alpha=alpha,
                                      center=ctr, **kw)
        want = tk.train_gathered_reference(X2, w0, ids, eta=0.1,
                                           alpha=alpha, center=ctr, **kw)
        _close(got, want, 1e-5 if dtype == torch.float32 else 1e-3)
        first.append(got)
    for (w0, ctr, ids, alpha), want in list(zip(calls, first))[::-1]:
        assert torch.equal(tk.fused_train_gathered(
            X2, w0, ids, eta=0.1, alpha=alpha, center=ctr, **kw), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_replicas", [1, 4])
@pytest.mark.parametrize("sampler", ["fused_gather", "fused_train"])
def test_launch_counts_and_replay(sampler, n_replicas, cuda_device):
    """MA launches B1 R·L times a round on ``fused_gather`` and B2 R
    times on ``fused_train``, and no other kernel of the module; a fixed
    seed replays bit for bit; ``fused_train`` is within atol 1e-3 of
    ``fused_gather`` (the JAX package's standard)."""
    cfg = _config(ma, "MAConfig", sampler, "bfloat16")
    run = _setup(cuda_device, cfg, n_replicas)
    run()
    torch.cuda.synchronize()
    for k in tk.KERNELS:
        k.launches = 0
    w, ws, _, _ = run()
    torch.cuda.synchronize()
    L = cfg.n_local_iterations
    want = {"fused_grad_sum_gathered": n_replicas * L * ROUNDS
            if sampler == "fused_gather" else 0,
            "fused_train_gathered": n_replicas * ROUNDS
            if sampler == "fused_train" else 0}
    assert {k.__name__: k.launches for k in tk.KERNELS} == {
        k.__name__: want.get(k.__name__, 0) for k in tk.KERNELS}
    w2, ws2, _, _ = run()
    assert torch.equal(w, w2) and torch.equal(ws, ws2)
    other = "fused_gather" if sampler == "fused_train" else "fused_train"
    wo, wso, _, _ = _setup(cuda_device, dataclasses.replace(
        cfg, sampler=other), n_replicas)()
    torch.testing.assert_close(w, wo, rtol=0, atol=1e-3)
    torch.testing.assert_close(ws, wso, rtol=0, atol=1e-3)
