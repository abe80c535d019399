"""Kernels B3 and B4 (``csrc/ssgd.cu``: ``fused_forward_gathered``,
``fused_backward_gathered``) and the tp trainer on the card. Imports
neither jax nor ``tpu_distalg``, so it also runs on a machine with only
the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ssgd_tp_card.py

Without a card the tests skip (a CUDA kernel has no CPU mode); the
plain versions are held to the JAX package in
``tests/test_torch_ssgd_tp_kernels.py``.

The cases are ``chip_smoke.py``'s (D = 32, 72, 128, 4104 and 8200, pack
4 and 16, float32 and bfloat16, repeated ids, one block, padding rows
with v = 0). "exact": X in {-3..3} and integer w and residuals, so every
sum is exact in float32: outputs equal the plain version's bit for bit.
"random": normal entries, within 1e-5 of the largest entry (measured on
an H100: 5e-7). A second launch equals the first bit for bit.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import pytest
import torch

from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.ops import ssgd_kernels as tk
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

#: (dtype, rows, features, pack, gather_block_rows, block ids)
CASES = [("float32", 398, 30, 4, 32, (0, 12, 12, 3)),
         ("bfloat16", 3000, 70, 16, 512, (5,)),
         ("bfloat16", 20000, 126, 16, 2048, (9, 0, 9)),
         ("float32", 1500, 126, 4, 256, (5, 2)),
         ("bfloat16", 1000, 4102, 16, 256, (3, 1, 3)),
         ("float32", 700, 4102, 16, 128, (5,)),
         ("bfloat16", 600, 8198, 16, 128, (4, 4, 0)),
         ("float32", 600, 8198, 16, 128, (4, 2))]


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _close(got, want, kind):
    if kind == "exact":
        assert torch.equal(got, want)
        return
    tol = 1e-5 * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol, f"max |err| {err} > {tol}"


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-D{c[2] + 2}-p{c[3]}" for c in CASES])
def test_b3_b4_on_card(case, kind, cuda_device):
    dt, n, d, pack, gbr, blocks = case
    rng = np.random.default_rng(n + d)
    X = (rng.integers(-3, 4, size=(n, d)) if kind == "exact"
         else rng.normal(size=(n, d))).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    X2, meta = tk.pack_augmented(X, y, np.ones(n, np.float32), dtype=dt,
                                 pack=pack, block_rows=gbr,
                                 device=cuda_device)
    D = meta["d_total"]
    assert max(blocks) == meta["n_padded"] // gbr - 1  # a padding block
    w = np.zeros(D, np.float32)
    w[:d] = (rng.integers(-3, 4, size=d) if kind == "exact"
             else rng.normal(size=d) * 0.1)
    w = torch.as_tensor(w, device=cuda_device)
    ids = torch.as_tensor(np.asarray(blocks, np.int32), device=cuda_device)
    kw = dict(pack=pack, d_total=D, y_col=meta["y_col"],
              v_col=meta["v_col"], gather_block_rows=gbr)
    n3 = tk.fused_forward_gathered.launches
    zyv = tk.fused_forward_gathered(X2, w, ids, **kw)
    assert tk.fused_forward_gathered.launches == n3 + 1
    zr = tk.forward_gathered_reference(X2, w, ids, **kw)
    _close(zyv, zr, kind)
    assert torch.equal(zyv, tk.fused_forward_gathered(X2, w, ids, **kw))
    shape = (zr.shape[0], pack)
    r = torch.as_tensor((rng.integers(-3, 4, size=shape) if kind == "exact"
                         else rng.normal(size=shape)).astype(np.float32),
                        device=cuda_device)
    bkw = dict(pack=pack, d_total=D, gather_block_rows=gbr)
    n4 = tk.fused_backward_gathered.launches
    g = tk.fused_backward_gathered(X2, r, ids, **bkw)
    assert tk.fused_backward_gathered.launches == n4 + 1
    _close(g, tk.backward_gathered_reference(X2, r, ids, **bkw), kind)
    assert torch.equal(g, tk.fused_backward_gathered(X2, r, ids, **bkw))


#: B3 on the ring's edges: (rows, features, pack, gather_block_rows,
#: sampled blocks), in either dtype. On an H100 (132 SMs) a block's chunk
#: of rows crosses sampled-block boundaries in each, and in most is not a
#: multiple of a stage; D 512 is the ring's widest float32 row (2048
#: bytes). Their packed blocks are multiples of 8 rows, so
#: ``tests/test_torch_ssgd_tp_kernels.py`` holds the same shapes against
#: the JAX package. B3_CARD_EDGES adds pack 1, whose last stage's run of
#: zyv is not a multiple of 4 floats.
B3_EDGES = [(1300, 30, 4, 32, 40), (20000, 126, 16, 128, 150),
            (13000, 70, 16, 128, 100), (3300, 510, 4, 32, 100)]
B3_CARD_EDGES = B3_EDGES + [(3000, 126, 1, 30, 77)]


def b3_edge_case(case, dtype, kind, device):
    """(X2, w, ids, kw, n_blocks) for a B3_EDGES case: ids drawn with one
    block repeated, then -1 and n_blocks (outside [0, n_blocks))."""
    n, d, pack, gbr, n_s = case
    rng = np.random.default_rng(n_s + d)
    X = (rng.integers(-3, 4, size=(n, d)) if kind == "exact"
         else rng.normal(size=(n, d))).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    X2, meta = tk.pack_augmented(X, y, np.ones(n, np.float32), dtype=dtype,
                                 pack=pack, block_rows=gbr, device=device)
    D = meta["d_total"]
    n_blocks = meta["n_padded"] // gbr
    w = np.zeros(D, np.float32)
    w[:d] = (rng.integers(-3, 4, size=d) if kind == "exact"
             else rng.normal(size=d) * 0.1)
    ids = rng.integers(0, n_blocks, n_s)
    ids[-1] = ids[0]
    ids = np.concatenate([ids, [-1, n_blocks]]).astype(np.int32)
    kw = dict(pack=pack, d_total=D, y_col=meta["y_col"], v_col=meta["v_col"],
              gather_block_rows=gbr)
    return (X2, torch.as_tensor(w, device=device),
            torch.as_tensor(ids, device=device), kw, n_blocks)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", B3_CARD_EDGES,
                         ids=[f"D{c[1] + 2}-p{c[2]}-gbr{c[3]}"
                              for c in B3_CARD_EDGES])
def test_b3_ring_edges_on_card(case, dtype, kind, cuda_device):
    """B3 against its plain version where the ring's chunks cross
    sampled blocks and stages are part-full; a repeated block appears
    each time, and the rows of a block id outside [0, n_blocks) are
    zeros. A second launch equals the first bit for bit."""
    X2, w, ids, kw, n_blocks = b3_edge_case(case, dtype, kind, cuda_device)
    pack, gbr = kw["pack"], kw["gather_block_rows"]
    plan = tk.forward_plan(ids.shape[0] * gbr, kw["d_total"], X2.dtype, pack,
                           torch.cuda.get_device_properties(
                               cuda_device).multi_processor_count)
    assert plan["ring"]
    zyv = tk.fused_forward_gathered(X2, w, ids, **kw)
    ok = (ids >= 0) & (ids < n_blocks)
    want = tk.forward_gathered_reference(X2, w, torch.where(ok, ids, 0),
                                         **kw)
    want = want.reshape(ids.shape[0], -1) * ok.view(-1, 1).float()
    _close(zyv, want.reshape(-1, 3 * pack), kind)
    assert torch.equal(zyv, tk.fused_forward_gathered(X2, w, ids, **kw))


@pytest.mark.gpu
def test_b3_b4_wrappers_raise_on_the_card(cuda_device):
    """Mixed devices, rows that are not whole 16-byte vectors, rows past
    MAX_TP_D and a misaligned X2 raise; none falls back to the plain
    version."""
    kw = dict(pack=4, d_total=32, y_col=30, v_col=31, gather_block_rows=16)
    bkw = dict(pack=4, d_total=32, gather_block_rows=16)
    X2 = torch.zeros((8, 128), device=cuda_device)
    w = torch.zeros(32, device=cuda_device)
    ids = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    r = torch.zeros((8, 4), device=cuda_device)
    with pytest.raises(ValueError, match="operands on"):
        tk.fused_forward_gathered(X2, w.cpu(), ids, **kw)
    with pytest.raises(ValueError, match="operands on"):
        tk.fused_backward_gathered(X2, r, ids.cpu(), **bkw)
    X2b = torch.zeros((4, 128 * 3), device=cuda_device)
    with pytest.raises(ValueError, match="16-byte vectors"):
        tk.fused_forward_gathered(X2b, torch.zeros(3, device=cuda_device),
                                  ids, pack=128, d_total=3, y_col=1,
                                  v_col=2, gather_block_rows=128)
    with pytest.raises(ValueError, match="16-byte vectors"):
        tk.fused_backward_gathered(X2b, torch.zeros((1, 128),
                                                    device=cuda_device),
                                   ids[:1], pack=128, d_total=3,
                                   gather_block_rows=128)
    wide = tk.MAX_TP_D + 128
    X2w = torch.zeros((1, wide), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte vectors"):
        tk.fused_backward_gathered(X2w, torch.zeros((1, 1),
                                                    device=cuda_device),
                                   ids[:1], pack=1, d_total=wide,
                                   gather_block_rows=1)
    flat = torch.zeros(8 * 128 + 1, device=cuda_device)
    X2m = flat[1:].view(8, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk.fused_forward_gathered(X2m, w, ids, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk.fused_backward_gathered(X2m, r, ids, **bkw)


@pytest.mark.gpu
def test_tp_trainer_on_card(cuda_device):
    """``fused_gather`` on a 2×2 mesh: B3 and B4 launch once per step,
    data shard and model slice, two runs are equal bit for bit, and the
    card is within 1e-4 of max|w| of the CPU port after 30 steps."""
    data = datasets.breast_cancer_split()
    cfg = ssgd.SSGDConfig(n_iterations=30, sampler="fused_gather",
                          fused_pack=4, gather_block_rows=32, shuffle_seed=0,
                          feature_sharded=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        n3 = tk.fused_forward_gathered.launches
        n4 = tk.fused_backward_gathered.launches
        card = ssgd.train(*data, get_mesh(2, 2, device=cuda_device), cfg)
        assert tk.fused_forward_gathered.launches - n3 == 30 * 4
        assert tk.fused_backward_gathered.launches - n4 == 30 * 4
        again = ssgd.train(*data, get_mesh(2, 2, device=cuda_device), cfg)
        cpu = ssgd.train(*data, get_mesh(2, 2, device="cpu"), cfg)
    assert torch.equal(card.w, again.w)
    w_cpu = cpu.w.numpy()
    np.testing.assert_allclose(card.w.cpu().numpy(), w_cpu, rtol=0,
                               atol=1e-4 * float(np.abs(w_cpu).max()))
