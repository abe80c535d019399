"""The SSGD CUDA kernels (``tpu_distalg_torch/csrc/ssgd.cu``) against
their plain PyTorch versions, on the card. Imports neither jax nor
``tpu_distalg``, so it also runs on a machine with only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ssgd_card.py

Without a card the tests skip (a CUDA kernel has no CPU mode); the
plain versions are held to the JAX package in
``tests/test_torch_ssgd_kernels.py``.

Three kinds of case. "exact": entries in {-2..2} and w = 0, so every
z is 0, σ(0) = 0.5 exactly, every residual is 0 or ±0.5 and every sum
is exact in float32 whatever its order: gradients and counts must be
equal bit for bit. "integer": the same entries and w a multiple of
1/64, so every z is exact; σ(z) is not (and may differ in its last bit
between the kernel's expf and torch's), and the backward sum adds those
floats in another order: counts must be equal and gradients agree
within 64 float32 ulps of their largest entry (a sequential float32 sum
of 14336 such rows is 34 ulps from the float64 sum). "random": normal
entries, held to 1e-5 of the largest entry. B2's weights after several
steps on bfloat16 X are held to 1e-3 of the largest entry: a residual
rounded to bf16 can land one bf16 ulp (2⁻⁸ relative) apart after
float32 sums in two orders, and later steps carry that. A fixed seed
must replay bit for bit. B5 draws its Bernoulli mask in the kernel: its
count must equal the plain version's (which makes the same mask from
``utils/prng.py``), and a case with unit-vector rows reads the kept set
off the gradient row by row.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch.ops import ssgd_kernels as tk
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

ULP64 = 64 * 2.0**-23
CASES = ["exact", "integer", "random"]


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _values(rng, shape, case):
    if case == "random":
        return rng.normal(size=shape).astype(np.float32)
    return rng.integers(-2, 3, size=shape).astype(np.float32)


def _weights(rng, d, case):
    if case == "exact":
        return np.zeros(d, np.float32)
    if case == "integer":
        return (rng.integers(-8, 9, size=d) / 64.0).astype(np.float32)
    return (rng.normal(size=d) * 0.1).astype(np.float32)


def _check(got, want, case):
    if case == "exact":
        assert torch.equal(got, want)
    else:
        _close(got, want, ULP64 if case == "integer" else 1e-5)


def _close(got, want, rel):
    tol = rel * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol, f"max |err| {err} > {tol}"


def _packed(dev, n, d, dtype, pack, gbr, case, seed):
    rng = np.random.default_rng(seed)
    X = _values(rng, (n, d), case)
    y = rng.integers(0, 2, n).astype(np.float32)
    X2, meta = tk.pack_augmented(X, y, np.ones(n, np.float32), dtype=dtype,
                                 pack=pack, block_rows=gbr, device=dev)
    w = torch.zeros(meta["d_total"], device=dev)
    w[:d] = torch.as_tensor(_weights(rng, d, case), device=dev)
    kw = dict(pack=pack, d_total=meta["d_total"], y_col=meta["y_col"],
              v_col=meta["v_col"], gather_block_rows=gbr)
    return rng, X2, meta, w, kw


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(777, 61), (33, 1), (5000, 126),
                                 (3001, 1000), (1200, 4224), (600, 8192)])
def test_fused_grad_sum_b6_on_card(n, d, dtype, case, cuda_device):
    rng = np.random.default_rng(n + d)
    X = torch.as_tensor(_values(rng, (n, d), case),
                        device=cuda_device).to(dtype)
    y = torch.as_tensor(rng.integers(0, 2, n).astype(np.float32),
                        device=cuda_device)
    m = torch.as_tensor((rng.random(n) < 0.3).astype(np.float32),
                        device=cuda_device)
    w = torch.as_tensor(_weights(rng, d, case), device=cuda_device)
    before = tk.fused_grad_sum.launches
    g, c = tk.fused_grad_sum(X, y, m, w)
    torch.cuda.synchronize()
    assert tk.fused_grad_sum.launches == before + 1
    gr, cr = tk.grad_sum_reference(X, y, m, w)
    assert float(c) == float(cr)
    _check(g, gr, case)
    g2, c2 = tk.fused_grad_sum(X, y, m, w)
    assert torch.equal(g, g2) and torch.equal(c, c2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,pack,gbr,n_s", [
    (400, 30, 16, 128, 4), (398, 31, 4, 32, 1), (5000, 300, 16, 1024, 3),
    (20000, 125, 16, 2048, 7), (3000, 1150, 16, 256, 4),
    (1500, 8190, 16, 256, 3), (1000, 638, 4, 64, 3)])
def test_fused_grad_sum_gathered_b1_on_card(n, d, pack, gbr, n_s, dtype,
                                            case, cuda_device):
    rng, X2, meta, w, kw = _packed(cuda_device, n, d, dtype, pack, gbr,
                                   case, seed=n_s)
    n_blocks = meta["n_padded"] // gbr
    ids = torch.as_tensor(rng.integers(0, n_blocks, n_s).astype(np.int32),
                          device=cuda_device)  # repeats allowed
    before = tk.fused_grad_sum_gathered.launches
    g, c = tk.fused_grad_sum_gathered(X2, w, ids, **kw)
    torch.cuda.synchronize()
    assert tk.fused_grad_sum_gathered.launches == before + 1
    gr, cr = tk.grad_sum_gathered_reference(X2, w, ids, **kw)
    yc = meta["y_col"]
    assert float(c) == float(cr)
    _check(g[:yc], gr[:yc], case)
    g2, c2 = tk.fused_grad_sum_gathered(X2, w, ids, **kw)
    assert torch.equal(g, g2) and torch.equal(c, c2)


@pytest.mark.gpu
@pytest.mark.parametrize("alpha,skip", [(0.0, False), (0.3, False),
                                        (0.0, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,pack,gbr,n_s,T", [
    (400, 30, 16, 128, 2, 7), (398, 31, 4, 32, 1, 125),
    (5000, 400, 16, 1024, 3, 9), (20000, 125, 16, 2048, 5, 40),
    (3000, 1150, 16, 256, 3, 9), (1000, 638, 4, 64, 2, 5)])
def test_fused_train_gathered_b2_on_card(n, d, pack, gbr, n_s, T, dtype,
                                         alpha, skip, cuda_device):
    rng, X2, meta, w, kw = _packed(cuda_device, n, d, dtype, pack, gbr,
                                   "random", seed=T)
    n_blocks = meta["n_padded"] // gbr
    ctr = torch.zeros_like(w)
    ctr[:d] = torch.as_tensor(_weights(rng, d, "random"),
                             device=cuda_device)
    ids = torch.as_tensor(np.stack([
        rng.permutation(n_blocks)[:n_s] for _ in range(T)]).astype(np.int32),
        device=cuda_device)
    before = tk.fused_train_gathered.launches
    wk = tk.fused_train_gathered(X2, w, ids, eta=0.1, alpha=alpha,
                                 center=ctr, skip_update=skip, **kw)
    torch.cuda.synchronize()
    assert tk.fused_train_gathered.launches == before + 1
    wr = tk.train_gathered_reference(X2, w, ids, eta=0.1, alpha=alpha,
                                     center=ctr, skip_update=skip, **kw)
    if skip:
        assert torch.equal(wk, w)
    _close(wk, wr, 1e-5 if dtype == torch.float32 else 1e-3)
    wk2 = tk.fused_train_gathered(X2, w, ids, eta=0.1, alpha=alpha,
                                  center=ctr, skip_update=skip, **kw)
    assert torch.equal(wk, wk2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,pack,block,frac", [
    (400, 30, 16, 128, 0.1), (398, 31, 4, 32, 0.5), (5000, 300, 16, 1024, 0.1),
    (20000, 125, 16, 2048, 0.03), (777, 61, 16, 16, 1.0)])
def test_fused_grad_sum_packed_b5_on_card(n, d, pack, block, frac, dtype,
                                          case, cuda_device):
    """B5 against its plain version under the same (t, shard): the
    count (so the number of kept rows) equal, the gradient as B1's
    cases hold it, a replay bitwise, another t another draw."""
    rng, X2, meta, w, kw = _packed(cuda_device, n, d, dtype, pack, block,
                                   case, seed=n)
    kw = dict(pack=pack, d_total=meta["d_total"], y_col=meta["y_col"],
              v_col=meta["v_col"], fraction=frac, block_rows=block)
    t, shard = 42 + n, 3
    before = tk.fused_grad_sum_packed.launches
    g, c = tk.fused_grad_sum_packed(X2, w, t, shard, **kw)
    torch.cuda.synchronize()
    assert tk.fused_grad_sum_packed.launches == before + 1
    gr, cr = tk.grad_sum_packed_reference(X2, w, t, shard, **kw)
    yc = meta["y_col"]
    assert float(c) == float(cr)
    if (case, dtype) == ("random", torch.bfloat16):
        # a residual on a bf16 rounding boundary rounds the other way
        # when z is summed in another order; among thousands of kept rows
        # a few do, each moving an entry by up to 2⁻⁹·|resid|·|x|
        _close(g[:yc], gr[:yc], 1e-4)
    else:
        _check(g[:yc], gr[:yc], case)
    g2, c2 = tk.fused_grad_sum_packed(X2, w, t, shard, **kw)
    assert torch.equal(g, g2) and torch.equal(c, c2)
    if frac < 1.0 and n > 1000:
        _, c3 = tk.fused_grad_sum_packed(X2, w, t + 1, shard, **kw)
        _, c4 = tk.fused_grad_sum_packed(X2, w, t, shard + 1, **kw)
        assert float(c3) != float(c) or float(c4) != float(c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,pack", [(126, 16), (300, 16)])
def test_b5_kept_set_equals_the_plain_mask(d, pack, dtype, cuda_device):
    """Row i is the unit vector e_i, y = 0 and w = 0, so the residual
    is 0.5·m_i and g[i] = 0.5·m_i: the gradient spells out the kept set,
    which must be the plain mask's, with no pad row kept."""
    n_real = d - 7
    X = np.eye(d, dtype=np.float32)[:n_real]
    X2, meta = tk.pack_augmented(X, np.zeros(n_real, np.float32),
                                 np.ones(n_real, np.float32), dtype=dtype,
                                 pack=pack, block_rows=512,
                                 device=cuda_device)
    w = torch.zeros(meta["d_total"], device=cuda_device)
    for t, shard, frac in ((0, 0, 0.5), (99, 2, 0.1), (2**32 + 5, 7, 0.9)):
        g, c = tk.fused_grad_sum_packed(
            X2, w, t, shard, pack=pack, d_total=meta["d_total"],
            y_col=meta["y_col"], v_col=meta["v_col"], fraction=frac,
            block_rows=512)
        keep = tk.packed_keep_mask(t, shard, meta["n_padded"], frac,
                                   cuda_device)[:n_real].to(torch.float32)
        assert torch.equal(g[:n_real], 0.5 * keep)
        assert float(g[n_real:d].abs().max()) == 0.0
        assert float(c) == float(keep.sum())


@pytest.mark.gpu
def test_cuda_tensors_never_take_the_plain_version(cuda_device):
    """A shape the kernel does not take raises on the card (the plain
    version would have computed it)."""
    X2 = torch.zeros((4, 16 * 8), dtype=torch.float32, device=cuda_device)
    w = torch.zeros(8, device=cuda_device)
    ids = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    kw = dict(pack=16, d_total=8, y_col=6, v_col=7, gather_block_rows=16)
    tk.fused_grad_sum_gathered(X2, w, ids, **kw)   # 32-byte rows: fine
    X2b = torch.zeros((4, 128 * 3), dtype=torch.float32, device=cuda_device)
    wb = torch.zeros(3, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte vectors"):
        tk.fused_grad_sum_gathered(
            X2b, wb, ids, pack=128, d_total=3, y_col=1, v_col=2,
            gather_block_rows=128)
    with pytest.raises(ValueError, match="16-byte vectors"):
        tk.fused_grad_sum_packed(
            X2b, wb, 0, 0, pack=128, d_total=3, y_col=1, v_col=2,
            fraction=0.1, block_rows=128)


#: B1/B2 cases at the edges of their ring (n, d, pack, gbr, n_s, T): a
#: block's rows cross many sampled blocks (gbr 16) and T = 1; rows a block
#: (the plan's chunk) a multiple of neither the stage nor gbr; 16-byte
#: bf16 rows; float32 rows of 1632 bytes (four vectors a lane); bench.py's
#: block size at a few blocks
RING_EDGES = [(5000, 30, 16, 16, 40, 1), (3001, 125, 16, 48, 60, 3),
              (4000, 6, 16, 32, 50, 4), (3000, 400, 16, 64, 9, 5),
              (20000, 125, 16, 2048, 5, 2)]


def _ring_ids(rng, n_blocks, n_s, T):
    """(T, n_s) block ids; each step draws one block twice."""
    ids = rng.integers(0, n_blocks, (T, n_s))
    ids[:, -1] = ids[:, 0]
    return ids.astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,pack,gbr,n_s,T", RING_EDGES)
def test_b1_b2_ring_edges_on_card(n, d, pack, gbr, n_s, T, dtype,
                                  cuda_device):
    """B1 and B2 at the ring's edges against their plain versions, as
    the cases above hold them; B1 also with block ids outside
    [0, n_blocks), which count nothing."""
    rng, X2, meta, w, kw = _packed(cuda_device, n, d, dtype, pack, gbr,
                                   "random", seed=n_s)
    n_blocks, yc = meta["n_padded"] // gbr, meta["y_col"]
    ids = torch.as_tensor(_ring_ids(rng, n_blocks, n_s, T),
                          device=cuda_device)
    g, c = tk.fused_grad_sum_gathered(X2, w, ids[0], **kw)
    gr, cr = tk.grad_sum_gathered_reference(X2, w, ids[0], **kw)
    assert float(c) == float(cr)
    _close(g[:yc], gr[:yc], 1e-5)
    bad = torch.cat([ids[0], torch.tensor([-1, n_blocks, 2**30],
                                          dtype=torch.int32,
                                          device=cuda_device)])
    gb, cb = tk.fused_grad_sum_gathered(X2, w, bad, **kw)
    assert float(cb) == float(cr)
    _close(gb[:yc], gr[:yc], 1e-5)
    wk = tk.fused_train_gathered(X2, w, ids, eta=0.1, **kw)
    wr = tk.train_gathered_reference(X2, w, ids, eta=0.1, **kw)
    _close(wk, wr, 1e-5 if dtype == torch.float32 else 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("alpha", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,pack,gbr,n_s,T", RING_EDGES)
def test_b2_equals_t_calls_of_b1_on_card(n, d, pack, gbr, n_s, T, dtype,
                                         alpha, cuda_device):
    """B2's weights after T steps equal, bit for bit, T calls of B1 at
    the same w (zeroed at columns >= y_col, as B2 casts it), each
    followed by B2's update in B2's own order: the two kernels share the
    row body, the row split and the fold."""
    rng, X2, meta, w, kw = _packed(cuda_device, n, d, dtype, pack, gbr,
                                   "random", seed=T)
    n_blocks, D, yc = meta["n_padded"] // gbr, meta["d_total"], meta["y_col"]
    ids = torch.as_tensor(_ring_ids(rng, n_blocks, n_s, T),
                          device=cuda_device)
    ctr = torch.zeros_like(w)
    ctr[:d] = torch.as_tensor(_weights(rng, d, "random"), device=cuda_device)
    wk = tk.fused_train_gathered(X2, w, ids, eta=0.1, alpha=alpha,
                                 center=ctr, **kw)
    keep = torch.arange(D, device=cuda_device) < yc
    eta_t = torch.tensor(0.1, dtype=torch.float32, device=cuda_device)
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=cuda_device)
    wt = w.clone()
    for t in range(T):
        g, c = tk.fused_grad_sum_gathered(X2, torch.where(keep, wt, 0.0),
                                          ids[t], **kw)
        w_new = wt - (eta_t / torch.clamp_min(c, 1.0)) * torch.where(
            keep, g, 0.0)
        if alpha:
            w_new = w_new - alpha_t * (wt - ctr)
        wt = w_new
    assert torch.equal(wk, wt)


#: B1/B2 on rows over 2048 bytes (n, d, pack, gbr, n_s, T, dtype):
#: epsilon's width (d_total 2008 bf16); the first width past the ring's
#: 2048 bytes (d_total 1152 bf16); a float32 row of 2432 bytes; D 8200
#: bf16, chip_smoke.py's wide geometry; then D 16400 bf16, past the wide
#: ring's 2048 vectors, which the wide body takes. Each block of the wide
#: ring takes several rounds of stages a step, the last stage short.
WIDE_EDGES = [(12000, 2000, 16, 512, 12, 4, torch.bfloat16),
              (3000, 1150, 16, 256, 9, 3, torch.bfloat16),
              (4000, 600, 16, 128, 20, 3, torch.float32),
              (2000, 8198, 16, 128, 12, 3, torch.bfloat16),
              (600, 16398, 16, 64, 3, 2, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,pack,gbr,n_s,T,dtype", WIDE_EDGES)
def test_b1_b2_wide_rows_on_card(n, d, pack, gbr, n_s, T, dtype,
                                 cuda_device):
    """B1 and B2 on wide rows against their plain versions, as the cases
    above hold them: B1 also with block ids outside [0, n_blocks), which
    count nothing; a replay equal bit for bit; each launch counted under
    the body that the row's width picks."""
    rng, X2, meta, w, kw = _packed(cuda_device, n, d, dtype, pack, gbr,
                                   "random", seed=n_s)
    n_blocks, D, yc = meta["n_padded"] // gbr, meta["d_total"], meta["y_col"]
    body = "wide" if D * X2.element_size() // 16 > tk.WIDE_MAX_VECTORS \
        else "wide_ring"
    ids = torch.as_tensor(_ring_ids(rng, n_blocks, n_s, T),
                          device=cuda_device)
    b1 = dict(tk.fused_grad_sum_gathered.launches_by_body)
    g, c = tk.fused_grad_sum_gathered(X2, w, ids[0], **kw)
    gr, cr = tk.grad_sum_gathered_reference(X2, w, ids[0], **kw)
    assert float(c) == float(cr)
    _close(g[:yc], gr[:yc], 1e-5)
    bad = torch.cat([ids[0], torch.tensor([-1, n_blocks, 2**30],
                                          dtype=torch.int32,
                                          device=cuda_device)])
    gb, cb = tk.fused_grad_sum_gathered(X2, w, bad, **kw)
    assert float(cb) == float(cr)
    _close(gb[:yc], gr[:yc], 1e-5)
    g2, c2 = tk.fused_grad_sum_gathered(X2, w, ids[0], **kw)
    assert torch.equal(g, g2) and torch.equal(c, c2)
    b2 = dict(tk.fused_train_gathered.launches_by_body)
    wk = tk.fused_train_gathered(X2, w, ids, eta=0.1, **kw)
    wr = tk.train_gathered_reference(X2, w, ids, eta=0.1, **kw)
    _close(wk, wr, 1e-5 if dtype == torch.float32 else 1e-3)
    assert torch.equal(wk, tk.fused_train_gathered(X2, w, ids, eta=0.1, **kw))
    ws = tk.fused_train_gathered(X2, w, ids, eta=0.1, skip_update=True, **kw)
    assert torch.equal(ws, w)
    torch.cuda.synchronize()
    for wrapper, before, count in ((tk.fused_grad_sum_gathered, b1, 3),
                                   (tk.fused_train_gathered, b2, 3)):
        got = {k: v - before[k] for k, v in wrapper.launches_by_body.items()}
        assert got == {"ring": 0, "wide_ring": 0, "wide": 0, body: count}


@pytest.mark.gpu
@pytest.mark.parametrize("alpha", [0.0, 0.3])
@pytest.mark.parametrize("n,d,pack,gbr,n_s,T,dtype", WIDE_EDGES[:4])
def test_b2_equals_t_calls_of_b1_wide_ring_on_card(n, d, pack, gbr, n_s, T,
                                                   dtype, alpha,
                                                   cuda_device):
    """On the wide ring too, B2's weights after T steps equal, bit for
    bit, T calls of B1 at the same w followed by B2's update: the two
    kernels share the plan, the consumer body and the fold's order."""
    rng, X2, meta, w, kw = _packed(cuda_device, n, d, dtype, pack, gbr,
                                   "random", seed=T)
    n_blocks, D, yc = meta["n_padded"] // gbr, meta["d_total"], meta["y_col"]
    ids = torch.as_tensor(_ring_ids(rng, n_blocks, n_s, T),
                          device=cuda_device)
    ctr = torch.zeros_like(w)
    ctr[:d] = torch.as_tensor(_weights(rng, d, "random"), device=cuda_device)
    wk = tk.fused_train_gathered(X2, w, ids, eta=0.1, alpha=alpha,
                                 center=ctr, **kw)
    keep = torch.arange(D, device=cuda_device) < yc
    eta_t = torch.tensor(0.1, dtype=torch.float32, device=cuda_device)
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=cuda_device)
    wt = w.clone()
    for t in range(T):
        g, c = tk.fused_grad_sum_gathered(X2, torch.where(keep, wt, 0.0),
                                          ids[t], **kw)
        w_new = wt - (eta_t / torch.clamp_min(c, 1.0)) * torch.where(
            keep, g, 0.0)
        if alpha:
            w_new = w_new - alpha_t * (wt - ctr)
        wt = w_new
    assert torch.equal(wk, wt)


@pytest.mark.gpu
def test_b1_ticket_resets_and_two_streams_on_card(cuda_device):
    """B1 folds in the launch's last block and resets its ticket: back
    to back calls give equal bits, and calls on two streams (each with
    its own workspace) are right on both."""
    rng, X2, meta, w, kw = _packed(cuda_device, 20000, 125, torch.bfloat16,
                                   16, 2048, "random", seed=3)
    n_blocks, yc = meta["n_padded"] // 2048, meta["y_col"]
    ids = [torch.as_tensor(rng.integers(0, n_blocks, 7).astype(np.int32),
                           device=cuda_device) for _ in range(2)]
    want = [tk.fused_grad_sum_gathered(X2, w, i, **kw) for i in ids]
    for (g, c), i in zip(want, ids):
        gr, cr = tk.grad_sum_gathered_reference(X2, w, i, **kw)
        assert float(c) == float(cr)
        _close(g[:yc], gr[:yc], 1e-5)
    for _ in range(3):
        again = [tk.fused_grad_sum_gathered(X2, w, i, **kw) for i in ids]
        for (g, c), (g2, c2) in zip(want, again):
            assert torch.equal(g, g2) and torch.equal(c, c2)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    got = []
    for _ in range(10):
        for s, i in zip(streams, ids):
            with torch.cuda.stream(s):
                got.append(tk.fused_grad_sum_gathered(X2, w, i, **kw))
    torch.cuda.synchronize()
    for k, (g, c) in enumerate(got):
        assert torch.equal(g, want[k % 2][0]) and torch.equal(c, want[k % 2][1])


@pytest.mark.gpu
def test_program_spans_agree_with_the_trace_on_card(cuda_device, tmp_path):
    """Three ``fused_train`` calls at a HIGGS-like shape (8M rows of 28
    features + bias, bf16, 1024-row blocks, 1500 steps in 12 launches)
    under the profiler: one ``ssgd.launch`` span per B2 kernel in the
    trace, and each call's ``ssgd.draws`` device seconds (CUDA events
    at its edges) within 10% of the trace's own reading, from the first
    device operation the span launched to the start of the call's first
    B2 kernel."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.telemetry import events

    mesh = get_mesh(data=1, device=cuda_device)
    cfg = ssgd.SSGDConfig(sampler="fused_train", x_dtype="bfloat16",
                          fused_pack=16, gather_block_rows=1024,
                          n_iterations=1500, mega_steps=125, eval_every=125)
    _, X2, w, meta = ssgd.prepare_fused_synthetic(8 << 20, 28, mesh, cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    X_te = torch.randn((4096, meta["d_total"]), generator=gen,
                       device=cuda_device)
    y_te = (torch.rand(4096, generator=gen, device=cuda_device)
            < 0.5).float()
    ssgd.train_prepared(mesh, cfg, X2, w, meta, X_te, y_te)   # warm
    torch.cuda.synchronize()
    with events.recording(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            w = ssgd.train_prepared(mesh, cfg, X2, w, meta, X_te, y_te).w
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in evs
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    b2 = sorted(e["ts"] for e in device if "train_ring_kernel" in e["name"])
    assert len(events.recorded("ssgd.launch")) == len(b2) == 36
    runtime = [e for e in evs if e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver")]
    draws = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs
                   if e.get("cat") == "user_annotation"
                   and e["name"] == "ssgd.draws")
    spans = events.recorded("ssgd.draws")
    assert len(draws) == len(spans) == 3
    for (a, b), s in zip(draws, spans):
        launched = {e["args"].get("correlation") for e in runtime
                    if a <= e["ts"] <= b}
        first = min(e["ts"] for e in device
                    if e["args"].get("correlation") in launched)
        trace_s = (min(t for t in b2 if t >= first) - first) * 1e-6
        assert abs(s.device_s - trace_s) <= 0.1 * trace_s, (s.device_s,
                                                             trace_s)
