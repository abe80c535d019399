"""The flash-attention CUDA kernels (``tpu_distalg_torch/csrc/attention.cu``,
B11 and B12) against their plain PyTorch versions, on the card. Imports
neither jax nor ``tpu_distalg``, so it also runs on a machine with only
the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_attention_card.py

Without a card the tests skip (a CUDA kernel has no CPU mode); the plain
versions are held to the JAX package's Pallas kernels in
``tests/test_torch_attention_kernels.py``.

Two kinds of input. "exact": the forward gets q = 0 (every score is 0,
so P is 1 or 0 and o, l are sums of integers), integer v and an integer
carry; the backward gets lse = 0 and either q = 0 or k = 0 with integer
k or q, v, dO and delta and scale 0.5, so every product and sum is exact
in float32 and dS rounds to bf16 the same way on both sides: o, l, dq,
dk, dv must be equal bit for bit. "random": N(0, 1) inputs and a
consistent lse, delta; the largest |kernel − plain| must stay within
1e-5 of the largest |plain| for float32 (sums in another order) and 2e-2
for bf16, the band of ``tests_tpu/test_tpu_numerics.py``: the kernel
rounds dO and P to bf16 for the tensor cores where the plain version
multiplies them in float32 (ROADMAP C), which moves its gradients by
about 0.5% of their largest entry. In both kinds m is compared after
mapping values at or below −5e29 to −inf: a row that has seen no key
keeps −inf or takes the sentinel depending on the tiling. A fixed input
must replay bit for bit, and each call counts one launch.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch.ops import attention_kernels as ak
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

#: (name, H, H_kv, S_q, S_kv, d, causal, q_off, k_off, bq, bkv): the
#: diagonal crossing tiles, every tile full (queries past the block),
#: dead then crossing tiles (keys past the first queries), no mask, equal
#: heads, a 136-row tail, head dims 256, 384 and 512 (the last two split
#: their output columns over blocks)
CASES = [
    ("diagonal", 8, 2, 256, 256, 128, True, 0, 0, 128, 128),
    ("full", 8, 2, 128, 256, 128, True, 512, 0, 128, 256),
    ("dead_crossing", 4, 2, 384, 256, 128, True, 0, 256, 128, 128),
    ("noncausal", 4, 4, 256, 384, 128, False, 0, 0, 256, 128),
    ("tail", 8, 2, 136, 256, 128, True, 120, 0, 136, 128),
    ("d256", 2, 1, 256, 256, 256, True, 64, 0, 128, 128),
    ("d384", 4, 2, 256, 256, 384, True, 0, 0, 128, 128),
    ("d512_tail", 2, 2, 136, 384, 512, True, 200, 0, 136, 128),
]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _norm_m(m):
    return torch.where(m <= ak._NEG / 2, float("-inf"), m)


def _close(what, got, want, dtype, exact):
    if exact:
        assert torch.equal(got, want), (
            f"{what}: max |err| {float((got - want).abs().max())!r}")
        return
    err = float((got - want).abs().max())
    bound = TOL[dtype] * float(want.abs().max())
    assert err <= bound, f"{what}: max |err| {err!r} > {bound!r}"


def _m_close(got, want, dtype, exact):
    got, want = _norm_m(got), _norm_m(want)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = ~torch.isneginf(want)
    _close("m", got[fin], want[fin], dtype, exact)


def fwd_inputs(case, dtype, kind, dev, seed=0):
    _, h, h_kv, s_q, s_kv, d, *_ = case
    rng = np.random.default_rng(seed)

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x, np.float32)).to(dev, dt)

    if kind == "exact":
        q = np.zeros((h, s_q, d))
        k = rng.integers(-3, 4, (h_kv, s_kv, d))
        v = rng.integers(-3, 4, (h_kv, s_kv, d))
        o = rng.integers(-8, 9, (h, s_q, d))
        m = np.zeros((h, s_q, 1))
        l = rng.integers(1, 5, (h, s_q, 1))
    else:
        q, k, v = (rng.normal(size=s) for s in
                   ((h, s_q, d), (h_kv, s_kv, d), (h_kv, s_kv, d)))
        o = np.zeros((h, s_q, d))
        m = np.full((h, s_q, 1), -np.inf)
        l = np.zeros((h, s_q, 1))
    f32 = torch.float32
    return t(q), t(k), t(v), t(o, f32), t(m, f32), t(l, f32)


def bwd_inputs(case, dtype, kind, dev, seed=1):
    _, h, h_kv, s_q, s_kv, d, causal, q_off, k_off, bq, bkv = case
    rng = np.random.default_rng(seed)
    f32 = torch.float32

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x, np.float32)).to(dev, dt)

    if kind in ("exact_q0", "exact_k0"):
        q = rng.integers(-2, 3, (h, s_q, d))
        k = rng.integers(-2, 3, (h_kv, s_kv, d))
        if kind == "exact_q0":
            q = np.zeros_like(q)
        else:
            k = np.zeros_like(k)
        v = rng.integers(-2, 3, (h_kv, s_kv, d))
        do = rng.integers(-2, 3, (h, s_q, d))
        lse = np.zeros((h, s_q, 1))
        delta = rng.integers(-20, 21, (h, s_q, 1))
        return (t(q), t(k), t(v), t(do, f32), t(lse, f32), t(delta, f32),
                0.5)
    scale = 1.0 / np.sqrt(d)
    q, k, v = fwd_inputs(case, dtype, "random", dev, seed)[:3]
    o0 = torch.zeros((h, s_q, d), dtype=f32, device=dev)
    m0 = torch.full((h, s_q, 1), float("-inf"), device=dev)
    l0 = torch.zeros((h, s_q, 1), device=dev)
    # the state over every key this block's queries see: the block itself
    # and, so that no row is empty, a second one at offset 0
    o, m, l = ak.flash_attention_block_reference(
        q, k, v, o0, m0, l0, q_off, k_off, scale=scale, causal=causal,
        bq=bq, bkv=bkv)
    if causal:
        o, m, l = ak.flash_attention_block_reference(
            q, k, v, o, m, l, q_off, min(q_off, k_off) - s_kv,
            scale=scale, causal=True, bq=bq, bkv=bkv)
    out = o / l
    do = t(rng.normal(size=(h, s_q, d)), f32)
    return (q, k, v, do, m + torch.log(l),
            (do * out).sum(-1, keepdim=True), scale)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_forward_b11_on_card(case, dtype, kind, cuda_device):
    _, h, h_kv, s_q, s_kv, d, causal, q_off, k_off, bq, bkv = case
    q, k, v, o, m, l = fwd_inputs(case, dtype, kind, cuda_device)
    kw = dict(scale=0.5 if kind == "exact" else 1.0 / np.sqrt(d),
              causal=causal, bq=bq, bkv=bkv)
    before = ak.flash_attention_block.launches
    got = ak.flash_attention_block(q, k, v, o, m, l, q_off, k_off, **kw)
    torch.cuda.synchronize()
    assert ak.flash_attention_block.launches == before + 1
    want = ak.flash_attention_block_reference(q, k, v, o, m, l, q_off,
                                              k_off, **kw)
    exact = kind == "exact"
    _close("o", got[0], want[0], dtype, exact)
    _m_close(got[1], want[1], dtype, exact)
    _close("l", got[2], want[2], dtype, exact)
    # carry-in: fold the block again at a later offset (keys past some
    # rows) onto the state just computed
    got2 = ak.flash_attention_block(q, k, v, *got, q_off, k_off + 64, **kw)
    want2 = ak.flash_attention_block_reference(q, k, v, *want, q_off,
                                               k_off + 64, **kw)
    _close("o carried", got2[0], want2[0], dtype, exact)
    _m_close(got2[1], want2[1], dtype, exact)
    _close("l carried", got2[2], want2[2], dtype, exact)
    again = ak.flash_attention_block(q, k, v, o, m, l, q_off, k_off, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact_q0", "exact_k0", "random"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_backward_b12_on_card(case, dtype, kind, cuda_device):
    _, h, h_kv, s_q, s_kv, d, causal, q_off, k_off, bq, bkv = case
    q, k, v, do, lse, delta, scale = bwd_inputs(case, dtype, kind,
                                                cuda_device)
    kw = dict(scale=scale, causal=causal, bq=bq, bkv=bkv)
    before = ak.flash_attention_backward_block.launches
    got = ak.flash_attention_backward_block(q, k, v, do, lse, delta, q_off,
                                            k_off, **kw)
    torch.cuda.synchronize()
    assert ak.flash_attention_backward_block.launches == before + 1
    want = ak.flash_attention_backward_block_reference(
        q, k, v, do, lse, delta, q_off, k_off, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        _close(name, a, b, dtype, kind != "random")
    again = ak.flash_attention_backward_block(q, k, v, do, lse, delta,
                                              q_off, k_off, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_block_halves_to_divisor_on_card(dtype, cuda_device):
    """S 384 with bq = bkv = 256 halves to 128 (JAX's contract), on the
    kernel as on the plain version, with a bf16 dO too."""
    case = ("halving", 1, 1, 384, 384, 128, True, 0, 0, 128, 128)
    q, k, v, do, lse, delta, scale = bwd_inputs(case, dtype, "random",
                                                cuda_device)
    kw = dict(scale=scale, causal=True, bq=256, bkv=256)
    got = ak.flash_attention_backward_block(q, k, v, do, lse, delta, 0, 0,
                                            **kw)
    want = ak.flash_attention_backward_block_reference(
        q, k, v, do, lse, delta, 0, 0, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(name, a, b, dtype, False)
    if dtype == torch.bfloat16:
        got = ak.flash_attention_backward_block(
            q, k, v, do.to(dtype), lse, delta, 0, 0, **kw)
        want = ak.flash_attention_backward_block_reference(
            q, k, v, do.to(dtype), lse, delta, 0, 0, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _close(name, a, b, dtype, False)


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    dev = cuda_device
    h, s, d = 2, 256, 128

    def z(*shape, dt=torch.bfloat16):
        return torch.zeros(shape, dtype=dt, device=dev)

    state = (z(h, s, d, dt=torch.float32), z(h, s, 1, dt=torch.float32),
             z(h, s, 1, dt=torch.float32))
    kw = dict(scale=1.0, causal=True)
    # a head dim past 256, once refused, runs and matches the plain version
    rng = np.random.default_rng(384)
    q3, k3, v3 = (torch.as_tensor(rng.normal(size=(h, s, 384)),
                                  dtype=torch.float32).to(dev, torch.bfloat16)
                  for _ in range(3))
    st3 = (z(h, s, 384, dt=torch.float32),
           torch.full((h, s, 1), float("-inf"), device=dev),
           z(h, s, 1, dt=torch.float32))
    kw3 = dict(scale=384 ** -0.5, causal=True)
    got = ak.flash_attention_block(q3, k3, v3, *st3, 0, 0, **kw3)
    want = ak.flash_attention_block_reference(q3, k3, v3, *st3, 0, 0, **kw3)
    _close("o d384", got[0], want[0], torch.bfloat16, False)
    _m_close(got[1], want[1], torch.bfloat16, False)
    _close("l d384", got[2], want[2], torch.bfloat16, False)
    with pytest.raises(ValueError, match="one type"):
        ak.flash_attention_block(z(h, s, d), z(h, s, d, dt=torch.float32),
                                 z(h, s, d), *state, 0, 0, **kw)
    with pytest.raises(ValueError, match="float16|bfloat16"):
        ak.flash_attention_block(*(z(h, s, d, dt=torch.float16),) * 3,
                                 *state, 0, 0, **kw)
    with pytest.raises(ValueError, match="divisible blocks"):
        ak.flash_attention_block(z(h, s, d), z(h, s, d), z(h, s, d), *state,
                                 0, 0, bq=96, **kw)
    f32 = torch.float32
    with pytest.raises(ValueError, match="do must be"):
        ak.flash_attention_backward_block(
            *(z(h, s, d, dt=f32),) * 3, z(h, s, d), state[1], state[2], 0,
            0, **kw)
    with pytest.raises(ValueError, match="unsupported device|operands on"):
        ak.flash_attention_block(z(h, s, d).cpu(), z(h, s, d), z(h, s, d),
                                 *state, 0, 0, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_softmax_attention_flash_on_card(dtype, cuda_device):
    """``softmax_attention(use_flash=True)``: one B11 launch forward and
    one B12 launch backward, out and the gradients of Σ out² within
    TOL's relative error (Frobenius, whole tensor) of the dense torch-op
    path on the same card."""
    from tpu_distalg_torch.parallel import softmax_attention

    rng = np.random.default_rng(3)
    ts = [torch.as_tensor(rng.normal(size=(512, h, 128)), dtype=torch.float32)
          .to(cuda_device, dtype) for h in (8, 2, 2)]

    def run(use_flash):
        xs = [t.detach().requires_grad_(True) for t in ts]
        out = softmax_attention(*xs, causal=True, use_flash=use_flash)
        return (out, *torch.autograd.grad((out * out).sum(), xs))

    for kern in ak.KERNELS:
        kern.launches = 0
    got = run(True)
    assert [kern.launches for kern in ak.KERNELS] == [1, 1]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, run(False)):
        a, b = a.float(), b.float()
        rel = float((a - b).norm() / b.norm())
        assert rel <= TOL[dtype], f"{name}: relative error {rel!r}"
