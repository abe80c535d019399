"""The plain versions of kernels B11 and B12
(``tpu_distalg_torch/ops/attention_kernels.py``) against the JAX
package's Pallas kernels (``tpu_distalg/ops/pallas_attention.py``),
called directly in interpret mode on the CPU (never under ``shard_map``,
whose partitioner this jaxlib refuses for them).

Both packages get the same numpy arrays. Tolerances, as the largest
|port − JAX| over the largest |JAX| of each output: float32 1e-5 (both
walk the same tiles with the same algebra; only the order of the f32
sums inside a tile product differs, measured at about 1e-6); bf16 inputs
2e-3 for the forward and 1e-3 for the backward: the same, plus P (or
dS) rounded to bf16 after an exp that differs by an ulp between the two
libraries, which now and then flips one rounding (measured at about
6e-4 of the largest entry). m is compared where finite, and −inf where
JAX has −inf. The gradients of the halving case are held to the dense
oracle within 1e-4, as ``tests/test_ring.py`` holds JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_distalg.ops import pallas_attention as jpa
from tpu_distalg_torch.ops import attention_kernels as ak

TOL_FWD = {"float32": 1e-5, "bfloat16": 2e-3}
TOL_BWD = {"float32": 1e-5, "bfloat16": 1e-3}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}

#: (name, H, H_kv, S_q, S_kv, causal, q_off, k_off, bq, bkv): GQA on the
#: diagonal, equal heads without a mask, every tile full, dead then
#: crossing tiles, one block per axis
CASES = [
    ("gqa_diagonal", 4, 2, 256, 256, True, 0, 0, 64, 128),
    ("mha_noncausal", 2, 2, 128, 256, False, 0, 0, 64, 128),
    ("full", 4, 2, 128, 256, True, 512, 0, 64, 128),
    ("dead_crossing", 2, 1, 256, 256, True, 0, 128, 64, 128),
    ("one_tile", 2, 1, 128, 128, True, 0, 0, 128, 128),
]


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(case, seed, carry, d=128):
    _, h, h_kv, s_q, s_kv, *_ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(h, s_q, d)).astype(np.float32)
    k = rng.normal(size=(h_kv, s_kv, d)).astype(np.float32)
    v = rng.normal(size=(h_kv, s_kv, d)).astype(np.float32)
    if carry:
        o = rng.normal(size=(h, s_q, d)).astype(np.float32)
        m = rng.normal(size=(h, s_q, 1)).astype(np.float32)
        l = rng.uniform(1.0, 4.0, size=(h, s_q, 1)).astype(np.float32)
    else:
        o = np.zeros((h, s_q, d), np.float32)
        m = np.full((h, s_q, 1), -np.inf, np.float32)
        l = np.zeros((h, s_q, 1), np.float32)
    return q, k, v, o, m, l


def _both(x, dtype):
    jdt, tdt = DT[dtype]
    return jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carry"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_b11_matches_jax_interpret(case, dtype, carry):
    _, h, h_kv, s_q, s_kv, causal, q_off, k_off, bq, bkv = case
    q, k, v, o, m, l = _inputs(case, 0, carry)
    kw = dict(scale=1.0 / np.sqrt(128), causal=causal, bq=bq, bkv=bkv)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = jpa.flash_attention_block(jq, jk, jv, o, m, l, q_off, k_off,
                                     interpret=True, **kw)
    got = ak.flash_attention_block(tq, tk, tv, torch.as_tensor(o),
                                   torch.as_tensor(m), torch.as_tensor(l),
                                   q_off, k_off, **kw)
    assert all(g.dtype == torch.float32 for g in got)
    jm = np.asarray(want[1])
    np.testing.assert_array_equal(np.isneginf(got[1].numpy()),
                                  np.isneginf(jm))
    fin = np.isfinite(jm)
    assert _rel_err(got[1].numpy()[fin], jm[fin]) <= TOL_FWD[dtype]
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert _rel_err(g.numpy(), w) <= TOL_FWD[dtype]


def _bwd_inputs(case, seed, d=128):
    """q, k, v, dO and the (lse, delta) of the full causal prefix: the
    block itself and, so that no row is empty, one of keys before every
    query."""
    _, h, h_kv, s_q, s_kv, causal, q_off, k_off, bq, bkv = case
    q, k, v, o, m, l = _inputs(case, seed, False, d)
    t = [torch.as_tensor(x) for x in (q, k, v, o, m, l)]
    kw = dict(scale=1.0 / np.sqrt(d), causal=causal, bq=bq, bkv=bkv)
    o_, m_, l_ = ak.flash_attention_block_reference(*t, q_off, k_off, **kw)
    if causal:
        o_, m_, l_ = ak.flash_attention_block_reference(
            *t[:3], o_, m_, l_, q_off, min(q_off, k_off) - s_kv, **kw)
    rng = np.random.default_rng(seed + 1)
    do = rng.normal(size=q.shape).astype(np.float32)
    lse = (m_ + torch.log(l_)).numpy()
    delta = (torch.as_tensor(do) * o_ / l_).sum(-1, keepdim=True).numpy()
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_b12_matches_jax_interpret(case, dtype):
    _, h, h_kv, s_q, s_kv, causal, q_off, k_off, bq, bkv = case
    q, k, v, do, lse, delta = _bwd_inputs(case, 3)
    kw = dict(scale=1.0 / np.sqrt(128), causal=causal, bq=bq, bkv=bkv)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = jpa.flash_attention_backward_block(
        jq, jk, jv, jnp.asarray(do), jnp.asarray(lse), jnp.asarray(delta),
        q_off, k_off, interpret=True, **kw)
    got = ak.flash_attention_backward_block(
        tq, tk, tv, torch.as_tensor(do), torch.as_tensor(lse),
        torch.as_tensor(delta), q_off, k_off, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel_err(g.numpy(), w) <= TOL_BWD[dtype], name


#: a head dim past 256 (the CUDA kernels split its output columns
#: over blocks): GQA on the diagonal with a 64-row tail
WIDE = ("gqa_tail_d384", 2, 1, 192, 256, True, 64, 0, 64, 128)
#: the backward at d 384: one dS that flips its bf16 rounding moves a
#: gradient by the same amount as at d 128, but the largest gradient is
#: smaller (scale 1/√384), so bf16 is held to 2e-3 (measured 1.06e-3)
TOL_BWD_WIDE = {"float32": 1e-5, "bfloat16": 2e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_b11_matches_jax_interpret_at_d384(dtype):
    _, h, h_kv, s_q, s_kv, causal, q_off, k_off, bq, bkv = WIDE
    q, k, v, o, m, l = _inputs(WIDE, 5, True, d=384)
    kw = dict(scale=1.0 / np.sqrt(384), causal=causal, bq=bq, bkv=bkv)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = jpa.flash_attention_block(jq, jk, jv, o, m, l, q_off, k_off,
                                     interpret=True, **kw)
    got = ak.flash_attention_block(tq, tk, tv, torch.as_tensor(o),
                                   torch.as_tensor(m), torch.as_tensor(l),
                                   q_off, k_off, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g.numpy(), w) <= TOL_FWD[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_b12_matches_jax_interpret_at_d384(dtype):
    _, h, h_kv, s_q, s_kv, causal, q_off, k_off, bq, bkv = WIDE
    q, k, v, do, lse, delta = _bwd_inputs(WIDE, 6, d=384)
    kw = dict(scale=1.0 / np.sqrt(384), causal=causal, bq=bq, bkv=bkv)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = jpa.flash_attention_backward_block(
        jq, jk, jv, jnp.asarray(do), jnp.asarray(lse), jnp.asarray(delta),
        q_off, k_off, interpret=True, **kw)
    got = ak.flash_attention_backward_block(
        tq, tk, tv, torch.as_tensor(do), torch.as_tensor(lse),
        torch.as_tensor(delta), q_off, k_off, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        assert _rel_err(g.numpy(), w) <= TOL_BWD_WIDE[dtype], name


def test_plain_b12_halves_to_divisor_like_jax():
    """s = 384 with bq = bkv = 256 halves to 128 (JAX's own test,
    ``tests/test_ring.py:453``): the plain gradients equal JAX's
    interpret-mode ones and the dense oracle's within 1e-4."""
    rng = np.random.default_rng(21)
    H, S, d = 1, 384, 128
    qh, kh, vh = (rng.normal(size=(H, S, d)).astype(np.float32)
                  for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    o0 = torch.zeros((H, S, d))
    m0 = torch.full((H, S, 1), float("-inf"))
    l0 = torch.zeros((H, S, 1))
    tq, tk, tv = (torch.as_tensor(x) for x in (qh, kh, vh))
    o, m, l = ak.flash_attention_block(tq, tk, tv, o0, m0, l0, 0, 0,
                                       scale=scale, causal=True, bq=128,
                                       bkv=128)
    do = rng.normal(size=(H, S, d)).astype(np.float32)
    lse = m + torch.log(l)
    delta = (torch.as_tensor(do) * (o / l)).sum(-1, keepdim=True)
    got = ak.flash_attention_backward_block(
        tq, tk, tv, torch.as_tensor(do), lse, delta, 0, 0, scale=scale,
        causal=True, bq=256, bkv=256)
    want = jpa.flash_attention_backward_block(
        jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(do),
        jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()), 0, 0,
        scale=scale, causal=True, bq=256, bkv=256, interpret=True)

    def dense(q_, k_, v_):
        sc = jnp.einsum("hqd,hkd->hqk", q_, k_) * scale
        mask = jnp.arange(S)[:, None] >= jnp.arange(S)[None, :]
        p = jax.nn.softmax(jnp.where(mask[None], sc, -jnp.inf), axis=-1)
        return jnp.einsum("hqk,hkd->hqd", p, v_)

    _, vjp = jax.vjp(dense, jnp.asarray(qh), jnp.asarray(kh),
                     jnp.asarray(vh))
    oracle = vjp(jnp.asarray(do))
    for g, w, o_ in zip(got, want, oracle):
        assert _rel_err(g.numpy(), w) <= TOL_BWD["float32"]
        np.testing.assert_allclose(g.numpy(), np.asarray(o_), rtol=1e-4,
                                   atol=1e-4)


def test_plain_matches_dense_over_two_blocks_with_carry():
    """Two blocks folded one after the other, with GQA and a tail-free
    causal split, normalise to the dense causal softmax (f32 within
    1e-5 of the largest entry)."""
    rng = np.random.default_rng(5)
    h, h_kv, s, d = 4, 2, 256, 128
    q = rng.normal(size=(h, s, d)).astype(np.float32)
    k = rng.normal(size=(h_kv, s, d)).astype(np.float32)
    v = rng.normal(size=(h_kv, s, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    st = (torch.zeros((h, s, d)), torch.full((h, s, 1), float("-inf")),
          torch.zeros((h, s, 1)))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    for half in (0, 1):
        rows = slice(half * 128, (half + 1) * 128)
        st = ak.flash_attention_block(tq, tk[:, rows], tv[:, rows], *st, 0,
                                      half * 128, scale=scale, causal=True,
                                      bq=64, bkv=128)
    out = (st[0] / st[2]).numpy()
    kr, vr = np.repeat(k, 2, axis=0), np.repeat(v, 2, axis=0)
    sc = np.einsum("hqd,hkd->hqk", q, kr) * scale
    sc = np.where(np.tril(np.ones((s, s), bool))[None], sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    want = np.einsum("hqk,hkd->hqd", p / p.sum(-1, keepdims=True), vr)
    assert _rel_err(out, want) <= 1e-5


#: JAX's bad shapes, each with the text of its ValueError
BAD_FWD = [
    (dict(d=64), "d%128"),
    (dict(s_q=100, bq=64), "divisible blocks"),
    (dict(s_kv=200), "divisible blocks"),
    (dict(bkv=64), "divisible blocks"),
    (dict(v_len=128), "must match k"),
    (dict(h=3), "not divisible"),
]


def _bad(d=128, s_q=128, s_kv=256, h=4, h_kv=2, v_len=None, bq=2048,
         bkv=2048):
    z = np.zeros
    return (z((h, s_q, d), np.float32), z((h_kv, s_kv, d), np.float32),
            z((h_kv, v_len or s_kv, d), np.float32),
            z((h, s_q, d), np.float32), z((h, s_q, 1), np.float32),
            z((h, s_q, 1), np.float32)), dict(bq=bq, bkv=bkv)


@pytest.mark.parametrize("bad,msg", BAD_FWD)
def test_same_value_errors_as_jax(bad, msg):
    arrays, blocks = _bad(**bad)
    kw = dict(scale=1.0, causal=True, **blocks)
    with pytest.raises(ValueError, match=msg):
        jpa.flash_attention_block(*(jnp.asarray(a) for a in arrays), 0, 0,
                                  interpret=True, **kw)
    with pytest.raises(ValueError, match=msg):
        ak.flash_attention_block(*(torch.as_tensor(a) for a in arrays), 0,
                                 0, **kw)
    q, k, v, o, m, _ = arrays
    with pytest.raises(ValueError, match=msg):
        jpa.flash_attention_backward_block(
            *(jnp.asarray(a) for a in (q, k, v, q, m, m)), 0, 0,
            interpret=True, **kw)
    with pytest.raises(ValueError, match=msg):
        ak.flash_attention_backward_block(
            *(torch.as_tensor(a) for a in (q, k, v, q, m, m)), 0, 0, **kw)


def test_backward_do_shape_error_like_jax():
    arrays, _ = _bad()
    q, k, v, o, m, _ = arrays
    do = np.zeros((4, 64, 128), np.float32)
    with pytest.raises(ValueError, match="do must match q"):
        jpa.flash_attention_backward_block(
            *(jnp.asarray(a) for a in (q, k, v, do, m, m)), 0, 0,
            scale=1.0, interpret=True)
    with pytest.raises(ValueError, match="do must match q"):
        ak.flash_attention_backward_block(
            *(torch.as_tensor(a) for a in (q, k, v, do, m, m)), 0, 0,
            scale=1.0)


def test_wrappers_run_the_plain_version_on_the_cpu():
    """CPU tensors go to the plain versions and launch nothing."""
    case = CASES[0]
    q, k, v, o, m, l = (torch.as_tensor(x) for x in _inputs(case, 1, False))
    before = (ak.flash_attention_block.launches,
              ak.flash_attention_backward_block.launches)
    kw = dict(scale=0.1, causal=True, bq=64, bkv=128)
    got = ak.flash_attention_block(q, k, v, o, m, l, 0, 0, **kw)
    want = ak.flash_attention_block_reference(q, k, v, o, m, l, 0, 0, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (ak.flash_attention_block.launches,
            ak.flash_attention_backward_block.launches) == before
