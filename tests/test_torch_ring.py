"""The port's ring, zigzag and Ulysses attention
(``tpu_distalg_torch/parallel/ring.py``) against the JAX package's
``parallel/ring.py`` on ``mesh8``, and against the numpy dense oracle, on
the CPU. One counterpart for each of the 26 tests of
``tests/test_ring.py``, on the same inputs.

The port takes and returns the global arrays that JAX's
``data_parallel(f, mesh8, in_specs=P("data", …), out_specs=P("data", …))``
takes and returns, so the two are compared array to array. Its flash
path runs the plain versions of kernels B11 and B12 on the CPU. JAX's
flash path is compared where this jaxlib runs it under ``shard_map``
(the configurations of ``tests/test_ring.py:341``, ``:666`` and
``:696``); the three tests skipped there are held to the dense oracle
and to JAX's XLA path instead.

Tolerances: outputs against JAX's XLA path and the dense oracle, and
gradients against ``jax.grad`` of JAX's XLA path or of the dense oracle,
within rtol = atol = 2e-4 and 1e-4, the bounds of ``tests/test_ring.py``;
the all-to-all exchanges are permutations and must be equal exactly, as
must the zigzag permutations.
"""

from __future__ import annotations

import os
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpu_distalg.parallel import data_parallel, parallelize
from tpu_distalg.parallel import ring as jring
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.parallel import ring
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

OUT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pmesh8():
    return get_mesh(data=8, device="cpu")


def _dense_attention(q, k, v, causal=False):
    """NumPy oracle (``tests/test_ring.py``'s), KV heads repeated for
    GQA."""
    single = q.ndim == 2
    if single:
        q, k, v = (x[:, None, :] for x in (q, k, v))
    g = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    d = q.shape[-1]
    scores = np.einsum("qhd,khd->hqk", q, k) / np.sqrt(d)
    if causal:
        mask = np.arange(q.shape[0])[:, None] >= np.arange(k.shape[0])
        scores = np.where(mask[None], scores, -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    out = np.einsum("hqk,khd->qhd", p / p.sum(-1, keepdims=True), v)
    return out[:, 0, :] if single else out


def _jax_ring(fn, mesh8, *arrays, out_spec=None, **kw):
    """JAX's ``fn`` under ``data_parallel`` on mesh8: the global output."""
    spec = P("data", *([None] * (arrays[0].ndim - 1)))
    f = data_parallel(functools.partial(fn, **kw), mesh8,
                      in_specs=(spec,) * len(arrays),
                      out_specs=out_spec or spec)
    shards = [parallelize(a, mesh8).data for a in arrays]
    return np.asarray(jax.jit(f)(*shards))


def _jax_grads(fn, mesh8, q, k, v, **kw):
    """``jax.grad`` of Σ out² through JAX's ``fn`` on mesh8."""
    spec = P("data", None, None)
    f = data_parallel(functools.partial(fn, **kw), mesh8,
                      in_specs=(spec,) * 3, out_specs=spec)

    def loss(q_, k_, v_):
        return jnp.sum(f(q_, k_, v_) ** 2)

    shards = [parallelize(a, mesh8).data for a in (q, k, v)]
    return [np.asarray(g) for g in
            jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*shards)]


def _dense_grads(q, k, v):
    """``jax.grad`` of Σ out² through dense causal attention with KV
    heads repeated (``tests/test_ring.py``'s oracle)."""
    S, d = q.shape[0], q.shape[-1]
    g = q.shape[1] // k.shape[1]

    def dense_loss(q_, k_, v_):
        kr, vr = jnp.repeat(k_, g, axis=1), jnp.repeat(v_, g, axis=1)
        sc = jnp.einsum("qhd,khd->hqk", q_, kr) / np.sqrt(np.float32(d))
        mask = jnp.arange(S)[:, None] >= jnp.arange(S)[None, :]
        p = jax.nn.softmax(jnp.where(mask[None], sc, -jnp.inf), axis=-1)
        return jnp.sum(jnp.einsum("hqk,khd->qhd", p, vr) ** 2)

    return [np.asarray(x) for x in jax.grad(dense_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port(fn, mesh, *arrays, **kw):
    return fn(*(torch.as_tensor(a) for a in arrays), mesh, **kw).numpy()


def _port_grads(fn, mesh, q, k, v, **kw):
    """Gradients of Σ out² through the port's ``fn`` (autograd; its
    flash path through the ``autograd.Function`` and kernel B12)."""
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (fn(*ts, mesh, **kw) ** 2).sum().backward()
    return [t.grad.numpy() for t in ts]


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_ring_allgather_matmul(mesh8, pmesh8):
    rng = np.random.default_rng(0)
    A, B = _normal(rng, 64, 16), _normal(rng, 64, 16)
    got = ring.ring_allgather_matmul(torch.as_tensor(A), torch.as_tensor(B),
                                     pmesh8).numpy()
    want = _jax_ring(jring.ring_allgather_matmul, mesh8, A, B)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, A @ B.T, rtol=1e-4, atol=1e-4)


def test_ring_attention_matches_dense(mesh8, pmesh8):
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, 128, 32) for _ in range(3))
    got = _port(ring.ring_attention, pmesh8, q, k, v)
    np.testing.assert_allclose(
        got, _jax_ring(jring.ring_attention, mesh8, q, k, v), **OUT_TOL)
    np.testing.assert_allclose(got, _dense_attention(q, k, v), **OUT_TOL)


def test_ring_attention_long_sequence_stability(mesh8, pmesh8):
    rng = np.random.default_rng(2)
    q, k = (_normal(rng, 64, 8) * 30 for _ in range(2))
    v = _normal(rng, 64, 8)
    got = _port(ring.ring_attention, pmesh8, q, k, v)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, _jax_ring(jring.ring_attention, mesh8, q, k, v), **OUT_TOL)


def test_alltoall_seq_to_head(mesh8, pmesh8):
    """The exchange as global arrays: shard j holds the full sequence of
    head group j — JAX's all_to_all output, equal exactly — and
    regrouped it is x again."""
    rng = np.random.default_rng(3)
    S, H, d = 64, 8, 4
    x = _normal(rng, S, H, d)
    got = ring.alltoall_seq_to_head(torch.as_tensor(x), pmesh8).numpy()
    want = _jax_ring(jring.alltoall_seq_to_head, mesh8, x)
    np.testing.assert_array_equal(got, want)
    back = got.reshape(8, S, H // 8, d).transpose(1, 0, 2, 3).reshape(
        S, H, d)
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ring_attention_kv_chunked_matches_unchunked(chunk, mesh8, pmesh8):
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, 128, 16) for _ in range(3))
    got = _port(ring.ring_attention, pmesh8, q, k, v, kv_chunk=chunk)
    np.testing.assert_allclose(got, _jax_ring(
        jring.ring_attention, mesh8, q, k, v, kv_chunk=chunk), **OUT_TOL)
    np.testing.assert_allclose(got, _dense_attention(q, k, v), **OUT_TOL)


def test_ring_attention_kv_chunk_validation(pmesh8):
    x = torch.as_tensor(_normal(np.random.default_rng(4), 64, 8))
    with pytest.raises(ValueError, match="kv_chunk"):
        ring.ring_attention(x, x, x, pmesh8, kv_chunk=3)


def test_ring_attention_kv_chunk_oversized_degrades(pmesh8):
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, 64, 8) for _ in range(3))
    np.testing.assert_allclose(
        _port(ring.ring_attention, pmesh8, q, k, v, kv_chunk=4096),
        _port(ring.ring_attention, pmesh8, q, k, v), rtol=1e-6)


def test_ring_attention_multihead_matches_dense(mesh8, pmesh8):
    rng = np.random.default_rng(6)
    q, k, v = (_normal(rng, 64, 4, 16) for _ in range(3))
    got = _port(ring.ring_attention, pmesh8, q, k, v)
    np.testing.assert_allclose(
        got, _jax_ring(jring.ring_attention, mesh8, q, k, v), **OUT_TOL)
    np.testing.assert_allclose(got, _dense_attention(q, k, v), **OUT_TOL)


def test_ring_attention_causal_matches_dense(mesh8, pmesh8):
    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, 64, 8) for _ in range(3))
    got = _port(ring.ring_attention, pmesh8, q, k, v, causal=True)
    np.testing.assert_allclose(got, _jax_ring(
        jring.ring_attention, mesh8, q, k, v, causal=True), **OUT_TOL)
    np.testing.assert_allclose(got, _dense_attention(q, k, v, causal=True),
                               **OUT_TOL)


@pytest.mark.parametrize("chunk", [4, 8])
def test_ring_attention_causal_multihead_chunked(chunk, mesh8, pmesh8):
    rng = np.random.default_rng(8)
    q, k, v = (_normal(rng, 128, 2, 8) for _ in range(3))
    kw = dict(causal=True, kv_chunk=chunk)
    got = _port(ring.ring_attention, pmesh8, q, k, v, **kw)
    np.testing.assert_allclose(got, _jax_ring(
        jring.ring_attention, mesh8, q, k, v, **kw), **OUT_TOL)
    np.testing.assert_allclose(got, _dense_attention(q, k, v, causal=True),
                               **OUT_TOL)


def test_alltoall_head_to_seq_roundtrip(mesh8, pmesh8):
    rng = np.random.default_rng(9)
    x = _normal(rng, 64, 8, 4)
    mid = ring.alltoall_seq_to_head(torch.as_tensor(x), pmesh8)
    got = ring.alltoall_head_to_seq(mid, pmesh8).numpy()
    np.testing.assert_array_equal(got, x)
    # head_to_seq alone against JAX's, on a head-sharded global array
    y = _normal(rng, 8 * 64, 1, 4)
    np.testing.assert_array_equal(
        ring.alltoall_head_to_seq(torch.as_tensor(y), pmesh8).numpy(),
        _jax_ring(jring.alltoall_head_to_seq, mesh8, y))


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_dense(causal, mesh8, pmesh8):
    rng = np.random.default_rng(10)
    q, k, v = (_normal(rng, 64, 8, 16) for _ in range(3))
    got = _port(ring.ulysses_attention, pmesh8, q, k, v, causal=causal)
    np.testing.assert_allclose(got, _jax_ring(
        jring.ulysses_attention, mesh8, q, k, v, causal=causal), **OUT_TOL)
    np.testing.assert_allclose(
        got, _dense_attention(q, k, v, causal=causal), **OUT_TOL)


def test_ulysses_matches_ring(pmesh8):
    rng = np.random.default_rng(11)
    q, k, v = (_normal(rng, 64, 8, 8) for _ in range(3))
    np.testing.assert_allclose(
        _port(ring.ring_attention, pmesh8, q, k, v, causal=True),
        _port(ring.ulysses_attention, pmesh8, q, k, v, causal=True),
        **OUT_TOL)


@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_attention_gradients_match_dense(which, mesh8, pmesh8):
    """Autograd through the port's torch-op ring and Ulysses exchanges
    equals ``jax.grad`` through JAX's, and the dense oracle's."""
    rng = np.random.default_rng(12)
    q, k, v = (_normal(rng, 64, 8, 8) for _ in range(3))
    pfn = {"ring": ring.ring_attention,
           "ulysses": ring.ulysses_attention}[which]
    jfn = {"ring": jring.ring_attention,
           "ulysses": jring.ulysses_attention}[which]
    got = _port_grads(pfn, pmesh8, q, k, v, causal=True)
    want = _jax_grads(jfn, mesh8, q, k, v, causal=True)
    for a, b, c in zip(got, want, _dense_grads(q, k, v)):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
        np.testing.assert_allclose(a, c, **GRAD_TOL)


def test_flash_ring_gradients_match_xla_path(mesh8, pmesh8):
    """The flash ring's ``autograd.Function`` (B11 forward, the B12 ring
    backward) against ``jax.grad`` of JAX's XLA ring and of JAX's flash
    ring (``tests/test_ring.py:341``'s configuration)."""
    rng = np.random.default_rng(17)
    q, k, v = (_normal(rng, 1024, 2, 128) for _ in range(3))
    flash = dict(use_flash=True, flash_block_q=128, flash_block_kv=128)
    got = _port_grads(ring.ring_attention, pmesh8, q, k, v, causal=True,
                      **flash)
    want = _jax_grads(jring.ring_attention, mesh8, q, k, v, causal=True)
    jflash = _jax_grads(jring.ring_attention, mesh8, q, k, v, causal=True,
                        flash_interpret=True, **flash)
    for a, b, c in zip(got, want, jflash):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
        np.testing.assert_allclose(a, c, **GRAD_TOL)


def test_ulysses_flash_gradients_match_dense(mesh8, pmesh8):
    rng = np.random.default_rng(19)
    q, k, v = (_normal(rng, 512, 8, 128) for _ in range(3))
    got = _port_grads(ring.ulysses_attention, pmesh8, q, k, v, causal=True,
                      use_flash=True)
    want = _jax_grads(jring.ulysses_attention, mesh8, q, k, v, causal=True)
    for a, b, c in zip(got, want, _dense_grads(q, k, v)):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
        np.testing.assert_allclose(a, c, **GRAD_TOL)


def test_flash_ring_gradients_noncausal_multitile(mesh8, pmesh8):
    """Skipped in ``tests/test_ring.py`` on this jaxlib: non-causal,
    2×2 backward tiles a step, GQA (H 2 over 1 KV head); the port's
    flash gradients against ``jax.grad`` of JAX's XLA ring."""
    rng = np.random.default_rng(20)
    q = _normal(rng, 2048, 2, 128)
    k, v = _normal(rng, 2048, 1, 128), _normal(rng, 2048, 1, 128)
    got = _port_grads(ring.ring_attention, pmesh8, q, k, v, use_flash=True,
                      flash_block_q=128, flash_block_kv=128)
    want = _jax_grads(jring.ring_attention, mesh8, q, k, v)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_flash_backward_block_halves_to_divisor(pmesh8):
    """The dense flash path on S 384, a length no power of two divides
    (its blocks clamp to 384): its gradients equal autograd through the
    dense torch-op path. The halving of a non-dividing backward block
    itself is held against JAX in
    ``tests/test_torch_attention_kernels.py``."""
    rng = np.random.default_rng(21)
    q, k, v = (_normal(rng, 384, 1, 128) for _ in range(3))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (ring.softmax_attention(*ts, causal=True, use_flash=True) ** 2
     ).sum().backward()
    us = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (ring.softmax_attention(*us, causal=True) ** 2).sum().backward()
    for a, b in zip(ts, us):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_flash_matches_dense(causal, mesh8, pmesh8):
    """Skipped in ``tests/test_ring.py`` on this jaxlib: the flash ring
    with several tiles a step (4×2 here: S 2048 over 8 shards, blocks
    64 × 128, where JAX's test takes S 4096 and 4×4), against the dense
    oracle and JAX's XLA ring."""
    rng = np.random.default_rng(13)
    q, k, v = (_normal(rng, 2048, 2, 128) for _ in range(3))
    got = _port(ring.ring_attention, pmesh8, q, k, v, causal=causal,
                use_flash=True, flash_block_q=64, flash_block_kv=128)
    np.testing.assert_allclose(
        got, _dense_attention(q, k, v, causal=causal), **OUT_TOL)
    np.testing.assert_allclose(got, _jax_ring(
        jring.ring_attention, mesh8, q, k, v, causal=causal), **OUT_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_flash_matches_dense(causal, mesh8, pmesh8):
    rng = np.random.default_rng(14)
    q, k, v = (_normal(rng, 512, 8, 128) for _ in range(3))
    got = _port(ring.ulysses_attention, pmesh8, q, k, v, causal=causal,
                use_flash=True)
    np.testing.assert_allclose(
        got, _dense_attention(q, k, v, causal=causal), **OUT_TOL)
    np.testing.assert_allclose(got, _jax_ring(
        jring.ulysses_attention, mesh8, q, k, v, causal=causal), **OUT_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_flash_gqa_matches_dense(causal, mesh8, pmesh8):
    """Skipped in ``tests/test_ring.py`` on this jaxlib: GQA through the
    flash ring, against the repeated-KV oracle and JAX's XLA ring."""
    rng = np.random.default_rng(15)
    q = _normal(rng, 1024, 8, 128)
    k, v = _normal(rng, 1024, 2, 128), _normal(rng, 1024, 2, 128)
    got = _port(ring.ring_attention, pmesh8, q, k, v, causal=causal,
                use_flash=True, flash_block_q=128, flash_block_kv=128)
    np.testing.assert_allclose(
        got, _dense_attention(q, k, v, causal=causal), **OUT_TOL)
    np.testing.assert_allclose(got, _jax_ring(
        jring.ring_attention, mesh8, q, k, v, causal=causal), **OUT_TOL)


@pytest.mark.parametrize("fn,kw", [
    ("ring", dict(causal=True)),
    ("ring", dict(causal=True, kv_chunk=4)),
    ("ulysses", dict(causal=True)),
], ids=["ring", "ring_chunked", "ulysses"])
def test_ring_attention_gqa_xla_path_matches_dense(fn, kw, mesh8, pmesh8):
    rng = np.random.default_rng(16)
    q = _normal(rng, 64, 16, 16)
    k, v = _normal(rng, 64, 8, 16), _normal(rng, 64, 8, 16)
    pfn = {"ring": ring.ring_attention, "ulysses": ring.ulysses_attention}
    jfn = {"ring": jring.ring_attention,
           "ulysses": jring.ulysses_attention}
    got = _port(pfn[fn], pmesh8, q, k, v, **kw)
    np.testing.assert_allclose(
        got, _dense_attention(q, k, v, causal=True), **OUT_TOL)
    np.testing.assert_allclose(
        got, _jax_ring(jfn[fn], mesh8, q, k, v, **kw), **OUT_TOL)


@pytest.mark.parametrize("flash", [False, True], ids=["xla", "flash"])
def test_gqa_gradients_match_repeated_kv_oracle(flash, mesh8, pmesh8):
    """GQA backward, dK/dV summed over each KV head's query group: the
    port's torch-op and flash rings against the dense oracle and
    ``jax.grad`` of JAX's ring on the same path
    (``tests/test_ring.py:666``)."""
    rng = np.random.default_rng(18)
    q = _normal(rng, 1024, 4, 128)
    k, v = _normal(rng, 1024, 2, 128), _normal(rng, 1024, 2, 128)
    kw = dict(causal=True)
    jkw = {}
    if flash:
        kw.update(use_flash=True, flash_block_q=64, flash_block_kv=128)
        jkw = dict(flash_interpret=True)
    got = _port_grads(ring.ring_attention, pmesh8, q, k, v, **kw)
    want = _jax_grads(jring.ring_attention, mesh8, q, k, v, **kw, **jkw)
    for a, b, c in zip(got, want, _dense_grads(q, k, v)):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
        np.testing.assert_allclose(a, c, **GRAD_TOL)


@pytest.mark.parametrize("flash", [False, True], ids=["xla", "flash"])
def test_zigzag_causal_ring_matches_dense(flash, mesh8, pmesh8):
    """The zigzag layout on both paths against the dense oracle after
    undoing the layout, and against JAX's zigzag ring on the same path
    (``tests/test_ring.py:696``)."""
    rng = np.random.default_rng(22)
    S = 2048
    q, k, v = (_normal(rng, S, 2, 128) for _ in range(3))
    p, inv = ring.zigzag_order(8, S), ring.zigzag_inverse(8, S)
    np.testing.assert_array_equal(p, jring.zigzag_order(8, S))
    np.testing.assert_array_equal(inv, jring.zigzag_inverse(8, S))
    kw = dict(causal=True, layout="zigzag")
    jkw = {}
    if flash:
        kw.update(use_flash=True, flash_block_q=128, flash_block_kv=128)
        jkw = dict(flash_interpret=True)
    got = _port(ring.ring_attention, pmesh8, q[p], k[p], v[p], **kw)
    np.testing.assert_allclose(
        got[inv], _dense_attention(q, k, v, causal=True), **OUT_TOL)
    np.testing.assert_allclose(got, _jax_ring(
        jring.ring_attention, mesh8, q[p], k[p], v[p], **kw, **jkw),
        **OUT_TOL)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "xla"])
def test_zigzag_gradients_match_dense(flash, mesh8, pmesh8):
    """Zigzag backward (GQA, H 2 over 1 KV head): the flash
    ``autograd.Function`` and autograd through the torch-op zigzag
    against the dense oracle after undoing the layout, and both against
    ``jax.grad`` of JAX's XLA zigzag."""
    rng = np.random.default_rng(23)
    S = 2048
    q = _normal(rng, S, 2, 128)
    k, v = _normal(rng, S, 1, 128), _normal(rng, S, 1, 128)
    p, inv = ring.zigzag_order(8, S), ring.zigzag_inverse(8, S)
    kw = dict(causal=True, layout="zigzag")
    if flash:
        kw.update(use_flash=True, flash_block_q=128, flash_block_kv=128)
    got = _port_grads(ring.ring_attention, pmesh8, q[p], k[p], v[p], **kw)
    for a, b in zip(got, _dense_grads(q, k, v)):
        np.testing.assert_allclose(a[inv], b, **GRAD_TOL)
    want = _jax_grads(jring.ring_attention, mesh8, q[p], k[p], v[p],
                      causal=True, layout="zigzag")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("kw,msg", [
    (dict(layout="zigzag"), "zigzag"),
    (dict(layout="zigzag", causal=True, kv_chunk=4), "kv_chunk"),
    (dict(layout="spiral"), "layout"),
], ids=["noncausal", "kv_chunk", "unknown"])
def test_zigzag_layout_validation(kw, msg, pmesh8):
    x = torch.as_tensor(_normal(np.random.default_rng(24), 64, 8))
    with pytest.raises(ValueError, match=msg):
        ring.ring_attention(x, x, x, pmesh8, **kw)


def test_zigzag_order_validation_like_jax():
    with pytest.raises(ValueError, match="divisible"):
        ring.zigzag_order(8, 100)
    with pytest.raises(ValueError, match="divisible"):
        jring.zigzag_order(8, 100)


def test_head_count_errors_like_jax(pmesh8):
    x = torch.zeros((64, 4, 8))
    with pytest.raises(ValueError, match="divisible by the 'data' axis"):
        ring.alltoall_seq_to_head(x, pmesh8)
    with pytest.raises(ValueError, match="query heads not divisible"):
        ring.ring_attention(torch.zeros((64, 3, 8)), x[:, :2], x[:, :2],
                            pmesh8)
