"""Ring pipelines over the emulated data axis — sequence parallelism.

Port of ``tpu_distalg/parallel/ring.py`` for one card. The JAX functions
are ``shard_map`` bodies over the ``data`` axis; each function here
takes and returns the GLOBAL arrays that JAX's
``data_parallel(f, mesh, in_specs=P("data", …), out_specs=P("data", …))``
takes and returns: shard i is rows [i·S_local, (i+1)·S_local) of the
sequence axis (the first), for ``mesh.n_data`` shards. A ring hop is a
change of the K/V shard index, not a copy; the loops visit shards and
steps in JAX's order, so every online-softmax update and every gradient
accumulator adds in JAX's order.

  * :func:`ring_allgather_matmul` — A·Bᵀ with both operands row-sharded;
  * :func:`ring_attention` — exact blockwise attention with the
    online-softmax state (o, m, l) carried around the ring, multi-head,
    grouped-query, causal on global positions, ``kv_chunk`` tiling of
    the torch-op path, the balanced ``layout='zigzag'``, and
    ``use_flash=True`` through kernel B11 forward and B12 backward
    (``ops/attention_kernels.py``), differentiable through a
    ``torch.autograd.Function`` whose backward is the second ring of
    B12 with the dK/dV accumulators travelling with their blocks;
  * :func:`ulysses_attention` — DeepSpeed-Ulysses: sequence → head
    exchange, dense (or flash) attention per head group over the full
    sequence, and the inverse exchange; :func:`softmax_attention` is the
    dense oracle and that local attention.

The torch-op path (``use_flash=False``) is differentiated by autograd,
as JAX differentiates its XLA path. Outputs are float32, like JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_distalg_torch.ops import attention_kernels as ak

#: the mesh axis the JAX package shards sequences over (error messages)
DATA_AXIS = "data"


def _n_shards(mesh, *tensors) -> int:
    n = int(mesh.n_data)
    for t in tensors:
        if t.device.type != mesh.device.type:
            raise ValueError(f"operand on {t.device}, mesh on {mesh.device}")
        if t.shape[0] % n:
            raise ValueError(
                f"sequence length {t.shape[0]} not divisible by the "
                f"'{DATA_AXIS}' axis size {n}")
    return n


def _shards(x, n: int):
    """(S, H, d) global → (n, H, S/n, d): shard i's (H, S_local, d)
    block, contiguous (JAX's per-shard ``moveaxis(x, 1, 0)``)."""
    s, h, d = x.shape
    return x.reshape(n, s // n, h, d).permute(0, 2, 1, 3).contiguous()


def _unshard(x):
    """Inverse of :func:`_shards`: (n, H, S_local, d) → (n·S_local, H, d)."""
    n, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(n * s, h, d)


def _chunks(x, n: int):
    """(S, H, d) global → (n, 2, H, c, d): shard i's two zigzag chunks,
    each contiguous."""
    s, h, d = x.shape
    c = s // (2 * n)
    return x.reshape(n, 2, c, h, d).permute(0, 1, 3, 2, 4).contiguous()


def _unchunk(x):
    n, two, h, c, d = x.shape
    return x.permute(0, 1, 3, 2, 4).reshape(n * two * c, h, d)


def _scale(scale, d: int) -> float:
    return scale if scale is not None else 1.0 / (d ** 0.5)


def _f32(x):
    return x.to(torch.float32)


def ring_allgather_matmul(a, b, mesh):
    """A·Bᵀ with A (Sa, d) and B (Sb, d) row-sharded: each shard's rows
    of the (Sa, Sb) float32 product, assembled block by block as the B
    blocks pass around the ring (``torch.matmul`` per block)."""
    n = _n_shards(mesh, a, b)
    sa, sb = a.shape[0] // n, b.shape[0] // n
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32,
                      device=a.device)
    af, bf = _f32(a), _f32(b)
    for my in range(n):
        for i in range(n):
            src = (my - i) % n       # the block resident at step i
            out[my * sa:(my + 1) * sa, src * sb:(src + 1) * sb] = (
                af[my * sa:(my + 1) * sa] @ bf[src * sb:(src + 1) * sb].T)
    return out


def _online_update(qh, o, m, l, kh, vh, scale, mask):
    """One online-softmax step over a resident K/V chunk (the torch-op
    path). ``qh`` (H, Sq, d); ``kh, vh`` (H_kv, C, d), query heads
    [hk·g, hk·g+g) reading KV head hk; state ``o`` (H, Sq, d), ``m, l``
    (H, Sq); ``mask`` (Sq, C) boolean (True = attend) or None. While a
    row's ``m`` is still −inf its rescale and probabilities are 0, not
    exp(−inf − −inf) = NaN."""
    h, s_q, d = qh.shape
    h_kv, c = kh.shape[0], kh.shape[1]
    g = h // h_kv
    scores = torch.einsum("hgqd,hkd->hgqk",
                          _f32(qh).reshape(h_kv, g, s_q, d),
                          _f32(kh)).reshape(h, s_q, c) * scale
    if mask is not None:
        scores = torch.where(mask[None], scores, float("-inf"))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    safe = ~torch.isneginf(m_new)
    alpha = torch.where(safe, torch.exp(m - m_new), 0.0)
    p = torch.where(safe[..., None], torch.exp(scores - m_new[..., None]),
                    0.0)
    l = l * alpha + p.sum(dim=-1)
    pv = _f32(p.to(vh.dtype)).reshape(h_kv, g, s_q, c)
    upd = torch.einsum("hgqk,hkd->hgqd", pv, _f32(vh)).reshape(h, s_q, d)
    return o * alpha[..., None] + upd, m_new, l


def zigzag_order(n_shards: int, n_rows: int):
    """Row permutation for the balanced causal ring layout: lay a
    global (S, ...) array out as ``x[zigzag_order(n, S)]``; shard s then
    holds global chunks (s, 2n−1−s). ``S`` must divide into 2n chunks."""
    if n_rows % (2 * n_shards):
        raise ValueError(
            f"zigzag_order: {n_rows} rows not divisible by "
            f"2·n_shards={2 * n_shards}")
    c = n_rows // (2 * n_shards)
    parts = []
    for s in range(n_shards):
        parts.append(np.arange(s * c, (s + 1) * c))
        parts.append(np.arange((2 * n_shards - 1 - s) * c,
                               (2 * n_shards - s) * c))
    return np.concatenate(parts)


def zigzag_inverse(n_shards: int, n_rows: int):
    """Inverse permutation: ``zigzag_out[zigzag_inverse]`` is in natural
    position order."""
    p = zigzag_order(n_shards, n_rows)
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    return inv


def _state0(h, s, d, device):
    return (torch.zeros((h, s, d), dtype=torch.float32, device=device),
            torch.full((h, s), float("-inf"), dtype=torch.float32,
                       device=device),
            torch.zeros((h, s), dtype=torch.float32, device=device))


def _flash_update(qc, kc, vc, st, q0, k0, *, scale, causal, bq, bkv):
    o, m, l = st
    o, m, l = ak.flash_attention_block(
        qc, kc, vc, o, m[..., None], l[..., None], q0, k0, scale=scale,
        causal=causal, bq=bq, bkv=bkv)
    return o, m[..., 0], l[..., 0]


def _heads(q, k, what="ring_attention"):
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"{what}: {q.shape[1]} query heads not divisible by "
            f"{k.shape[1]} KV heads")


def _ring_impl(q, k, v, n, *, scale, kv_chunk, causal, use_flash, bq, bkv,
               return_stats=False):
    """The contiguous ring, forward. Returns (S, H, d) float32, and with
    ``return_stats`` the per-shard logsumexp (n, H, S_local, 1)."""
    _heads(q, k)
    s_glob, h, d = q.shape
    s_q, s_local = s_glob // n, k.shape[0] // n
    s = _scale(scale, d)
    if not use_flash and kv_chunk is not None and (
            kv_chunk < 1 or (kv_chunk < s_local and s_local % kv_chunk)):
        raise ValueError(
            f"kv_chunk={kv_chunk} must be >= 1 and divide the local "
            f"K/V length {s_local}")
    qz, kz, vz = _shards(q, n), _shards(k, n), _shards(v, n)

    def process_block(qh, kh, vh, st, my, src):
        if use_flash:
            return _flash_update(qh, kh, vh, st, my * s_q, src * s_local,
                                 scale=s, causal=causal, bq=bq, bkv=bkv)
        q_pos = my * s_q + torch.arange(s_q, device=q.device)
        chunk = s_local if kv_chunk is None else min(kv_chunk, s_local)
        for c0 in range(0, s_local, chunk):
            mask = None
            if causal:
                k_pos = src * s_local + c0 + torch.arange(chunk,
                                                          device=q.device)
                mask = q_pos[:, None] >= k_pos[None, :]
            st = _online_update(qh, *st, kh[:, c0:c0 + chunk],
                                vh[:, c0:c0 + chunk], s, mask)
        return st

    outs, lses = [], []
    for my in range(n):
        st = _state0(h, s_q, d, q.device)
        for i in range(n):
            src = (my - i) % n       # the block resident at step i
            if causal and src > my:
                continue             # a later shard's block: all masked
            st = process_block(qz[my], kz[src], vz[src], st, my, src)
        o, m, l = st
        outs.append(o / l[..., None])
        lses.append((m + torch.log(l))[..., None])
    out = _unshard(torch.stack(outs))
    if return_stats:
        return out, torch.stack(lses)
    return out


def _ring_flash_backward(q, k, v, out, lse, g, n, *, scale, causal, bq,
                         bkv):
    """The second ring: B12 on every live (shard, block) pair. dQ
    accumulates on its shard; block b's dK/dV accumulator travels with
    the block, collecting shard b's contribution first, then b+1's, in
    JAX's ring order."""
    s_glob, h, d = q.shape
    s_q, s_local = s_glob // n, k.shape[0] // n
    s = _scale(scale, d)
    qz, kz, vz = _shards(q, n), _shards(k, n), _shards(v, n)
    doz, oz = _shards(_f32(g), n), _shards(_f32(out), n)
    delta = (doz * oz).sum(dim=-1, keepdim=True)   # (n, H, S_q, 1)
    dq = [torch.zeros((h, s_q, d), dtype=torch.float32, device=q.device)
          for _ in range(n)]
    dk = [torch.zeros(kz.shape[1:], dtype=torch.float32, device=q.device)
          for _ in range(n)]
    dv = [torch.zeros_like(x) for x in dk]
    for i in range(n):
        for my in range(n):
            src = (my - i) % n
            if causal and src > my:
                continue
            dq_c, dk_c, dv_c = ak.flash_attention_backward_block(
                qz[my], kz[src], vz[src], doz[my], lse[my], delta[my],
                my * s_q, src * s_local, scale=s, causal=causal, bq=bq,
                bkv=bkv)
            dq[my] = dq[my] + dq_c
            dk[src] = dk[src] + dk_c
            dv[src] = dv[src] + dv_c
    return (_unshard(torch.stack(dq)).to(q.dtype),
            _unshard(torch.stack(dk)).to(k.dtype),
            _unshard(torch.stack(dv)).to(v.dtype))


class _RingFlash(torch.autograd.Function):
    """The contiguous flash ring: forward B11, backward the B12 ring."""

    @staticmethod
    def forward(ctx, q, k, v, n, scale, causal, bq, bkv):
        out, lse = _ring_impl(q, k, v, n, scale=scale, kv_chunk=None,
                              causal=causal, use_flash=True, bq=bq, bkv=bkv,
                              return_stats=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (n, scale, causal, min(bq, ak.BWD_BLOCK_MAX),
                   min(bkv, ak.BWD_BLOCK_MAX))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        n, scale, causal, bq, bkv = ctx.cfg
        dq, dk, dv = _ring_flash_backward(q, k, v, out, lse, g, n,
                                          scale=scale, causal=causal,
                                          bq=bq, bkv=bkv)
        return dq, dk, dv, None, None, None, None, None


def _zigzag_pairs(my, src, n, c):
    """Global start offsets (qC, qD, kA, kB) of a step's chunk-pairs:
    shard s holds chunks (s, 2n−1−s) of c rows. Of the four (q-chunk,
    kv-chunk) pairs, (C, B) is all masked, (D, A) all attend, and (C, A)
    and (D, B) live when src <= my and src >= my."""
    return (my * c, (2 * n - 1 - my) * c, src * c, (2 * n - 1 - src) * c)


def _zigzag_impl(q, k, v, n, *, scale, use_flash, bq, bkv,
                 return_stats=False):
    """The zigzag ring, forward (JAX's ``_zigzag_impl``). Returns the
    (S, H, d) float32 output in the zigzag layout, and with
    ``return_stats`` the logsumexp (n, 2, H, c, 1)."""
    s_glob, h, d = q.shape
    s_q = s_glob // n
    if s_q % 2 or k.shape[0] // n != s_q:
        raise ValueError(
            f"zigzag ring: local length {s_q} must be even (two "
            f"chunks) and q/k lengths equal (got k {k.shape[0] // n})")
    _heads(q, k)
    c = s_q // 2
    s = _scale(scale, d)
    qz, kz, vz = _chunks(q, n), _chunks(k, n), _chunks(v, n)

    def upd(qc, kc, vc, st, q0, k0, causal_pair):
        if use_flash:
            return _flash_update(qc, kc, vc, st, q0, k0, scale=s,
                                 causal=causal_pair, bq=bq, bkv=bkv)
        mask = None
        if causal_pair:
            ar = torch.arange(c, device=q.device)
            mask = (q0 + ar)[:, None] >= (k0 + ar)[None, :]
        return _online_update(qc, *st, kc, vc, s, mask)

    outs, lses = [], []
    for my in range(n):
        st_c = _state0(h, c, d, q.device)
        st_d = _state0(h, c, d, q.device)
        for i in range(n):
            src = (my - i) % n
            qc0, qd0, ka0, kb0 = _zigzag_pairs(my, src, n, c)
            if src <= my:
                st_c = upd(qz[my, 0], kz[src, 0], vz[src, 0], st_c, qc0,
                           ka0, True)
            st_d = upd(qz[my, 1], kz[src, 0], vz[src, 0], st_d, qd0, ka0,
                       False)
            if src >= my:
                st_d = upd(qz[my, 1], kz[src, 1], vz[src, 1], st_d, qd0,
                           kb0, True)
        outs.append(torch.stack([st[0] / st[2][..., None]
                                 for st in (st_c, st_d)]))
        lses.append(torch.stack([(st[1] + torch.log(st[2]))[..., None]
                                 for st in (st_c, st_d)]))
    out = _unchunk(torch.stack(outs))
    if return_stats:
        return out, torch.stack(lses)
    return out


def _zigzag_flash_backward(q, k, v, out, lse, g, n, *, scale, bq, bkv):
    """Zigzag mirror of :func:`_ring_flash_backward`: the same three live
    chunk-pairs per step, dK/dV accumulators travelling with their
    blocks, dQ accumulating per local chunk."""
    s_glob, h, d = q.shape
    c = s_glob // n // 2
    s = _scale(scale, d)
    qz, kz, vz = _chunks(q, n), _chunks(k, n), _chunks(v, n)
    doz, oz = _chunks(_f32(g), n), _chunks(_f32(out), n)
    delta = (doz * oz).sum(dim=-1, keepdim=True)   # (n, 2, H, c, 1)

    def acc(like):             # [shard][chunk] float32 accumulators
        return [[torch.zeros(like.shape[2:], dtype=torch.float32,
                             device=q.device) for _ in range(2)]
                for _ in range(n)]

    dq, dk, dv = acc(qz), acc(kz), acc(kz)

    def pair(my, src, qi, ki, q0, k0, causal_pair):
        dq_c, dk_c, dv_c = ak.flash_attention_backward_block(
            qz[my, qi], kz[src, ki], vz[src, ki], doz[my, qi],
            lse[my, qi], delta[my, qi], q0, k0, scale=s,
            causal=causal_pair, bq=bq, bkv=bkv)
        dq[my][qi] = dq[my][qi] + dq_c
        dk[src][ki] = dk[src][ki] + dk_c
        dv[src][ki] = dv[src][ki] + dv_c

    for i in range(n):
        for my in range(n):
            src = (my - i) % n
            qc0, qd0, ka0, kb0 = _zigzag_pairs(my, src, n, c)
            if src <= my:
                pair(my, src, 0, 0, qc0, ka0, True)
            pair(my, src, 1, 0, qd0, ka0, False)
            if src >= my:
                pair(my, src, 1, 1, qd0, kb0, True)

    def glob(parts, dtype):
        return _unchunk(torch.stack([torch.stack(p) for p in parts])
                        ).to(dtype)

    return glob(dq, q.dtype), glob(dk, k.dtype), glob(dv, v.dtype)


class _ZigzagFlash(torch.autograd.Function):
    """The zigzag flash ring: forward B11, backward the B12 ring."""

    @staticmethod
    def forward(ctx, q, k, v, n, scale, bq, bkv):
        out, lse = _zigzag_impl(q, k, v, n, scale=scale, use_flash=True,
                                bq=bq, bkv=bkv, return_stats=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (n, scale, min(bq, ak.BWD_BLOCK_MAX),
                   min(bkv, ak.BWD_BLOCK_MAX))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        n, scale, bq, bkv = ctx.cfg
        dq, dk, dv = _zigzag_flash_backward(q, k, v, out, lse, g, n,
                                            scale=scale, bq=bq, bkv=bkv)
        return dq, dk, dv, None, None, None, None


def _single_head(fn, q, k, v, *args, **kw):
    """Run ``fn`` on (S, H, d) operands; (S, d) ones get a head axis
    and lose it again."""
    if q.dim() == 2:
        return fn(q[:, None], k[:, None], v[:, None], *args, **kw)[:, 0]
    return fn(q, k, v, *args, **kw)


def ring_attention(q, k, v, mesh, *, scale: float | None = None,
                   kv_chunk: int | None = None, causal: bool = False,
                   use_flash: bool = False, flash_block_q: int = 2048,
                   flash_block_kv: int = 2048, layout: str = "contiguous"):
    """Exact attention over a sequence sharded around the ring.

    ``q`` (S, d) or (S, H, d), ``k, v`` (S, d) or (S, H_kv, d), global
    and sequence-sharded over ``mesh.n_data`` shards (shard i holds
    positions [i·S_local, (i+1)·S_local)); returns softmax(QKᵀ·scale)·V
    per head, float32, in the operands' layout. ``causal`` masks on
    global positions and skips blocks from later shards.
    ``layout='zigzag'`` (causal only, no ``kv_chunk``) expects rows laid
    out by :func:`zigzag_order`, so that shard s holds chunks
    (s, 2n−1−s) and every shard does the same work. ``kv_chunk`` bounds
    the torch-op path's score tile; ``use_flash`` runs kernel B11
    instead (block-divisible lengths, head dim a multiple of 128) and is
    differentiable through the B12 ring. The same ``ValueError``\\ s as
    the JAX package for the same bad arguments."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if layout == "zigzag":
        if not causal:
            raise ValueError(
                "layout='zigzag' exists to balance the CAUSAL ring; "
                "non-causal rings are balanced already")
        if kv_chunk is not None:
            raise ValueError(
                "layout='zigzag' does not compose with kv_chunk; use "
                "use_flash=True (tiled in VMEM) to bound memory")
    n = _n_shards(mesh, q, k, v)
    if layout == "zigzag":
        if use_flash:
            return _single_head(_ZigzagFlash.apply, q, k, v, n, scale,
                                flash_block_q, flash_block_kv)
        return _single_head(_zigzag_impl, q, k, v, n, scale=scale,
                            use_flash=False, bq=flash_block_q,
                            bkv=flash_block_kv)
    if use_flash:
        return _single_head(_RingFlash.apply, q, k, v, n, scale, causal,
                            flash_block_q, flash_block_kv)
    return _single_head(_ring_impl, q, k, v, n, scale=scale,
                        kv_chunk=kv_chunk, causal=causal, use_flash=False,
                        bq=flash_block_q, bkv=flash_block_kv)


def softmax_attention(q, k, v, *, scale: float | None = None,
                      causal: bool = False, use_flash: bool = False):
    """Dense attention, (S, H, d) × (T, H_kv, d) → (S, H, d) float32.

    Materialises the (H, S, T) scores: the local compute of
    :func:`ulysses_attention` and the oracle of the rings.
    ``use_flash=True`` runs kernel B11 instead, differentiable through
    kernel B12 (one ring step at offsets 0)."""
    d = q.shape[-1]
    _heads(q, k, "softmax_attention")
    s = _scale(scale, d)
    if use_flash:
        return _RingFlash.apply(q, k, v, 1, s, causal, 2048, 2048)
    s_q, h, _ = q.shape
    t, h_kv = k.shape[0], k.shape[1]
    g = h // h_kv
    scores = torch.einsum("qhgd,khd->hgqk",
                          _f32(q).reshape(s_q, h_kv, g, d),
                          _f32(k)).reshape(h, s_q, t) * s
    if causal:
        mask = (torch.arange(s_q, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :])
        scores = torch.where(mask[None], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum(
        "hgqk,khd->qhgd", _f32(p.to(v.dtype)).reshape(h_kv, g, s_q, t),
        _f32(v)).reshape(s_q, h, d)


def alltoall_seq_to_head(x, mesh):
    """(S, H, d) sequence-sharded → (n·S, H/n, d) head-sharded: shard j
    holds the full sequence of head group j (JAX's ``all_to_all`` over
    the data axis, as global arrays). Autograd gives the inverse
    exchange."""
    n = int(mesh.n_data)
    s, h, d = x.shape
    if h % n:
        raise ValueError(
            f"alltoall_seq_to_head: head count {h} must be divisible by "
            f"the '{DATA_AXIS}' axis size {n}")
    if s % n:
        raise ValueError(
            f"sequence length {s} not divisible by the '{DATA_AXIS}' axis "
            f"size {n}")
    return x.reshape(s, n, h // n, d).permute(1, 0, 2, 3).reshape(
        n * s, h // n, d)


def alltoall_head_to_seq(x, mesh):
    """Inverse of :func:`alltoall_seq_to_head`: (n·S, H/n, d)
    head-sharded → (S, H, d) sequence-sharded."""
    n = int(mesh.n_data)
    rows, h_l, d = x.shape
    s = rows // n
    if rows % n or s % n:
        raise ValueError(
            f"alltoall_head_to_seq: sequence length {s} must be "
            f"divisible by the '{DATA_AXIS}' axis size {n}")
    # [device i, sequence chunk j, r] → shard j's rows r of head group i
    return x.reshape(n, n, s // n, h_l, d).permute(1, 2, 0, 3, 4).reshape(
        s, n * h_l, d)


def ulysses_attention(q, k, v, mesh, *, scale: float | None = None,
                      causal: bool = False, use_flash: bool = False):
    """DeepSpeed-Ulysses sequence-parallel attention on global (S, H, d)
    operands: the exchange to head shards, :func:`softmax_attention` on
    each shard's full sequence for its head group (``use_flash``: B11,
    differentiable through B12), and the inverse exchange. Needs H and
    H_kv divisible by ``mesh.n_data``."""
    n = _n_shards(mesh, q, k, v)
    s = q.shape[0]
    qh, kh, vh = (alltoall_seq_to_head(x, mesh) for x in (q, k, v))
    o = torch.cat([
        softmax_attention(qh[j * s:(j + 1) * s], kh[j * s:(j + 1) * s],
                          vh[j * s:(j + 1) * s], scale=scale, causal=causal,
                          use_flash=use_flash)
        for j in range(n)])
    return alltoall_head_to_seq(o, mesh)

