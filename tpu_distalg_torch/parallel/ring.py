"""Ring pipelines over the emulated data axis — sequence parallelism.

Port of ``tpu_distalg/parallel/ring.py``. The JAX functions are
``shard_map`` bodies over the ``data`` axis; each function here takes
and returns this process's rows of the arrays that JAX's
``data_parallel(f, mesh, in_specs=P("data", …), out_specs=P("data", …))``
takes and returns (the GLOBAL arrays in one process): shard i is rows
[i·S_local, (i+1)·S_local) of the sequence axis (the first), for
``mesh.n_data`` shards, and a process holds the rows of its shards
``mesh.local_data``. The ring runs hop by hop: each step the K/V blocks
move one shard on (s → s+1, :func:`..collectives.permute`, a copy on
the device between shards of one process, a message only for the hop
that leaves a process), and every shard folds the block it holds, in
JAX's order, so every online-softmax update and every gradient
accumulator adds in JAX's order and P processes equal one process bit
for bit. A hop is differentiable (:class:`_Hop`: its backward is the
inverse hop); the flash rings' backward carries the dK/dV accumulators
with their blocks and brings them home with one last hop.

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
from tpu_distalg_torch.parallel import collectives

#: the mesh axis the JAX package shards sequences over (error messages)
DATA_AXIS = "data"


def _n_shards(mesh, *tensors) -> int:
    """The shards this process holds, after checking that each operand
    (this process's rows) splits into them."""
    n = int(mesh.n_local)
    for t in tensors:
        if t.device.type != mesh.device.type:
            raise ValueError(f"operand on {t.device}, mesh on {mesh.device}")
        if t.shape[0] % n:
            raise ValueError(
                f"sequence length {t.shape[0]} not divisible by the "
                f"'{DATA_AXIS}' axis size {n}")
    return n


def _inverse(perm: tuple) -> tuple:
    inv = [0] * len(perm)
    for s, d in enumerate(perm):
        inv[d] = s
    return tuple(inv)


class _Hop(torch.autograd.Function):
    """One ring hop of stacks of this process's shards' blocks (each
    (L, …), row i shard ``local_data[i]``'s): shard s's blocks go to
    shard s+1 mod n. Its backward sends the gradients the other way."""

    @staticmethod
    def forward(ctx, mesh, *stacks):
        ctx.mesh = mesh
        return collectives.permute(stacks, mesh,
                                   collectives.ring_perm(mesh.n_data))

    @staticmethod
    def backward(ctx, *grads):
        grads = tuple(g.contiguous() for g in grads)
        back = collectives.permute(
            grads, ctx.mesh,
            _inverse(collectives.ring_perm(ctx.mesh.n_data)))
        return (None,) + tuple(back)


def _hop(mesh, *stacks) -> tuple:
    out = _Hop.apply(mesh, *stacks)
    return out if isinstance(out, tuple) else (out,)


class _Tie(torch.autograd.Function):
    """``x`` itself, with the ring's last stacks as inputs whose gradient
    is zero. A causal ring leaves some hops' blocks unread by one
    process's shards; tied to the output, every hop of the chain is on
    the path to the loss on every process, so every process runs every
    hop's backward and the processes' messages pair up."""

    @staticmethod
    def forward(ctx, x, *stacks):
        ctx.like = [(t.shape, t.dtype) for t in stacks]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(shape, dtype=dtype, device=g.device)
                            for shape, dtype in ctx.like)


def _ring_steps(mesh):
    """``(i, [(j, my, src), …])`` for each ring step i: local shard j is
    global shard ``my`` and holds block ``src = (my − i) mod n``."""
    n, base = mesh.n_data, mesh.local_data.start
    for i in range(n):
        yield i, [(j, base + j, (base + j - i) % n)
                  for j in range(mesh.n_local)]


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
    blocks pass around the ring (``torch.matmul`` per block). Across
    processes ``a`` and ``b`` are this process's rows, and so is the
    result's (every column)."""
    L = _n_shards(mesh, a, b)
    n = mesh.n_data
    sa, sb = a.shape[0] // L, b.shape[0] // L
    out = torch.empty((a.shape[0], sb * n), dtype=torch.float32,
                      device=a.device)
    af = _f32(a)
    (bz,) = (_f32(b).reshape(L, sb, b.shape[1]),)
    for i, steps in _ring_steps(mesh):
        if i:
            (bz,) = _hop(mesh, bz)
        for j, _, src in steps:
            out[j * sa:(j + 1) * sa, src * sb:(src + 1) * sb] = (
                af[j * sa:(j + 1) * sa] @ bz[j].T)
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


def _ring_impl(q, k, v, mesh, *, scale, kv_chunk, causal, use_flash, bq,
               bkv, return_stats=False):
    """The contiguous ring, forward. Returns this process's (S, H, d)
    float32 rows, and with ``return_stats`` the per-shard logsumexp
    (L, H, S_local, 1) of its L shards."""
    _heads(q, k)
    L = _n_shards(mesh, q, k, v)
    _, h, d = q.shape
    s_q, s_local = q.shape[0] // L, k.shape[0] // L
    s = _scale(scale, d)
    if not use_flash and kv_chunk is not None and (
            kv_chunk < 1 or (kv_chunk < s_local and s_local % kv_chunk)):
        raise ValueError(
            f"kv_chunk={kv_chunk} must be >= 1 and divide the local "
            f"K/V length {s_local}")
    qz, kz, vz = _shards(q, L), _shards(k, L), _shards(v, L)

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

    states = [_state0(h, s_q, d, q.device) for _ in range(L)]
    for i, steps in _ring_steps(mesh):
        if i:
            kz, vz = _hop(mesh, kz, vz)
        for j, my, src in steps:
            if causal and src > my:
                continue             # a later shard's block: all masked
            states[j] = process_block(qz[j], kz[j], vz[j], states[j], my,
                                      src)
    outs = [o / l[..., None] for o, _, l in states]
    out = _Tie.apply(_unshard(torch.stack(outs)), kz, vz)
    if return_stats:
        return out, torch.stack([(m + torch.log(l))[..., None]
                                 for _, m, l in states])
    return out


def _ring_flash_backward(q, k, v, out, lse, g, mesh, *, scale, causal, bq,
                         bkv):
    """The second ring: B12 on every live (shard, block) pair. dQ
    accumulates on its shard; block b's dK/dV accumulator travels with
    the block, collecting shard b's contribution first, then b+1's, in
    JAX's ring order, and one last hop brings it home."""
    L = mesh.n_local
    _, h, d = q.shape
    s_q, s_local = q.shape[0] // L, k.shape[0] // L
    s = _scale(scale, d)
    qz, kz, vz = _shards(q, L), _shards(k, L), _shards(v, L)
    doz, oz = _shards(_f32(g), L), _shards(_f32(out), L)
    delta = (doz * oz).sum(dim=-1, keepdim=True)   # (L, H, S_q, 1)
    dq = [torch.zeros((h, s_q, d), dtype=torch.float32, device=q.device)
          for _ in range(L)]
    dk = torch.zeros(kz.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i, steps in _ring_steps(mesh):
        if i:
            kz, vz, dk, dv = _hop(mesh, kz, vz, dk, dv)
        dk, dv = list(dk), list(dv)
        for j, my, src in steps:
            if causal and src > my:
                continue
            dq_c, dk_c, dv_c = ak.flash_attention_backward_block(
                qz[j], kz[j], vz[j], doz[j], lse[j], delta[j],
                my * s_q, src * s_local, scale=s, causal=causal, bq=bq,
                bkv=bkv)
            dq[j] = dq[j] + dq_c
            dk[j] = dk[j] + dk_c
            dv[j] = dv[j] + dv_c
        dk, dv = torch.stack(dk), torch.stack(dv)
    dk, dv = _hop(mesh, dk, dv)     # each accumulator back to its block
    return (_unshard(torch.stack(dq)).to(q.dtype),
            _unshard(dk).to(k.dtype), _unshard(dv).to(v.dtype))


class _RingFlash(torch.autograd.Function):
    """The contiguous flash ring: forward B11, backward the B12 ring."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, scale, causal, bq, bkv):
        out, lse = _ring_impl(q, k, v, mesh, scale=scale, kv_chunk=None,
                              causal=causal, use_flash=True, bq=bq, bkv=bkv,
                              return_stats=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (mesh, scale, causal, min(bq, ak.BWD_BLOCK_MAX),
                   min(bkv, ak.BWD_BLOCK_MAX))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, scale, causal, bq, bkv = ctx.cfg
        dq, dk, dv = _ring_flash_backward(q, k, v, out, lse, g, mesh,
                                          scale=scale, causal=causal,
                                          bq=bq, bkv=bkv)
        return dq, dk, dv, None, None, None, None, None


def _zigzag_pairs(my, src, n, c):
    """Global start offsets (qC, qD, kA, kB) of a step's chunk-pairs:
    shard s holds chunks (s, 2n−1−s) of c rows. Of the four (q-chunk,
    kv-chunk) pairs, (C, B) is all masked, (D, A) all attend, and (C, A)
    and (D, B) live when src <= my and src >= my."""
    return (my * c, (2 * n - 1 - my) * c, src * c, (2 * n - 1 - src) * c)


def _zigzag_impl(q, k, v, mesh, *, scale, use_flash, bq, bkv,
                 return_stats=False):
    """The zigzag ring, forward (JAX's ``_zigzag_impl``). Returns this
    process's (S, H, d) float32 rows in the zigzag layout, and with
    ``return_stats`` the logsumexp (L, 2, H, c, 1)."""
    L = _n_shards(mesh, q, k, v)
    n = mesh.n_data
    _, h, d = q.shape
    s_q = q.shape[0] // L
    if s_q % 2 or k.shape[0] // L != s_q:
        raise ValueError(
            f"zigzag ring: local length {s_q} must be even (two "
            f"chunks) and q/k lengths equal (got k {k.shape[0] // L})")
    _heads(q, k)
    c = s_q // 2
    s = _scale(scale, d)
    qz, kz, vz = _chunks(q, L), _chunks(k, L), _chunks(v, L)

    def upd(qc, kc, vc, st, q0, k0, causal_pair):
        if use_flash:
            return _flash_update(qc, kc, vc, st, q0, k0, scale=s,
                                 causal=causal_pair, bq=bq, bkv=bkv)
        mask = None
        if causal_pair:
            ar = torch.arange(c, device=q.device)
            mask = (q0 + ar)[:, None] >= (k0 + ar)[None, :]
        return _online_update(qc, *st, kc, vc, s, mask)

    st_c = [_state0(h, c, d, q.device) for _ in range(L)]
    st_d = [_state0(h, c, d, q.device) for _ in range(L)]
    for i, steps in _ring_steps(mesh):
        if i:
            kz, vz = _hop(mesh, kz, vz)
        for j, my, src in steps:
            qc0, qd0, ka0, kb0 = _zigzag_pairs(my, src, n, c)
            if src <= my:
                st_c[j] = upd(qz[j, 0], kz[j, 0], vz[j, 0], st_c[j], qc0,
                              ka0, True)
            st_d[j] = upd(qz[j, 1], kz[j, 0], vz[j, 0], st_d[j], qd0, ka0,
                          False)
            if src >= my:
                st_d[j] = upd(qz[j, 1], kz[j, 1], vz[j, 1], st_d[j], qd0,
                              kb0, True)
    outs = [torch.stack([st[0] / st[2][..., None] for st in pair])
            for pair in zip(st_c, st_d)]
    out = _Tie.apply(_unchunk(torch.stack(outs)), kz, vz)
    if return_stats:
        return out, torch.stack([
            torch.stack([(st[1] + torch.log(st[2]))[..., None]
                         for st in pair]) for pair in zip(st_c, st_d)])
    return out


def _zigzag_flash_backward(q, k, v, out, lse, g, mesh, *, scale, bq, bkv):
    """Zigzag mirror of :func:`_ring_flash_backward`: the same three live
    chunk-pairs per step, dK/dV accumulators travelling with their
    blocks, dQ accumulating per local chunk."""
    L, n = mesh.n_local, mesh.n_data
    _, h, d = q.shape
    c = q.shape[0] // L // 2
    s = _scale(scale, d)
    qz, kz, vz = _chunks(q, L), _chunks(k, L), _chunks(v, L)
    doz, oz = _chunks(_f32(g), L), _chunks(_f32(out), L)
    delta = (doz * oz).sum(dim=-1, keepdim=True)   # (L, 2, H, c, 1)
    dq = [[torch.zeros(qz.shape[2:], dtype=torch.float32, device=q.device)
           for _ in range(2)] for _ in range(L)]
    dk = torch.zeros(kz.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i, steps in _ring_steps(mesh):
        if i:
            kz, vz, dk, dv = _hop(mesh, kz, vz, dk, dv)
        dk = [list(x) for x in dk]
        dv = [list(x) for x in dv]

        def pair(j, my, src, qi, ki, q0, k0, causal_pair):
            dq_c, dk_c, dv_c = ak.flash_attention_backward_block(
                qz[j, qi], kz[j, ki], vz[j, ki], doz[j, qi],
                lse[j, qi], delta[j, qi], q0, k0, scale=s,
                causal=causal_pair, bq=bq, bkv=bkv)
            dq[j][qi] = dq[j][qi] + dq_c
            dk[j][ki] = dk[j][ki] + dk_c
            dv[j][ki] = dv[j][ki] + dv_c

        for j, my, src in steps:
            qc0, qd0, ka0, kb0 = _zigzag_pairs(my, src, n, c)
            if src <= my:
                pair(j, my, src, 0, 0, qc0, ka0, True)
            pair(j, my, src, 1, 0, qd0, ka0, False)
            if src >= my:
                pair(j, my, src, 1, 1, qd0, kb0, True)
        dk = torch.stack([torch.stack(x) for x in dk])
        dv = torch.stack([torch.stack(x) for x in dv])
    dk, dv = _hop(mesh, dk, dv)     # each accumulator back to its block
    dq = torch.stack([torch.stack(x) for x in dq])
    return (_unchunk(dq).to(q.dtype), _unchunk(dk).to(k.dtype),
            _unchunk(dv).to(v.dtype))


class _ZigzagFlash(torch.autograd.Function):
    """The zigzag flash ring: forward B11, backward the B12 ring."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, scale, bq, bkv):
        out, lse = _zigzag_impl(q, k, v, mesh, scale=scale, use_flash=True,
                                bq=bq, bkv=bkv, return_stats=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (mesh, scale, min(bq, ak.BWD_BLOCK_MAX),
                   min(bkv, ak.BWD_BLOCK_MAX))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, scale, bq, bkv = ctx.cfg
        dq, dk, dv = _zigzag_flash_backward(q, k, v, out, lse, g, mesh,
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
    _n_shards(mesh, q, k, v)
    if layout == "zigzag":
        if use_flash:
            return _single_head(_ZigzagFlash.apply, q, k, v, mesh, scale,
                                flash_block_q, flash_block_kv)
        return _single_head(_zigzag_impl, q, k, v, mesh, scale=scale,
                            use_flash=False, bq=flash_block_q,
                            bkv=flash_block_kv)
    if use_flash:
        return _single_head(_RingFlash.apply, q, k, v, mesh, scale, causal,
                            flash_block_q, flash_block_kv)
    return _single_head(_ring_impl, q, k, v, mesh, scale=scale,
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
        from tpu_distalg_torch.parallel.mesh import Mesh

        return _RingFlash.apply(q, k, v, Mesh(n_data=1, device=q.device),
                                s, causal, 2048, 2048)
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


class _AllToAll(torch.autograd.Function):
    """:func:`..collectives.all_to_all` of (L, n, …) pieces; its
    backward is the exchange back."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return collectives.all_to_all(x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, g):
        back = collectives.all_to_all(g.transpose(0, 1).contiguous(),
                                      ctx.mesh)
        return back.transpose(0, 1), None


def alltoall_seq_to_head(x, mesh):
    """(S, H, d) sequence-sharded → (n·S, H/n, d) head-sharded: shard j
    holds the full sequence of head group j (JAX's ``all_to_all`` over
    the data axis, as global arrays in one process; across processes
    this process's rows in, its head groups' full sequences out).
    Differentiable: the backward is the inverse exchange."""
    n, L = int(mesh.n_data), int(mesh.n_local)
    rows, h, d = x.shape
    if h % n:
        raise ValueError(
            f"alltoall_seq_to_head: head count {h} must be divisible by "
            f"the '{DATA_AXIS}' axis size {n}")
    if rows % L:
        raise ValueError(
            f"sequence length {rows} not divisible by the '{DATA_AXIS}' "
            f"axis size {L}")
    s = rows // L
    # [i, j]: held shard i's rows of head group j, bound for shard j
    pieces = x.reshape(L, s, n, h // n, d).permute(0, 2, 1, 3, 4)
    got = _AllToAll.apply(pieces, mesh)   # [j, i]: shard j's rows
    return got.permute(1, 0, 2, 3, 4).reshape(L * n * s, h // n, d)


def alltoall_head_to_seq(x, mesh):
    """Inverse of :func:`alltoall_seq_to_head`: (n·S, H/n, d)
    head-sharded → (S, H, d) sequence-sharded."""
    n, L = int(mesh.n_data), int(mesh.n_local)
    rows, h_l, d = x.shape
    s = rows // L // n if rows % (L * n) == 0 else 0
    if s == 0:
        raise ValueError(
            f"alltoall_head_to_seq: sequence length {rows // L} must be "
            f"divisible by the '{DATA_AXIS}' axis size {n}")
    # [i, j]: held head group i's rows of sequence shard j
    pieces = x.reshape(L, n, s, h_l, d)
    got = _AllToAll.apply(pieces, mesh)   # [j, i]: head group j's rows
    return got.permute(1, 2, 0, 3, 4).reshape(L * s, n * h_l, d)


def ulysses_attention(q, k, v, mesh, *, scale: float | None = None,
                      causal: bool = False, use_flash: bool = False):
    """DeepSpeed-Ulysses sequence-parallel attention on (S, H, d)
    operands (this process's rows): the exchange to head shards,
    :func:`softmax_attention` on each held shard's full sequence for its
    head group (``use_flash``: B11, differentiable through B12), and the
    inverse exchange. Needs H and H_kv divisible by ``mesh.n_data``."""
    L = _n_shards(mesh, q, k, v)
    s = q.shape[0] // L * mesh.n_data          # the full sequence
    qh, kh, vh = (alltoall_seq_to_head(x, mesh) for x in (q, k, v))
    o = torch.cat([
        softmax_attention(qh[j * s:(j + 1) * s], kh[j * s:(j + 1) * s],
                          vh[j * s:(j + 1) * s], scale=scale, causal=causal,
                          use_flash=use_flash)
        for j in range(L)])
    return alltoall_head_to_seq(o, mesh)
