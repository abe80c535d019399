"""Flash-attention kernels of the ring: one K/V block folded into the
online-softmax state (B11), and the FlashAttention-2 recompute backward
of one block (B12).

Port of ``tpu_distalg/ops/pallas_attention.py``:

  * B11 :func:`flash_attention_block` (``:166``): ``(o, m, l)`` carried
    in and out, one resident K/V block folded in, causal by global
    position (``q_off``/``k_off``), grouped-query heads (query head h
    reads KV head ``h // (H/H_kv)``); normalise ``o / l`` after the
    last block;
  * B12 :func:`flash_attention_backward_block` (``:374``): given the
    final per-row logsumexp ``lse`` and ``delta = Σ_d dO·O``, the dQ
    partial of this block and its full dK, dV, recomputing
    P = exp(QKᵀ·scale − lse) tile by tile.

Shapes follow JAX: q and do (H, S_q, d); k and v (H_kv, S_kv, d); o
(H, S_q, d) f32; m, l, lse and delta (H, S_q, 1) f32. The shape checks,
their ``ValueError``\\ s and the backward's block halving are JAX's, so
the same calls fail the same way; ``bq``/``bkv`` are checked for that
contract and set the plain versions' tiles, while the CUDA kernels
(``csrc/attention.cu``) use tiles of their own.

The plain versions walk JAX's (bq, bkv) tiles in JAX's order with JAX's
algebra: the three-way causal split (dead tiles skipped, full tiles
unmasked, crossing tiles masked with the finite ``_NEG`` sentinel and
guarded so that a row which has seen no key adds no exp(0) mass), f32
products (bf16 operands are widened, which is exact), P rounded to
``v.dtype`` before ·V, dS rounded to ``k.dtype``/``q.dtype`` and P to
``do.dtype`` in the backward. The wrapper takes them only for tensors on
the CPU; for CUDA tensors it launches the kernels (counted in
``<wrapper>.launches``, one a call) or raises.

Deliberate differences of the CUDA kernels (ROADMAP C): for bf16 q, k, v
the backward's float32 operands (dO, and P in Pᵀ·dO) are rounded to
bf16 for the tensor cores, as the TPU's MXU rounds them at default
precision (the wrapper rounds a float32 dO once, before the launch). A
row that has seen no unmasked key leaves m at −inf or at the sentinel,
depending on the tiling; o and l are the same either way. The kernels
take every head dim JAX's contract takes (a multiple of 128).
"""

from __future__ import annotations

import torch

from tpu_distalg_torch.ops import _native

_NEG = -1e30

#: the backward's default tile edge, and the ring VJPs' cap on their
#: flash blocks (JAX's measured-best TPU tile, kept for the contract)
BWD_BLOCK_MAX = 2048


# ----------------------------------------------------------------- checks


def _fwd_blocks(q, k, v, bq: int, bkv: int) -> tuple[int, int, int]:
    """JAX's forward checks: ``(bq, bkv, group)``, or ``ValueError``."""
    h, s_q, d = q.shape
    h_kv, s_kv = k.shape[0], k.shape[1]
    bq = min(bq, s_q)
    bkv = min(bkv, s_kv)
    if d % 128 or s_q % bq or s_kv % bkv or bq % 8 or bkv % 128:
        raise ValueError(
            f"flash_attention_block: shapes q={tuple(q.shape)} "
            f"k={tuple(k.shape)} need d%128==0 and divisible blocks "
            f"(bq={bq}, bkv={bkv})")
    if v.shape != k.shape:
        raise ValueError(
            f"flash_attention_block: v {tuple(v.shape)} must match k "
            f"{tuple(k.shape)} — both ride the same KV-head index map")
    if h % h_kv:
        raise ValueError(
            f"flash_attention_block: {h} query heads not divisible by "
            f"{h_kv} KV heads")
    return bq, bkv, h // h_kv


def _bwd_blocks(q, k, v, do, bq: int, bkv: int) -> tuple[int, int, int]:
    """JAX's backward checks after halving each block down to a divisor
    of its length: ``(bq, bkv, group)``, or ``ValueError``."""
    h, s_q, d = q.shape
    h_kv, s_kv = k.shape[0], k.shape[1]
    bq = min(bq, s_q)
    while bq > 8 and s_q % bq:
        bq //= 2
    bkv = min(bkv, s_kv)
    while bkv > 128 and s_kv % bkv:
        bkv //= 2
    if d % 128 or s_q % bq or s_kv % bkv or bq % 8 or bkv % 128:
        raise ValueError(
            f"flash_attention_backward_block: shapes q={tuple(q.shape)} "
            f"k={tuple(k.shape)} need d%128==0 and divisible blocks "
            f"(bq={bq}, bkv={bkv})")
    if v.shape != k.shape or do.shape != q.shape:
        raise ValueError(
            "flash_attention_backward_block: v must match k and do "
            f"must match q (got v={tuple(v.shape)}, "
            f"do={tuple(do.shape)})")
    if h % h_kv:
        raise ValueError(
            f"flash_attention_backward_block: {h} query heads not "
            f"divisible by {h_kv} KV heads")
    return bq, bkv, h // h_kv


def _check_state(what, shape, **tensors) -> None:
    for name, t in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} must be "
                             f"{shape}")


def _tile_kind(q0: int, k0: int, bq: int, bkv: int) -> str:
    """JAX's three-way causal split of the tile whose first query and
    key sit at global positions ``q0`` and ``k0``."""
    if q0 + bq - 1 < k0:
        return "dead"
    if q0 >= k0 + bkv - 1:
        return "full"
    return "masked"


def _causal_mask(q0: int, k0: int, bq: int, bkv: int, device):
    qpos = q0 + torch.arange(bq, device=device)
    kpos = k0 + torch.arange(bkv, device=device)
    return qpos[:, None] >= kpos[None, :]


def _f32(x):
    return x.to(torch.float32)


# ------------------------------------------------------------------ plain


def flash_attention_block_reference(q, k, v, o, m, l, q_off, k_off, *,
                                    scale: float, causal: bool = False,
                                    bq: int = 2048, bkv: int = 2048):
    """Plain B11: the JAX kernel's tile walk with torch ops."""
    bq, bkv, group = _fwd_blocks(q, k, v, bq, bkv)
    h, s_q, d = q.shape
    h_kv, s_kv = k.shape[0], k.shape[1]
    q_off, k_off = int(q_off), int(k_off)
    qg = _f32(q).reshape(h_kv, group, s_q, d)
    kf, vf = _f32(k), _f32(v)
    o_out = torch.empty((h, s_q, d), dtype=torch.float32, device=q.device)
    m_out = torch.empty((h, s_q, 1), dtype=torch.float32, device=q.device)
    l_out = torch.empty_like(m_out)
    for i in range(s_q // bq):
        rows = slice(i * bq, (i + 1) * bq)
        oacc = _f32(o[:, rows]).clone()
        macc = _f32(m[:, rows]).clone()
        lacc = _f32(l[:, rows]).clone()
        for j in range(s_kv // bkv):
            cols = slice(j * bkv, (j + 1) * bkv)
            kind = "full"
            if causal:
                kind = _tile_kind(q_off + i * bq, k_off + j * bkv, bq, bkv)
                if kind == "dead":
                    continue
            s = torch.einsum("hgqd,hkd->hgqk", qg[:, :, rows],
                             kf[:, cols]).reshape(h, bq, bkv) * scale
            if kind == "masked":
                mask = _causal_mask(q_off + i * bq, k_off + j * bkv, bq,
                                    bkv, q.device)
                s = torch.where(mask[None], s, _NEG)
            m_new = torch.maximum(macc, s.amax(dim=2, keepdim=True))
            if kind == "masked":
                live = m_new > _NEG / 2
                alpha = torch.where(live, torch.exp(macc - m_new), 0.0)
                p = torch.where(live, torch.exp(s - m_new), 0.0)
            else:
                alpha = torch.exp(macc - m_new)
                p = torch.exp(s - m_new)
            lacc = lacc * alpha + p.sum(dim=2, keepdim=True)
            pv = _f32(p.to(v.dtype)).reshape(h_kv, group, bq, bkv)
            oacc = oacc * alpha + torch.einsum(
                "hgqk,hkd->hgqd", pv, vf[:, cols]).reshape(h, bq, d)
            macc = m_new
        o_out[:, rows], m_out[:, rows], l_out[:, rows] = oacc, macc, lacc
    return o_out, m_out, l_out


def _recompute_p(q, k, lse, q0, k0, bq, bkv, scale, masked):
    """P = exp(QKᵀ·scale − lse) of one tile, (H_kv, g, bq, bkv)."""
    s = torch.einsum("hgqd,hkd->hgqk", q, k) * scale
    p = torch.exp(s - lse)
    if masked:
        p = torch.where(_causal_mask(q0, k0, bq, bkv, q.device), p, 0.0)
    return p


def flash_attention_backward_block_reference(q, k, v, do, lse, delta,
                                             q_off, k_off, *,
                                             scale: float,
                                             causal: bool = False,
                                             bq: int = BWD_BLOCK_MAX,
                                             bkv: int = BWD_BLOCK_MAX):
    """Plain B12: JAX's two passes with torch ops — dQ over (head, q
    block) walking KV blocks, dK/dV over (KV head, KV block) walking
    (group member, q block), each in JAX's order."""
    bq, bkv, group = _bwd_blocks(q, k, v, do, bq, bkv)
    h, s_q, d = q.shape
    h_kv, s_kv = k.shape[0], k.shape[1]
    q_off, k_off = int(q_off), int(k_off)
    n_q, n_kv = s_q // bq, s_kv // bkv
    qf = _f32(q).reshape(h_kv, group, s_q, d)
    dof = _f32(do).reshape(h_kv, group, s_q, d)
    lse_g = _f32(lse).reshape(h_kv, group, s_q, 1)
    dl_g = _f32(delta).reshape(h_kv, group, s_q, 1)
    kf, vf = _f32(k), _f32(v)

    def kinds(qi, kj):
        if not causal:
            return "full"
        return _tile_kind(q_off + qi * bq, k_off + kj * bkv, bq, bkv)

    dq = torch.zeros((h_kv, group, s_q, d), dtype=torch.float32,
                     device=q.device)
    for i in range(n_q):
        rows = slice(i * bq, (i + 1) * bq)
        for j in range(n_kv):
            kind = kinds(i, j)
            if kind == "dead":
                continue
            cols = slice(j * bkv, (j + 1) * bkv)
            p = _recompute_p(qf[:, :, rows], kf[:, cols], lse_g[:, :, rows],
                             q_off + i * bq, k_off + j * bkv, bq, bkv,
                             scale, kind == "masked")
            dp = torch.einsum("hgqd,hkd->hgqk", dof[:, :, rows],
                              vf[:, cols])
            ds = p * (dp - dl_g[:, :, rows]) * scale
            dq[:, :, rows] += torch.einsum(
                "hgqk,hkd->hgqd", _f32(ds.to(k.dtype)), kf[:, cols])

    dk = torch.zeros((h_kv, s_kv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i in range(n_kv):
        cols = slice(i * bkv, (i + 1) * bkv)
        for gm in range(group):
            for qi in range(n_q):
                kind = kinds(qi, i)
                if kind == "dead":
                    continue
                rows = slice(qi * bq, (qi + 1) * bq)
                qt, dot = qf[:, gm, rows], dof[:, gm, rows]
                p = _recompute_p(qt[:, None], kf[:, cols],
                                 lse_g[:, gm, rows][:, None],
                                 q_off + qi * bq, k_off + i * bkv, bq, bkv,
                                 scale, kind == "masked")[:, 0]
                dv[:, cols] += torch.einsum(
                    "hqk,hqd->hkd", _f32(p.to(do.dtype)), dot)
                dp = torch.einsum("hqd,hkd->hqk", dot, vf[:, cols])
                ds = p * (dp - dl_g[:, gm, rows]) * scale
                dk[:, cols] += torch.einsum(
                    "hqk,hqd->hkd", _f32(ds.to(q.dtype)), qt)
    return dq.reshape(h, s_q, d), dk, dv


# ---------------------------------------------------------------- kernels

_TYPES = (torch.bfloat16, torch.float32)


def _kernel_checks(what, q, k, v):
    """What the CUDA kernels take beyond JAX's contract: q, k, v of one
    type, bf16 or float32."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _native.check_tensor(name, t, _TYPES, 3)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"{what}: the CUDA kernel takes q, k, v of one "
                         f"type, got {q.dtype}, {k.dtype}, {v.dtype}")


def _aligned(what, *tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the CUDA kernel reads q, k, v and do "
                         f"by TMA or 16-byte loads; they must be 16-byte "
                         f"aligned")


def flash_attention_block(q, k, v, o, m, l, q_off, k_off, *,
                          scale: float, causal: bool = False,
                          bq: int = 2048, bkv: int = 2048):
    """B11: one resident K/V block folded into the online-softmax state.

    Returns the updated ``(o, m, l)`` (new tensors); normalise ``o / l``
    after the last block. ``q_off``/``k_off`` are the global positions
    of row 0 of q and of k. A CPU tensor goes to
    :func:`flash_attention_block_reference`; a CUDA tensor launches the
    kernel (``flash_attention_block.launches``) or raises."""
    _fwd_blocks(q, k, v, bq, bkv)
    h, s_q, d = q.shape
    _check_state("flash_attention_block", (h, s_q, d), o=o)
    _check_state("flash_attention_block", (h, s_q, 1), m=m, l=l)
    tensors = (q, k, v, o, m, l)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_block_reference(
            q, k, v, o, m, l, q_off, k_off, scale=scale, causal=causal,
            bq=bq, bkv=bkv)
    dev = _native.cuda_device(*tensors)
    _kernel_checks("flash_attention_block", q, k, v)
    for name, t in (("o", o), ("m", m), ("l", l)):
        _native.check_tensor(name, t, (torch.float32,), 3)
    q, k, v, o, m, l = (t.contiguous() for t in tensors)
    _aligned("flash_attention_block", q, k, v)
    o_out = torch.empty_like(o)
    m_out = torch.empty_like(m)
    l_out = torch.empty_like(l)
    lib = _native.load("attention")
    rc = lib.tda_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), o_out.data_ptr(), m_out.data_ptr(),
        l_out.data_ptr(), h, k.shape[0], s_q, k.shape[1], d, int(q_off),
        int(k_off), float(scale), int(bool(causal)),
        int(q.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _native.check(lib, rc, "flash_attention_block")
    flash_attention_block.launches += 1
    return o_out, m_out, l_out


flash_attention_block.launches = 0


def flash_attention_backward_block(q, k, v, do, lse, delta, q_off, k_off,
                                   *, scale: float, causal: bool = False,
                                   bq: int = BWD_BLOCK_MAX,
                                   bkv: int = BWD_BLOCK_MAX):
    """B12: gradients through one resident K/V block → ``(dq, dk, dv)``
    f32: dq this block's partial (summed over ring steps outside), dk
    and dv the block's full cotangents w.r.t. these queries (summed over
    ring shards outside). A CPU tensor goes to
    :func:`flash_attention_backward_block_reference`; a CUDA tensor
    launches the two passes (dQ, then dK/dV; one count in
    ``flash_attention_backward_block.launches``) or raises. For bf16
    q, k, v a float32 ``do`` is rounded to bf16 once before the launch
    (the kernel's tiles arrive by TMA, which copies without converting)."""
    _bwd_blocks(q, k, v, do, bq, bkv)
    h, s_q, d = q.shape
    _check_state("flash_attention_backward_block", (h, s_q, 1), lse=lse,
                 delta=delta)
    tensors = (q, k, v, do, lse, delta)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_backward_block_reference(
            q, k, v, do, lse, delta, q_off, k_off, scale=scale,
            causal=causal, bq=bq, bkv=bkv)
    dev = _native.cuda_device(*tensors)
    what = "flash_attention_backward_block"
    _kernel_checks(what, q, k, v)
    _native.check_tensor("do", do, _TYPES, 3)
    if do.dtype != torch.float32 and do.dtype != q.dtype:
        raise ValueError(f"{what}: do must be float32 or q's type, got "
                         f"{do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        _native.check_tensor(name, t, (torch.float32,), 3)
    if q.dtype == torch.bfloat16:
        do = do.to(torch.bfloat16)
    q, k, v, do, lse, delta = (t.contiguous()
                               for t in (q, k, v, do, lse, delta))
    _aligned(what, q, k, v, do)
    dq = torch.empty((h, s_q, d), dtype=torch.float32, device=dev)
    dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(k.shape, dtype=torch.float32, device=dev)
    lib = _native.load("attention")
    rc = lib.tda_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), h, k.shape[0], s_q, k.shape[1], d, int(q_off),
        int(k_off), float(scale), int(bool(causal)),
        int(q.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _native.check(lib, rc, what)
    flash_attention_backward_block.launches += 1
    return dq, dk, dv


flash_attention_backward_block.launches = 0

#: the kernels of this module, for resetting and reading launch counts
KERNELS = (flash_attention_block, flash_attention_backward_block)
