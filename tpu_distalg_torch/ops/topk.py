"""Fused matmul + top-k: the serving layer's retrieval kernel.

Port of ``tpu_distalg/ops/pallas_topk.py``. :func:`fused_matmul_topk`
returns the top k of ``Q · Vᵀ`` per query row; on the card it launches
the hand-written kernel of ``csrc/topk.cu``, which never writes the
(B, N) score matrix to device memory. :func:`matmul_topk_reference` is
its plain PyTorch version, with the contract of the JAX package's
``xla_matmul_topk``: float32 scores, local rows at or past ``n_valid``
masked to -inf, ``index_offset`` added to the selected rows, value
descending with ties toward the lower index, and (-inf, 2³¹−1) in the
slots left when fewer than k valid items exist.

The wrapper takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from tpu_distalg_torch.ops import _native

IDX_SENTINEL = 2**31 - 1
#: items per kernel sub-tile; ``block_items`` is a multiple of it
TILE_ITEMS = 128
#: query rows per kernel block
TILE_QUERIES = 32
#: serialises the launch counter's read-modify-write: every served
#: model launches from its own dispatch thread
_LAUNCHES_LOCK = threading.Lock()


def matmul_topk_reference(Q: torch.Tensor, V: torch.Tensor,
                          index_offset: int, n_valid: int, *, k: int):
    """Plain PyTorch top-k of ``Q · Vᵀ`` → ``(values (B, k) f32,
    indices (B, k) int32)``. ``torch.topk`` promises no order among
    ties, so this sorts stably: value descending, ties toward the lower
    index."""
    scores = Q.to(torch.float32) @ V.to(torch.float32).T
    n = V.shape[0]
    col = torch.arange(n, dtype=torch.int64, device=Q.device)
    scores = torch.where(col[None, :] < int(n_valid), scores,
                         float("-inf"))
    if k > n:
        pad = k - n
        scores = torch.nn.functional.pad(scores, (0, pad),
                                         value=float("-inf"))
        col = torch.nn.functional.pad(col, (0, pad), value=IDX_SENTINEL)
    vals, local = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, local = vals[:, :k], local[:, :k]
    gidx = col[local] + int(index_offset)
    gidx = torch.where(vals == float("-inf"), IDX_SENTINEL, gidx)
    return vals.contiguous(), gidx.to(torch.int32)


def assert_topk_close(got_v, got_i, ref_v, ref_i, *, rtol: float = 1e-5):
    """Hold a top-k result to a reference by the tie-tolerance rule.

    Float sums in another order may move a score in its last bits and
    so swap two items whose scores are that close. So values must agree
    within ``tol = rtol · max|ref score|``, and indices must be equal
    at every rank whose reference score is more than ``tol`` from both
    of its neighbours. Slots with a -inf reference must hold (-inf,
    2³¹−1). ``ref_v``/``ref_i`` may carry more columns than the result
    (k+1): the extra column only serves as the last rank's neighbour;
    without it the last rank's index is held only by its value."""
    gv, gi, rv, ri = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x)
                      for x in (got_v, got_i, ref_v, ref_i))
    k = gv.shape[1]
    if gv.shape != gi.shape or rv.shape[0] != gv.shape[0] or \
            rv.shape[1] < k:
        raise AssertionError(f"shapes differ: got {gv.shape}/{gi.shape},"
                             f" reference {rv.shape}")
    finite = rv[np.isfinite(rv)]
    tol = rtol * (float(np.abs(finite).max()) if finite.size else 0.0)
    rvk, rik = rv[:, :k], ri[:, :k]
    with np.errstate(invalid="ignore"):
        close = (gv == rvk) | (np.abs(gv - rvk) <= tol)
    if not close.all():
        r, c = np.argwhere(~close)[0]
        raise AssertionError(
            f"{int((~close).sum())} value(s) off by more than {tol:.3g}; "
            f"first at row {r} rank {c}: {gv[r, c]!r} vs {rvk[r, c]!r}")
    empty = rvk == -np.inf
    if not (gi[empty] == IDX_SENTINEL).all():
        raise AssertionError("a -inf slot does not hold the sentinel index")
    left = np.full_like(rvk, np.inf)
    left[:, 1:] = rvk[:, :-1]
    right = np.full_like(rvk, -np.inf)
    right[:, :-1] = rvk[:, 1:]
    if rv.shape[1] > k:
        right[:, -1] = rv[:, k]
    else:
        right[:, -1] = rvk[:, -1]  # unknown: the last rank is not held
    with np.errstate(invalid="ignore"):
        apart = (np.abs(rvk - left) > tol) & (np.abs(rvk - right) > tol)
    bad = apart & ~empty & (gi != rik)
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise AssertionError(
            f"{int(bad.sum())} index(es) differ at separated ranks; first "
            f"at row {r} rank {c}: {gi[r, c]} vs {rik[r, c]} (score "
            f"{rvk[r, c]!r})")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _subs_per_block(B: int, N: int, block_items: int | None,
                    device: torch.device) -> int:
    """Item sub-tiles per CUDA block. ``block_items=None`` sizes the
    blocks so that the grid holds about two blocks per SM."""
    if block_items is not None:
        return block_items // TILE_ITEMS
    n_sub = -(-N // TILE_ITEMS)
    q_tiles = -(-B // TILE_QUERIES)
    want = max(1, -(-2 * _sm_count(device.index) // q_tiles))
    return max(1, -(-n_sub // want))


def _validate(Q, V, index_offset, k, block_items):
    for name, t in (("Q", Q), ("V", V)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Q.device != V.device:
        raise ValueError(f"Q on {Q.device} but V on {V.device}")
    if Q.shape[1] != V.shape[1]:
        raise ValueError(f"Q {tuple(Q.shape)} vs V {tuple(V.shape)}: "
                         f"feature dims differ")
    if Q.shape[0] < 1 or V.shape[0] < 1 or Q.shape[1] < 1:
        raise ValueError(f"empty operand: Q {tuple(Q.shape)}, "
                         f"V {tuple(V.shape)}")
    if max(Q.shape[0], V.shape[0]) >= 2**31:
        raise ValueError("Q and V rows must fit in int32")
    if not -2**31 <= int(index_offset) <= IDX_SENTINEL - V.shape[0]:
        raise ValueError(f"index_offset {index_offset} overflows int32 "
                         f"item ids")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if block_items is not None and (
            block_items < TILE_ITEMS or block_items % TILE_ITEMS):
        raise ValueError(f"block_items must be a positive multiple of "
                         f"{TILE_ITEMS}, got {block_items}")


def fused_matmul_topk(Q: torch.Tensor, V: torch.Tensor, index_offset: int,
                      n_valid: int, *, k: int,
                      block_items: int | None = None):
    """Top-k of ``Q · Vᵀ`` without materialising the score matrix.

    ``Q`` (B, d) and ``V`` (N, d): contiguous float32 on one device.
    ``index_offset`` maps local rows of V to global item ids;
    ``n_valid`` counts the real local rows (rows at or past it never
    win). Returns ``(values (B, k) f32, indices (B, k) int32)`` in
    the order of :func:`matmul_topk_reference`. ``block_items`` is the
    number of items one CUDA block scans (``None``: sized to the card).

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel (counted in ``fused_matmul_topk.launches``) or raises."""
    _validate(Q, V, index_offset, k, block_items)
    if Q.device.type == "cpu":
        return matmul_topk_reference(Q, V, index_offset, n_valid, k=k)
    if Q.device.type != "cuda":
        raise ValueError(f"unsupported device {Q.device}")
    lib = _native.load("topk")
    B, d = Q.shape
    N = V.shape[0]
    dev = Q.device
    subs = _subs_per_block(B, N, block_items, dev)
    n_sub = -(-N // TILE_ITEMS)
    n_tiles = -(-n_sub // subs)
    cand_v = torch.empty((B, n_tiles, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((B, n_tiles, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    # a tensor's CUDA device always carries its index; the stream is
    # that device's current one in the calling thread (the batcher
    # launches from its own dispatch thread)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.tda_topk(
        Q.data_ptr(), V.data_ptr(), B, N, d, k, int(index_offset),
        max(-1, min(int(n_valid), N)), subs, n_tiles, cand_v.data_ptr(),
        cand_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), dev.index,
        stream)
    _native.check(lib, rc, "fused_matmul_topk")
    with _LAUNCHES_LOCK:
        fused_matmul_topk.launches += 1
    return out_v, out_i


fused_matmul_topk.launches = 0
