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

import ctypes
import functools
import threading

import numpy as np
import torch

from tpu_distalg_torch.ops import _native

IDX_SENTINEL = 2**31 - 1
#: the unit of ``block_items``: the items one CUDA block scans are a
#: multiple of it
TILE_ITEMS = 128
#: the kernel's two block shapes (``csrc/topk.cu::shape_of``), by shape:
#: query rows a block and items a sub-tile; shape 0 ("A") at k <=
#: SHAPE_A_MAX_K when the card has work enough for it, else shape 1 ("B").
#: The kernel's shared memory and workspace layout are its own
#: (``tda_topk_layout``).
TILE_QUERIES, SUB_TILE_ITEMS = (32, 8), (128, 256)
SHAPE_A_MAX_K = 64
#: serialises the launch counter's read-modify-write: every served model
#: launches from its own dispatch thread
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


def merge_topk_pairs(all_vals: torch.Tensor, all_idx: torch.Tensor, *,
                     k: int):
    """Merge per-shard top-k candidate pairs into the global top k, on
    the pairs' device (port of ``pallas_topk.merge_topk_pairs``, plain
    JAX there, not a Pallas kernel).

    ``all_vals``/``all_idx`` are (S, B, K) shard-major stacks, as
    ``parallel.comms.ring_allgather`` returns them. The order is value
    descending with ties toward the lower index, as JAX's two-key sort
    gives it: here two stable sorts, by index and then by value, since
    ``torch.topk`` fixes no order among ties on CUDA. Shard windows are
    disjoint, so no index appears twice; exhausted slots keep -inf and
    the sentinel index."""
    S, B, K = all_vals.shape
    v = all_vals.movedim(0, 1).reshape(B, S * K)
    i = all_idx.movedim(0, 1).reshape(B, S * K)
    i, by_idx = torch.sort(i, dim=1, stable=True)
    v = torch.gather(v, 1, by_idx)
    v, by_val = torch.sort(v, dim=1, descending=True, stable=True)
    i = torch.gather(i, 1, by_val)
    return v[:, :k].contiguous(), i[:, :k].contiguous()


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
def topk_plan(B: int, N: int, k: int, block_items: int | None,
              n_sm: int) -> dict:
    """The kernel's launch plan, from the shapes and the SM count alone.

    Shape A (32 queries a block, 128-item sub-tiles) when k <= 64 and the
    card has work for every SM at four sub-tiles a block; else shape B (8
    queries, 256-item sub-tiles). A block scans ``range_items`` items
    (``block_items``, or sized for two A blocks or one B block an SM, at
    least a sub-tile and at least 4·k, rounded up to 128, so that a
    block's list is not mostly candidates); blocks are (query tile, item
    range) pairs. The kernel lays out its own shared memory and
    workspace for the plan (``csrc/topk.cu::layout_of``)."""
    q_a = -(-B // TILE_QUERIES[0])
    shape = 0 if k <= SHAPE_A_MAX_K and q_a * -(-N // (
        4 * SUB_TILE_ITEMS[0])) >= n_sm else 1
    qt, sub = TILE_QUERIES[shape], SUB_TILE_ITEMS[shape]
    q_tiles = -(-B // qt)
    if block_items is not None:
        range_items = block_items
    else:
        want = max(1, -(-(2 if shape == 0 else 1) * n_sm // q_tiles))
        range_items = -(-N // want)
        range_items = max(range_items, 4 * k, sub)
        range_items = -(-range_items // TILE_ITEMS) * TILE_ITEMS
    n_ranges = -(-N // range_items)
    return dict(shape=shape, queries=qt, sub_items=sub,
                range_items=range_items, n_ranges=n_ranges,
                q_tiles=q_tiles, blocks=q_tiles * n_ranges)


@functools.cache
def _lib():
    """The kernel's library (built at first use; argtypes set)."""
    return _native.load("topk")


@functools.cache
def topk_layout(B: int, N: int, k: int, shape: int,
                range_items: int) -> tuple[int, int, int]:
    """``(state words, list words, shared-memory bytes)`` of a plan, as
    the kernel lays it out (``csrc/topk.cu::tda_topk_layout``); raises
    for a plan the kernel does not take. Needs the built library."""
    words = (ctypes.c_longlong * 3)()
    if _lib().tda_topk_layout(B, N, k, shape, range_items, words):
        raise ValueError(
            f"fused_matmul_topk: B={B}, N={N}, k={k} in item ranges of "
            f"{range_items} exceeds the kernel's int32 counts")
    return words[0], words[1], words[2]


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
    B, d = Q.shape
    N = V.shape[0]
    dev = Q.device
    plan = topk_plan(B, N, k, block_items, _native.sm_count(dev.index))
    state_words, list_words, _ = topk_layout(B, N, k, plan["shape"],
                                             plan["range_items"])
    # the stream is the device's current one in the calling thread (the
    # batcher launches from its own dispatch thread); the state region
    # (tickets, bounds) is zero between launches, the lists are scratch
    stream = _native.stream(dev)
    state = _native.workspace("topk state", dev, stream, state_words,
                              torch.int32)
    lists = _native.workspace("topk lists", dev, stream, list_words,
                              torch.int32)
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    rc = _lib().tda_topk(
        Q.data_ptr(), V.data_ptr(), B, N, d, k, int(index_offset),
        max(-1, min(int(n_valid), N)), plan["shape"], plan["range_items"],
        state.data_ptr(), state.numel(), lists.data_ptr(), lists.numel(),
        out_v.data_ptr(), out_i.data_ptr(), dev.index, stream)
    if rc:
        _native.check(_lib(), rc, "fused_matmul_topk")
    with _LAUNCHES_LOCK:
        fused_matmul_topk.launches += 1
    return out_v, out_i


fused_matmul_topk.launches = 0
