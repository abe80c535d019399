"""Carry trained parameters (ALS factors, SSGD weights, dp×tp SSGD
state, k-means centres) and PageRank's rank state from the JAX package
into the port.

The two packages share no file format the port reads (the JAX package
checkpoints as flax msgpack), so parameters cross as numpy arrays:
``np.asarray`` of the JAX arrays on that side, these functions on this
side. Attention (``parallel/ring.py``) has no parameters and needs
nothing here: its tests hand both packages the same numpy q, k, v.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_distalg_torch.utils.device import resolve_device


def als_params_from_jax(U_np, V_np, *,
                        device: str | torch.device | None = None):
    """ALS factors ``U`` (users, r) and ``V`` (items, r) as contiguous
    float32 tensors on ``device``."""
    dev = resolve_device(device)
    U = np.array(U_np, np.float32)  # a copy: JAX's arrays are read-only
    V = np.array(V_np, np.float32)
    if U.ndim != 2 or V.ndim != 2 or U.shape[1] != V.shape[1]:
        raise ValueError(f"U {U.shape} vs V {V.shape}: want (users, r) "
                         f"and (items, r)")
    return (torch.from_numpy(U).to(dev).contiguous(),
            torch.from_numpy(V).to(dev).contiguous())


def ssgd_params_from_jax(w_np, meta: dict | None = None, *,
                         device: str | torch.device | None = None):
    """SSGD weights from the JAX package as a float32 tensor on
    ``device``: the plain (d,) vector when ``meta`` is None, else the
    augmented (d_total,) layout of ``meta`` (from ``pack_augmented``),
    the plain weights followed by zeros at and past ``y_col``. A JAX
    bfloat16 array crosses as its ``np.uint16`` bits (numpy has no
    bfloat16): ``np.asarray(w).view(np.uint16)`` on that side."""
    dev = resolve_device(device)
    w = np.asarray(w_np)
    if w.ndim != 1:
        raise ValueError(f"w {w.shape}: want a vector")
    if w.dtype == np.uint16:
        t = torch.from_numpy(w.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(w, np.float32))
    t = t.to(torch.float32)
    if meta is not None:
        d_t, y_col = int(meta["d_total"]), int(meta["y_col"])
        if t.shape[0] == d_t:
            if bool((t[y_col:] != 0).any()):
                raise ValueError(f"augmented w is non-zero at or past "
                                 f"y_col={y_col}")
        elif t.shape[0] == y_col:
            t = torch.cat([t, torch.zeros(d_t - y_col)])
        else:
            raise ValueError(f"w {tuple(t.shape)}: want ({y_col},) or "
                             f"({d_t},) for meta {meta}")
    return t.to(dev).contiguous()


def _bf16_or_f32(a: np.ndarray) -> torch.Tensor:
    """A float32 array, or bfloat16 crossed as its 16-bit pattern
    (``np.uint16``, or ml_dtypes' bfloat16, which numpy sees as 2-byte
    values), as a torch tensor of that type."""
    if a.dtype.itemsize == 2:
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, np.float32))


def ssgd_tp_params_from_jax(w_np, X2_np, meta: dict, *,
                            device: str | torch.device | None = None):
    """The JAX package's dp×tp ``fused_gather`` state (``prepare_fused_tp``)
    in the port's layout: ``(w, X2)``. w, the (n_model·D,) concatenation
    of the slices' augmented weights, stays as it is (float32); X2, JAX's
    (n2, n_model·P·D) column concatenation of the slices' packs, becomes
    the (n_model, n2, P·D) tensor of contiguous slices. A bfloat16 X2
    crosses as its bits (``np.asarray(X2).view(np.uint16)``)."""
    dev = resolve_device(device)
    n_model, d_t, pack = meta["n_model"], meta["d_total"], meta["pack"]
    w = np.array(w_np, np.float32)
    X2 = np.asarray(X2_np)
    if w.shape != (n_model * d_t,):
        raise ValueError(f"w {w.shape}: want ({n_model * d_t},) for meta "
                         f"{meta}")
    if X2.ndim != 2 or X2.shape[1] != n_model * pack * d_t:
        raise ValueError(f"X2 {X2.shape}: want (n2, {n_model * pack * d_t})")
    slices = X2.reshape(X2.shape[0], n_model, pack * d_t).transpose(1, 0, 2)
    return (torch.from_numpy(w).to(dev),
            _bf16_or_f32(slices).to(dev).contiguous())


def ssgd_tp_params_to_jax(w, X2, meta: dict):
    """The inverse of :func:`ssgd_tp_params_from_jax`: numpy ``(w, X2)``
    in the JAX package's layout, X2 (n2, n_model·P·D) as float32 or, for
    bfloat16, as its ``np.uint16`` bits."""
    n_model, n2, width = X2.shape
    if n_model != meta["n_model"] or width != meta["pack"] * meta["d_total"]:
        raise ValueError(f"X2 {tuple(X2.shape)} does not match meta {meta}")
    cat = X2.detach().transpose(0, 1).reshape(n2, n_model * width).cpu()
    x = (cat.view(torch.int16).numpy().view(np.uint16)
         if cat.dtype == torch.bfloat16 else cat.numpy())
    return w.detach().cpu().numpy().astype(np.float32), x


def kmeans_params_from_jax(centers_np, *,
                           device: str | torch.device | None = None):
    """K-means centres (k, dim) from the JAX package as a contiguous
    float32 tensor on ``device``: what ``models.kmeans`` takes as
    ``centers0`` and ``serve.kmeans_model`` serves."""
    dev = resolve_device(device)
    c = np.array(centers_np, np.float32)  # a copy: JAX's are read-only
    if c.ndim != 2:
        raise ValueError(f"centers {c.shape}: want (k, dim)")
    return torch.from_numpy(c).to(dev).contiguous()


def pagerank_state_from_jax(ranks_np, has_rank_np, *,
                            device: str | torch.device | None = None):
    """A JAX PageRank run's carry — ``ranks`` (V,) and ``has_rank`` (V,),
    float32 or bool, 1 where a vertex holds a rank — as the float32
    ``(ranks0, has_rank0)`` the port's ``models.pagerank.run`` resumes
    from. PageRank has no weights: its state is the carry."""
    dev = resolve_device(device)
    ranks = np.array(ranks_np, np.float32)
    has = np.array(has_rank_np, np.float32)
    if ranks.ndim != 1 or ranks.shape != has.shape:
        raise ValueError(f"ranks {ranks.shape} vs has_rank {has.shape}: "
                         f"want two (V,) vectors")
    if not np.isin(has, (0.0, 1.0)).all():
        raise ValueError("has_rank must hold only 0 and 1")
    return (torch.from_numpy(ranks).to(dev).contiguous(),
            torch.from_numpy(has).to(dev).contiguous())
