"""SSGD kernels: the packed layout and the six gradient kernels.

Port of ``tpu_distalg/ops/pallas_kernels.py``:

  * :func:`packed_dims` and :func:`pack_augmented` (``:149-203``): the
    augmented row layout ``[features… | y | valid | zero-pad]`` of width
    ``d_total``, rows padded to a block multiple, optionally shuffled
    once, returned as X2 of shape (n_padded/pack, pack·d_total);
  * B6 :func:`fused_grad_sum` (``:92``): masked (Σ gradient, count) over
    unpacked X, y and mask in one pass;
  * B1 :func:`fused_grad_sum_gathered` (``:277``): the same sum over only
    the sampled ``gather_block_rows``-row blocks, with y and validity read
    from the columns ``y_col`` and ``v_col``;
  * B2 :func:`fused_train_gathered` (``:442``): T block-sampled SGD steps
    in one launch, with a float32 master and an optional EASGD pull;
  * B5 :func:`fused_grad_sum_packed` (``:737``): the same sum in one pass
    over ALL rows, each kept by a Bernoulli(fraction) draw made inside the
    kernel from (t, shard, row) (``build_selector`` is not ported);
  * B3 :func:`fused_forward_gathered` (``:590``) and B4
    :func:`fused_backward_gathered` (``:668``): B1's two halves, for the
    tensor-parallel split, where each model slice holds only some of the
    features and z must be summed over the slices between them. B3
    gives ``zyv = [z | y | v]`` per sampled packed slot, B4 the slice's
    gradient ``Σ bf16(resid)·x`` over the sampled rows.

The packed X2 is, byte for byte, the row-major (n_padded, d_total)
augmented matrix, and the CUDA kernels (``csrc/ssgd.cu``) read it as
such; the TPU kernels' block-diagonal selector and (P, P·D)
accumulator existed only to dodge TPU lane padding and are not ported.
So B2 takes and returns the (d_total,) weights, not the (P·D, 1) tile.

Beside each wrapper is its plain PyTorch version (``*_reference``),
with the same contract and the same rounding points: z sums x·w with w
cast to X's dtype, B1/B2 round the residual to X's dtype before the
backward product (B6 keeps it float32), B5 as B1, B3 as B1's z, B4
rounds the residual it is given as B1 does, sums are float32. A wrapper
takes its plain version only for tensors on the CPU; for CUDA tensors
it launches its kernel (counted in ``<wrapper>.launches``) or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_distalg_torch.ops import _native
from tpu_distalg_torch.telemetry import events as tevents
from tpu_distalg_torch.utils import prng
from tpu_distalg_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: B3 and B4 stride over a row in 16-byte vectors, so rows may be wide;
#: B3 stages w (D float32) in shared memory
MAX_TP_D = 32768


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}: use float32 or "
                         f"bfloat16") from None


def packed_dims(d: int, pack: int):
    """``(d_total, y_col, v_col)``: features + y + valid + zero-pad,
    rounded so that ``pack·d_total`` is a multiple of 128, as the JAX
    package lays it out."""
    y_col, v_col = d, d + 1
    lane_q = 128 // int(np.gcd(pack, 128))
    d_t = d + 2 + ((-(d + 2)) % lane_q)
    return int(d_t), y_col, v_col


def pack_augmented(X, y, valid, *, dtype=torch.bfloat16, pack: int = 16,
                   block_rows: int = 8192, shuffle_seed: int | None = None,
                   device: str | torch.device | None = None, mesh=None,
                   table: str = "ssgd", model_slice: int | None = None):
    """Pack (X, y, valid) once, outside the training loop.

    Row i of the augmented matrix is ``[X[i] | y[i] | valid[i] | 0…]``;
    rows are padded to a multiple of ``max(block_rows, pack)`` (padding
    rows carry valid = 0 and are inert) and ``shuffle_seed`` permutes
    the rows first with ``np.random.default_rng(shuffle_seed)``.
    Returns ``(X2, meta)``: X2 of shape (n_padded/pack, pack·d_total) in
    ``dtype`` on ``device`` (rounded to nearest even from float32, as
    JAX casts), meta the dict of pack, d_total, y_col, v_col,
    n_padded. With a ``mesh``, X2 is placed by ``table``'s rule for
    ``X2`` on the mesh's device (``partition.put``; ``model_slice`` for
    one model slice of the tp split): a process of a group keeps only
    its data shards' rows."""
    dev = resolve_device(device) if mesh is None else mesh.device
    with tevents.span("pack.host", fine=True):
        X = np.asarray(X, np.float32)
        if shuffle_seed is not None:
            perm = np.random.default_rng(shuffle_seed).permutation(
                X.shape[0])
            X, y = X[perm], np.asarray(y)[perm]
            valid = np.asarray(valid)[perm]
        n, d = X.shape
        d_t, y_col, v_col = packed_dims(d, pack)
        n_t = n + ((-n) % max(block_rows, pack))
        out = np.zeros((n_t, d_t), np.float32)
        out[:n, :d] = X
        out[:n, y_col] = np.asarray(y, np.float32)
        out[:n, v_col] = np.asarray(valid, np.float32)[:n]
        X2 = out.reshape(n_t // pack, pack * d_t)
    with tevents.span("pack.h2d", fine=True):
        if mesh is None:
            X2 = torch.from_numpy(X2).to(dev)
        else:
            from tpu_distalg_torch.parallel import partition

            X2 = partition.put(X2, "X2", table, mesh,
                               model_slice=model_slice)
        X2 = X2.to(as_dtype(dtype))
    meta = dict(pack=pack, d_total=d_t, y_col=y_col, v_col=v_col,
                n_padded=n_t)
    return X2, meta


# ---------------------------------------------------------------- plain


def grad_sum_reference(X, y, mask, w):
    """Plain B6: ``(Xᵀ·((σ(X·w_X) − y)·mask), Σmask)`` with ``w_X`` =
    w cast to X's dtype, the residual and sums in float32."""
    Xf = X.to(torch.float32)
    wq = w.to(X.dtype).to(torch.float32)
    resid = (torch.sigmoid(Xf @ wq) - y) * mask
    return Xf.T @ resid, mask.sum()


def _gathered_rows(X2, block_idx, d_total, gather_block_rows):
    rows = X2.reshape(-1, d_total)
    blocks = rows.reshape(-1, gather_block_rows, d_total)
    return blocks[block_idx.long()].reshape(-1, d_total)


def _grad_rows(x, wq, y_col, v_col, dtype):
    """(g, count) of float32 rows ``x`` from X's type ``dtype``."""
    z = x @ wq
    resid = ((torch.sigmoid(z) - x[:, y_col]) * x[:, v_col]).to(dtype)
    return x.T @ resid.to(torch.float32), x[:, v_col].sum()


def grad_sum_gathered_reference(X2, w_aug, block_idx, *, pack: int,
                                d_total: int, y_col: int, v_col: int,
                                gather_block_rows: int = 1024):
    """Plain B1 over rows ``[b·gbr, (b+1)·gbr)`` of each sampled block
    b: the (d_total,) float32 gradient (entries at and past ``y_col``
    are not part of the contract) and the count Σ x[v_col]."""
    del pack
    x = _gathered_rows(X2, block_idx, d_total,
                       gather_block_rows).to(torch.float32)
    wq = w_aug.to(X2.dtype).to(torch.float32)
    return _grad_rows(x, wq, y_col, v_col, X2.dtype)


def forward_gathered_reference(X2, w_aug, block_idx, *, pack: int,
                               d_total: int, y_col: int, v_col: int,
                               gather_block_rows: int = 1024):
    """Plain B3: ``zyv`` (n_s·bp, 3P) float32, bp = gbr/P. Sampled row
    ``i = k·gbr + r·P + c`` (row r·P + c of block ``block_idx[k]``) is
    packed row ``k·bp + r``, slot c: column c holds ``z = Σ_j x_j·w_j``
    over all ``d_total`` columns with w cast to X2's dtype, column
    ``P + c`` its ``x[y_col]`` and column ``2P + c`` its ``x[v_col]``."""
    x = _gathered_rows(X2, block_idx, d_total,
                       gather_block_rows).to(torch.float32)
    wq = w_aug.to(X2.dtype).to(torch.float32)
    zyv = torch.stack([x @ wq, x[:, y_col], x[:, v_col]])   # (3, rows)
    rows = x.shape[0]
    return zyv.reshape(3, rows // pack, pack).transpose(0, 1).reshape(
        rows // pack, 3 * pack)


def backward_gathered_reference(X2, resid, block_idx, *, pack: int,
                                d_total: int, gather_block_rows: int = 1024):
    """Plain B4: the (d_total,) float32 ``g = Σ_i bf16(resid_i)·x_i``
    over the sampled rows, ``resid`` (n_s·bp, P) in B3's sampled order
    (element ``(i // P, i % P)`` belongs to sampled row i), rounded to
    X2's dtype before the product."""
    del pack
    x = _gathered_rows(X2, block_idx, d_total,
                       gather_block_rows).to(torch.float32)
    r = resid.reshape(-1).to(X2.dtype).to(torch.float32)
    return x.T @ r


def packed_threshold(fraction: float) -> int:
    """B5 keeps a row iff its 32 random bits are below this:
    ``min(int(fraction·2³²), 2³² − 1)``, as the JAX package."""
    return min(int(fraction * 2.0**32), 2**32 - 1)


def packed_keep_mask(t: int, shard: int, n_rows: int, fraction: float,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    """B5's Bernoulli(fraction) draw over the ``n_rows`` rows of a
    shard, (n_rows,) bool: row i is kept iff element i of
    ``prng.bits`` under the key ``(uint32(t), uint32(shard))`` is below
    :func:`packed_threshold`. It depends on t, the shard and the row's
    index in the shard alone."""
    key = torch.tensor([int(t) & prng.MASK32, int(shard) & prng.MASK32],
                       dtype=torch.int64, device=device)
    return prng.bits(key, (n_rows,)) < packed_threshold(fraction)


def grad_sum_packed_reference(X2, w_aug, t: int, shard: int, *, pack: int,
                              d_total: int, y_col: int, v_col: int,
                              fraction: float, block_rows: int = 8192):
    """Plain B5 over every row of X2 with ``m = x[v_col]·keep``
    (:func:`packed_keep_mask`): the (d_total,) float32 gradient
    (entries at and past ``y_col`` are not part of the contract) and
    the count Σ m."""
    del pack, block_rows
    x = X2.reshape(-1, d_total).to(torch.float32)
    keep = packed_keep_mask(t, shard, x.shape[0], fraction, X2.device)
    wq = w_aug.to(X2.dtype).to(torch.float32)
    m = x[:, v_col] * keep
    resid = ((torch.sigmoid(x @ wq) - x[:, y_col]) * m).to(X2.dtype)
    return x.T @ resid.to(torch.float32), m.sum()


def train_gathered_reference(X2, w0, block_idx, *, pack: int, d_total: int,
                             y_col: int, v_col: int, gather_block_rows: int,
                             eta: float, alpha: float = 0.0, center=None,
                             skip_update: bool = False):
    """Plain B2: ``block_idx.shape[0]`` steps of B1's gradient at the
    float32 master (cast to X's dtype, zero at columns >= y_col), each
    followed by ``w ← w − (η/max(cnt, 1))·g·[j < y_col]`` and, if
    α ≠ 0, ``w ← w − α·(w_before − center)``. Returns the (d_total,)
    float32 master."""
    del pack
    keep = torch.arange(d_total, device=X2.device) < y_col
    w = w0.to(torch.float32).clone()
    eta_t = torch.tensor(eta, dtype=torch.float32, device=X2.device)
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=X2.device)
    if center is None:
        center = torch.zeros_like(w)
    for ids in block_idx:
        x = _gathered_rows(X2, ids, d_total,
                           gather_block_rows).to(torch.float32)
        wq = torch.where(keep, w, 0.0).to(X2.dtype).to(torch.float32)
        g, cnt = _grad_rows(x, wq, y_col, v_col, X2.dtype)
        if skip_update:
            continue
        nb = torch.clamp_min(cnt, 1.0)
        w_new = w - (eta_t / nb) * torch.where(keep, g, 0.0)
        if alpha:
            w_new = w_new - alpha_t * (w - center)
        w = w_new
    return w


# -------------------------------------------------------------- kernels


#: B1/B2's ring (``csrc/ssgd.cu``): consumer warps, rows a lane group takes
#: a pass, rows of at most RING_VPL2_VECTORS vectors take 2 vectors a lane
#: (else 4), a stage's target bytes, the most slots and rows a stage, and
#: the dynamic shared memory a block may use on an H100
RING_WARPS, RING_U, RING_VPL2_VECTORS, RING_STAGE_BYTES = 16, 1, 64, 16384
RING_MAX_STAGES, RING_MAX_STAGE_ROWS, SMEM_MAX = 12, 1024, 232448
#: rows of more than this many bytes take B1/B2's wide ring
MAX_RING_ROW_BYTES = 2048
#: the wide ring (``csrc/ssgd.cu``): 16-byte vectors a consumer thread owns
#: of a row (rows of up to RING_WARPS·32·WIDE_MAX_KV vectors, 32 KB; wider
#: rows take the wide body), the float4s of B2's fold scratch
WIDE_MAX_KV, WIDE_FOLD_QUADS = 4, 256
WIDE_MAX_VECTORS = RING_WARPS * 32 * WIDE_MAX_KV
#: floats at the head of a B1/B2 workspace: the launch counters
WORK_COUNTERS = 32


def _ring_smem(d_total: int, stage_bytes: int, stages: int,
               out_floats: int = 0) -> int:
    """Bytes of a ring block's dynamic shared memory, as
    ``csrc/ssgd.cu::ring_layout`` lays it out (``out_floats``: B3's
    staged zyv rows)."""
    wp = (d_total + 4) // 4 * 4

    def r16(x):
        return (x + 15) & ~15

    o = stages * (stage_bytes + 16 + 4 * RING_MAX_STAGE_ROWS // 32)
    o = r16(o + 4 * d_total)
    o = r16(o + 4 * (RING_WARPS * d_total + RING_WARPS))
    return o + 4 * max(4 * 32 * RING_WARPS, wp) + 16 + 4 * out_floats


def _wide_smem(d_total: int, row_bytes: int, stage_bytes: int,
               stages: int) -> int:
    """Bytes of a wide-ring block's dynamic shared memory, as
    ``csrc/ssgd.cu::wide_layout`` lays it out."""
    o = stages * (stage_bytes + 16 + 4 * RING_MAX_STAGE_ROWS // 32)
    o = (o + 15) & ~15
    return (o + row_bytes + 4 * d_total + 16 * WIDE_FOLD_QUADS
            + 4 * 4 * 2 * RING_WARPS + 16)


@functools.cache
def gathered_plan(n_rows: int, d_total: int, dtype, n_sm: int) -> dict:
    """B1/B2's launch plan for ``n_rows`` sampled rows of ``d_total``
    columns, from the shapes and the SM count alone (so B1 and B2 add
    in the same order, and a run replays bit for bit). ``body`` names
    the kernels' body, which the row's width alone decides.

    A row is L = d_total·size/16 vectors of 16 bytes. Block k of
    ``blocks`` (at most one per SM) takes the sampled rows [k·chunk,
    (k+1)·chunk); its producer copies them in stages of ``stage_rows``
    whole rows (about 16 KB) into ``stages`` ring slots, as many as the
    shared memory holds, at most 12. Rows of at most 2048 bytes take
    the ring (``ring``): a lane holds ``vpl`` of a row's vectors (2, or
    4 past 64) and G = the least power of two with G·vpl >= L lanes own
    a row; a stage is a multiple of a consumer pass. Rows of up to
    WIDE_MAX_VECTORS vectors take the wide ring (``wide_ring``): a
    consumer warp a row for its residual, a consumer thread ``owned``
    (at most 4) vectors of the partial, in its registers, the rest of
    the shared memory holding w cast to X's type and the float32
    master. ``workspace`` is the floats the launch needs beside its
    output: the counters, then the partials of two steps (and, on the
    wide ring, the step's sum). Wider rows take the wide body
    (``wide``): at most ``blocks`` = 4 per SM, and room for their
    partials, the step's sum and the blocks' masters."""
    size = as_dtype(dtype).itemsize
    row_bytes = d_total * size
    if row_bytes % 16:
        raise ValueError(f"a row of {d_total} × {size} bytes is not a whole "
                         f"number of 16-byte vectors")
    L = row_bytes // 16
    wp = (d_total + 4) // 4 * 4
    if L > WIDE_MAX_VECTORS:
        blocks = 4 * n_sm
        return dict(body="wide", blocks=blocks, chunk=0, stage_rows=0,
                    stages=0, workspace=WORK_COUNTERS + (blocks + 1)
                    * (d_total + 1) + blocks * d_total)
    if row_bytes > MAX_RING_ROW_BYTES:
        stage_rows = max(1, RING_STAGE_BYTES // row_bytes)
        stage_bytes = stage_rows * row_bytes
        fixed = _wide_smem(d_total, row_bytes, 0, 0)
        stages = min(RING_MAX_STAGES, (SMEM_MAX - fixed) // (
            _wide_smem(d_total, row_bytes, stage_bytes, 1) - fixed))
        chunk = -(-max(n_rows, 1) // n_sm)
        blocks = -(-max(n_rows, 1) // chunk)
        return dict(body="wide_ring", vectors=L,
                    owned=-(-L // (RING_WARPS * 32)), stage_rows=stage_rows,
                    stage_bytes=stage_bytes, stages=stages, chunk=chunk,
                    blocks=blocks,
                    smem=_wide_smem(d_total, row_bytes, stage_bytes, stages),
                    workspace=WORK_COUNTERS + (2 * blocks + 1) * wp)
    vpl = 2 if L <= RING_VPL2_VECTORS else 4
    G = 1
    while G * vpl < L:
        G *= 2
    pass_rows = RING_WARPS * (32 // G) * RING_U
    stage_rows = pass_rows * max(1, RING_STAGE_BYTES // (row_bytes
                                                         * pass_rows))
    stage_bytes = stage_rows * row_bytes
    fixed = _ring_smem(d_total, 0, 0)
    stages = min(RING_MAX_STAGES, (SMEM_MAX - fixed) // (
        _ring_smem(d_total, stage_bytes, 1) - fixed))
    chunk = max(-(-max(n_rows, 1) // n_sm), RING_WARPS * (32 // G))
    blocks = -(-max(n_rows, 1) // chunk)
    return dict(body="ring", vectors=L, lanes=G, vpl=vpl,
                pass_rows=pass_rows, stage_rows=stage_rows,
                stage_bytes=stage_bytes, stages=stages, chunk=chunk,
                blocks=blocks, smem=_ring_smem(d_total, stage_bytes, stages),
                workspace=WORK_COUNTERS + 2 * blocks * wp)


def _workspace(dev, stream: int, floats: int) -> torch.Tensor:
    """B1/B2's workspace on ``stream``: counters that every launch leaves
    at zero, then partials."""
    return _native.workspace("ssgd", dev, stream, floats, torch.float32)


@functools.cache
def _entry(name: str):
    """A C entry point of the ssgd library (built at first use)."""
    return getattr(_native.load("ssgd"), name)


def _check_packed(X2, pack, d_total, gather_block_rows, what):
    """The JAX package's shape contract of X2 (its TPU tiling rule, a
    multiple of 8 packed rows per block, is not part of it)."""
    n2, pd = X2.shape
    bp = gather_block_rows // pack if pack > 0 else 0
    if (pd != pack * d_total or (pack * d_total) % 128
            or gather_block_rows % pack or bp == 0 or n2 % bp):
        raise ValueError(
            f"{what}: X2 {tuple(X2.shape)} incompatible with pack={pack}, "
            f"d_total={d_total}, gather_block_rows={gather_block_rows}")


def _check_row_kernel(X2, d_total, y_col, v_col, what):
    """What the CUDA kernels of B1/B2 need beyond the contract."""
    row_bytes = d_total * X2.element_size()
    if row_bytes % 16:
        raise ValueError(
            f"{what}: a row of d_total={d_total} {X2.dtype} is {row_bytes} "
            f"bytes; the CUDA kernel reads rows as 16-byte vectors")
    if X2.data_ptr() % 16:
        raise ValueError(f"{what}: X2 must be 16-byte aligned")
    if not (0 <= y_col < d_total and 0 <= v_col < d_total):
        raise ValueError(f"{what}: y_col={y_col}, v_col={v_col} outside "
                         f"d_total={d_total}")


def fused_grad_sum(X, y, mask, w, *, block_rows: int = 2048):
    """B6: masked ``(Σ gradient (d,) f32, count f32)`` in one pass over X.

    X (n, d) float32 or bfloat16; y, mask (n,) and w (d,) float32, all
    contiguous on one device. ``block_rows`` is the JAX kernel's row
    tile; the CUDA kernel sizes its own blocks, so it only has to be
    positive. A CPU tensor goes to :func:`grad_sum_reference`; a CUDA
    tensor launches the kernel (``fused_grad_sum.launches``) or raises."""
    _native.check_tensor("X", X, (torch.float32, torch.bfloat16), 2)
    for name, t in (("y", y), ("mask", mask), ("w", w)):
        _native.check_tensor(name, t, (torch.float32,), 1)
    n, d = X.shape
    if y.shape[0] != n or mask.shape[0] != n or w.shape[0] != d:
        raise ValueError(f"X {tuple(X.shape)}, y {tuple(y.shape)}, mask "
                         f"{tuple(mask.shape)}, w {tuple(w.shape)} disagree")
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    if X.device.type == "cpu":
        return grad_sum_reference(X, y, mask, w)
    dev = _native.cuda_device(X, y, mask, w)
    if n < 1 or d < 1 or n >= 2**31:
        raise ValueError(f"X {tuple(X.shape)}: the CUDA kernel takes "
                         f"d >= 1 and 1 <= n < 2**31")
    X, y, mask, w = (t.contiguous() for t in (X, y, mask, w))
    lib = _native.load("ssgd")
    max_blocks = 4 * _native.sm_count(dev.index)
    partial = torch.empty((max_blocks, d + 1), dtype=torch.float32,
                          device=dev)
    # the rows' residuals, for the two-pass body of rows over 4096 columns
    resid = torch.empty((n,), dtype=torch.float32, device=dev)
    out = torch.empty((d + 1,), dtype=torch.float32, device=dev)
    rc = lib.tda_ssgd_grad(
        X.data_ptr(), _DTYPE_CODE[X.dtype], y.data_ptr(), mask.data_ptr(),
        w.data_ptr(), n, d, max_blocks, partial.data_ptr(), resid.data_ptr(),
        out.data_ptr(), dev.index, _native.stream(dev))
    _native.check(lib, rc, "fused_grad_sum")
    fused_grad_sum.launches += 1
    return out[:d], out[d]


fused_grad_sum.launches = 0


def fused_grad_sum_gathered(X2, w_aug, block_idx, *, pack: int,
                            d_total: int, y_col: int, v_col: int,
                            gather_block_rows: int = 1024):
    """B1: ``(Σ gradient (d_total,) f32, count f32)`` over only the
    sampled blocks ``block_idx`` (n_s,) of X2, in one pass.

    X2 (n/pack, pack·d_total) float32 or bfloat16, w_aug (d_total,)
    float32; y and validity come from columns ``y_col`` and ``v_col``.
    Block ids must lie in ``[0, n_blocks)``; repeats count each time.
    Entries of the gradient at and past ``y_col`` are not part of the
    contract. A CPU tensor goes to :func:`grad_sum_gathered_reference`;
    a CUDA tensor launches the kernel (``.launches``) or raises."""
    _native.check_tensor("X2", X2, (torch.float32, torch.bfloat16), 2)
    _native.check_tensor("w_aug", w_aug, (torch.float32,), 1)
    _native.check_tensor("block_idx", block_idx,
                         (torch.int32, torch.int64), 1)
    _check_packed(X2, pack, d_total, gather_block_rows,
                  "fused_grad_sum_gathered")
    if w_aug.shape[0] != d_total:
        raise ValueError(f"w_aug {tuple(w_aug.shape)} != ({d_total},)")
    if X2.device.type == "cpu":
        return grad_sum_gathered_reference(
            X2, w_aug, block_idx, pack=pack, d_total=d_total, y_col=y_col,
            v_col=v_col, gather_block_rows=gather_block_rows)
    dev = _native.cuda_device(X2, w_aug, block_idx)
    _check_row_kernel(X2, d_total, y_col, v_col, "fused_grad_sum_gathered")
    n_s = block_idx.shape[0]
    if n_s < 1:
        raise ValueError("block_idx is empty")
    if block_idx.dtype != torch.int32:
        block_idx = block_idx.to(torch.int32)
    X2, ids, w_aug = X2.contiguous(), block_idx.contiguous(), w_aug.contiguous()
    plan = gathered_plan(n_s * gather_block_rows, d_total, X2.dtype,
                         _native.sm_count(dev.index))
    stream = _native.stream(dev)
    work = _workspace(dev, stream, plan["workspace"])
    out = torch.empty((d_total + 1,), dtype=torch.float32, device=dev)
    rc = _entry("tda_ssgd_grad_gathered")(
        X2.data_ptr(), _DTYPE_CODE[X2.dtype], ids.data_ptr(), n_s,
        X2.shape[0] * pack // gather_block_rows, gather_block_rows, d_total,
        y_col, v_col, w_aug.data_ptr(), plan["blocks"], plan["chunk"],
        plan["stage_rows"], plan["stages"], work.data_ptr(), out.data_ptr(),
        dev.index, stream)
    if rc:
        _native.check(_native.load("ssgd"), rc, "fused_grad_sum_gathered")
    fused_grad_sum_gathered.launches += 1
    fused_grad_sum_gathered.launches_by_body[plan["body"]] += 1
    return out[:d_total], out[d_total]


fused_grad_sum_gathered.launches = 0
#: B1's and B2's launches by the body that took them (gathered_plan's body)
fused_grad_sum_gathered.launches_by_body = dict(ring=0, wide_ring=0, wide=0)


def fused_grad_sum_packed(X2, w_aug, t: int, shard: int, *, pack: int,
                          d_total: int, y_col: int, v_col: int,
                          fraction: float, block_rows: int = 8192):
    """B5: ``(Σ gradient (d_total,) f32, count f32)`` in one pass over
    ALL rows of X2, the minibatch drawn inside the kernel.

    X2 (n/pack, pack·d_total) float32 or bfloat16 holds one shard's
    rows, w_aug (d_total,) float32. Row i of the shard is kept iff
    ``bits < min(int(fraction·2³²), 2³² − 1)`` where ``bits`` is
    threefry2x32 under the key ``(uint32(t), uint32(shard))`` of the
    counter ``(0, i)``, its two words xored: element i of
    ``utils.prng.bits`` under that key (:func:`packed_keep_mask`). The
    trainer passes ``t = step + seed``. So the mask depends on t, the
    shard and the row alone, never on ``block_rows`` or the launch
    grid. (The TPU kernel draws from its on-core generator, whose bits
    cannot be had elsewhere; only the distribution is shared.) The
    residual ``(σ(z) − y)·m`` with ``m = x[v_col]·keep`` is rounded to
    X2's dtype, the count is Σ m; entries of the gradient at and past
    ``y_col`` are not part of the contract. ``block_rows`` is the JAX
    kernel's row tile: X2's rows must be a multiple of it. A CPU tensor
    goes to :func:`grad_sum_packed_reference`; a CUDA tensor launches
    the kernel (``.launches``) or raises."""
    _native.check_tensor("X2", X2, (torch.float32, torch.bfloat16), 2)
    _native.check_tensor("w_aug", w_aug, (torch.float32,), 1)
    _check_packed(X2, pack, d_total, block_rows, "fused_grad_sum_packed")
    if w_aug.shape[0] != d_total:
        raise ValueError(f"w_aug {tuple(w_aug.shape)} != ({d_total},)")
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"fraction must lie in [0, 1], got {fraction}")
    if X2.device.type == "cpu":
        return grad_sum_packed_reference(
            X2, w_aug, t, shard, pack=pack, d_total=d_total, y_col=y_col,
            v_col=v_col, fraction=fraction, block_rows=block_rows)
    dev = _native.cuda_device(X2, w_aug)
    _check_row_kernel(X2, d_total, y_col, v_col, "fused_grad_sum_packed")
    n = X2.shape[0] * pack
    if not 1 <= n < 2**30:
        raise ValueError(f"fused_grad_sum_packed: {n} rows; the CUDA kernel "
                         f"takes 1 <= n < 2**30")
    X2, w_aug = X2.contiguous(), w_aug.contiguous()
    lib = _native.load("ssgd")
    max_blocks = 4 * _native.sm_count(dev.index)
    partial = torch.empty((max_blocks, d_total + 1), dtype=torch.float32,
                          device=dev)
    out = torch.empty((d_total + 1,), dtype=torch.float32, device=dev)
    rc = lib.tda_ssgd_grad_packed(
        X2.data_ptr(), _DTYPE_CODE[X2.dtype], n, d_total, y_col, v_col,
        w_aug.data_ptr(), int(t) & prng.MASK32, int(shard) & prng.MASK32,
        packed_threshold(fraction), max_blocks, partial.data_ptr(),
        out.data_ptr(), dev.index,
        _native.stream(dev))
    _native.check(lib, rc, "fused_grad_sum_packed")
    fused_grad_sum_packed.launches += 1
    return out[:d_total], out[d_total]


fused_grad_sum_packed.launches = 0


def fused_train_gathered(X2, w0, block_idx, *, pack: int, d_total: int,
                         y_col: int, v_col: int, gather_block_rows: int,
                         eta: float, alpha: float = 0.0, center=None,
                         skip_update: bool = False):
    """B2: ``T = block_idx.shape[0]`` block-sampled SGD steps in one
    launch; returns the final (d_total,) float32 weights.

    ``w0`` (d_total,) float32 is the augmented start; ``block_idx``
    (T, n_s) holds each step's block ids. Each step is B1's gradient
    at the float32 master (cast to X's dtype, zero at columns >= y_col)
    and ``w ← w − (η/max(cnt, 1))·g`` with g zero at columns >= y_col;
    ``alpha``/``center`` add the EASGD pull ``w ← w − α·(w_before −
    center)``. ``skip_update`` keeps each step's gradient pass and drops
    the update (the weights stay ``w0``): it prices the update chain.
    A CPU tensor goes to :func:`train_gathered_reference`; a CUDA
    tensor launches the kernel (``.launches``) or raises."""
    _native.check_tensor("X2", X2, (torch.float32, torch.bfloat16), 2)
    _native.check_tensor("w0", w0, (torch.float32,), 1)
    _native.check_tensor("block_idx", block_idx,
                         (torch.int32, torch.int64), 2)
    _check_packed(X2, pack, d_total, gather_block_rows,
                  "fused_train_gathered")
    if w0.shape[0] != d_total:
        raise ValueError(f"w0 {tuple(w0.shape)} != ({d_total},)")
    if center is not None:
        _native.check_tensor("center", center, (torch.float32,), 1)
        if center.shape[0] != d_total:
            raise ValueError(f"center {tuple(center.shape)} != "
                             f"({d_total},)")
    if X2.device.type == "cpu":
        return train_gathered_reference(
            X2, w0, block_idx, pack=pack, d_total=d_total, y_col=y_col,
            v_col=v_col, gather_block_rows=gather_block_rows, eta=eta,
            alpha=alpha, center=center, skip_update=skip_update)
    if center is None:
        center = torch.zeros_like(w0)
    dev = _native.cuda_device(X2, w0, block_idx, center)
    _check_row_kernel(X2, d_total, y_col, v_col, "fused_train_gathered")
    T, n_s = block_idx.shape
    if T < 1 or n_s < 1:
        raise ValueError(f"block_idx {tuple(block_idx.shape)} is empty")
    X2 = X2.contiguous()
    ids = block_idx.to(torch.int32).contiguous()
    w0, center = w0.contiguous(), center.contiguous()
    plan = gathered_plan(n_s * gather_block_rows, d_total, X2.dtype,
                         _native.sm_count(dev.index))
    stream = _native.stream(dev)
    work = _workspace(dev, stream, plan["workspace"])
    w_out = torch.empty((d_total,), dtype=torch.float32, device=dev)
    rc = _entry("tda_ssgd_train")(
        X2.data_ptr(), _DTYPE_CODE[X2.dtype], ids.data_ptr(), T, n_s,
        X2.shape[0] * pack // gather_block_rows, gather_block_rows, d_total,
        y_col, v_col, w0.data_ptr(), center.data_ptr(), float(eta),
        float(alpha), int(skip_update), plan["blocks"], plan["chunk"],
        plan["stage_rows"], plan["stages"], work.data_ptr(), w_out.data_ptr(),
        dev.index, stream)
    if rc:
        _native.check(_native.load("ssgd"), rc, "fused_train_gathered")
    fused_train_gathered.launches += 1
    fused_train_gathered.launches_by_body[plan["body"]] += 1
    return w_out


fused_train_gathered.launches = 0
fused_train_gathered.launches_by_body = dict(ring=0, wide_ring=0, wide=0)

#: B4's launch geometry: 8 warps a block, 4 rows in flight a lane group,
#: and row chunks sized for about 528 blocks (4 per SM of an H100 SXM, a
#: constant so that the order of B4's sums depends on the shapes alone)
TP_WARPS, TP_ROWS_IN_FLIGHT, TP_TARGET_BLOCKS = 8, 4, 528
#: 16-byte vectors a lane holds of a row in B3's ring body
#: (``csrc/ssgd.cu::kFwdVPL``)
FWD_VPL = 4
#: B3's wide body (rows over 2048 bytes), a grid-stride launch: at most
#: this many blocks (its rows are independent, so the grid size never
#: changes a result)
TP_MAX_FWD_BLOCKS = 1056


@functools.cache
def tp_kernel_plan(n_rows: int, d_total: int, dtype) -> dict:
    """B4's launch plan, and the grid of B3's wide body, from the shapes
    alone (``csrc/ssgd.cu`` derives the same lanes and tiles from D and
    the element size).

    A row is L = d_total·size/16 vectors of 16 bytes; G = the least power
    of two >= L, at most 32, lanes own a row (a lane one vector; longer
    rows: B4 ``tiles`` column tiles of 32 vectors); a warp holds 32/G
    rows. B3's wide body (:func:`forward_plan`) takes ``fwd_blocks``
    blocks. B4 splits the ``n_rows``
    sampled rows into ``n_chunks`` chunks of ``chunk`` rows (a multiple
    of one block pass), one block per (chunk, tile); each block adds its
    rows in row order, and the chunks' partials are added in chunk order
    by a second launch."""
    size = as_dtype(dtype).itemsize
    if (d_total * size) % 16:
        raise ValueError(f"a row of {d_total} × {size} bytes is not a whole "
                         f"number of 16-byte vectors")
    L = d_total * size // 16
    G = 1
    while G < L and G < 32:
        G *= 2
    tiles = -(-L // G)
    pass_rows = TP_WARPS * (32 // G) * TP_ROWS_IN_FLIGHT
    want = max(1, TP_TARGET_BLOCKS // tiles)
    chunk = -(-max(n_rows, 1) // want)
    chunk = -(-chunk // pass_rows) * pass_rows
    n_chunks = -(-max(n_rows, 1) // chunk)
    fwd_blocks = min(TP_MAX_FWD_BLOCKS,
                     -(-max(n_rows, 1) // (TP_WARPS * (32 // G)
                                            * TP_ROWS_IN_FLIGHT)))
    return dict(vectors=L, lanes=G, tiles=tiles, chunk=chunk,
                n_chunks=n_chunks, fwd_blocks=fwd_blocks)


@functools.cache
def forward_plan(n_rows: int, d_total: int, dtype, pack: int,
                 n_sm: int) -> dict:
    """B3's launch plan for ``n_rows`` sampled rows, from the shapes and
    the SM count alone (its rows are independent, so the plan never
    changes a result).

    Rows of at most 2048 bytes go through B1's ring (``ring``): a lane
    holds ``vpl`` = FWD_VPL vectors of a row and G lanes, the least power
    of two with G·vpl >= L, own it; a stage is ``stage_rows`` rows, a
    multiple of
    a consumer pass and of ``pack`` (about 16 KB), over ``stages`` slots;
    block k takes the rows [k·chunk, (k+1)·chunk), ``chunk`` a multiple
    of ``pack`` and of 4, at most one block an SM. So one block writes
    each packed zyv row, and each stage's rows are one 16-byte aligned
    run of zyv. Wider rows, or a pack no stage of at most 1024 rows
    holds (or 2**30 rows and more), take the wide body on
    :func:`tp_kernel_plan`'s ``fwd_blocks`` (``ring`` False,
    ``stage_rows`` 0)."""
    size = as_dtype(dtype).itemsize
    row_bytes = d_total * size
    if row_bytes % 16:
        raise ValueError(f"a row of {d_total} × {size} bytes is not a whole "
                         f"number of 16-byte vectors")
    L = row_bytes // 16
    vpl, G = FWD_VPL, 1
    while G * vpl < L:
        G *= 2
    unit = int(np.lcm(RING_WARPS * (32 // G), pack))
    if (row_bytes <= MAX_RING_ROW_BYTES and unit <= RING_MAX_STAGE_ROWS
            and n_rows < 2**30):
        stage_rows = unit * max(1, RING_STAGE_BYTES // (row_bytes * unit))
        out = 6 * stage_rows
        fixed = _ring_smem(d_total, 0, 0, out)
        stages = min(RING_MAX_STAGES, (SMEM_MAX - fixed) // (
            _ring_smem(d_total, stage_rows * row_bytes, 1, out) - fixed))
        if stages >= 2:
            step = int(np.lcm(pack, 4))
            chunk = -(-max(n_rows, 1) // n_sm)
            chunk = -(-chunk // step) * step
            return dict(ring=True, vectors=L, lanes=G, vpl=vpl,
                        stage_rows=stage_rows, stages=stages, chunk=chunk,
                        blocks=-(-max(n_rows, 1) // chunk),
                        smem=_ring_smem(d_total, stage_rows * row_bytes,
                                        stages, out))
    return dict(ring=False, stage_rows=0, stages=0, chunk=0,
                blocks=tp_kernel_plan(n_rows, d_total, dtype)["fwd_blocks"])


def _check_tp_kernel(X2, d_total, what):
    """What the CUDA kernels of B3/B4 need beyond the contract."""
    row_bytes = d_total * X2.element_size()
    if row_bytes % 16 or d_total > MAX_TP_D:
        raise ValueError(
            f"{what}: a row of d_total={d_total} {X2.dtype} is {row_bytes} "
            f"bytes; the CUDA kernel reads rows as 16-byte vectors, at "
            f"most {MAX_TP_D} columns")
    if X2.data_ptr() % 16:
        raise ValueError(f"{what}: X2 must be 16-byte aligned")


def fused_forward_gathered(X2, w_aug, block_idx, *, pack: int,
                           d_total: int, y_col: int, v_col: int,
                           gather_block_rows: int = 1024):
    """B3: ``zyv`` (n_s·bp, 3P) float32 = [z | y | v] per packed slot of
    the sampled blocks ``block_idx`` (n_s,), bp = gather_block_rows/P.

    X2 (n/pack, pack·d_total) float32 or bfloat16 holds one model
    slice's features with the y/v columns replicated into it; w_aug
    (d_total,) float32 is that slice's weights. z sums x·w over all
    d_total columns in float32 with w cast to X2's dtype (the y/v/pad
    entries of w are held at zero by the trainer, so they add nothing);
    the layout is :func:`forward_gathered_reference`'s. Block ids must
    lie in ``[0, n_blocks)``; repeats appear each time. A CPU tensor goes
    to :func:`forward_gathered_reference`; a CUDA tensor launches the
    kernel (``.launches``) or raises."""
    _native.check_tensor("X2", X2, (torch.float32, torch.bfloat16), 2)
    _native.check_tensor("w_aug", w_aug, (torch.float32,), 1)
    _native.check_tensor("block_idx", block_idx,
                         (torch.int32, torch.int64), 1)
    _check_packed(X2, pack, d_total, gather_block_rows,
                  "fused_forward_gathered")
    if w_aug.shape[0] != d_total:
        raise ValueError(f"w_aug {tuple(w_aug.shape)} != ({d_total},)")
    if not (0 <= y_col < d_total and 0 <= v_col < d_total):
        raise ValueError(f"y_col={y_col}, v_col={v_col} outside "
                         f"d_total={d_total}")
    if X2.device.type == "cpu":
        return forward_gathered_reference(
            X2, w_aug, block_idx, pack=pack, d_total=d_total, y_col=y_col,
            v_col=v_col, gather_block_rows=gather_block_rows)
    dev = _native.cuda_device(X2, w_aug, block_idx)
    _check_tp_kernel(X2, d_total, "fused_forward_gathered")
    n_s = block_idx.shape[0]
    rows = n_s * gather_block_rows
    if not 1 <= rows < 2**31:
        raise ValueError(f"fused_forward_gathered: {n_s} blocks of "
                         f"{gather_block_rows} rows; the CUDA kernel takes "
                         f"1 to 2**31 - 1 sampled rows")
    X2 = X2.contiguous()
    ids = block_idx.to(torch.int32).contiguous()
    w_aug = w_aug.contiguous()
    plan = forward_plan(rows, d_total, X2.dtype, pack,
                        _native.sm_count(dev.index))
    zyv = torch.empty((rows // pack, 3 * pack), dtype=torch.float32,
                      device=dev)
    rc = _entry("tda_ssgd_forward_gathered")(
        X2.data_ptr(), _DTYPE_CODE[X2.dtype], ids.data_ptr(), n_s,
        X2.shape[0] * pack // gather_block_rows, gather_block_rows, d_total,
        y_col, v_col, pack, w_aug.data_ptr(), plan["blocks"], plan["chunk"],
        plan["stage_rows"], plan["stages"], zyv.data_ptr(), dev.index,
        _native.stream(dev))
    if rc:
        _native.check(_native.load("ssgd"), rc, "fused_forward_gathered")
    fused_forward_gathered.launches += 1
    return zyv


fused_forward_gathered.launches = 0


def fused_backward_gathered(X2, resid, block_idx, *, pack: int,
                            d_total: int, gather_block_rows: int = 1024):
    """B4: this model slice's (d_total,) float32 gradient
    ``g = Σ_i bf16(resid_i)·x_i`` over the sampled blocks ``block_idx``.

    X2 as in :func:`fused_forward_gathered`; ``resid`` (n_s·bp, P)
    float32 in B3's sampled order, rounded to X2's dtype before the
    product; sums in float32, in an order fixed by the shapes
    (:func:`tp_kernel_plan`), so a run replays bit for bit. A CPU tensor
    goes to :func:`backward_gathered_reference`; a CUDA tensor launches
    the kernel (``.launches``) or raises."""
    _native.check_tensor("X2", X2, (torch.float32, torch.bfloat16), 2)
    _native.check_tensor("resid", resid, (torch.float32,), 2)
    _native.check_tensor("block_idx", block_idx,
                         (torch.int32, torch.int64), 1)
    _check_packed(X2, pack, d_total, gather_block_rows,
                  "fused_backward_gathered")
    n_s = block_idx.shape[0]
    bp = gather_block_rows // pack
    if tuple(resid.shape) != (n_s * bp, pack):
        raise ValueError(f"resid {tuple(resid.shape)} != ({n_s * bp}, "
                         f"{pack}) sampled layout")
    if X2.device.type == "cpu":
        return backward_gathered_reference(
            X2, resid, block_idx, pack=pack, d_total=d_total,
            gather_block_rows=gather_block_rows)
    dev = _native.cuda_device(X2, resid, block_idx)
    _check_tp_kernel(X2, d_total, "fused_backward_gathered")
    rows = n_s * gather_block_rows
    if not 1 <= rows < 2**31:
        raise ValueError(f"fused_backward_gathered: {n_s} blocks of "
                         f"{gather_block_rows} rows; the CUDA kernel takes "
                         f"1 to 2**31 - 1 sampled rows")
    X2 = X2.contiguous()
    ids = block_idx.to(torch.int32).contiguous()
    resid = resid.contiguous()
    plan = tp_kernel_plan(rows, d_total, X2.dtype)
    partial = torch.empty((plan["n_chunks"], d_total), dtype=torch.float32,
                          device=dev)
    out = torch.empty((d_total,), dtype=torch.float32, device=dev)
    lib = _native.load("ssgd")
    rc = lib.tda_ssgd_backward_gathered(
        X2.data_ptr(), _DTYPE_CODE[X2.dtype], ids.data_ptr(), n_s,
        X2.shape[0] * pack // gather_block_rows, gather_block_rows, d_total,
        resid.data_ptr(), plan["chunk"], plan["n_chunks"],
        partial.data_ptr(), out.data_ptr(), dev.index,
        _native.stream(dev))
    _native.check(lib, rc, "fused_backward_gathered")
    fused_backward_gathered.launches += 1
    return out


fused_backward_gathered.launches = 0

#: the kernels of this module, for resetting and reading launch counts
KERNELS = (fused_grad_sum, fused_grad_sum_gathered, fused_train_gathered,
           fused_grad_sum_packed, fused_forward_gathered,
           fused_backward_gathered)
