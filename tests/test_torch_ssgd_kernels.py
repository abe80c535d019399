"""The port's SSGD kernels (``tpu_distalg_torch/ops/ssgd_kernels.py``)
against the JAX package's Pallas kernels in interpret mode
(``tpu_distalg/ops/pallas_kernels.py``), on the CPU.

On the CPU each wrapper runs its plain PyTorch version, which keeps the
kernel's rounding points: z sums x·w with w cast to X's dtype, B1/B2
round the residual to X's dtype (B6 keeps it float32), and sums are
float32. The two packages add in different orders, so gradients are
held to rtol 1e-5 of the largest entry (float32 and bfloat16 storage
alike: the products of bf16 values are exact in float32, so only the
summation order differs; a residual that lands on a bf16 rounding
boundary could flip one ulp, which the tolerance absorbs). Counts are
integers and must be equal. ``pack_augmented`` must equal JAX's bit for
bit (bfloat16 compared as uint16).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_distalg.ops import pallas_kernels as pk
from tpu_distalg_torch.ops import ssgd_kernels as tk
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bits(x) -> np.ndarray:
    """Raw bits of a float32 or bfloat16 array (JAX or torch)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def _packed(n, d, dtype, pack, gbr, seed, shuffle_seed=None):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    X2j, meta = pk.pack_augmented(X, y, np.ones(n, np.float32), dtype=jdt,
                                  pack=pack, block_rows=gbr,
                                  shuffle_seed=shuffle_seed)
    X2t, meta_t = tk.pack_augmented(X, y, np.ones(n, np.float32),
                                    dtype=tdt, pack=pack, block_rows=gbr,
                                    shuffle_seed=shuffle_seed, device="cpu")
    assert meta_t == meta
    w = np.zeros(meta["d_total"], np.float32)
    w[:d] = rng.normal(size=d).astype(np.float32) * 0.1
    kw = dict(pack=pack, d_total=meta["d_total"], y_col=meta["y_col"],
              v_col=meta["v_col"], gather_block_rows=gbr)
    return X2j, X2t, meta, w, kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,pack,gbr,shuffle", [
    (300, 13, 16, 128, None), (398, 31, 4, 32, 0), (1000, 125, 16, 512, 3),
    (77, 5, 1, 16, None)])
def test_pack_augmented_equals_jax(dtype, n, d, pack, gbr, shuffle):
    X2j, X2t, meta, _, _ = _packed(n, d, dtype, pack, gbr, seed=n,
                                   shuffle_seed=shuffle)
    assert tuple(X2t.shape) == X2j.shape
    assert X2t.dtype == DTYPES[dtype][0]
    np.testing.assert_array_equal(_bits(X2t), _bits(X2j))
    assert tk.packed_dims(d + 0, pack) == pk.packed_dims(d, pack)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(1000, 129), (777, 61), (256, 32)])
def test_fused_grad_sum_b6_matches_jax(dtype, n, d):
    """B6 with unaligned n and d (the JAX kernel pads both)."""
    rng = np.random.default_rng(d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    w = (rng.normal(size=d) * 0.1).astype(np.float32)
    mask = (rng.random(n) < 0.3).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    gj, cj = pk.fused_grad_sum(jnp.asarray(X, jdt), jnp.asarray(y),
                               jnp.asarray(mask), jnp.asarray(w),
                               block_rows=256, interpret=True)
    gt, ct = tk.fused_grad_sum(torch.as_tensor(X).to(tdt),
                               torch.as_tensor(y), torch.as_tensor(mask),
                               torch.as_tensor(w))
    assert gt.shape == (d,) and gt.dtype == torch.float32
    assert float(ct) == float(cj) == float(mask.sum())
    _close(gt, gj)


def test_fused_grad_sum_b6_zero_mask():
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.normal(size=(256, 32)).astype(np.float32))
    g, c = tk.fused_grad_sum(X, torch.ones(256), torch.zeros(256),
                             torch.zeros(32))
    assert float(c) == 0.0 and float(g.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks", [[0, 2, 3], [1, 1, 3, 1], [3]])
def test_fused_grad_sum_gathered_b1_matches_jax(dtype, blocks):
    """B1, repeated block ids included (each repeat counts)."""
    X2j, X2t, meta, w, kw = _packed(400, 30, dtype, 16, 128, seed=6)
    ids = np.asarray(blocks, np.int32)
    gj, cj = pk.fused_grad_sum_gathered(X2j, jnp.asarray(w),
                                        jnp.asarray(ids), interpret=True,
                                        **kw)
    gt, ct = tk.fused_grad_sum_gathered(X2t, torch.as_tensor(w),
                                        torch.as_tensor(ids), **kw)
    yc = meta["y_col"]
    assert float(ct) == float(cj)
    # rows past n_padded's valid rows (block 3 holds rows 384..511 of
    # which 16 are real) count only through the validity column
    assert float(ct) == sum(min(128, max(0, 400 - 128 * b))
                            for b in blocks)
    _close(gt[:yc], np.asarray(gj)[:yc])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha,skip", [(0.0, False), (0.3, False),
                                        (0.0, True)])
def test_fused_train_gathered_b2_matches_jax(dtype, alpha, skip):
    """B2: T steps with and without the EASGD pull, and skip_update
    (the gradient passes run, the weights stay w0)."""
    X2j, X2t, meta, w, kw = _packed(400, 30, dtype, 16, 128, seed=8)
    P, D = meta["pack"], meta["d_total"]
    rng = np.random.default_rng(9)
    idx = np.stack([rng.permutation(4)[:2] for _ in range(7)]).astype(
        np.int32)
    ctr = np.zeros(D, np.float32)
    ctr[:30] = rng.normal(size=30).astype(np.float32) * 0.1
    wj = pk.fused_train_gathered(
        X2j, jnp.tile(jnp.asarray(w), P)[:, None], jnp.asarray(idx),
        eta=0.1, alpha=alpha, center_tile=jnp.tile(jnp.asarray(ctr),
                                                   P)[:, None],
        interpret=True, skip_update=skip, **kw)
    wt = tk.fused_train_gathered(X2t, torch.as_tensor(w),
                                 torch.as_tensor(idx), eta=0.1, alpha=alpha,
                                 center=torch.as_tensor(ctr),
                                 skip_update=skip, **kw)
    assert wt.shape == (D,) and wt.dtype == torch.float32
    if skip:
        np.testing.assert_array_equal(wt.numpy(), w)
    _close(wt, np.asarray(wj)[:D, 0])


@pytest.mark.parametrize("kernel", ["B1", "B2"])
def test_wide_rows_b1_b2_match_jax(kernel):
    """Rows over 2048 bytes, which the CUDA kernels take through their
    wide body: bf16 d_total 1152."""
    X2j, X2t, meta, w, kw = _packed(256, 1150, "bfloat16", 4, 64, seed=12)
    assert meta["d_total"] == 1152
    yc, P, D = meta["y_col"], meta["pack"], meta["d_total"]
    if kernel == "B1":
        ids = np.asarray([0, 3, 3], np.int32)
        gj, cj = pk.fused_grad_sum_gathered(X2j, jnp.asarray(w),
                                            jnp.asarray(ids), interpret=True,
                                            **kw)
        gt, ct = tk.fused_grad_sum_gathered(X2t, torch.as_tensor(w),
                                            torch.as_tensor(ids), **kw)
        assert float(ct) == float(cj)
        _close(gt[:yc], np.asarray(gj)[:yc])
        return
    idx = np.asarray([[0, 1], [2, 3], [1, 1]], np.int32)
    wj = pk.fused_train_gathered(X2j, jnp.tile(jnp.asarray(w), P)[:, None],
                                 jnp.asarray(idx), eta=0.1, interpret=True,
                                 **kw)
    wt = tk.fused_train_gathered(X2t, torch.as_tensor(w),
                                 torch.as_tensor(idx), eta=0.1, **kw)
    _close(wt, np.asarray(wj)[:D, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_grad_sum_b6_wide_matches_jax(dtype):
    """B6 past d 4096, which the CUDA kernel takes in two passes."""
    rng = np.random.default_rng(4224)
    n, d = 300, 4224
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    w = (rng.normal(size=d) * 0.02).astype(np.float32)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    gj, cj = pk.fused_grad_sum(jnp.asarray(X, jdt), jnp.asarray(y),
                               jnp.asarray(mask), jnp.asarray(w),
                               block_rows=128, interpret=True)
    gt, ct = tk.fused_grad_sum(torch.as_tensor(X).to(tdt),
                               torch.as_tensor(y), torch.as_tensor(mask),
                               torch.as_tensor(w))
    assert float(ct) == float(cj)
    _close(gt, gj)


def test_fused_train_equals_fused_grad_sum_steps():
    """Within the port: B2's T steps are T steps of B1 followed by the
    update, bit for bit on the CPU (one plain implementation)."""
    _, X2t, meta, w, kw = _packed(400, 30, "bfloat16", 16, 128, seed=10)
    idx = torch.tensor([[0, 3], [2, 2], [1, 0]], dtype=torch.int32)
    keep = torch.arange(meta["d_total"]) < meta["y_col"]
    wt = torch.as_tensor(w)
    for ids in idx:
        g, c = tk.fused_grad_sum_gathered(
            X2t, torch.where(keep, wt, 0.0), ids, **kw)
        wt = wt - (torch.tensor(0.1) / torch.clamp_min(c, 1.0)) * \
            torch.where(keep, g, 0.0)
    got = tk.fused_train_gathered(X2t, torch.as_tensor(w), idx, eta=0.1,
                                  **kw)
    np.testing.assert_array_equal(got.numpy(), wt.numpy())


def test_wrappers_validate_like_jax():
    _, X2t, meta, w, kw = _packed(400, 30, "float32", 16, 128, seed=11)
    ids = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="incompatible"):
        tk.fused_grad_sum_gathered(X2t, torch.as_tensor(w), ids,
                                   **{**kw, "d_total": meta["d_total"] + 8})
    with pytest.raises(ValueError, match="incompatible"):
        tk.fused_train_gathered(X2t, torch.as_tensor(w), ids[None],
                                eta=0.1, **{**kw, "gather_block_rows": 100})
    with pytest.raises(ValueError, match="float32"):
        tk.fused_grad_sum(torch.zeros(4, 3, dtype=torch.float64),
                          torch.zeros(4), torch.zeros(4), torch.zeros(3))
    with pytest.raises(ValueError, match="disagree"):
        tk.fused_grad_sum(torch.zeros(4, 3), torch.zeros(5), torch.zeros(4),
                          torch.zeros(3))
    with pytest.raises(ValueError, match="unsupported dtype"):
        tk.as_dtype("float16")


#: B1/B2 at the edges of the CUDA kernels' ring (n, d, pack, gbr, n_s, T):
#: 21 sampled blocks of 32 rows at T = 1; 16-row blocks, so a CUDA block's
#: rows and its stages cross many sampled blocks. Each step draws one
#: block twice.
RING_EDGES = [(700, 30, 4, 32, 21, 1), (1000, 61, 2, 16, 50, 3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,pack,gbr,n_s,T", RING_EDGES)
def test_b1_b2_ring_edges_match_jax(n, d, pack, gbr, n_s, T, dtype):
    X2j, X2t, meta, w, kw = _packed(n, d, dtype, pack, gbr, seed=n_s)
    P, D, yc = meta["pack"], meta["d_total"], meta["y_col"]
    rng = np.random.default_rng(T)
    idx = rng.integers(0, meta["n_padded"] // gbr, (T, n_s))
    idx[:, -1] = idx[:, 0]
    idx = idx.astype(np.int32)
    gj, cj = pk.fused_grad_sum_gathered(X2j, jnp.asarray(w),
                                        jnp.asarray(idx[0]), interpret=True,
                                        **kw)
    gt, ct = tk.fused_grad_sum_gathered(X2t, torch.as_tensor(w),
                                        torch.as_tensor(idx[0]), **kw)
    assert float(ct) == float(cj)
    _close(gt[:yc], np.asarray(gj)[:yc])
    wj = pk.fused_train_gathered(X2j, jnp.tile(jnp.asarray(w), P)[:, None],
                                 jnp.asarray(idx), eta=0.1, interpret=True,
                                 **kw)
    wt = tk.fused_train_gathered(X2t, torch.as_tensor(w),
                                 torch.as_tensor(idx), eta=0.1, **kw)
    _close(wt, np.asarray(wj)[:D, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rows,d_total,n_sm", [
    (106496, 128, 132), (106496, 128, 114), (672, 32, 132), (800, 64, 132),
    (31, 8, 132), (5000, 1024, 132), (8192 * 64, 408, 132), (20000, 24, 7),
    (65536, 8200, 132), (39936, 2008, 132), (1024, 16400, 132)])
def test_gathered_plan_covers_every_row_once(n_rows, d_total, dtype, n_sm):
    """B1/B2's plan: the row's width alone picks the body (the ring up
    to 2048 bytes, the wide ring up to 2048 vectors, then the wide
    body); on either ring every sampled row falls in exactly one (block,
    stage), stages are whole rows of whole 16-byte vectors, at least two
    slots and the ring fit the 227 KB of shared memory, and there is at
    most one block per SM; the same shapes and SM count give the same
    plan (nothing else enters it)."""
    size = tk.as_dtype(dtype).itemsize
    if (d_total * size) % 16:
        with pytest.raises(ValueError, match="16-byte"):
            tk.gathered_plan(n_rows, d_total, dtype, n_sm)
        return
    plan = tk.gathered_plan(n_rows, d_total, dtype, n_sm)
    assert plan == tk.gathered_plan.__wrapped__(n_rows, d_total,
                                                tk.as_dtype(dtype), n_sm)
    row_bytes = d_total * size
    wp = (d_total + 4) // 4 * 4
    if row_bytes // 16 > tk.WIDE_MAX_VECTORS:
        assert plan["body"] == "wide" and plan["blocks"] == 4 * n_sm
        return
    assert 1 <= plan["blocks"] <= n_sm
    sr = plan["stage_rows"]
    assert plan["stage_bytes"] == sr * row_bytes and plan["stage_bytes"] % 16 == 0
    assert 1 <= sr <= tk.RING_MAX_STAGE_ROWS
    assert 2 <= plan["stages"] <= tk.RING_MAX_STAGES
    assert plan["smem"] <= tk.SMEM_MAX
    if row_bytes > tk.MAX_RING_ROW_BYTES:
        assert plan["body"] == "wide_ring"
        # whole rows of about 16 KB a stage (one row past 16 KB), at most
        # one a consumer warp; the partial's vectors in registers
        assert sr == max(1, tk.RING_STAGE_BYTES // row_bytes)
        assert sr <= tk.RING_WARPS
        assert 1 <= plan["owned"] <= tk.WIDE_MAX_KV
        assert plan["owned"] * tk.RING_WARPS * 32 >= plan["vectors"]
        assert plan["smem"] == tk._wide_smem(
            d_total, row_bytes, plan["stage_bytes"], plan["stages"])
        assert (plan["stages"] == tk.RING_MAX_STAGES
                or tk._wide_smem(d_total, row_bytes, plan["stage_bytes"],
                                 plan["stages"] + 1) > tk.SMEM_MAX)
        floats = tk.WORK_COUNTERS + (2 * plan["blocks"] + 1) * wp
    else:
        assert plan["body"] == "ring"
        assert sr % plan["pass_rows"] == 0
        assert plan["lanes"] * plan["vpl"] >= plan["vectors"]
        floats = tk.WORK_COUNTERS + 2 * plan["blocks"] * wp
    seen = np.zeros(n_rows, np.int64)
    for b in range(plan["blocks"]):
        r0 = b * plan["chunk"]
        r1 = min(r0 + plan["chunk"], n_rows)
        assert r0 < r1
        for i0 in range(r0, r1, sr):
            seen[i0:min(i0 + sr, r1)] += 1
    assert (seen == 1).all()
    assert plan["workspace"] == floats
