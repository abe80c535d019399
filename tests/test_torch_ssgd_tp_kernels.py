"""Kernels B3 and B4 of the port (``ops/ssgd_kernels.py``
``fused_forward_gathered`` / ``fused_backward_gathered``) and the dp×tp
layout (``models/ssgd.py`` ``prepare_fused_tp``,
``tp_augment_test_matrix``, ``tp_extract_weights``) against the JAX
package on the CPU, its Pallas kernels in interpret mode.

On the CPU each wrapper runs its plain PyTorch version. "exact" inputs
have integer entries in {-3..3} and integer weights and residuals, so
every sum is exact in float32 whatever its order: outputs must be equal
bit for bit. "random" inputs are normal; the two packages add in other
orders, so they are held to rtol 1e-6 plus an atol of 2e-6 of the
largest entry (measured: at most 3e-7 of it; B4 adds up to 512 products
a column). The layout must equal JAX's exactly, through
``convert.ssgd_tp_params_from_jax``.
"""

from __future__ import annotations

import os
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ssgd_tp_card import B3_EDGES, b3_edge_case
from tpu_distalg.models import ssgd as jssgd
from tpu_distalg.ops import pallas_kernels as pk
from tpu_distalg_torch import convert
from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.ops import ssgd_kernels as tk
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (pack, gather_block_rows, features): D = 32 and D = 80
GEOMETRIES = [(4, 64, 30), (16, 128, 70)]
BLOCKS = [[0, 2, 3], [1, 1, 3, 1], [2]]


def _case(dtype, pack, gbr, d, kind, seed=5, n=500):
    rng = np.random.default_rng(seed)
    if kind == "exact":
        X = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    else:
        X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    X2j, meta = pk.pack_augmented(X, y, np.ones(n, np.float32), dtype=jdt,
                                  pack=pack, block_rows=gbr)
    X2t, _ = tk.pack_augmented(X, y, np.ones(n, np.float32), dtype=tdt,
                               pack=pack, block_rows=gbr, device="cpu")
    w = np.zeros(meta["d_total"], np.float32)
    w[:d] = (rng.integers(-3, 4, size=d) if kind == "exact"
             else rng.normal(size=d) * 0.1)
    kw = dict(pack=pack, d_total=meta["d_total"], y_col=meta["y_col"],
              v_col=meta["v_col"], gather_block_rows=gbr)
    return rng, X2j, X2t, w, kw


def _hold(got, want, kind):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if kind == "exact":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=2e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("blocks", BLOCKS, ids=["distinct", "repeats",
                                                "one"])
@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["pack4", "pack16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_b3_matches_jax(dtype, geometry, kind, blocks):
    """zyv = [z | y | v] per packed slot, in JAX's (n_s·bp, 3P) layout;
    a repeated block appears each time."""
    pack, gbr, d = geometry
    _, X2j, X2t, w, kw = _case(dtype, pack, gbr, d, kind)
    ids = np.asarray(blocks, np.int32)
    want = pk.fused_forward_gathered(X2j, jnp.asarray(w), jnp.asarray(ids),
                                     interpret=True, **kw)
    got = tk.fused_forward_gathered(X2t, torch.as_tensor(w),
                                    torch.as_tensor(ids), **kw)
    assert tuple(got.shape) == (len(blocks) * gbr // pack, 3 * pack)
    _hold(got.numpy(), want, kind)


@pytest.mark.parametrize("blocks", BLOCKS, ids=["distinct", "repeats",
                                                "one"])
@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["pack4", "pack16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_b4_matches_jax(dtype, geometry, kind, blocks):
    """g = Σ bf16(resid)·x over the sampled rows, resid in sampled order
    (JAX casts it to X's dtype inside the kernel)."""
    pack, gbr, d = geometry
    rng, X2j, X2t, _, kw = _case(dtype, pack, gbr, d, kind, seed=9)
    ids = np.asarray(blocks, np.int32)
    shape = (len(blocks) * gbr // pack, pack)
    resid = (rng.integers(-3, 4, size=shape) if kind == "exact"
             else rng.normal(size=shape)).astype(np.float32)
    bkw = dict(pack=pack, d_total=kw["d_total"], gather_block_rows=gbr)
    want = pk.fused_backward_gathered(X2j, jnp.asarray(resid),
                                      jnp.asarray(ids), interpret=True,
                                      **bkw)
    got = tk.fused_backward_gathered(X2t, torch.as_tensor(resid),
                                     torch.as_tensor(ids), **bkw)
    _hold(got.numpy(), want, kind)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b3_then_b4_is_b1(dtype):
    """The split is B1: B3's z, the residual, then B4, gives B1's
    gradient and count on the same blocks."""
    pack, gbr, d = 16, 128, 70
    _, _, X2t, w, kw = _case(dtype, pack, gbr, d, "random", seed=2)
    ids = torch.tensor([3, 0, 0], dtype=torch.int32)
    wt = torch.as_tensor(w)
    zyv = tk.fused_forward_gathered(X2t, wt, ids, **kw)
    z, y, v = zyv[:, :pack], zyv[:, pack:2 * pack], zyv[:, 2 * pack:]
    g = tk.fused_backward_gathered(
        X2t, (torch.sigmoid(z) - y) * v, ids, pack=pack,
        d_total=kw["d_total"], gather_block_rows=gbr)
    g1, c1 = tk.fused_grad_sum_gathered(X2t, wt, ids, **kw)
    yc = kw["y_col"]
    np.testing.assert_allclose(g[:yc].numpy(), g1[:yc].numpy(), rtol=0,
                               atol=1e-6 * float(g1[:yc].abs().max()))
    assert float(v.sum()) == float(c1)


#: the SM count of an H100 SXM, for the plans the card will run
H100_SMS = 132


@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", B3_EDGES,
                         ids=[f"D{c[1] + 2}-p{c[2]}-gbr{c[3]}"
                              for c in B3_EDGES])
def test_b3_ring_edges_match_jax(case, dtype, kind):
    """The card tests' B3 edge shapes (a block's chunk of rows crosses
    sampled-block boundaries on an H100) through the plain version
    against JAX's kernel, a repeated block included; JAX's kernel takes
    only ids in [0, n_blocks), so the out-of-range ids are left out."""
    X2t, w, ids, kw, _ = b3_edge_case(case, dtype, kind, "cpu")
    ids = ids[:-2]
    plan = tk.forward_plan(ids.shape[0] * kw["gather_block_rows"],
                           kw["d_total"], X2t.dtype, kw["pack"], H100_SMS)
    assert plan["ring"] and plan["chunk"] % kw["gather_block_rows"]
    X2j = jnp.asarray(X2t.float().numpy()).astype(DTYPES[dtype][1])
    want = pk.fused_forward_gathered(X2j, jnp.asarray(w.numpy()),
                                     jnp.asarray(ids.numpy()),
                                     interpret=True, **kw)
    got = tk.fused_forward_gathered(X2t, w, ids, **kw)
    _hold(got.numpy(), want, kind)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b3_edges_leave_stages_part_full(dtype):
    """In most edge shapes a block's chunk is not a multiple of a stage,
    so its last stage is part-full."""
    part = 0
    for case in B3_EDGES:
        X2, _, ids, kw, _ = b3_edge_case(case, dtype, "exact", "cpu")
        plan = tk.forward_plan((ids.shape[0] - 2) * kw["gather_block_rows"],
                               kw["d_total"], X2.dtype, kw["pack"], H100_SMS)
        part += plan["chunk"] % plan["stage_rows"] != 0
    assert part >= len(B3_EDGES) - 1


@pytest.mark.parametrize("n_rows,d_total,dtype,pack,n_sm", [
    (106_496, 128, "bfloat16", 16, 132),    # main geometry at 1×1
    (106_496, 72, "bfloat16", 16, 132),     # 1×2: 9 vectors a row
    (106_496, 128, "bfloat16", 16, 114),    # another card
    (64, 32, "float32", 4, 132),            # breast cancer at pack 4
    (1280, 32, "float32", 4, 132),          # chunk shorter than a stage
    (3200, 512, "float32", 4, 132),         # 2048-byte rows: the widest
    (2310, 128, "bfloat16", 1, 132),        # pack 1
    (7 * 48, 128, "bfloat16", 48, 8),       # pack 48: stages of lcm(64, 48)
])
def test_forward_plan_covers_every_row_once(n_rows, d_total, dtype, pack,
                                            n_sm):
    """B3's ring plan: every sampled row falls in exactly one block, a
    block's chunk and a stage are multiples of pack (one block writes
    each packed zyv row) and of 4 (16-byte stores), a stage is a
    multiple of a consumer pass and at most 1024 rows, at most one block
    an SM, the shared memory fits 227 KB, and nothing in the plan comes
    from anything but the shapes and the SM count."""
    plan = tk.forward_plan(n_rows, d_total, dtype, pack, n_sm)
    assert plan["ring"]
    chunk, stage, blocks = plan["chunk"], plan["stage_rows"], plan["blocks"]
    assert (blocks - 1) * chunk < n_rows <= blocks * chunk <= n_rows + chunk
    assert blocks <= n_sm
    assert chunk % pack == 0 and chunk % 4 == 0
    assert stage % pack == 0 and stage % 4 == 0 and stage <= 1024
    assert stage % (tk.RING_WARPS * (32 // plan["lanes"])) == 0
    assert plan["lanes"] * plan["vpl"] >= plan["vectors"]
    assert 2 <= plan["stages"] <= tk.RING_MAX_STAGES
    assert plan["smem"] <= tk.SMEM_MAX
    assert plan == tk.forward_plan.__wrapped__(n_rows, d_total, dtype, pack,
                                               n_sm)


@pytest.mark.parametrize("n_rows,d_total,dtype,pack", [
    (32_768, 4104, "bfloat16", 16),   # wide 2×2: 8208-byte rows
    (4096, 1024, "float32", 4),       # 4096-byte rows
    (2000, 128, "bfloat16", 1000),    # no stage of at most 1024 rows
])
def test_forward_plan_takes_the_wide_body_past_the_ring(n_rows, d_total,
                                                        dtype, pack):
    """Rows over 2048 bytes, or a pack no stage holds, keep the wide body
    on tp_kernel_plan's grid."""
    plan = tk.forward_plan(n_rows, d_total, dtype, pack, 132)
    assert not plan["ring"] and plan["stage_rows"] == 0
    assert plan["blocks"] == tk.tp_kernel_plan(n_rows, d_total,
                                               dtype)["fwd_blocks"]


def test_b3_b4_wrappers_validate_like_jax():
    """The JAX package's shape errors (its TPU tiling rule, a multiple
    of 8 packed rows a block, is not part of the contract)."""
    X2 = torch.zeros((16, 4 * 32))
    w = torch.zeros(32)
    ids = torch.zeros(2, dtype=torch.int32)
    kw = dict(pack=4, d_total=32, y_col=30, v_col=31)
    with pytest.raises(ValueError, match="incompatible"):
        tk.fused_forward_gathered(X2, w, ids, gather_block_rows=6, **kw)
    with pytest.raises(ValueError, match="incompatible"):
        tk.fused_backward_gathered(X2, torch.zeros((8, 4)), ids, pack=4,
                                   d_total=30, gather_block_rows=16)
    with pytest.raises(ValueError, match="sampled layout"):
        tk.fused_backward_gathered(X2, torch.zeros((7, 4)), ids, pack=4,
                                   d_total=32, gather_block_rows=16)
    with pytest.raises(ValueError, match="w_aug"):
        tk.fused_forward_gathered(X2, torch.zeros(31), ids,
                                  gather_block_rows=16, **kw)
    with pytest.raises(ValueError, match="y_col"):
        tk.fused_forward_gathered(X2, w, ids, gather_block_rows=16,
                                  pack=4, d_total=32, y_col=32, v_col=31)
    with pytest.raises(ValueError, match="float32"):
        tk.fused_backward_gathered(X2, torch.zeros((8, 4),
                                                   dtype=torch.float64),
                                   ids, pack=4, d_total=32,
                                   gather_block_rows=16)


@pytest.mark.parametrize("n_rows,d_total,dtype,lanes,tiles", [
    (106_496, 128, "bfloat16", 16, 1),      # main geometry at 1×1
    (106_496, 72, "bfloat16", 16, 1),       # 1×2: 9 vectors a row
    (32_768, 4104, "bfloat16", 32, 17),     # wide 2×2: 513 vectors
    (32_768, 8200, "bfloat16", 32, 33),     # wide 2×1
    (64, 32, "float32", 8, 1),              # breast cancer at pack 4
    (5, 4, "float32", 1, 1),
])
def test_tp_kernel_plan_from_the_shapes(n_rows, d_total, dtype, lanes,
                                        tiles):
    """B4's chunks cover the rows exactly once, in whole block passes,
    for about TP_TARGET_BLOCKS blocks; nothing in the plan comes from
    the card."""
    plan = tk.tp_kernel_plan(n_rows, d_total, dtype)
    assert plan["lanes"] == lanes and plan["tiles"] == tiles
    pass_rows = tk.TP_WARPS * (32 // lanes) * tk.TP_ROWS_IN_FLIGHT
    assert plan["chunk"] % pass_rows == 0
    assert plan["chunk"] * (plan["n_chunks"] - 1) < n_rows \
        <= plan["chunk"] * plan["n_chunks"]
    assert plan["n_chunks"] * tiles <= max(tk.TP_TARGET_BLOCKS, tiles)
    assert 1 <= plan["fwd_blocks"] <= tk.TP_MAX_FWD_BLOCKS
    assert plan == tk.tp_kernel_plan(n_rows, d_total, dtype)


def test_tp_kernel_plan_refuses_partial_vectors():
    with pytest.raises(ValueError, match="16-byte"):
        tk.tp_kernel_plan(64, 3, "float32")


@pytest.fixture(scope="module")
def data():
    return datasets.breast_cancer_split()


@pytest.mark.parametrize("mesh_shape,x_dtype,pack", [
    ((2, 4), "float32", 4), ((2, 4), "bfloat16", 16), ((1, 2), "float32", 4),
], ids=["2x4-f32", "2x4-bf16", "1x2-f32"])
def test_prepare_fused_tp_layout_equals_jax(data, mesh_shape, x_dtype,
                                            pack):
    """Slices, w0 and meta equal JAX's ``prepare_fused_tp`` exactly (X2
    through ``convert``, both ways), and so do
    ``tp_augment_test_matrix`` and ``tp_extract_weights``."""
    import jax

    from tpu_distalg.parallel import get_mesh as jget_mesh

    n_data, n_model = mesh_shape
    cfg = ssgd.SSGDConfig(n_iterations=5, sampler="fused_gather",
                          fused_pack=pack, gather_block_rows=32,
                          shuffle_seed=0, feature_sharded=True,
                          x_dtype=x_dtype)
    jmesh = jget_mesh(data=n_data, model=n_model,
                      devices=jax.devices()[:n_data * n_model])
    _, X2j, w0j, meta_j = jssgd.prepare_fused_tp(
        data[0], data[1], jmesh, jssgd.SSGDConfig(**dataclasses.asdict(cfg)))
    _, X2t, w0t, meta = ssgd.prepare_fused_tp(
        data[0], data[1], get_mesh(n_data, n_model, device="cpu"), cfg)
    assert meta == meta_j
    assert X2t.shape == (n_model, X2j.shape[0], X2j.shape[1] // n_model)
    w_c, X2_c = convert.ssgd_tp_params_from_jax(np.asarray(w0j),
                                                np.asarray(X2j), meta_j,
                                                device="cpu")
    assert X2_c.dtype == X2t.dtype
    assert torch.equal(X2_c.view(torch.int16 if x_dtype == "bfloat16"
                                 else torch.int32),
                       X2t.view(torch.int16 if x_dtype == "bfloat16"
                                else torch.int32))
    assert torch.equal(w_c, w0t)
    w_back, X2_back = convert.ssgd_tp_params_to_jax(w0t, X2t, meta)
    np.testing.assert_array_equal(w_back, np.asarray(w0j))
    np.testing.assert_array_equal(
        X2_back, np.asarray(X2j).view(np.uint16) if x_dtype == "bfloat16"
        else np.asarray(X2j))
    Xte_j = np.asarray(jssgd.tp_augment_test_matrix(data[2], meta_j))
    np.testing.assert_array_equal(
        ssgd.tp_augment_test_matrix(data[2], meta, device="cpu").numpy(),
        Xte_j)
    w_rand = np.random.default_rng(1).normal(
        size=w0t.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(
        ssgd.tp_extract_weights(torch.as_tensor(w_rand), meta).numpy(),
        np.asarray(jssgd.tp_extract_weights(jnp.asarray(w_rand), meta_j)))


def test_convert_refuses_a_foreign_layout():
    meta = dict(n_model=2, d_total=32, pack=4)
    with pytest.raises(ValueError, match="want"):
        convert.ssgd_tp_params_from_jax(np.zeros(63, np.float32),
                                        np.zeros((4, 256), np.float32),
                                        meta, device="cpu")
    with pytest.raises(ValueError, match="want"):
        convert.ssgd_tp_params_from_jax(np.zeros(64, np.float32),
                                        np.zeros((4, 255), np.float32),
                                        meta, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        convert.ssgd_tp_params_to_jax(torch.zeros(64),
                                      torch.zeros((3, 4, 128)), meta)
