"""The port's fused matmul+top-k (``tpu_distalg_torch/ops/topk.py``)
against the JAX package's ``ops/pallas_topk.py``.

Inputs are made with numpy from a seed and handed to both packages.
Integer-valued inputs (entries in {-3..3}) make every dot product exact
in float32, so there the two packages must agree bitwise. On random
inputs the libraries sum in different orders, which moves scores in
their last bits (the JAX package's own Pallas kernel and its XLA
reference differ that way), so there the results are held by the
tie-tolerance rule: values within rtol 1e-5 of the largest score, and
indices equal at every rank whose score is farther than that from both
neighbours.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_topk_card import EXACT, PLAN_CASES, exact_case
from tpu_distalg.ops import pallas_topk as pt
from tpu_distalg_torch.ops import topk
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))


def _jax_ref(Q, V, off, nv, k):
    return tuple(np.asarray(x) for x in
                 pt.xla_matmul_topk(Q, V, off, nv, k=k))


def _jax_pallas(Q, V, off, nv, k):
    return tuple(np.asarray(x) for x in pt.fused_matmul_topk(
        jnp.asarray(Q), jnp.asarray(V), off, nv, k=k, block_items=128,
        interpret=True))


def _port(Q, V, off, nv, k):
    v, i = topk.matmul_topk_reference(torch.as_tensor(Q),
                                      torch.as_tensor(V), off, nv, k=k)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("name", EXACT)
def test_reference_equals_jax_on_exact_inputs(name):
    Q, V, off, nv, k = exact_case(name)
    pv, pi = _port(Q, V, off, nv, k)
    for want_v, want_i in (_jax_ref(Q, V, off, nv, k),
                           _jax_pallas(Q, V, off, nv, k)):
        assert np.array_equal(pv, want_v)
        assert np.array_equal(pi, want_i)
    if name == "offset_and_poisoned_tail":
        assert pi.min() >= 1000 and pi.max() < 1000 + 150
    if name == "fewer_valid_than_k":
        assert np.all(pv[:, 4:] == -np.inf)
        assert np.all(pi[:, 4:] == 2**31 - 1)
    if name in ("crafted_ties", "ties_across_blocks"):
        # each score appears at several indices, taken in ascending order
        for row_v, row_i in zip(pv, pi):
            for j in range(k - 1):
                if row_v[j] == row_v[j + 1]:
                    assert row_i[j] < row_i[j + 1]


@pytest.mark.parametrize("b,d,n,k,off,nv", [
    (8, 48, 500, 7, 0, 500),
    (5, 33, 305, 7, 0, 305),
    (32, 64, 2048, 10, 3000, 2000),
])
def test_reference_matches_jax_on_random_inputs(b, d, n, k, off, nv):
    rng = np.random.default_rng(b * 1000 + n)
    Q = rng.normal(size=(b, d)).astype(np.float32)
    V = rng.normal(size=(n, d)).astype(np.float32)
    pv, pi = _port(Q, V, off, nv, k)
    for ref in (_jax_ref(Q, V, off, nv, k + 1),
                _jax_pallas(Q, V, off, nv, k + 1)):
        topk.assert_topk_close(pv, pi, *ref, rtol=1e-5)


@pytest.mark.parametrize("k,n,nv", [(200, 640, 600), (300, 280, 260)])
def test_reference_matches_jax_at_k_over_128(k, n, nv):
    """k past 128, where the kernel's queues hold 256 entries: k 200, and
    k 300 beyond the 260 valid rows, whose tail is (−inf, 2³¹−1)."""
    rng = np.random.default_rng(k)
    Q = rng.normal(size=(6, 24)).astype(np.float32)
    V = rng.normal(size=(n, 24)).astype(np.float32)
    pv, pi = _port(Q, V, 50, nv, k)
    topk.assert_topk_close(pv, pi, *_jax_pallas(Q, V, 50, nv, k + 1),
                           rtol=1e-5)
    if k > nv:
        assert np.all(pv[:, nv:] == -np.inf)
        assert np.all(pi[:, nv:] == 2**31 - 1)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    Q, V, off, nv, k = exact_case("odd_geometry")
    rng = np.random.default_rng(9)
    Q = Q + rng.normal(size=Q.shape).astype(np.float32)
    Qt, Vt = torch.as_tensor(Q), torch.as_tensor(V)
    before = topk.fused_matmul_topk.launches
    gv, gi = topk.fused_matmul_topk(Qt, Vt, off, nv, k=k)
    rv, ri = topk.matmul_topk_reference(Qt, Vt, off, nv, k=k)
    assert torch.equal(gv, rv) and torch.equal(gi, ri)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    assert topk.fused_matmul_topk.launches == before


@pytest.mark.parametrize("bad", [
    "float64", "non_contiguous", "k_zero", "offset_underflows",
    "dims_differ",
    "block_items_not_tile_multiple", "offset_overflows",
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rng = np.random.default_rng(3)
    Q = torch.as_tensor(rng.normal(size=(4, 16)).astype(np.float32))
    V = torch.as_tensor(rng.normal(size=(300, 16)).astype(np.float32))
    kw = {"k": 5}
    off = 0
    if bad == "float64":
        Q = Q.double()
    elif bad == "non_contiguous":
        V = torch.as_tensor(rng.normal(size=(16, 300)).astype(
            np.float32)).T
    elif bad == "k_zero":
        kw["k"] = 0
    elif bad == "offset_underflows":
        off = -2**31 - 1
    elif bad == "dims_differ":
        V = V[:, :15].contiguous()
    elif bad == "block_items_not_tile_multiple":
        kw["block_items"] = 100
    else:
        off = 2**31 - 100
    with pytest.raises(ValueError):
        topk.fused_matmul_topk(Q, V, off, 300, **kw)


def test_tie_tolerance_rule_holds_separated_ranks_only():
    rng = np.random.default_rng(4)
    Q = torch.as_tensor(rng.normal(size=(6, 16)).astype(np.float32))
    V = torch.as_tensor(rng.normal(size=(400, 16)).astype(np.float32))
    V[7] = V[3]  # an exact tie: either order of 3 and 7 passes
    rv, ri = topk.matmul_topk_reference(Q, V, 0, 400, k=9)
    v, i = rv[:, :8].clone(), ri[:, :8].clone()
    topk.assert_topk_close(v, i, rv, ri)
    swapped = i.clone()
    for r in range(i.shape[0]):
        row = swapped[r].tolist()
        if 3 in row and 7 in row:
            a, b = row.index(3), row.index(7)
            swapped[r, a], swapped[r, b] = 7, 3
    topk.assert_topk_close(v, swapped, rv, ri)
    wrong = i.clone()
    wrong[0, 0] = wrong[0, 5]
    with pytest.raises(AssertionError, match="index"):
        topk.assert_topk_close(v, wrong, rv, ri)
    off = v.clone()
    off[1, 1] += 1e-2
    with pytest.raises(AssertionError, match="value"):
        topk.assert_topk_close(off, i, rv, ri)


#: the SM count of an H100 SXM, for the plans the card will run
H100_SMS = 132


@pytest.mark.parametrize("B,N,k,block_items,n_sm", PLAN_CASES)
def test_topk_plan_covers_every_item_once(B, N, k, block_items, n_sm):
    """Every item falls in exactly one block's range and every query in
    one query tile; ranges are multiples of 128 (``block_items`` when
    given, else at least 4·k and a sub-tile); nothing in the plan comes
    from anything but the shapes and the SM count. (The kernel lays out
    its shared memory and workspace itself: ``test_torch_topk_card.py``
    holds those to 227 KB.)"""
    plan = topk.topk_plan(B, N, k, block_items, n_sm)
    r, nr, qt, nq = (plan["range_items"], plan["n_ranges"],
                     plan["queries"], plan["q_tiles"])
    assert r % topk.TILE_ITEMS == 0
    assert (nr - 1) * r < N <= nr * r
    assert (nq - 1) * qt < B <= nq * qt
    assert plan["blocks"] == nq * nr
    if block_items is not None:
        assert r == block_items
    else:
        assert r >= min(4 * k, N) and r >= min(plan["sub_items"], N)
    assert qt == topk.TILE_QUERIES[plan["shape"]]
    assert plan["sub_items"] == topk.SUB_TILE_ITEMS[plan["shape"]]
    assert plan["shape"] == 1 or k <= topk.SHAPE_A_MAX_K
    assert plan == topk.topk_plan.__wrapped__(B, N, k, block_items, n_sm)


def test_topk_plan_shapes_follow_the_work():
    """Shape A (32 queries a block) where the card has work for every SM
    at four sub-tiles a block; shape B (8 queries) at the serving shape,
    where 128 blocks of one A sub-tile would leave a long merge."""
    assert topk.topk_plan(32, 1 << 20, 10, None, H100_SMS)["shape"] == 0
    serving = topk.topk_plan(32, 16384, 10, None, H100_SMS)
    assert serving["shape"] == 1 and serving["blocks"] <= H100_SMS
    assert topk.topk_plan(32, 1 << 20, 65, None, H100_SMS)["shape"] == 1


def test_workspace_cache_grows_and_keeps_tags_apart():
    """The kernels' shared workspace cache: one tensor a (tag, device,
    stream), zeros when new, kept while it is large enough, replaced by
    a larger one of zeros when a launch needs more."""
    from tpu_distalg_torch.ops import _native

    dev = torch.device("cpu")
    keys = [(tag, None, s) for tag in ("t state", "t lists") for s in (7, 8)]
    try:
        a = _native.workspace("t state", dev, 7, 10, torch.int32)
        assert a.numel() == 10 and not a.any()
        a[3] = 5
        assert _native.workspace("t state", dev, 7, 4, torch.int32) is a
        assert _native.workspace("t lists", dev, 7, 4, torch.int32) is not a
        assert _native.workspace("t state", dev, 8, 4, torch.int32) is not a
        c = _native.workspace("t state", dev, 7, 11, torch.int32)
        assert c.numel() == 11 and not c.any()
    finally:
        for key in keys:
            _native._WORKSPACES.pop(key, None)
