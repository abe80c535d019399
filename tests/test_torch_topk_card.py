"""The fused matmul+top-k CUDA kernel against its plain PyTorch version,
on the card. Imports neither jax nor ``tpu_distalg``, so it also runs on
a machine with only the port installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_topk_card.py

Every exact case has integer entries in {-3..3}, so every dot product
is exact in float32 and the kernel must equal the plain version
bitwise. Random cases (normal entries) are held by the tie-tolerance
rule (``topk.assert_topk_close``, rtol 1e-5). Without a card the tests
skip (the kernel has no CPU mode); the exact cases run against the JAX
package in ``tests/test_torch_topk.py``.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import pytest
import torch

from tpu_distalg_torch.ops import topk

EXACT = ["crafted_ties", "offset_and_poisoned_tail", "fewer_valid_than_k",
         "odd_geometry", "k128_two_query_tiles", "ties_across_blocks",
         "k129", "k256", "ties_beyond_queue", "ties_beyond_large_queue",
         "k_equals_n_valid", "k_above_n", "b1", "b33"]
#: held on the card only: JAX's interpret mode takes minutes at k 1000
CARD_ONLY = ["k1000_past_valid"]
#: each case's seed is its place here (later cases are appended)
_SEED_ORDER = EXACT[:8] + CARD_ONLY + EXACT[8:]
#: (B, N, k, block_items, SM count) of the plans held on the CPU
#: (``test_torch_topk.py``) and, for the kernel's layout, here
PLAN_CASES = [
    (32, 16384, 10, None, 132),        # the serving shape
    (32, 1 << 20, 10, None, 132),      # a million items: shape A
    (32, 16384, 256, None, 132),
    (32, 16384, 1000, None, 132),
    (32, 16384, 5000, None, 132),      # lists past shared memory
    (1, 16384, 10, None, 132),
    (33, 16384, 10, 256, 132),
    (40, 600, 129, None, 132),
    (8, 2000, 100, 256, 132),
    (5, 305, 7, None, 114),
    (6, 90, 100, None, 8),             # k above N
]
#: the dynamic shared memory a block may use on an H100
SMEM_MAX = 232448


def _ints(rng, *shape):
    return rng.integers(-3, 4, size=shape).astype(np.float32)


def exact_case(name):
    """(Q, V, index_offset, n_valid, k) with every score exact."""
    rng = np.random.default_rng(_SEED_ORDER.index(name))
    if name == "crafted_ties":
        return (_ints(rng, 8, 48), np.concatenate([_ints(rng, 15, 48)] * 3),
                0, 45, 9)
    if name == "ties_across_blocks":
        # every score repeats 70 times, over many 128-item sub-tiles
        return (_ints(rng, 8, 48),
                np.concatenate([_ints(rng, 15, 48)] * 70), 0, 1050, 9)
    if name == "offset_and_poisoned_tail":
        V = _ints(rng, 200, 48)
        V[150:] = 100.0
        return _ints(rng, 8, 48), V, 1000, 150, 7
    if name == "fewer_valid_than_k":
        return _ints(rng, 8, 48), _ints(rng, 4, 48), 0, 4, 7
    if name == "odd_geometry":
        return _ints(rng, 5, 33), _ints(rng, 305, 33), 0, 305, 7
    # k over 128: the kernel keeps its lists in device memory
    if name == "k129":
        return _ints(rng, 40, 70), _ints(rng, 600, 70), 5, 550, 129
    if name == "k256":
        return _ints(rng, 9, 40), _ints(rng, 1200, 40), 0, 1200, 256
    if name == "k1000_past_valid":
        return _ints(rng, 4, 36), _ints(rng, 260, 36), 7, 250, 1000
    if name in ("ties_beyond_queue", "ties_beyond_large_queue"):
        # 600 copies of the all-3 row, the best item of every query (Q
        # is non-negative): more scores tied with the k-th best than a
        # queue holds (32 entries at k 10, 256 at k 100)
        V = _ints(rng, 2000, 48)
        V[rng.choice(2000, 600, replace=False)] = 3.0
        Q = rng.integers(0, 4, size=(8, 48)).astype(np.float32)
        return Q, V, 0, 2000, 10 if name == "ties_beyond_queue" else 100
    if name == "k_equals_n_valid":
        return _ints(rng, 8, 40), _ints(rng, 300, 40), 11, 77, 77
    if name == "k_above_n":
        return _ints(rng, 6, 40), _ints(rng, 90, 40), 0, 90, 100
    if name == "b1":
        return _ints(rng, 1, 64), _ints(rng, 3000, 64), 0, 3000, 10
    if name == "b33":
        return _ints(rng, 33, 64), _ints(rng, 3000, 64), 2, 2990, 10
    return _ints(rng, 40, 70), _ints(rng, 600, 70), 5, 550, 128


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU "
                    "interpret mode (chip_smoke.py runs it on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", EXACT + CARD_ONLY)
@pytest.mark.parametrize("block_items", [None, 256])
def test_kernel_equals_plain_version_on_card(name, block_items,
                                             cuda_device):
    Q, V, off, nv, k = exact_case(name)
    Qd = torch.as_tensor(Q, device=cuda_device)
    Vd = torch.as_tensor(V, device=cuda_device)
    before = topk.fused_matmul_topk.launches
    gv, gi = topk.fused_matmul_topk(Qd, Vd, off, nv, k=k,
                                    block_items=block_items)
    torch.cuda.synchronize()
    rv, ri = topk.matmul_topk_reference(Qd, Vd, off, nv, k=k)
    assert topk.fused_matmul_topk.launches == before + 1
    assert torch.equal(gv, rv) and torch.equal(gi, ri)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["serving_random", "ties_beyond_queue",
                                  "k256_random"])
def test_kernel_replays_bitwise_over_100_calls(case, cuda_device):
    """The order in which winners reach a queue changes from call to
    call; the total order on (value desc, index asc) makes the result
    the same bits every time."""
    rng = np.random.default_rng(11)
    if case == "ties_beyond_queue":
        Q, V, off, nv, k = exact_case(case)
    else:
        Q = rng.normal(size=(32, 64)).astype(np.float32)
        V = rng.normal(size=(16384, 64)).astype(np.float32)
        off, nv, k = 0, 16384, 10 if case == "serving_random" else 256
    Qd = torch.as_tensor(Q, device=cuda_device)
    Vd = torch.as_tensor(V, device=cuda_device)
    v0, i0 = topk.fused_matmul_topk(Qd, Vd, off, nv, k=k)
    runs = [topk.fused_matmul_topk(Qd, Vd, off, nv, k=k) for _ in range(99)]
    torch.cuda.synchronize()
    for v, i in runs:
        assert torch.equal(v, v0) and torch.equal(i, i0)
    rv, ri = topk.matmul_topk_reference(Qd, Vd, off, nv, k=k + 1)
    topk.assert_topk_close(v0, i0, rv, ri, rtol=1e-5)


@pytest.mark.gpu
def test_kernel_on_two_streams_from_two_threads(cuda_device):
    """Each served model launches from its own dispatch thread on its own
    stream; each stream has its own workspace and tickets."""
    cases = [exact_case("ties_across_blocks"), exact_case("b33")]
    want = [topk.matmul_topk_reference(torch.as_tensor(Q, device=cuda_device),
                                       torch.as_tensor(V, device=cuda_device),
                                       off, nv, k=k)
            for Q, V, off, nv, k in cases]
    results = queue.Queue()

    def run(j):
        try:
            Q, V, off, nv, k = cases[j]
            stream = torch.cuda.Stream(device=cuda_device)
            with torch.cuda.stream(stream):
                Qd = torch.as_tensor(Q, device=cuda_device)
                Vd = torch.as_tensor(V, device=cuda_device)
                outs = [topk.fused_matmul_topk(Qd, Vd, off, nv, k=k,
                                               block_items=256)
                        for _ in range(50)]
            stream.synchronize()
            results.put((j, outs))
        except Exception as e:  # noqa: BLE001 - re-raised below
            results.put((j, e))

    threads = [threading.Thread(target=run, args=(j,), daemon=False)
               for j in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for _ in range(2):
        j, outs = results.get_nowait()
        assert not isinstance(outs, Exception), outs
        for v, i in outs:
            assert torch.equal(v, want[j][0]) and torch.equal(i, want[j][1])


@pytest.mark.gpu
def test_every_served_batch_fill_within_the_tie_rule(cuda_device):
    """The serving shape (ALS 4096 users × 16384 items, rank 64, k 10,
    micro-batches padded to 32): every fill from 1 to 32."""
    from tpu_distalg_torch.serve import artifacts

    rng = np.random.default_rng(12)
    U = rng.normal(size=(4096, 64)).astype(np.float32)
    V = rng.normal(size=(16384, 64)).astype(np.float32)
    model = artifacts.als_model(U, V, device=cuda_device, k_top=10)
    Ud = torch.as_tensor(U, device=cuda_device)
    Vd = torch.as_tensor(V, device=cuda_device)
    for fill in range(1, 33):
        ids = rng.integers(0, 4096, size=fill)
        replies = model.predict_batch(list(ids), 32)
        rv, ri = topk.matmul_topk_reference(
            Ud[torch.as_tensor(ids, device=cuda_device)], Vd, 0, 16384, k=11)
        got_v = np.stack([r[0] for r in replies])
        got_i = np.stack([r[1] for r in replies])
        topk.assert_topk_close(got_v, got_i, rv, ri, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,k,block_items,n_sm", PLAN_CASES)
def test_topk_layout_fits_shared_memory(B, N, k, block_items, n_sm,
                                        cuda_device):
    """The kernel's own layout of every plan fits a block's 227 KB, and
    its state region holds a ticket a query tile."""
    plan = topk.topk_plan(B, N, k, block_items, n_sm)
    state, lists, smem = topk.topk_layout(B, N, k, plan["shape"],
                                          plan["range_items"])
    assert smem <= SMEM_MAX
    assert state >= plan["q_tiles"]
    assert (lists > 0) == (plan["n_ranges"] > 1 or k > 1092)


@pytest.mark.gpu
def test_topk_lists_leave_shared_memory_past_k_1092(cuda_device):
    """Shape B's lists (8 queries, 256-entry queues) fit a block's
    227 KB up to k = 1092, as ``csrc/topk.cu``'s header states; past it
    they take the workspace. Shape A's largest fits half an SM."""
    one = dict(B=8, N=256, shape=1, range_items=256)   # one item range
    assert topk.topk_layout(k=1092, **one)[1] == 0
    state, lists, smem = topk.topk_layout(k=1093, **one)
    assert lists == 4 * 8 * 1093 and smem <= SMEM_MAX
    assert topk.topk_layout(32, 512, 64, 0, 512)[2] <= SMEM_MAX // 2


@pytest.mark.gpu
def test_state_is_zero_whatever_plan_ran_before(cuda_device):
    """Every launch finds its tickets at zero, whatever plan
    ran before it on the stream's workspace: a smaller plan's lists
    never land where a larger one keeps its state. The serving shape at
    B 32, then B 8 with 5 valid items (whose lists are mostly -inf),
    then B 32 again; then more than 32 query tiles (B 1100 at k 10, B
    300 at k 100) after small batches, and so on, each equal to the
    plain version."""
    rng = np.random.default_rng(14)
    Vd = torch.as_tensor(_ints(rng, 16384, 64), device=cuda_device)
    stream = torch.cuda.Stream(device=cuda_device)
    seq = [(32, 16384, 10), (8, 5, 10), (32, 16384, 10), (8, 5, 10),
           (1100, 16384, 10), (8, 5, 100), (300, 16384, 100),
           (1, 16384, 10), (32, 16384, 10)]
    with torch.cuda.stream(stream):
        for B, nv, k in seq:
            Qd = torch.as_tensor(_ints(rng, B, 64), device=cuda_device)
            gv, gi = topk.fused_matmul_topk(Qd, Vd, 0, nv, k=k)
            rv, ri = topk.matmul_topk_reference(Qd, Vd, 0, nv, k=k)
            stream.synchronize()
            assert torch.equal(gv, rv) and torch.equal(gi, ri), (B, nv, k)
