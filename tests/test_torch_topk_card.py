"""The fused matmul+top-k CUDA kernel against its plain PyTorch version,
on the card. Imports neither jax nor ``tpu_distalg``, so it also runs on
a machine with only the port installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_topk_card.py

Every case has integer entries in {-3..3}, so every dot product is exact
in float32 and the kernel must equal the plain version bitwise. Without
a card the tests skip (the kernel has no CPU mode); the same cases run
against the JAX package in ``tests/test_torch_topk.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_distalg_torch.ops import topk

EXACT = ["crafted_ties", "offset_and_poisoned_tail", "fewer_valid_than_k",
         "odd_geometry", "k128_two_query_tiles", "ties_across_blocks",
         "k129", "k256"]
#: held on the card only: JAX's interpret mode takes minutes at k 1000
CARD_ONLY = ["k1000_past_valid"]


def _ints(rng, *shape):
    return rng.integers(-3, 4, size=shape).astype(np.float32)


def exact_case(name):
    """(Q, V, index_offset, n_valid, k) with every score exact."""
    rng = np.random.default_rng((EXACT + CARD_ONLY).index(name))
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
