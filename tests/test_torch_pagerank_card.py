"""The PageRank CUDA kernels (``tpu_distalg_torch/csrc/pagerank.cu``) and
the paths of ``models/pagerank.py`` on the card. Imports neither jax nor
``tpu_distalg``, so it also runs on a machine with only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pagerank_card.py

Without a card the tests skip (a CUDA kernel has no CPU mode); the
plain versions are held to the JAX package in
``tests/test_torch_pagerank_kernels.py``.

"exact" cases: x a multiple of 2⁻¹⁰ below 2⁻⁶, w_e = 1 and integer c,
so every partial sum is exact in float32 whatever its order: the
kernels must equal their plain versions bit for bit. "random" cases:
positive uniform values, per element within rtol 1e-5, atol 1e-8 of the
plain version (a row of at most ~40 edges drifts a few 2⁻²⁴ in either
order). The hub row's 100k-term random sum is held to rtol 1e-4: the
plain version on the card adds with atomics in no fixed order, and a
float32 sum of 100k positive terms drifts about 1e-5 of its value (the
CPU's sequential sum: 7.2e-6). A fixed input must replay bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_distalg_torch.models import pagerank
from tpu_distalg_torch.ops import pagerank_kernels as pk
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import datasets

GOLDEN = [0.38891305880091237, 0.214416470596171, 0.3966704706029163]


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _graph(dev, v, hub_degree, avg, seed):
    """CSR rows: row 17 with ``hub_degree`` in-edges, every fifth row
    empty, the others Poisson(avg) edges."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg, size=v)
    deg[::5] = 0
    if hub_degree:
        deg[17] = hub_degree
    rp = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=rp[1:])
    E = int(rp[-1])
    src = rng.integers(0, v, size=E).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return rng, t(rp.astype(np.int32)), t(src), E


CASES = [(4099, 100_000, 8.0), (1_000_003, 0, 8.0), (37, 0, 2.5),
         (5000, 0, 30.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("v,hub,avg", CASES)
def test_kernels_exact_cases_bitwise(v, hub, avg, cuda_device):
    rng, rp, src, E = _graph(cuda_device, v, hub, avg, seed=v)
    x = torch.as_tensor((rng.integers(0, 16, size=v) / 1024.0).astype(
        np.float32), device=cuda_device)
    ones = torch.ones(E, device=cuda_device)
    c = torch.as_tensor(rng.integers(-8, 9, size=E).astype(np.float32),
                        device=cuda_device)
    before = (pk.spmv_table.launches, pk.scatter_table.launches)
    y7 = pk.spmv_table(rp, src, ones, x)
    y8 = pk.scatter_table(rp, c)
    torch.cuda.synchronize()
    assert (pk.spmv_table.launches, pk.scatter_table.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(y7, pk.spmv_table_reference(rp, src, ones, x))
    assert torch.equal(y8, pk.scatter_table_reference(rp, c))
    assert float(y7[::5][1:].abs().max()) == 0.0  # empty rows
    assert torch.equal(y7, pk.spmv_table(rp, src, ones, x))
    assert torch.equal(y8, pk.scatter_table(rp, c))


@pytest.mark.gpu
@pytest.mark.parametrize("v,hub,avg", CASES)
def test_kernels_random_cases(v, hub, avg, cuda_device):
    rng, rp, src, E = _graph(cuda_device, v, hub, avg, seed=v + 1)
    x = torch.as_tensor(rng.random(v).astype(np.float32), device=cuda_device)
    w = torch.as_tensor(rng.random(E).astype(np.float32), device=cuda_device)
    c = torch.as_tensor(rng.random(E).astype(np.float32), device=cuda_device)
    rtol = 1e-4 if hub else 1e-5
    y7 = pk.spmv_table(rp, src, w, x)
    torch.testing.assert_close(y7, pk.spmv_table_reference(rp, src, w, x),
                               rtol=rtol, atol=1e-8)
    y8 = pk.scatter_table(rp, c)
    torch.testing.assert_close(y8, pk.scatter_table_reference(rp, c),
                               rtol=rtol, atol=1e-8)
    assert torch.equal(y7, pk.spmv_table(rp, src, w, x))
    assert torch.equal(y8, pk.scatter_table(rp, c))


@pytest.mark.gpu
def test_cuda_tensors_never_take_the_plain_version(cuda_device):
    rp = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="V >= 1"):
        pk.scatter_table(rp, torch.zeros(0, device=cuda_device))
    with pytest.raises(ValueError, match="operands on"):
        pk.scatter_table(torch.tensor([0, 0], dtype=torch.int32,
                                      device=cuda_device),
                         torch.zeros(0))


def _reset():
    for k in pk.KERNELS:
        k.launches = 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode,scatter,b7,b8", [
    ("standard", "auto", 12, 0), ("standard", "spmv", 12, 0),
    ("standard", "pallas", 0, 12), ("standard", "xla", 0, 0),
    ("reference", "auto", 24, 0)])
def test_paths_launch_their_kernels_and_replay(mode, scatter, b7, b8,
                                               cuda_device):
    """Each path's launches per 12 iterations, the card against the
    CPU's plain versions (rtol 1e-5, atol 1e-8), bitwise replay."""
    edges = datasets.erdos_renyi_edges(20_000, 8.0, seed=1)
    cfg = pagerank.PageRankConfig(n_iterations=12, mode=mode,
                                  scatter=scatter)
    _reset()
    card = pagerank.run(edges, get_mesh(device=cuda_device), cfg)
    torch.cuda.synchronize()
    assert (pk.spmv_table.launches, pk.scatter_table.launches) == (b7, b8)
    cpu = pagerank.run(edges, get_mesh(device="cpu"), cfg)
    torch.testing.assert_close(card.ranks.cpu(), cpu.ranks, rtol=1e-5,
                               atol=1e-8)
    assert torch.equal(card.has_rank.cpu(), cpu.has_rank)
    if scatter != "xla":
        again = pagerank.run(edges, get_mesh(device=cuda_device), cfg)
        assert torch.equal(card.ranks, again.ranks)


@pytest.mark.gpu
def test_reference_toy_golden_on_card(cuda_device):
    _reset()
    res = pagerank.run(datasets.toy_graph_edges(),
                       get_mesh(data=2, device=cuda_device))
    assert pk.spmv_table.launches == 2 * 10 * 2  # 2 per shard per iteration
    np.testing.assert_allclose(res.ranks.cpu().numpy(), GOLDEN, atol=1e-5)
