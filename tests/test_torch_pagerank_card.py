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
CPU's sequential sum: 7.2e-6); so are the skewed graph's rows of more
than 10,000 edges. A fixed input must replay bit for bit.

The kernels split the merge path of row ends and edges into tiles of
equal work (``pagerank_kernels.tile_plan``): the cases below put rows
across tile boundaries and past a whole tile, slices of src and w at
every 4-byte offset, shards without edges, and calls of many shapes in
turn on one stream's workspace (tickets that every launch leaves zero).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch.models import pagerank
from tpu_distalg_torch.ops import graph as gops
from tpu_distalg_torch.ops import pagerank_kernels as pk
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils import datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

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


def _check_exact_and_random(dev, rp, src, rng, what):
    """B7 and B8 on one CSR against the plain versions: dyadic x with
    w_e = 1 and integer c bitwise, random values within rtol 1e-5 (rows
    of more than 10,000 edges 1e-4, as the hub row), replay bitwise."""
    V, E = rp.shape[0] - 1, src.shape[0]
    x = torch.as_tensor((rng.integers(0, 16, size=V) / 1024.0).astype(
        np.float32), device=dev)
    ones = torch.ones(E, device=dev)
    c = torch.as_tensor(rng.integers(-8, 9, size=E).astype(np.float32),
                        device=dev)
    y7, y8 = pk.spmv_table(rp, src, ones, x), pk.scatter_table(rp, c)
    assert torch.equal(y7, pk.spmv_table_reference(rp, src, ones, x)), what
    assert torch.equal(y8, pk.scatter_table_reference(rp, c)), what
    xr, wr, cr = (torch.as_tensor(rng.random(n).astype(np.float32),
                                  device=dev) for n in (V, E, E))
    y7, y8 = pk.spmv_table(rp, src, wr, xr), pk.scatter_table(rp, cr)
    rtol = torch.where(rp[1:] - rp[:-1] > 10_000, 1e-4, 1e-5)
    for got, want in ((y7, pk.spmv_table_reference(rp, src, wr, xr)),
                      (y8, pk.scatter_table_reference(rp, cr))):
        assert bool(((got - want).abs() <= 1e-8 + rtol * want.abs()).all()
                    ), what
    assert torch.equal(y7, pk.spmv_table(rp, src, wr, xr)), what
    assert torch.equal(y8, pk.scatter_table(rp, cr)), what


@pytest.mark.gpu
def test_misaligned_shard_slices(cuda_device):
    """A 3-shard split of ~30k edges, E and the slices' length not
    multiples of 4: the shards' src and w_e slices start 16-byte
    misaligned (scalar heads and tails), each shard's
    sweep against the plain version, with the prepared plans."""
    edges = datasets.erdos_renyi_edges(4000, 7.5, seed=3)
    for drop in range(16):   # E and the shards' slice length not 4k
        el = gops.prepare_edges(edges[:len(edges) - drop], 4000)
        if el.n_edges % 4 and -(-el.n_edges // 3) % 4:
            break
    de = pagerank.prepare_device_edges(el, get_mesh(data=3,
                                                    device=cuda_device))
    offsets = {src.data_ptr() % 16 for _, src, _ in de.shards}
    assert len(offsets) > 1
    rng = np.random.default_rng(3)
    for (rp, src, w), plan in zip(de.shards, de.plans):
        x = torch.as_tensor(rng.random(4000).astype(np.float32),
                            device=cuda_device)
        c = torch.as_tensor(rng.random(src.shape[0]).astype(np.float32),
                            device=cuda_device)
        torch.testing.assert_close(pk.spmv_table(rp, src, w, x, plan),
                                   pk.spmv_table_reference(rp, src, w, x),
                                   rtol=1e-5, atol=1e-8)
        torch.testing.assert_close(pk.scatter_table(rp, c, plan),
                                   pk.scatter_table_reference(rp, c),
                                   rtol=1e-5, atol=1e-8)
        _check_exact_and_random(cuda_device, rp, src, rng, "misaligned")
    # w_e sliced at another offset than src: scalar loads throughout
    rp, src, w = de.shards[1]
    for k in (1, 2, 3):
        w2 = torch.cat([torch.zeros(k, device=cuda_device), w])[k:]
        if (w2.data_ptr() - src.data_ptr()) % 16:
            break
    x = torch.as_tensor(rng.random(4000).astype(np.float32),
                        device=cuda_device)
    assert (w2.data_ptr() - src.data_ptr()) % 16 != 0
    torch.testing.assert_close(pk.spmv_table(rp, src, w2, x),
                               pk.spmv_table_reference(rp, src, w2, x),
                               rtol=1e-5, atol=1e-8)


@pytest.mark.gpu
def test_empty_shard(cuda_device):
    """E = 0: every row sums to 0 (a shard of an 8-way split of 5 edges
    has none), directly and through the paths."""
    for v in (1, 37, 5000):
        rp = torch.zeros(v + 1, dtype=torch.int32, device=cuda_device)
        src = torch.zeros(0, dtype=torch.int32, device=cuda_device)
        empty = torch.zeros(0, device=cuda_device)
        x = torch.ones(v, device=cuda_device)
        assert torch.equal(pk.spmv_table(rp, src, empty, x),
                           torch.zeros(v, device=cuda_device))
        assert torch.equal(pk.scatter_table(rp, empty),
                           torch.zeros(v, device=cuda_device))
    edges = np.array([[0, 1], [1, 2], [2, 0], [3, 1], [2, 3]])
    cfg = pagerank.PageRankConfig(n_iterations=4, mode="standard")
    card = pagerank.run(edges, get_mesh(data=8, device=cuda_device), cfg)
    cpu = pagerank.run(edges, get_mesh(data=8, device="cpu"), cfg)
    torch.testing.assert_close(card.ranks.cpu(), cpu.ranks, rtol=1e-5,
                               atol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("v,low,high,long_row", [
    (3000, 0, 700, 5000),      # rows across many tile boundaries
    (40, 1500, 2600, 9000),    # rows longer than a tile (256 items here)
    (997, 0, 40, 0)])          # rows around kShort (16) and the warp path
def test_rows_straddling_tiles(v, low, high, long_row, cuda_device):
    rng = np.random.default_rng(v)
    deg = rng.integers(low, high + 1, size=v)
    deg[::7] = 0
    if long_row:
        deg[v // 2] = long_row
    rp = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=rp[1:])
    src = rng.integers(0, v, size=int(rp[-1])).astype(np.int32)
    rpt = torch.as_tensor(rp.astype(np.int32), device=cuda_device)
    plan = pk.tile_plan(rpt, len(src))
    r = np.arange(v)
    crossing = (rp[r] + r) // plan.items < (rp[r + 1] + r) // plan.items
    assert crossing.sum() > 1
    _check_exact_and_random(cuda_device, rpt,
                            torch.as_tensor(src, device=cuda_device), rng,
                            f"straddling v={v}")


def _skewed_rows(dev, v, seed=0):
    """In-degrees zipf(2.0), capped at 100,000; src uniform."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(2.0, v), 100_000)
    rp = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=rp[1:])
    src = rng.integers(0, v, size=int(rp[-1])).astype(np.int32)
    return (rng, torch.as_tensor(rp.astype(np.int32), device=dev),
            torch.as_tensor(src, device=dev), deg)


@pytest.mark.gpu
def test_skewed_graph(cuda_device):
    """The skewed graph at V 50,000: rows of up to 100,000 edges among
    Poisson-short ones; rows past 10,000 edges held to rtol 1e-4."""
    rng, rp, src, deg = _skewed_rows(cuda_device, 50_000)
    assert (deg > 10_000).any() and (deg <= 16).mean() > 0.9
    _check_exact_and_random(cuda_device, rp, src, rng, "skewed")


@pytest.mark.gpu
def test_calls_of_other_shapes_in_turn_on_one_stream(cuda_device):
    """Calls with different V and E (and tile sizes) in turn on one
    stream, each exact case bitwise, and the tickets' workspace all zero
    after them."""
    from tpu_distalg_torch.ops import _native

    graphs = [_graph(cuda_device, v, hub, avg, seed=v)[1:3]
              for v, hub, avg in ((4099, 100_000, 8.0), (37, 0, 2.5),
                                  (200_003, 0, 8.0), (5000, 0, 30.0))]
    graphs.append((torch.zeros(11, dtype=torch.int32, device=cuda_device),
                   torch.zeros(0, dtype=torch.int32, device=cuda_device)))
    rng = np.random.default_rng(1)
    for rp, src in graphs + graphs[::-1]:
        _check_exact_and_random(cuda_device, rp, src, rng, "in turn")
    torch.cuda.synchronize()
    dev = graphs[0][0].device
    key = ("pagerank tickets", dev.index, _native.stream(dev))
    assert int(_native._WORKSPACES[key].abs().sum()) == 0


@pytest.mark.gpu
def test_replay_bitwise_over_100_calls(cuda_device):
    rng, rp, src, E = _graph(cuda_device, 4099, 100_000, 8.0, seed=9)
    x = torch.as_tensor(rng.random(4099).astype(np.float32),
                        device=cuda_device)
    w = torch.as_tensor(rng.random(E).astype(np.float32), device=cuda_device)
    plan = pk.tile_plan(rp, E)
    first7, first8 = pk.spmv_table(rp, src, w, x, plan), \
        pk.scatter_table(rp, w, plan)
    for _ in range(100):
        assert torch.equal(pk.spmv_table(rp, src, w, x, plan), first7)
        assert torch.equal(pk.scatter_table(rp, w, plan), first8)


@pytest.mark.gpu
def test_plan_is_checked_and_the_ceiling_runs(cuda_device):
    """A plan of another graph raises; the gather ceiling's tiles add up
    to B7's sweep."""
    rng, rp, src, E = _graph(cuda_device, 5000, 0, 30.0, seed=4)
    x = torch.as_tensor(rng.random(5000).astype(np.float32),
                        device=cuda_device)
    w = torch.as_tensor(rng.random(E).astype(np.float32), device=cuda_device)
    other = pk.tile_plan(rp[:-1], E)
    with pytest.raises(ValueError, match="plan is for"):
        pk.spmv_table(rp, src, w, x, other)
    with pytest.raises(ValueError, match="plan is for"):
        pk.scatter_table(rp, w, pk.tile_plan(rp.cpu(), E))
    plan = pk.tile_plan(rp, E)
    sums = pk.gather_ceiling(rp, src, w, x, plan)
    assert sums.shape == (plan.n_tiles,)
    torch.testing.assert_close(sums.double().sum(),
                               pk.spmv_table(rp, src, w, x).double().sum(),
                               rtol=1e-5, atol=0.0)


@pytest.mark.gpu
def test_a_plan_of_another_row_ptr_of_the_same_shape_is_refused(cuda_device):
    """B7, B8 and the gather ceiling refuse the plan of another graph
    with the same V and E, and the plan of an equal-valued clone, before
    they launch; the graph's own plan gives the plan-less result."""
    rng, rp, src, E = _graph(cuda_device, 5000, 0, 30.0, seed=4)
    deg = np.diff(rp.cpu().numpy().astype(np.int64))
    other = np.zeros(5001, np.int64)
    np.cumsum(rng.permutation(deg), out=other[1:])
    rp2 = torch.as_tensor(other.astype(np.int32), device=cuda_device)
    assert rp2.shape == rp.shape and int(rp2[-1]) == E
    assert not torch.equal(rp2, rp)
    x = torch.as_tensor(rng.random(5000).astype(np.float32),
                        device=cuda_device)
    w = torch.as_tensor(rng.random(E).astype(np.float32), device=cuda_device)
    before = (pk.spmv_table.launches, pk.scatter_table.launches)
    for plan in (pk.tile_plan(rp, E), pk.tile_plan(rp2.clone(), E)):
        with pytest.raises(ValueError, match="another row_ptr"):
            pk.spmv_table(rp2, src, w, x, plan)
        with pytest.raises(ValueError, match="another row_ptr"):
            pk.scatter_table(rp2, w, plan)
        with pytest.raises(ValueError, match="another row_ptr"):
            pk.gather_ceiling(rp2, src, w, x, plan)
    assert (pk.spmv_table.launches, pk.scatter_table.launches) == before
    plan2 = pk.tile_plan(rp2, E)
    assert torch.equal(pk.spmv_table(rp2, src, w, x, plan2),
                       pk.spmv_table(rp2, src, w, x))
    assert torch.equal(pk.scatter_table(rp2, w, plan2),
                       pk.scatter_table(rp2, w))
