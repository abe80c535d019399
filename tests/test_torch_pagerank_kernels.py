"""The port's PageRank host prep and kernels
(``tpu_distalg_torch/ops/graph.py``, ``ops/pagerank_kernels.py``)
against the JAX package (``tpu_distalg/ops/graph.py``,
``tpu_distalg/native``, ``ops/pallas_pagerank.py`` in interpret mode),
on the CPU.

Integer prep must be equal exactly: deduped (src, dst), out-degrees,
the dst sort, the CSR rows and the shard split. ``inv_out_degree`` is
equal bit for bit. On the CPU each kernel wrapper runs its plain
version (an ``index_add_`` in edge order); sums of float32 products are
held to rtol 1e-5, atol 1e-7 against a float64 ``np.add.at`` and
against the JAX kernels, as ``tests/test_pallas_pagerank.py`` holds the
JAX kernels. On dyadic inputs every partial sum is exact, so there the
plain versions must equal the float64 sums bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_distalg import native
from tpu_distalg.graphs import ingest
from tpu_distalg.models import pagerank as jpagerank
from tpu_distalg.ops import graph as jgops
from tpu_distalg.ops import pallas_pagerank as ppr
from tpu_distalg.utils import datasets as jdatasets
from tpu_distalg_torch.ops import graph as gops
from tpu_distalg_torch.ops import pagerank_kernels as pk
from tpu_distalg_torch.utils import datasets


def _random_edges(v, e, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, size=e), rng.integers(0, v, size=e)],
                    axis=1).astype(np.int64)


def _row_ptr(dst, v):
    rp = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=v), out=rp[1:])
    return torch.from_numpy(rp.astype(np.int32))


def _add_at(dst, vals, v):
    want = np.zeros(v, np.float64)
    np.add.at(want, dst, np.asarray(vals, np.float64))
    return want


@pytest.mark.parametrize("v,e,seed", [(50, 400, 0), (4096, 65536, 5),
                                      (3, 0, 0)])
def test_prepare_edges_equals_jax(v, e, seed):
    """Dedupe (duplicates and self-loops kept once), (src, dst) order and
    out-degrees equal JAX's, with an inferred and a larger vertex
    count."""
    edges = _random_edges(max(v, 1), e, seed)
    if e:
        edges = np.concatenate([edges, edges[: e // 3]])
    for n in ((None, v + 7) if e else (v,)):
        got = gops.prepare_edges(edges, n)
        want = jgops.prepare_edges(edges, n)
        assert got.n_vertices == want.n_vertices and got.n_edges == \
            want.n_edges
        for name in ("src", "dst", "out_degree"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_graph_generators_equal_jax():
    for args in ((1000, 8.0, 0), (4096, 3.5, 7)):
        np.testing.assert_array_equal(datasets.erdos_renyi_edges(*args),
                                      jdatasets.erdos_renyi_edges(*args))
    np.testing.assert_array_equal(datasets.toy_graph_edges(),
                                  jdatasets.toy_graph_edges())


def test_prepare_edges_rejects_undersized_vertex_count():
    edges = datasets.toy_graph_edges()
    with pytest.raises(ValueError, match="n_vertices=2"):
        gops.prepare_edges(edges, 2)
    with pytest.raises(ValueError, match="n_vertices=2"):
        jgops.prepare_edges(edges, 2)


def test_host_helpers_equal_native(tmp_path):
    """The numpy helpers give the C++ ingest's integer arrays."""
    edges = _random_edges(300, 5000, 1)
    for a, b in zip(gops.dedupe_edges_pair(edges),
                    native.dedupe_edges_pair(edges)):
        np.testing.assert_array_equal(a, b)
    src = edges[:, 0]
    np.testing.assert_array_equal(gops.out_degree(src, 300),
                                  native.out_degree(src, 300))
    np.testing.assert_array_equal(gops.counting_sort_perm(edges[:, 1], 300),
                                  native.counting_sort_perm(edges[:, 1], 300))
    with pytest.raises(ValueError, match="out of range"):
        gops.counting_sort_perm(np.array([0, 300]), 300)
    with pytest.raises(ValueError, match="out of range"):
        gops.out_degree(np.array([0, 300]), 300)
    path = tmp_path / "edges.txt"
    path.write_text("# a comment\n0 1\n0 2\n\n1\t2\n2 0  # tail\n")
    np.testing.assert_array_equal(gops.parse_edges_text(str(path)),
                                  native.parse_edges_text(str(path), 64))


def test_inv_out_degree_equals_jax():
    deg = np.array([0, 1, 2, 3, 7, 0, 1000, 12345], np.int32)
    got = gops.inv_out_degree(deg)
    want = ingest.inv_out_degree(deg)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_plan_csr_matches_jax_device_edges(n_shards, mesh8):
    """The dst-sorted src and w_e, the dst ids expanded from row_ptr,
    and each shard's edge range equal JAX's ``prepare_device_edges``
    (the no-plan layout, padded to a multiple of the shard count)."""
    el_np = jgops.prepare_edges(_random_edges(700, 6000, 2), 700)
    plan = pk.plan_csr(gops.prepare_edges(_random_edges(700, 6000, 2), 700),
                       n_shards)
    E = el_np.n_edges
    order = native.counting_sort_perm(el_np.dst, 700)
    np.testing.assert_array_equal(plan.src, el_np.src[order])
    np.testing.assert_array_equal(
        plan.w_e, ingest.inv_out_degree(el_np.out_degree)[el_np.src[order]])
    rows = np.repeat(np.arange(700), np.diff(plan.row_ptr))
    np.testing.assert_array_equal(rows, el_np.dst[order])
    assert plan.row_ptr.dtype == np.int32 and plan.row_ptr[-1] == E
    if n_shards == 8:
        de = jpagerank.prepare_device_edges(el_np, mesh8, build_plan=False)
        np.testing.assert_array_equal(np.asarray(de.src)[:E], plan.src)
        np.testing.assert_array_equal(np.asarray(de.w_e)[:E], plan.w_e)
        real = np.asarray(de.emask).reshape(8, -1).sum(axis=1)
        assert [hi - lo for lo, hi in plan.bounds] == real.tolist()
    for s, (lo, hi) in enumerate(plan.bounds):
        rp = plan.shard_row_ptr(s)
        assert rp[0] == 0 and rp[-1] == hi - lo
        np.testing.assert_array_equal(
            np.repeat(np.arange(700), np.diff(rp)), rows[lo:hi])
    assert plan.bounds[0][0] == 0 and plan.bounds[-1][1] == E


def test_scatter_table_b8_matches_jax_kernel():
    """B8's plain version against the JAX Pallas scatter (interpret) and
    a float64 ``np.add.at``, as ``test_plan_and_scatter_match_numpy``."""
    v, e = 2048, 16384
    rng = np.random.default_rng(0)
    dst = np.sort(rng.integers(0, v, size=e).astype(np.int32))
    contrib = rng.random(e).astype(np.float32)
    plan = ppr.plan_scatter(dst, v, n_shards=1, chunk=128, blk=4)
    assert plan is not None
    c_pad = np.zeros(plan.n_chunks * 128, np.float32)
    c_pad[:e] = contrib
    jax_out = np.asarray(ppr.scatter_table(
        jnp.asarray(plan.base), jnp.asarray(c_pad.reshape(-1, 128)),
        jnp.asarray(plan.row), jnp.asarray(plan.lane), w=plan.w, r8=plan.r8,
        blk=plan.blk, interpret=True))[:plan.r8].reshape(-1)[:v]
    got = pk.scatter_table(_row_ptr(dst, v), torch.from_numpy(contrib))
    assert got.shape == (v,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.numpy(), _add_at(dst, contrib, v),
                               rtol=1e-5, atol=1e-7)


def test_spmv_table_b7_matches_jax_kernel():
    """B7's plain version against the JAX fused SpMV (interpret) on the
    same (src, dst, w_e, ranks), and a float64 ``np.add.at``."""
    v, e = 8192, 65536
    rng = np.random.default_rng(4)
    src = rng.integers(0, v, size=e)
    dst = rng.integers(0, v, size=e)
    w_e = rng.random(e).astype(np.float32)
    ranks = rng.random(v).astype(np.float32)
    plan = ppr.plan_spmv(src, dst, w_e, v)
    assert plan is not None
    rt = np.zeros((plan.r8 + plan.rg, 128), np.float32)
    rt[: (v + 127) // 128].reshape(-1)[:v] = ranks
    jax_out = np.asarray(ppr.spmv_table(
        jnp.asarray(plan.gbase), jnp.asarray(plan.sbase), jnp.asarray(rt),
        jnp.asarray(plan.src_lane), jnp.asarray(plan.src_row),
        jnp.asarray(plan.dst_row), jnp.asarray(plan.dst_lane),
        jnp.asarray(plan.w_e), rg=plan.rg, ws=plan.ws, r8=plan.r8,
        blk=plan.blk, interpret=True))[:plan.r8].reshape(-1)[:v]
    order = np.argsort(dst, kind="stable")
    got = pk.spmv_table(_row_ptr(dst, v),
                        torch.from_numpy(src[order].astype(np.int32)),
                        torch.from_numpy(w_e[order]), torch.from_numpy(ranks))
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        got.numpy(), _add_at(dst, ranks[src].astype(np.float64) * w_e, v),
        rtol=1e-5, atol=1e-7)


def _hub_graph(rng, v, hub, hub_degree):
    """Row ``hub`` with ``hub_degree`` in-edges, every fifth row empty,
    the rest a few edges each."""
    deg = rng.integers(0, 12, size=v)
    deg[::5] = 0
    deg[hub] = hub_degree
    rp = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=rp[1:])
    src = rng.integers(0, v, size=int(rp[-1]))
    return rp, src, np.repeat(np.arange(v), deg)


@pytest.mark.parametrize("v,hub_degree", [(4099, 100_000), (37, 0)])
def test_plain_kernels_exact_cases_bitwise(v, hub_degree):
    """Dyadic x (multiples of 2⁻¹⁰, small enough that a 100k-edge hub
    row sums exactly), w_e = 1 and integer c: every partial sum is exact
    in float32, so the plain versions equal the float64 sums bit for
    bit, empty rows included."""
    rng = np.random.default_rng(v)
    rp, src, dst = _hub_graph(rng, v, 17, hub_degree)
    x = (rng.integers(0, 16, size=v) / 1024.0).astype(np.float32)
    c = rng.integers(-8, 9, size=len(src)).astype(np.float32)
    rpt = torch.from_numpy(rp.astype(np.int32))
    y7 = pk.spmv_table(rpt, torch.from_numpy(src.astype(np.int32)),
                       torch.ones(len(src)), torch.from_numpy(x))
    y8 = pk.scatter_table(rpt, torch.from_numpy(c))
    want7 = _add_at(dst, x[src], v)
    want8 = _add_at(dst, c, v)
    np.testing.assert_array_equal(y7.numpy(), want7.astype(np.float32))
    np.testing.assert_array_equal(y8.numpy(), want8.astype(np.float32))
    assert (y7.numpy()[::5][1:] == 0).all() and (y8.numpy()[::5][1:] == 0
                                                 ).all()


def test_plain_kernels_random_hub_row():
    """Random positive values with a 100k-edge hub row: within rtol 1e-5,
    atol 1e-7 of the float64 sums. The plain version adds in edge order;
    its hub row is 7.2e-6 relative from the float64 sum on this seed."""
    rng = np.random.default_rng(7)
    v = 4099
    rp, src, dst = _hub_graph(rng, v, 17, 100_000)
    x = rng.random(v).astype(np.float32)
    w = rng.random(len(src)).astype(np.float32)
    y7 = pk.spmv_table(torch.from_numpy(rp.astype(np.int32)),
                       torch.from_numpy(src.astype(np.int32)),
                       torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(
        y7.numpy(), _add_at(dst, x[src] * w, v), rtol=1e-5, atol=1e-7)


def test_wrappers_validate_and_cpu_takes_the_plain_version():
    rp = torch.tensor([0, 2, 3], dtype=torch.int32)
    src = torch.tensor([1, 0, 1], dtype=torch.int32)
    w = torch.ones(3)
    x = torch.tensor([1.0, 2.0])
    before = (pk.spmv_table.launches, pk.scatter_table.launches)
    assert pk.spmv_table(rp, src, w, x).tolist() == [3.0, 2.0]
    assert pk.scatter_table(rp, torch.tensor([1.0, 2.0, 4.0])).tolist() == [
        3.0, 4.0]
    assert (pk.spmv_table.launches, pk.scatter_table.launches) == before
    with pytest.raises(ValueError, match="int32"):
        pk.spmv_table(rp.long(), src, w, x)
    with pytest.raises(ValueError, match="disagree"):
        pk.spmv_table(rp, src, w[:2], x)
    with pytest.raises(ValueError, match="float32"):
        pk.scatter_table(rp, torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="1-D"):
        pk.spmv_table(rp, src, w, x[None])
    assert [pk.tile_items(v, e) for v, e in (
        (1, 0), (1000, 8000), (100_000, 800_000), (500_000, 1_500_000),
        (1_000_000, 7_999_981))] == [256, 256, 512, 1024, 2048]
    assert pk.KERNELS == (pk.spmv_table, pk.scatter_table)


def _plan_case(name):
    """(row_ptr int64 numpy, E) of a tile-plan case: V 1, V 37, the
    hub graph, an empty shard (E = 0), or shard s of a 3- or 8-shard
    split (``split3-1``)."""
    rng = np.random.default_rng(11)
    if name == "v1":
        return np.array([0, 5], np.int64), 5
    if name == "v37":
        rp, _, _ = _hub_graph(rng, 37, 3, 0)
        return rp, int(rp[-1])
    if name == "hub":
        rp, _, _ = _hub_graph(rng, 4099, 17, 100_000)
        return rp, int(rp[-1])
    if name == "empty_shard":
        return np.zeros(301, np.int64), 0
    n, s = (int(p) for p in name[len("split"):].split("-"))
    plan = pk.plan_csr(gops.prepare_edges(_random_edges(2000, 30_011, 3),
                                          2000), n)
    rp = plan.shard_row_ptr(s).astype(np.int64)
    return rp, int(rp[-1])


PLAN_CASES = (["v1", "v37", "hub", "empty_shard"]
              + [f"split3-{s}" for s in range(3)]
              + [f"split8-{s}" for s in range(8)])


def _tile_bounds(plan):
    """Per tile: its rows [i0, i1) and edges [j0, j1)."""
    rb = plan.rows_before.numpy().astype(np.int64)
    d = np.minimum(np.arange(plan.n_tiles + 1) * plan.items,
                   plan.n_rows + plan.n_edges)
    return rb, d - rb


@pytest.mark.parametrize("name", PLAN_CASES)
def test_tile_plan_covers_every_row_and_edge_once(name):
    """Every row ends in exactly one tile and every edge lies in exactly
    one: the tiles' row and edge ranges are consecutive and cover
    [0, V) and [0, E). A tile holds at most ``items`` rows and edges
    together, so its edges stay within the budget; only a row longer
    than a tile spans several (its edges before its end)."""
    rp, E = _plan_case(name)
    V = len(rp) - 1
    plan = pk.tile_plan(torch.from_numpy(rp.astype(np.int32)), E)
    assert (plan.n_rows, plan.n_edges) == (V, E)
    assert plan.items == pk.tile_items(V, E)
    assert plan.rows_before.dtype == torch.int32
    assert plan.n_tiles == max(1, -(-(V + E) // plan.items))
    rb, eb = _tile_bounds(plan)
    assert rb[0] == 0 and rb[-1] == V and eb[0] == 0 and eb[-1] == E
    assert (np.diff(rb) >= 0).all() and (np.diff(eb) >= 0).all()
    assert (np.diff(rb) + np.diff(eb) <= plan.items).all()
    assert (np.diff(rb)[:-1] + np.diff(eb)[:-1] == plan.items).all()
    for t in range(plan.n_tiles):
        rows = np.arange(rb[t], rb[t + 1])
        # a row ends in tile t: its edges lie at or before the tile's end
        # and its end comes after the tile's start
        assert (rp[rows + 1] <= eb[t + 1]).all()
        assert (rp[rows + 1] + rows >= t * plan.items).all()
        if rb[t + 1] < V:   # the open row has not ended before the tile's end
            assert rp[rb[t + 1] + 1] + rb[t + 1] >= (t + 1) * plan.items
    # a row longer than a tile is the one thing past the budget: it spans
    # tiles
    long = np.flatnonzero(np.diff(rp) > plan.items)
    assert ((rp[long + 1] + long) // plan.items
            > (rp[long] + long) // plan.items).all()


def _tile_sums(plan, rp, vals):
    """The kernels' order of adds, in numpy float32: each tile's part of
    a row in edge order (a warp's strided lanes folded by the butterfly
    past ``kShort`` = 16 edges); a row that crosses one tile boundary
    with at most 64 edges before it read whole by the tile that holds its
    end (a warp's fold over all its edges); any other crossing row added
    up from its parts in tile order by the last tile to take its ticket (one part a tile, a warp's
    fold again)."""
    f = np.float32

    def fold(xs, warp):
        xs = [f(v) for v in xs]
        if len(xs) <= 16 and not warp:
            acc = f(0)
            for v in xs:
                acc = f(acc + v)
            return acc
        lanes = [f(0)] * 32
        for i, v in enumerate(xs):
            lanes[i % 32] = f(lanes[i % 32] + v)
        for off in (16, 8, 4, 2, 1):
            lanes = [f(lanes[i] + lanes[i ^ off]) for i in range(32)]
        return lanes[0]

    V, items = plan.n_rows, plan.items
    rb, eb = _tile_bounds(plan)
    y = np.full(V, np.nan, np.float32)
    parts = {}
    tickets = np.zeros(plan.n_tiles, np.int64)

    def tiles_of(r):
        return (rp[r] + r) // items, (rp[r + 1] + r) // items

    def whole(r):   # over one boundary, at most kWhole = 64 edges before
        ta, tb = tiles_of(r)
        return tb - ta == 1 and tb * items - r - rp[r] <= 64

    for t in range(plan.n_tiles):
        i0, i1, j0, j1 = rb[t], rb[t + 1], eb[t], eb[t + 1]
        for k in range(i1 - i0 + 1):
            r = i0 + k
            b = max(rp[r], j0)
            e = rp[r + 1] if r < i1 else j1
            if r == i1:
                if r < V and rp[r] < j1:
                    parts[(t, 1)] = fold(vals[b:e], False)
            elif k == 0 and rp[r] < j0:
                if whole(r):
                    y[r] = fold(vals[rp[r]:rp[r + 1]], True)
                else:
                    parts[(t, 0)] = fold(vals[b:e], False)
            else:
                y[r] = fold(vals[b:e], False)
        for slot, cross, r in ((0, i1 > i0 and rp[i0] < j0, i0),
                               (1, i1 < V and rp[i1] < j1, i1)):
            if not cross:
                continue
            ta, tb = tiles_of(r)
            if whole(r):
                continue
            tickets[tb] += 1
            if tickets[tb] == tb - ta + 1:
                y[r] = fold([parts[(u, 0 if u == tb else 1)]
                             for u in range(ta, tb + 1)], True)
                tickets[tb] = 0
    assert not tickets.any() and not np.isnan(y).any()
    return y


@pytest.mark.parametrize("name", PLAN_CASES)
def test_tile_sums_in_the_kernels_order_equal_the_plain_sums(name):
    """The plan's rows, whole or in parts and tickets, added in the
    kernels' order (in numpy), give every row once: integer values equal the plain sums bit
    for bit, random ones within rtol 1e-5 (the hub row 1e-4, as the card
    tests hold it)."""
    rp, E = _plan_case(name)
    V = len(rp) - 1
    plan = pk.tile_plan(torch.from_numpy(rp.astype(np.int32)), E)
    rng = np.random.default_rng(5)
    rpt = torch.from_numpy(rp.astype(np.int32))
    for kind in ("exact", "random"):
        c = (rng.integers(-8, 9, size=E) if kind == "exact"
             else rng.random(E)).astype(np.float32)
        got = _tile_sums(plan, rp, c)
        want = pk.scatter_table(rpt, torch.from_numpy(c)).numpy()
        if kind == "exact":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-8,
                                       rtol=1e-4 if name == "hub" else 1e-5)


def test_tile_plan_is_pure_and_made_once_per_graph(monkeypatch):
    """The plan is a function of ``row_ptr`` and E alone, and
    ``prepare_device_edges`` makes one per shard; the iterations reuse
    it and make none."""
    from tpu_distalg_torch.models import pagerank
    from tpu_distalg_torch.parallel import get_mesh

    rp, E = _plan_case("hub")
    rpt = torch.from_numpy(rp.astype(np.int32))
    a, b = pk.tile_plan(rpt, E), pk.tile_plan(rpt.clone(), E)
    assert (a.n_rows, a.n_edges, a.items) == (b.n_rows, b.n_edges, b.items)
    assert torch.equal(a.rows_before, b.rows_before)
    mesh = get_mesh(data=3, device="cpu")
    el = gops.prepare_edges(_random_edges(500, 4001, 9), 500)
    de = pagerank.prepare_device_edges(el, mesh)
    assert len(de.plans) == 3
    for (rps, src, _), plan in zip(de.shards, de.plans):
        want = pk.tile_plan(rps, src.shape[0])
        assert torch.equal(plan.rows_before, want.rows_before)
    made = []
    monkeypatch.setattr(pk, "tile_plan", lambda *a: made.append(a))
    for mode, scatter in (("standard", "auto"), ("standard", "pallas"),
                          ("reference", "auto")):
        pagerank.make_run_fn(mesh, pagerank.PageRankConfig(
            n_iterations=3, mode=mode, scatter=scatter), 500)(de)
    assert made == []
