"""The port's partition-rule engine (``tpu_distalg_torch/parallel/
partition.py``) against the JAX package's (``tpu_distalg/parallel/
partition.py``), as JAX ``tests/test_partition.py:41-266`` holds it:

  * rule matching (first match wins, scalars replicate, an unmatched
    leaf is an error) and every registered table, rule for rule;
  * reshard ≡ host gather + put for every pair in ``RESHARD_PAIRS``,
    values unchanged;
  * the wire accounting's closed forms, and ``reshard_stats`` equal to
    the JAX package's, integer for integer, on 1×4, 2×2 and 2×4;
  * the uneven pad-reshard-slice round trip, bitwise;
  * the shard views equal the JAX package's addressable shards;
  * the ``reshard.*`` counters, read by the JAX package's report;
  * the table placement of ``parallel/sharding.py`` equal to the former
    hand layout, view for view, and every trainer moved onto the tables
    equal to itself fed that layout, bit for bit.

Everything here is exact: the engine moves and pads values, it never
computes with them.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P
from tpu_distalg.parallel import get_mesh as jax_mesh
from tpu_distalg.parallel import partition as jpt
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.parallel import partition as pt
from tpu_distalg_torch.parallel import sharding
from tpu_distalg_torch.telemetry import events
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

SHAPES = [(1, 4), (2, 2), (2, 4)]


def _meshes(data, model):
    return (get_mesh(data, model, device="cpu"),
            jax_mesh(data=data, model=model,
                     devices=jax.devices()[:data * model]))


def _pair_tree(src_name: str):
    """A tree whose leaves both tables of a registered pair name, shapes
    divisible by every axis of the 2×2 mesh."""
    rng = np.random.default_rng(7)
    if src_name.startswith("als"):
        return {"U": rng.standard_normal((8, 4)).astype(np.float32),
                "V": rng.standard_normal((8, 4)).astype(np.float32)}
    return {"X_data": rng.standard_normal((8, 8)).astype(np.float32),
            "w": rng.standard_normal((8,)).astype(np.float32),
            "res": rng.standard_normal((4, 8)).astype(np.float32)}


# ------------------------------------------------------- rule matching


def test_rule_match_first_wins_and_nested_state():
    tbl = pt.RuleTable("t", (
        (r"inner/.*/mu$", ("data", None)),
        (r"^w$", ()),
        (r".*", ("data",)),
    ))
    tree = {"w": np.zeros((4, 4)),
            "inner": [{"mu": np.zeros((8, 2)), "nu": np.zeros((8,))}],
            "step": np.int32(3)}
    specs = pt.match_partition_rules(tbl, tree)
    assert specs["w"] == ()
    assert specs["inner"][0]["mu"] == ("data", None)
    assert specs["inner"][0]["nu"] == ("data",)   # the catch-all
    assert specs["step"] == ()                    # scalar short-circuit
    assert [n for n, _ in pt.named_leaves(tree)] == [
        n for n, _ in jpt.named_leaves(tree)]


def test_scalar_and_size_one_leaves_replicate():
    tbl = pt.RuleTable("t", ((r"^x$", ("data",)),))
    specs = pt.match_partition_rules(
        tbl, {"x": np.zeros(()), "y": torch.zeros((1,))})
    assert specs == {"x": (), "y": ()}


def test_unmatched_leaf_is_hard_error():
    tbl = pt.RuleTable("t", ((r"^known$", ("data",)),))
    with pytest.raises(pt.PartitionRuleError) as ei:
        pt.match_partition_rules(tbl, {"mystery": np.zeros((4, 4))})
    assert "mystery" in str(ei.value) and "'t'" in str(ei.value)


def test_unknown_table_and_duplicate_register():
    with pytest.raises(pt.PartitionRuleError, match="unknown rule table"):
        pt.table("no_such_table")
    with pytest.raises(pt.PartitionRuleError, match="already registered"):
        pt.register(pt.RuleTable("ssgd", ()))


def test_specs_equal_strips_trailing_none():
    assert pt.specs_equal(("data",), ("data", None))
    assert not pt.specs_equal(("data",), (None, "data"))


def test_every_table_of_the_jax_package_is_registered_rule_for_rule():
    assert pt.registered() == jpt.registered()
    for name in pt.registered():
        mine, ref = pt.table(name).rules, jpt.table(name).rules
        assert [(p, tuple(s)) for p, s in mine] == \
            [(p, tuple(s)) for p, s in ref], name
    assert pt.RESHARD_PAIRS == jpt.RESHARD_PAIRS


# ------------------------------------------------ reshard ≡ gather+put


def test_reshard_equals_host_gather_put_every_registered_pair():
    mesh = get_mesh(2, 2, device="cpu")
    for src, dst in pt.RESHARD_PAIRS:
        tree = _pair_tree(src)
        placed = pt.place(tree, src, mesh)
        dev = pt.reshard(placed, src, dst, mesh, emit=False)
        host = pt.host_gather_reshard(placed, dst, mesh)
        for name, _ in pt.named_leaves(tree):
            a, b = dev[name].numpy(), host[name].numpy()
            assert a.tobytes() == b.tobytes(), (src, dst, name)
            assert a.tobytes() == tree[name].tobytes(), (src, dst, name)
            pt.constrain(dev[name], name, dst, mesh)


def test_place_passes_through_placed_leaves():
    mesh = get_mesh(2, 2, device="cpu")
    tree = _pair_tree("als_train")
    placed = pt.place(tree, "als_train", mesh)
    again = pt.place(placed, "als_train", mesh)
    assert again["U"] is placed["U"] and again["V"] is placed["V"]
    assert placed["U"].numpy().tobytes() == tree["U"].tobytes()
    assert pt.gather(placed)["V"].tobytes() == tree["V"].tobytes()


@pytest.mark.parametrize("data,model", [(2, 1), (2, 2), (2, 4)])
@pytest.mark.parametrize("tbl,leaf,by_model", [
    ("lr", "X", False), ("ssgd", "X", False), ("local_sgd", "X", False),
    ("kmeans", "points", False), ("ssgd_tp", "X", True),
    ("ssgd_feature_sharded", "X", True)])
def test_hand_placement_matches_its_table(tbl, leaf, by_model, data,
                                          model):
    """The table placement (``parallel/sharding.py``'s thin callers of
    the engine) gives each shard the block the former hand placement
    gave it: rows zero-padded to a multiple of the data shards, shard s
    the s-th equal slice; under the model axis, contiguous column
    slices."""
    mesh = get_mesh(data, model, device="cpu")
    rng = np.random.default_rng(3)
    X = rng.standard_normal((13, 12)).astype(np.float32)
    Xs = sharding.parallelize(X, mesh, table=tbl, leaf=leaf)
    n_pad = (-13) % data
    former = torch.from_numpy(np.pad(X, ((0, n_pad), (0, 0))))
    former_mask = torch.from_numpy((np.arange(13 + n_pad) < 13).astype(
        np.float32))
    assert Xs.n_padded == 13 + n_pad and torch.equal(Xs.data, former)
    n_local = Xs.n_padded // data
    spec = pt.table(tbl).spec_for(leaf, tuple(Xs.data.shape))
    views = pt.shards(Xs.data, spec, mesh)
    mviews = pt.shards(Xs.mask, pt.table(tbl).spec_for(
        "mask", tuple(Xs.mask.shape)), mesh)
    cols = sharding.shard_features(Xs.data, model) if by_model else None
    d_l = 12 // model
    for s in range(data):
        rows = slice(s * n_local, (s + 1) * n_local)
        for m in range(model):
            want = former[rows, m * d_l:(m + 1) * d_l] if by_model \
                else former[rows]
            assert torch.equal(views[s][m], want), (tbl, s, m)
            if by_model:
                assert torch.equal(cols[m][rows], want), (tbl, s, m)
            assert torch.equal(mviews[s][m], former_mask[rows]), (tbl, s, m)


def _former_rows(X, n_shards, dtype=torch.float32):
    """The former hand placement: rows zero-padded to a multiple of the
    shards, the padded array and its mask on the CPU."""
    X = np.asarray(X)
    n_pad = (-X.shape[0]) % n_shards
    padded = np.pad(X, [(0, n_pad)] + [(0, 0)] * (X.ndim - 1))
    mask = (np.arange(X.shape[0] + n_pad) < X.shape[0]).astype(np.float32)
    return (torch.from_numpy(np.ascontiguousarray(padded)).to(dtype),
            torch.from_numpy(mask))


def _former_trainer_run(name, mesh, data):
    """``name``'s trainer fed the former hand layout → its weights (or
    centres, or ranks)."""
    from tpu_distalg_torch.models import (
        kmeans,
        local_sgd,
        logistic_regression,
        ssgd,
    )
    from tpu_distalg_torch.ops import logistic, ssgd_kernels
    from tpu_distalg_torch.utils import prng

    X, S = data[0], mesh.n_data
    if name == "kmeans":
        cfg = kmeans.KMeansConfig(k=3, n_iterations=4)
        Xt, mask = _former_rows(X, S)
        return kmeans.make_fit_fn(mesh, cfg)(
            Xt, mask, kmeans.init_centers(X, 3, cfg.seed))[0]
    if name == "pagerank":
        return _former_pagerank(X, mesh)
    X, y, X_te, y_te = data
    Xt, mask = _former_rows(X, S)
    yt, _ = _former_rows(np.asarray(y, np.float32), S)
    X_te_t = torch.from_numpy(np.asarray(X_te, np.float32))
    y_te_t = torch.from_numpy(np.asarray(y_te, np.float32))
    w0 = logistic.init_weights(prng.root_key(7, mesh.device), X.shape[1])
    if name == "lr":
        cfg = logistic_regression.LRConfig(n_iterations=20)
        return logistic_regression.make_train_fn(mesh, cfg)(
            Xt, yt, mask, X_te_t, y_te_t, w0)[0]
    if name in ("ssgd_bernoulli", "ssgd_fixed"):
        cfg = ssgd.SSGDConfig(n_iterations=20, sampler=name[5:])
        return ssgd.make_train_fn(mesh, cfg, Xt.shape[0])(
            Xt, yt, mask, X_te_t, y_te_t, w0)[0]
    if name in ("ssgd_fused_gather", "ssgd_fused"):
        cfg = ssgd.SSGDConfig(n_iterations=20, sampler=name[5:],
                              fused_pack=4, gather_block_rows=32,
                              fused_block_rows=64, shuffle_seed=0)
        block = 32 if name == "ssgd_fused_gather" else 64
        X2, meta = ssgd_kernels.pack_augmented(
            np.asarray(X), np.asarray(y), np.ones(X.shape[0], np.float32),
            dtype="float32", pack=4, block_rows=block * S, shuffle_seed=0,
            device="cpu")
        w = torch.zeros((meta["d_total"],))
        w[:X.shape[1]] = w0
        X_te_p = torch.from_numpy(np.pad(
            np.asarray(X_te, np.float32),
            ((0, 0), (0, meta["d_total"] - X.shape[1]))))
        return ssgd.make_train_fn_fused(mesh, cfg, meta)(
            X2, None, None, X_te_p, y_te_t, w)[0][:X.shape[1]]
    if name == "ssgd_tp":
        cfg = ssgd.SSGDConfig(n_iterations=20, feature_sharded=True)
        M = mesh.n_model
        Xp = np.pad(np.asarray(X, np.float32),
                    ((0, 0), (0, (-X.shape[1]) % M)))
        Xf, mask = _former_rows(Xp, S)
        Xsl = Xf.reshape(Xf.shape[0], M, -1).transpose(0, 1).contiguous()
        X_te_p = torch.from_numpy(np.pad(
            np.asarray(X_te, np.float32), ((0, 0), (0, Xp.shape[1] -
                                                    X.shape[1]))))
        w = logistic.init_weights(prng.root_key(7, mesh.device),
                                  Xp.shape[1])
        return ssgd.make_train_fn(mesh, cfg, Xf.shape[0])(
            Xsl, yt, mask, X_te_p, y_te_t, w)[0][:X.shape[1]]
    assert name == "local_sgd"
    cfg = local_sgd.LocalSGDConfig(n_iterations=3)
    st = local_sgd.init_state(cfg, X.shape[1], X.shape[1], S, mesh.device)
    return local_sgd.make_train_fn(mesh, cfg, Xt.shape[0])(
        Xt, yt, mask, X_te_t, y_te_t, *st)[0]


def _former_pagerank(edges, mesh):
    """PageRank on the former hand layout: the whole dst-sorted edge
    list on the device, each shard a view of its slice."""
    from tpu_distalg_torch.models import pagerank
    from tpu_distalg_torch.ops import graph as gops
    from tpu_distalg_torch.ops import pagerank_kernels as pk

    S = mesh.n_data
    cfg = pagerank.PageRankConfig(n_iterations=5, mode="standard")
    el = gops.prepare_edges(edges, None)
    plan = pk.plan_csr(el, S)
    src, w_e = torch.from_numpy(plan.src), torch.from_numpy(plan.w_e)
    shards = [(torch.from_numpy(plan.shard_row_ptr(s)), src[lo:hi],
               w_e[lo:hi]) for s, (lo, hi) in enumerate(plan.bounds)]
    has_out = (el.out_degree > 0).astype(np.float32)
    de = pagerank.DeviceEdges(
        shards=shards, plans=[pk.tile_plan(rp, s_.shape[0])
                              for rp, s_, _ in shards],
        has_out=torch.from_numpy(has_out), n_vertices=el.n_vertices,
        n_edges=el.n_edges, n_ref=float(has_out.sum()))
    return pagerank.run_prepared(de, mesh, cfg).ranks


def _table_trainer_run(name, mesh, data):
    """``name``'s public entry point, placing by the rule tables."""
    from tpu_distalg_torch.models import (
        kmeans,
        local_sgd,
        logistic_regression,
        pagerank,
        ssgd,
    )

    X = data[0]
    if name == "kmeans":
        return kmeans.fit(X, mesh, kmeans.KMeansConfig(k=3,
                                                       n_iterations=4)).centers
    if name == "pagerank":
        return pagerank.run(X, mesh, pagerank.PageRankConfig(
            n_iterations=5, mode="standard")).ranks
    X, y, X_te, y_te = data
    if name == "lr":
        return logistic_regression.train(
            X, y, X_te, y_te, mesh,
            logistic_regression.LRConfig(n_iterations=20)).w
    if name.startswith("ssgd"):
        fields = dict(feature_sharded=True) if name == "ssgd_tp" else dict(
            sampler=name[5:], fused_pack=4, gather_block_rows=32,
            fused_block_rows=64, shuffle_seed=0, x_dtype="float32")
        return ssgd.train(X, y, X_te, y_te, mesh,
                          ssgd.SSGDConfig(n_iterations=20, **fields)).w
    return local_sgd.train(X, y, X_te, y_te, mesh,
                           local_sgd.LocalSGDConfig(n_iterations=3)).w


@pytest.mark.parametrize("name,shape", [
    ("lr", (4, 1)), ("ssgd_bernoulli", (4, 1)), ("ssgd_fixed", (4, 1)),
    ("ssgd_fused_gather", (4, 1)), ("ssgd_fused", (4, 1)),
    ("ssgd_tp", (2, 2)), ("local_sgd", (4, 1)), ("kmeans", (3, 1)),
    ("pagerank", (3, 1))])
def test_table_placement_trains_as_the_former_hand_layout(name, shape):
    """Each trainer moved onto the tables, on one process, equals the
    same trainer fed the former hand layout bit for bit: the move
    changes where a layout is written down, not what it is. Small
    shapes: 77 rows of 5 features (odd, so the rows pad), a 60-point
    mixture, a 40-vertex graph of 200 edges (uneven over 3 shards)."""
    import warnings

    mesh = get_mesh(*shape, device="cpu")
    rng = np.random.default_rng(11)
    if name == "pagerank":
        data = (rng.integers(0, 40, size=(200, 2)).astype(np.int64),)
    elif name == "kmeans":
        data = (rng.standard_normal((61, 3)).astype(np.float32) * 3,)
    else:
        X = rng.standard_normal((77, 5)).astype(np.float32)
        y = (X[:, 0] + 0.3 * rng.standard_normal(77) > 0).astype(np.float32)
        data = (X, y, X[:20], y[:20])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # coarse-fraction geometry warn
        got = _table_trainer_run(name, mesh, data)
        want = _former_trainer_run(name, mesh, data)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.numpy().tobytes() == want.numpy().tobytes()


def test_put_and_constrain_refuse_an_uneven_layout():
    mesh = get_mesh(2, 4, device="cpu")
    assert pt.put(np.zeros((8, 3), np.float32), "V", "als_train",
                  mesh).shape == (8, 3)
    with pytest.raises(pt.PartitionRuleError, match="evenly"):
        pt.put(np.zeros((10, 3), np.float32), "V", "als_train", mesh)
    with pytest.raises(pt.PartitionRuleError, match="pad it first"):
        pt.shards(torch.zeros((10, 3)), ("model", None), mesh)


# -------------------------------------------------- wire accounting


def test_wire_accounting_closed_form():
    mesh4, mesh22, mesh24 = (get_mesh(4, 1, device="cpu"),
                             get_mesh(2, 2, device="cpu"),
                             get_mesh(2, 4, device="cpu"))
    B = 8 * 4 * 4  # bytes of an (8, 4) f32 leaf
    st = pt.reshard_stats({"U": np.zeros((8, 4), np.float32)},
                          "als_train", "als_serve", mesh4)
    leaf = st["leaves"]["U"]
    assert leaf["op"] == "all_gather"
    assert leaf["bytes_wire"] == int(B * 3 / 4)
    assert leaf["bytes_host_roundtrip"] == 2 * B
    st = pt.reshard_stats({"V": torch.zeros((8, 4))},
                          "als_serve", "als_train", mesh22)
    assert st["leaves"]["V"]["op"] == "noop"
    st = pt.reshard_stats({"U": np.zeros((8, 4), np.float32)},
                          "als_serve", "als_train", mesh22)
    assert st["leaves"]["U"]["op"] == "slice"
    assert st["leaves"]["U"]["bytes_wire"] == 0
    nb = 8 * 8 * 4
    plan = pt._leaf_plan((8, 8), np.float32, ("data", None),
                         (None, "data"), mesh4)
    assert plan["op"] == "all_to_all"
    assert plan["bytes_wire"] == int(round((nb / 4) * 3 / 4))
    plan = pt._leaf_plan((8, 8), torch.float32, ("data", None),
                         ("model", None), mesh22)
    assert plan["op"] == "all_to_all"
    plan = pt._leaf_plan((8, 8), np.float32, ("data", None),
                         ("model", None), mesh24)
    assert plan["op"] == "gather_slice"
    assert plan["bytes_wire"] == int(round(nb * 1 / 2))


def _stats_trees():
    """Trees whose accounting the two packages must agree on: the
    registered pairs', the serving shape's factors (uneven V), a
    previously padded leaf, and int32 and float16 leaves."""
    rng = np.random.default_rng(3)
    return [("als_train", "als_serve", _pair_tree("als_train"), None),
           ("als_serve", "als_train", _pair_tree("als_serve"), None),
           ("ssgd_feature_sharded", "ssgd", _pair_tree("ssgd"), None),
           ("ssgd", "ssgd_feature_sharded", _pair_tree("ssgd"), None),
           ("als_train", "als_serve",
            {"U": np.zeros((4096, 64), np.float32),
             "V": np.zeros((16383, 64), np.float32)}, None),
           ("lr", "lr", {"res": np.zeros((10, 3), np.float32),
                         "w": np.zeros((5,), np.float32),
                         "y": np.zeros((9,), np.int32)}, None),
           ("lr", "lr", {"res": np.zeros((12, 3), np.float32)},
            {"res": (10, 3)}),
           ("kmeans", "kmeans",
            {"points": rng.random((7, 2)).astype(np.float16),
             "centers": np.zeros((3, 2), np.float32)}, None)]


@pytest.mark.parametrize("data,model", SHAPES)
def test_reshard_stats_equal_the_jax_package(data, model):
    mine_mesh, jax_m = _meshes(data, model)
    for src, dst, tree, true in _stats_trees():
        mine = pt.reshard_stats(tree, src, dst, mine_mesh, true_shapes=true)
        ref = jpt.reshard_stats(tree, src, dst, jax_m, true_shapes=true)
        assert mine == ref, (src, dst, sorted(tree))
        torch_tree = {k: torch.as_tensor(v) for k, v in tree.items()}
        assert pt.reshard_stats(torch_tree, src, dst, mine_mesh,
                                true_shapes=true) == ref


def test_uneven_dst_pad_reshard_slice_round_trip():
    mesh4 = get_mesh(4, 1, device="cpu")
    tree = {"res": np.arange(10 * 3, dtype=np.float32).reshape(10, 3),
            "w": np.arange(5, dtype=np.float32)}
    st = pt.reshard_stats(tree, "lr", "lr", mesh4)
    leaf = st["leaves"]["res"]
    assert leaf["pad"] == (2, 0)
    assert leaf["padded_shape"] == (12, 3)
    assert leaf["bytes_padding"] == st["bytes_padding"] == 2 * 3 * 4
    assert leaf["bytes_logical"] == 12 * 3 * 4
    out = pt.reshard(tree, "lr", "lr", mesh4, emit=False)
    assert out["res"].shape == (12, 3)
    assert np.array_equal(out["res"].numpy()[:10], tree["res"])
    assert not out["res"].numpy()[10:].any()
    hb = pt.host_gather_reshard(tree, "lr", mesh4)
    assert hb["res"].numpy().tobytes() == out["res"].numpy().tobytes()
    repl = pt.RuleTable("repl_scratch", ((r".*", ()),))
    back = pt.reshard(out, "lr", repl, mesh4, emit=False,
                      true_shapes={"res": (10, 3)})
    assert back["res"].shape == (10, 3)
    assert back["res"].numpy().tobytes() == tree["res"].tobytes()
    assert back["w"].numpy().tobytes() == tree["w"].tobytes()
    bst = pt.reshard_stats(out, "lr", repl, mesh4,
                           true_shapes={"res": (10, 3)})
    assert bst["leaves"]["res"]["true_shape"] == (10, 3)
    st2 = pt.reshard_stats({"res": np.zeros((8, 3), np.float32)},
                           "lr", "lr", mesh4)
    assert "pad" not in st2["leaves"]["res"]
    assert st2["bytes_padding"] == 0
    assert st2["leaves"]["res"]["op"] == "noop"


def test_uneven_pad_amounts_and_scalars():
    mine, ref = _meshes(2, 4)
    for shape, spec in (((10, 3), ("data", None)), ((10, 3), ("model", None)),
                        ((7,), (("data", "model"),)), ((), ())):
        assert pt.pad_amounts(shape, spec, mine) == \
            jpt.pad_amounts(shape, P(*spec), ref)
        assert pt.spec_shards(spec, mine) == jpt.spec_shards(P(*spec), ref)
    assert pt.pad_amounts((10, 3), ("model", None), mine) == (2, 0)
    assert pt.pad_amounts((7,), (("data", "model"),), mine) == (1,)


def test_size_one_axis_spellings_are_noops():
    st = pt.reshard_stats({"X_data": np.zeros((8, 8), np.float32),
                          "w": np.zeros((8,), np.float32)},
                         "ssgd_feature_sharded", "ssgd",
                         get_mesh(4, 1, device="cpu"))
    assert st["leaves"]["X_data"]["op"] == "noop"
    assert st["leaves"]["w"]["op"] == "noop"
    assert st["bytes_wire"] == 0 and st["n_moved"] == 0


# ------------------------------------------------------- shard views


@pytest.mark.parametrize("data,model", [(1, 4), (4, 1), (2, 2), (2, 4)])
def test_shard_views_equal_the_jax_package_shards(data, model):
    """Shard (s, m)'s view of each ``ssgd_tp`` and ``als_serve`` leaf
    equals what the JAX package places on the device at mesh position
    (s, m), and is a view of the placed tensor, not a copy."""
    mine_mesh, jax_m = _meshes(data, model)
    tree = {"X2": np.arange(64, dtype=np.float32).reshape(8, 8),
            "w": np.arange(8, dtype=np.float32)}
    for tbl, t in (("ssgd_tp", tree),
                   ("als_serve", _pair_tree("als_serve"))):
        placed = pt.place(t, tbl, mine_mesh)
        ref = jpt.place(t, tbl, jax_m)
        for name, x in placed.items():
            views = pt.shards(x, pt.table(tbl).spec_for(name, x.shape),
                              mine_mesh)
            for sh in ref[name].addressable_shards:
                s, m = (int(c[0]) for c in np.nonzero(
                    jax_m.devices == sh.device))
                assert views[s][m].numpy().tobytes() == \
                    np.asarray(sh.data).tobytes(), (tbl, name, s, m)
                assert views[s][m].untyped_storage().data_ptr() == \
                    x.untyped_storage().data_ptr()


@pytest.mark.parametrize("process_index", [0, 1])
def test_data_block_and_local_block_are_the_engines_cut(process_index):
    """Process p of two, holding data shards 2p and 2p+1 of 4 (its mesh
    made as a rank's, no group is needed): ``local_block`` of a draw
    over every row keeps the rows ``put`` keeps, ``data_block`` gives a
    held shard the view ``shards`` gives it, along dim 0 or dim 1 (the
    block draws' shard axis), and a shard of the other process is
    refused. Two processes of two shards are the fewest in which a
    held shard's place differs from its global id."""
    from tpu_distalg_torch.parallel import DATA_AXIS, Mesh

    mesh = Mesh(n_data=4, device=torch.device("cpu"),
                process_index=process_index, process_count=2)
    lo = 2 * process_index
    u = torch.arange(16, dtype=torch.float32)
    mine = pt.local_block(u, (DATA_AXIS,), mesh)
    assert torch.equal(mine, pt.put(u.numpy(), "y", "ssgd", mesh))
    assert torch.equal(mine, u[4 * lo:4 * lo + 8])
    views = pt.shards(mine, (DATA_AXIS,), mesh)
    ids = torch.arange(24).reshape(2, 4, 3)
    held = pt.local_block(ids, (None, DATA_AXIS), mesh)
    assert torch.equal(held, ids[:, lo:lo + 2])
    for s in mesh.local_data:
        assert pt.held_index(s, mesh) == s - lo
        got = pt.data_block(mine, s, mesh)
        assert torch.equal(got, views[s][0])
        assert got.data_ptr() == views[s][0].data_ptr()
        assert torch.equal(pt.data_block(held, s, mesh, dim=1),
                           ids[:, s:s + 1])
    with pytest.raises(ValueError, match="not held"):
        pt.held_index(2 - lo, mesh)


# ---------------------------------------------------------- counters


def test_reshard_emits_counters_the_jax_report_reads(tmp_path):
    from tpu_distalg.telemetry import report

    d = str(tmp_path / "tel")
    sink = events.configure(d)
    try:
        mesh = get_mesh(2, 2, device="cpu")
        placed = pt.place(_pair_tree("als_train"), "als_train", mesh)
        pt.reshard(placed, "als_train", "als_serve", mesh)
        counters = sink.counters()
    finally:
        events.configure(False)
    st = pt.reshard_stats(placed, "als_train", "als_serve", mesh)
    assert counters["reshard.syncs"] == 1
    assert counters["reshard.bytes_wire"] == st["bytes_wire"] > 0
    assert counters["reshard.leaves"] == st["n_moved"]
    s = report.summarize(report.load_events(d))
    assert s["counters"]["reshard.syncs"] == 1
    text = report.render(s)
    assert "reshard:" in text and "host round-trip avoided" in text
