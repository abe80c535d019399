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
  * the hand placement of ``parallel/sharding.py`` equal to the views
    its table names.

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
    """The trainers that still place by hand (``parallel/sharding.py``)
    give each shard the block their table names: rows over data by
    ``parallelize``, and columns over model by ``shard_features``."""
    mesh = get_mesh(data, model, device="cpu")
    rng = np.random.default_rng(3)
    X = rng.standard_normal((13, 12)).astype(np.float32)
    Xs = sharding.parallelize(X, mesh)
    n_local = Xs.n_padded // data
    spec = pt.table(tbl).spec_for(leaf, tuple(Xs.data.shape))
    views = pt.shards(Xs.data, spec, mesh)
    mviews = pt.shards(Xs.mask, pt.table(tbl).spec_for(
        "mask", tuple(Xs.mask.shape)), mesh)
    cols = sharding.shard_features(Xs.data, model) if by_model else None
    for s in range(data):
        rows = slice(s * n_local, (s + 1) * n_local)
        for m in range(model):
            want = cols[m][rows] if by_model else Xs.data[rows]
            assert torch.equal(views[s][m], want), (tbl, s, m)
            assert torch.equal(mviews[s][m], Xs.mask[rows]), (tbl, s, m)


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
