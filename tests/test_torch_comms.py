"""The port's sync schedules (``tpu_distalg_torch/parallel/comms.py``)
against the JAX package's ``parallel/comms.py`` on the CPU.

The JAX side runs each schedule under ``shard_map`` on the conftest's
host devices; the port runs the same arithmetic over a shard-major stack.
The schedules are sums in a fixed order, so the standard is bitwise
wherever XLA and torch round the same way: ``int8`` and ``topk`` are
held bitwise (outputs, residuals, chosen indices), and so, measured,
are ``dense``, ``bucketed``, ``hier`` and ``bf16`` (XLA divides by a
constant as a product with its float32 reciprocal and adds bf16 values
in float32 before one rounding; the port writes both the same way).
The byte accounting, the spellings and the host codecs are compared
exactly.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_distalg.parallel import comms as jcomms
from tpu_distalg.parallel import data_parallel
from tpu_distalg.parallel import get_mesh as jget_mesh
from tpu_distalg_torch.parallel import comms, get_mesh
from tpu_distalg_torch.telemetry import events
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

SCHEDULES = ("dense", "bucketed", "bucketed:64", "hier", "hier:2", "bf16",
             "int8", "int8:5:300", "int8@seq", "topk", "topk:0.05")


@pytest.fixture(autouse=True)
def _clean():
    yield
    events.configure(False)


def _jreduce(mesh, sched, gs, cnts, t, *, mean=False, res=None):
    """One JAX sync of (grad, count) → (sum, count, residual)."""
    example = (jax.ShapeDtypeStruct(gs.shape[1:], jnp.float32),
               jax.ShapeDtypeStruct((), jnp.float32))
    sync = jcomms.make_sync(sched, mesh, example)

    def body(g, c, r, tt):
        f = sync.reduce_mean if mean else sync.reduce
        (gg, cc), rr = f((g[0], c[0]), r, tt)
        return gg, cc, rr

    fn = data_parallel(
        body, mesh,
        in_specs=(P("data", None), P("data"), P("data", None), P()),
        out_specs=(P(), P(), P("data", None)))
    r0 = sync.init_state() if res is None else res
    out = jax.jit(fn)(
        jax.device_put(gs, NamedSharding(mesh, P("data", None))),
        jax.device_put(cnts, NamedSharding(mesh, P("data"))),
        jax.device_put(jnp.asarray(r0), NamedSharding(mesh, P("data", None))),
        jnp.int32(t))
    return tuple(np.asarray(x) for x in out)


def _preduce(n, sched, gs, cnts, t, *, mean=False, res=None, compute=None):
    sync = comms.make_sync(sched, get_mesh(n, device="cpu"),
                           (comms.leaf(gs.shape[1:]), comms.leaf(())))
    r0 = torch.from_numpy(sync.init_state() if res is None else res)
    per = [(torch.from_numpy(gs[s]), torch.tensor(cnts[s])) for s in range(n)]
    f = sync.reduce_mean if mean else sync.reduce
    out = f(per, r0, t, compute=compute) if compute else f(per, r0, t)
    (g, c), r = out[0], out[1]
    return (g.numpy(), c.numpy(), r.numpy()) + tuple(out[2:])


def _mesh(n):
    return jget_mesh(data=n, devices=jax.devices()[:n])


# ------------------------------------------------------------ spellings


SPELLINGS = ("dense", "", None, "topk:0.05", "bucketed:1024", "hier:2",
             "int8:9", "int8:9:128", "int8@seq", "bucketed:64@seq",
             "topk:0.05@seq", "int8@ov", "hier", "bf16")


@pytest.mark.parametrize("text", SPELLINGS)
def test_comm_spec_parse_equals_jax(text):
    want = jcomms.CommSpec.parse(text)
    got = comms.CommSpec.parse(text)
    for f in ("schedule", "bucket_elems", "topk_fraction", "hier_groups",
              "seed", "overlap"):
        assert getattr(got, f) == getattr(want, f), (text, f)
    assert got.stateful == want.stateful
    assert comms.CommSpec.parse(got) is got


@pytest.mark.parametrize("text", ["zstd", "dense:4", "topk:0", "int8seq",
                                  "bucketed:0", "topk:1.5"])
def test_comm_spec_errors_in_jax_words(text):
    with pytest.raises(ValueError) as want:
        jcomms.CommSpec.parse(text)
    with pytest.raises(ValueError) as got:
        comms.CommSpec.parse(text)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------- byte accounting


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("sched", ["dense", "bucketed", "bucketed:7", "hier",
                                   "hier:2", "bf16", "int8", "int8:0:5",
                                   "topk", "topk:0.3"])
def test_stats_equal_jax(n, sched):
    """``CommSync.stats`` and ``schedule_stats`` equal JAX's integers,
    at odd sizes and with many buckets."""
    if sched == "hier:2" and n % 2:
        ex = (jax.ShapeDtypeStruct((8,), jnp.float32),)
        with pytest.raises(ValueError) as want:
            jcomms.make_sync(sched, _mesh(n), ex)
        with pytest.raises(ValueError) as got:
            comms.make_sync(sched, get_mesh(n, device="cpu"),
                            (comms.leaf((8,)),))
        assert str(got.value) == str(want.value)
        return
    for d, extra in ((126, ((),)), (257, ((), (3,))), (1, ((),)),
                     (70001, ((),))):
        jex = (jax.ShapeDtypeStruct((d,), jnp.float32),) + tuple(
            jax.ShapeDtypeStruct(s, jnp.float32) for s in extra)
        pex = (comms.leaf((d,)),) + tuple(comms.leaf(s) for s in extra)
        want = jcomms.make_sync(sched, _mesh(n), jex).stats()
        got = comms.make_sync(sched, get_mesh(n, device="cpu"), pex).stats()
        assert got == want, (n, sched, d)
    spec = comms.CommSpec.parse(sched)
    kw = dict(n_shards=n, compressible_elems=1000, dense_elems=2,
              bucket_elems=spec.bucket_elems,
              topk_fraction=spec.topk_fraction, groups=spec.hier_groups or 1)
    assert comms.schedule_stats(spec.schedule, **kw) == \
        jcomms.schedule_stats(spec.schedule, **kw)


@pytest.mark.parametrize("n", [4, 8])
def test_infer_groups_and_hier_refusal_equal_jax(n):
    assert comms.infer_groups(get_mesh(n, device="cpu")) == \
        jcomms.infer_groups(_mesh(n))
    ex = (jax.ShapeDtypeStruct((8,), jnp.float32),)
    with pytest.raises(ValueError) as want:
        jcomms.make_sync("hier:3", _mesh(n), ex)
    with pytest.raises(ValueError) as got:
        comms.make_sync("hier:3", get_mesh(n, device="cpu"),
                        (comms.leaf((8,)),))
    assert str(got.value) == str(want.value)


def test_rank_combine_stats_equal_jax():
    for k, length, n in ((3, 40, 4), (100, 1 << 20, 8), (0, 5, 1)):
        assert comms.rank_combine_stats(k, length, n) == \
            jcomms.rank_combine_stats(k, length, n)


# -------------------------------------------------------------- reduce


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_reduce_equals_jax(n, sched):
    """One sync, sum and mean, on equal per-shard inputs at 126 and
    4,001 elements, and 70,001 for the default 65,536-element buckets
    (two of them): int8 and topk (outputs, residuals) bitwise; dense,
    bucketed and hier within 1e-6 of max|·|, bf16 within a bf16 ulp of
    max|·| (2⁻⁸), as stated — they are bitwise too on this jaxlib."""
    rng = np.random.default_rng(n)
    two_buckets = sched in ("bucketed", "int8", "int8@seq")
    for d in (126, 4001) + ((70001,) if two_buckets else ()):
        gs = rng.standard_normal((n, d)).astype(np.float32)
        cnts = rng.integers(1, 50, n).astype(np.float32)
        for mean in (False, True):
            want = _jreduce(_mesh(n), sched, gs, cnts, 3, mean=mean)
            got = _preduce(n, sched, gs, cnts, 3, mean=mean)
            name = comms.CommSpec.parse(sched).schedule
            if name in ("int8", "topk"):
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b, err_msg=sched)
                continue
            tol = 2.0 ** -8 if name == "bf16" else 1e-6
            np.testing.assert_allclose(
                got[0], want[0], rtol=0,
                atol=tol * float(np.abs(want[0]).max()))
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n", [4, 8])
def test_topk_with_residual_and_ties_equal_jax(n):
    """A nonzero residual carried in, and tied magnitudes (lax.top_k
    keeps the lower index): the chosen pairs, the sum and the new
    residual equal JAX's bitwise."""
    rng = np.random.default_rng(7)
    gs = np.round(rng.standard_normal((n, 96)) * 2).astype(np.float32)
    res = rng.standard_normal((n, 96)).astype(np.float32) * 0.25
    cnts = np.ones(n, np.float32)
    want = _jreduce(_mesh(n), "topk:0.1", gs, cnts, 1, res=res)
    got = _preduce(n, "topk:0.1", gs, cnts, 1, res=res)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_int8_noise_varies_with_step_and_seq_equals_overlap():
    """The rounding key folds the step in (t 1 and 2 differ); ``@seq``
    equals the default pipeline bitwise; a replay is bitwise."""
    rng = np.random.default_rng(3)
    gs = rng.standard_normal((4, 257)).astype(np.float32)
    cnts = np.ones(4, np.float32)
    a = _preduce(4, "int8:0:64", gs, cnts, 1)
    b = _preduce(4, "int8:0:64", gs, cnts, 2)
    assert not np.array_equal(a[0], b[0])
    for ov, seq in (("int8:0:64", "int8:0:64@seq"), ("bucketed:64",
                                                     "bucketed:64@seq"),
                    ("topk:0.1", "topk:0.1@seq")):
        x = _preduce(4, ov, gs, cnts, 5)
        y = _preduce(4, seq, gs, cnts, 5)
        z = _preduce(4, ov, gs, cnts, 5)
        for p, q, r in zip(x, y, z):
            np.testing.assert_array_equal(p, q)
            np.testing.assert_array_equal(p, r)


def test_topk_residual_conserves_mass():
    """What each shard sent plus its new residual is its gradient plus
    its old residual; each shard sent at most k entries, and the sum is
    the sum of what was sent."""
    rng = np.random.default_rng(4)
    gs = rng.standard_normal((4, 40)).astype(np.float32)
    got, _, res = _preduce(4, "topk:0.1", gs, np.ones(4, np.float32), 0)
    sent = gs - res
    k = max(1, round(0.1 * 40))
    assert all(int((np.abs(sent[i]) > 0).sum()) <= k for i in range(4))
    np.testing.assert_allclose(got, sent.sum(axis=0), atol=1e-5)


@pytest.mark.parametrize("sched", ["dense", "int8", "bucketed:16",
                                   "topk:0.1", "bf16", "hier"])
def test_compute_thunk_rides_the_sync(sched):
    """``reduce(..., compute=thunk)`` returns the thunk's value as a
    third element and leaves the sum bitwise unchanged."""
    rng = np.random.default_rng(13)
    gs = rng.standard_normal((4, 64)).astype(np.float32)
    cnts = np.ones(4, np.float32)
    plain = _preduce(4, sched, gs, cnts, 2)
    calls = []
    ridden = _preduce(4, sched, gs, cnts, 2,
                      compute=lambda: calls.append(1) or 42)
    assert calls == [1] and ridden[3] == 42
    for a, b in zip(plain, ridden[:3]):
        np.testing.assert_array_equal(a, b)


def test_sparse_allreduce_duplicates_equal_jax():
    """Duplicate indices within one shard and across shards: the port's
    ordered rounds equal JAX's ``.at[].add`` in origin order bitwise."""
    rng = np.random.default_rng(9)
    length, k = 40, 6
    idx = np.array([[0, 5, 5, 5, 39, 0], [1, 5, 39, 39, 2, 2],
                    [2, 0, 7, 7, 7, 7], [39, 39, 3, 0, 0, 5]], np.int32)
    vals = (rng.standard_normal((4, k)) * 10).astype(np.float32)

    def body(v, i):
        return jcomms.sparse_allreduce(v[0], i[0], length)[None, :]

    mesh = _mesh(4)
    fn = data_parallel(body, mesh,
                       in_specs=(P("data", None), P("data", None)),
                       out_specs=P("data", None))
    want = np.asarray(jax.jit(fn)(
        jax.device_put(vals, NamedSharding(mesh, P("data", None))),
        jax.device_put(idx, NamedSharding(mesh, P("data", None)))))[0]
    got = comms.sparse_allreduce(torch.from_numpy(vals),
                                 torch.from_numpy(idx), length)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------- host codecs


@pytest.mark.parametrize("spec", ["int8:3", "topk:0.2"])
def test_host_codecs_equal_jax_bitwise(spec):
    rng = np.random.default_rng(0)
    vec = rng.standard_normal(333).astype(np.float32)
    res = rng.standard_normal(333).astype(np.float32) * 0.1
    pc, jc = comms.make_host_codec(spec), jcomms.make_host_codec(spec)
    for r in (None, res):
        a, ra = pc.encode(vec, r, 1, 4, 9)
        b, rb = jc.encode(vec, r, 1, 4, 9)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
        if r is None:
            assert ra is None and rb is None
        else:
            np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(pc.decode(a, 333), jc.decode(b, 333))
    assert type(comms.make_host_pull_codec(spec)).__name__ == \
        type(jcomms.make_host_pull_codec(spec)).__name__
    assert comms.make_host_codec("dense") is None
    with pytest.raises(ValueError) as want:
        jcomms.make_host_codec("bf16")
    with pytest.raises(ValueError) as got:
        comms.make_host_codec("bf16")
    assert str(got.value) == str(want.value)
    np.testing.assert_array_equal(
        comms.host_rng(5, 1, 2).random(8), jcomms.host_rng(5, 1, 2).random(8))


def test_encode_decode_tree_round_trip():
    """The tree codecs equal JAX's and round-trip: topk at fraction 1
    exactly; int8 within one step of its scale; residuals as JAX's."""
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    for spec in ("topk:1.0", "int8:2"):
        pc, jc = comms.make_host_codec(spec), jcomms.make_host_codec(spec)
        res = comms.zero_residuals(tree)
        for name, z in jcomms.zero_residuals(tree).items():
            np.testing.assert_array_equal(res[name], z)
        arrays, r_new = comms.encode_tree(pc, tree, res, 2, 3)
        j_arrays, j_new = jcomms.encode_tree(jc, tree, res, 2, 3)
        assert sorted(arrays) == sorted(j_arrays)
        for key in arrays:
            np.testing.assert_array_equal(arrays[key], j_arrays[key])
        for name in tree:
            np.testing.assert_array_equal(r_new[name], j_new[name])
        back = comms.decode_tree(pc, arrays, tree)
        for name in tree:
            if spec.startswith("topk"):
                np.testing.assert_array_equal(back[name], tree[name])
            else:
                scale = float(np.abs(tree[name]).max()) / 127
                np.testing.assert_allclose(back[name], tree[name],
                                           atol=scale * 1.0001)


# ------------------------------------------------------------ counters


def test_sync_counters_emitted(tmp_path):
    """``emit_sync_counters`` bumps JAX's ``comm.*`` counters by the
    stats times the sync count; the rank-combine and overlap counters
    land under their names too."""
    sink = events.configure(str(tmp_path))
    sync = comms.make_sync("int8", get_mesh(4, device="cpu"),
                           (comms.leaf((126,)), comms.leaf(())))
    st = comms.emit_sync_counters(sync, 10)
    comms.emit_rank_combine_counters(3, 40, 4, n_syncs=2)
    comms.emit_overlap_counters(1.6, 2.2)
    counters = sink.counters()
    events.configure(False)
    assert counters["comm.bytes_wire"] == st["bytes_wire"] * 10 + 8 * 3 * 3 * 2
    assert counters["comm.syncs"] == 12
    assert counters["comm.rounds"] == st["rounds"] * 10 + 2
    assert counters["graph.combine_syncs"] == 2
    assert counters["comm.overlap_hidden_ms"] == 2
    assert counters["comm.sync_ms"] == 2
    lines = [json.loads(x) for x in open(os.path.join(
        tmp_path, os.listdir(tmp_path)[0]))]
    assert lines[-2]["ev"] == "counters"
