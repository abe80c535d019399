"""Serving ALS with the item factors split over the emulated model axis
(``tpu_distalg_torch/serve/artifacts.als_model``), its candidate merges
(``ops/topk.merge_topk_pairs``, ``parallel/comms.py``) and the CLI path
``als --mesh-shape 2x4`` → ``serve --model-slices 4``, against the JAX
package's (``tpu_distalg/serve/artifacts.py``, JAX
``tests/test_serve.py:134-215``, ``tests/test_partition.py:396-430``).

Within the port, on the CPU, sharded replies equal unsharded ones
bitwise, for both merges, as the JAX package holds its own. Across the
two packages the scores are sums in other orders, so replies are held
by the tie-tolerance rule (``topk.assert_topk_close``, rtol 1e-5);
the merges, which only move and order values, are held bitwise.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tpu_distalg import serve as jserve
from tpu_distalg.ops import pallas_topk as jtopk
from tpu_distalg.parallel import comms as jcomms
from tpu_distalg.parallel import get_mesh as jax_mesh
from tpu_distalg_torch import serve
from tpu_distalg_torch.ops import topk
from tpu_distalg_torch.parallel import comms, get_mesh
from tpu_distalg_torch.telemetry import events
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 7


def _mesh(model):
    return get_mesh(1, model, device="cpu")


def _factors(seed, users=64, items=300, rank=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(users, rank)).astype(np.float32),
            rng.normal(size=(items, rank)).astype(np.float32))


def _equal(got, want):
    assert len(got) == len(want)
    for (gv, gi), (wv, wi) in zip(got, want):
        assert np.array_equal(gv, wv) and np.array_equal(gi, wi)
        assert gv.dtype == np.float32 and gi.dtype == np.int32


def _stack(replies):
    return (np.stack([v for v, _ in replies]),
            np.stack([i for _, i in replies]))


# ------------------------------------------------------------- merges


def _pair_stacks(rng, S=4, B=6, k=K):
    """(S, B, k) candidate stacks in each shard's own top-k order, with
    ties inside and across shards (integer scores), and shards whose
    tails ran out (-inf, sentinel)."""
    v = rng.integers(-4, 5, size=(S, B, k)).astype(np.float32)
    v = -np.sort(-v, axis=2)
    i = np.stack([s * 1000 + np.sort(rng.choice(1000, size=(B, k),
                                                replace=True), axis=1)
                  for s in range(S)]).astype(np.int32)
    for s in range(S):
        for b in range(B):
            order = np.lexsort((i[s, b], -v[s, b]))
            v[s, b], i[s, b] = v[s, b][order], i[s, b][order]
    v[1, :, 3:] = -np.inf
    i[1, :, 3:] = topk.IDX_SENTINEL
    v[3, 2, :] = -np.inf
    i[3, 2, :] = topk.IDX_SENTINEL
    return v, i


@pytest.mark.parametrize("k", [1, K, 4 * K])
def test_merge_topk_pairs_equals_jax_with_ties_and_tails(k):
    v, i = _pair_stacks(np.random.default_rng(k))
    mv, mi = topk.merge_topk_pairs(torch.as_tensor(v), torch.as_tensor(i),
                                   k=k)
    jv, ji = jtopk.merge_topk_pairs(jnp.asarray(v), jnp.asarray(i), k=k)
    assert np.array_equal(mv.numpy(), np.asarray(jv))
    assert np.array_equal(mi.numpy(), np.asarray(ji))
    hv, hi = comms.merge_topk_pairs_host(v, i, k=k)
    rv, ri = jcomms.merge_topk_pairs_host(v, i, k=k)
    assert np.array_equal(hv, rv) and np.array_equal(hi, ri)
    assert np.array_equal(hv, mv.numpy()) and np.array_equal(hi, mi.numpy())
    if k == 4 * K:  # every candidate: the exhausted slots come last
        assert (mv.numpy()[:, -1] == -np.inf).all()
        assert (mi.numpy()[:, -1] == topk.IDX_SENTINEL).all()


def test_merge_topk_pairs_equals_global_topk():
    """Each slice's candidates through the merge equal the top k over
    the whole catalogue (JAX ``tests/test_serve.py:134``)."""
    rng = np.random.default_rng(5)
    Q = torch.as_tensor(rng.normal(size=(8, 48)).astype(np.float32))
    V = torch.as_tensor(rng.normal(size=(400, 48)).astype(np.float32))
    per = [topk.matmul_topk_reference(Q, V[s * 100:(s + 1) * 100],
                                      s * 100, 100, k=K) for s in range(4)]
    all_v, all_i = comms.ring_allgather(per)
    assert all_v.shape == (4, 8, K) and all_i.dtype == torch.int32
    for s, (v, i) in enumerate(per):
        assert torch.equal(all_v[s], v) and torch.equal(all_i[s], i)
    mv, mi = topk.merge_topk_pairs(all_v, all_i, k=K)
    rv, ri = topk.matmul_topk_reference(Q, V, 0, 400, k=K)
    assert torch.equal(mv, rv) and torch.equal(mi, ri)


def test_ring_allgather_refuses_ragged_shards():
    with pytest.raises(ValueError, match="at least one"):
        comms.ring_allgather([])
    with pytest.raises(ValueError, match="numbers of buffers"):
        comms.ring_allgather([(torch.zeros(2),),
                              (torch.zeros(2), torch.zeros(2))])


# ------------------------------------------- sharded == unsharded


@pytest.mark.parametrize("merge", ["sparse", "dense"])
@pytest.mark.parametrize("model", [2, 4, 8])
def test_sharded_replies_equal_unsharded_bitwise(merge, model):
    """JAX ``tests/test_serve.py:189``: V of 300 items over 2, 4 and 8
    slices (8 pads it to 304) answers as one slice does, with the
    pair-ring accounting 8·k·(S−1) bytes a request."""
    U, V = _factors(3)
    sharded = serve.als_model(U, V, _mesh(model), k_top=K, merge=merge)
    single = serve.als_model(U, V, _mesh(1), k_top=K)
    ids = [np.int32(i) for i in np.random.default_rng(9).integers(0, 64, 24)]
    _equal(sharded.predict_batch(ids, 32), single.predict_batch(ids, 32))
    assert sharded.meta["n_model"] == model and sharded.meta["n_items"] == 300
    want = 8 * K * (model - 1) if merge == "sparse" else \
        4 * (-(-300 // model) * model) * (model - 1) // model
    assert sharded.meta["merge_wire_bytes_per_request"] == want
    assert single.meta["merge_wire_bytes_per_request"] == 0


def test_sparse_wire_bytes_below_dense():
    U, V = _factors(4, users=16, items=4096, rank=8)
    sp = serve.als_model(U, V, _mesh(4), k_top=K, merge="sparse")
    dn = serve.als_model(U, V, _mesh(4), k_top=K, merge="dense")
    assert 0 < sp.meta["merge_wire_bytes_per_request"] \
        < dn.meta["merge_wire_bytes_per_request"]


def test_batched_equals_unbatched_on_model_4():
    """JAX ``tests/test_serve.py:177``: a batch's replies equal the same
    requests sent one at a time through the padded predictor."""
    U, V = _factors(2, users=32, items=200)
    for merge in ("sparse", "dense"):
        model = serve.als_model(U, V, _mesh(4), k_top=K, merge=merge)
        ids = [np.int32(i)
               for i in np.random.default_rng(2).integers(0, 32, 5)]
        _equal(model.predict_batch(ids, 8),
               [model.predict_one(p, 8) for p in ids])


def test_slices_past_the_catalogue_and_a_zero_tail_are_masked():
    """A zero-padded tail of V (an artifact of a mesh fit) is detected;
    slices wholly past the true items take no part; k above the items a
    slice holds leaves its exhausted slots to the merge."""
    U, V = _factors(6, users=16, items=40, rank=8)
    V = np.concatenate([V, np.zeros((24, 8), np.float32)])
    single = serve.als_model(U, V[:40], _mesh(1), k_top=12)
    ids = list(range(16))
    want = single.predict_batch(ids, 16)
    for merge in ("sparse", "dense"):
        m = serve.als_model(U, V, _mesh(8), k_top=12, merge=merge)
        assert m.meta["n_items"] == 40
        got = m.predict_batch(ids, 16)
        _equal(got, want)
        assert max(int(i.max()) for _, i in got) < 40


def test_unknown_merge_and_library_path():
    U, V = _factors(7)
    with pytest.raises(ValueError, match="merge must be 'sparse' or "
                                         "'dense', got 'ring'"):
        serve.als_model(U, V, _mesh(4), merge="ring")
    # the wrapper picks by device: on a CPU mesh, the plain version
    m = serve.als_model(U, V, _mesh(4), k_top=K)
    assert m.meta["fused"] is False
    ids = list(range(10))
    Ut = torch.as_tensor(U)
    want_v, want_i = topk.matmul_topk_reference(
        Ut[ids], torch.as_tensor(V), 0, V.shape[0], k=K)
    for (v, i), wv, wi in zip(m.predict_batch(ids, 16), want_v.numpy(),
                              want_i.numpy()):
        assert np.array_equal(i, wi) and np.array_equal(v, wv)


# ------------------------------------------------ against JAX's serving


@pytest.mark.parametrize("merge", ["sparse", "dense"])
@pytest.mark.parametrize("data,model", [(1, 1), (1, 4), (2, 4)])
def test_replies_and_meta_match_jax_als_model(merge, data, model):
    """The same U, V and mesh shape through both packages: indices by
    the tie-tolerance rule (rtol 1e-5), ``meta`` and the wire accounting
    equal (the port's ``meta`` adds its device)."""
    U, V = _factors(11, users=40, items=250)
    mine = serve.als_model(U, V, get_mesh(data, model, device="cpu"),
                           k_top=K, merge=merge)
    ref = jserve.als_model(U, V, jax_mesh(
        data=data, model=model, devices=jax.devices()[:data * model]),
        k_top=K + 1, merge=merge)
    ids = [np.int32(i) for i in np.random.default_rng(1).integers(0, 40, 16)]
    gv, gi = _stack(mine.predict_batch(ids, 16))
    rv, ri = _stack(ref.predict_batch(ids, 16))
    topk.assert_topk_close(gv, gi, rv, ri, rtol=1e-5)
    ref_k = jserve.als_model(U, V, jax_mesh(
        data=data, model=model, devices=jax.devices()[:data * model]),
        k_top=K, merge=merge)
    meta = dict(mine.meta)
    assert meta.pop("device") == "cpu"
    assert meta == ref_k.meta


def test_jax_mesh_fit_factors_convert_and_serve_sharded():
    """Factors of a JAX fit on a 2×4 mesh (returned unpadded) cross
    through ``convert.als_params_from_jax`` and serve over 4 slices as
    the JAX package serves them (tie-tolerance rule)."""
    from tpu_distalg.models import als as jals
    from tpu_distalg_torch import convert

    jm = jax_mesh(data=2, model=4)
    res = jals.fit(jm, jals.ALSConfig(m=30, n=70, k=8, n_iterations=2))
    U_np, V_np = np.asarray(res.U), np.asarray(res.V)
    assert U_np.shape == (30, 8) and V_np.shape == (70, 8)
    U, V = convert.als_params_from_jax(U_np, V_np, device="cpu")
    mine = serve.als_model(U, V, _mesh(4), k_top=K)
    ref = jserve.als_model(U_np, V_np, jax_mesh(
        data=1, model=4, devices=jax.devices()[:4]), k_top=K + 1)
    ids = [np.int32(i) for i in range(30)]
    gv, gi = _stack(mine.predict_batch(ids, 32))
    rv, ri = _stack(ref.predict_batch(ids, 32))
    topk.assert_topk_close(gv, gi, rv, ri, rtol=1e-5)
    assert mine.meta["n_items"] == 70 and mine.meta["n_users"] == 30


# -------------------------------------- device-resident factors, counters


def test_device_factors_answer_like_host_factors(tmp_path):
    """JAX ``tests/test_partition.py:396,418``: tensors (a training
    result handed straight to serving) take the train→serve reshard,
    which emits its counters, and answer bitwise as host arrays do;
    each batch counts its merge's wire bytes."""
    rng = np.random.default_rng(3)
    U = rng.standard_normal((8, 4)).astype(np.float32)
    V = rng.standard_normal((8, 4)).astype(np.float32)
    mesh = get_mesh(2, 2, device="cpu")
    host = serve.als_model(U, V, mesh, k_top=3)
    sink = events.configure(str(tmp_path / "tel"))
    try:
        dev = serve.als_model(torch.as_tensor(U), torch.as_tensor(V), mesh,
                              k_top=3)
        after_build = sink.counters()
        a = host.predict_batch([0, 3, 7], 4)
        b = dev.predict_batch([0, 3, 7], 4)
        counters = sink.counters()
    finally:
        events.configure(False)
    _equal(a, b)
    assert dev.meta == host.meta
    assert after_build["reshard.syncs"] == 1
    assert after_build["reshard.bytes_wire"] > 0
    assert "serve.merge_bytes_wire" not in after_build
    assert counters["serve.merge_bytes_wire"] == 2 * 8 * 3 * 1 * 4


def test_sharded_and_unsharded_models_under_many_clients():
    """One server, a sharded and an unsharded model of the same factors
    driven at once by 16 clients each: every reply equals the plain
    top k of its own request."""
    U, V = _factors(8, users=50, items=90, rank=8)
    srv = serve.Server(_mesh(4), serve.ServeConfig(
        max_batch=4, max_delay_ms=1.0, queue_depth=512, k_top=3))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    ids = list(np.random.default_rng(8).integers(0, 50, 120))
    out = {}
    lock = threading.Lock()
    try:
        srv.add_model(serve.als_model(U, V, _mesh(4), k_top=3, name="s4"))
        srv.add_model(serve.als_model(U, V, _mesh(1), k_top=3, name="s1"))

        def drive(name):
            res = serve.run_closed_loop(srv, name, ids, concurrency=16)
            with lock:
                out[name] = res

        loads = [threading.Thread(target=drive, args=(n,), daemon=True)
                 for n in ("s4", "s1")]
        for t in loads:
            t.start()
        for t in loads:
            t.join(60.0)
        assert not any(t.is_alive() for t in loads)
    finally:
        sys.setswitchinterval(old)
        srv.close()
    want_v, want_i = topk.matmul_topk_reference(
        torch.as_tensor(U[ids]), torch.as_tensor(V), 0, 90, k=3)
    for name in ("s4", "s1"):
        results, info = out[name]
        assert info["ok"] == len(ids) and info["failed"] == 0
        for r, (v, i) in enumerate(results):
            assert np.array_equal(v, want_v[r].numpy())
            assert np.array_equal(i, want_i[r].numpy())


# ---------------------------------------------------------------- CLI


def _run(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "tpu_distalg_torch.cli",
                          "--device", "cpu"] + args, capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def test_cli_mesh_fit_then_sharded_serving(tmp_path):
    """``als --mesh-shape 2x4 --checkpoint-dir D`` then ``serve
    --artifact D --model-slices 4 --comm sparse|dense``: 64/64 replies,
    and the rmse lines of the 1x1 run within 4e-6."""
    ck = str(tmp_path / "ck")
    fit = ["als", "--m", "64", "--n", "198", "--k", "8", "--n-iterations",
           "3", "--checkpoint-every", "2"]
    lines = _run(fit + ["--mesh-shape", "2x4", "--checkpoint-dir", ck])
    assert lines[-1] == f"artifact_path: {ck}"
    hist = [float(ln.split("rmse: ")[1]) for ln in lines[:3]]
    base = [float(ln.split("rmse: ")[1]) for ln in _run(fit)[:3]]
    np.testing.assert_allclose(hist, base, rtol=0, atol=4e-6)
    assert sorted(os.listdir(ck)) == ["step_2.npz", "step_3.npz"]
    for comm in ("sparse", "dense"):
        out = "\n".join(_run(["serve", "--artifact", ck, "--requests", "64",
                              "--max-batch", "8", "--model-slices", "4",
                              "--comm", comm]))
        assert f"'merge': '{comm}'" in out and "'n_model': 4" in out
        assert "'n_items': 198" in out and "'n_users': 64" in out
        assert "[serve] als: 64/64 replies at " in out


def test_cli_refusals_name_their_item():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m", "tpu_distalg_torch.cli", "--device", "cpu",
            "als", "--n-iterations", "1"]
    for extra, want in ((["--data-backend", "streamed"],
                         "needs --stream-cache"),
                        (["--max-restarts", "1"], "A12"),
                        (["--mesh-shape", "2x2", "--n-slices", "2"],
                         "--mesh-shape and --n-slices both set")):
        out = subprocess.run(base + extra, capture_output=True, text=True,
                             timeout=300, env=env, cwd=REPO)
        assert out.returncode != 0 and want in out.stderr, out.stderr
