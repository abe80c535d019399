"""ALS served over the emulated model axis on the card: the top-k kernel
(``csrc/topk.cu``, B9) once per slice of V against its plain PyTorch
version, and sharded replies against unsharded ones. Imports neither
jax nor ``tpu_distalg``:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_serve_sharded_card.py

B9 sums each score over the features in order, one fused multiply-add
chain a (query, item) pair, whatever its plan (shape A or B, the vector
or the scalar load path), and breaks ties toward the lower id. So the
sparse merge of the slices' candidates must equal one launch over the
whole V bitwise, and the tests hold that with ``torch.equal``. Against
the plain version (cuBLAS sums in another order) replies are held by
the tie-tolerance rule (``topk.assert_topk_close``, rtol 1e-5); so is
the dense merge, which scores with cuBLAS. Without a card the tests
skip; ``tests/test_torch_serve_sharded.py`` holds the CPU path.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

from tpu_distalg_torch import serve
from tpu_distalg_torch.ops import _native, topk
from tpu_distalg_torch.parallel import get_mesh
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU "
                    "interpret mode (chip_smoke.py runs it on the card)")
    return torch.device("cuda")


def _factors(rng, users, items, rank):
    return (rng.normal(size=(users, rank)).astype(np.float32),
            rng.normal(size=(items, rank)).astype(np.float32))


def _stack(replies):
    return (np.stack([v for v, _ in replies]),
            np.stack([i for _, i in replies]))


def _plain(U, V, ids, dev, k):
    Ud, Vd = (torch.as_tensor(x, device=dev) for x in (U, V))
    return topk.matmul_topk_reference(
        Ud[torch.as_tensor(np.asarray(ids), device=dev)].contiguous(), Vd,
        0, V.shape[0], k=k + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("items,rank", [(131072, 64), (16384, 64),
                                        (16384, 10), (1001, 10)])
def test_sparse_slices_equal_one_launch_bitwise(items, rank, cuda_device):
    """B 32, k 10 on 4 slices: at 131,072 items the whole V takes plan
    shape A and a slice shape B; rank 10 takes the kernel's scalar load
    path (d % 4 != 0); 1001 items pad to 1004. Each slice's launch is
    held to the plain version on its slice, and the merged replies equal
    one launch's bitwise."""
    rng = np.random.default_rng(items + rank)
    U, V = _factors(rng, 512, items, rank)
    mesh4 = get_mesh(1, 4, device=cuda_device)
    n_sm = _native.sm_count(cuda_device.index or 0)
    if items == 131072:
        assert topk.topk_plan(32, items, 10, None, n_sm)["shape"] == 0
        assert topk.topk_plan(32, items // 4, 10, None, n_sm)["shape"] == 1
    sharded = serve.als_model(U, V, mesh4, k_top=10)
    single = serve.als_model(U, V, get_mesh(device=cuda_device), k_top=10)
    ids = list(rng.integers(0, 512, size=32))
    before = topk.fused_matmul_topk.launches
    got = sharded.predict_batch(ids, 32)
    assert topk.fused_matmul_topk.launches - before == 4
    want = single.predict_batch(ids, 32)
    gv, gi = _stack(got)
    wv, wi = _stack(want)
    assert np.array_equal(gv, wv) and np.array_equal(gi, wi)
    rv, ri = _plain(U, V, ids, cuda_device, 10)
    topk.assert_topk_close(gv, gi, rv, ri, rtol=1e-5)
    # each slice's launch against the plain version on that slice
    Q = torch.as_tensor(U[ids], device=cuda_device)
    local = -(-items // 4)
    Vp = torch.zeros((4 * local, rank), device=cuda_device)
    Vp[:items] = torch.as_tensor(V, device=cuda_device)
    for m in range(4):
        Vl = Vp[m * local:(m + 1) * local]
        nv = min(max(items - m * local, 0), local)
        kv, ki = topk.fused_matmul_topk(Q, Vl, m * local, nv, k=10)
        pv, pi = topk.matmul_topk_reference(Q, Vl, m * local, nv, k=11)
        topk.assert_topk_close(kv, ki, pv, pi, rtol=1e-5)


@pytest.mark.gpu
def test_dense_merge_launches_no_kernel_and_matches_plain(cuda_device):
    """The dense merge scores with cuBLAS (no B9 launch) and is held to
    the plain version by the tie-tolerance rule."""
    rng = np.random.default_rng(7)
    U, V = _factors(rng, 4096, 16384, 64)
    dense = serve.als_model(U, V, get_mesh(1, 4, device=cuda_device),
                            k_top=10, merge="dense")
    assert dense.meta["merge_wire_bytes_per_request"] == 4 * 16384 * 3 // 4
    ids = list(rng.integers(0, 4096, size=32))
    before = topk.fused_matmul_topk.launches
    gv, gi = _stack(dense.predict_batch(ids, 32))
    assert topk.fused_matmul_topk.launches == before
    rv, ri = _plain(U, V, ids, cuda_device, 10)
    topk.assert_topk_close(gv, gi, rv, ri, rtol=1e-5)


@pytest.mark.gpu
def test_device_resident_factors_serve_like_host_ones(cuda_device):
    """CUDA tensors take the train→serve reshard; their replies equal
    the host factors' bitwise."""
    rng = np.random.default_rng(8)
    U, V = _factors(rng, 256, 5000, 64)
    mesh = get_mesh(2, 4, device=cuda_device)
    host = serve.als_model(U, V, mesh, k_top=10)
    dev = serve.als_model(torch.as_tensor(U, device=cuda_device),
                          torch.as_tensor(V, device=cuda_device), mesh,
                          k_top=10)
    ids = list(rng.integers(0, 256, size=20))
    a, b = _stack(host.predict_batch(ids, 32)), _stack(
        dev.predict_batch(ids, 32))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert dev.meta == host.meta


@pytest.mark.gpu
def test_sharded_and_unsharded_models_in_turn_and_at_once(cuda_device):
    """One workspace cache, many shapes (a stale cached workspace once
    corrupted a later, larger batch): a sharded model (4 launches a
    batch at N/4) and an unsharded one (N) of other factors alternate on
    one stream, then serve together from one ``Server`` under 8 clients
    each; every reply equals its model's unsharded reply computed
    alone."""
    rng = np.random.default_rng(9)
    fa = _factors(rng, 1024, 16384, 64)
    fb = _factors(rng, 1024, 40000, 64)
    mesh1, mesh4 = (get_mesh(device=cuda_device),
                    get_mesh(1, 4, device=cuda_device))
    ids = [int(i) for i in rng.integers(0, 1024, size=256)]

    def alone(U, V):
        m = serve.als_model(U, V, mesh1, k_top=10)
        return [r for j in range(0, len(ids), 32)
                for r in m.predict_batch(ids[j:j + 32], 32)]

    want = {"a4": alone(*fa), "b1": alone(*fb)}
    models = {"a4": serve.als_model(*fa, mesh4, k_top=10, name="a4"),
              "b1": serve.als_model(*fb, mesh1, k_top=10, name="b1")}
    for j in range(0, len(ids), 32):  # in turn on one stream
        for name, m in models.items():
            got = m.predict_batch(ids[j:j + 32], 32)
            for (gv, gi), (wv, wi) in zip(got, want[name][j:j + 32]):
                assert np.array_equal(gv, wv) and np.array_equal(gi, wi)
    srv = serve.Server(mesh4, serve.ServeConfig(max_batch=32,
                                                max_delay_ms=2.0,
                                                queue_depth=512))
    out = {}
    lock = threading.Lock()
    try:
        for m in models.values():
            srv.add_model(m)

        def drive(name):
            res = serve.run_closed_loop(srv, name, ids, concurrency=8)
            with lock:
                out[name] = res

        threads = [threading.Thread(target=drive, args=(n,), daemon=True)
                   for n in models]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.close()
    for name in models:
        results, info = out[name]
        assert info["ok"] == len(ids) and info["failed"] == 0
        for (gv, gi), (wv, wi) in zip(results, want[name]):
            assert np.array_equal(gv, wv) and np.array_equal(gi, wi)
