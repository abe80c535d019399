"""The serving plane's replicas on the card (B9 an ALS shard's micro-batch).
Imports neither jax nor ``tpu_distalg``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cluster_serve_card.py

Without a card the tests skip; the CPU port is held to the JAX package in
``tests/test_torch_cluster_serve.py``. Standard: B9's scores are float32
FMAs in a fixed order over the rank, and a replica scores 32 rows a call
with the tail padded, so a request's reply is the same bits at every
batch fill 1..32, and a fleet of 2 or 4 shards merges to the bits of
one replica holding the whole catalogue (sparse and dense merges);
against the plain version on the CPU the replies hold by the tie rule
(``ops/topk.assert_topk_close``).

Sizes: 256 users × 4096 items, rank 64, k 10 (the serving shape's rank
and k on a smaller catalogue).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch.cluster import serve
from tpu_distalg_torch.ops import topk
from tpu_distalg_torch.parallel import comms
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

pytestmark = pytest.mark.gpu

K_TOP = 10


@pytest.fixture
def cuda_device():
    """The card, or a skip: the replicas were asked for the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the replicas run B9 there "
                    "(chip_smoke.py phase 19 serves the full artifact)")
    return torch.device("cuda")


def _center(seed=5, users=256, items=4096, rank=64):
    rng = np.random.default_rng(seed)
    return {"U": rng.normal(size=(users, rank)).astype(np.float32),
            "V": rng.normal(size=(items, rank)).astype(np.float32)}


def _merged(center, merge, n_shards, ids, device):
    """The router's merge (``router._merge``'s arithmetic) over the
    shards' replies to ``ids``."""
    parts = [serve.ReplicaModel("als", center, shard=s, n_shards=n_shards,
                                k_top=K_TOP, merge=merge, device=device)
             .score_frame({"x": ids}) for s in range(n_shards)]
    if merge == "sparse":
        return comms.merge_topk_pairs_host(
            np.stack([p["vals"] for p in parts]),
            np.stack([p["idx"] for p in parts]), k=K_TOP)
    full = np.concatenate([p["scores"] for p in parts], axis=1)
    gidx = np.arange(full.shape[1], dtype=np.int32)
    order = np.stack([np.lexsort((gidx, -row))[:K_TOP] for row in full])
    return np.take_along_axis(full, order, 1), gidx[order]


def test_replies_are_bitwise_at_every_fill(cuda_device):
    center = _center()
    ids = np.random.default_rng(1).integers(0, 256, size=32)
    m = serve.ReplicaModel("als", center, n_shards=1, k_top=K_TOP,
                           device=cuda_device)
    topk.fused_matmul_topk.launches = 0
    whole = m.score_frame({"x": ids})
    assert topk.fused_matmul_topk.launches == 1
    for fill in range(1, 33):
        part = m.score_frame({"x": ids[:fill]})
        assert part["vals"].tobytes() == whole["vals"][:fill].tobytes()
        assert part["idx"].tobytes() == whole["idx"][:fill].tobytes()
    assert topk.fused_matmul_topk.launches == 33
    cpu = serve.ReplicaModel("als", center, k_top=K_TOP + 1,
                             device="cpu").score_frame({"x": ids})
    topk.assert_topk_close(whole["vals"], whole["idx"], cpu["vals"],
                           cpu["idx"])


@pytest.mark.parametrize("merge", ["sparse", "dense"])
def test_shards_merge_to_one_replicas_bits(cuda_device, merge):
    center = _center()
    ids = np.arange(40) * 5 % 256
    one = _merged(center, merge, 1, ids, cuda_device)
    for n_shards in (2, 4):
        got = _merged(center, merge, n_shards, ids, cuda_device)
        assert got[0].tobytes() == one[0].tobytes(), n_shards
        assert got[1].tobytes() == one[1].tobytes(), n_shards


def test_card_fleet_under_a_replica_kill(cuda_device):
    """Three k-means replicas on the card behind the router, one killed
    mid-burst: every reply the undisturbed bits."""
    from tpu_distalg_torch import faults

    rng = np.random.default_rng(13)
    center = {"centers": rng.standard_normal((8, 16)).astype(np.float32)}
    X = list(rng.standard_normal((96, 16)).astype(np.float32))
    cfg = serve.FleetConfig(kind="kmeans", n_replicas=3, version=1,
                            max_delay_ms=1.0)
    out = []
    for plan in (None, "seed=13;cluster:replica@7=kill"):
        faults.configure(plan or False)
        try:
            fleet = serve.ServeFleet(cfg, center, device=cuda_device).start()
            try:
                res, info = serve.run_fleet_closed_loop(
                    fleet, X, concurrency=8, retries=10,
                    retry_backoff_s=0.05)
                killed = [r.slot for r in fleet.replicas if r.killed]
            finally:
                fleet.stop()
        finally:
            faults.configure(False)
        assert info["failed"] == 0
        out.append((np.stack([v for v, _, _ in res]), killed))
    assert out[0][1] == [] and len(out[1][1]) == 1
    assert out[0][0].tobytes() == out[1][0].tobytes()
