"""The cluster runtime (``tpu_distalg_torch/cluster/``) with its workers on
the card. Imports neither jax nor ``tpu_distalg``, so it also runs on a
machine with only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cluster_card.py

Without a card the tests skip; the CPU port is held to the JAX package in
``tests/test_torch_cluster.py``. Standard: the merge and membership
sequences are plan-determined, so thread-mode workers on the card give
the CPU port's ``event_digest`` exactly; the centers part only by the
order of the trainers' matrix-vector products (within 1e-4 of max|w|
after 8 windows). The straggle cells run ``csrc/ssp.cu`` on the card,
one launch a fired cell.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch import cluster as clus
from tpu_distalg_torch.parallel import ssp as pssp
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

pytestmark = pytest.mark.gpu

#: a kill of (window 3, slot 1) and straggles of (4, 0) and (6, 2)
PLAN = ("seed=7;cluster:worker@10=kill;cluster:worker@12=straggle:30;"
        "cluster:worker@20=straggle:30")


@pytest.fixture
def cuda_device():
    """The card, or a skip: the workers were asked for the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the workers run on it "
                    "(chip_smoke.py phase 18 runs the cluster there)")
    return torch.device("cuda")


def _run(device, comm="dense"):
    cfg = clus.ClusterConfig(
        n_slots=3, n_windows=8, staleness=3, heartbeat_timeout=15.0,
        plan_spec=PLAN, comm=comm,
        train=clus.TrainTask(n_rows=1024, test_rows=512))
    return clus.run_local_cluster(cfg, spawn="thread", timeout=180.0,
                                  rejoin_after=2, device=device)


@pytest.mark.parametrize("comm", ["dense", "int8:5"])
def test_card_workers_give_the_cpu_digest(cuda_device, comm):
    pssp.straggle_work.launches = 0
    card = _run(cuda_device, comm)
    launches = pssp.straggle_work.launches
    cpu = _run("cpu", comm)
    assert card["version"] == cpu["version"] == 8
    assert card["respawns"] == cpu["respawns"] == 1
    assert clus.event_digest(card) == clus.event_digest(cpu)
    w, cw = card["center"]["w"], cpu["center"]["w"]
    assert np.abs(w - cw).max() <= 1e-4 * np.abs(cw).max()
    skips = sum(s.get("skips", 0) for s in card["worker_stats"].values())
    assert skips == 2 and launches == skips


def test_card_replays_bitwise(cuda_device):
    a, b = _run(cuda_device), _run(cuda_device)
    assert clus.event_digest(a) == clus.event_digest(b)
    assert a["center"]["w"].tobytes() == b["center"]["w"].tobytes()
