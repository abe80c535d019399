"""The sync layer (``tpu_distalg_torch/parallel/comms.py``, ``ssp.py``)
on the card. Imports neither jax nor ``tpu_distalg``, so it also runs on
a machine with only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_comms_card.py

Without a card the tests skip; the CPU port is held to the JAX package
in ``tests/test_torch_comms.py`` and ``tests/test_torch_ssp.py``. Every
schedule is elementwise ops in a fixed order over the shard stack (no
float atomics), so the standard on the card is bitwise: each
schedule's reduce equals the CPU port's, a duplicate-index sparse
combine replays over 100 calls, and B1 under ``int8`` and SSP under a
straggle plan replay.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_distalg_torch import faults
from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.parallel import comms, get_mesh
from tpu_distalg_torch.parallel import ssp as pssp
from tpu_distalg_torch.utils import datasets
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

pytestmark = pytest.mark.gpu

SCHEDULES = ("dense", "bucketed", "bucketed:256", "hier", "hier:4", "bf16",
             "int8", "int8:5:300", "int8@seq", "topk", "topk:0.05")
FUSED = dict(fused_pack=4, gather_block_rows=32, shuffle_seed=0)


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _per_shard(n, d, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.integers(1, 50, n).astype(np.float32)
    return [(torch.from_numpy(g[s]), torch.tensor(c[s])) for s in range(n)]


@pytest.mark.parametrize("sched,n", [(s, n) for n in (4, 8)
                                     for s in SCHEDULES
                                     if not (s == "hier:4" and n == 4)])
def test_reduce_on_card_equals_cpu_bitwise(cuda_device, sched, n):
    """Sum and mean, with a nonzero residual for topk, at 126 and 70,001
    elements (one and many buckets); hier:4 on 8 shards only (4 groups of
    one shard on 4 would be the flat ring)."""
    for d in (126, 70001):
        per = _per_shard(n, d, seed=d + n)
        example = (comms.leaf((d,)), comms.leaf(()))
        card = comms.make_sync(sched, get_mesh(n, device=cuda_device),
                               example)
        cpu = comms.make_sync(sched, get_mesh(n, device="cpu"), example)
        res = torch.from_numpy(np.random.default_rng(1).standard_normal(
            cpu.init_state().shape).astype(np.float32))
        for mean in (False, True):
            f_cpu = cpu.reduce_mean if mean else cpu.reduce
            f_card = card.reduce_mean if mean else card.reduce
            (g0, c0), r0 = f_cpu(per, res, 7)
            (g1, c1), r1 = f_card(
                [tuple(x.to(cuda_device) for x in p) for p in per],
                res.to(cuda_device), 7)
            assert torch.equal(g1.cpu(), g0), (sched, d, mean)
            assert torch.equal(c1.cpu(), c0)
            assert torch.equal(r1.cpu(), r0)


def test_sparse_allreduce_duplicates_replay_on_card(cuda_device):
    """Duplicate indices within and across shards add in the JAX
    package's order (within a shard one after another, the shards in
    origin order) with no float atomics: 100 calls on the card equal
    each other and the CPU port's bitwise."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 64, (4, 300)).astype(np.int32)
    vals = rng.standard_normal((4, 300)).astype(np.float32)
    want = comms.sparse_allreduce(torch.from_numpy(vals),
                                  torch.from_numpy(idx), 64)
    v, i = (torch.from_numpy(vals).to(cuda_device),
            torch.from_numpy(idx).to(cuda_device))
    for _ in range(100):
        got = comms.sparse_allreduce(v, i, 64)
        assert torch.equal(got.cpu(), want)


def test_straggle_work_on_card_is_one_launch(cuda_device):
    """One launch a tick for every shard; the sums stay near the plain
    version's (fused multiply-adds and another order of sums)."""
    units = torch.tensor([0, 3, 40, 7], dtype=torch.int32)
    before = pssp.straggle_work.launches
    got = pssp.straggle_work(units.to(cuda_device), 1.0)
    assert pssp.straggle_work.launches == before + 1
    want = pssp.straggle_work_reference(units, 1.0)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5)


def _breast_cancer():
    return datasets.breast_cancer_split()


def test_fused_gather_int8_replays_and_tracks_cpu(cuda_device):
    """B1 on 4 shards under int8: two runs on the card equal bitwise,
    B1 launches 4 a step, and the card stays within 1e-2 of the largest
    |w| of the CPU port after 5 steps (B1 sums in another order than
    its plain version, and int8's rounding acts on those sums)."""
    from tpu_distalg_torch.ops import ssgd_kernels as tk

    data = _breast_cancer()
    cfg = ssgd.SSGDConfig(n_iterations=5, comm="int8", sampler="fused_gather",
                          **FUSED)
    mesh = get_mesh(4, device=cuda_device)
    before = tk.fused_grad_sum_gathered.launches
    a = ssgd.train(*data, mesh, cfg)
    assert tk.fused_grad_sum_gathered.launches - before == 4 * 5
    b = ssgd.train(*data, mesh, cfg)
    assert torch.equal(a.w, b.w)
    c = ssgd.train(*data, get_mesh(4, device="cpu"), cfg)
    err = float((a.w.cpu() - c.w).abs().max())
    assert err <= 1e-2 * float(c.w.abs().max())


def test_ssp_under_a_plan_replays_on_card(cuda_device):
    """SSGD ssp:4 on 4 shards (bernoulli, fused_gather through B1 and
    fused through B5) under a straggle and leave plan: a replay under
    the same plan equals the first run bitwise."""
    data = _breast_cancer()
    plan = ("seed=7;shard:straggle@p0.25=straggle:8;"
            "shard:leave@p0.1=leave:2")
    mesh = get_mesh(4, device=cuda_device)
    for kw in ({}, dict(sampler="fused_gather", **FUSED),
               dict(sampler="fused", fused_pack=4, fused_block_rows=64)):
        cfg = ssgd.SSGDConfig(n_iterations=48, sync="ssp:4", **kw)
        runs = []
        for _ in range(2):
            faults.configure(plan)
            try:
                runs.append(ssgd.train(*data, mesh, cfg))
            finally:
                faults.configure(False)
        assert torch.equal(runs[0].w, runs[1].w)
        assert torch.equal(runs[0].accs, runs[1].accs)
