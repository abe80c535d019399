"""The sync layer across processes (``torch.distributed`` over gloo, on
the CPU) against one process, and against the JAX package.

A spawned pair of processes, each holding 2 of 4 emulated data shards,
runs the compressed schedules on the hops of ``parallel/collectives.py``
(``bucketed``, ``hier``, ``bf16``, ``int8``, ``int8@seq``, ``topk``) on
SSGD ``fused_gather`` and ``bernoulli``, LR under ``int8``, MA on
``fused_train`` and ``fused_gather`` under ``int8`` and ``topk``; SSGD
``fused_gather`` and MA under ``--sync ssp:2`` with the card's straggle
and leave plans, ``fused`` (B5's plain version) under int8, topk and
ssp:2, and the straggler bench's BSP arm; checkpoints written by the
pair and resumed by one process and the other way round; an SSP
checkpoint written at 2 global shards and resumed at 4; LR, EASGD,
k-means, PageRank and the tp split in segments through the shared
directory. Rank 0 also runs each on one process × 4 emulated shards at
the same thread count (torch's CPU reductions change with it). Every
add keeps the one-process order, so the two must be equal BIT FOR BIT.
The bytes each process sends a sync must equal the port's closed form
(``comms.process_bytes``), and ``hier`` < ``bucketed`` < ``dense`` at 2
processes × 2 shards. A group of 3 processes × 2 shards infers 3
``hier`` groups and equals one process under ``hier:3``.

The worker is this file run as a script with the repo on
``PYTHONPATH``; it imports neither jax nor ``tpu_distalg``. Groups meet
through a ``file://`` rendezvous in ``tmp_path``; only the CLI test
takes a free TCP port.

Shapes: breast cancer over 4 shards, 5 steps or rounds for
trajectories (ROADMAP C's standard: before the float32 runs part from
JAX), 16 ticks for SSP (8 windows of 2, so the plans' straggles fire in
most windows); a 4096-wide vector for the byte counts, where the
padding of 1001-element leaves would blur the 4E/6E/8E order.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 300
FUSED = dict(fused_pack=4, gather_block_rows=32, shuffle_seed=0)
STEPS, SSP_TICKS, BYTES_D = 5, 16, 4096
SCHEDULES = ("bucketed", "hier", "bf16", "int8", "int8@seq", "topk:0.01")
#: the card's plans (chip_smoke.py phase 13)
SSP_PLAN = "seed=7;shard:straggle@p0.25=straggle:800"
SSP_LEAVE_PLAN = SSP_PLAN + ";shard:leave@p0.05=leave:2"
#: (name, SSGD config fields) under every schedule
SSGD_SAMPLERS = (("fused_gather", dict(sampler="fused_gather", **FUSED)),
                 ("bernoulli", {}))
#: (name, sampler, schedule) of the MA runs
MA_RUNS = tuple((f"ma_{smp}_{c.split(':')[0]}", smp, c)
                for smp in ("fused_train", "fused_gather")
                for c in ("int8", "topk:0.01"))
#: ``fused`` (B5's plain version) under the schedules with a state or a
#: second rounding; it has no JAX counterpart (the TPU draws its mask
#: on the core), so it is held to one process only
FUSED_B5 = dict(sampler="fused", fused_block_rows=64, **FUSED)
B5_SCHEDULES = ("int8", "topk:0.01")
#: (name, trainer, plan) of the SSP runs
SSP_RUNS = tuple(
    (f"ssp_{kind}_{label}", kind, plan)
    for kind in ("ssgd_fused_gather", "ma")
    for label, plan in (("straggle", SSP_PLAN), ("leave", SSP_LEAVE_PLAN))
) + (("ssp_ssgd_fused_straggle", "ssgd_fused", SSP_PLAN),)


def _name(sampler: str, comm: str) -> str:
    return f"ssgd_{sampler}_{comm.replace(':', '_').replace('@', '_')}"


# ------------------------------------------------------------- worker


def _host(t):
    return t.detach().cpu().numpy().copy()


def _ssp_train(kind: str, mesh, plan: str, n: int, **ckpt):
    from tpu_distalg_torch import faults
    from tpu_distalg_torch.models import ma, ssgd
    from tpu_distalg_torch.utils import datasets

    data = datasets.breast_cancer_split()
    faults.configure(plan)
    try:
        if kind == "ma":
            return ma.train(*data, mesh, ma.MAConfig(n_iterations=n,
                                                     sync="ssp:2"), **ckpt)
        fields = (FUSED_B5 if kind == "ssgd_fused"
                  else dict(sampler="fused_gather", **FUSED))
        return ssgd.train(*data, mesh, ssgd.SSGDConfig(
            n_iterations=n, sync="ssp:2", **fields), **ckpt)
    finally:
        faults.configure(False)


def _workloads(mesh) -> dict:
    """Every trajectory on ``mesh`` (4 data shards) → {name: {key:
    array}}."""
    from tpu_distalg_torch.models import logistic_regression, ma, ssgd
    from tpu_distalg_torch.utils import datasets

    data = datasets.breast_cancer_split()
    out = {}
    for smp, fields in SSGD_SAMPLERS:
        for comm in SCHEDULES:
            r = ssgd.train(*data, mesh, ssgd.SSGDConfig(
                n_iterations=STEPS, comm=comm, **fields))
            out[_name(smp, comm)] = {"w": _host(r.w), "accs": _host(r.accs)}
    for comm in B5_SCHEDULES:
        r = ssgd.train(*data, mesh, ssgd.SSGDConfig(
            n_iterations=STEPS, comm=comm, **FUSED_B5))
        out[_name("fused", comm)] = {"w": _host(r.w), "accs": _host(r.accs)}
    r = logistic_regression.train(*data, mesh, logistic_regression.LRConfig(
        n_iterations=STEPS, comm="int8"))
    out["lr_int8"] = {"w": _host(r.w), "accs": _host(r.accs)}
    for name, smp, comm in MA_RUNS:
        r = ma.train(*data, mesh, ma.MAConfig(n_iterations=STEPS, sampler=smp,
                                              comm=comm, **FUSED))
        out[name] = {"w": _host(r.w), "ws": _host(r.ws),
                     "accs": _host(r.accs)}
    for name, kind, plan in SSP_RUNS:
        r = _ssp_train(kind, mesh, plan, SSP_TICKS)
        out[name] = {"w": _host(r.w), "accs": _host(r.accs)}
    out["bsp_straggler"] = _bsp_straggler(mesh, data)
    return out


def _bsp_straggler(mesh, data) -> dict:
    """The straggler bench's BSP arm under the straggle plan: a process
    runs its own shards' straggle work and gradients."""
    from tpu_distalg_torch import faults
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import parallelize
    from tpu_distalg_torch.parallel import ssp as pssp

    X, y, X_te, y_te = data
    Xs, ys = parallelize(X, mesh), parallelize(np.asarray(y, np.float32),
                                               mesh)
    extra = pssp.compile_straggle_schedule(
        SSP_TICKS, mesh.n_data, plan=faults.FaultPlan.parse(SSP_PLAN))
    fn = ssgd.make_bsp_straggler_fn(
        mesh, ssgd.SSGDConfig(n_iterations=SSP_TICKS), Xs.n_padded, extra)
    w, accs = fn(Xs.data, ys.data, Xs.mask,
                 torch.as_tensor(np.asarray(X_te, np.float32)),
                 torch.as_tensor(np.asarray(y_te, np.float32)),
                 torch.zeros((X.shape[1],)))
    return {"w": _host(w), "accs": _host(accs)}


def _bytes(mesh) -> dict:
    """Each schedule's bytes a sync of SSGD's (Σ grad, count) pair at
    width 4096: what this process counted sending, and the closed
    form."""
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import collectives

    rng = np.random.default_rng(3)
    vals = rng.standard_normal((mesh.n_data, BYTES_D)).astype(np.float32)
    per = [(torch.from_numpy(vals[s]), torch.tensor(float(s)))
           for s in mesh.local_data]
    out = {}
    for comm in ("dense",) + SCHEDULES:
        sync = ssgd._comm_sync(mesh, ssgd.SSGDConfig(comm=comm), BYTES_D)
        res = torch.zeros((mesh.n_local, sync.init_state().shape[1]))
        collectives.reset_counters()
        for t in range(2):
            _, res = sync.reduce(per, res, t)
        out[comm.replace(":", "_").replace("@", "_")] = np.array(
            [collectives.COUNTERS["bytes_sent"] // 2,
             sync.bytes_process(), sync.stats()["bytes_wire"]],
            np.int64)
    return {"bytes": out}


def _ckpt_cfg(n: int):
    from tpu_distalg_torch.models import ssgd

    return ssgd.SSGDConfig(n_iterations=n, sampler="fused_gather",
                           comm="topk:0.05", **FUSED)


def _checkpoints(mesh, one, rank: int, tmp: str) -> tuple[dict, dict]:
    """Checkpoints the pair and one process hand each other: SSGD under
    ``topk`` (a row-sharded residual) and MA (row-sharded replicas),
    written for 3 steps by one side, resumed to 6 by the other; an SSP
    run written at 2 global shards and resumed at 4; and each rank's own
    directory, which must raise on both. Returns the pair's results and
    (rank 0) the one process's."""
    import torch.distributed as dist

    from tpu_distalg_torch.models import ma, ssgd
    from tpu_distalg_torch.parallel import Mesh, get_mesh
    from tpu_distalg_torch.utils import datasets

    data = datasets.breast_cancer_split()
    multi, single = {}, {}

    def ma_cfg(n):
        return ma.MAConfig(n_iterations=n, sampler="fused_gather", **FUSED)

    runs = (("ckpt_ssgd", ssgd.train, _ckpt_cfg),
            ("ckpt_ma", ma.train, ma_cfg))
    for name, train, cfg in runs:
        # the pair writes, one process resumes
        d = os.path.join(tmp, f"{name}_by_pair")
        train(*data, mesh, cfg(3), checkpoint_dir=d, checkpoint_every=3)
        dist.barrier()
        if rank == 0:
            r = train(*data, one, cfg(6), checkpoint_dir=d,
                      checkpoint_every=3)
            single[f"{name}_pair_to_one"] = {"w": _host(r.w),
                                             "accs": _host(r.accs)}
            r = train(*data, one, cfg(6))
            single[f"{name}_straight"] = {"w": _host(r.w),
                                          "accs": _host(r.accs)}
        # one process writes, the pair resumes
        d = os.path.join(tmp, f"{name}_by_one")
        if rank == 0:
            train(*data, one, cfg(3), checkpoint_dir=d, checkpoint_every=3)
        dist.barrier()
        r = train(*data, mesh, cfg(6), checkpoint_dir=d, checkpoint_every=3)
        multi[f"{name}_one_to_pair"] = {"w": _host(r.w),
                                        "accs": _host(r.accs)}
    # SSP: written at 2 global shards (one a process), resumed at 4
    d = os.path.join(tmp, "ssp_by_pair")
    _ssp_train("ssgd_fused_gather", get_mesh(2, device="cpu"), SSP_PLAN, 8,
               checkpoint_dir=d, checkpoint_every=4)
    r = _ssp_train("ssgd_fused_gather", mesh, SSP_PLAN, SSP_TICKS,
                   checkpoint_dir=d, checkpoint_every=4)
    multi["ssp_renegotiated"] = {"w": _host(r.w), "accs": _host(r.accs)}
    if rank == 0:
        d = os.path.join(tmp, "ssp_by_one")
        _ssp_train("ssgd_fused_gather", Mesh(n_data=2, device=one.device),
                   SSP_PLAN, 8, checkpoint_dir=d, checkpoint_every=4)
        r = _ssp_train("ssgd_fused_gather", one, SSP_PLAN, SSP_TICKS,
                       checkpoint_dir=d, checkpoint_every=4)
        single["ssp_renegotiated"] = {"w": _host(r.w), "accs": _host(r.accs)}
    # the tp split (one data shard a process, 2 model slices) in segments
    tp = ssgd.SSGDConfig(n_iterations=6, sampler="fused_gather",
                         feature_sharded=True, **FUSED)
    r = ssgd.train(*data, get_mesh(2, 2, device="cpu"), tp,
                   checkpoint_dir=os.path.join(tmp, "seg_tp"),
                   checkpoint_every=2)
    multi["seg_ssgd_tp"] = {"w": _host(r.w), "accs": _host(r.accs)}
    if rank == 0:
        r = ssgd.train(*data, Mesh(n_data=2, device=one.device, n_model=2),
                       tp)
        single["seg_ssgd_tp"] = {"w": _host(r.w), "accs": _host(r.accs)}
    # segments in the shared directory = one process's straight run
    for name, fn in _segmented_runs(data).items():
        r = fn(mesh, checkpoint_dir=os.path.join(tmp, name),
               checkpoint_every=2)
        multi[name] = {k: _host(v) for k, v in r.items()}
        if rank == 0:
            single[name] = {k: _host(v) for k, v in fn(one).items()}
    # a directory only this rank sees
    own = os.path.join(tmp, f"own_{rank}")
    try:
        ssgd.train(*data, mesh, _ckpt_cfg(3), checkpoint_dir=own,
                   checkpoint_every=3)
        raised = 0
    except ValueError as e:
        raised = int("not shared" in str(e) and own in str(e))
    multi["unshared"] = {"raised": np.int64(raised)}
    return multi, single


def _segmented_runs(data) -> dict:
    """The other trainers that checkpoint across processes, 6 steps or
    iterations: LR under int8 (its residual row-sharded), EASGD on
    ``fused_gather`` (its replicas row-sharded), k-means (Lloyd) and
    resident PageRank → {name: fn(mesh, **ckpt) → {key: tensor}}."""
    from tpu_distalg_torch.models import (
        easgd,
        kmeans,
        logistic_regression,
        pagerank,
    )
    from tpu_distalg_torch.utils import datasets

    pts = datasets.gaussian_mixture(2000, k=4, dim=4)
    edges = np.random.default_rng(5).integers(0, 300, size=(2000, 2))

    def lr(m, **ck):
        r = logistic_regression.train(*data, m, logistic_regression.LRConfig(
            n_iterations=6, comm="int8"), **ck)
        return {"w": r.w, "accs": r.accs}

    def ea(m, **ck):
        r = easgd.train(*data, m, easgd.EASGDConfig(
            n_iterations=6, sampler="fused_gather", **FUSED), **ck)
        return {"w": r.w, "ws": r.ws, "accs": r.accs}

    def km(m, **ck):
        r = kmeans.fit(pts, m, kmeans.KMeansConfig(k=4, n_iterations=6),
                       **ck)
        return {"centers": r.centers}

    def pr(m, **ck):
        r = pagerank.run(edges, m, pagerank.PageRankConfig(
            n_iterations=6, mode="standard"), 300, **ck)
        return {"ranks": r.ranks}

    return {"seg_lr_int8": lr, "seg_easgd": ea, "seg_kmeans": km,
            "seg_pagerank": pr}


def _worker(rank: int, world: int, init: str, outdir: str, procs: int,
            mode: str) -> None:
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import Mesh, comms, get_mesh
    from tpu_distalg_torch.parallel import mesh as pmesh
    from tpu_distalg_torch.utils import datasets

    share_host_threads(procs)
    pmesh.emulate_devices(2)
    pmesh.multihost_initialize(init, world, rank, device="cpu", timeout=120)
    try:
        mesh = get_mesh(device="cpu")          # 2 shards a process
        one = Mesh(n_data=mesh.n_data, device=torch.device("cpu"))
        flat = {}

        def add(prefix, results):
            flat.update({f"{prefix}/{n}/{k}": v for n, d in results.items()
                         for k, v in d.items()})

        if mode == "three":
            data = datasets.breast_cancer_split()
            got = {"groups": {"inferred": np.int64(
                comms.infer_groups(mesh))}}
            for label, m, comm in (("hier", mesh, "hier"),
                                   ("hier3", mesh, "hier:3")):
                r = ssgd.train(*data, m, ssgd.SSGDConfig(
                    n_iterations=STEPS, comm=comm, sampler="fused_gather",
                    **FUSED))
                got[label] = {"w": _host(r.w), "accs": _host(r.accs)}
            add("multi", got)
            if rank == 0:
                r = ssgd.train(*data, one, ssgd.SSGDConfig(
                    n_iterations=STEPS, comm="hier:3", sampler="fused_gather",
                    **FUSED))
                add("single", {"hier3": {"w": _host(r.w),
                                         "accs": _host(r.accs)}})
        else:
            add("multi", _workloads(mesh))
            add("multi", _bytes(mesh))
            multi, single = _checkpoints(mesh, one, rank, outdir)
            add("multi", multi)
            if rank == 0:
                add("single", _workloads(one))
                add("single", single)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **flat)
    finally:
        pmesh.shutdown()


# -------------------------------------------------------------- parent


def _threads_share(world: int) -> int:
    return world * int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)


def _spawn(cmd_for_rank, world: int, timeout=SPAWN_TIMEOUT_S):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(cmd_for_rank(r), cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def _group(tmp, world: int, mode: str) -> list[dict]:
    init = f"file://{tmp / 'rendezvous'}"
    rcs, outs = _spawn(lambda r: [
        sys.executable, os.path.abspath(__file__), "worker", str(r),
        str(world), init, str(tmp), str(_threads_share(world)), mode],
        world)
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
    loaded = []
    for r in range(world):
        with np.load(tmp / f"rank{r}.npz") as z:
            loaded.append({k: z[k] for k in z.files})
    return loaded


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pair's results: ``(rank0, rank1)`` dicts of name/key →
    array, rank 0's with the one-process results under ``single``."""
    return _group(tmp_path_factory.mktemp("multiproc_sync"), 2, "main")


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    return _group(tmp_path_factory.mktemp("multiproc_three"), 3, "three")


def _keys(run: dict, prefix: str, name: str) -> dict:
    p = f"{prefix}/{name}/"
    return {k[len(p):]: v for k, v in run.items() if k.startswith(p)}


#: results each process holds only its rows of (the replicas' models)
ROW_SHARDED = {(name, "ws") for name, _, _ in MA_RUNS} | {
    ("seg_easgd", "ws")}

NAMES = ([_name(smp, c) for smp, _ in SSGD_SAMPLERS for c in SCHEDULES]
         + ["lr_int8"] + [n for n, _, _ in MA_RUNS]
         + [_name("fused", c) for c in B5_SCHEDULES]
         + [n for n, _, _ in SSP_RUNS] + ["ssp_renegotiated",
                                           "bsp_straggler"]
         + ["seg_lr_int8", "seg_easgd", "seg_kmeans", "seg_pagerank",
            "seg_ssgd_tp"])


def _assert_equal_one_process(runs, name, single_name=None):
    r0, r1 = runs
    single = _keys(r0, "single", single_name or name)
    m0, m1 = _keys(r0, "multi", name), _keys(r1, "multi", name)
    assert single and set(single) == set(m0) == set(m1)
    for key, want in single.items():
        if (name, key) in ROW_SHARDED:
            got = np.concatenate([m0[key], m1[key]])
        else:
            assert m0[key].tobytes() == m1[key].tobytes(), key
            got = m0[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), (name, key)


@pytest.mark.parametrize("name", NAMES)
def test_two_processes_equal_one_bitwise(runs, name):
    """2 processes × 2 shards = 1 process × 4 shards, bit for bit, every
    schedule, SSP run, the renegotiated resume and the runs segmented
    through a shared directory (``seg_*``: LR, EASGD, k-means, PageRank
    against one process's straight run); the replicated results equal
    on both ranks, the replicas each rank's own rows."""
    _assert_equal_one_process(runs, name)


@pytest.mark.parametrize("name", ["ckpt_ssgd", "ckpt_ma"])
def test_checkpoints_cross_between_two_processes_and_one(runs, name):
    """Written by the pair, resumed by one process; written by one
    process, resumed by the pair: both equal one straight process
    bitwise (SSGD's topk residual and MA's replicas are row-sharded
    leaves of the file)."""
    r0, r1 = runs
    want = _keys(r0, "single", f"{name}_straight")
    for got in (_keys(r0, "single", f"{name}_pair_to_one"),
                _keys(r0, "multi", f"{name}_one_to_pair"),
                _keys(r1, "multi", f"{name}_one_to_pair")):
        assert set(got) == set(want)
        for key in want:
            assert got[key].tobytes() == want[key].tobytes(), (name, key)


def test_a_directory_not_shared_raises_on_both_ranks(runs):
    """Each rank given its own directory: after process 0 writes, the
    other sees no step, and both raise naming their directory."""
    for r in runs:
        assert int(_keys(r, "multi", "unshared")["raised"]) == 1


@pytest.mark.parametrize("comm", SCHEDULES)
def test_bytes_sent_equal_the_closed_form_and_undercut_dense(runs, comm):
    """A process's counted bytes a sync equal ``bytes_process`` on both
    ranks, and every schedule sends less than ``dense``'s all-gather of
    float32 partials; at 2 × 2, hier < bucketed < dense."""
    key = comm.replace(":", "_").replace("@", "_")
    for r in runs:
        b = _keys(r, "multi", "bytes")
        sent, model, _ = (int(x) for x in b[key])
        assert sent == model > 0, (comm, sent, model)
        assert sent < int(b["dense"][0]), (comm, sent)
        assert int(b["dense"][0]) == int(b["dense"][1])
        assert int(b["hier"][0]) < int(b["bucketed"][0]) < int(
            b["dense"][0])


def test_three_processes_infer_three_groups(three):
    """3 processes × 2 shards: ``hier`` infers the processes as its 3
    groups, equals ``hier:3``, and equals one process × 6 under
    ``hier:3`` bit for bit, on every rank."""
    want = _keys(three[0], "single", "hier3")
    for r in three:
        assert int(_keys(r, "multi", "groups")["inferred"]) == 3
        for label in ("hier", "hier3"):
            got = _keys(r, "multi", label)
            for key in want:
                assert got[key].tobytes() == want[key].tobytes(), (label,
                                                                  key)


@pytest.mark.parametrize("n,g", [(2, 1), (3, 3), (4, 2), (6, 2), (6, 3)])
def test_stepwise_rings_equal_the_one_process_folds(n, g):
    """The step-by-step rings the processes run, on one process's stack
    (every hop a copy on the device), equal the one-process folds bit
    for bit: the same adds in the same order. No process is spawned."""
    from tpu_distalg_torch.parallel import Mesh, comms

    mesh = Mesh(n_data=n, device=torch.device("cpu"))
    v = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, 3, n * 10)).astype(np.float32))
    assert torch.equal(comms._ring_allreduce_across(v, mesh),
                       comms._ring_allreduce(v))
    assert torch.equal(comms._hier_allreduce_across(v, g, mesh),
                       comms._hier_allreduce(v, g))


def test_closed_form_at_two_by_two():
    """The worked cases: at 2 processes × 2 shards, E float32 elements
    (E a multiple of 4) cost a process 8E bytes dense, 6E bucketed
    (2(n−1)/n · 4E) and 4E under hier ((P−1) · 4E); with one process
    nothing is sent."""
    from tpu_distalg_torch.parallel import comms

    E = 4096

    def sent(schedule, processes=2):
        return comms.process_bytes(schedule, processes=processes,
                                   n_shards=4, leaves=[(E, 4, True)],
                                   groups=2)

    assert (sent("dense"), sent("bucketed"), sent("hier")) == (
        8 * E, 6 * E, 4 * E)
    assert {sent(c, processes=1) for c in ("dense", "hier", "int8")} == {0}


# ---------------------------------------------------------- against JAX


def _jax_mesh(data):
    import jax

    from tpu_distalg.parallel import get_mesh as jget_mesh

    return jget_mesh(data=data, devices=jax.devices()[:data])


def _close(got, want, rel):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _quiet(fn, *a, **kw):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # coarse-fraction geometry warn
        return fn(*a, **kw)


@pytest.mark.parametrize("smp,fields", SSGD_SAMPLERS,
                         ids=[s for s, _ in SSGD_SAMPLERS])
@pytest.mark.parametrize("comm", SCHEDULES)
def test_ssgd_schedules_across_processes_match_jax(runs, smp, fields, comm):
    """ROADMAP C's standard (``tests/test_torch_comms_trainers.py``):
    1e-5 of the largest |w| at 5 steps, the accuracies equal."""
    from tpu_distalg.models import ssgd as jssgd
    from tpu_distalg.utils import datasets as jdatasets

    want = _quiet(jssgd.train, *jdatasets.breast_cancer_split(),
                  _jax_mesh(4), jssgd.SSGDConfig(n_iterations=STEPS,
                                                 comm=comm, **fields))
    got = _keys(runs[0], "multi", _name(smp, comm))
    _close(got["w"], want.w, 1e-5)
    np.testing.assert_array_equal(got["accs"], np.asarray(want.accs))


def test_lr_int8_across_processes_matches_jax(runs):
    from tpu_distalg.models import logistic_regression as jlr
    from tpu_distalg.utils import datasets as jdatasets

    want = jlr.train(*jdatasets.breast_cancer_split(), _jax_mesh(4),
                     jlr.LRConfig(n_iterations=STEPS, comm="int8"))
    got = _keys(runs[0], "multi", "lr_int8")
    _close(got["w"], want.w, 1e-5)
    np.testing.assert_array_equal(got["accs"], np.asarray(want.accs))


@pytest.mark.parametrize("name,smp,comm", MA_RUNS,
                         ids=[n for n, _, _ in MA_RUNS])
def test_ma_schedules_across_processes_match_jax(runs, name, smp, comm):
    """The center within 1e-5 of the largest |w| after 5 rounds, the
    replicas (each rank's own two) within 1e-5, 1e-4 under topk."""
    from tpu_distalg.models import ma as jma
    from tpu_distalg.utils import datasets as jdatasets

    want = _quiet(jma.train, *jdatasets.breast_cancer_split(), _jax_mesh(4),
                  jma.MAConfig(n_iterations=STEPS, sampler=smp, comm=comm,
                               **FUSED))
    got = _keys(runs[0], "multi", name)
    _close(got["w"], want.w, 1e-5)
    _close(np.concatenate([_keys(r, "multi", name)["ws"] for r in runs]),
           want.ws, 1e-4 if comm.startswith("topk") else 1e-5)


@pytest.mark.parametrize("name,kind,plan",
                         [r for r in SSP_RUNS if r[1] != "ssgd_fused"],
                         ids=[r[0] for r in SSP_RUNS
                              if r[1] != "ssgd_fused"])
def test_ssp_across_processes_matches_jax(runs, name, kind, plan):
    """``tests/test_torch_ssp.py``'s standard under the same plan: the
    accuracy history equal, w within 1e-5 of the largest |w|."""
    import importlib

    from tpu_distalg import faults as jfaults
    from tpu_distalg.utils import datasets as jdatasets

    data = jdatasets.breast_cancer_split()
    jfaults.configure(plan)
    try:
        if kind == "ma":
            jma = importlib.import_module("tpu_distalg.models.ma")
            want = jma.train(*data, _jax_mesh(4), jma.MAConfig(
                n_iterations=SSP_TICKS, sync="ssp:2"))
        else:
            from tpu_distalg.models import ssgd as jssgd

            want = _quiet(jssgd.train, *data, _jax_mesh(4),
                          jssgd.SSGDConfig(n_iterations=SSP_TICKS,
                                           sync="ssp:2",
                                           sampler="fused_gather", **FUSED))
    finally:
        jfaults.configure(False)
    got = _keys(runs[0], "multi", name)
    np.testing.assert_array_equal(got["accs"], np.asarray(want.accs))
    _close(got["w"], want.w, 1e-5)


def test_three_processes_hier_matches_jax_on_six_devices(three):
    from tpu_distalg.models import ssgd as jssgd
    from tpu_distalg.utils import datasets as jdatasets

    want = _quiet(jssgd.train, *jdatasets.breast_cancer_split(),
                  _jax_mesh(6), jssgd.SSGDConfig(
                      n_iterations=STEPS, comm="hier:3",
                      sampler="fused_gather", **FUSED))
    got = _keys(three[0], "multi", "hier")
    _close(got["w"], want.w, 1e-5)
    np.testing.assert_array_equal(got["accs"], np.asarray(want.accs))


# ------------------------------------------------------------- the CLI


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_argv(*argv):
    return [sys.executable, "-m", "tpu_distalg_torch.cli", "--device",
            "cpu", *argv]


@pytest.mark.parametrize("argv", [
    ["ssgd", "--sampler", "fused_gather", "--fused-pack", "4",
     "--gather-block-rows", "32", "--shuffle-seed", "0", "--comm", "hier",
     "--n-iterations", "20", "--quiet"],
    ["ma", "--sync", "ssp:2", "--n-iterations", "8", "--quiet"],
    ["ssgd", "--checkpoint-dir", "{tmp}", "--checkpoint-every", "10",
     "--n-iterations", "20", "--quiet"],
], ids=["comm", "ssp", "checkpoint"])
def test_cli_runs_under_multihost_as_one_process(tmp_path, argv):
    """Two CLI processes of 2 shards each print the ``Final acc`` line
    that one process prints with ``--emulate 4``."""
    def argv_in(d):
        return [a.replace("{tmp}", str(d)) for a in argv]

    def final(out):
        return [ln for ln in out.splitlines() if ln.startswith("Final acc")]

    coord = f"127.0.0.1:{_free_port()}"
    rcs, outs = _spawn(lambda r: _cli_argv(
        "--emulate", "2", "--multihost", "--coordinator-address", coord,
        "--num-processes", "2", "--process-id", str(r),
        *argv_in(tmp_path / "pair")), 2)
    (rc,), (one,) = _spawn(lambda r: _cli_argv(
        "--emulate", "4", *argv_in(tmp_path / "one")), 1)
    assert rc == 0, one[-4000:]
    want = final(one)
    assert len(want) == 1, one[-4000:]
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
        assert final(out) == want, out[-4000:]


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
            int(sys.argv[6]), sys.argv[7])
