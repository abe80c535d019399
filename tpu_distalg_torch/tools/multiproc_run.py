"""The data axis across processes at full width, one process's part.

    python -m tpu_distalg_torch.tools.multiproc_run --out DIR \\
        [--init file:///path --world 2 --rank 0] [--workloads a,b,...]
    python -m tpu_distalg_torch.tools.multiproc_run --out DIR \\
        --trees build/parent . --runs 5   # one-process arms, tree by tree

Runs the workloads that cross processes on the card at bench.py's
geometries on 2 global data shards (a 2×2 mesh for the tp split) and
writes what they return (weights, centres, ranks: ``rank<r>.npz``, or
``single.npz`` without ``--init``) and what they cost
(``rank<r>.json``/``single.json``). Each workload runs once untimed (its
profiled window, or the whole run), then ``--runs`` times timed, each
with every counter at 0: the runs' seconds, the steps/s of their
median, the kernel launches (it raises unless they are this process's
shards × its steps) and, in a group, the last run's collectives, the
bytes this process sent and its host-staging copies with their
seconds. Then, unless ``--no-profile``, the window goes
through :func:`..profiling.window`, whose idle share is its device time
under the profiler over the wall time of the same window unprofiled.
``--world 1`` is a group of one, which takes the NCCL backend; two
ranks on one card take gloo (:func:`..utils.device.choose_backend`).

The one-process arm (no ``--init``) calls only what the port had before
its process group: the trainers, ``get_mesh`` and the kernels' launch
counts. So ``--trees`` can run it in an older checkout too (from
``git archive``; ``.`` is this one): each tree in its own process with
its own build of the kernels, the trees in turn :data:`TREE_ROUNDS`
times, every other round in reverse order (A B, B A, A B, …); every
result must be equal across all the runs bit for bit, and each run's
rates are printed.

  * ``ssgd_fused_gather``: 1,048,576 rows × 126 (bench.py:90-102, made
    on the card, bf16, pack 16, 8192-row blocks), 1500 steps, B1;
  * ``ssgd_fused``: the same rows through B5, 1500 steps;
  * ``ma_fused_train`` / ``ma_fused_gather``: MA at bench.py's MA
    geometry (300 rounds × 5 local steps) on those rows, B2 / B1;
  * ``ssgd_tp``: ``fused_gather`` on the host-made two-class rows of
    the same size over a 2×2 mesh, 1500 steps, B3 and B4;
  * ``kmeans_fused``: 10,000,000 points × 16, k 8, 50 Lloyd iterations
    through B10;
  * ``pagerank_auto`` / ``pagerank_pallas``: 1,000,000 vertices,
    Erdős–Rényi of average degree 8, 50 standard-mode iterations
    through B7 / B8.

The sync layer's workloads (``sync_*``) run at chip_smoke phase 13's
geometry instead: the same packed rows on bench.py's canonical comm
mesh, 4 global data shards (2 a rank in a pair), 3 of 32 blocks a shard
a step:

  * ``sync_<schedule>``: ``fused_gather`` under each of
    :data:`SYNC_SCHEDULES`, :data:`SYNC_STEPS` steps; in a group the run
    raises unless the bytes this process sent equal the steps times the
    schedule's closed form (``comms.process_bytes``), beside which the
    record keeps ``dense``'s;
  * ``sync_ma_int8`` / ``sync_ma_topk``: MA ``fused_train`` (B2) under
    int8 and topk, :data:`SYNC_MA_ROUNDS` rounds;
  * ``sync_ssp_straggle`` / ``sync_ssp_leave``: ``fused_gather`` under
    ``ssp:8`` with the straggle plan and the leave plan,
    :data:`SYNC_SSP_TICKS` ticks;
  * ``sync_bsp_straggler`` / ``sync_ssp_straggler``: bench.py's SSP
    straggler bench (chip_smoke phase 13's: 4096 rows × 31 of the
    normalised two-class task on ``bernoulli``, the straggle plan,
    :data:`SSP_BENCH_STEPS` steps, run :data:`SSP_BENCH_REPEATS` times
    a call), its BSP arm (every step waits for its straggle work and
    the psum) and ``ssp:8`` (one merge a window): the speedup is the
    second's rate over the first's;
  * ``sync_ckpt``: a checkpointed ``fused_gather`` run under topk split
    across a restart: a group trains the first half into ``OUT/ckpt``;
    one process (run after it) resumes that directory to the end and
    also trains the whole run straight (``w_resumed``, ``w``) and the
    first half (``w_half``, which the group returns too).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

SSGD_ROWS, SSGD_FEATURES, SSGD_GBR, SSGD_STEPS = 1 << 20, 125, 8192, 1500
MA_ROUNDS, MA_L = 300, 5
KM_POINTS, KM_DIM, KM_K, KM_ITERS = 10_000_000, 16, 8, 50
PR_VERTICES, PR_DEGREE, PR_ITERS = 1_000_000, 8.0, 50
N_DATA = 2
#: steps (rounds) of the window that warms a long run and is profiled:
#: the profiler's own host cost a step would stretch a whole 1500-step
#: run's profiled copy to many seconds
PROFILE_STEPS, PROFILE_ROUNDS = 100, 20
#: rounds of one process a tree in ``--trees``, ten pairs: the
#: host-bound rates of one process spread by up to 2× between
#: processes, so a few pairs say nothing
TREE_ROUNDS = 10
#: the sync layer's geometry (chip_smoke.py phase 13): bench.py's
#: canonical comm mesh, the schedules, the plans of its SSP runs
SYNC_SHARDS = 4
SYNC_SCHEDULES = ("dense", "bucketed", "hier", "bf16", "int8", "int8@seq",
                  "topk:0.01")
SYNC_STEPS, SYNC_MA_ROUNDS, SYNC_SSP_TICKS, SYNC_CKPT_STEPS = 200, 40, 200, 200
SYNC_PROFILE_STEPS, SYNC_PROFILE_ROUNDS, SYNC_SSP_S = 50, 10, 8
SSP_PLAN = "seed=7;shard:straggle@p0.25=straggle:800"
SSP_LEAVE_PLAN = SSP_PLAN + ";shard:leave@p0.05=leave:2"
SSP_BENCH_STEPS, SSP_BENCH_REPEATS = 64, 3
SYNC_WORKLOADS = tuple(
    "sync_" + c.split(":")[0].replace("@", "_") for c in SYNC_SCHEDULES) + (
    "sync_ma_int8", "sync_ma_topk", "sync_ssp_straggle", "sync_ssp_leave",
    "sync_bsp_straggler", "sync_ssp_straggler", "sync_ckpt")
WORKLOADS = ("ssgd_fused_gather", "ssgd_fused", "ma_fused_train",
             "ma_fused_gather", "ssgd_tp", "kmeans_fused", "pagerank_auto",
             "pagerank_pallas") + SYNC_WORKLOADS


def _kernels():
    from tpu_distalg_torch.ops import kmeans_kernels, pagerank_kernels
    from tpu_distalg_torch.ops import ssgd_kernels

    return (ssgd_kernels.KERNELS + pagerank_kernels.KERNELS
            + kmeans_kernels.KERNELS)


def _counts() -> dict:
    return {k.__name__: k.launches for k in _kernels() if k.launches}


def _barrier(group: bool) -> None:
    """Line the ranks up, so that no rank's timed run waits out another's
    set-up."""
    if group:
        import torch.distributed as dist

        dist.barrier()


def _measure(dev, built, group: bool, profiled: bool,
             runs: int = 1) -> tuple:
    """Warm, then ``runs`` timed runs, each with every counter at 0: the
    last one's output, the runs' seconds, the steps/s of their median,
    the launches (raising unless they are what the workload wants), in
    a group the last run's collectives' counters and the host copies'
    share of its wall time; then, if ``profiled``, the window's
    :func:`..profiling.window` record."""
    run, steps, want, window = built
    short, n_short = window or (run, steps)
    short()
    torch.cuda.synchronize(dev)
    if group:
        from tpu_distalg_torch.parallel import collectives
    times = []
    for _ in range(runs):
        _barrier(group)
        for k in _kernels():
            k.launches = 0
        if group:
            collectives.reset_counters()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        times.append(secs)
        launches = _counts()
        if launches != want:
            raise AssertionError(f"launched {launches}, want {want}")
    stats = {"steps": steps, "runs_seconds": times,
             "seconds": float(np.median(times)),
             "steps_per_s": steps / float(np.median(times)),
             "launches": launches}
    if group:
        d = dict(collectives.COUNTERS)
        stats.update(dist=d,
                     host_copy_share=d["host_copy_seconds"] / secs)
    if profiled:
        from tpu_distalg_torch.tools import profiling

        _barrier(group)
        w = profiling.window(short, n_short)
        stats.update(window_steps=n_short,
                     window_wall_us_per_step=w["wall_us_per_step"],
                     device_us_per_step=w["device_us_per_step"],
                     idle_share=w["device_idle_share"])
    return out, stats


def _rows(mesh, cache: dict):
    """SSGD's packed rows made on the card, once for the four workloads
    that read them (``fused``'s blocks equal ``fused_gather``'s here, so
    the packing is the same): ``(X2, w0, meta)``."""
    from tpu_distalg_torch.models import ssgd

    key = ("rows", mesh.n_data)
    if key not in cache:
        cfg = ssgd.SSGDConfig(sampler="fused_gather", x_dtype="bfloat16",
                              gather_block_rows=SSGD_GBR, shuffle_seed=0,
                              init_seed=7)
        _, X2, w0, meta = ssgd.prepare_fused_synthetic(
            SSGD_ROWS, SSGD_FEATURES, mesh, cfg)
        cache[key] = (X2, w0, meta)
    return cache[key]


def _ssgd(mesh, held: int, sampler: str, cache: dict):
    from tpu_distalg_torch.models import ssgd

    cfg = ssgd.SSGDConfig(
        n_iterations=SSGD_STEPS, eval_test=False, x_dtype="bfloat16",
        sampler=sampler, gather_block_rows=SSGD_GBR,
        fused_block_rows=SSGD_GBR, shuffle_seed=0, init_seed=7)
    X2, w0, meta = _rows(mesh, cache)
    fn = ssgd.make_train_fn_fused(mesh, cfg, meta)
    short = ssgd.make_train_fn_fused(
        mesh, dataclasses.replace(cfg, n_iterations=PROFILE_STEPS), meta)
    te = (torch.zeros((1, meta["d_total"]), device=mesh.device),
          torch.zeros((1,), device=mesh.device))
    key = ("fused_grad_sum_gathered" if sampler == "fused_gather"
           else "fused_grad_sum_packed")
    return (lambda: {"w": fn(X2, None, None, *te, w0)[0]}, SSGD_STEPS,
            {key: held * SSGD_STEPS},
            (lambda: short(X2, None, None, *te, w0), PROFILE_STEPS))


def _ma(mesh, held: int, sampler: str, cache: dict, group: bool):
    from tpu_distalg_torch.models import local_sgd

    X2, _, meta = _rows(mesh, cache)
    cfg = local_sgd.LocalSGDConfig(
        n_iterations=MA_ROUNDS, n_local_iterations=MA_L, eval_test=False,
        sampler=sampler, x_dtype="bfloat16", gather_block_rows=SSGD_GBR,
        shuffle_seed=0)
    fn = local_sgd.make_train_fn_fused(mesh, cfg, meta)
    short = local_sgd.make_train_fn_fused(
        mesh, dataclasses.replace(cfg, n_iterations=PROFILE_ROUNDS), meta)
    st = local_sgd.init_state(cfg, SSGD_FEATURES + 1, meta["d_total"],
                              mesh.n_data, mesh.device)
    if group:   # this process's replicas (all of them in one process)
        st = local_sgd.placed_state(st, mesh)
    te = (torch.zeros((1, meta["d_total"]), device=mesh.device),
          torch.zeros((1,), device=mesh.device))

    def run():
        w, ws, _, _ = fn(X2, *te, *st)
        return {"w": w, "ws": ws}

    if sampler == "fused_train":
        want = {"fused_train_gathered": held * MA_ROUNDS}
    else:
        want = {"fused_grad_sum_gathered": held * MA_ROUNDS * MA_L}
    return (run, MA_ROUNDS, want,
            (lambda: short(X2, *te, *st), PROFILE_ROUNDS))


def _tp(mesh, held: int):
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.utils import datasets

    X, y = datasets.synthetic_two_class(SSGD_ROWS, SSGD_FEATURES, seed=0)
    X = datasets.add_bias_column(X)
    cfg = ssgd.SSGDConfig(
        n_iterations=SSGD_STEPS, eval_test=False, x_dtype="bfloat16",
        sampler="fused_gather", gather_block_rows=SSGD_GBR, shuffle_seed=0,
        init_seed=7, feature_sharded=True)
    fn, X2, w0, meta = ssgd.prepare_fused_tp(X, y, mesh, cfg)
    del X
    short = ssgd.make_train_fn_fused_tp(
        mesh, dataclasses.replace(cfg, n_iterations=PROFILE_STEPS), meta)
    te = (torch.zeros((1, meta["n_model"] * meta["d_total"]),
                      device=mesh.device),
          torch.zeros((1,), device=mesh.device))
    n = held * mesh.n_model * SSGD_STEPS
    return (lambda: {"w": fn(X2, None, None, *te, w0)[0]}, SSGD_STEPS,
            {"fused_forward_gathered": n, "fused_backward_gathered": n},
            (lambda: short(X2, None, None, *te, w0), PROFILE_STEPS))


def _kmeans(mesh, held: int):
    from tpu_distalg_torch.models import kmeans
    from tpu_distalg_torch.parallel import build_sharded
    from tpu_distalg_torch.utils import datasets

    make_rows, _ = datasets.gaussian_mixture_rows(k=KM_K, dim=KM_DIM,
                                                  seed=0, spread=8.0)
    cfg = kmeans.KMeansConfig(k=KM_K, n_iterations=KM_ITERS, seed=0,
                              init="farthest")
    ps = build_sharded(mesh, KM_POINTS, make_rows)
    c0 = kmeans.init_centers_scaled(make_rows, KM_POINTS, cfg, mesh.device)
    X2, m2 = kmeans.pack_device(mesh, ps.data, ps.mask, dim=KM_DIM, k=KM_K)
    fit = kmeans.make_fit_fn_fused(mesh, cfg, KM_DIM)
    return (lambda: {"centers": fit(X2, m2, c0)[0]}, KM_ITERS,
            {"fused_cluster_stats": held * KM_ITERS}, None)


def _pagerank(mesh, held: int, scatter: str, cache: dict):
    from tpu_distalg_torch.models import pagerank
    from tpu_distalg_torch.ops import graph as gops
    from tpu_distalg_torch.utils import datasets

    if "de" not in cache:
        edges = datasets.erdos_renyi_edges(PR_VERTICES, PR_DEGREE, seed=0)
        cache["de"] = pagerank.prepare_device_edges(
            gops.prepare_edges(edges, PR_VERTICES), mesh)
    de = cache["de"]
    cfg = pagerank.PageRankConfig(n_iterations=PR_ITERS, mode="standard",
                                  scatter=scatter)
    key = "spmv_table" if scatter == "auto" else "scatter_table"
    return (lambda: {"ranks": pagerank.run_prepared(de, mesh, cfg).ranks},
            PR_ITERS, {key: held * PR_ITERS}, None)


def _sync_schedule(name: str) -> str:
    return next(c for c in SYNC_SCHEDULES
                if "sync_" + c.split(":")[0].replace("@", "_") == name)


def _sync_cfg(**kw):
    from tpu_distalg_torch.models import ssgd

    return ssgd.SSGDConfig(
        eval_test=False, x_dtype="bfloat16", sampler="fused_gather",
        gather_block_rows=SSGD_GBR, shuffle_seed=0, init_seed=7, **kw)


def _te(mesh, d: int) -> tuple:
    return (torch.zeros((1, d), device=mesh.device),
            torch.zeros((1,), device=mesh.device))


def _sync_bytes(mesh, comm: str, d: int, syncs: int) -> tuple[int, int]:
    """The closed forms of the bytes this process sends over ``syncs``
    syncs of SSGD's (Σ grad, count) pair: the schedule's, and
    ``dense``'s all-gather of partials."""
    from tpu_distalg_torch.parallel import comms

    leaves = (comms.leaf((d,)), comms.leaf(()))
    return tuple(syncs * comms.make_sync(c, mesh, leaves).bytes_process()
                 for c in (comm, "dense"))


def _sync_ssgd(mesh, held: int, comm: str, cache: dict):
    """``fused_gather`` under ``comm`` at phase 13's geometry."""
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import comms, partition

    X2, w0, meta = _rows(mesh, cache)
    d = meta["d_total"]
    cfg = _sync_cfg(n_iterations=SYNC_STEPS, comm=comm)
    fn = ssgd.make_train_fn_fused(mesh, cfg, meta)
    short = ssgd.make_train_fn_fused(
        mesh, dataclasses.replace(cfg, n_iterations=SYNC_PROFILE_STEPS),
        meta)
    res = ()
    if comm != "dense":
        sync = comms.make_sync(comm, mesh, (comms.leaf((d,)),
                                            comms.leaf(())))
        res = (partition.place({"res": sync.init_state()}, "ssgd",
                               mesh)["res"],)
    te = _te(mesh, d)
    return (lambda: {"w": fn(X2, None, None, *te, w0, *res)[0]}, SYNC_STEPS,
            {"fused_grad_sum_gathered": held * SYNC_STEPS},
            (lambda: short(X2, None, None, *te, w0, *res),
             SYNC_PROFILE_STEPS))


def _sync_ma(mesh, held: int, comm: str, cache: dict):
    """MA ``fused_train`` (B2) under ``comm``."""
    from tpu_distalg_torch.models import local_sgd
    from tpu_distalg_torch.parallel import comms, partition

    X2, _, meta = _rows(mesh, cache)
    d = meta["d_total"]
    cfg = local_sgd.LocalSGDConfig(
        n_iterations=SYNC_MA_ROUNDS, n_local_iterations=MA_L,
        eval_test=False, sampler="fused_train", x_dtype="bfloat16",
        gather_block_rows=SSGD_GBR, shuffle_seed=0, comm=comm)
    fn = local_sgd.make_train_fn_fused(mesh, cfg, meta)
    short = local_sgd.make_train_fn_fused(
        mesh, dataclasses.replace(cfg, n_iterations=SYNC_PROFILE_ROUNDS),
        meta)
    st = local_sgd.placed_state(local_sgd.init_state(
        cfg, SSGD_FEATURES + 1, d, mesh.n_data, mesh.device), mesh)
    sync = comms.make_sync(comm, mesh, (comms.leaf((d,)),))
    res = partition.place({"res": sync.init_state()}, "local_sgd",
                          mesh)["res"]
    te = _te(mesh, d)

    def run():
        w, ws, *_ = fn(X2, *te, *st, res)
        return {"w": w, "ws": ws}

    return (run, SYNC_MA_ROUNDS,
            {"fused_train_gathered": held * SYNC_MA_ROUNDS},
            (lambda: short(X2, *te, *st, res), SYNC_PROFILE_ROUNDS))


def _sync_ssp(mesh, held: int, plan: str, cache: dict):
    """``fused_gather`` under ``ssp:8`` and a fault plan (configured
    for each call, so every call replays it)."""
    from tpu_distalg_torch import faults
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import ssp as pssp

    X2, w0, meta = _rows(mesh, cache)
    te = _te(mesh, meta["d_total"])

    def call(ticks):
        faults.configure(plan)
        try:
            res, _ = ssgd.train_prepared_ssp(
                mesh, _sync_cfg(n_iterations=ticks,
                                sync=f"ssp:{SYNC_SSP_S}"),
                (X2, None, None), *te, w0, n_padded=meta["n_padded"],
                meta=meta)
        finally:
            faults.configure(False)
        return {"w": res.w}

    ticks = pssp.window_grid(SYNC_SSP_TICKS, SYNC_SSP_S)[1]
    return (lambda: call(SYNC_SSP_TICKS), SYNC_SSP_TICKS,
            {"fused_grad_sum_gathered": held * ticks},
            (lambda: call(SYNC_PROFILE_STEPS), SYNC_PROFILE_STEPS))


def _ssp_bench(mesh, ssp: bool):
    """bench.py's straggler bench, its BSP arm or ``ssp:8``, repeated
    :data:`SSP_BENCH_REPEATS` times a call."""
    from tpu_distalg_torch import faults
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import parallelize, partition
    from tpu_distalg_torch.parallel import ssp as pssp
    from tpu_distalg_torch.utils import datasets

    X, y = datasets.synthetic_two_class(4096 + 1024, 30, seed=0)
    X = datasets.add_bias_column(X)
    d = X.shape[1]
    Xs, ys = parallelize(X[:4096], mesh), parallelize(y[:4096], mesh)
    te = _te(mesh, d)
    w0 = torch.zeros((d,), device=mesh.device)
    n_win, padded = pssp.window_grid(SSP_BENCH_STEPS, SYNC_SSP_S)
    extra = pssp.compile_straggle_schedule(
        padded, mesh.n_data, plan=faults.FaultPlan.parse(SSP_PLAN))
    extra[SSP_BENCH_STEPS:] = 0
    cfg = ssgd.SSGDConfig(n_iterations=SSP_BENCH_STEPS, eval_test=False)
    if not ssp:
        fn = ssgd.make_bsp_straggler_fn(mesh, cfg, Xs.n_padded, extra)

        def once():
            return fn(Xs.data, ys.data, Xs.mask, *te, w0)[0]
    else:
        cfg = dataclasses.replace(cfg, sync=f"ssp:{SYNC_SSP_S}")
        fn = ssgd.make_ssp_train_fn(
            mesh, cfg, Xs.n_padded, d, active=(True,) * mesh.n_data,
            n_win_seg=n_win, total_ticks=SSP_BENCH_STEPS)
        st = partition.place(dict(zip(
            ("w", "clocks", "pend", "basegen", "wl", "accd", "res"),
            ssgd.ssp_init_state(mesh, cfg, d, w=w0))), "ssgd", mesh)
        seg = extra.reshape(n_win, SYNC_SSP_S, mesh.n_data)

        def once():
            return fn(Xs.data, ys.data, Xs.mask, *te, st["w"], st["clocks"],
                      st["pend"], st["basegen"], st["wl"], st["accd"],
                      st["res"], seg, 0)[0]

    def run():
        for _ in range(SSP_BENCH_REPEATS):
            w = once()
        return {"w": w}

    return (run, SSP_BENCH_STEPS * SSP_BENCH_REPEATS, {},
            (once, SSP_BENCH_STEPS))


def _sync_ckpt(mesh, group: bool, out_dir: str, cache: dict) -> dict:
    """``sync_ckpt``: a group trains the first half into ``out_dir/ckpt``
    (process 0 writes); one process resumes it to the end and trains the
    whole and the half straight. Untimed: each call changes the
    directory."""
    from tpu_distalg_torch.models import ssgd

    X2, w0, meta = _rows(mesh, cache)
    te = _te(mesh, meta["d_total"])
    half, d = SYNC_CKPT_STEPS // 2, os.path.join(out_dir, "ckpt")

    def train(n, ckpt=None):
        return ssgd.train_prepared(
            mesh, _sync_cfg(n_iterations=n, comm="topk:0.01"), X2, w0, meta,
            *te, checkpoint_dir=ckpt, checkpoint_every=half).w

    if group:
        return {"w_half": train(half, d)}
    if not os.path.isdir(d):
        raise AssertionError(f"sync_ckpt: no group wrote {d}")
    return {"w_resumed": train(SYNC_CKPT_STEPS, d),
            "w": train(SYNC_CKPT_STEPS), "w_half": train(half)}


def run(out_dir: str, workloads, *, init: str | None = None,
        world: int = 0, rank: int = 0, profiled: bool = True,
        runs: int = 1) -> dict:
    """Run ``workloads`` in this process (a rank of a ``world``-process
    group meeting at ``init``, or alone) and write its two files.
    ``profiled`` adds each workload's profiled window. Every arm takes
    half the host's cores, a pair's share, so the arms' CPU work
    matches."""
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils.device import share_host_threads

    share_host_threads(2)
    group = init is not None
    info = {}
    if group:
        from tpu_distalg_torch.parallel import mesh as pmesh

        info["backend"] = pmesh.multihost_initialize(
            init, world, rank, device="cuda", timeout=600)
    try:
        mesh = get_mesh(N_DATA, device="cuda")
        mesh22 = (get_mesh(N_DATA, 2, device="cuda")
                  if "ssgd_tp" in workloads else None)
        mesh4 = get_mesh(SYNC_SHARDS, device="cuda")
        held = mesh.n_local if group else mesh.n_data
        held4 = mesh4.n_local if group else mesh4.n_data
        if group:
            info.update(process_count=mesh.process_count,
                        local_data=list(mesh.local_data))
        arrays, stats, cache = {}, {}, {}
        for name in workloads:
            t0 = time.perf_counter()
            if name == "sync_ckpt":
                _barrier(group)
                from tpu_distalg_torch.parallel import collectives

                collectives.reset_counters()
                out = _sync_ckpt(mesh4, group, out_dir, cache)
                torch.cuda.synchronize(mesh4.device)
                stats[name] = {"seconds": time.perf_counter() - t0,
                               **({"dist": dict(collectives.COUNTERS)}
                                  if group else {})}
                for k, v in out.items():
                    arrays[f"{name}/{k}"] = v.detach().cpu().numpy()
                continue
            expect = None
            if name.startswith("sync_ma_"):
                built = _sync_ma(mesh4, held4, {"sync_ma_int8": "int8"}.get(
                    name, "topk:0.01"), cache)
            elif name.endswith("_straggler"):
                built = _ssp_bench(mesh4, name == "sync_ssp_straggler")
            elif name.startswith("sync_ssp_"):
                built = _sync_ssp(mesh4, held4, SSP_PLAN if name.endswith(
                    "straggle") else SSP_LEAVE_PLAN, cache)
            elif name in SYNC_WORKLOADS:
                comm = _sync_schedule(name)
                built = _sync_ssgd(mesh4, held4, comm, cache)
                if group:
                    expect = _sync_bytes(mesh4, comm, _rows(mesh4, cache)[2][
                        "d_total"], SYNC_STEPS)
            elif name.startswith("ssgd_fused"):
                built = _ssgd(mesh, held, name[len("ssgd_"):], cache)
            elif name.startswith("ma_"):
                built = _ma(mesh, held, name[len("ma_"):], cache, group)
            elif name == "ssgd_tp":
                built = _tp(mesh22, held)
            elif name == "kmeans_fused":
                built = _kmeans(mesh, held)
            else:
                built = _pagerank(mesh, held, name.split("_")[1], cache)
            torch.cuda.synchronize(mesh.device)
            setup = time.perf_counter() - t0
            try:
                out, st = _measure(mesh.device, built, group, profiled,
                                   runs)
                if expect is not None:
                    closed, dense = expect
                    sent = st["dist"]["bytes_sent"]
                    if sent != closed:
                        raise AssertionError(
                            f"sent {sent} B, the closed form says "
                            f"{closed} B")
                    st.update(bytes_closed_form=closed, bytes_dense=dense)
            except AssertionError as e:
                raise AssertionError(f"{name}: {e}") from None
            stats[name] = dict(st, setup_seconds=setup)
            for k, v in out.items():
                arrays[f"{name}/{k}"] = v.detach().cpu().numpy()
            del out, built
        tag = f"rank{rank}" if group else "single"
        np.savez(os.path.join(out_dir, f"{tag}.npz"), **arrays)
        info.update(device=str(mesh.device), stats=stats)
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
            json.dump(info, f)
        return info
    finally:
        if group:
            pmesh.shutdown()


def compare_trees(out_dir: str, trees, names, runs: int) -> bool:
    """The one-process arm of each tree in its own process, the trees in
    turn :data:`TREE_ROUNDS` times (every other round reversed), then every
    result compared across all the runs bit for bit; prints the verdict
    and each run's rates in the order run, returns the verdict."""
    import subprocess
    import sys

    results = []
    for i in range(TREE_ROUNDS):
        for tree in (trees if i % 2 == 0 else trees[::-1]):
            root = os.path.abspath(tree)
            sub = os.path.join(os.path.abspath(out_dir),
                               f"run{len(results)}")
            os.makedirs(sub, exist_ok=True)
            subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--out", sub,
                 "--workloads", ",".join(names), "--no-profile",
                 "--runs", str(runs)], cwd=root,
                env=dict(os.environ, PYTHONPATH=root), check=True)
            with np.load(os.path.join(sub, "single.npz")) as z:
                arrays = {k: z[k] for k in z.files}
            with open(os.path.join(sub, "single.json")) as f:
                rates = {k: [v["steps"] / t for t in v["runs_seconds"]]
                         for k, v in json.load(f)["stats"].items()}
            results.append((tree, arrays, rates))
    base = results[0][1]
    same = all(set(a) == set(base) and all(
        a[k].tobytes() == base[k].tobytes() for k in base)
        for _, a, _ in results[1:])
    print(json.dumps({"trees": trees, "bitwise_equal": same,
                      "arrays": sorted(base),
                      "runs": [{"tree": t, "steps_per_s": r}
                               for t, _, r in results]}))
    return same


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_distalg_torch.tools.multiproc_run")
    p.add_argument("--out", required=True)
    p.add_argument("--init", default=None,
                   help="the group's rendezvous (file:// or host:port); "
                        "none: one process, no group")
    p.add_argument("--world", type=int, default=0)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--workloads", default=",".join(WORKLOADS))
    p.add_argument("--no-profile", action="store_true",
                   help="skip the profiled window (no idle share)")
    p.add_argument("--trees", nargs="+", default=None,
                   help="checkout roots whose one-process arms must agree "
                        "bit for bit")
    p.add_argument("--runs", type=int, default=1,
                   help="timed runs of each workload in a process")
    a = p.parse_args(argv)
    names = [w for w in a.workloads.split(",") if w]
    unknown = set(names) - set(WORKLOADS)
    if unknown:
        raise SystemExit(f"unknown workloads {sorted(unknown)}")
    if a.trees:
        return 0 if compare_trees(a.out, a.trees, names, a.runs) else 1
    run(a.out, names, init=a.init, world=a.world, rank=a.rank,
        profiled=not a.no_profile, runs=a.runs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
