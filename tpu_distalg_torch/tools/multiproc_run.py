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
    on the card, bf16, pack 16, 8192-row blocks), :data:`SSGD_STEPS`
    steps (bench.py's 1500, cut: PERF.md §4), B1;
  * ``ssgd_fused``: the same rows through B5;
  * ``ma_fused_train`` / ``ma_fused_gather``: MA at bench.py's MA
    geometry (5 local steps a round; :data:`MA_ROUNDS` of its 300
    rounds) on those rows, B2 / B1;
  * ``ssgd_tp``: ``fused_gather`` on the host-made two-class rows of
    the same size over a 2×2 mesh, B3 and B4;
  * ``kmeans_fused``: 10,000,000 points × 16, k 8, :data:`KM_ITERS`
    Lloyd iterations (of 50) through B10;
  * ``pagerank_auto`` / ``pagerank_pallas``: 1,000,000 vertices,
    Erdős–Rényi of average degree 8, :data:`PR_ITERS` standard-mode
    iterations (of 50) through B7 / B8.

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

The workloads that crossed processes last (``A9_WORKLOADS``) run at the
cells' widths with their depth cut (PERF.md §4), without a profiled
window; a big result is kept as the SHA-256 of each global shard's rows
(``*_sha``) or of the whole (closure), which the arms compare:

  * ``als``: ALS 4096 × 16384, rank 64 (bench.py:2815-2822) on a 2×2
    mesh, :data:`ALS_SWEEPS` sweeps; ``als_ckpt`` (untimed): the first
    sweeps into ``OUT/als_ckpt`` and a resume to the end, and the
    directory is the served artifact;
  * ``serve_sparse`` / ``serve_dense``: :data:`SERVE_REQUESTS` requests
    at max-batch 32 on the 2×2 mesh over 8 closed-loop workers: sparse
    serves ``als``'s training result through the reshard seam (B9 once
    a model slice a batch), dense the artifact (no kernel). In a group
    process 0 leads and the other follows; both return the replies in
    request order;
  * ``closure_dense`` / ``closure_sparse``: bench.py's DAG at V 6800
    (10,316,480 paths): the dense fixpoint and ``run_sparse_auto``;
  * ``stream_ssgd`` / ``stream_kmeans``: streamed SSGD (B1) and
    minibatch k-means over chip_smoke phase 14's caches (``--ooc-dir``),
    :data:`STREAM_STEPS` steps of 4 blocks a shard;
  * ``stream_pagerank``: streamed PageRank (B7 on each staged batch) on
    a 2-shard power-law edge-block cache of :data:`GRAPH_V` vertices
    made here (process 0 first), :data:`GRAPH_SWEEPS` sweeps;
  * ``ring_contiguous`` / ``ring_zigzag`` / ``ulysses``: causal
    attention at 32k × 8 heads × d 128 bf16 (bench.py's), forward and
    the gradients of Σ out·g, through B11 and B12.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

SSGD_ROWS, SSGD_FEATURES, SSGD_GBR, SSGD_STEPS = 1 << 20, 125, 8192, 500
MA_ROUNDS, MA_L = 100, 5
KM_POINTS, KM_DIM, KM_K, KM_ITERS = 10_000_000, 16, 8, 20
PR_VERTICES, PR_DEGREE, PR_ITERS = 1_000_000, 8.0, 20
N_DATA = 2
#: steps (rounds) of the window that warms a long run and is profiled:
#: the profiler's own host cost a step would stretch a whole run's
#: profiled copy to many seconds
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
SYNC_STEPS, SYNC_MA_ROUNDS, SYNC_SSP_TICKS, SYNC_CKPT_STEPS = 100, 20, 104, 100
SYNC_PROFILE_STEPS, SYNC_PROFILE_ROUNDS, SYNC_SSP_S = 50, 10, 8
SSP_PLAN = "seed=7;shard:straggle@p0.25=straggle:800"
SSP_LEAVE_PLAN = SSP_PLAN + ";shard:leave@p0.05=leave:2"
SSP_BENCH_STEPS, SSP_BENCH_REPEATS = 64, 3
SYNC_WORKLOADS = tuple(
    "sync_" + c.split(":")[0].replace("@", "_") for c in SYNC_SCHEDULES) + (
    "sync_ma_int8", "sync_ma_topk", "sync_ssp_straggle", "sync_ssp_leave",
    "sync_bsp_straggler", "sync_ssp_straggler", "sync_ckpt")
#: the cells of the workloads that crossed processes last (depth cut:
#: PERF.md §4)
ALS_USERS, ALS_ITEMS, ALS_RANK, ALS_SWEEPS = 4096, 16384, 64, 3
SERVE_REQUESTS, SERVE_MAX_BATCH, SERVE_K_TOP, SERVE_WORKERS = 2048, 32, 10, 8
#: requests of the serving workloads' warm run
SERVE_WARM_REQUESTS = 256
CLOSURE_V, CLOSURE_DEGREE = 6800, 8
STREAM_STEPS, STREAM_BLOCKS = 30, 4
STREAM_PACK, STREAM_GBR, KM_BLOCK, KM_STREAM_DIM = 16, 2048, 2048, 16
GRAPH_V, GRAPH_AVG_IN, GRAPH_BLOCK, GRAPH_SWEEPS = 1 << 21, 16.0, 1 << 16, 5
ATT_S, ATT_H, ATT_D = 32768, 8, 128
A9_WORKLOADS = ("als", "als_ckpt", "serve_sparse", "serve_dense",
                "closure_dense", "closure_sparse", "stream_ssgd",
                "stream_kmeans", "stream_pagerank", "ring_contiguous",
                "ring_zigzag", "ulysses")
#: the workloads that read chip_smoke phase 14's caches
OOC_WORKLOADS = ("stream_ssgd", "stream_kmeans")
WORKLOADS = ("ssgd_fused_gather", "ssgd_fused", "ma_fused_train",
             "ma_fused_gather", "ssgd_tp", "kmeans_fused", "pagerank_auto",
             "pagerank_pallas") + SYNC_WORKLOADS + A9_WORKLOADS


def _kernels():
    from tpu_distalg_torch.ops import attention_kernels, kmeans_kernels
    from tpu_distalg_torch.ops import pagerank_kernels, ssgd_kernels, topk

    return (ssgd_kernels.KERNELS + pagerank_kernels.KERNELS
            + kmeans_kernels.KERNELS + attention_kernels.KERNELS
            + (topk.fused_matmul_topk,))


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
    run, steps, want, window = built[:4]
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
        wanted = want(out) if callable(want) else want
        if launches != wanted:
            raise AssertionError(f"launched {launches}, want {wanted}")
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


# -------------------------------- the workloads that crossed last


def _sha_rows(t: torch.Tensor, parts: int) -> torch.Tensor:
    """The SHA-256 of each of ``parts`` equal row blocks of ``t``'s
    bytes, (parts, 32) uint8: a global shard's rows compared without
    carrying them."""
    import hashlib

    raw = t.detach().contiguous().cpu().reshape(parts, -1).view(torch.uint8)
    return torch.as_tensor(np.stack([np.frombuffer(
        hashlib.sha256(r.numpy().tobytes()).digest(), np.uint8)
        for r in raw]))


def _als_cfg(n: int = ALS_SWEEPS):
    from tpu_distalg_torch.models import als

    return als.ALSConfig(lam=0.01, m=ALS_USERS, n=ALS_ITEMS, k=ALS_RANK,
                         n_iterations=n, seed=0)


def _als(mesh22, cache: dict):
    """ALS straight on the 2×2 mesh; the result feeds ``serve_sparse``."""
    from tpu_distalg_torch.models import als

    def run():
        r = als.fit(mesh22, _als_cfg())
        cache["als"] = r
        return {"U": r.U, "V": r.V, "rmse": r.rmse_history}

    return run, ALS_SWEEPS, {}, None


def _als_dir(out_dir: str, group: bool) -> str:
    """``als_ckpt``'s directory: one for a group, one for one process."""
    return os.path.join(out_dir, "als_ckpt_group" if group
                        else "als_ckpt_one")


def _als_ckpt(mesh22, d: str) -> dict:
    """The first sweeps into ``d`` and a resume to the end (the served
    artifact)."""
    from tpu_distalg_torch.models import als

    als.fit(mesh22, _als_cfg(ALS_SWEEPS - 1), checkpoint_dir=d,
            checkpoint_every=ALS_SWEEPS - 1)
    r = als.fit(mesh22, _als_cfg(), checkpoint_dir=d,
                checkpoint_every=ALS_SWEEPS - 1)
    return {"U": r.U, "V": r.V}


def _serve(mesh22, merge: str, artifact: str, cache: dict):
    """``SERVE_REQUESTS`` closed-loop requests; in a group process 0
    leads and the other follows. Returns the replies in request order
    and the batches this process ran."""
    from tpu_distalg_torch import serve

    ids = np.random.default_rng(0).integers(0, ALS_USERS,
                                            size=SERVE_REQUESTS)
    cfg = serve.ServeConfig(max_batch=SERVE_MAX_BATCH, max_delay_ms=2.0,
                            k_top=SERVE_K_TOP, merge=merge)

    def run(ids=ids):
        server = serve.Server(mesh22, cfg)
        try:
            if merge == "sparse":
                r = cache["als"]
                server.add_model(serve.als_model(
                    r.U, r.V, mesh22, k_top=SERVE_K_TOP, merge=merge))
            else:
                server.add_artifact(artifact, name="als")
            if server.leader:
                got, info = serve.run_closed_loop(
                    server, "als", list(ids), concurrency=SERVE_WORKERS)
                if info["ok"] != len(ids):
                    raise AssertionError(f"served {info['ok']} of "
                                         f"{len(ids)}")
                batches = server.stats()["batches"]
            else:
                by_id, n = {}, [0]

                def seen(name, packed, reps):
                    n[0] += 1
                    for uid, rep in zip(packed, reps):
                        by_id[int(uid)] = rep

                server.follow(seen)
                got, batches = [by_id[int(u)] for u in ids], n[0]
        except BaseException:
            server.close(abort=True)
            raise
        server.close()
        return {"v": torch.as_tensor(np.stack([v for v, _ in got])),
                "i": torch.as_tensor(np.stack([i for _, i in got])),
                "batches": torch.tensor(batches)}

    def want(out):
        if merge == "dense":
            return {}
        # a batch is one B9 launch a model slice; add_model warms once
        return {"fused_matmul_topk": mesh22.n_model
                * (int(out["batches"]) + 1)}

    return (run, SERVE_REQUESTS, want,
            (lambda: run(ids[:SERVE_WARM_REQUESTS]), SERVE_WARM_REQUESTS))


def _closure(mesh, held: int, sparse: bool):
    from tpu_distalg_torch.models import transitive_closure as tc
    from tpu_distalg_torch.utils import datasets

    edges = datasets.closure_dag_edges(CLOSURE_V, CLOSURE_DEGREE, seed=0)

    def run():
        if sparse:
            r = tc.run_sparse_auto(edges, mesh)
            rows = torch.as_tensor(r.paths)
        else:
            r = tc.run(edges, mesh)
            rows = r.paths
        return {"rows": rows, "n": torch.tensor(r.n_paths),
                "rounds": torch.tensor(r.n_rounds)}

    def digest(out):
        """The dense matrix's rows as each held shard's SHA-256; the
        sparse pairs as they are (a process's slice of the buffer)."""
        if not sparse:
            out = dict(out, rows=_sha_rows(out["rows"], held))
        return out

    return run, 1, {}, None, digest


def _stream_ssgd(mesh, held: int, ooc_dir: str):
    """Streamed SSGD over phase 14's packed cache, 4 blocks a shard."""
    from tpu_distalg_torch.data import cache as dcache
    from tpu_distalg_torch.models import ssgd, ssgd_stream

    path = os.path.join(ooc_dir, "stream")
    X2, header = dcache.open_cache(path)
    g = header["geom"]
    meta = dict(pack=g["pack"], d_total=g["d_total"], y_col=g["y_col"],
                v_col=g["v_col"], n_padded=g["n_rows"])
    blocks = g["n_rows"] // (STREAM_GBR * mesh.n_data)
    cfg = ssgd.SSGDConfig(
        n_iterations=STREAM_STEPS, eval_test=False, x_dtype="bfloat16",
        sampler="fused_gather", gather_block_rows=STREAM_GBR,
        fused_pack=STREAM_PACK, shuffle_seed=None,
        mini_batch_fraction=STREAM_BLOCKS / blocks)
    trainer = ssgd_stream.StreamTrainer(X2, meta, mesh, cfg)
    w0 = torch.zeros((meta["d_total"],), device=mesh.device)
    return (lambda: {"w": trainer.run(w0, 0, STREAM_STEPS)[0]},
            STREAM_STEPS, {"fused_grad_sum_gathered": held * STREAM_STEPS},
            None)


def _stream_kmeans(mesh, ooc_dir: str):
    """Minibatch k-means over phase 14's points cache (its bytes split
    over this mesh's shards)."""
    from tpu_distalg_torch.data import ShardedDataset
    from tpu_distalg_torch.models import kmeans

    ds = ShardedDataset.from_cache(os.path.join(ooc_dir, "points"), mesh,
                                   block_rows=KM_BLOCK)
    k = int(ds.meta["k"])
    return (lambda: {"centers": kmeans.fit_minibatch(
        ds, kmeans.KMeansConfig(k=k, seed=0), n_steps=STREAM_STEPS,
        mini_batch_blocks=STREAM_BLOCKS).centers}, STREAM_STEPS, {}, None)


def _stream_pagerank(mesh, held: int, cache_dir: str):
    """Streamed PageRank on a 2-shard power-law cache (process 0 makes
    it, the others open it)."""
    from tpu_distalg_torch import graphs
    from tpu_distalg_torch.parallel.collectives import rank0_first

    path = os.path.join(cache_dir, "graph2")
    rank0_first(mesh, lambda: graphs.build_powerlaw_block_cache(
        path, n_vertices=GRAPH_V, n_shards=mesh.n_data,
        avg_in_degree=GRAPH_AVG_IN, block_edges=GRAPH_BLOCK))
    gd = graphs.open_graph_dataset(path, mesh)
    cfg = graphs.StreamedPageRankConfig(n_iterations=GRAPH_SWEEPS)
    batches = len(graphs.engine._block_schedule(gd.ds.n_blocks, gd.n_shards,
                                                cfg.batch_blocks))
    return (lambda: {"ranks": graphs.run_streamed_pagerank(gd, cfg).ranks},
            GRAPH_SWEEPS, {"spmv_table": held * batches * GRAPH_SWEEPS},
            None)


def _attention(mesh, held: int, kind: str):
    """Causal attention at bench.py's geometry on this process's rows:
    the output and the gradients of Σ out·g, each kept as the SHA-256 of
    every global shard's rows."""
    from tpu_distalg_torch.parallel import ring

    n = mesh.n_data
    gen = torch.Generator(device=mesh.device).manual_seed(11)
    q, k, v, g = (torch.randn((ATT_S, ATT_H, ATT_D), generator=gen,
                              device=mesh.device, dtype=torch.bfloat16)
                  for _ in range(4))
    if kind == "ring_zigzag":
        order = torch.as_tensor(ring.zigzag_order(n, ATT_S),
                                device=mesh.device)
        q, k, v, g = (x[order] for x in (q, k, v, g))
    rows = ATT_S // mesh.process_count
    lo = mesh.process_index * rows if mesh.distributed else 0
    q, k, v, g = (x[lo:lo + rows].contiguous() for x in (q, k, v, g))

    def run():
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        if kind == "ulysses":
            out = ring.ulysses_attention(*ts, mesh, causal=True,
                                         use_flash=True)
        else:
            out = ring.ring_attention(
                *ts, mesh, causal=True, use_flash=True,
                layout="zigzag" if kind == "ring_zigzag" else "contiguous")
        (out * g.float()).sum().backward()
        return {"out": out, "dq": ts[0].grad, "dk": ts[1].grad,
                "dv": ts[2].grad}

    def digest(out):
        """Each result as the SHA-256 of every held shard's rows."""
        return {f"{k}_sha": _sha_rows(v, held) for k, v in out.items()}

    if kind == "ulysses":
        live = held                         # one call a held head group
    else:
        base, live = mesh.local_data.start if mesh.distributed else 0, 0
        for i in range(n):
            for j in range(held):
                my, src = base + j, (base + j - i) % n
                live += (src <= my if kind == "ring_contiguous"
                         else 1 + (src <= my) + (src >= my))
    return (run, 1, {"flash_attention_block": live,
                     "flash_attention_backward_block": live}, None, digest)


def run(out_dir: str, workloads, *, init: str | None = None,
        world: int = 0, rank: int = 0, profiled: bool = True,
        runs: int = 1, ooc_dir: str | None = None,
        cache_dir: str | None = None) -> dict:
    """Run ``workloads`` in this process (a rank of a ``world``-process
    group meeting at ``init``, or alone) and write its two files.
    ``profiled`` adds each workload's profiled window (not the
    :data:`A9_WORKLOADS`'). ``ooc_dir`` holds phase 14's caches;
    ``cache_dir`` (default ``out_dir``) takes the graph cache, shared by
    the arms. Every arm takes half the host's cores, a pair's share, so
    the arms' CPU work matches."""
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
        if mesh22 is None and set(workloads) & set(A9_WORKLOADS):
            mesh22 = get_mesh(N_DATA, 2, device="cuda")
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
            if name == "als_ckpt":
                out = _als_ckpt(mesh22, _als_dir(out_dir, group))
                torch.cuda.synchronize(mesh.device)
                stats[name] = {"seconds": time.perf_counter() - t0}
                for k, v in out.items():
                    arrays[f"{name}/{k}"] = v.detach().cpu().numpy()
                continue
            expect = None
            if name == "als":
                built = _als(mesh22, cache)
            elif name.startswith("serve_"):
                built = _serve(mesh22, name[len("serve_"):],
                               _als_dir(out_dir, group), cache)
            elif name.startswith("closure_"):
                built = _closure(mesh, held, name == "closure_sparse")
            elif name == "stream_ssgd":
                built = _stream_ssgd(mesh, held, ooc_dir)
            elif name == "stream_kmeans":
                built = _stream_kmeans(mesh, ooc_dir)
            elif name == "stream_pagerank":
                built = _stream_pagerank(mesh, held, cache_dir or out_dir)
            elif name in ("ring_contiguous", "ring_zigzag", "ulysses"):
                built = _attention(mesh, held, name)
            elif name.startswith("sync_ma_"):
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
                out, st = _measure(mesh.device, built, group,
                                   profiled and name not in A9_WORKLOADS,
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
            if len(built) > 4:      # a digest of big results, untimed
                out = built[4](out)
            for k, v in out.items():
                arrays[f"{name}/{k}"] = v.detach().cpu().numpy()
            del out, built
        tag = f"rank{rank}" if group else "single"
        np.savez(os.path.join(out_dir, f"{tag}.npz"), **arrays)
        info.update(device=str(mesh.device), stats=stats)
        # tda: ignore[TDA030] -- a probe run by hand: it writes its
        # results, never a run's state, under no chaos schedule
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
    p.add_argument("--workloads", default=",".join(
        w for w in WORKLOADS if w not in OOC_WORKLOADS),
        help="comma-separated; the default is every workload but "
             f"{', '.join(OOC_WORKLOADS)}, which need --ooc-dir")
    p.add_argument("--no-profile", action="store_true",
                   help="skip the profiled window (no idle share)")
    p.add_argument("--trees", nargs="+", default=None,
                   help="checkout roots whose one-process arms must agree "
                        "bit for bit")
    p.add_argument("--runs", type=int, default=1,
                   help="timed runs of each workload in a process")
    p.add_argument("--ooc-dir", default=None,
                   help="chip_smoke phase 14's caches (stream, points), "
                        "for stream_ssgd and stream_kmeans")
    p.add_argument("--cache-dir", default=None,
                   help="where stream_pagerank makes its edge-block "
                        "cache (default: --out)")
    a = p.parse_args(argv)
    names = [w for w in a.workloads.split(",") if w]
    unknown = set(names) - set(WORKLOADS)
    if unknown:
        raise SystemExit(f"unknown workloads {sorted(unknown)}")
    if a.ooc_dir is None and set(names) & set(OOC_WORKLOADS):
        raise SystemExit(f"{sorted(set(names) & set(OOC_WORKLOADS))} read "
                         f"chip_smoke phase 14's caches: give --ooc-dir")
    if a.trees:
        return 0 if compare_trees(a.out, a.trees, names, a.runs) else 1
    run(a.out, names, init=a.init, world=a.world, rank=a.rank,
        profiled=not a.no_profile, runs=a.runs, ooc_dir=a.ooc_dir,
        cache_dir=a.cache_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
