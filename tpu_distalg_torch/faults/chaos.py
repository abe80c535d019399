"""The chaos harness — ``tda chaos`` (port of ``tpu_distalg/faults/chaos.py``).

Runs one small workload twice, once undisturbed and once under a
:class:`~tpu_distalg_torch.faults.FaultPlan` with the recovery stack
armed (``run_with_restarts`` and a checkpoint directory), and holds the
recovered result bit for bit against the undisturbed one. Every sampler
keys on the absolute step, so segmented, straight and crashed-and-
resumed runs are equal, and any drift under chaos is a broken recovery
path.

Workloads, at the JAX package's sizes (the value is the fault
schedule, not the work):

  ``lr``               full-batch logistic regression (checkpointed)
  ``ssgd``             minibatch SGD, ``bernoulli`` (checkpointed)
  ``kmeans``           full-batch Lloyd (checkpointed)
  ``als``              alternating least squares (checkpointed)
  ``kmeans_stream``    minibatch k-means over a virtual ShardedDataset:
                       the prefetch pipeline under ``data:gather`` /
                       ``data:h2d`` faults; stateless, so a restart
                       re-runs it from step 0
  ``pagerank_stream``  streamed PageRank over a power-law edge-block
                       cache, through B7 on the card (checkpointed)
  ``ssp``              stale-synchronous SSGD under a straggle and
                       leave schedule: these faults change the
                       trajectory, so the verdict is the tail accuracy
                       within :data:`SSP_CHAOS_ACC_BAND` of the
                       undisturbed run and the chaos run bitwise equal
                       to a replay of the same plan
  ``serve``            the micro-batching server answering a fixed
                       request sequence from an LR artifact: the load
                       passes ``ckpt:read`` (a corrupt read is re-read)
                       and each batch ``data:gather`` (a failed batch
                       fails its replies; the client retries)
  ``cluster``          the multi-process elastic runtime
                       (``tpu_distalg_torch/cluster/``) with its workers
                       on the mesh's device, under ``cluster:*`` rules
                       (a coordinator kill: respawned on the same port,
                       recovered from the WAL, the workers resumed): the
                       final center and the merge/membership event
                       digest bitwise the undisturbed run's; ``spawn``
                       (thread or process workers) and ``comm`` (the
                       wire schedule of both runs) apply here only

  ``rowstore``         PageRank over the sharded row store's fleet
                       (``cluster/rowstore.run_cluster_pagerank``, its
                       workers' windows through B7 on the mesh's device)
                       under worker, coordinator, PS and rpc faults: the
                       final ranks and the commit-event digest bitwise
                       the undisturbed run's
  ``cluster_serve``    three k-means replicas scoring on the mesh's
                       device behind the router under ``cluster:replica``
                       kills and ``cluster:rpc`` faults: the replies
                       bitwise the undisturbed run's, and the share
                       answered at the first try at least
                       :data:`CLUSTER_SERVE_AVAILABILITY_BAND`
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_distalg_torch import faults
from tpu_distalg_torch.telemetry import events as tevents

WORKLOADS = ("lr", "ssgd", "kmeans", "als", "kmeans_stream",
             "pagerank_stream", "serve", "ssp", "cluster",
             "cluster_serve", "rowstore")

#: the ssp workload's band: |tail accuracy under chaos − undisturbed|
SSP_CHAOS_ACC_BAND = 0.12

#: the cluster_serve verdict's floor on first-try availability
CLUSTER_SERVE_AVAILABILITY_BAND = 0.85

#: enough restarts for a multi-fault schedule, few enough that a fault
#: that keeps firing still fails
DEFAULT_MAX_RESTARTS = 3


@dataclasses.dataclass
class ServeChaosResult:
    """The serve workload's result: the stacked replies (the compared
    surface) and the evidence that the server degraded (sheds, failed
    batches, client retries), which legitimately differs between runs."""

    replies: np.ndarray
    shed: int
    failed_batches: int
    client_retries: int


@dataclasses.dataclass
class ClusterChaosResult:
    """The cluster workload's result: the final center and the event
    digest (as bytes, so it rides the bitwise compare). The recovery
    evidence shows the kill fired; it is not compared (wall clock
    differs between runs)."""

    center_w: np.ndarray
    event_digest: np.ndarray
    recoveries: int
    recovery_ms: list


@dataclasses.dataclass
class RowstoreChaosResult:
    """The rowstore workload's result: the final rank vector and the
    commit-event digest (as bytes, so it rides the bitwise compare). The
    recovery count and the pull sparsity show that the kill fired and
    the pulls were sparse; they are not compared."""

    ranks: np.ndarray
    event_digest: np.ndarray
    recoveries: int
    sparse_pull_fraction: float


@dataclasses.dataclass
class ClusterServeChaosResult:
    """The cluster_serve workload's result: the stacked router replies
    for the fixed request sequence (compared bitwise: a reply's bits
    depend only on its payload and the model, so a re-routed request's
    reply is the undisturbed one). Availability and the degradation
    counts are the band verdict's and the tests' evidence, not
    compared."""

    replies: np.ndarray
    availability: float
    sheds: int
    reroutes: int
    client_retries: int


@dataclasses.dataclass
class ChaosResult:
    workload: str
    plan_spec: str
    equal: bool
    mismatched: list[str]
    fired: list[tuple[str, int, str]]
    restarts_logged: int

    def verdict(self) -> str:
        fired = ", ".join(f"{p}#{h}={k}" for p, h, k in self.fired) or "-"
        if self.equal:
            return (f"[chaos] OK: {self.workload} recovered bitwise-"
                    f"equal under {len(self.fired)} injected fault(s) "
                    f"({fired}; {self.restarts_logged} restart(s))")
        return (f"[chaos] MISMATCH: {self.workload} diverged in "
                f"{', '.join(self.mismatched)} under injected faults "
                f"({fired}) — a recovery path is broken")


def _host(x) -> np.ndarray:
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(workload: str, res) -> dict[str, np.ndarray]:
    """The compared surface of a workload's result: every array a user
    could read from it, on the host."""
    if workload in ("lr", "ssgd", "ssp"):
        return {"w": _host(res.w), "accs": _host(res.accs)}
    if workload == "cluster":
        # tda: ignore[TDA100] -- not a checkpoint payload: this is the
        # bitwise-COMPARE surface, and recoveries/recovery_ms are
        # deliberately outside it (wall clock legitimately differs
        # between the disturbed and undisturbed runs — see
        # ClusterChaosResult's docstring)
        return {"center_w": res.center_w, "event_digest": res.event_digest}
    if workload in ("kmeans", "kmeans_stream"):
        return {"centers": _host(res.centers)}
    if workload == "als":
        return {"U": _host(res.U), "V": _host(res.V),
                "rmse_history": _host(res.rmse_history)}
    if workload == "pagerank_stream":
        return {"ranks": _host(res.ranks)}
    if workload == "rowstore":
        # tda: ignore[TDA100] -- not a checkpoint payload: the
        # bitwise-COMPARE surface; recoveries/sparsity stay outside it
        # (see RowstoreChaosResult's docstring)
        return {"ranks": res.ranks, "event_digest": res.event_digest}
    if workload in ("serve", "cluster_serve"):
        return {"replies": _host(res.replies)}
    raise ValueError(f"unknown chaos workload {workload!r}; choose from "
                     f"{WORKLOADS}")


def _cluster_runner(mesh, windows: int, every: int, spawn: str,
                    comm: str):
    """The cluster workload (JAX ``faults/chaos.py:242-275``): 3 slots,
    ``windows`` windows at s 3, workers on the mesh's device."""
    from tpu_distalg_torch import cluster as clus

    device = mesh.device if mesh is not None else None

    def run(ckpt_dir):
        # the plan drives the cluster config (its schedules compile
        # from it): the undisturbed reference runs with no plan
        reg = faults.active()
        plan_spec = reg.plan.spec() if reg is not None else None
        cfg = clus.ClusterConfig(
            n_slots=3, n_windows=windows, staleness=3,
            # generous: a slow reconnect on a loaded host must not turn
            # into a readmission and fail the verdict for that reason
            heartbeat_timeout=15.0, checkpoint_every=every,
            checkpoint_dir=ckpt_dir, plan_spec=plan_spec, comm=comm,
            train=clus.TrainTask(n_rows=1024, test_rows=512))
        res = clus.run_local_cluster(cfg, spawn=spawn, timeout=280.0,
                                     device=device)
        if res["version"] != windows:
            raise RuntimeError(f"cluster chaos run stopped at window "
                               f"{res['version']}/{windows}")
        return ClusterChaosResult(
            center_w=np.asarray(res["center"]["w"]),
            event_digest=np.frombuffer(
                bytes.fromhex(clus.event_digest(res)), np.uint8),
            recoveries=int(res.get("coordinator_recoveries", 0)),
            recovery_ms=list(res.get("recovery_ms", [])))
    return run


def _rowstore_runner(mesh, iters: int, workdir: str, comm: str):
    """The rowstore workload (JAX ``faults/chaos.py:277-315``): the
    512-vertex power-law cache of 4 shards, made once outside both runs,
    its fleet's windows on the mesh's device."""
    import os

    from tpu_distalg_torch import graphs
    from tpu_distalg_torch.cluster import rowstore

    device = mesh.device if mesh is not None else None
    path = os.path.join(workdir, "graph", "rowstore")
    graphs.build_powerlaw_block_cache(
        path, n_vertices=512, n_shards=4, avg_in_degree=8.0,
        alpha=1.6, seed=3, block_edges=64)

    def run(ckpt_dir):
        # the plan drives the fleet config (its point schedules compile
        # from it): the undisturbed reference runs with no plan
        reg = faults.active()
        plan_spec = reg.plan.spec() if reg is not None else None
        res = rowstore.run_cluster_pagerank(
            path, rowstore.ClusterPageRankConfig(
                n_iterations=iters, comm=comm, plan_spec=plan_spec,
                wal_dir=os.path.join(ckpt_dir, "wal")), device=device)
        if res["version"] != iters:
            raise RuntimeError(f"rowstore chaos run stopped at iteration "
                               f"{res['version']}/{iters}")
        return RowstoreChaosResult(
            ranks=np.asarray(res["ranks"]),
            event_digest=np.frombuffer(
                bytes.fromhex(res["event_digest"]), np.uint8),
            recoveries=int(res["recoveries"]),
            sparse_pull_fraction=float(res["sparse_pull_fraction"]))
    return run


def _cluster_serve_runner(mesh, n_requests: int):
    """The cluster_serve workload (JAX ``faults/chaos.py:415-455``): a
    fixed synthetic k-means center and request sequence, 3 replicas on
    the mesh's device; recovery is re-route and client retry."""
    from tpu_distalg_torch.cluster import serve as cserve

    device = mesh.device if mesh is not None else None
    rng = np.random.default_rng(7)
    center = {"centers": rng.normal(size=(8, 16)).astype(np.float32)}
    X_req = rng.normal(size=(n_requests, 16)).astype(np.float32)

    def run(ckpt_dir):
        del ckpt_dir  # recovery = re-route + client retry
        fleet = cserve.ServeFleet(cserve.FleetConfig(
            kind="kmeans", n_replicas=3, version=1, max_delay_ms=1.0),
            center, device=device).start()
        try:
            # backoff × retries spans the router's revival sweep: an
            # oserror storm can condemn the whole fleet for one beat
            results, info = cserve.run_fleet_closed_loop(
                fleet, list(X_req), concurrency=4, retries=10,
                retry_backoff_s=0.05)
            if info["failed"]:
                # out of retry budget: restartable, not a verdict
                raise RuntimeError(
                    f"cluster_serve chaos: {info['failed']} request(s) "
                    f"still failed after retries")
            st = fleet.stats()
            return ClusterServeChaosResult(
                replies=np.stack([np.asarray(v)
                                  for v, _ver, _rid in results]),
                availability=float(info["availability"]),
                sheds=int(st["sheds"]), reroutes=int(st["reroutes"]),
                client_retries=int(info["retries"]))
        finally:
            fleet.stop()
    return run


def _make_runner(workload: str, mesh, n_iterations: int | None,
                 checkpoint_every: int | None, workdir: str,
                 spawn: str = "thread", comm: str = "dense"):
    """``run(checkpoint_dir) -> result`` for one workload at its small
    default size. ``workdir`` holds what a workload needs besides its
    checkpoints (the graph cache, the served artifact); ``spawn`` and
    ``comm`` apply to the cluster workload only."""
    if workload == "rowstore":
        return _rowstore_runner(mesh, n_iterations or 6, workdir, comm)
    if workload == "cluster_serve":
        return _cluster_serve_runner(mesh, n_iterations or 96)
    if workload == "cluster":
        return _cluster_runner(mesh, n_iterations or 8,
                               checkpoint_every or 3, spawn, comm)
    if workload == "lr":
        from tpu_distalg_torch.models import logistic_regression as m
        from tpu_distalg_torch.utils import datasets

        data = datasets.breast_cancer_split()
        cfg = m.LRConfig(n_iterations=n_iterations or 60)
        every = checkpoint_every or 20

        def run(ckpt_dir):
            return m.train(*data, mesh, cfg, checkpoint_dir=ckpt_dir,
                           checkpoint_every=every)
        return run
    if workload in ("ssgd", "ssp"):
        from tpu_distalg_torch.models import ssgd as m
        from tpu_distalg_torch.utils import datasets

        data = datasets.breast_cancer_split()
        if workload == "ssgd":
            cfg = m.SSGDConfig(n_iterations=n_iterations or 90)
            every = checkpoint_every or 30
        else:
            cfg = m.SSGDConfig(n_iterations=n_iterations or 160,
                               sync="ssp:4")
            every = checkpoint_every or 40

        def run(ckpt_dir):
            return m.train(*data, mesh, cfg, checkpoint_dir=ckpt_dir,
                           checkpoint_every=every)
        return run
    if workload == "kmeans":
        from tpu_distalg_torch.models import kmeans as m
        from tpu_distalg_torch.utils import datasets

        pts = datasets.gaussian_mixture(4000, k=3, seed=1)
        cfg = m.KMeansConfig(k=3, n_iterations=n_iterations or 9)
        every = checkpoint_every or 3

        def run(ckpt_dir):
            return m.fit(pts, mesh, cfg, checkpoint_dir=ckpt_dir,
                         checkpoint_every=every)
        return run
    if workload == "als":
        from tpu_distalg_torch.models import als as m

        cfg = m.ALSConfig(n_iterations=n_iterations or 6)
        every = checkpoint_every or 2

        def run(ckpt_dir):
            return m.fit(mesh, cfg, checkpoint_dir=ckpt_dir,
                         checkpoint_every=every)
        return run
    if workload == "kmeans_stream":
        from tpu_distalg_torch.data import builders
        from tpu_distalg_torch.models import kmeans as m

        ds, _ = builders.gaussian_points_dataset(
            mesh, 4096, dim=8, k=3, seed=1, block_rows=256,
            backend="virtual")
        cfg = m.KMeansConfig(k=3)
        steps = n_iterations or 8

        def run(ckpt_dir):
            del ckpt_dir  # stateless: recovery is a re-run
            return m.fit_minibatch(ds, cfg, n_steps=steps,
                                   mini_batch_blocks=2)
        return run
    if workload == "pagerank_stream":
        import os

        from tpu_distalg_torch import graphs

        # built once, outside both runs: the chaos surface is the sweep
        path = os.path.join(workdir, "graph", "powerlaw")
        graphs.build_powerlaw_block_cache(
            path, n_vertices=2048, n_shards=mesh.n_data,
            avg_in_degree=8.0, alpha=1.6, seed=1, block_edges=512)
        cfg = graphs.StreamedPageRankConfig(n_iterations=n_iterations or 6)
        every = checkpoint_every or 2

        def run(ckpt_dir):
            gd = graphs.open_graph_dataset(path, mesh, backend="streamed")
            return graphs.run_streamed_pagerank(
                gd, cfg, checkpoint_dir=ckpt_dir, checkpoint_every=every)
        return run
    if workload == "serve":
        import os

        from tpu_distalg_torch.models import logistic_regression as lrm
        from tpu_distalg_torch.utils import datasets

        # trained once, outside both runs: the chaos surface is the
        # artifact's load (ckpt:read) and the dispatch (data:gather)
        data = datasets.breast_cancer_split()
        artifact_dir = os.path.join(workdir, "artifact")
        lrm.train(*data, mesh,
                  lrm.LRConfig(n_iterations=n_iterations or 30),
                  checkpoint_dir=artifact_dir, checkpoint_every=10)
        X_req = np.asarray(data[2], np.float32)[:24]  # fixed test rows

        def run(ckpt_dir):
            del ckpt_dir  # recovery is shed and client retry
            from tpu_distalg_torch import serve

            srv = serve.Server(mesh, serve.ServeConfig(
                max_batch=4, max_delay_ms=2.0, queue_depth=8))
            try:
                srv.add_artifact(artifact_dir, name="lr")
                results, info = serve.run_closed_loop(
                    srv, "lr", list(X_req), concurrency=2, retries=8,
                    retry_backoff_s=0.01)
                if info["failed"]:
                    # out of retries: restartable, not a verdict
                    raise RuntimeError(
                        f"serve chaos: {info['failed']} request(s) "
                        f"still failed after retries")
                st = srv.stats()
                return ServeChaosResult(
                    replies=np.stack([np.asarray(r) for r in results]),
                    shed=st["shed"], failed_batches=st["failed_batches"],
                    client_retries=info["retries"])
            finally:
                srv.close()
        return run
    raise ValueError(f"unknown chaos workload {workload!r}; choose from "
                     f"{WORKLOADS}")


def run_chaos(workload: str, mesh, *, plan, workdir: str,
              n_iterations: int | None = None,
              checkpoint_every: int | None = None,
              max_restarts: int = DEFAULT_MAX_RESTARTS,
              spawn: str = "thread", comm: str = "dense",
              logger=None) -> ChaosResult:
    """Undisturbed run, chaos run, bitwise compare.

    ``plan`` is a :class:`~tpu_distalg_torch.faults.FaultPlan` or its
    spelling. Both runs get fresh checkpoint directories under
    ``workdir``; the chaos run runs under ``run_with_restarts``. The
    process-global fault registry is left off on return. ``spawn`` and
    ``comm`` set the cluster workload's workers and wire."""
    import os

    from tpu_distalg_torch.utils import checkpoint as ckpt

    if isinstance(plan, str):
        plan = faults.FaultPlan.parse(plan)
    log = logger or (lambda m: None)
    # off before any of the experiment's I/O: the serve runner trains
    # its artifact in _make_runner
    faults.configure(False)
    runner = _make_runner(workload, mesh, n_iterations, checkpoint_every,
                          workdir, spawn=spawn, comm=comm)
    # kmeans_stream recovers by a re-run, serve by shed and client
    # retry, cluster_serve by re-route and retry: no checkpoint dir
    uses_ckpt = workload not in ("kmeans_stream", "serve", "cluster_serve")

    def dirpath(name):
        return os.path.join(workdir, name) if uses_ckpt else None

    tevents.mark("chaos:reference", emit_event=False)
    ref = runner(dirpath("ref"))

    # a fresh registry: the schedule replays the same on every call
    reg = faults.configure(plan)
    tevents.mark("chaos:faulted", emit_event=False)
    restart_log: list[str] = []
    try:
        got = ckpt.run_with_restarts(
            lambda: runner(dirpath("chaos")), max_restarts=max_restarts,
            logger=lambda m: (restart_log.append(m), log(m)))
    finally:
        fired = list(reg.fired)
        faults.configure(False)

    ref_leaves = _leaves(workload, ref)
    got_leaves = _leaves(workload, got)
    if workload == "ssp":
        faults.configure(plan)
        tevents.mark("chaos:replay", emit_event=False)
        try:
            import shutil

            shutil.rmtree(os.path.join(workdir, "chaos"),
                          ignore_errors=True)
            replay = ckpt.run_with_restarts(
                lambda: runner(dirpath("chaos")),
                max_restarts=max_restarts, logger=log)
        finally:
            faults.configure(False)
        rep_leaves = _leaves(workload, replay)
        mismatched = [f"replay:{name}" for name, a in got_leaves.items()
                      if not np.array_equal(a, rep_leaves[name])]

        def tail_acc(leaves):
            # the last quarter's mean: the endpoint swings tick to tick
            accs = leaves["accs"]
            return float(np.mean(accs[-max(1, len(accs) // 4):]))

        band = abs(tail_acc(got_leaves) - tail_acc(ref_leaves))
        if band > SSP_CHAOS_ACC_BAND:
            mismatched.append(
                f"band:tail_acc (|Δ|={band:.4f} > {SSP_CHAOS_ACC_BAND})")
    else:
        mismatched = [name for name, a in ref_leaves.items()
                      if not np.array_equal(a, got_leaves[name])]
        if workload == "cluster_serve":
            # bitwise replies alone would pass a fleet that answered
            # every request on its fifth retry
            avail = float(got.availability)
            if avail < CLUSTER_SERVE_AVAILABILITY_BAND:
                mismatched.append(
                    f"band:availability ({avail:.4f} < "
                    f"{CLUSTER_SERVE_AVAILABILITY_BAND})")
    result = ChaosResult(
        workload=workload, plan_spec=plan.spec(), equal=not mismatched,
        mismatched=mismatched, fired=fired,
        restarts_logged=sum(1 for m in restart_log
                            if m.startswith("[restart")))
    tevents.emit("chaos_verdict", workload=workload, equal=result.equal,
                 mismatched=mismatched, faults_fired=len(fired))
    return result
