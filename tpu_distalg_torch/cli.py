"""Command line of the port: full-batch LR, SSGD, the local-update family
(MA, BMUF, EASGD), ALS, k-means, PageRank, the transitive closure,
Monte-Carlo π, and serving ALS, k-means and LR artifacts.

    python -m tpu_distalg_torch.cli [--device {cuda,cpu}] lr
    python -m tpu_distalg_torch.cli ma --n-slices 4 --sampler fused_train \\
        --fused-pack 4 --gather-block-rows 32 --shuffle-seed 0  # B2
    python -m tpu_distalg_torch.cli [--device {cuda,cpu}] ssgd \\
        --sampler fused_train --gather-block-rows 32 --fused-pack 4 \\
        --shuffle-seed 0 --n-iterations 1500      # breast-cancer task
    python -m tpu_distalg_torch.cli ssgd --sampler fused_gather \\
        --mesh-shape 2x4 --fused-pack 4 --gather-block-rows 32 \\
        --shuffle-seed 0        # features over 4 model slices (B3, B4)
    python -m tpu_distalg_torch.cli [--device {cuda,cpu}] als \\
        --m 4096 --n 16384 --k 64 --lam 0.0 --n-iterations 5 \\
        [--mesh-shape 2x4] --checkpoint-dir D  # prints artifact_path: D
    python -m tpu_distalg_torch.cli serve --artifact D --max-batch 32 \\
        --requests 2048 --concurrency 8 [--model-slices 4 --comm sparse]
    python -m tpu_distalg_torch.cli [--device {cuda,cpu}] pagerank \\
        [--n-vertices 1000000 --mode standard --n-iterations 50]
    python -m tpu_distalg_torch.cli [--device {cuda,cpu}] kmeans \\
        [--scale-points 10000000 --dim 16 --k 8 --n-iterations 50]
    python -m tpu_distalg_torch.cli closure [--n-vertices 4096 [--sparse]]
    python -m tpu_distalg_torch.cli mc [--n-slices 4 --n 400000]
    python -m tpu_distalg_torch.cli ssgd --n-slices 4 --sampler fused_gather \
        --comm int8 --quiet              # the gradient sync's schedules
    python -m tpu_distalg_torch.cli ssgd --n-slices 4 --sync ssp:4 \
        --fault-plan "seed=7;shard:straggle@p0.25=straggle:8"
    python -m tpu_distalg_torch.cli ssgd --stream-cache build/s \
        --stream-rows 4194304 --gather-block-rows 2048  # rows from disk
    python -m tpu_distalg_torch.cli kmeans --data-backend streamed \
        --stream-cache build/pts --scale-points 1048576 --k 8
    python -m tpu_distalg_torch.cli als --data-backend virtual \
        --m 4096 --n 4096 --k 16 --rmse-every 0

The lines printed match the JAX package's ``tda lr``, ``tda ssgd``,
``tda ma``, ``tda bmuf``, ``tda easgd``, ``tda als``, ``tda serve``,
``tda pagerank``, ``tda kmeans``, ``tda closure`` and ``tda mc``. Runs on ``cuda`` unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys


def parse_mesh_shape(text: str) -> tuple[int, int]:
    """``'DxM'`` → ``(data, model)``: ``'8x1'`` is pure data parallel,
    ``'2x4'`` puts 4 model slices (the features) inside each data
    shard."""
    m = re.fullmatch(r"(\d+)[xX](\d+)", text.strip())
    if not m or int(m.group(1)) < 1 or int(m.group(2)) < 1:
        raise ValueError(
            f"--mesh-shape wants DATAxMODEL (e.g. 4x2), got {text!r}")
    return int(m.group(1)), int(m.group(2))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpu_distalg_torch.cli")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sub = p.add_subparsers(dest="cmd", required=True)

    lr = sub.add_parser("lr", help="full-batch logistic regression")
    _add_optimizer(lr, 1500)
    for name in ("ma", "bmuf", "easgd"):
        o = sub.add_parser(name, help={
            "ma": "model averaging (local SGD)",
            "bmuf": "blockwise model update filtering",
            "easgd": "elastic averaging SGD"}[name])
        _add_optimizer(o, 1500 if name == "easgd" else 300)
        o.add_argument("--mini-batch-fraction", type=float, default=0.1)
        o.add_argument("--sampler", default="bernoulli",
                       choices=["bernoulli", "fused_gather", "fused_train"])
        o.add_argument("--x-dtype", default="float32",
                       choices=["float32", "bfloat16"])
        o.add_argument("--gather-block-rows", type=int, default=1024)
        o.add_argument("--fused-pack", type=int, default=16)
        o.add_argument("--shuffle-seed", type=int, default=None)
        o.add_argument("--mega-steps", type=int, default=None,
                       help="ssgd only: refused here, as the JAX CLI does")
        _add_sync(o)
        o.add_argument("--n-local-iterations", type=int,
                       default=1 if name == "easgd" else 5)
        o.add_argument("--resample-per-local-step", action="store_true")

    o = sub.add_parser("ssgd", help="synchronous minibatch SGD")
    o.add_argument("--n-slices", type=int, default=0,
                   help="emulated data shards; 0 = 1")
    o.add_argument("--mesh-shape", type=str, default=None, metavar="DxM",
                   help="emulated mesh data x model (e.g. 2x2); model > 1 "
                        "splits the features over the model slices "
                        "(feature_sharded) — replaces --n-slices")
    o.add_argument("--n-iterations", type=int, default=1500)
    o.add_argument("--eta", type=float, default=0.1)
    o.add_argument("--mini-batch-fraction", type=float, default=0.1)
    o.add_argument("--sampler", default="bernoulli",
                   choices=["bernoulli", "fixed", "fused", "fused_gather",
                            "fused_train"])
    o.add_argument("--x-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    o.add_argument("--gather-block-rows", type=int, default=1024)
    o.add_argument("--fused-pack", type=int, default=16)
    o.add_argument("--shuffle-seed", type=int, default=None)
    o.add_argument("--mega-steps", type=int, default=None,
                   help="steps per kernel launch (sampler=fused_train); "
                        "default: the largest divisor of every segment "
                        "length <= 125")
    o.add_argument("--lam", type=float, default=0.0)
    o.add_argument("--reg-type", default="l2",
                   choices=["none", "l2", "l1", "elastic_net"])
    o.add_argument("--plot", type=str, default=None,
                   help="save an accuracy plot PNG here")
    o.add_argument("--quiet", action="store_true")
    o.add_argument("--checkpoint-dir", type=str, default=None,
                   help="segmented checkpoint/resume directory")
    o.add_argument("--checkpoint-every", type=int, default=500)
    o.add_argument("--stream-cache", type=str, default=None,
                   metavar="PATH",
                   help="train the streamed path from a disk-backed packed "
                        "dataset at PATH (created by utils.datasets."
                        "streamed_packed_cache if missing — see "
                        "--stream-rows); sampled blocks are gathered on the "
                        "host and staged per step (models/ssgd_stream.py). "
                        "Ignores --sampler/--x-dtype/--shuffle-seed (the "
                        "cache fixes the bf16 dtype and row layout); "
                        "rejects --mega-steps")
    o.add_argument("--stream-rows", type=int, default=1 << 22,
                   help="rows to generate when --stream-cache is new")
    _add_comm(o)
    _add_sync(o)
    _add_fault_plan(o)

    a = sub.add_parser("als", help="ALS matrix factorisation")
    _add_mesh_flags(a)
    a.add_argument("--m", type=int, default=100)
    a.add_argument("--n", type=int, default=500)
    a.add_argument("--k", type=int, default=10)
    a.add_argument("--lam", type=float, default=0.01)
    a.add_argument("--n-iterations", type=int, default=5)
    a.add_argument("--seed", type=int, default=0)
    _add_data_backend(a, block_rows=256)
    a.add_argument("--rmse-every", type=int, default=1,
                   help="streamed/virtual backends: stream one extra RMSE "
                        "evaluation pass every N sweeps (0 = once after "
                        "the final sweep — each pass re-reads R)")
    a.add_argument("--checkpoint-dir", default=None,
                   help="segmented checkpoint/resume directory; its last "
                        "checkpoint is the serving artifact")
    a.add_argument("--checkpoint-every", type=int, default=5)
    _add_max_restarts(a)
    _add_fault_plan(a)

    s = sub.add_parser("serve", help="serve ALS, k-means and LR artifacts "
                                     "under load")
    s.add_argument("--artifact", action="append", required=True,
                   help="checkpoint directory (repeatable)")
    s.add_argument("--n-slices", type=int, default=0,
                   help="emulated data shards; 0 = 1")
    s.add_argument("--model-slices", type=int, default=1,
                   help="emulated model slices: ALS item factors are split "
                        "over them and each slice's top-k candidates merge "
                        "by --comm")
    s.add_argument("--comm", default="sparse", choices=["sparse", "dense"],
                   help="ALS candidate merge: sparse = each slice's k "
                        "(value, index) pairs (8k(S-1) B/request), dense = "
                        "the slices' whole score blocks (the O(N) baseline)")
    s.add_argument("--max-batch", type=int, default=16)
    s.add_argument("--max-delay-ms", type=float, default=5.0)
    s.add_argument("--queue-depth", type=int, default=128)
    s.add_argument("--k-top", type=int, default=10)
    s.add_argument("--requests", type=int, default=256)
    s.add_argument("--concurrency", type=int, default=4)

    c = sub.add_parser("kmeans", help="k-means (Lloyd's algorithm)")
    c.add_argument("--n-slices", type=int, default=0,
                   help="emulated data shards; 0 = 1")
    c.add_argument("--k", type=int, default=2)
    c.add_argument("--n-iterations", type=int, default=5)
    c.add_argument("--converge-dist", type=float, default=None)
    c.add_argument("--n-points", type=int, default=0,
                   help="0 = the reference's toy 6x2 matrix; else a "
                        "Gaussian mixture of this many points (made on "
                        "the host, like the reference)")
    c.add_argument("--scale-points", type=int, default=0,
                   help="scale path: synthesize this many mixture points "
                        "ON the device (host memory O(k); overrides "
                        "--n-points)")
    c.add_argument("--dim", type=int, default=16,
                   help="point dimension for --scale-points")
    _add_data_backend(c, block_rows=2048)
    c.add_argument("--mini-batch-blocks", type=int, default=4,
                   help="blocks per shard per minibatch step (minibatch "
                        "engine)")
    c.add_argument("--minibatch-steps", type=int, default=0,
                   help="run the minibatch engine for N steps over the "
                        "ShardedDataset (0 = classic full-batch Lloyd when "
                        "--data-backend resident, 100 otherwise)")
    c.add_argument("--checkpoint-dir", type=str, default=None,
                   help="segmented checkpoint/resume directory")
    c.add_argument("--checkpoint-every", type=int, default=100)
    c.add_argument("--max-restarts", type=int, default=0,
                   help="restarts after a failed segment: waits for the "
                        "faults slice (ROADMAP A12); only 0 is accepted")
    _add_fault_plan(c)

    g = sub.add_parser("pagerank", help="PageRank power iteration")
    g.add_argument("--n-slices", type=int, default=0,
                   help="emulated data shards; 0 = 1")
    g.add_argument("--n-iterations", type=int, default=10)
    g.add_argument("--q", type=float, default=0.15)
    g.add_argument("--mode", default=None,
                   choices=["reference", "standard"],
                   help="default: reference (the resident backend's)")
    g.add_argument("--scatter", default="auto",
                   choices=["auto", "pallas", "xla", "spmv"],
                   help="standard-mode sweep: auto/spmv = kernel B7 (CSR "
                        "SpMV), pallas = torch gather + kernel B8 "
                        "(segmented sum), xla = the library's sparse CSR "
                        "product (the A/B line)")
    g.add_argument("--n-vertices", type=int, default=0,
                   help="0 = the reference's 4-edge toy graph; else an "
                        "Erdős–Rényi graph of this many vertices")
    g.add_argument("--edge-file", type=str, default=None,
                   help="load the graph from a '#'-commented whitespace "
                        "edge-list file (overrides --n-vertices); parsed "
                        "by the C++ ingest's binding")
    g.add_argument("--edge-capacity", type=int, default=1 << 24,
                   help="max edges the file parser may return")
    g.add_argument("--data-backend", default="resident",
                   choices=["resident", "virtual", "streamed"],
                   help="where the edge set lives: resident = device "
                        "memory (the CSR sweeps), streamed = a dst-sorted "
                        "CSR edge-block disk cache swept out of core "
                        "(tpu_distalg_torch/graphs/: only O(V) state on "
                        "the device, each staged batch through kernel "
                        "B7), virtual = the same engine from host memory")
    g.add_argument("--stream-cache", type=str, default=None,
                   metavar="PATH",
                   help="edge-block cache path for the streamed/virtual "
                        "engine (default: a geometry-keyed path under "
                        "$TMPDIR, built on first use)")
    g.add_argument("--block-edges", type=int, default=1 << 16,
                   help="edges per streamed block (the out-of-core "
                        "transfer granularity)")
    g.add_argument("--combine", default="auto",
                   choices=["auto", "sparse", "dense"],
                   help="the engine's cross-shard rank combine: sparse = "
                        "each shard's distinct-destination (value, index) "
                        "pairs (comms.sparse_allreduce), dense = O(V) "
                        "vectors added in shard order; auto picks by "
                        "wire-byte accounting")
    g.add_argument("--checkpoint-dir", type=str, default=None,
                   help="segmented checkpoint/resume directory")
    g.add_argument("--checkpoint-every", type=int, default=5)
    g.add_argument("--max-restarts", type=int, default=0,
                   help="restarts after a failed segment: waits for the "
                        "faults slice (ROADMAP A12); only 0 is accepted")
    _add_fault_plan(g)

    t = sub.add_parser("closure", help="transitive closure")
    _add_mesh_flags(t)
    t.add_argument("--n-vertices", type=int, default=0,
                   help="0 = the reference's toy graph; else an "
                        "Erdős–Rényi graph of average degree 2, or with "
                        "--sparse a chain forest (an ER closure is an "
                        "inherently quadratic output)")
    t.add_argument("--sparse", action="store_true",
                   help="sort-dedup path-set closure (O(closure) memory)")
    t.add_argument("--capacity", type=int, default=0,
                   help="sparse path-buffer capacity; 0 = 8x edges")
    t.add_argument("--checkpoint-dir", type=str, default=None,
                   help="segmented checkpoint/resume directory")
    t.add_argument("--checkpoint-every", type=int, default=8)
    _add_max_restarts(t)
    _add_fault_plan(t)

    m = sub.add_parser("mc", help="Monte-Carlo pi")
    _add_mesh_flags(m)
    m.add_argument("--n", type=int, default=400_000)
    _add_max_restarts(m)
    _add_fault_plan(m)
    return p


def _add_data_backend(p, block_rows: int) -> None:
    """The data-placement knob (``tpu_distalg_torch/data/``), as the JAX
    CLI gives it (``tpu_distalg/cli.py:148-166``): a placement, not an
    algorithm knob — staged batches are bitwise equal across backends."""
    p.add_argument("--data-backend", default="resident",
                   choices=["resident", "virtual", "streamed"],
                   help="where the dataset lives: resident = device "
                        "memory, virtual = host RAM, streamed = disk "
                        "packed cache (needs --stream-cache); virtual/"
                        "streamed stage sampled blocks through the "
                        "prefetch pipeline (tpu_distalg_torch/data/)")
    p.add_argument("--stream-cache", type=str, default=None,
                   metavar="PATH",
                   help="packed-cache path for --data-backend streamed "
                        "(created on first use)")
    p.add_argument("--block-rows", type=int, default=block_rows,
                   help="rows per gathered block (the out-of-core "
                        "transfer granularity)")


def _uses_data(args) -> bool:
    """True when the run goes through the data subsystem (the streamed
    SSGD trainer, minibatch k-means, streamed ALS, the graph engine)."""
    if args.cmd == "ssgd":
        return args.stream_cache is not None
    if args.cmd == "pagerank":
        return args.data_backend != "resident"
    if args.cmd in ("kmeans", "als"):
        return (args.data_backend != "resident"
                or bool(getattr(args, "minibatch_steps", 0)))
    return False


def _add_mesh_flags(p) -> None:
    """``--n-slices`` and ``--mesh-shape``, as the JAX CLI gives them."""
    p.add_argument("--n-slices", type=int, default=0,
                   help="emulated data shards; 0 = 1")
    p.add_argument("--mesh-shape", type=str, default=None, metavar="DxM",
                   help="emulated mesh data x model (e.g. 2x2) — replaces "
                        "--n-slices")


def _add_comm(p) -> None:
    """``--comm``, with the JAX CLI's default and help
    (``tpu_distalg/cli.py:88-105``)."""
    p.add_argument(
        "--comm", default="dense", metavar="SCHED",
        help="cross-shard sync schedule: dense (bitwise the "
             "classic psum — default), bucketed[:elems] "
             "(ppermute-chunk ring), hier[:groups] "
             "(reduce-scatter intra-group / ring across groups / "
             "all-gather), bf16, int8[:seed[:bucket]] (native "
             "int8 wire: seeded stochastic rounding, int8 in both "
             "ring phases), topk[:frac] (sparse allreduce + error "
             "feedback). bucketed/int8 overlap their bucket "
             "exchange with compute by default; append @seq for "
             "the bitwise-identical sequential exchange (a no-op "
             "for the single-bucket topk/hier). Emits "
             "comm.bytes_wire/bytes_logical/rounds telemetry "
             "counters per run")


def _add_sync(p) -> None:
    """``--sync``, with the JAX CLI's default and help
    (``tpu_distalg/cli.py:106-121``)."""
    p.add_argument(
        "--sync", default="bsp", metavar="MODE",
        help="synchronization discipline: bsp (lock-step, one "
             "collective per step/round — bitwise the classic "
             "trainer; default) or ssp[:s[:decay]] (stale-"
             "synchronous: shards run up to s steps ahead of the "
             "slowest, the merge runs once per s-tick window with "
             "staleness-weighted averaging / delayed gradients, "
             "and a clock vector gates bound violations — a "
             "straggler no longer serializes every step). Seeded "
             "shard:straggle / shard:leave --fault-plan rules "
             "compile into deterministic straggler and elastic-"
             "membership schedules; the same plan replays bitwise. "
             "A checkpointed ssp run resumed with a different "
             "--n-slices renegotiates the ring (membership epoch) "
             "instead of rejecting")


def _add_fault_plan(p) -> None:
    """``--fault-plan`` (``tpu_distalg/cli.py:179-188``), through
    :func:`tpu_distalg_torch.faults.configure`."""
    p.add_argument(
        "--fault-plan", type=str, default=None, metavar="SPEC",
        help="deterministic fault-injection plan: inline "
             "'seed=N;point@hit=kind[:arg];...' or a JSON plan file "
             "($TDA_FAULT_PLAN is the default). The port injects at "
             "shard:straggle (kind straggle) and shard:leave (kind "
             "leave), compiled into the --sync ssp schedules of ssgd, "
             "ma, bmuf and easgd, and at data:gather, data:h2d and "
             "cache:write on the runs through the data subsystem (ssgd "
             "--stream-cache, kmeans and als off the resident backend); "
             "the same plan+seed replays bitwise. A rule no seam of the "
             "run reads, or at any other point, is refused: those seams "
             "wait for ROADMAP A12")


def _refuse_unread_plan(args) -> None:
    """A rule that no seam of this run reads would never fire: the SSP
    runs of ssgd and the local-update family compile the shard points,
    the runs through the data subsystem fire the data points."""
    from tpu_distalg_torch import faults
    from tpu_distalg_torch.parallel import ssp as pssp

    reg = faults.active()
    if reg is None:
        return
    try:
        is_ssp = pssp.SyncSpec.parse(getattr(args, "sync", "bsp")).is_ssp
    except ValueError:
        return  # the trainer refuses the spelling in JAX's words
    reads = set()
    if is_ssp and args.cmd in ("ssgd", "ma", "bmuf", "easgd"):
        reads |= {"shard:straggle", "shard:leave"}
    if _uses_data(args):
        reads |= {"data:gather", "data:h2d", "cache:write"}
    unread = sorted({r.point for r in reg.plan.rules} - reads)
    if not unread:
        return
    run = f"{args.cmd} --sync {args.sync}" if hasattr(args, "sync") \
        else args.cmd
    if not reads:
        raise SystemExit(
            f"--fault-plan: {run} reads no fault plan (the port compiles "
            f"shard:straggle and shard:leave into the --sync ssp runs of "
            f"ssgd, ma, bmuf and easgd, and fires data:gather, data:h2d "
            f"and cache:write on the runs through the data subsystem); "
            f"injection at the other seams waits for ROADMAP A12")
    raise SystemExit(
        f"--fault-plan: {run} reads no rule at {', '.join(unread)} (it "
        f"reads {', '.join(sorted(reads))}); injection at the other "
        f"seams waits for ROADMAP A12")


def _add_max_restarts(p) -> None:
    p.add_argument("--max-restarts", type=int, default=0,
                   help="restarts after a failed segment: waits for the "
                        "faults slice (ROADMAP A12); only 0 is accepted")


def _mesh(args):
    """The emulated mesh of ``--n-slices`` or ``--mesh-shape`` on
    ``--device``, with the JAX CLI's refusals and its warning for a
    model axis the workload does not use."""
    from tpu_distalg_torch.parallel import get_mesh

    if args.max_restarts != 0:
        raise SystemExit("--max-restarts waits for the faults slice "
                         "(ROADMAP A12); only 0 is accepted")
    data, model = args.n_slices or 1, 1
    if args.mesh_shape:
        if args.n_slices > 0:
            raise SystemExit(
                "--mesh-shape and --n-slices both set: --mesh-shape "
                "IS the full (data x model) geometry; drop --n-slices")
        try:
            data, model = parse_mesh_shape(args.mesh_shape)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        if model > 1 and args.cmd != "als":  # ALS splits V over model
            print(f"[mesh] warning: --mesh-shape {data}x{model} puts "
                  f"{model}-way model parallelism on a workload whose "
                  f"rule table has no model-axis placement — those "
                  f"devices will idle; use --mesh-shape "
                  f"{data * model}x1 (or --n-slices {data * model}) "
                  f"for full data parallelism", file=sys.stderr)
    return get_mesh(data=data, model=model, device=args.device)


def _run_closure(args) -> None:
    """``tda closure``'s graph choice (``tpu_distalg/cli.py:1516-1545``)
    and its closing line."""
    from tpu_distalg_torch.models import transitive_closure as m
    from tpu_distalg_torch.utils import datasets

    mesh = _mesh(args)
    if args.n_vertices == 0:
        edges = datasets.toy_graph_edges()
    elif args.sparse:
        edges = datasets.chain_forest_edges(args.n_vertices)
    else:
        edges = datasets.erdos_renyi_edges(args.n_vertices, 2.0)
    ckpt = dict(checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every)
    if args.sparse:
        res = m.run_sparse(
            edges, mesh, m.SparseClosureConfig(capacity=args.capacity or None),
            **ckpt)
    else:
        res = m.run(edges, mesh, **ckpt)
    print(f"The original graph has {res.n_paths} paths "
          f"({res.n_rounds} rounds)")


def _add_optimizer(p, n_iterations: int) -> None:
    """The flags the JAX CLI gives ``lr``, ``ma``, ``bmuf`` and
    ``easgd`` (``tpu_distalg/cli.py:256-288``), defaults included."""
    p.add_argument("--n-slices", type=int, default=0,
                   help="emulated data shards (replicas); 0 = 1")
    p.add_argument("--n-iterations", type=int, default=n_iterations)
    p.add_argument("--eta", type=float, default=0.1)
    _add_comm(p)
    p.add_argument("--plot", type=str, default=None,
                   help="save an accuracy plot PNG here")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="segmented checkpoint/resume directory")
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--max-restarts", type=int, default=0,
                   help="restarts after a failed segment: waits for the "
                        "faults slice (ROADMAP A12); only 0 is accepted")
    _add_fault_plan(p)


def _report(name: str, res, args, seconds: float) -> None:
    """The JAX CLI's closing lines of an optimizer run."""
    from tpu_distalg_torch.utils import metrics

    if not args.quiet:
        print(f"Final w: {list(map(float, res.w.cpu()))}")
    print(f"Final acc: {res.final_acc:.6f}")
    print(f"[{name}] {args.n_iterations} iterations in {seconds:.3f}s "
          f"({args.n_iterations / seconds:.1f} steps/s)")
    if args.plot:
        metrics.draw_acc_plot(res.accs.cpu().numpy(), args.plot)
        print(f"saved plot: {args.plot}")


def _run_optimizer(args) -> None:
    """``lr``, ``ma``, ``bmuf`` and ``easgd`` on the breast-cancer task."""
    import importlib
    import time

    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    if args.max_restarts != 0:
        raise SystemExit("--max-restarts waits for the faults slice "
                         "(ROADMAP A12); only 0 is accepted")
    if args.cmd != "lr" and args.mega_steps is not None:
        raise SystemExit(
            f"{args.cmd}: --mega-steps applies to ssgd only — "
            "local-update megakernels launch n-local-iterations "
            "steps per round")
    data = datasets.breast_cancer_split()
    mesh = get_mesh(data=args.n_slices or None, device=args.device)
    if args.cmd == "lr":
        from tpu_distalg_torch.models import logistic_regression as m

        cfg = m.LRConfig(n_iterations=args.n_iterations, eta=args.eta,
                         comm=args.comm)
    else:
        m = importlib.import_module(f"tpu_distalg_torch.models.{args.cmd}")
        cfg = getattr(m, {"ma": "MAConfig", "bmuf": "BMUFConfig",
                          "easgd": "EASGDConfig"}[args.cmd])(
            n_iterations=args.n_iterations, eta=args.eta,
            mini_batch_fraction=args.mini_batch_fraction,
            n_local_iterations=args.n_local_iterations,
            resample_per_local_step=args.resample_per_local_step,
            sampler=args.sampler, x_dtype=args.x_dtype,
            gather_block_rows=args.gather_block_rows,
            fused_pack=args.fused_pack, shuffle_seed=args.shuffle_seed,
            comm=args.comm, sync=args.sync)
    t0 = time.perf_counter()
    try:
        res = m.train(*data, mesh, cfg, checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every)
    except NotImplementedError as e:
        raise SystemExit(f"[{args.cmd}] {e}") from None
    w = res.w.cpu()   # waits for the card
    _report(args.cmd, dataclasses.replace(res, w=w), args,
            time.perf_counter() - t0)


def _mega_steps(args, default: int) -> int:
    """The JAX CLI's ``--mega-steps`` auto-pick: the largest divisor of
    every segment the run will execute, a resume included, that is at
    most the default launch size."""
    import math

    from tpu_distalg_torch.models import ssgd

    mega = args.mega_steps
    if mega is not None and mega < 1:
        raise SystemExit(f"--mega-steps must be >= 1 (got {mega})")
    if mega is not None:
        return mega
    if args.n_iterations < 1:
        return default
    segs = ssgd.fused_train_segment_lengths(
        args.checkpoint_dir,
        args.checkpoint_every if args.checkpoint_dir else args.n_iterations,
        args.n_iterations)
    g = math.gcd(*segs) if segs else args.n_iterations
    cap = min(default, g)
    mega = max(d for d in range(1, cap + 1) if g % d == 0)
    if mega < min(default, args.n_iterations) // 2:
        print(f"[ssgd] note: auto-picked mega_steps={mega} is far below "
              f"the default launch size — iteration/checkpoint counts "
              f"with a larger common divisor run faster")
    return mega


def _run_ssgd_stream(args, mesh) -> None:
    """``ssgd --stream-cache``: the streamed trainer over a disk cache
    of the two-class task (``tpu_distalg/cli.py:1181-1220``)."""
    import time

    from tpu_distalg_torch.models import ssgd, ssgd_stream
    from tpu_distalg_torch.utils import datasets

    if args.mega_steps is not None:
        raise SystemExit(
            "--mega-steps applies to sampler=fused_train only; "
            "the streamed path runs one kernel per step")
    if args.comm != "dense":
        raise SystemExit(
            "--comm applies to the in-memory trainers; the "
            "streamed trainer (--stream-cache) stages blocks "
            "host->device per step and syncs dense")
    if args.sync != "bsp":
        raise SystemExit(
            "--sync ssp applies to the in-memory trainers; "
            "the streamed trainer (--stream-cache) runs BSP")
    X2, meta, (X_te, y_te) = datasets.streamed_packed_cache(
        args.stream_cache, n_rows=args.stream_rows, n_features=125,
        n_shards=mesh.n_data, pack=args.fused_pack,
        gather_block_rows=args.gather_block_rows)
    cfg = ssgd.SSGDConfig(
        n_iterations=args.n_iterations, eta=args.eta,
        mini_batch_fraction=args.mini_batch_fraction, lam=args.lam,
        reg_type=args.reg_type, fused_pack=args.fused_pack,
        gather_block_rows=args.gather_block_rows, sampler="fused_gather",
        shuffle_seed=None, eval_every=max(1, args.n_iterations // 10))
    t0 = time.perf_counter()
    res = ssgd_stream.train(X2, meta, mesh, cfg, X_te, y_te,
                            checkpoint_dir=args.checkpoint_dir,
                            checkpoint_every=args.checkpoint_every)
    w = res.w.cpu()   # waits for the card
    _report("ssgd", dataclasses.replace(res, w=w), args,
            time.perf_counter() - t0)


def _run_ssgd(args) -> None:
    import time

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    n_data, n_model = args.n_slices or 1, 1
    if args.mesh_shape:
        if args.n_slices > 0:
            raise SystemExit(
                "--mesh-shape and --n-slices both set: --mesh-shape "
                "IS the full (data x model) geometry; drop --n-slices")
        try:
            n_data, n_model = parse_mesh_shape(args.mesh_shape)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if n_model > 1 and args.sampler not in ("bernoulli", "fused_gather"):
        raise SystemExit(
            f"--mesh-shape with model={n_model} shards the feature dim, "
            f"which composes with sampler=bernoulli or fused_gather (got "
            f"{args.sampler!r})")
    mesh = get_mesh(data=n_data, model=n_model, device=args.device)
    if args.stream_cache is not None:
        return _run_ssgd_stream(args, mesh)
    data = datasets.breast_cancer_split()
    kw = dict(
        n_iterations=args.n_iterations, eta=args.eta,
        mini_batch_fraction=args.mini_batch_fraction, lam=args.lam,
        reg_type=args.reg_type, sampler=args.sampler,
        x_dtype=args.x_dtype, gather_block_rows=args.gather_block_rows,
        fused_pack=args.fused_pack, shuffle_seed=args.shuffle_seed,
        feature_sharded=n_model > 1, comm=args.comm, sync=args.sync)
    if args.sampler != "fused_train" and args.mega_steps is not None:
        raise SystemExit(f"--mega-steps applies to sampler=fused_train "
                         f"only (got {args.sampler})")
    if args.sampler == "fused_train":
        mega = _mega_steps(args, ssgd.SSGDConfig().mega_steps)
        kw["mega_steps"] = mega
        # the kernel evaluates at launch boundaries only
        kw["eval_every"] = max(1, min(mega, args.n_iterations))
    t0 = time.perf_counter()
    res = ssgd.train(*data, mesh, ssgd.SSGDConfig(**kw),
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every)
    w = res.w.cpu()   # waits for the card
    _report("ssgd", dataclasses.replace(res, w=w), args,
            time.perf_counter() - t0)


def _run_kmeans(args) -> None:
    from tpu_distalg_torch.models import kmeans as m
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    if args.max_restarts != 0:
        raise SystemExit("--max-restarts waits for the faults slice "
                         "(ROADMAP A12); only 0 is accepted")
    mesh = get_mesh(data=args.n_slices or None, device=args.device)
    if _uses_data(args):
        # the out-of-core engine: the mixture behind a ShardedDataset
        # (host memory or a disk cache) and minibatch k-means over it
        from tpu_distalg_torch.data import builders

        if args.checkpoint_dir:
            raise SystemExit(
                "--checkpoint-dir is not supported by the minibatch "
                "engine yet (state is tiny; rerun instead)")
        _need_stream_cache(args)
        ds, _ = builders.gaussian_points_dataset(
            mesh, args.scale_points or args.n_points or (1 << 20),
            dim=args.dim, k=args.k, seed=0, block_rows=args.block_rows,
            backend=args.data_backend, path=args.stream_cache)
        res = m.fit_minibatch(ds, m.KMeansConfig(k=args.k),
                              n_steps=args.minibatch_steps or 100,
                              mini_batch_blocks=args.mini_batch_blocks)
        print(f"Final centers: {res.centers.cpu().tolist()}")
        print(f"minibatch steps run: {res.n_iterations_run} "
              f"(backend={args.data_backend})")
        return
    ckpt = dict(checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every)
    if args.scale_points:
        make_rows, _ = datasets.gaussian_mixture_rows(k=args.k, dim=args.dim,
                                                      seed=0)
        res = m.fit_scaled(
            mesh, args.scale_points, make_rows,
            m.KMeansConfig(k=args.k, n_iterations=args.n_iterations,
                           converge_dist=args.converge_dist,
                           init="farthest"), **ckpt)
    else:
        pts = (datasets.toy_kmeans_matrix() if args.n_points == 0
               else datasets.gaussian_mixture(args.n_points, k=args.k))
        res = m.fit(pts, mesh, m.KMeansConfig(
            k=args.k, n_iterations=args.n_iterations,
            converge_dist=args.converge_dist), **ckpt)
    print(f"Final centers: {res.centers.cpu().tolist()}")
    print(f"iterations run: {res.n_iterations_run}")


def _need_stream_cache(args) -> None:
    if args.data_backend == "streamed" and not args.stream_cache:
        raise SystemExit(
            "--data-backend streamed needs --stream-cache PATH "
            "(the on-disk packed cache to create or reopen)")


def _run_als(args) -> None:
    """``als``: the mesh fit, or with ``--data-backend`` virtual or
    streamed the sweep over R streamed from a ShardedDataset
    (``tpu_distalg/cli.py:1546-1575``)."""
    from tpu_distalg_torch.models import als

    mesh = _mesh(args)
    cfg = als.ALSConfig(lam=args.lam, m=args.m, n=args.n, k=args.k,
                        n_iterations=args.n_iterations, seed=args.seed)
    if _uses_data(args):
        from tpu_distalg_torch.data import builders

        if args.checkpoint_dir:
            raise SystemExit("--checkpoint-dir is not supported by the "
                             "streamed ALS path yet")
        _need_stream_cache(args)
        ds, _ = builders.rank_k_rows_dataset(
            mesh, args.m, args.n, args.k, seed=cfg.seed,
            block_rows=args.block_rows, backend=args.data_backend,
            path=args.stream_cache)
        res = als.fit_streamed(ds, cfg, rmse_every=args.rmse_every)
    else:
        res = als.fit(mesh, cfg, checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every)
    for t, e in enumerate(res.rmse_history.cpu().numpy()):
        print(f"iterations: {t}, rmse: {float(e):f}")
    if args.checkpoint_dir:
        from tpu_distalg_torch.telemetry import events as tevents

        tevents.emit("artifact_path", workload="als",
                     path=args.checkpoint_dir)
        print(f"artifact_path: {args.checkpoint_dir}")


def _serve_payloads(model, rng, n: int) -> list:
    """A demo load for a served model, as the JAX CLI draws it."""
    import numpy as np

    if model.kind == "als":
        return list(rng.integers(0, max(1, model.meta["n_users"]), size=n))
    width = model.meta["dim" if model.kind == "kmeans" else "d"]
    return list(rng.normal(size=(n, width)).astype(np.float32))


def _run_pagerank(args) -> None:
    import time

    import numpy as np
    import torch

    from tpu_distalg_torch import native
    from tpu_distalg_torch.models import pagerank as m
    from tpu_distalg_torch.ops import graph as gops
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    if args.max_restarts != 0:
        raise SystemExit("--max-restarts waits for the faults slice "
                         "(ROADMAP A12); only 0 is accepted")
    if args.edge_file is not None:
        edges = native.parse_edges_text(args.edge_file, args.edge_capacity)
    elif args.n_vertices == 0:
        edges = datasets.toy_graph_edges()
    else:
        edges = datasets.erdos_renyi_edges(args.n_vertices)
    # the edge content is authoritative for --edge-file; the synthetic
    # graph keeps its isolated tail vertices
    n_v = int(np.asarray(edges).max()) + 1 if len(edges) else 1
    if args.edge_file is None and args.n_vertices:
        n_v = max(n_v, args.n_vertices)
    backend = m.choose_data_backend(args.data_backend)
    if backend != "resident" and args.mode == "reference":
        raise SystemExit(
            "[pagerank] the reference-parity mode is resident-only "
            "(per-vertex receive masks); the streamed engine runs "
            "mode='standard' — drop --mode reference or use "
            "--data-backend resident on a smaller graph")
    mode = args.mode or ("reference" if backend == "resident"
                         else "standard")
    mesh = get_mesh(data=args.n_slices or None, device=args.device)
    t0 = time.perf_counter()
    if backend == "resident":
        cfg = m.PageRankConfig(n_iterations=args.n_iterations, q=args.q,
                               mode=mode, scatter=args.scatter)
        el = gops.prepare_edges(edges, n_v)
        de = m.prepare_device_edges(el, mesh)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t1 = time.perf_counter()
        print(f"[pagerank] prep: {t1 - t0:.3f}s ({el.n_edges} edges, "
              f"{el.n_vertices} vertices: dedupe, dst sort, CSR upload)")
        res = m.run_prepared(de, mesh, cfg,
                             checkpoint_dir=args.checkpoint_dir,
                             checkpoint_every=args.checkpoint_every)
        mask = res.has_rank.cpu().numpy() > 0
        tail = ""
    else:
        res, tail = _run_pagerank_engine(args, edges, n_v, mesh, backend)
        t1 = t0
        mask = np.ones(res.ranks.shape[0], bool)
    ranks = res.ranks.cpu().numpy()
    dt = time.perf_counter() - t1
    for v in np.argsort(-ranks)[:10]:
        if mask[v]:
            print(f"{v} has rank: {ranks[v]}.")
    print(f"[pagerank] {args.n_iterations} iterations in {dt:.3f}s "
          f"({args.n_iterations / dt:.2f} iter/s){tail}")


def _run_pagerank_engine(args, edges, n_v: int, mesh, backend: str):
    """``--data-backend streamed|virtual``: ingest into an edge-block
    cache (the default path keyed on V, the shards, the block size and
    the edges' sha1), then the out-of-core engine. Returns the result
    and the summary line's wire-byte tail."""
    import hashlib
    import tempfile

    import numpy as np

    from tpu_distalg_torch import graphs

    # keyed on the edge content too: two graphs of one vertex count must
    # not meet in one stale cache
    sha = hashlib.sha1(
        np.ascontiguousarray(edges, np.int64).tobytes()).hexdigest()
    path = args.stream_cache or os.path.join(
        tempfile.gettempdir(),
        f"tda_graph_cache_v{n_v}_s{mesh.n_data}_b{args.block_edges}"
        f"_{sha[:12]}")
    if args.stream_cache is None:
        print(f"[pagerank] edge-block cache: {path} (set --stream-cache "
              f"to keep it elsewhere)", file=sys.stderr)
    graphs.build_edge_block_cache(
        edges, path, n_shards=mesh.n_data, block_edges=args.block_edges,
        n_vertices=n_v, source={"kind": "edges", "sha1": sha})
    gd = graphs.open_graph_dataset(path, mesh, backend=backend)
    res = graphs.run_streamed_pagerank(
        gd, graphs.StreamedPageRankConfig(
            n_iterations=args.n_iterations, q=args.q, combine=args.combine),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)
    st = res.comm_stats
    wire = (st["bytes_wire"] if res.combine == "sparse"
            else st["bytes_dense_ring"])
    tail = (f" [{backend} engine, combine={res.combine}: {wire} B "
            f"wire/sweep; accounting sparse {st['bytes_wire']} B vs "
            f"dense-ring {st['bytes_dense_ring']} B]")
    return res, tail


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if hasattr(args, "fault_plan"):
        from tpu_distalg_torch import faults

        try:
            faults.configure(args.fault_plan)
        except (ValueError, OSError) as e:
            raise SystemExit(f"--fault-plan: {e}") from None
        _refuse_unread_plan(args)
    if args.cmd == "ssgd":
        _run_ssgd(args)
    elif args.cmd in ("lr", "ma", "bmuf", "easgd"):
        _run_optimizer(args)
    elif args.cmd == "pagerank":
        _run_pagerank(args)
    elif args.cmd == "kmeans":
        _run_kmeans(args)
    elif args.cmd == "closure":
        _run_closure(args)
    elif args.cmd == "mc":
        from tpu_distalg_torch.models import monte_carlo

        mesh = _mesh(args)
        pi, _ = monte_carlo.estimate_pi(
            mesh, monte_carlo.MonteCarloConfig(n=args.n))
        print(f"Pi is roughly {pi:f}")
    elif args.cmd == "als":
        _run_als(args)
    elif args.cmd == "serve":
        import numpy as np

        from tpu_distalg_torch import serve
        from tpu_distalg_torch.parallel import get_mesh

        mesh = get_mesh(data=args.n_slices or 1, model=args.model_slices,
                        device=args.device)
        cfg = serve.ServeConfig(
            max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
            queue_depth=args.queue_depth, k_top=args.k_top,
            merge=args.comm)
        server = serve.Server(mesh, cfg)
        try:
            for path in args.artifact:
                model = server.add_artifact(path)
                print(f"[serve] {model.kind} model {model.name!r} from "
                      f"{path} (meta: {model.meta})")
            rng = np.random.default_rng(0)
            for name, model in server.models.items():
                payloads = _serve_payloads(model, rng, args.requests)
                _, info = serve.run_closed_loop(
                    server, name, payloads,
                    concurrency=args.concurrency, retries=2)
                print(f"[serve] {name}: {info['ok']}/{len(payloads)} "
                      f"replies at {info['qps']:.2f} req/s (closed loop, "
                      f"{info['concurrency']} workers, "
                      f"{info['retries']} retries)")
            s = server.emit_counters()
            print(f"[serve] total: {s['replies']} replies in "
                  f"{s['batches']} micro-batch(es), p50 {s['p50_ms']:.3f} "
                  f"ms / p99 {s['p99_ms']:.3f} ms, {s['shed']} shed, max "
                  f"queue depth {s['max_queue_depth']}")
        finally:
            server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
