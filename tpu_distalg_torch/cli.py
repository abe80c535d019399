"""Command line of the port: full-batch LR, SSGD, the local-update family
(MA, BMUF, EASGD), ALS, k-means, PageRank, the transitive closure,
Monte-Carlo π, serving ALS, k-means and LR artifacts, the chaos harness,
telemetry reports and the cluster runtime.

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
    python -m tpu_distalg_torch.cli --device cpu --emulate 2 --multihost \
        --coordinator-address 127.0.0.1:29500 --num-processes 2 \
        --process-id 0 ssgd --sampler fused_gather  # one such per rank
    python -m tpu_distalg_torch.cli ssgd --checkpoint-dir D --max-restarts 2 \
        --telemetry-dir T --fault-plan "seed=1;segment:run@1=kill"
    python -m tpu_distalg_torch.cli chaos --workload lr \
        --fault-plan "seed=5;ckpt:write@1=corrupt;segment:run@2=kill"
    python -m tpu_distalg_torch.cli report T
    python -m tpu_distalg_torch.cli cluster --role local --spawn process \
        --workers 3 --n-windows 24 --fault-plan "seed=7;cluster:worker@37=kill"
    python -m tpu_distalg_torch.cli cluster --role coordinator --port 29600
    python -m tpu_distalg_torch.cli cluster --role worker \
        --connect 127.0.0.1:29600                 # a worker on the card
    python -m tpu_distalg_torch.cli --profile P ssgd  # a Chrome trace in P
    python -m tpu_distalg_torch.cli tune --out-dir D [--collective \
        --n-slices 4]                     # a RigProfile of this rig
    python -m tpu_distalg_torch.cli ssgd --tune auto  # or --tune PROFILE
    python -m tpu_distalg_torch.cli cluster --role local --spawn thread \
        --ps-mode rowstore                # the center in the row store
    python -m tpu_distalg_torch.cli cluster --role replica --artifact D \
        --replica-shards 2 --shard 0      # prints its port; scores on card
    python -m tpu_distalg_torch.cli cluster --role router \
        --replicas 127.0.0.1:P0,127.0.0.1:P1 --serve-mode sharded
    python -m tpu_distalg_torch.cli lint --no-ruff  # the port's own tree
    python -m tpu_distalg_torch.cli protocol --check  # the wire contract

The lines printed match the JAX package's ``tda lr``, ``tda ssgd``,
``tda ma``, ``tda bmuf``, ``tda easgd``, ``tda als``, ``tda serve``,
``tda pagerank``, ``tda kmeans``, ``tda closure``, ``tda mc``, ``tda
chaos``, ``tda report``, ``tda cluster``, ``tda tune``, ``tda lint`` and
``tda protocol``. Runs on ``cuda`` unless
``--device cpu`` is given (a cluster's workers run there; its
coordinator holds the center on the host). ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the whole run. Every run takes ``--telemetry-dir`` and ``--fault-plan``, and is
wrapped in ``checkpoint.run_with_restarts`` (``--max-restarts``) where
the JAX CLI wraps it; with ``--checkpoint-dir`` a SIGTERM stops the run
at the next checkpointed boundary with rc 75, and the same command
resumes it. ``--multihost`` joins a ``torch.distributed`` group
(:func:`..parallel.mesh.multihost_initialize`) and every process prints
the same result lines, ``--comm`` schedules, ``--sync ssp`` and a
``--checkpoint-dir`` the processes share included. ``als``, ``closure``
and the out-of-core backends run there too (a disk cache is built by
process 0 first and then opened by the others); ``serve`` runs with
process 0 as the leader, which drives the load and prints the serving
lines, and every other process following its batches.
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
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="trace the run with torch.profiler (CPU, and the "
                        "card's kernels with --device cuda) and write a "
                        "Chrome trace (*.pt.trace.json, for Perfetto) "
                        "into DIR")
    p.add_argument("--emulate", type=int, default=0, metavar="N",
                   help="hold N emulated data shards in each process "
                        "when --n-slices/--mesh-shape do not say (unlike "
                        "the JAX CLI, keeps --device)")
    p.add_argument("--multihost", action="store_true",
                   help="join a torch.distributed process group before "
                        "building the mesh; run the same command in every "
                        "process")
    p.add_argument("--coordinator-address", type=str, default=None,
                   help="host:port of process 0 (with --multihost); omit "
                        "all three under torchrun, whose environment "
                        "names the group")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count (with --coordinator-address)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (with --coordinator-address)")
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
    _add_mesh_flags(o)
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
    _add_max_restarts(o)
    _add_telemetry(o)

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
    _add_telemetry(a)

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
    _add_telemetry(s)

    c = sub.add_parser("kmeans", help="k-means (Lloyd's algorithm)")
    _add_mesh_flags(c)
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
    c.add_argument("--plot", type=str, default=None,
                   help="save a cluster scatter PNG (2-D data; needs "
                        "matplotlib)")
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
    _add_max_restarts(c)
    _add_telemetry(c)

    g = sub.add_parser("pagerank", help="PageRank power iteration")
    _add_mesh_flags(g)
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
    _add_max_restarts(g)
    _add_telemetry(g)

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
    _add_telemetry(t)

    m = sub.add_parser("mc", help="Monte-Carlo pi")
    _add_mesh_flags(m)
    m.add_argument("--n", type=int, default=400_000)
    _add_max_restarts(m)
    _add_telemetry(m)

    _add_cluster(sub)

    from tpu_distalg_torch.faults import chaos

    h = sub.add_parser(
        "chaos",
        help="run a small workload twice — undisturbed, then under an "
             "injected fault schedule with the full recovery stack "
             "armed — and verify the recovered final state is bitwise-"
             "equal (rc 1 on mismatch)")
    h.add_argument("--workload", default="lr", choices=list(chaos.WORKLOADS))
    _add_mesh_flags(h)
    h.add_argument("--n-iterations", type=int, default=None,
                   help="override the workload's small default")
    h.add_argument("--checkpoint-every", type=int, default=None)
    h.add_argument("--max-restarts", type=int,
                   default=chaos.DEFAULT_MAX_RESTARTS,
                   help="restart budget for the chaos run")
    h.add_argument("--spawn", default="thread",
                   choices=["thread", "process"],
                   help="cluster workload only: thread workers (fast) or "
                        "real worker processes (a genuine kill -9)")
    h.add_argument("--comm", default="dense", metavar="SCHED",
                   help="cluster workload only: the wire schedule both "
                        "runs use (dense, int8[:seed], topk[:frac])")
    h.add_argument("--workdir", type=str, default=None,
                   help="checkpoint scratch directory (default: a fresh "
                        "temp dir, removed on success)")
    _add_telemetry(h)

    u = sub.add_parser(
        "tune",
        help="measure this rig — framed-TCP loopback bandwidth/RTT, host "
             "memcpy, the host's numpy matmul FLOP/s, host RAM, each "
             "--comm codec's throughput, the init time of --device in a "
             "cold child, optionally the psum over emulated data shards — "
             "and write a versioned rig-tagged RigProfile JSON; every "
             "subcommand's '--tune auto' then resolves its geometry from "
             "the newest profile (tune/resolve.py)")
    u.add_argument("--out-dir", type=str, default=None, metavar="DIR",
                   help="profile directory (default $TDA_PROFILE_DIR or "
                        "./.tda_profiles)")
    u.add_argument("--seed", type=int, default=0,
                   help="measurement seed (profiles are seeded and "
                        "deterministic but for the measured timings)")
    u.add_argument("--quick", action="store_true",
                   help="smaller working sets (the artifact records "
                        "quick=true)")
    u.add_argument("--no-backend-init", action="store_true",
                   help="skip the subprocess-timed backend init "
                        "measurement (the slowest pass)")
    u.add_argument("--collective", action="store_true",
                   help="also measure the psum of the port's collectives "
                        "over the mesh's data shards on --device")
    u.add_argument("--n-slices", type=int, default=0,
                   help="with --collective: data shards; 0 = the emulated "
                        "count (--emulate) a process, else 1")
    u.add_argument("--mesh-shape", type=str, default=None, metavar="DxM",
                   help="with --collective: mesh data x model (replaces "
                        "--n-slices)")
    u.add_argument("--telemetry-dir", type=str, default=None,
                   metavar="DIR",
                   help="record the profiling pass as telemetry events (a "
                        "'tune' span)")

    from tpu_distalg_torch.analysis import cli as lint_cli

    li = sub.add_parser(
        "lint",
        help="static analysis for the framework's own invariants "
             "(TDA0xx rules: determinism, trace purity, concurrency, "
             "fault-seam coverage, Pallas hygiene; TDA1xx over the "
             "project graph); exits 1 on un-baselined violations; "
             "chain-runs ruff when installed")
    lint_cli.add_parser_args(li)
    li.add_argument("--telemetry-dir", type=str, default=None,
                    metavar="DIR",
                    help="record the lint run as telemetry events (a "
                         "'lint' span + per-rule counters)")
    pr = sub.add_parser(
        "protocol",
        help="extract the cluster wire contract from source (frame "
             "kinds, payload keys, reply pairings, fencing, WAL "
             "records) as a deterministic table; --check pins "
             f"{lint_cli.PROTOCOL_DOC} against it")
    lint_cli.add_protocol_args(pr)
    pr.add_argument("--telemetry-dir", type=str, default=None,
                    metavar="DIR",
                    help="record the extraction as telemetry events (a "
                         "'protocol' span)")

    r = sub.add_parser("report",
                       help="summarize a telemetry event log: phase "
                            "durations, stalls, backend-init attempts, "
                            "restarts, preemptions, injected faults, last "
                            "heartbeat, metrics; several dirs (or a parent "
                            "of per-process dirs) render one merged report")
    r.add_argument("dir", nargs="+",
                   help="telemetry directory (of events-*.jsonl), one "
                        "event file, a parent directory of per-process "
                        "telemetry dirs, or several of these")
    r.add_argument("--json", action="store_true",
                   help="print the full summary as JSON (for CI)")
    return p


def _add_cluster(sub) -> None:
    """``cluster``, with the JAX CLI's options, defaults and choices
    (``tpu_distalg/cli.py:449-620``)."""
    p = sub.add_parser(
        "cluster",
        help="multi-process elastic runtime (tpu_distalg_torch/cluster/): "
             "a coordinator plus N workers exchanging staleness-weighted "
             "deltas with a parameter-server tier over a framed TCP "
             "transport — kill -9 a worker mid-window and training "
             "continues at reduced quorum; a fresh worker rejoins by "
             "pulling the center")
    p.add_argument("--role", default="local",
                   choices=["coordinator", "worker", "local", "replica",
                            "router"],
                   help="coordinator = serve rendezvous/clock/PS on "
                        "--host:--port; worker = join a coordinator at "
                        "--connect and train on --device; local = a "
                        "coordinator plus --workers N workers on this "
                        "machine; replica = one serving replica (loads "
                        "--artifact, scores on --device over the framed "
                        "transport, hot-swappable); router = the serving "
                        "front end dispatching at --replicas")
    p.add_argument("--workers", type=int, default=3,
                   help="worker slot count (coordinator/local roles)")
    p.add_argument("--spawn", default="process",
                   choices=["process", "thread"],
                   help="local role: real worker processes (kill -9 is the "
                        "genuine article) or threads (same protocol and "
                        "sockets, fast for tests)")
    p.add_argument("--coordinator-spawn", default="inproc",
                   choices=["inproc", "process"],
                   help="local role: the coordinator in this process (a "
                        "cluster:coordinator kill cell slams its sockets) "
                        "or a real subprocess (a genuine kill -9; the "
                        "launcher respawns it on the same port and it "
                        "recovers from the WAL — needs --checkpoint-dir)")
    p.add_argument("--connect", type=str, default=None, metavar="HOST:PORT",
                   help="worker role: the coordinator's address")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="coordinator bind port (0 = ephemeral, printed at "
                        "start)")
    p.add_argument("--slot", type=int, default=None,
                   help="worker role: requested slot (default: any free)")
    p.add_argument("--rejoin", action="store_true",
                   help="worker role: a replacement for a departed slot")
    p.add_argument("--admit-at", type=int, default=None,
                   help="worker role: pin admission to this window (the "
                        "launcher's replay-determinism hook)")
    p.add_argument("--n-windows", type=int, default=24,
                   help="merge windows to train (each = s local ticks per "
                        "worker)")
    p.add_argument("--sync", default="ssp:4", metavar="MODE",
                   help="ssp[:s[:decay]]: s = ticks per window and the "
                        "clock gate's bound, decay = the merge weight "
                        "decay^age")
    p.add_argument("--algo", default="ssgd", choices=["ssgd", "local_sgd"],
                   help="the trainer each worker wraps between push/pull "
                        "seams")
    p.add_argument("--ps-shards", type=int, default=2,
                   help="parameter-server tier width (the center split by "
                        "the model's partition rule table)")
    p.add_argument("--comm", default="dense", metavar="SCHED",
                   help="wire schedule: dense (f32 snapshots), int8[:seed] "
                        "(seeded stochastic rounding both ways) or "
                        "topk[:frac] (pairs with worker-side error "
                        "feedback; pulls ride int8); compressed pushes "
                        "overlap the next window unless @seq")
    p.add_argument("--ps-mode", default="replicated",
                   choices=["replicated", "rowstore"],
                   help="PS state layout: replicated = each shard holds "
                        "dense slices and merges whole deltas; rowstore = "
                        "shards own disjoint leading-dim row ranges "
                        "(partition rule table), pushes carry {leaf}.rows "
                        "index arrays and merge row-wise with per-row "
                        "versions (cluster/rowstore.py)")
    p.add_argument("--pull-refresh-windows", type=int, default=None,
                   metavar="N",
                   help="compressed pulls: every Nth commit ships a dense "
                        "version-pinned pull (default: tune/defaults.py)")
    p.add_argument("--policy", default="elastic",
                   choices=["elastic", "restart"],
                   help="elastic = continue at reduced quorum and rejoin; "
                        "restart = abort and respawn everything from the "
                        "checkpoint (the BSP-restart baseline)")
    p.add_argument("--rejoin-after", type=int, default=3,
                   help="local elastic role: windows a killed slot stays "
                        "away before its replacement is admitted")
    p.add_argument("--heartbeat-timeout", type=float, default=5.0,
                   help="seconds of worker silence before the coordinator "
                        "declares it dead")
    p.add_argument("--heartbeat-interval", type=float, default=0.5,
                   help="seconds between worker liveness beats")
    p.add_argument("--rpc-deadline", type=float, default=30.0,
                   help="bound on any single blocking round trip")
    p.add_argument("--reconnect-grace", type=float, default=1.0,
                   help="seconds a connection's EOF leaves its slot "
                        "suspect before the death fires")
    p.add_argument("--n-rows", type=int, default=4096,
                   help="training rows of the shared synthetic task")
    p.add_argument("--train-json", type=str, default=None, metavar="JSON",
                   help="coordinator role: the exact TrainTask as JSON "
                        "(the launcher's subprocess handoff; overrides "
                        "--algo and --n-rows)")
    p.add_argument("--artifact", type=str, default=None, metavar="CKPT_DIR",
                   help="replica role: checkpoint directory to serve (the "
                        "artifact_path: line a training command prints)")
    p.add_argument("--replica-shards", type=int, default=1,
                   help="replica role: the model-axis shard count of the "
                        "fleet this replica belongs to")
    p.add_argument("--shard", type=int, default=0,
                   help="replica role: this replica's model-axis shard")
    p.add_argument("--k-top", type=int, default=10,
                   help="serving plane: top-k candidates of an ALS request")
    p.add_argument("--merge", default="sparse", choices=["sparse", "dense"],
                   help="serving plane: the ALS candidate merge across "
                        "replicas — sparse (value, index) pairs (B9 on "
                        "each shard) or the dense score blocks")
    p.add_argument("--replicas", type=str, default=None,
                   metavar="HOST:PORT[,HOST:PORT...]",
                   help="router role: the replica fleet's addresses")
    p.add_argument("--dispatch", default="least_loaded",
                   choices=["least_loaded", "consistent_hash"],
                   help="router role: dispatch policy")
    p.add_argument("--serve-mode", default="routed",
                   choices=["routed", "sharded"],
                   help="router role: routed = each request to one "
                        "replica (re-routed on a death); sharded = to "
                        "every model-axis shard, candidates merged")
    p.add_argument("--wal-dir", type=str, default=None, metavar="DIR",
                   help="router role: the durable routing state (a "
                        "restarted router replays it and rebinds the same "
                        "port)")
    p.add_argument("--deadline", type=float, default=600.0,
                   help="local/coordinator roles: give up if the run is "
                        "still incomplete after this many seconds")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="the coordinator's center checkpoints and WAL")
    p.add_argument("--checkpoint-every", type=int, default=8)
    p.add_argument("--max-restarts", type=int, default=0,
                   help="refused above 0: the cluster recovers through "
                        "its launcher (respawns, the WAL), not by "
                        "re-running the command")
    _add_telemetry(p)


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


def _add_mesh_flags(p, what: str = "emulated data shards") -> None:
    """``--n-slices`` and the one definition of ``--mesh-shape``, as the
    JAX CLI gives them (``tpu_distalg/cli.py:34-41``)."""
    p.add_argument("--n-slices", type=int, default=0,
                   help=f"{what}; 0 = the emulated count (--emulate) a "
                        f"process, else 1")
    p.add_argument("--mesh-shape", type=str, default=None, metavar="DxM",
                   help="mesh data x model (e.g. 2x2); placement falls out "
                        "of the workload's rule table — replaces "
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


def _add_telemetry(p) -> None:
    """``--telemetry-dir``, ``--fault-plan`` and ``--tune`` (the JAX CLI's
    ``_add_telemetry``, ``tpu_distalg/cli.py:169-199``)."""
    p.add_argument("--telemetry-dir", type=str, default=None,
                   metavar="DIR",
                   help="write structured JSONL runtime events here "
                        "($TDA_TELEMETRY_DIR is the default when "
                        "unset); summarize with 'tda report DIR'")
    p.add_argument(
        "--fault-plan", type=str, default=None, metavar="SPEC",
        help="deterministic fault-injection plan: inline "
             "'seed=N;point@hit=kind[:arg];...' or a JSON plan file "
             "($TDA_FAULT_PLAN is the default; points: ckpt:write, "
             "ckpt:read, cache:write, data:gather, data:h2d, "
             "backend:init, segment:run, shard:straggle, shard:leave, "
             "cluster:worker, cluster:rpc, cluster:coordinator, "
             "cluster:wal, cluster:ps, cluster:replica; kinds: oserror, "
             "hang, corrupt, "
             "kill, straggle, leave). The same plan+seed replays the same "
             "failure sequence bitwise — see 'tda chaos'. A rule no seam "
             "of the run reads is refused")
    p.add_argument("--tune", type=str, default="off", metavar="MODE",
                   help="geometry from a measured rig profile "
                        "(tpu_distalg_torch/tune/): 'off' = the default "
                        "tables, 'auto' = resolve comm schedule, bucket "
                        "elems, mesh shape, ps-shards/mode, block sizes and "
                        "pull-refresh cadence from this rig's newest "
                        "profile (run 'tda tune' once), or a "
                        "RIGPROFILE_*.json path. Explicit flags always win; "
                        "each knob logs a tune_knob event with its WHY. "
                        "Tuning changes geometry, never determinism")


#: the seams a run reads, by what the run does
_CKPT_POINTS = ("ckpt:write", "ckpt:read", "segment:run")
_DATA_POINTS = ("data:gather", "data:h2d", "cache:write")
_SSP_POINTS = ("shard:straggle", "shard:leave")
_CLUSTER_POINTS = ("cluster:worker", "cluster:rpc", "cluster:coordinator",
                   "cluster:wal", "cluster:ps", "cluster:replica")


def _plan_reads(args) -> set:
    """The fault points some seam of this run reads."""
    from tpu_distalg_torch.parallel import ssp as pssp

    if args.cmd == "serve":
        return {"ckpt:read", "data:gather"}
    if args.cmd == "cluster":
        # the coordinator's center checkpoints write and read; it runs
        # no segments
        return set(_CLUSTER_POINTS) | (
            {"ckpt:write", "ckpt:read"} if args.checkpoint_dir else set())
    reads = set()
    try:
        is_ssp = pssp.SyncSpec.parse(getattr(args, "sync", "bsp")).is_ssp
    except ValueError:
        is_ssp = False  # the trainer refuses the spelling in JAX's words
    if is_ssp and args.cmd in ("ssgd", "ma", "bmuf", "easgd"):
        reads |= set(_SSP_POINTS)
    if _uses_data(args):
        reads |= set(_DATA_POINTS)
    if getattr(args, "checkpoint_dir", None):
        reads |= set(_CKPT_POINTS)
    return reads


def _refuse_unread_plan(args) -> None:
    """A rule that no seam of this run reads would never fire: refuse
    it. A run with ``--checkpoint-dir`` reads the checkpoint and segment
    points, ``serve`` the artifact read and the batch dispatch, the runs
    through the data subsystem the data points and the SSP runs the
    shard points; ``backend:init`` is read by
    ``telemetry.supervisor.init_backend`` only."""
    from tpu_distalg_torch import faults

    reg = faults.active()
    if reg is None:
        return
    reads = _plan_reads(args)
    unread = sorted({r.point for r in reg.plan.rules} - reads)
    if not unread:
        return
    run = f"{args.cmd} --sync {args.sync}" if hasattr(args, "sync") \
        else args.cmd
    if not reads:
        raise SystemExit(
            f"--fault-plan: {run} reads no fault plan (the port fires "
            f"{', '.join(_CKPT_POINTS)} on a run with --checkpoint-dir, "
            f"ckpt:read and data:gather in serve, "
            f"{', '.join(_DATA_POINTS)} on the runs through the data "
            f"subsystem, and compiles {' and '.join(_SSP_POINTS)} into the "
            f"--sync ssp runs of ssgd, ma, bmuf and easgd; backend:init "
            f"fires in telemetry.supervisor.init_backend only, and the "
            f"cluster:* points in the cluster runtime, tda cluster)")
    raise SystemExit(
        f"--fault-plan: {run} reads no rule at {', '.join(unread)} (it "
        f"reads {', '.join(sorted(reads))})")


def _add_max_restarts(p) -> None:
    """``--max-restarts`` (``tpu_distalg/cli.py:202-215``): the run is
    wrapped in ``checkpoint.run_with_restarts``."""
    p.add_argument("--max-restarts", type=int, default=0,
                   help="auto-restart the run up to N times on crash or "
                        "NaN-guard trip; with --checkpoint-dir each "
                        "restart resumes from the latest checkpoint "
                        "(bitwise-identical to an uninterrupted run)")


def _mesh(args):
    """The mesh of ``--n-slices`` or ``--mesh-shape`` on ``--device``
    (``--emulate``'s count a process when neither says), with the JAX
    CLI's refusals and its warning for a model axis the workload does
    not use (``tpu_distalg/cli.py:45-77``)."""
    from tpu_distalg_torch.parallel import get_mesh

    data, model = args.n_slices or None, 1
    if args.mesh_shape:
        if args.n_slices > 0:
            raise SystemExit(
                "--mesh-shape and --n-slices both set: --mesh-shape "
                "IS the full (data x model) geometry; drop --n-slices")
        try:
            data, model = parse_mesh_shape(args.mesh_shape)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        # ssgd engages the tp split, ALS splits V over the model axis
        if model > 1 and args.cmd not in ("ssgd", "als"):
            print(f"[mesh] warning: --mesh-shape {data}x{model} puts "
                  f"{model}-way model parallelism on a workload whose "
                  f"rule table has no model-axis placement — those "
                  f"devices will idle; use --mesh-shape "
                  f"{data * model}x1 (or --n-slices {data * model}) "
                  f"for full data parallelism", file=sys.stderr)
    try:
        return get_mesh(data=data, model=model, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e)) from None


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
        res = _with_restarts(args, lambda: m.run_sparse(
            edges, mesh, m.SparseClosureConfig(capacity=args.capacity or None),
            **ckpt))
    else:
        res = _with_restarts(args, lambda: m.run(edges, mesh, **ckpt))
    print(f"The original graph has {res.n_paths} paths "
          f"({res.n_rounds} rounds)")


def _add_optimizer(p, n_iterations: int) -> None:
    """The flags the JAX CLI gives ``lr``, ``ma``, ``bmuf`` and
    ``easgd`` (``tpu_distalg/cli.py:256-288``), defaults included."""
    _add_mesh_flags(p, "emulated data shards (replicas)")
    p.add_argument("--n-iterations", type=int, default=n_iterations)
    p.add_argument("--eta", type=float, default=0.1)
    _add_comm(p)
    p.add_argument("--plot", type=str, default=None,
                   help="save an accuracy plot PNG here")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="segmented checkpoint/resume directory")
    p.add_argument("--checkpoint-every", type=int, default=500)
    _add_max_restarts(p)
    _add_telemetry(p)


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

    from tpu_distalg_torch.utils import datasets

    if args.cmd != "lr" and args.mega_steps is not None:
        raise SystemExit(
            f"{args.cmd}: --mega-steps applies to ssgd only — "
            "local-update megakernels launch n-local-iterations "
            "steps per round")
    data = datasets.breast_cancer_split()
    mesh = _mesh(args)
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
        res = _with_restarts(args, lambda: m.train(
            *data, mesh, cfg, checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every))
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
    from tpu_distalg_torch.parallel.collectives import rank0_first
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
    X2, meta, (X_te, y_te) = rank0_first(
        mesh, lambda: datasets.streamed_packed_cache(
            args.stream_cache, n_rows=args.stream_rows, n_features=125,
            n_shards=mesh.n_data, pack=args.fused_pack,
            gather_block_rows=args.gather_block_rows))
    cfg = ssgd.SSGDConfig(
        n_iterations=args.n_iterations, eta=args.eta,
        mini_batch_fraction=args.mini_batch_fraction, lam=args.lam,
        reg_type=args.reg_type, fused_pack=args.fused_pack,
        gather_block_rows=args.gather_block_rows, sampler="fused_gather",
        shuffle_seed=None, eval_every=max(1, args.n_iterations // 10))
    t0 = time.perf_counter()
    res = _with_restarts(args, lambda: ssgd_stream.train(
        X2, meta, mesh, cfg, X_te, y_te,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every))
    w = res.w.cpu()   # waits for the card
    _report("ssgd", dataclasses.replace(res, w=w), args,
            time.perf_counter() - t0)


def _run_ssgd(args) -> None:
    import time

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.utils import datasets

    mesh = _mesh(args)
    n_model = mesh.n_model
    if n_model > 1 and args.sampler not in ("bernoulli", "fused_gather"):
        raise SystemExit(
            f"--mesh-shape with model={n_model} shards the feature dim, "
            f"which composes with sampler=bernoulli or fused_gather (got "
            f"{args.sampler!r})")
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
    res = _with_restarts(args, lambda: ssgd.train(
        *data, mesh, ssgd.SSGDConfig(**kw),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every))
    w = res.w.cpu()   # waits for the card
    _report("ssgd", dataclasses.replace(res, w=w), args,
            time.perf_counter() - t0)


def _run_kmeans(args) -> None:
    from tpu_distalg_torch.models import kmeans as m
    from tpu_distalg_torch.parallel.collectives import rank0_first
    from tpu_distalg_torch.utils import datasets

    mesh = _mesh(args)
    if _uses_data(args):
        # the out-of-core engine: the mixture behind a ShardedDataset
        # (host memory or a disk cache) and minibatch k-means over it
        from tpu_distalg_torch.data import builders

        if args.checkpoint_dir:
            raise SystemExit(
                "--checkpoint-dir is not supported by the minibatch "
                "engine yet (state is tiny; rerun instead)")
        _need_stream_cache(args)
        ds, _ = rank0_first(mesh, lambda: builders.gaussian_points_dataset(
            mesh, args.scale_points or args.n_points or (1 << 20),
            dim=args.dim, k=args.k, seed=0, block_rows=args.block_rows,
            backend=args.data_backend, path=args.stream_cache))
        res = _with_restarts(args, lambda: m.fit_minibatch(
            ds, m.KMeansConfig(k=args.k),
            n_steps=args.minibatch_steps or 100,
            mini_batch_blocks=args.mini_batch_blocks))
        print(f"Final centers: {res.centers.cpu().tolist()}")
        print(f"minibatch steps run: {res.n_iterations_run} "
              f"(backend={args.data_backend})")
        if args.plot:
            print("--plot ignored with the minibatch engine (points stay "
                  "in the dataset)")
        return
    ckpt = dict(checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every)
    if args.scale_points:
        make_rows, _ = datasets.gaussian_mixture_rows(k=args.k, dim=args.dim,
                                                      seed=0)
        res = _with_restarts(args, lambda: m.fit_scaled(
            mesh, args.scale_points, make_rows,
            m.KMeansConfig(k=args.k, n_iterations=args.n_iterations,
                           converge_dist=args.converge_dist,
                           init="farthest"), **ckpt))
    else:
        pts = (datasets.toy_kmeans_matrix() if args.n_points == 0
               else datasets.gaussian_mixture(args.n_points, k=args.k))
        res = _with_restarts(args, lambda: m.fit(pts, mesh, m.KMeansConfig(
            k=args.k, n_iterations=args.n_iterations,
            converge_dist=args.converge_dist), **ckpt))
    print(f"Final centers: {res.centers.cpu().tolist()}")
    print(f"iterations run: {res.n_iterations_run}")
    if args.plot:
        _plot_clusters(args, res, None if args.scale_points else pts, mesh)


def _plot_clusters(args, res, pts, mesh) -> None:
    """``kmeans --plot`` (``tpu_distalg/cli.py:1400-1411``)."""
    if pts is None:
        print("--plot ignored with --scale-points (points stay on device)")
    elif mesh.process_count > 1:
        print("--plot ignored across processes (each holds only its "
              "points' assignments)")
    else:
        from tpu_distalg_torch.utils import metrics

        metrics.display_clusters(
            pts, res.assignments.cpu().numpy()[: len(pts)], args.plot,
            k=args.k)
        print(f"saved plot: {args.plot}")


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
    from tpu_distalg_torch.parallel.collectives import rank0_first

    mesh = _mesh(args)
    cfg = als.ALSConfig(lam=args.lam, m=args.m, n=args.n, k=args.k,
                        n_iterations=args.n_iterations, seed=args.seed)
    if _uses_data(args):
        from tpu_distalg_torch.data import builders

        if args.checkpoint_dir:
            raise SystemExit("--checkpoint-dir is not supported by the "
                             "streamed ALS path yet")
        _need_stream_cache(args)
        ds, _ = rank0_first(mesh, lambda: builders.rank_k_rows_dataset(
            mesh, args.m, args.n, args.k, seed=cfg.seed,
            block_rows=args.block_rows, backend=args.data_backend,
            path=args.stream_cache))
        res = _with_restarts(args, lambda: als.fit_streamed(
            ds, cfg, rmse_every=args.rmse_every))
    else:
        res = _with_restarts(args, lambda: als.fit(
            mesh, cfg, checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every))
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
    from tpu_distalg_torch.utils import datasets

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
    mesh = _mesh(args)
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
        res = _with_restarts(args, lambda: m.run_prepared(
            de, mesh, cfg, checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every))
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
    from tpu_distalg_torch.parallel.collectives import rank0_first

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
    rank0_first(mesh, lambda: graphs.build_edge_block_cache(
        edges, path, n_shards=mesh.n_data, block_edges=args.block_edges,
        n_vertices=n_v, source={"kind": "edges", "sha1": sha}))
    gd = graphs.open_graph_dataset(path, mesh, backend=backend)
    res = _with_restarts(args, lambda: graphs.run_streamed_pagerank(
        gd, graphs.StreamedPageRankConfig(
            n_iterations=args.n_iterations, q=args.q, combine=args.combine),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every))
    st = res.comm_stats
    wire = (st["bytes_wire"] if res.combine == "sparse"
            else st["bytes_dense_ring"])
    tail = (f" [{backend} engine, combine={res.combine}: {wire} B "
            f"wire/sweep; accounting sparse {st['bytes_wire']} B vs "
            f"dense-ring {st['bytes_dense_ring']} B]")
    return res, tail


def _dispatch(args) -> int:
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
        pi, _ = _with_restarts(args, lambda: monte_carlo.estimate_pi(
            mesh, monte_carlo.MonteCarloConfig(n=args.n)))
        print(f"Pi is roughly {pi:f}")
    elif args.cmd == "als":
        _run_als(args)
    elif args.cmd == "serve":
        _run_serve(args)
    elif args.cmd == "chaos":
        return _run_chaos(args)
    elif args.cmd == "cluster":
        return _run_cluster(args)
    return 0


def _with_restarts(args, run_once):
    """``run_once()`` under ``checkpoint.run_with_restarts`` with the
    run's ``--max-restarts``, where the JAX CLI wraps it."""
    from tpu_distalg_torch.utils import checkpoint

    return checkpoint.run_with_restarts(
        run_once, max_restarts=args.max_restarts)


def _run_chaos(args) -> int:
    """``chaos`` (``tpu_distalg/cli.py:1600-1640``): rc 1 on a mismatch;
    a temporary ``--workdir`` is removed on success and kept on
    failure."""
    import shutil
    import tempfile

    from tpu_distalg_torch import faults
    from tpu_distalg_torch.faults import chaos

    spec = args.fault_plan or os.environ.get(faults.ENV_PLAN)
    if not spec:
        raise SystemExit(
            "tda chaos needs a fault schedule: pass --fault-plan "
            "'seed=N;point@hit=kind[:arg];...' (or a JSON plan file, or "
            "export $TDA_FAULT_PLAN)")
    if (args.spawn != "thread" and args.workload != "cluster") or (
            args.comm != "dense"
            and args.workload not in ("cluster", "rowstore")):
        raise SystemExit("[chaos] --spawn and --comm set the cluster "
                         "workload's workers and wire (--comm also the "
                         "rowstore workload's); the "
                         f"{args.workload} workload has neither")
    try:
        plan = faults.FaultPlan.parse(spec)
    except (ValueError, OSError) as e:
        raise SystemExit(f"--fault-plan: {e}") from None
    mesh = _mesh(args)
    workdir = args.workdir
    made_tmp = workdir is None
    if made_tmp:
        workdir = tempfile.mkdtemp(prefix="tda-chaos-")
    res = None
    try:
        res = chaos.run_chaos(
            args.workload, mesh, plan=plan, workdir=workdir,
            n_iterations=args.n_iterations,
            checkpoint_every=args.checkpoint_every,
            max_restarts=args.max_restarts, spawn=args.spawn,
            comm=args.comm, logger=lambda m: print(f"[chaos] {m}"))
    finally:
        if made_tmp:
            if res is not None and res.equal:
                shutil.rmtree(workdir, ignore_errors=True)
            else:
                print(f"[chaos] scratch kept for debugging: {workdir}",
                      file=sys.stderr)
    print(res.verdict())
    return 0 if res.equal else 1


#: --tune knob -> (argparse dest, the option strings that mark it spelled
#: out). A knob is applied only where the subcommand has the flag;
#: explicit flags always win (``tpu_distalg/cli.py:867-879``)
_TUNE_FLAG_KNOBS = (
    ("comm", "comm", ("--comm",)),
    ("mesh_shape", "mesh_shape", ("--mesh-shape",)),
    ("ps_shards", "ps_shards", ("--ps-shards",)),
    ("ps_mode", "ps_mode", ("--ps-mode",)),
    ("block_rows", "block_rows", ("--block-rows",)),
    ("block_edges", "block_edges", ("--block-edges",)),
    ("pull_refresh_windows", "pull_refresh_windows",
     ("--pull-refresh-windows",)),
)


def _spelled_options(argv) -> set:
    """The long options the user typed (``--opt`` and ``--opt=value``
    both count)."""
    return {a.split("=", 1)[0] for a in argv if a.startswith("--")}


def _tune_workload(args, ttune):
    """The workload the resolver prices this subcommand against."""
    if args.cmd == "cluster":
        # the coordinator's TrainTask: breast-cancer-shaped synthetic
        # two-class rows (30 features + bias) over the host TCP wire
        return ttune.Workload(
            d=31, n_rows=getattr(args, "n_rows", 0) or 0,
            n_workers=getattr(args, "workers", None)
            or ttune.defaults.CLUSTER_SLOTS,
            family="data", transport="host")
    family = {"kmeans": "kmeans", "als": "als", "pagerank": "graph",
              "closure": "graph"}.get(args.cmd, "data")
    return ttune.Workload(
        d=31, n_rows=getattr(args, "n_rows", 0) or 0,
        family=family, transport="device",
        n_shards=getattr(args, "n_slices", 0) or None)


def _apply_tune(args, argv) -> None:
    """Resolve ``--tune`` into ``args`` (``tpu_distalg/cli.py:909-956``):
    load the profile, price the workload, and set every resolved knob
    the subcommand has, but for knobs spelled out on the command line.
    Each knob prints ``tune[knob]: ...`` and emits a ``tune_knob``
    event; ``--tune auto`` with no profile of this rig keeps the table
    defaults."""
    mode = getattr(args, "tune", "off") or "off"
    if mode == "off":
        return
    import socket

    from tpu_distalg_torch import tune as ttune

    if mode == "auto":
        profile, _ = ttune.newest_profile(rig=socket.gethostname())
        if profile is None:
            print("tda --tune auto: no profile for this rig (run "
                  "'tda tune' once); table defaults stand",
                  file=sys.stderr)
            return
    else:
        try:
            profile = ttune.load_profile(mode)
        except ttune.ProfileError as e:
            raise SystemExit(f"--tune: {e}") from None
    spelled = _spelled_options(argv)
    explicit = {
        knob: getattr(args, dest)
        for knob, dest, opts in _TUNE_FLAG_KNOBS
        if hasattr(args, dest) and any(o in spelled for o in opts)}
    res = ttune.resolve(profile, _tune_workload(args, ttune),
                        explicit=explicit)
    for knob, dest, _opts in _TUNE_FLAG_KNOBS:
        if not hasattr(args, dest):
            continue
        c = res.choices[knob]
        if c.source != "resolved" or c.value is None:
            continue
        setattr(args, dest,
                res.comm_string() if knob == "comm" else c.value)
    args._tune_profile_id = res.profile_id
    ttune.emit_resolution(res)
    if not getattr(args, "quiet", False):
        for knob in ttune.KNOBS:
            c = res.choices[knob]
            print(f"tune[{knob}]: {c.value} ({c.source}) {c.why}",
                  file=sys.stderr)


def _run_tune(args) -> int:
    """``tune`` (``tpu_distalg/cli.py:958-1005``): measure the rig on
    ``--device`` and write the RigProfile artifact."""
    import time

    from tpu_distalg_torch import telemetry
    from tpu_distalg_torch import tune as ttune
    from tpu_distalg_torch.utils.device import resolve_device

    backend = resolve_device(args.device).type   # no card: raises
    collective = None
    with telemetry.span("cli:tune"):
        if args.collective:
            collective = ttune.measure_collective(_mesh(args))
        m = ttune.measure_rig(
            seed=args.seed, quick=args.quick,
            include_backend_init=not args.no_backend_init,
            collective=collective, device=backend)
        # the one wall-clock read: it orders profiles on disk and tags
        # when the rig was measured, and never steers a run
        created = time.time()  # tda: ignore[TDA001] -- artifact timestamp, not run state
        profile = ttune.build_profile(
            m, created_unix=created, seed=args.seed, backend=backend)
        path = ttune.save_profile(profile, args.out_dir)
    lb = m["loopback"]
    print(f"tune: rig={profile['rig']} backend={backend} "
          f"id={profile['profile_id']}")
    print(f"tune: loopback {lb['bandwidth_bytes_s'] / 1e6:.0f} MB/s "
          f"rtt {lb['rtt_s'] * 1e6:.0f}us | memcpy "
          f"{m['memcpy_bytes_s'] / 1e9:.1f} GB/s | matmul "
          f"{m['matmul_flops_s'] / 1e9:.1f} GFLOP/s")
    for name, rates in sorted(m["codecs"].items()):
        print(f"tune: codec {name}: encode "
              f"{rates['encode_elems_s'] / 1e6:.1f} Melem/s, decode "
              f"{rates['decode_elems_s'] / 1e6:.1f} Melem/s")
    if collective:
        print(f"tune: collective "
              f"{collective['bandwidth_bytes_s'] / 1e6:.0f} MB/s "
              f"rtt {collective['rtt_s'] * 1e6:.0f}us over "
              f"{collective['n_shards']} shards")
    if m.get("backend_init_s") is not None:
        print(f"tune: backend init {m['backend_init_s']:.1f}s")
    print(f"tune: wrote {path}")
    return 0


def _run_serving_plane(args) -> int:
    """``cluster --role replica|router`` (``tpu_distalg/cli.py:1107-
    1153``): both park until ``--deadline`` (or a kill); the ``listening
    on`` line is the launcher's handshake. A replica scores on
    ``--device``; the router is host code."""
    import time

    err = lambda m: print(m, file=sys.stderr)  # noqa: E731
    if args.role == "replica":
        from tpu_distalg_torch.cluster import serve as cserve

        if not args.artifact:
            raise SystemExit("--role replica needs --artifact CKPT_DIR")
        rep = cserve.run_replica(
            args.slot or 0, args.artifact, shard=args.shard,
            n_shards=args.replica_shards, k_top=args.k_top,
            merge=args.merge, comm=args.comm, host=args.host,
            port=args.port, logger=err, device=args.device)
        print(f"cluster_replica: listening on {args.host}:{rep.port}",
              flush=True)
        deadline = time.monotonic() + args.deadline
        try:
            while (time.monotonic() < deadline
                   and not rep._stop.is_set()):
                time.sleep(0.2)
        finally:
            rep.stop()
        return 0
    from tpu_distalg_torch.cluster.router import Router, RouterConfig

    if not args.replicas:
        raise SystemExit("--role router needs --replicas "
                         "HOST:PORT[,HOST:PORT...]")
    addrs = []
    for tok in args.replicas.split(","):
        host, _, port = tok.strip().rpartition(":")
        addrs.append((host or "127.0.0.1", int(port)))
    router = Router(RouterConfig(
        replicas=tuple(addrs), mode=args.serve_mode,
        policy=args.dispatch, comm=args.comm, port=args.port,
        wal_dir=args.wal_dir, k_top=args.k_top, merge=args.merge,
        hb_interval=args.heartbeat_interval,
        hb_timeout=args.heartbeat_timeout,
        rpc_deadline=args.rpc_deadline), logger=err).start()
    print(f"cluster_router: listening on {args.host}:{router.port}",
          flush=True)
    deadline = time.monotonic() + args.deadline
    try:
        while time.monotonic() < deadline and not router._stop.is_set():
            time.sleep(0.2)
        router.emit_gauges()
    finally:
        router.stop()
    return 0


def _run_cluster(args) -> int:
    """``cluster`` (``tpu_distalg/cli.py:1008-1106``): the multi-process
    elastic runtime, printing the JAX CLI's ``cluster_worker:``,
    ``cluster_coordinator:`` and ``cluster_result:`` lines. Workers run
    on ``--device``; the coordinator holds the center on the host."""
    import json
    import time

    from tpu_distalg_torch import cluster as clus
    from tpu_distalg_torch.parallel import ssp as pssp

    if args.role in ("replica", "router"):
        return _run_serving_plane(args)
    if args.max_restarts:
        raise SystemExit(
            "--max-restarts: the cluster recovers through its launcher "
            "(respawns, the coordinator's WAL), not by re-running the "
            "command")
    spec = pssp.SyncSpec.parse(args.sync)
    if not spec.is_ssp:
        raise SystemExit(
            "the cluster runtime is stale-synchronous by construction "
            "— --sync ssp[:s[:decay]] (a BSP cluster is the restart-"
            "policy baseline the bench measures, not a mode)")
    err = lambda m: print(m, file=sys.stderr)  # noqa: E731
    if args.role == "worker":
        if not args.connect:
            raise SystemExit("--role worker needs --connect HOST:PORT")
        host, _, port = args.connect.rpartition(":")
        stats = clus.run_worker(
            host or "127.0.0.1", int(port), slot=args.slot,
            rejoin=args.rejoin, admit_at=args.admit_at, logger=err,
            device=args.device)
        print("cluster_worker: " + json.dumps(
            {k: v for k, v in stats.items() if not isinstance(v, list)}))
        return 0
    plan = args.fault_plan or os.environ.get("TDA_FAULT_PLAN") or None
    train = (clus.TrainTask(**json.loads(args.train_json))
             if args.train_json
             else clus.TrainTask(algo=args.algo, n_rows=args.n_rows))
    extra = {}
    if args.pull_refresh_windows is not None:
        extra["pull_refresh_windows"] = args.pull_refresh_windows
    cfg = clus.ClusterConfig(
        n_slots=args.workers, n_windows=args.n_windows,
        staleness=spec.staleness, decay=spec.decay,
        ps_shards=args.ps_shards, host=args.host, port=args.port,
        heartbeat_timeout=args.heartbeat_timeout,
        heartbeat_interval=args.heartbeat_interval,
        rpc_deadline=args.rpc_deadline,
        reconnect_grace=args.reconnect_grace,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        policy=args.policy, plan_spec=plan, comm=args.comm,
        ps_mode=args.ps_mode,
        tune_profile=getattr(args, "_tune_profile_id", None),
        train=train, **extra)
    if args.role == "coordinator":
        coord = clus.Coordinator(cfg).start()
        print(f"cluster_coordinator: listening on {cfg.host}:{coord.port}",
              flush=True)
        coord.wait(timeout=args.deadline)
        # linger briefly for the workers' byes (their stats ride them):
        # done fires at the final commit, a breath before the last
        # deferred acks and byes drain; the result snapshots after
        coord_deadline = time.monotonic() + 10.0
        while time.monotonic() < coord_deadline and any(
                st.status == "active" for st in coord.slots.values()):
            time.sleep(0.05)
        res = coord.result()
        coord.stop()
    else:
        # (main() pointed this process's telemetry at DIR/coordinator;
        # spawned workers get DIR/worker-N)
        res = clus.run_local_cluster(
            cfg, spawn=args.spawn,
            coordinator_spawn=args.coordinator_spawn,
            rejoin_after=args.rejoin_after,
            telemetry_dir=args.telemetry_dir, timeout=args.deadline,
            logger=err, device=args.device)
    # the replay acceptance compares the event digests of two runs; a
    # subprocess coordinator's result line already carries its own
    print("cluster_result: " + json.dumps({
        "accuracy": round(res["accuracy"], 6),
        "version": res["version"],
        "gen": res["gen"],
        "merges": res.get("merges", len(res.get("merge_sequence", ()))),
        "respawns": res.get("respawns", 0),
        "restarts": res.get("restarts", 0),
        "recoveries": res.get("coordinator_recoveries",
                              1 if res.get("recovered") else 0),
        "recovery_ms": res.get("recovery_ms", []),
        "wal_records_replayed": res.get("wal_records_replayed", 0),
        "event_digest": res.get("event_digest") or clus.event_digest(res),
    }, default=float))
    return 0


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.cmd == "report":
        from tpu_distalg_torch.telemetry import report

        try:
            return report.report_main(args.dir, as_json=args.json)
        except FileNotFoundError as e:
            print(f"tda report: {e}", file=sys.stderr)
            return 2
    if args.cmd in ("lint", "protocol"):
        # pure source analysis on the host: no device (--device is not
        # read), no fault plan, no heartbeat
        from tpu_distalg_torch import telemetry
        from tpu_distalg_torch.analysis import cli as lint_cli

        telemetry.configure(args.telemetry_dir)
        return (lint_cli.run_lint(args) if args.cmd == "lint"
                else lint_cli.run_protocol(args))
    if args.cmd == "tune":
        # host measurements (and, with --collective, the mesh's psum):
        # no fault plan, no heartbeat
        from tpu_distalg_torch import telemetry

        telemetry.configure(args.telemetry_dir)
        if args.emulate:
            from tpu_distalg_torch.parallel import emulate_devices

            emulate_devices(args.emulate)
        return _run_tune(args)
    if args.multihost and args.coordinator_address is None and (
            args.num_processes is not None or args.process_id is not None):
        parser.error("--num-processes/--process-id require "
                     "--coordinator-address (omit all three to auto-detect)")
    from tpu_distalg_torch import faults, telemetry

    tdir = args.telemetry_dir
    if args.cmd == "cluster" and args.role == "local" and tdir:
        # one directory a process: the coordinator's events under
        # DIR/coordinator, each spawned worker's under DIR/worker-N, so
        # 'tda report DIR' merges them with per-worker columns
        tdir = os.path.join(tdir, "coordinator")
    telemetry.configure(tdir)
    if args.cmd != "chaos":
        # the chaos harness owns the registry (it runs an undisturbed
        # reference first); elsewhere the plan is live for the run
        try:
            faults.configure(args.fault_plan)
        except (ValueError, OSError) as e:
            raise SystemExit(f"--fault-plan: {e}") from None
        try:
            _refuse_unread_plan(args)
        except SystemExit:
            faults.configure(False)
            raise
    if getattr(args, "checkpoint_dir", None):
        # SIGTERM/SIGINT: checkpoint at the next boundary, exit rc 75
        faults.preempt.install()
    # before the mesh is built (the resolver may set --mesh-shape), with
    # the raw argv so that spelled-out flags win over resolved values
    _apply_tune(args, argv if argv is not None else sys.argv[1:])
    if args.emulate:
        from tpu_distalg_torch.parallel import emulate_devices

        emulate_devices(args.emulate)
    # well above the silent phases of a healthy run (first builds of
    # the kernels, the host sorts of a large graph)
    hb = telemetry.start_heartbeat(stall_after=600.0)
    from tpu_distalg_torch.utils import profiling

    try:
        with profiling.maybe_trace(args.profile, cuda=args.device == "cuda",
                                   name=f"cli:{args.cmd}"):
            with telemetry.span(f"cli:{args.cmd}"):
                return _run(args)
    except faults.Preempted as e:
        # the boundary checkpoint is on disk: the same command resumes
        print(f"[preempted] checkpoint saved at step {e.step}; re-run the "
              f"same command to resume (rc={faults.PREEMPTED_RC})",
              file=sys.stderr)
        return faults.PREEMPTED_RC
    finally:
        if hb is not None:
            hb.stop()


def _run(args) -> int:
    """The run, in a process group under ``--multihost``."""
    if not args.multihost:
        return _dispatch(args)
    from tpu_distalg_torch.parallel import mesh as pmesh

    pmesh.multihost_initialize(args.coordinator_address,
                               args.num_processes, args.process_id,
                               device=args.device)
    try:
        return _dispatch(args)
    finally:
        # a rank that raises leaves the group, so the others' pending
        # collectives fail instead of waiting out their timeout
        pmesh.shutdown()


def _run_serve(args) -> None:
    """``serve``: load the artifacts and drive each model closed-loop
    (the leader; a follower runs the batches the leader sends)."""
    from tpu_distalg_torch import serve
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.parallel.mesh import process_count

    # one data shard a process at least: the queries are replicated
    # over the data axis, the item factors split over the model axis
    mesh = get_mesh(data=args.n_slices or process_count(),
                    model=args.model_slices, device=args.device)
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
        if not server.leader:
            n = server.follow()
            print(f"[serve] follower {mesh.process_index}: ran {n} "
                  f"batch(es) the leader sent")
            return
        _drive_serve(server, args)
    except BaseException:
        server.close(abort=True)
        raise
    server.close()


def _drive_serve(server, args) -> None:
    """The leader's closed-loop load over every served model, and the
    serving lines."""
    import numpy as np

    from tpu_distalg_torch import serve

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
    if server.broken is not None:
        raise SystemExit(f"[serve] the serving group was lost: "
                         f"{server.broken}")


if __name__ == "__main__":
    sys.exit(main())
