"""Drive the PyTorch/CUDA port (``tpu_distalg_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines and its time; any failure raises
and the script exits non-zero without printing a result:

  1. device: the card's name, and its power limit from nvidia-smi;
  2. build: nvcc builds every kernel library of the ported paths from
     ``csrc/``, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card —
     exact integer cases bitwise, random cases within a stated
     tolerance — and its time at the main path's shape beside the plain
     version's, a library call's and the card's bound;
  4. ALS: the card against the CPU at a small size, then the serving
     path's training at full width (4096 users × 16384 items, rank 64);
  5. serve: the trained artifact loaded into the micro-batching server
     and 2048 requests answered through the top-k kernel, each checked
     against the plain version;
 5b. sharded ALS: the same fit on an emulated 2×4 data × model mesh (V
     over the model axis; U·Vᵀ against phase 4's), straight and resumed
     after its first segment of 2 sweeps (bitwise equal), its artifact
     served over 4 model slices with the sparse merge (B9 four times a
     micro-batch) and the dense one (no B9), every reply against the
     plain version, sparse replies bitwise equal to unsharded ones and
     phase 5's; a micro-batch's device time and B9 at the slice's shape;
  6. SSGD: logistic regression at bench.py's geometry (1,048,576 rows ×
     125 features + bias, 8192-row blocks, 1500 steps) through
     ``ssgd.prepare_fused``/``make_train_fn``: ``fused_train`` (kernel
     B2), ``fused_gather`` (B1), ``bernoulli`` with ``use_pallas`` (B6)
     and ``fused`` (B5, which passes over all rows and draws its mask
     in the kernel), then the breast-cancer reference task on the fused
     samplers; B1, its library line and B2 are timed over the trainer's
     own draws in turn (cold rows; B1's device and wall time apart), and
     B1's and B2's SASS must hold bulk copies (UBLKCP, ``cuobjdump``);
  7. PageRank at bench.py's geometry (1,000,000 vertices, Erdős–Rényi of
     average degree 8: 7,999,981 edges): kernels B7 and B8 against their
     plain versions on small cases (exact ones bitwise, a 100k-edge hub
     row, empty rows, misaligned shard slices, E = 0, rows across and
     longer than a tile) and at the main shape and on a skewed graph
     (zipf in-degrees), timed beside the plain version, the library
     call, the bound and the gather ceiling; their SASS must hold
     128-bit global loads; ``models.pagerank.run``
     in standard mode for 50 iterations (B7), its ranks against the CPU
     port's after 10, bitwise replay; the ``pallas`` (B8) and ``xla``
     (library) sweeps; reference mode on the toy graph against the
     recorded golden;
  8. k-means at bench.py's geometry (10,000,000 points × 16 dims, k = 8,
     a Gaussian mixture synthesized on the card): kernel B10 against its
     plain version on small cases (exact ones bitwise, duplicate
     centres, an empty cluster, masked rows, every row width) and at the
     main shape, timed beside the plain version, the library line and
     the bound; 50 Lloyd iterations through ``make_fit_fn_fused`` (B10)
     and through ``make_fit_fn`` (torch ops, the A/B line), every
     mixture mean recovered, bitwise replay, the card against the CPU
     port; then ``fit`` → artifact → ``Server`` → replies;
  9. SSGD's tensor-parallel split (``feature_sharded``, kernels B3 and
     B4): ``fused_gather`` on phase 6's data on a 1×1 and an emulated 1×2
     mesh, against phase 6's one-pass run (B1), with bitwise replay and a
     segmented run; at bench.py's mesh2d width (65,536 rows × 8192
     features, every block sampled) on an emulated 2×2 mesh against a
     2×1 one; breast cancer through the CLI's ``--mesh-shape 2x4`` on the
     card and on the CPU; B3 and B4 timed at both shapes;
 10. attention at bench.py's geometry (8 heads, head dim 128, bf16,
     causal; ``parallel/ring.py``, kernels B11 and B12): both kernels
     against their plain versions on small cases (causal and not, GQA,
     dead, full and crossing tiles, carry-in, a 136-row tail, head dim
     256, the 384/256 halving, float32 and bf16; exact ones bitwise,
     replays bitwise); at 32k tokens one hop the flash forward beside
     the torch-op path at kv_chunk 2048 (within the bf16 band) and the
     forward + backward through the ``autograd.Function``; an emulated
     4-shard ring, contiguous and zigzag, forward and gradients against
     the one hop; 128k tokens one hop, forward and forward + backward;
     B11 and B12 at the 32k shape timed beside their plain versions,
     SDPA and the bound;
 11. the local-update family (``models/local_sgd.py``): MA, BMUF and
     EASGD on phase 6's packed rows at bench.py's MA geometry (300
     rounds × 5 local steps, bench.py:2234-2295) on 1 and 4 emulated
     replicas, ``fused_train`` (B2, R launches a round) and
     ``fused_gather`` (B1, R·L); MA timed (wall, device, idle share,
     device time by op); each launch count checked; the card against
     the CPU port after 5 rounds on 4 replicas; ``fused_train`` against
     ``fused_gather``; the breast-cancer task as bench.py runs it, held
     by the tail of each run;
 12. the rest of the reference's workloads and SSGD's scale path:
     Monte Carlo at 2³⁰ darts on one shard (π within 5σ, the first
     chunks' hits equal to the CPU port's); the transitive closure at
     bench.py's geometry (the V = 120 DAG dense and auto-sized sparse
     against each other and the CPU port; the V = 6200 DAG through
     ``run_sparse_auto`` pinned to the host DP's count, >= 10⁷ paths,
     with paths/s and the device's idle share; the dense fixpoint on an
     Erdős–Rényi graph of 4096 vertices against the sparse one, its
     product in bf16 against float32); the ``fixed`` sampler on phase
     6's float32 rows and on breast cancer over 8 emulated shards; the
     100M-row path as bench.py's ``_bench_ssgd_scale`` runs it (rows
     made on the card, 500 ``fused_gather`` steps through B1 on an X2
     past 2³¹ elements, held-out accuracy, host RSS, B1 at that shape);
 13. the sync layer (``parallel/comms.py``, ``ssp.py``, ``membership.py``)
     on 4 emulated data shards: SSGD ``fused_gather`` (B1) at phase 6's
     geometry for 250 steps (depth cut: PERF.md §4) under dense,
     bucketed, hier, bf16, int8, int8@seq and topk:0.01 (steps/s, wall
     and device µs and device ops a step, the sync's own device µs,
     ring-model wire bytes; B1 = 4 × 250; every run replayed bitwise, int8@seq = int8, the card's
     reduce = the CPU port's bitwise, 5 steps against the CPU port);
     ``fused`` (B5) under int8 and topk; bench.py's comparison task
     (every schedule, the 3× and 4× wire cuts, the calibrated band);
     its comm-bound geometry (d 2²⁰); its SSP straggler bench (ssp:8,
     BSP and SSP arms under the seeded plan) and equal-loss steps;
     ssp:8 on ``fused_gather`` at full width under the plan (replayed
     bitwise) and under a leave plan (membership epochs); MA at
     bench.py's MA geometry on 4 replicas under int8 and topk (B2 = 4 ×
     300, B1 = 4 × 1500); the reference task under the schedules and
     MA under ssp:4, held by the tail's best;
 14. the out-of-core data subsystem (``tpu_distalg_torch/data/``) at
     bench.py's row widths, depths cut (PERF.md §4): streamed SSGD from a
     2²⁴-row disk cache (125 features + bias, pack 16, bf16, 2048-row
     blocks) through the pinned prefetch pipeline and B1, at 4 and 64
     sampled blocks a step (steps/s, H2D bytes, achieved GB/s beside a
     pinned ``copy_`` of the same size, serial ``stage`` GB/s, host
     gather GB/s, idle share, held-out accuracy beside the teacher's
     ceiling; B1 on a staged batch against its plain version), 100
     streamed steps = resident ``fused_gather`` on the same bytes bit
     for bit on 1 and 4 shards, segmented = straight; virtual SSGD at
     10⁹ logical rows (two runs bit for bit, host RSS growth under
     1 GB); minibatch k-means on a streamed mixture of 2²⁴ points
     (every true mean recovered, centres bit for bit across streamed,
     virtual and resident); streamed ALS on a 16384² rank-64 R (one
     sweep and one rmse pass, U, V and rmse bit for bit across the
     backends); the caches are made under ``build/``; phase 16 runs
     next and reads the streamed SSGD and k-means ones, then they are
     deleted;
 15. the out-of-core graph engine (``tpu_distalg_torch/graphs/``) at
     bench.py's ``pagerank_100m`` geometry with V cut to 2²³ (PERF.md
     §4), run after phase 16: a power-law edge-block cache made under
     ``build/`` through the C++ ingest's binding (asserted: no numpy
     fallback), one warm-up and two timed streamed sweeps (sweeps/s,
     ns/edge, the combine's wire bytes beside the dense ring's, H2D and
     host gather GB/s, idle share over 300 staged batches; B7 = staged
     batches × shards a sweep), B7 on the hub batch against its plain
     version and a float64 sum, timed beside cuSPARSE and the bound; at
     V 2²⁰ on 1 and 4 shards streamed = virtual = resident = a replay
     bit for bit, segmented = straight, the other combine and
     ``models.pagerank``'s CSR sweep within tolerance; phase 7 also
     times the resident prep through the binding and its numpy forms;
 16. the data axis across processes (``torch.distributed``,
     ``tpu_distalg_torch/tools/multiproc_run.py``): two ranks on the
     card over gloo (NCCL refuses two ranks on one GPU), each holding
     one of 2 global data shards, run SSGD ``fused_gather`` (B1) and
     ``fused`` (B5) at phase 6's geometry for 500 steps, MA on
     ``fused_train`` (B2) and ``fused_gather`` (B1) at phase 11's for 100
     rounds, the tp split on a 2×2 mesh (B3, B4), k-means at 10M × 16,
     k 8 (B10) and PageRank at 1M × 8M in ``auto`` (B7) and ``pallas``
     (B8) for 20 iterations (depths cut: PERF.md §4); each rank's launches are its shards × the steps; every
     result equals one process × 2 shards on the card bit for bit, and
     a world-1 NCCL group's ``fused_gather`` too; steps/s beside the one
     process's, the collectives' count and bytes, the host copies' share
     of the wall time and the idle share. Then the sync layer across the
     pair at phase 13's geometry (4 global shards, 2 a rank):
     ``fused_gather`` (B1) under each of phase 13's schedules for 100
     steps, each rank's bytes equal to the schedule's closed form
     (``comms.process_bytes``) and below ``dense``'s, MA ``fused_train``
     (B2) under int8 and topk for 20 rounds, ``fused_gather`` under
     ``ssp:8`` with the straggle plan and the leave plan for 104 ticks,
     bench.py's SSP straggler bench (its BSP arm and ``ssp:8``; the
     speedup a rank beside one process's), and a topk run checkpointed
     by the pair at step 50 and resumed by one process to 100; each
     equal to one process × 4 shards bit for bit (the resumed run to
     the straight one), and a world-1 NCCL group's ``hier`` too. Then
     the workloads that cross processes last (``multiproc_run``'s
     ``A9_WORKLOADS``, depth cut, PERF.md §4), on the pair, one process
     and the world-1 NCCL group, every result bitwise: ALS 4096 × 16384
     rank 64 on a 2×2 mesh for 3 sweeps (a checkpoint resumed = the
     straight fit), its serving over 2048 requests at max-batch 32,
     sparse from the training result through the reshard seam (B9 a
     model slice a batch) and dense from the artifact, process 0
     leading and process 1 following; the closure of bench.py's DAG at
     V 6800 (10,316,480 paths, asserted) dense and ``run_sparse_auto``;
     streamed SSGD (B1) and minibatch k-means for 30 steps on phase
     14's caches; streamed PageRank (B7) for 5 sweeps on a 2-shard
     power-law cache at V 2²¹; ring attention at 32k × 8 heads × d 128
     bf16, causal, contiguous and zigzag, and Ulysses, forward and the
     gradients (B11, B12); each rank launches B1, B7, B9, B11 and B12
     (asserted);
 17. recovery on the card (``run_recovery``): (a) ``fused_gather`` (B1)
     at phase 6's geometry, 1500 steps in segments of 250, straight, in
     undisturbed segments and under a plan that corrupts a save, kills a
     segment and fails a write, with ``run_with_restarts``: w and the
     accuracies bitwise equal, B1's launches the undisturbed run's plus
     the replayed segment's, the recovery's seconds; (b) at the same
     geometry, a SIGTERM to this process after the first checkpoint
     stops the run at a boundary (``Preempted``, rc 75), and the resumed
     run's final checkpoint equals (a)'s undisturbed segmented run's bit
     for bit, B1 launched 1500 times over the two; a command-line
     ``ssgd --checkpoint-dir`` child on the reference task sent SIGTERM
     after its first checkpoint exits 75, and its re-run's final
     checkpoint equals an undisturbed run's bit for bit; (c) phase 4's artifact served
     through B9 under a torn first read and a 10% batch loss, the
     replies bitwise an undisturbed server's, failed batches and one
     re-read counted, p99 beside the undisturbed one; (d) the chaos
     harness's eight workloads on the card, each equal and firing what
     the CPU fires (B7 launched by ``pagerank_stream``); (e)
     ``init_backend`` under a hang past its deadline returns the card;
 18. the profiler entry point and the cluster runtime
     (``run_cluster``): (a) a command-line child ``ssgd --sampler
     fused_gather --profile DIR`` on breast cancer (300 steps): its
     Chrome trace holds B1's kernel exactly as often as the same command
     launches B1 in this process, and B1's device µs a step; (b)
     bench.py's elastic-against-restart pair (3 thread workers on the
     card, 24 windows × s 4, 4096 + 1024 rows × 30 + bias, int8:5, a
     checkpoint every 8, ``seed=7;cluster:worker@37=kill``): walls,
     ratio, accuracies, respawns and restarts, each arm's event digest
     equal to the CPU port's; (c) the median push → commit → pull on a
     one-worker cluster; (d) ``tda cluster --role local --spawn process
     --coordinator-spawn process`` with process workers on the card
     under ``seed=11;cluster:coordinator@12=kill``: the final center
     bitwise the undisturbed run's, recovery ms and WAL records
     replayed; (e) bench.py's wire bench (d 8192, dense against int8:5):
     frame bytes and their ratio, both accuracies in the chaos band;
     (f) the chaos workload ``cluster`` equal, firing what the CPU
     fires;
 19. the autotuner, the sharded row store and cluster serving
     (``run_tune_rowstore_serving``): (a) ``tda tune`` on the card, then
     ``--collective`` over 4 emulated data shards (both profiles load,
     ``backend: cuda``, the backend init measured); (b) (a)'s profile
     resolved for bench.py's run_tuned_step_speedup geometry (ratio 1.0
     with ``identical_geometry`` where it keeps dense, a failure where a
     resolved schedule runs slower), the collective profile's
     resolution timed as a finding, and ``ssgd --tune`` (fused_gather,
     breast cancer, 300 steps) bitwise the run with its knobs spelled
     out, B1 = 300 × 4; (c) ``--ps-mode rowstore`` with 3 thread workers
     on the card at phase 18's geometry, dense and int8:5, the center
     bitwise the replicated one; ``run_cluster_pagerank`` at bench.py's
     rowstore geometry (V 8192, 4 shards, in-degree 8, 512-edge blocks)
     and at V 2²⁰ (in-degree 16, 65,536-edge blocks), 8 iterations: B7 =
     iterations × blocks, the ranks within 1e-6 of the engine at one
     block a step, Σ within 1e-4 of 1, a ``cluster:ps`` kill replayed
     from the WAL bitwise; ``fit_rowstore`` at JAX's test geometry and
     at 4096 × 16384 rank 64 (2 sweeps) under a row budget; (d)
     bench.py's cluster serve bench (3 k-means replicas on the card, 384
     requests, a seeded replica kill: replies bitwise), phase 4's
     artifact over 1 and 4 shard replicas, sparse and dense (merged =
     one replica bitwise; B9 = micro-batches + a warm-up a replica on
     sparse, none on dense), and two process replicas with a kill;
 20. the kernels line (B1's and B2's entries with their launches on the
     local-update runs, B1's on the scale path, phase 14's streamed
     runs and phase 18's profiled command line, B1's, B2's and B5's on
     phase 13's paths, B7's on phase 15's streamed sweeps and a hub
     batch, B9's on the sharded path and at the slice's shape, each
     kernel's launches a rank in phase 16, and phase 19's of B1, B7 and
     B9), then the last line
     ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Every path is driven with all launch counters set to 0 just before it
and read just after it (the serving path: phase 4's full-width fit and
phase 5; each of phase 5b's served runs; each SSGD path, each PageRank
sweep, each k-means fit, each tp mesh, each attention run, each
local-update run, each of phase 12's paths on its own, each of phase
13's runs, each of phase 14's runs, each of phase 15's sweeps, in
each of phase 16's processes, each workload, phase 18's profiled
command line, and each of phase 19's tuned runs, fleets and sweeps), so
the kernels line shows that each path went through its kernel, and that the kernel-free paths
(phase 5b's dense merge, phase 12's Monte Carlo, closure and ``fixed``,
phase 14's virtual SSGD, minibatch k-means and streamed ALS) launched
none.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
#: the serving geometry: users × items, rank, k, micro-batch, load
USERS, ITEMS, RANK, K_TOP, MAX_BATCH = 4096, 16384, 64, 10, 32
REQUESTS, CONCURRENCY, SWEEPS = 2048, 8, 5
#: H100 SXM data-sheet peaks: HBM bytes/s, float32 FLOP/s off the
#: tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _time_ms(fn, n: int = 200, warm: int = 10) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls (CUDA
    events around the run, after ``warm`` calls)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _topk_bound_ms(B: int, N: int, d: int, k: int) -> tuple[float, str]:
    """Least time for the top-k on this card: every input byte read
    once and every output byte written once over HBM bandwidth, against
    2·B·N·d float32 operations over the float32 peak."""
    t_bytes = (4 * (B * d + N * d) + 8 * B * k) / HBM_BYTES_PER_S
    t_ops = 2 * B * N * d / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def _int_inputs(rng, *shape):
    """Entries in {-3..3}: every dot product is exact in float32."""
    return rng.integers(-3, 4, size=shape).astype(np.float32)


def check_topk_kernel(dev) -> dict:
    """Phase 3: the fused top-k kernel against its plain version."""
    import torch

    from tpu_distalg_torch.ops import topk

    rng = np.random.default_rng(SEED)
    tied = _int_inputs(rng, 15, 48)
    poisoned = _int_inputs(rng, 200, 48)
    poisoned[150:] = 100.0
    tie_v = _int_inputs(rng, 2000, 48)
    tie_v[rng.choice(2000, 600, replace=False)] = 3.0
    tie_q = rng.integers(0, 4, size=(8, 48)).astype(np.float32)
    exact = [  # (label, Q, V, index_offset, n_valid, k, block_items)
        ("crafted ties", _int_inputs(rng, 8, 48),
         np.concatenate([tied] * 3), 0, 45, 9, None),
        ("ties across sub-tiles and blocks, 256 items a block",
         _int_inputs(rng, 8, 48), np.concatenate([tied] * 70), 0, 1050,
         9, 256),
        ("offset 1000, n_valid 150, poisoned tail",
         _int_inputs(rng, 8, 48), poisoned, 1000, 150, 7, None),
        ("fewer valid items than k", _int_inputs(rng, 8, 48),
         _int_inputs(rng, 4, 48), 0, 4, 7, None),
        ("odd geometry B=5 d=33 N=305", _int_inputs(rng, 5, 33),
         _int_inputs(rng, 305, 33), 0, 305, 7, None),
        ("k=128, B=40 (two query tiles)", _int_inputs(rng, 40, 70),
         _int_inputs(rng, 3000, 70), 5, 2900, 128, None),
        # k over 128: the lists live in device memory (ROADMAP C3)
        ("k=129, B=40", _int_inputs(rng, 40, 70),
         _int_inputs(rng, 3000, 70), 5, 2900, 129, None),
        ("k=256, 256 items a block", _int_inputs(rng, 9, 40),
         _int_inputs(rng, 1200, 40), 0, 1200, 256, 256),
        ("k=1000 past n_valid 850", _int_inputs(rng, 6, 36),
         _int_inputs(rng, 900, 36), 7, 850, 1000, None),
        # more scores tied with the k-th best than a queue holds (32
        # entries at k 10, 256 at k 100): 600 copies of the best row
        ("600 ties with the k-th best, k=10", tie_q, tie_v, 0, 2000, 10,
         None),
        ("600 ties with the k-th best, k=100", tie_q, tie_v, 0, 2000, 100,
         256),
        ("k = n_valid = 77", _int_inputs(rng, 8, 40),
         _int_inputs(rng, 300, 40), 11, 77, 77, None),
        ("k=100 above N=90", _int_inputs(rng, 6, 40),
         _int_inputs(rng, 90, 40), 0, 90, 100, None),
        ("B=1", _int_inputs(rng, 1, 64), _int_inputs(rng, 3000, 64), 0,
         3000, 10, None),
        ("B=33", _int_inputs(rng, 33, 64), _int_inputs(rng, 3000, 64), 2,
         2990, 10, 256),
    ]
    for label, Q, V, off, nv, k, block_items in exact:
        Qd = torch.as_tensor(Q, device=dev)
        Vd = torch.as_tensor(V, device=dev)
        gv, gi = topk.fused_matmul_topk(Qd, Vd, off, nv, k=k,
                                        block_items=block_items)
        torch.cuda.synchronize()
        rv, ri = topk.matmul_topk_reference(Qd, Vd, off, nv, k=k)
        torch.cuda.synchronize()
        if not (torch.equal(gv, rv) and torch.equal(gi, ri)):
            raise AssertionError(f"top-k kernel != plain version: {label}")
        print(f"[kernels] topk exact case '{label}': values and indices "
              f"equal")

    B, d, k = MAX_BATCH, RANK, K_TOP
    rec = {}
    for N in (ITEMS, 1 << 20):
        Qd = torch.as_tensor(rng.normal(size=(B, d)).astype(np.float32),
                             device=dev)
        Vd = torch.as_tensor(rng.normal(size=(N, d)).astype(np.float32),
                             device=dev)
        gv, gi = topk.fused_matmul_topk(Qd, Vd, 0, N, k=k)
        torch.cuda.synchronize()
        rv, ri = topk.matmul_topk_reference(Qd, Vd, 0, N, k=k + 1)
        torch.cuda.synchronize()
        topk.assert_topk_close(gv, gi, rv, ri, rtol=1e-5)
        err = float((gv - rv[:, :k]).abs().max())
        t = _topk_times(topk, Qd, Vd, N, k, 50)
        bound_ms, bound_by = _topk_bound_ms(B, N, d, k)
        print(f"[kernels] topk random B={B} d={d} N={N} k={k}: within the "
              f"tie-tolerance rule (rtol 1e-5), max |err| {err!r}; "
              f"kernel device {t['ms']!r} ms a call (CUPTI), wall "
              f"{t['wall_ms']!r} ms a call back to back, "
              f"{t['launches_per_call']} launch(es) a call; plain "
              f"{t['plain_ms']!r} ms; torch.matmul+torch.topk device "
              f"{t['library_ms']!r} ms, wall {t['library_wall_ms']!r} ms; "
              f"bound {bound_ms!r} ms ({bound_by}); V warm in L2 where it "
              f"fits (50 MB), as while serving")
        key = "" if N == ITEMS else "n1m_"   # the main path's shape first
        rec.update({f"{key}{n}": v for n, v in t.items()})
        rec.update({f"{key}bound_ms": bound_ms, f"{key}bound_by": bound_by,
                    f"{key}max_abs_err": err})
        del Qd, Vd
    # the main path's shape at k over 128
    Qd = torch.as_tensor(rng.normal(size=(B, d)).astype(np.float32),
                         device=dev)
    Vd = torch.as_tensor(rng.normal(size=(ITEMS, d)).astype(np.float32),
                         device=dev)
    for kl in (256, 1000):
        gv, gi = topk.fused_matmul_topk(Qd, Vd, 0, ITEMS, k=kl)
        torch.cuda.synchronize()
        rv, ri = topk.matmul_topk_reference(Qd, Vd, 0, ITEMS, k=kl + 1)
        topk.assert_topk_close(gv, gi, rv, ri, rtol=1e-5)
        t = _topk_times(topk, Qd, Vd, ITEMS, kl, 20)
        bound_ms, bound_by = _topk_bound_ms(B, ITEMS, d, kl)
        print(f"[kernels] topk random B={B} d={d} N={ITEMS} k={kl}: within "
              f"the tie-tolerance rule; kernel device {t['ms']!r} ms, wall "
              f"{t['wall_ms']!r} ms, {t['launches_per_call']} launch(es) a call; "
              f"plain {t['plain_ms']!r} ms; torch.matmul+torch.topk device "
              f"{t['library_ms']!r} ms, wall {t['library_wall_ms']!r} ms; "
              f"bound {bound_ms!r} ms ({bound_by})")
        rec.update({f"k{kl}_{n}": v for n, v in t.items()})
        rec[f"k{kl}_bound_ms"] = bound_ms
    rec["sass"] = topk_sass()
    return rec


def _topk_times(topk, Qd, Vd, N: int, k: int, calls: int) -> dict:
    """B9 and its library line on the same inputs: device ms a call
    (CUPTI, ``tools/topk_profile``'s method: the kernel's own time, no
    host gaps), wall ms a call back to back (host clock, ending in a
    synchronize), the kernel's launches a call, and the plain version's
    time. Raises unless B9 is one launch a call: the wrapper's counter
    over the calls, and one kernel in the profile (CUPTI may drop an
    event, so its count is not held). A trace with no device activity
    at all (CUPTI recorded nothing) is taken again, up to three times."""
    import torch

    from tpu_distalg_torch.tools.topk_profile import _profile

    for _ in range(3):
        before = topk.fused_matmul_topk.launches
        wall, act = _profile(
            lambda: topk.fused_matmul_topk(Qd, Vd, 0, N, k=k), calls)
        if act:
            break
    # _profile makes 5 warm-up calls, then the timed and the traced calls
    launches = (topk.fused_matmul_topk.launches - before) / (5 + 2 * calls)
    kernels = [name for name in act if "topk" in name]
    if launches != 1 or len(kernels) != 1:
        raise AssertionError(f"B9 at N={N} k={k}: {launches} launches a "
                             f"call and kernels {kernels}, not one")
    lib_wall, lib_act = _profile(lambda: torch.topk(Qd @ Vd.T, k, dim=1),
                                 calls)
    return {"ms": sum(t for name, (t, _) in act.items() if "topk" in name)
            / calls / 1e3,
            "wall_ms": wall, "launches_per_call": launches,
            "plain_ms": _time_ms(
                lambda: topk.matmul_topk_reference(Qd, Vd, 0, N, k=k),
                20 if k > K_TOP else 200, warm=2),
            "library_ms": sum(t for t, _ in lib_act.values()) / calls / 1e3,
            "library_wall_ms": lib_wall}


def _sass_counts(lib_name: str, keys: dict, ops: tuple) -> dict:
    """For the kernels of ``build/kernels/lib<lib_name>`` whose mangled
    names hold ``keys``' values: the count of the SASS lines that match
    each regular expression of ``ops`` (``cuobjdump -sass``) and their registers a thread and stack and
    local bytes (spills; ``cuobjdump -res-usage``)."""
    from tpu_distalg_torch.ops import _native

    tool = os.path.join(os.path.dirname(_native.find_nvcc()), "cuobjdump")
    lib = _native._lib_path(lib_name)

    def dump(flag):
        return subprocess.run([tool, flag, lib], capture_output=True,
                              text=True, timeout=120, check=True).stdout

    def which(line):
        return next((k for k, key in keys.items() if key in line), None)

    out = {k: {op: 0 for op in ops} for k in keys}
    name = None
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            name = which(line)
        elif name is not None:
            for op in ops:
                out[name][op] += re.search(op, line) is not None
    name = None
    for line in dump("-res-usage").splitlines():
        if line.strip().startswith("Function "):
            name = which(line)
        elif name is not None and "REG:" in line:
            fields = dict(f.split(":", 1) for f in line.split()
                          if ":" in f and not f.startswith("CONSTANT"))
            out[name].update(registers=int(fields["REG"]),
                             stack_bytes=int(fields["STACK"]),
                             local_bytes=int(fields["LOCAL"]))
            name = None
    return out


def topk_sass() -> dict:
    """Phase 3's build check of B9: for each of its kernels (shape A and
    shape B, 64- and 256-entry queues, 16- and 4-byte copies, lists in
    shared or, past k 1092, in device memory), the
    LDGSTS (cp.async) and UBLKCP (bulk copy) instructions in its SASS,
    its registers and spill bytes. Raises unless the main path's kernel
    (shape B, 64-entry queues, 16-byte copies) issues cp.async."""
    keys = {f"{shape}_q{q}_{'v16' if v else 'v4'}{'' if sl else '_glist'}":
            f"topk_kernelILi4ELi{ti}ELi{qg}ELi{q // 32}ELb{int(v)}ELb{int(sl)}E"
            for shape, ti, qg in (("A", 4, 8), ("B", 2, 2))
            for q in (64, 256) for v in (True, False) for sl in (True, False)
            if not (shape == "A" and q == 256) and (sl or q == 256)}
    out = _sass_counts("topk", keys, ("LDGSTS", "UBLKCP"))
    print(f"[kernels] topk SASS (LDGSTS = cp.async, UBLKCP = bulk copies; "
          f"registers a thread, stack and local bytes = spills): "
          f"{json.dumps(out)}")
    if not out["B_q64_v16"]["LDGSTS"]:
        raise AssertionError(f"B9's main kernel has no LDGSTS: {out}")
    return out


def check_als_small(dev) -> None:
    """Phase 4a: ALS on the card against the port's own CPU run."""
    from tpu_distalg_torch.models import als

    from tpu_distalg_torch.parallel import get_mesh

    cfg = als.ALSConfig(m=512, n=2048, k=16, n_iterations=3, seed=SEED)
    gpu = als.fit(get_mesh(device=dev), cfg).rmse_history.cpu().numpy()
    cpu = als.fit(get_mesh(device="cpu"), cfg).rmse_history.numpy()
    if not np.allclose(gpu, cpu, rtol=1e-4, atol=0.0):
        raise AssertionError(f"ALS card {gpu} != CPU {cpu} (rtol 1e-4)")
    print(f"[als] 512x2048 rank 16, lam {cfg.lam}: card {gpu.tolist()} == "
          f"CPU {cpu.tolist()} within rtol 1e-4")


def run_main_path(dev, workdir: str) -> dict:
    """Phases 4b and 5: train at full width, save the artifact, serve
    it. Returns what the checks after it need."""
    import torch

    from tpu_distalg_torch import serve
    from tpu_distalg_torch.models import als
    from tpu_distalg_torch.parallel import get_mesh

    cfg = als.ALSConfig(lam=0.0, m=USERS, n=ITEMS, k=RANK,
                        n_iterations=SWEEPS, seed=SEED)
    R, rms_r = _als_target()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = als.fit(get_mesh(device=dev), cfg, R, checkpoint_dir=workdir)
    hist = res.rmse_history.cpu().numpy()
    fit_s = time.perf_counter() - t0
    print(f"[als] {USERS}x{ITEMS} rank {RANK}, lam 0.0, {SWEEPS} sweeps: "
          f"rmse {hist.tolist()}; fit {fit_s!r} s including R to the card "
          f"and the artifact save ({fit_s / SWEEPS!r} s/sweep at most)")
    if not hist[-1] < 1e-3 * rms_r:
        raise AssertionError(f"final rmse {hist[-1]} not below 1e-3 x "
                             f"RMS(R) = {1e-3 * rms_r}")
    del R

    results, info, stats = _serve_closed_loop(
        get_mesh(device=dev), workdir, "sparse", SERVE_IDS)
    return {"results": results, "info": info, "stats": stats,
            "fit_s": fit_s, "U": res.U, "V": res.V}


def _als_target():
    """bench.py's full-width target (bench.py:2984-2986): exactly rank 64
    with N(0, 0.3²) factors, and its RMS. synthesize_rank_k's U[0,1)
    factors share one dominant direction at rank 64, which leaves the
    first sweep's float32 factors too ill-conditioned: the rmse then
    stalls near 8e-4 of RMS(R) (python -m
    tpu_distalg_torch.tools.als_precision)."""
    rng = np.random.default_rng(SEED)
    R = (rng.normal(0.0, 0.3, (USERS, RANK)).astype(np.float32)
         @ rng.normal(0.0, 0.3, (ITEMS, RANK)).astype(np.float32).T)
    return R, float(np.sqrt(np.mean(np.square(R, dtype=np.float64))))


#: the serving load: 2048 user ids, the same for every served run
SERVE_IDS = np.random.default_rng(SEED + 7).integers(0, USERS, size=REQUESTS)


def _serve_closed_loop(mesh, workdir: str, merge: str, ids):
    """The artifact under ``workdir`` served on ``mesh`` with ``merge``:
    ``ids`` from CONCURRENCY closed-loop clients, micro-batches of
    MAX_BATCH, a 2 ms deadline. Returns (replies, load info, stats)."""
    from tpu_distalg_torch import serve

    cfg = serve.ServeConfig(max_batch=MAX_BATCH, max_delay_ms=2.0,
                            k_top=K_TOP, merge=merge)
    server = serve.Server(mesh, cfg)
    try:
        server.add_artifact(workdir)
        results, info = serve.run_closed_loop(
            server, "als", list(ids), concurrency=CONCURRENCY)
        stats = server.emit_counters()
    finally:
        server.close()
    return results, info, stats


def check_served(dev, workdir: str, run: dict) -> None:
    """Phase 5's checks: every reply against the plain version."""
    import torch

    from tpu_distalg_torch.ops import topk
    from tpu_distalg_torch.utils import checkpoint

    info, stats = run["info"], run["stats"]
    if info["ok"] != REQUESTS or info["failed"] or \
            any(r is None for r in run["results"]):
        raise AssertionError(f"served {info['ok']}/{REQUESTS}: {info}")
    payload, _ = checkpoint.restore(workdir)
    U, V = (torch.as_tensor(x, device=dev) for x in payload["state"])
    Q = U[torch.as_tensor(SERVE_IDS, device=dev)].contiguous()
    rv, ri = topk.matmul_topk_reference(Q, V, 0, V.shape[0], k=K_TOP + 1)
    gv = np.stack([v for v, _ in run["results"]])
    gi = np.stack([i for _, i in run["results"]])
    topk.assert_topk_close(gv, gi, rv, ri, rtol=1e-5)
    print(f"[serve] {info['ok']}/{REQUESTS} replies in {stats['batches']} "
          f"micro-batches, each equal to the plain version by the "
          f"tie-tolerance rule; {info['qps']!r} req/s (closed loop, "
          f"{CONCURRENCY} workers), p50 {stats['p50_ms']!r} ms, p99 "
          f"{stats['p99_ms']!r} ms, {stats['shed']} shed")


#: phase 5b: the emulated mesh of the sharded fit, the model slices
#: serving splits V over, the resumed run's segment length, and the
#: batches the serving profile traces
FIT_MESH, SERVE_SLICES, SEGMENT, PROFILE_CALLS = (2, 4), 4, 2, 100


def _check_replies(what: str, dev, U, V, results) -> float:
    """Every served reply against the plain version on the artifact's
    factors (tie-tolerance rule, rtol 1e-5); returns the largest score
    error."""
    import torch

    from tpu_distalg_torch.ops import topk

    Q = U[torch.as_tensor(SERVE_IDS, device=dev)].contiguous()
    rv, ri = topk.matmul_topk_reference(Q, V, 0, V.shape[0], k=K_TOP + 1)
    gv = np.stack([v for v, _ in results])
    gi = np.stack([i for _, i in results])
    topk.assert_topk_close(gv, gi, rv, ri, rtol=1e-5)
    print(f"[sharded] {what}: {len(results)} replies equal to the plain "
          f"version by the tie-tolerance rule")
    return float(np.abs(gv - rv[:, :K_TOP].cpu().numpy()).max())


def _replies_equal(what: str, got, model) -> None:
    """``got`` (replies to SERVE_IDS) against ``model``'s own replies to
    the same ids, batch by batch, bitwise."""
    want = [r for j in range(0, REQUESTS, MAX_BATCH) for r in
            model.predict_batch(list(SERVE_IDS[j:j + MAX_BATCH]), MAX_BATCH)]
    for j, ((gv, gi), (wv, wi)) in enumerate(zip(got, want, strict=True)):
        if not (np.array_equal(gv, wv) and np.array_equal(gi, wi)):
            raise AssertionError(f"{what}: reply {j} differs")
    print(f"[sharded] {what}: {REQUESTS} replies equal bitwise")


def _batch_profile(model) -> dict:
    """One full micro-batch of ``model`` under the profiler: host wall
    ms a batch, device ms a batch, B9's part of it."""
    from tpu_distalg_torch.tools.topk_profile import _profile

    ids = list(SERVE_IDS[:MAX_BATCH])
    wall, act = _profile(lambda: model.predict_batch(ids, MAX_BATCH),
                         PROFILE_CALLS)
    dev_ms = sum(t for t, _ in act.values()) / PROFILE_CALLS / 1e3
    b9_ms = sum(t for name, (t, _) in act.items() if "topk" in name) \
        / PROFILE_CALLS / 1e3
    return {"wall_ms": wall, "device_ms": dev_ms, "b9_ms": b9_ms,
            "merge_share": (dev_ms - b9_ms) / dev_ms,
            "activities_a_batch": sum(n for _, n in act.values())
            / PROFILE_CALLS}


def _sweep_s(dev, mesh, cfg, R) -> float:
    """Seconds a sweep of ``als.make_fit_fn`` on ``mesh``, R and the
    factors already on the card: the best of 3 runs of
    ``cfg.n_iterations`` sweeps after one warm-up run."""
    import torch

    from tpu_distalg_torch.models import als

    R_d = torch.as_tensor(R, device=dev)
    U0 = torch.zeros((R.shape[0], cfg.k), device=dev)
    V0 = torch.as_tensor(np.random.default_rng(cfg.seed + 1).random(
        (R.shape[1], cfg.k), dtype=np.float32), device=dev)
    fn = als.make_fit_fn(mesh, cfg)
    fn(R_d, U0, V0)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(R_d, U0, V0)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best / cfg.n_iterations


def run_sharded(dev, workdir1: str, main: dict) -> dict:
    """Phase 5b: ALS on the emulated 2×4 mesh at full width (V over the
    model axis), straight and resumed after its first segment (bitwise
    equal), its artifact served over 4 model slices with the sparse and
    the dense merge (B9 four times a micro-batch on sparse, never on
    dense), sparse replies bitwise equal to unsharded ones, and the
    serving profile and B9 at the slice's shape."""
    import dataclasses

    import torch

    from tpu_distalg_torch import serve
    from tpu_distalg_torch.models import als
    from tpu_distalg_torch.ops import topk
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import checkpoint

    R, rms_r = _als_target()
    mesh = get_mesh(*FIT_MESH, device=dev)
    cfg = als.ALSConfig(lam=0.0, m=USERS, n=ITEMS, k=RANK,
                        n_iterations=SWEEPS, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    straight = als.fit(mesh, cfg, R)
    hist = straight.rmse_history.cpu().numpy()
    fit_s = time.perf_counter() - t0
    if not hist[-1] < 1e-3 * rms_r:
        raise AssertionError(f"2x4 final rmse {hist[-1]} not below 1e-3 x "
                             f"RMS(R) = {1e-3 * rms_r}")
    # each fit is within 1e-3·RMS(R) of R (asserted), so the two
    # reconstructions are within 2e-3·RMS(R) of each other
    d = (main["U"] @ main["V"].T - straight.U @ straight.V.T).double()
    recon = float(torch.sqrt(torch.mean(d * d)))
    del d
    if not recon < 2e-3 * rms_r:
        raise AssertionError(f"2x4 U·Vᵀ is {recon} (RMS) from the 1x1 "
                             f"fit's, not below 2e-3 x RMS(R)")
    print(f"[sharded] ALS on the emulated {FIT_MESH[0]}x{FIT_MESH[1]} mesh, "
          f"{USERS}x{ITEMS} rank {RANK}, lam 0.0, {SWEEPS} sweeps: rmse "
          f"{hist.tolist()}; fit {fit_s!r} s including R to the card "
          f"({fit_s / SWEEPS!r} s/sweep at most; 1x1 {main['fit_s']!r} s "
          f"with its artifact save); U·Vᵀ vs the 1x1 fit's: RMS {recon!r} "
          f"(RMS(R) {rms_r!r})")
    sweep = {shape: _sweep_s(dev, get_mesh(*shape, device=dev), cfg, R)
             for shape in ((1, 1), FIT_MESH)}
    print(f"[sharded] a sweep on the card (make_fit_fn on R already there, "
          f"best of 3 runs of {SWEEPS}): 1x1 {sweep[(1, 1)]!r} s, "
          f"{FIT_MESH[0]}x{FIT_MESH[1]} {sweep[FIT_MESH]!r} s")
    out = {"fit_s": fit_s, "rmse": hist.tolist(), "recon_rms": recon,
           "sweep_s_1x1": sweep[(1, 1)], "sweep_s": sweep[FIT_MESH]}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as workdir:
        first = als.fit(mesh, dataclasses.replace(cfg, n_iterations=SEGMENT),
                        R, checkpoint_dir=workdir, checkpoint_every=SEGMENT)
        if checkpoint.latest_step(workdir) != SEGMENT:
            raise AssertionError("the first segment left no checkpoint")
        seg = als.fit(mesh, cfg, R, checkpoint_dir=workdir,
                      checkpoint_every=SEGMENT)
        for name, a, b in (("U", straight.U, seg.U), ("V", straight.V, seg.V),
                           ("rmse", straight.rmse_history,
                            seg.rmse_history),
                           ("first segment's rmse", first.rmse_history,
                            straight.rmse_history[:SEGMENT])):
            if not torch.equal(a, b):
                raise AssertionError(f"segmented 2x4 fit != straight: {name}")
        print(f"[sharded] segmented fit (segments of {SEGMENT}, stopped "
              f"after the first and resumed) == straight bitwise: U, V, "
              f"rmse; artifact at step {checkpoint.latest_step(workdir)}")
        del R, first, seg

        mesh4 = get_mesh(1, SERVE_SLICES, device=dev)
        payload, _ = checkpoint.restore(workdir)
        U, V = (torch.as_tensor(x, device=dev) for x in payload["state"])
        for merge in ("sparse", "dense"):
            _reset_launches()
            results, info, stats = _serve_closed_loop(mesh4, workdir, merge,
                                                      SERVE_IDS)
            launches = {k: v for k, v in _launches().items() if v}
            if info["ok"] != REQUESTS or info["failed"]:
                raise AssertionError(f"{merge}: served {info['ok']}/"
                                     f"{REQUESTS}: {info}")
            want = {"topk": SERVE_SLICES * (stats["batches"] + 1)} \
                if merge == "sparse" else {}
            if launches != want:
                raise AssertionError(
                    f"{merge} on {SERVE_SLICES} slices launched {launches} "
                    f"for {stats['batches']} batches and the warm-up, not "
                    f"{want}")
            err = _check_replies(f"{merge} on {SERVE_SLICES} slices", dev, U,
                                 V, results)
            print(f"[sharded] serve {merge} on {SERVE_SLICES} model slices: "
                  f"{info['ok']}/{REQUESTS} replies in {stats['batches']} "
                  f"micro-batches, {info['qps']!r} req/s (closed loop, "
                  f"{CONCURRENCY} workers), p50 {stats['p50_ms']!r} ms, p99 "
                  f"{stats['p99_ms']!r} ms, {stats['shed']} shed; launches "
                  f"{launches}; max |err| vs plain {err!r}")
            out[merge] = {"qps": info["qps"], "p50_ms": stats["p50_ms"],
                          "p99_ms": stats["p99_ms"],
                          "batches": stats["batches"],
                          "launches": launches.get("topk", 0),
                          "max_abs_err": err, "results": results}
        _replies_equal("sparse on 4 slices vs the same artifact unsharded",
                       out["sparse"]["results"],
                       serve.load_artifact(workdir, get_mesh(device=dev)))
        _replies_equal("phase 5's replies vs its artifact on 4 slices "
                       "(sparse)", main["results"],
                       serve.load_artifact(workdir1, mesh4))
        for merge, mesh_p in (("unsharded", get_mesh(device=dev)),
                              ("sparse", mesh4), ("dense", mesh4)):
            prof = _batch_profile(serve.load_artifact(
                workdir, mesh_p, merge="dense" if merge == "dense"
                else "sparse"))
            out[merge] = {**out.get(merge, {}), **prof}
            print(f"[sharded] a micro-batch of {MAX_BATCH}, {merge} on "
                  f"{mesh_p.n_model} slice(s): host wall "
                  f"{prof['wall_ms']!r} ms, device {prof['device_ms']!r} ms "
                  f"in {prof['activities_a_batch']!r} device activities "
                  f"(CUPTI: kernels and copies), B9 {prof['b9_ms']!r} ms, "
                  f"the rest (gather, merge, copies) "
                  f"{prof['merge_share']!r} of the device time")
        local = V.shape[0] // SERVE_SLICES
        Q = U[torch.as_tensor(SERVE_IDS[:MAX_BATCH], device=dev)].contiguous()
        Vl = V[:local]
        t = _topk_times(topk, Q, Vl, local, K_TOP, 50)
        bound_ms, bound_by = _topk_bound_ms(MAX_BATCH, local, RANK, K_TOP)
        print(f"[sharded] B9 at the slice's shape B={MAX_BATCH} N={local} "
              f"d={RANK} k={K_TOP}: device {t['ms']!r} ms a call (CUPTI), "
              f"wall {t['wall_ms']!r} ms, {t['launches_per_call']} launch(es) "
              f"a call; plain {t['plain_ms']!r} ms; torch.matmul+torch.topk "
              f"device {t['library_ms']!r} ms; bound {bound_ms!r} ms "
              f"({bound_by})")
        out["slice"] = {**t, "bound_ms": bound_ms, "bound_by": bound_by}
    for merge in ("sparse", "dense"):
        del out[merge]["results"]
    return out


#: SSGD at bench.py's geometry (bench.py:90-102): rows × features (a
#: bias column is appended), rows per sampled block, steps per run,
#: steps per B2 launch
SSGD_ROWS, SSGD_FEATURES, SSGD_GBR, SSGD_STEPS, SSGD_MEGA = (
    1 << 20, 125, 8192, 1500, 125)
#: the JAX package's convergence band on the reference task
#: (tests_tpu/test_tpu_numerics.py; the reference reaches 0.929825) and
#: bench.py's convergence schedule (bench.py:2068-2089)
SSGD_BAND, REF_STEPS, REF_MEGA = 0.92, 1500, 125


def _ssgd_cases(dev):
    """Small SSGD cases: (label, kind, X2, meta, gbr, w, ids (T, n_s)).
    "exact": entries in {-2..2} and w = 0, so σ(z) = 0.5 and every sum
    is exact; "integer": w a multiple of 1/64, so every z is exact;
    "random": normal entries."""
    import torch

    from tpu_distalg_torch.ops import ssgd_kernels as tk

    rng = np.random.default_rng(SEED + 11)
    out = []
    for kind in ("exact", "integer", "random"):
        for dt, n, d, pack, gbr in (("bfloat16", 20000, 125, 16, 2048),
                                    ("float32", 398, 31, 4, 32),
                                    ("bfloat16", 5000, 600, 16, 1024),
                                    # rows over 2048 bytes (B1, B2, B5's
                                    # wide body) and B6 past d 4096 (its
                                    # two passes): d_total 1152 and 8192
                                    # bf16, 640 and 4224 float32, 4224 bf16
                                    ("bfloat16", 3000, 1150, 16, 256),
                                    ("bfloat16", 1500, 8190, 16, 256),
                                    ("float32", 1000, 638, 4, 64),
                                    ("float32", 1200, 4222, 16, 256),
                                    ("bfloat16", 1200, 4222, 16, 256)):
            X = (rng.normal(size=(n, d)) if kind == "random"
                 else rng.integers(-2, 3, size=(n, d))).astype(np.float32)
            y = rng.integers(0, 2, n).astype(np.float32)
            X2, meta = tk.pack_augmented(X, y, np.ones(n, np.float32),
                                         dtype=dt, pack=pack,
                                         block_rows=gbr, device=dev)
            w = np.zeros(meta["d_total"], np.float32)
            if kind == "integer":
                w[:d] = rng.integers(-8, 9, size=d) / 64.0
            elif kind == "random":
                w[:d] = rng.normal(size=d) * 0.1
            n_blocks = meta["n_padded"] // gbr
            ids = np.stack([rng.integers(0, n_blocks, 3)
                            for _ in range(9)]).astype(np.int32)
            out.append((f"{kind} {dt} n={n} d={d} pack={pack} gbr={gbr}",
                        kind, X2, meta, gbr, torch.as_tensor(w, device=dev),
                        torch.as_tensor(ids, device=dev)))
    return out


#: relative tolerances (of the largest entry): "integer" cases within
#: 64 float32 ulps (σ(z) may differ in its last bit and the backward
#: sum adds in another order); "random" float32 sums within 1e-5;
#: "steps_bf16": weights after several B2 steps on bf16 X, within 1e-3
#: (a residual rounded to bf16 can land one bf16 ulp, 2⁻⁸ relative,
#: apart after float32 sums in two orders, and later steps carry that);
#: "random_bf16": B5's one pass over many bf16 rows, within 1e-4 (the
#: same flip: one moves an entry by up to 2⁻⁹·|resid|·|x|, about 3e-5 of
#: the largest entry at 1500 kept rows of 600 columns, and several of the
#: kept rows can flip)
TOL = {"integer": 64 * 2.0**-23, "random": 1e-5, "steps_bf16": 1e-3,
       "random_bf16": 1e-4}


def _steps_kind(X2) -> str:
    import torch

    return "steps_bf16" if X2.dtype == torch.bfloat16 else "random"


def _assert_close(what, got, want, kind):
    """Counts and exact cases bitwise, the others within ``TOL``."""
    import torch

    if kind == "exact":
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: not bitwise equal")
        return 0.0
    rel = TOL[kind]
    err = float((got - want).abs().max())
    tol = rel * float(want.abs().max())
    if not err <= tol:
        raise AssertionError(f"{what}: max |err| {err} > {tol}")
    return err


def check_ssgd_kernels_small(dev) -> None:
    """Phase 3b: B6, B1 and B2 against their plain versions on small
    cases (odd widths, repeated block ids, the EASGD pull, skip_update),
    and a fixed input replaying bitwise."""
    import torch

    from tpu_distalg_torch.ops import ssgd_kernels as tk

    for label, kind, X2, meta, gbr, w, ids in _ssgd_cases(dev):
        kw = dict(pack=meta["pack"], d_total=meta["d_total"],
                  y_col=meta["y_col"], v_col=meta["v_col"],
                  gather_block_rows=gbr)
        yc, D = meta["y_col"], meta["d_total"]
        rows = X2.reshape(-1, D)
        mask = (torch.arange(rows.shape[0], device=dev) % 3 == 0).float()
        g6, c6 = tk.fused_grad_sum(rows, rows[:, yc].float().contiguous(),
                                   mask, w)
        r6, rc6 = tk.grad_sum_reference(rows, rows[:, yc].float(), mask, w)
        if float(c6) != float(rc6):
            raise AssertionError(f"B6 {label}: count {c6} != {rc6}")
        e6 = _assert_close(f"B6 {label}", g6, r6, kind)
        g1, c1 = tk.fused_grad_sum_gathered(X2, w, ids[0], **kw)
        r1, rc1 = tk.grad_sum_gathered_reference(X2, w, ids[0], **kw)
        if float(c1) != float(rc1):
            raise AssertionError(f"B1 {label}: count {c1} != {rc1}")
        e1 = _assert_close(f"B1 {label}", g1[:yc], r1[:yc], kind)
        again = tk.fused_grad_sum_gathered(X2, w, ids[0], **kw)
        if not (torch.equal(again[0], g1) and torch.equal(again[1], c1)):
            raise AssertionError(f"B1 {label}: replay differs")
        errs = []
        for alpha, skip in ((0.0, False), (0.3, False), (0.0, True)):
            ctr = w.flip(0) * (torch.arange(D, device=dev) < yc)
            wk = tk.fused_train_gathered(X2, w, ids, eta=0.1, alpha=alpha,
                                         center=ctr, skip_update=skip, **kw)
            wr = tk.train_gathered_reference(X2, w, ids, eta=0.1,
                                             alpha=alpha, center=ctr,
                                             skip_update=skip, **kw)
            # after the first update no case is exact any more
            errs.append(_assert_close(f"B2 {label} alpha={alpha} skip="
                                      f"{skip}", wk, wr, _steps_kind(X2)))
            if not torch.equal(wk, tk.fused_train_gathered(
                    X2, w, ids, eta=0.1, alpha=alpha, center=ctr,
                    skip_update=skip, **kw)):
                raise AssertionError(f"B2 {label}: replay differs")
        kw5 = dict(pack=meta["pack"], d_total=D, y_col=yc,
                   v_col=meta["v_col"], fraction=0.3, block_rows=gbr)
        g5, c5 = tk.fused_grad_sum_packed(X2, w, 42 + D, 3, **kw5)
        r5, rc5 = tk.grad_sum_packed_reference(X2, w, 42 + D, 3, **kw5)
        if float(c5) != float(rc5):
            raise AssertionError(f"B5 {label}: count {c5} != {rc5}")
        e5 = _assert_close(
            f"B5 {label}", g5[:yc], r5[:yc],
            "random_bf16" if (kind, X2.dtype) == ("random", torch.bfloat16)
            else kind)
        again = tk.fused_grad_sum_packed(X2, w, 42 + D, 3, **kw5)
        if not (torch.equal(again[0], g5) and torch.equal(again[1], c5)):
            raise AssertionError(f"B5 {label}: replay differs")
        print(f"[kernels] ssgd {label}: B6 count {float(c6)!r} equal, max "
              f"|err| {e6!r}; B1 count {float(c1)!r} equal, max |err| "
              f"{e1!r}, replay bitwise; B2 (9 steps; alpha 0, 0.3, "
              f"skip_update) max |err| {errs!r}, replay bitwise; B5 "
              f"(fraction 0.3) count {float(c5)!r} equal, max |err| {e5!r}, "
              f"replay bitwise")
    check_b5_kept_set(dev)


def check_b5_kept_set(dev) -> None:
    """B5's kept set, read off the gradient: row i is the unit vector
    e_i with y = 0 and w = 0, so g[i] = 0.5·m_i. It must equal the plain
    mask (threefry under the key (t, shard), the row's index as the
    counter) for every row, with no pad row kept."""
    import torch

    from tpu_distalg_torch.ops import ssgd_kernels as tk

    for dt in ("float32", "bfloat16"):
        for d in (126, 300):
            n_real = d - 7
            X2, meta = tk.pack_augmented(
                np.eye(d, dtype=np.float32)[:n_real],
                np.zeros(n_real, np.float32), np.ones(n_real, np.float32),
                dtype=dt, pack=16, block_rows=512, device=dev)
            w = torch.zeros(meta["d_total"], device=dev)
            kept = []
            for t, shard, frac in ((0, 0, 0.5), (99, 2, 0.1),
                                   (2**32 + 5, 7, 0.9)):
                g, c = tk.fused_grad_sum_packed(
                    X2, w, t, shard, pack=16, d_total=meta["d_total"],
                    y_col=meta["y_col"], v_col=meta["v_col"], fraction=frac,
                    block_rows=512)
                keep = tk.packed_keep_mask(t, shard, meta["n_padded"], frac,
                                           dev)[:n_real].to(torch.float32)
                if not (torch.equal(g[:n_real], 0.5 * keep)
                        and float(g[n_real:d].abs().max()) == 0.0
                        and float(c) == float(keep.sum())):
                    raise AssertionError(
                        f"B5 kept set != plain mask: {dt} d={d} t={t} "
                        f"shard={shard} fraction={frac}")
                kept.append(int(c))
            print(f"[kernels] ssgd B5 kept set, {dt} d={d} ({n_real} rows "
                  f"padded to {meta['n_padded']}): equal to the plain mask "
                  f"row by row at fractions 0.5, 0.1, 0.9 (kept {kept}), no "
                  f"pad row kept")


#: B3/B4 small cases: (dtype, rows, features, pack, gbr, block ids). D
#: (d_total) is 32, 72, 128, 128, 4104, 4104, 8200, 8200; every case's
#: ids take the last block, whose tail rows are padding (v = 0); the
#: ids repeat a block or hold one block (n_s = 1)
TP_SMALL = (("float32", 398, 30, 4, 32, (0, 12, 12, 3)),
            ("bfloat16", 3000, 70, 16, 512, (5,)),
            ("bfloat16", 20000, 126, 16, 2048, (9, 0, 9)),
            ("float32", 1500, 126, 4, 256, (5, 2)),
            ("bfloat16", 1000, 4102, 16, 256, (3, 1, 3)),
            ("float32", 700, 4102, 16, 128, (5,)),
            ("bfloat16", 600, 8198, 16, 128, (4, 4, 0)),
            ("float32", 600, 8198, 16, 128, (4, 2)))


def check_tp_kernels_small(dev) -> None:
    """Phase 3: B3 and B4 against their plain versions. "exact": entries
    of X in {-3..3}, integer w and residuals, so every sum is exact and
    the outputs must be equal bit for bit; "random": normal X, w and
    residuals, within ``TOL["random"]`` of the largest entry. A second
    launch must equal the first bit for bit."""
    import torch

    from tpu_distalg_torch.ops import ssgd_kernels as tk

    rng = np.random.default_rng(SEED + 13)
    for dt, n, d, pack, gbr, blocks in TP_SMALL:
        for kind in ("exact", "random"):
            X = (_int_inputs(rng, n, d) if kind == "exact"
                 else rng.normal(size=(n, d)).astype(np.float32))
            y = rng.integers(0, 2, n).astype(np.float32)
            X2, meta = tk.pack_augmented(X, y, np.ones(n, np.float32),
                                         dtype=dt, pack=pack, block_rows=gbr,
                                         device=dev)
            D = meta["d_total"]
            w = np.zeros(D, np.float32)
            w[:d] = (rng.integers(-3, 4, size=d) if kind == "exact"
                     else rng.normal(size=d) * 0.1)
            w = torch.as_tensor(w, device=dev)
            ids = torch.as_tensor(np.asarray(blocks, np.int32), device=dev)
            if max(blocks) != meta["n_padded"] // gbr - 1:
                raise AssertionError(f"B3/B4 case {n}x{d}: no padding block")
            kw = dict(pack=pack, d_total=D, y_col=meta["y_col"],
                      v_col=meta["v_col"], gather_block_rows=gbr)
            zyv = tk.fused_forward_gathered(X2, w, ids, **kw)
            zr = tk.forward_gathered_reference(X2, w, ids, **kw)
            e3 = _assert_close(f"B3 {kind} {dt} D={D}", zyv, zr, kind)
            shape = (zr.shape[0], pack)
            r = torch.as_tensor(
                (rng.integers(-3, 4, size=shape) if kind == "exact"
                 else rng.normal(size=shape)).astype(np.float32), device=dev)
            bkw = dict(pack=pack, d_total=D, gather_block_rows=gbr)
            g = tk.fused_backward_gathered(X2, r, ids, **bkw)
            gr = tk.backward_gathered_reference(X2, r, ids, **bkw)
            e4 = _assert_close(f"B4 {kind} {dt} D={D}", g, gr, kind)
            if not (torch.equal(zyv, tk.fused_forward_gathered(X2, w, ids,
                                                               **kw))
                    and torch.equal(g, tk.fused_backward_gathered(
                        X2, r, ids, **bkw))):
                raise AssertionError(f"B3/B4 {kind} {dt} D={D}: replay "
                                     f"differs")
            n_pad = int((zr[:, 2 * pack:] == 0).sum())
            print(f"[kernels] ssgd tp {kind} {dt} n={n} D={D} pack={pack} "
                  f"gbr={gbr} ids={list(blocks)} ({n_pad} padding slots): "
                  f"B3 max |err| {e3!r}, B4 max |err| {e4!r}"
                  + (" (bitwise)" if kind == "exact" else "")
                  + ", replay bitwise")


def _bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssgd_sass() -> dict:
    """Phase 6's and 9's build check: for B1's, B2's and B3's ring
    kernels at the main shape (bf16; B1 and B2 2 vectors a lane, 8 lanes
    a row; B3 4 vectors a lane, 4 lanes a row),
    the UBLKCP (bulk copy) and LDGSTS (cp.async) instructions in their
    SASS and their registers and spill bytes (``cuobjdump -sass`` and
    ``-res-usage``). Raises unless all three issue bulk copies."""
    keys = {"B1": "grad_ring_kernelI13__nv_bfloat16Li2ELi8E",
            "B2": "train_ring_kernelI13__nv_bfloat16Li2ELi8E",
            "B3": "forward_ring_kernelI13__nv_bfloat16Li4ELi4E"}
    out = _sass_counts("ssgd", keys, ("UBLKCP", "LDGSTS"))
    print(f"[kernels] ssgd SASS of B1's, B2's and B3's ring kernels at the "
          f"main shape (UBLKCP = bulk copies; registers a thread, stack and "
          f"local bytes = spills): {json.dumps(out)}")
    for k, c in out.items():
        if not c["UBLKCP"]:
            raise AssertionError(f"{k}: no UBLKCP in its SASS ({c}): not "
                                 f"on the bulk-copy ring")
    return out


def ssgd_kernel_records(dev, X_f32, y_f32, mask, w_plain, X2, meta, ids_all,
                        w_aug) -> dict:
    """Phase 3c: each SSGD kernel at the main path's shape against its
    plain version, timed beside the plain version, a library call and
    the bound. B1, its library line and B2 are timed over the trainer's
    draws in turn (``ids_all``, one row a step), so their rows come cold
    from device memory as a training step finds them."""
    import torch

    from tpu_distalg_torch.ops import ssgd_kernels as tk
    from tpu_distalg_torch.tools.ssgd_gathered_timing import (
        B1_DRAWS,
        LIB_DRAWS,
        rotating_ms,
    )

    ids1, ids_seg = ids_all[0], ids_all[:SSGD_MEGA]

    recs = {}
    n, d = X_f32.shape
    g, c = tk.fused_grad_sum(X_f32, y_f32, mask, w_plain)
    gr, cr = tk.grad_sum_reference(X_f32, y_f32, mask, w_plain)
    if float(c) != float(cr):
        raise AssertionError(f"B6 main shape: count {c} != {cr}")
    err = _assert_close("B6 main shape", g, gr, "random")

    def lib6():
        return (torch.mv(X_f32.T, (torch.sigmoid(torch.mv(X_f32, w_plain))
                                   - y_f32) * mask), mask.sum())

    bound = _bound_ms(4 * (n * d + 2 * n + d + d + 1),
                           4 * n * d + 6 * n)
    recs["B6"] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: tk.fused_grad_sum(X_f32, y_f32, mask,
                                                   w_plain), 50),
        plain_ms=_time_ms(lambda: tk.grad_sum_reference(
            X_f32, y_f32, mask, w_plain), 20),
        library_ms=_time_ms(lib6, 20),
        bound_ms=bound[0], bound_by=bound[1])

    D, yc, vc = meta["d_total"], meta["y_col"], meta["v_col"]
    kw = dict(pack=meta["pack"], d_total=D, y_col=yc, v_col=vc,
              gather_block_rows=SSGD_GBR)
    g, c = tk.fused_grad_sum_gathered(X2, w_aug, ids1, **kw)
    gr, cr = tk.grad_sum_gathered_reference(X2, w_aug, ids1, **kw)
    if float(c) != float(cr):
        raise AssertionError(f"B1 main shape: count {c} != {cr}")
    err = _assert_close("B1 main shape", g[:yc], gr[:yc], "random")
    blocks = X2.reshape(-1, SSGD_GBR, D)
    wq = w_aug.to(X2.dtype)

    def lib1(ids, w16):
        x = torch.index_select(blocks, 0, ids).reshape(-1, D)
        r = (torch.sigmoid(torch.mv(x, w16).float()) - x[:, yc].float()) \
            * x[:, vc].float()
        return torch.mv(x.T, r.to(x.dtype)).float(), x[:, vc].float().sum()

    n_s = ids1.shape[0]
    rows = n_s * SSGD_GBR
    step_bytes = rows * D * X2.element_size()
    bound = _bound_ms(step_bytes + 4 * (n_s + D + D + 1), 4 * rows * D)
    b1 = rotating_ms(lambda d: tk.fused_grad_sum_gathered(X2, w_aug, d, **kw),
                     list(ids_all[:B1_DRAWS]))
    b1_lib = rotating_ms(lambda d: lib1(d, wq),
                         list(ids_all[:LIB_DRAWS].long()))
    recs["B1"] = dict(
        max_abs_err=err, ms=b1["device_ms"], wall_ms=b1["wall_ms"],
        gapless=b1["gapless"] and b1_lib["gapless"],
        plain_ms=_time_ms(lambda: tk.grad_sum_gathered_reference(
            X2, w_aug, ids1, **kw), 50),
        library_ms=b1_lib["device_ms"], library_wall_ms=b1_lib["wall_ms"],
        bound_ms=bound[0], bound_by=bound[1])

    T = ids_seg.shape[0]
    eta = 0.1
    wk = tk.fused_train_gathered(X2, w_aug, ids_seg, eta=eta, **kw)
    wr = tk.train_gathered_reference(X2, w_aug, ids_seg, eta=eta, **kw)
    err = _assert_close(f"B2 main shape ({T} steps)", wk, wr,
                        _steps_kind(X2))
    keep = torch.arange(D, device=dev) < yc
    ids_long = ids_seg.long()

    def lib2():
        w = w_aug
        for t in range(T):
            gt, ct = lib1(ids_long[t], torch.where(keep, w, 0.0).to(X2.dtype))
            w = w - (eta / torch.clamp_min(ct, 1.0)) * torch.where(keep, gt,
                                                                   0.0)
        return w

    bound = _bound_ms(T * step_bytes + 4 * (T * n_s + 3 * D),
                           T * (4 * rows * D + 3 * D))
    segs = list(ids_all.reshape(SSGD_STEPS // T, T, n_s))
    skip_ms = rotating_ms(lambda d: tk.fused_train_gathered(
        X2, w_aug, d, eta=eta, skip_update=True, **kw), segs)["device_ms"]
    recs["B2"] = dict(
        max_abs_err=err,
        ms=rotating_ms(lambda d: tk.fused_train_gathered(
            X2, w_aug, d, eta=eta, **kw), segs)["device_ms"],
        plain_ms=_time_ms(lambda: tk.train_gathered_reference(
            X2, w_aug, ids_seg, eta=eta, **kw), 3, warm=1),
        library_ms=_time_ms(lib2, 3, warm=1),
        bound_ms=bound[0], bound_by=bound[1])
    t5, frac = 42, 0.1
    kw5 = dict(pack=meta["pack"], d_total=D, y_col=yc, v_col=vc,
               fraction=frac, block_rows=SSGD_GBR)
    g, c = tk.fused_grad_sum_packed(X2, w_aug, t5, 0, **kw5)
    gr, cr = tk.grad_sum_packed_reference(X2, w_aug, t5, 0, **kw5)
    if float(c) != float(cr):
        raise AssertionError(f"B5 main shape: count {c} != {cr}")
    err = _assert_close("B5 main shape", g[:yc], gr[:yc],
                        "random_bf16" if X2.dtype == torch.bfloat16
                        else "random")
    rows_all = X2.reshape(-1, D)
    keep16 = tk.packed_keep_mask(t5, 0, rows_all.shape[0], frac,
                                 dev).to(X2.dtype)

    def lib5():
        m = rows_all[:, vc] * keep16
        r = (torch.sigmoid(torch.mv(rows_all, wq).float())
             - rows_all[:, yc].float()) * m.float()
        return torch.mv(rows_all.T, r.to(X2.dtype)).float(), m.float().sum()

    all_bytes = X2.numel() * X2.element_size()
    bound = _bound_ms(all_bytes + 4 * (D + D + 1), 4 * rows_all.shape[0] * D)
    recs["B5"] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: tk.fused_grad_sum_packed(
            X2, w_aug, t5, 0, **kw5), 100),
        plain_ms=_time_ms(lambda: tk.grad_sum_packed_reference(
            X2, w_aug, t5, 0, **kw5), 10, warm=2),
        library_ms=_time_ms(lib5, 20),
        bound_ms=bound[0], bound_by=bound[1])
    r = recs["B1"]
    print(f"[kernels] ssgd B1 over the trainer's first {B1_DRAWS} draws in "
          f"turn (cold rows): device {r['ms']!r} ms a call (calls queued "
          f"behind a sleeping kernel: no host gaps), wall {r['wall_ms']!r} "
          f"ms a call back to back; library line over {LIB_DRAWS} draws: "
          f"device {r['library_ms']!r} ms, wall {r['library_wall_ms']!r} "
          f"ms; every call queued before the sleep ended: {r['gapless']}")
    for name, shape in (("B6", f"X ({n}, {d}) float32"),
                        ("B5", f"all {rows_all.shape[0]} rows, D={D} "
                               f"{X2.dtype}, fraction {frac}; kept "
                               f"{float(c)!r}"),
                        ("B1", f"{n_s} blocks of {SSGD_GBR} rows, D={D} "
                               f"{X2.dtype}"),
                        ("B2", f"{T} steps × {n_s} blocks of {SSGD_GBR} "
                               f"rows, D={D} {X2.dtype}")):
        r = recs[name]
        print(f"[kernels] ssgd {name} main shape ({shape}): max |err| "
              f"{r['max_abs_err']!r} vs plain; kernel {r['ms']!r} ms, plain "
              f"{r['plain_ms']!r} ms, library {r['library_ms']!r} ms, bound "
              f"{r['bound_ms']!r} ms ({r['bound_by']})")
    print(f"[kernels] ssgd B2 skip_update (gradient passes only, no grid "
          f"barrier, no fold, no update), over the 12 segments of the "
          f"trainer's draws in turn: {skip_ms!r} ms per {T} steps; the "
          f"update chain costs {(recs['B2']['ms'] - skip_ms) / T * 1e3!r} "
          f"µs per step")
    recs["B2"]["skip_update_ms"] = skip_ms
    sass = ssgd_sass()
    for key in ("B1", "B2"):
        recs[key]["sass"] = sass[key]
    recs["B3_sass"] = sass["B3"]   # phase 9's kernel, built in this library
    return recs


def _kernel_wrappers():
    from tpu_distalg_torch.ops import (
        attention_kernels,
        kmeans_kernels,
        pagerank_kernels,
        ssgd_kernels,
    )

    return (ssgd_kernels.KERNELS + pagerank_kernels.KERNELS
            + kmeans_kernels.KERNELS + attention_kernels.KERNELS)


def _reset_launches():
    from tpu_distalg_torch.ops import topk

    topk.fused_matmul_topk.launches = 0
    for k in _kernel_wrappers():
        k.launches = 0


def _launches() -> dict:
    from tpu_distalg_torch.ops import topk

    return {"topk": topk.fused_matmul_topk.launches,
            **{k.__name__: k.launches for k in _kernel_wrappers()}}


#: steps at the end of a `fused` run over which its accuracy is read
FUSED_TAIL = 200


def _check_fused_band(card, cpu) -> None:
    """The `fused` sampler on the reference task. Evaluated every step
    on the unnormalised features, the accuracy swings between about 0.45
    and 0.953 to the last step (a third of the late steps are at or
    above 0.92), and the card and the CPU round their sums differently,
    so they stand at different points of the swing at step 1500: the
    last step's accuracy is reported, not asserted. Asserted: each run
    reaches the band within its last ``FUSED_TAIL`` steps, and the
    card's mean accuracy over them is within 0.02 of the CPU's (0.871
    to 0.881 across seeds on the CPU)."""
    t_card, t_cpu = card[-FUSED_TAIL:], cpu[-FUSED_TAIL:]
    if not (t_card.max() >= SSGD_BAND and t_cpu.max() >= SSGD_BAND
            and abs(float(t_card.mean()) - float(t_cpu.mean())) <= 0.02):
        raise AssertionError(
            f"fused: last {FUSED_TAIL} steps: card best {t_card.max()}, "
            f"mean {t_card.mean()}; CPU best {t_cpu.max()}, mean "
            f"{t_cpu.mean()} (want both best >= {SSGD_BAND}, means within "
            f"0.02)")
    print(f"[ssgd] breast cancer, fused, last {FUSED_TAIL} of {len(card)} "
          f"steps: card best {float(t_card.max())!r}, mean "
          f"{float(t_card.mean())!r}, share >= {SSGD_BAND} "
          f"{float((t_card >= SSGD_BAND).mean())!r}; CPU best "
          f"{float(t_cpu.max())!r}, mean {float(t_cpu.mean())!r}, share "
          f"{float((t_cpu >= SSGD_BAND).mean())!r}")


def run_ssgd(dev) -> dict:
    """Phase 6: the SSGD paths at full width, then the reference task.
    Returns the kernel records and each path's launch counts."""
    import dataclasses

    import torch

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.ops import sampling
    from tpu_distalg_torch.parallel import get_mesh, parallelize
    from tpu_distalg_torch.tools.ssgd_gathered_timing import trainer_draws
    from tpu_distalg_torch.utils import datasets, prng

    t0 = time.perf_counter()
    mesh = get_mesh(data=1, device=dev)
    X, y = datasets.synthetic_two_class(SSGD_ROWS, SSGD_FEATURES, seed=0)
    X = datasets.add_bias_column(X)
    d = X.shape[1]
    cfg = ssgd.SSGDConfig(
        n_iterations=SSGD_STEPS, eval_test=False, x_dtype="bfloat16",
        sampler="fused_train", gather_block_rows=SSGD_GBR, shuffle_seed=0,
        init_seed=7, mega_steps=SSGD_MEGA)
    fn_train, X2, w0, meta = ssgd.prepare_fused(X, y, mesh, cfg)
    cfg_gather = dataclasses.replace(cfg, sampler="fused_gather")
    fn_gather = ssgd.make_train_fn_fused(mesh, cfg_gather, meta)
    # the same packed rows: gather_block_rows is fused_block_rows here
    fn_fused = ssgd.make_train_fn_fused(
        mesh, dataclasses.replace(cfg, sampler="fused",
                                  fused_block_rows=SSGD_GBR), meta)
    n_blocks, n_s = ssgd.fused_gather_geometry(cfg, meta, 1)
    cfg_bern = ssgd.SSGDConfig(n_iterations=SSGD_STEPS, eval_test=False,
                               use_pallas=True)
    Xs = parallelize(X, mesh)
    ys = parallelize(y, mesh)
    fn_bern = ssgd.make_train_fn(mesh, cfg_bern, Xs.n_padded)
    w0_plain = w0[:d].contiguous()
    te = (torch.zeros((1, meta["d_total"]), device=dev),
          torch.zeros((1,), device=dev))
    te_plain = (torch.zeros((1, d), device=dev), te[1])
    torch.cuda.synchronize()
    D = meta["d_total"]
    print(f"[ssgd] data: {SSGD_ROWS} rows x {d} columns; X2 {tuple(X2.shape)}"
          f" {X2.dtype} ({X2.numel() * X2.element_size()} bytes, D={D}, "
          f"{n_blocks} blocks of {SSGD_GBR} rows, {n_s} sampled per step); "
          f"X {tuple(Xs.data.shape)} float32 for bernoulli; set-up "
          f"{time.perf_counter() - t0!r} s")

    mask0 = sampling.bernoulli_mask(prng.root_key(cfg_bern.seed, dev), 0,
                                    Xs.n_padded, 0.1, Xs.mask)
    recs = ssgd_kernel_records(dev, Xs.data, ys.data, mask0, w0_plain, X2,
                               meta, trainer_draws(cfg, meta, dev), w0)

    step_bytes = {"fused_train": n_s * SSGD_GBR * D * X2.element_size(),
                  "fused_gather": n_s * SSGD_GBR * D * X2.element_size(),
                  "bernoulli": Xs.data.numel() * 4,
                  "fused": X2.numel() * X2.element_size()}
    paths = (("fused_train", lambda: fn_train(X2, None, None, *te, w0)),
             ("fused_gather", lambda: fn_gather(X2, None, None, *te, w0)),
             ("bernoulli", lambda: fn_bern(Xs.data, ys.data, Xs.mask,
                                           *te_plain, w0_plain)),
             ("fused", lambda: fn_fused(X2, None, None, *te, w0)))
    results, launches = {}, {}
    for name, run in paths:
        w_warm, _ = run()          # warm: allocator, cuBLAS, first launch
        torch.cuda.synchronize()
        _reset_launches()
        t1 = time.perf_counter()
        w, _ = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches[name] = _launches()
        if not bool(torch.isfinite(w).all()):
            raise AssertionError(f"{name}: non-finite weights")
        if name == "fused" and not torch.equal(w, w_warm):
            raise AssertionError("fused: two runs on the card differ")
        results[name] = w
        rate = SSGD_STEPS / secs
        share = step_bytes[name] * rate / HBM_BYTES_PER_S
        print(f"[ssgd] {name}: {SSGD_STEPS} steps in {secs!r} s = {rate!r} "
              f"steps/s; {step_bytes[name]} bytes/step, {share!r} of "
              f"3.35 TB/s; launches {launches[name]}")
    want = {"fused_train": ("fused_train_gathered",
                            SSGD_STEPS // SSGD_MEGA),
            "fused_gather": ("fused_grad_sum_gathered", SSGD_STEPS),
            "bernoulli": ("fused_grad_sum", SSGD_STEPS),
            "fused": ("fused_grad_sum_packed", SSGD_STEPS)}
    for name, (kernel, count) in want.items():
        if launches[name][kernel] != count:
            raise AssertionError(
                f"{name}: {kernel} launched {launches[name][kernel]} "
                f"time(s), want {count}: the path did not go through it")
    w_t, w_g = results["fused_train"], results["fused_gather"]
    diff = float((w_t - w_g).abs().max())
    if not torch.allclose(w_t, w_g, rtol=2e-2, atol=2e-2):
        raise AssertionError(f"fused_train != fused_gather: max |dw| {diff}")
    print(f"[ssgd] fused_train vs fused_gather after {SSGD_STEPS} steps "
          f"(bf16): max |dw| {diff!r} (held to rtol/atol 2e-2, as "
          f"tests/test_mega_kernel.py holds the JAX package)")
    print(f"[ssgd] fused: two runs of {SSGD_STEPS} steps on the card equal "
          f"bit for bit")

    data = datasets.breast_cancer_split()
    fused = dict(fused_pack=4, gather_block_rows=32, shuffle_seed=0)
    for cfg_ref in (
            ssgd.SSGDConfig(n_iterations=REF_STEPS, sampler="fused"),
            ssgd.SSGDConfig(n_iterations=REF_STEPS, sampler="fused_gather",
                            **fused),
            ssgd.SSGDConfig(n_iterations=REF_STEPS, sampler="fused_train",
                            mega_steps=REF_MEGA, eval_every=REF_MEGA,
                            **fused)):
        import warnings

        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="fused_gather:")
            res_card = ssgd.train(*data, mesh, cfg_ref)
            res_cpu = ssgd.train(*data, get_mesh(data=1, device="cpu"),
                                 cfg_ref)
        card, cpu = res_card.final_acc, res_cpu.final_acc
        if cfg_ref.sampler == "fused":
            _check_fused_band(res_card.accs.cpu().numpy(),
                              res_cpu.accs.numpy())
        elif not (card >= SSGD_BAND and cpu >= SSGD_BAND):
            raise AssertionError(f"{cfg_ref.sampler}: final acc card {card} "
                                 f"/ CPU {cpu} below {SSGD_BAND}")
        print(f"[ssgd] breast cancer, {cfg_ref.sampler} (bench.py's "
              f"convergence settings): final acc card {card!r}, CPU "
              f"{cpu!r}; "
              + ("reported, the band is held over the tail above"
                 if cfg_ref.sampler == "fused"
                 else f"band >= {SSGD_BAND} (reference 0.929825)"))
    return {"recs": recs, "launches": launches, "X": X, "y": y, "X2": X2,
            "meta": meta}


#: the tp split's wide geometry: bench.py's mesh2d width (bench.py:998),
#: rows scaled from its 512 a device to 65,536, every block sampled
#: (bench.py:1039-1041); steps a run and runs (the best is kept), as
#: bench.py's run_mesh2d_bench times them
TP_WIDE_ROWS, TP_WIDE_D, TP_WIDE_GBR, TP_WIDE_STEPS, TP_WIDE_REPEATS = (
    65536, 8192, 1024, 30, 3)
#: the 2×4 breast-cancer run's accuracy is read over its last steps, as
#: phase 6 reads `fused`'s (see _check_tp_cli)
TP_TAIL, TP_TAIL_MEANS = 200, 0.03


def tp_kernel_records(dev, X2m, wm, ids, meta, gbr, draws=None) -> dict:
    """B3 and B4 on one model slice at a path's shape: against their
    plain versions, timed beside them, the library yardstick (the
    sampled blocks by ``index_select``, then ``torch.mv`` in bf16) and
    the bound. With ``draws`` (the trainer's block ids, one row a step)
    B3 and its library line are timed over them in turn, so the rows
    come cold from device memory as a step finds them: device time with
    the calls queued behind a sleeping kernel, wall time apart; without,
    on ``ids`` each call."""
    import torch

    from tpu_distalg_torch.ops import ssgd_kernels as tk
    from tpu_distalg_torch.tools.ssgd_gathered_timing import (
        B1_DRAWS,
        LIB_DRAWS,
        rotating_ms,
    )

    P, D = meta["pack"], meta["d_total"]
    kw = dict(pack=P, d_total=D, y_col=meta["y_col"], v_col=meta["v_col"],
              gather_block_rows=gbr)
    bkw = dict(pack=P, d_total=D, gather_block_rows=gbr)
    zyv = tk.fused_forward_gathered(X2m, wm, ids, **kw)
    e3 = _assert_close("B3 path shape", zyv,
                       tk.forward_gathered_reference(X2m, wm, ids, **kw),
                       "random")
    z, yv, v = zyv[:, :P], zyv[:, P:2 * P], zyv[:, 2 * P:]
    resid = ((torch.sigmoid(z) - yv) * v).contiguous()
    g = tk.fused_backward_gathered(X2m, resid, ids, **bkw)
    e4 = _assert_close("B4 path shape", g[:meta["y_col"]],
                       tk.backward_gathered_reference(
                           X2m, resid, ids, **bkw)[:meta["y_col"]],
                       "random")
    blocks = X2m.reshape(-1, gbr, D)
    ids_l = ids.long()
    w16 = wm.to(X2m.dtype)
    r16 = resid.reshape(-1).to(X2m.dtype)

    def lib3():
        return torch.mv(torch.index_select(blocks, 0, ids_l).reshape(-1, D),
                        w16)

    def lib4():
        x = torch.index_select(blocks, 0, ids_l).reshape(-1, D)
        return torch.mv(x.T, r16)

    rows = ids.shape[0] * gbr
    x_bytes = rows * D * X2m.element_size()
    b3 = _bound_ms(x_bytes + 4 * (ids.shape[0] + D + 3 * rows), 2 * rows * D)
    b4 = _bound_ms(x_bytes + 4 * (ids.shape[0] + rows + D), 2 * rows * D)
    n_k = 200 if x_bytes < 1e8 else 20
    n_p = 20 if x_bytes < 1e8 else 5
    if draws is None:
        t3 = dict(ms=_time_ms(
            lambda: tk.fused_forward_gathered(X2m, wm, ids, **kw), n_k),
            library_ms=_time_ms(lib3, n_p, warm=2))
    else:
        mine = rotating_ms(
            lambda d: tk.fused_forward_gathered(X2m, wm, d, **kw),
            list(draws[:B1_DRAWS]))
        lib = rotating_ms(
            lambda d: torch.mv(torch.index_select(blocks, 0, d)
                               .reshape(-1, D), w16),
            list(draws[:LIB_DRAWS].long()))
        t3 = dict(ms=mine["device_ms"], wall_ms=mine["wall_ms"],
                  library_ms=lib["device_ms"],
                  library_wall_ms=lib["wall_ms"],
                  gapless=mine["gapless"] and lib["gapless"])
        print(f"[kernels] ssgd B3 over the trainer's first {B1_DRAWS} draws "
              f"in turn (cold rows): device {t3['ms']!r} ms a call (calls "
              f"queued behind a sleeping kernel), wall {t3['wall_ms']!r} ms "
              f"a call back to back; library line over {LIB_DRAWS} draws: "
              f"device {t3['library_ms']!r} ms, wall "
              f"{t3['library_wall_ms']!r} ms; every call queued before the "
              f"sleep ended: {t3['gapless']}")
    return {
        "B3": dict(max_abs_err=e3, **t3,
            plain_ms=_time_ms(lambda: tk.forward_gathered_reference(
                X2m, wm, ids, **kw), n_p, warm=2),
            bound_ms=b3[0], bound_by=b3[1], bytes=x_bytes),
        "B4": dict(max_abs_err=e4, ms=_time_ms(
            lambda: tk.fused_backward_gathered(X2m, resid, ids, **bkw), n_k),
            plain_ms=_time_ms(lambda: tk.backward_gathered_reference(
                X2m, resid, ids, **bkw), n_p, warm=2),
            library_ms=_time_ms(lib4, n_p, warm=2),
            bound_ms=b4[0], bound_by=b4[1], bytes=x_bytes)}


def _tp_run(name, run, steps, n_data, n_model):
    """One driven tp run with the counters set to 0 just before it: its
    weights, seconds and launches; B3 and B4 must each launch once per
    step, data shard and model slice, and B1 never."""
    import torch

    _reset_launches()
    t1 = time.perf_counter()
    w, _ = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    launches = _launches()
    want = steps * n_data * n_model
    got = (launches["fused_forward_gathered"],
           launches["fused_backward_gathered"])
    if got != (want, want) or launches["fused_grad_sum_gathered"]:
        raise AssertionError(f"{name}: B3, B4 launched {got} time(s), want "
                             f"{want} each, and B1 "
                             f"{launches['fused_grad_sum_gathered']}: the "
                             f"path did not go through the split")
    if not bool(torch.isfinite(w).all()):
        raise AssertionError(f"{name}: non-finite weights")
    return w, secs, launches


def _check_tp_cli(dev) -> None:
    """Breast cancer through the CLI's ``--mesh-shape 2x4`` on the card
    and on the CPU. Evaluated every step on the unnormalised features
    with one 32-row block a data shard, the accuracy swings to the last
    step (the JAX package ends this run at 0.906 on the CPU, the port at
    0.854), and the card and the CPU add in other orders, so they stand
    at different points of the swing: the last step is reported. Held:
    the CLI prints the library run's final accuracy; each run reaches
    the band within its last ``TP_TAIL`` steps; the card's and the CPU's
    means over them are within ``TP_TAIL_MEANS`` (the JAX package's and
    the port's CPU runs: 0.853 and 0.866)."""
    import contextlib
    import io
    import warnings

    from tpu_distalg_torch import cli
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    args = ["ssgd", "--sampler", "fused_gather", "--mesh-shape", "2x4",
            "--fused-pack", "4", "--gather-block-rows", "32",
            "--shuffle-seed", "0", "--quiet"]
    cfg = ssgd.SSGDConfig(n_iterations=REF_STEPS, sampler="fused_gather",
                          fused_pack=4, gather_block_rows=32, shuffle_seed=0,
                          feature_sharded=True)
    data = datasets.breast_cancer_split()
    tails = {}
    for where in ("cuda", "cpu"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="fused_gather:")
            if cli.main(["--device", where, *args]) != 0:
                raise AssertionError(f"cli ssgd --mesh-shape 2x4 on {where} "
                                     f"failed")
            res = ssgd.train(*data, get_mesh(2, 4, device=dev if where ==
                                             "cuda" else "cpu"), cfg)
        line = next(x for x in out.getvalue().splitlines()
                    if x.startswith("Final acc: "))
        if line != f"Final acc: {res.final_acc:.6f}":
            raise AssertionError(f"{where}: the CLI printed {line!r}, the "
                                 f"library run ends at {res.final_acc}")
        tails[where] = (res.final_acc, res.accs.cpu().numpy()[-TP_TAIL:])
    (f_card, t_card), (f_cpu, t_cpu) = tails["cuda"], tails["cpu"]
    if not (t_card.max() >= SSGD_BAND and t_cpu.max() >= SSGD_BAND
            and abs(float(t_card.mean()) - float(t_cpu.mean()))
            <= TP_TAIL_MEANS):
        raise AssertionError(
            f"--mesh-shape 2x4: last {TP_TAIL} steps: card best "
            f"{t_card.max()}, mean {t_card.mean()}; CPU best {t_cpu.max()}, "
            f"mean {t_cpu.mean()} (want both best >= {SSGD_BAND}, means "
            f"within {TP_TAIL_MEANS})")
    print(f"[tp] breast cancer, cli ssgd --sampler fused_gather --mesh-shape "
          f"2x4 --fused-pack 4 --gather-block-rows 32 --shuffle-seed 0: "
          f"final acc card {f_card!r}, CPU {f_cpu!r} (reported); last "
          f"{TP_TAIL} steps: card best {float(t_card.max())!r}, mean "
          f"{float(t_card.mean())!r}; CPU best {float(t_cpu.max())!r}, mean "
          f"{float(t_cpu.mean())!r}")


def run_ssgd_tp(dev, sg: dict) -> dict:
    """Phase 9: the tensor-parallel split. Returns the kernel records
    (main and wide shapes) and the main path's launches."""
    import dataclasses

    import torch

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.tools.ssgd_gathered_timing import trainer_draws

    X, y = sg["X"], sg["y"]
    cfg = ssgd.SSGDConfig(
        n_iterations=SSGD_STEPS, eval_test=False, x_dtype="bfloat16",
        sampler="fused_gather", gather_block_rows=SSGD_GBR, shuffle_seed=0,
        init_seed=7, feature_sharded=True)
    out = {"launches": {}}
    w_one = None
    for n_data, n_model in ((1, 1), (1, 2)):
        name = f"{n_data}x{n_model}"
        t0 = time.perf_counter()
        mesh = get_mesh(n_data, n_model, device=dev)
        fn, X2, w0, meta = ssgd.prepare_fused_tp(X, y, mesh, cfg)
        D = meta["d_total"]
        te = (torch.zeros((1, n_model * D), device=dev),
              torch.zeros((1,), device=dev))
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        n_blocks, n_s = ssgd.fused_gather_geometry(cfg, meta, n_data)

        def run():
            return fn(X2, None, None, *te, w0)

        w_warm, _ = run()
        if name == "1x1":
            # at 1×1 the slice is prepare_fused's X2 itself: the one-pass
            # trainer (B1) on it, timed in turns with the split
            fn_one = ssgd.make_train_fn_fused(mesh, dataclasses.replace(
                cfg, feature_sharded=False), meta)

            def run_one():
                t1 = time.perf_counter()
                w1, _ = fn_one(X2[0], None, None, *te, w0)
                torch.cuda.synchronize()
                return w1, time.perf_counter() - t1

            run_one()
            w_one, sec_a = run_one()
        w, sec1, launches = _tp_run(name, run, SSGD_STEPS, n_data, n_model)
        w2, sec2, _ = _tp_run(name, run, SSGD_STEPS, n_data, n_model)
        out["launches"][name] = launches
        if not (torch.equal(w, w_warm) and torch.equal(w, w2)):
            raise AssertionError(f"tp {name}: runs on the card differ")
        rates = [SSGD_STEPS / sec1, SSGD_STEPS / sec2]
        if name == "1x1":
            _, sec_b = run_one()
            rates_one = [SSGD_STEPS / sec_a, SSGD_STEPS / sec_b]
        w_plain = ssgd.tp_extract_weights(w, meta)
        w_ref = w_one[:meta["d_orig"]]
        diff = float((w_plain - w_ref).abs().max())
        if not torch.allclose(w_plain, w_ref, rtol=2e-2, atol=2e-2):
            raise AssertionError(f"tp {name} != one-pass fused_gather: max "
                                 f"|dw| {diff}")
        rate = max(rates)
        step_bytes = 2 * n_s * SSGD_GBR * D * X2.element_size() * n_model
        print(f"[tp] {name}: X2 {tuple(X2.shape)} {X2.dtype} "
              f"({X2.numel() * X2.element_size()} bytes, d_local "
              f"{meta['d_local']}, D={D}; set-up {setup!r} s); "
              f"{SSGD_STEPS} steps: {rates!r} steps/s, one-pass "
              f"fused_gather (B1) on the 1x1 slice {rates_one!r} (runs in "
              f"turns B1, split, split, B1 at 1x1), best split / best B1 "
              f"{rate / max(rates_one)!r}; {step_bytes} bytes/step "
              f"(B3 + B4), {step_bytes * rate / HBM_BYTES_PER_S!r} of 3.35 "
              f"TB/s; vs one-pass max |dw| {diff!r} (rtol/atol 2e-2); three "
              f"runs equal bit for bit; launches B3 "
              f"{launches['fused_forward_gathered']}, B4 "
              f"{launches['fused_backward_gathered']}, B1 "
              f"{launches['fused_grad_sum_gathered']}")
        if name == "1x1":
            out["main"] = tp_kernel_records(
                dev, X2[0], w0.view(n_model, D)[0],
                _first_step_ids(cfg, meta, n_data, dev), meta, SSGD_GBR,
                draws=trainer_draws(cfg, meta, dev))
            del fn_one
        else:
            with tempfile.TemporaryDirectory(prefix="chip-smoke-") as ck:
                w_seg, _ = ssgd.train_prepared_tp(
                    mesh, cfg, X2, w0, meta, *te, checkpoint_dir=ck,
                    checkpoint_every=500)
            if not torch.equal(w_seg, w):
                raise AssertionError(f"tp {name}: a run segmented at 500 "
                                     f"steps differs from a straight one")
            print(f"[tp] {name}: a run checkpointed in segments of 500 steps "
                  f"equals the straight run bit for bit")
        del fn, X2, w0
        torch.cuda.empty_cache()
    out["main_launches"] = out["launches"]["1x1"]

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    Xw = rng.standard_normal((TP_WIDE_ROWS, TP_WIDE_D)).astype(np.float32)
    yw = (Xw[:, 0] > 0).astype(np.float32)
    cfg_w = dataclasses.replace(
        cfg, n_iterations=TP_WIDE_STEPS, mini_batch_fraction=1.0,
        gather_block_rows=TP_WIDE_GBR, shuffle_seed=None)
    print(f"[tp] wide data: {TP_WIDE_ROWS} x {TP_WIDE_D} N(0, 1) float32 "
          f"from default_rng(0) in {time.perf_counter() - t0!r} s")
    weights = {}
    for n_data, n_model in ((2, 2), (2, 1)):
        name = f"{n_data}x{n_model}"
        t0 = time.perf_counter()
        mesh = get_mesh(n_data, n_model, device=dev)
        fn, X2, w0, meta = ssgd.prepare_fused_tp(Xw, yw, mesh, cfg_w)
        te = (torch.zeros((1, n_model * meta["d_total"]), device=dev),
              torch.zeros((1,), device=dev))
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        n_blocks, n_s = ssgd.fused_gather_geometry(cfg_w, meta, n_data)

        def run():
            return fn(X2, None, None, *te, w0)

        run()
        secs = []
        for _ in range(TP_WIDE_REPEATS):
            w, sec, launches = _tp_run(name, run, TP_WIDE_STEPS, n_data,
                                       n_model)
            secs.append(sec)
        weights[name] = ssgd.tp_extract_weights(w, meta)
        D = meta["d_total"]
        rate = TP_WIDE_STEPS / min(secs)
        step_bytes = 2 * n_data * n_model * n_s * TP_WIDE_GBR * D * 2
        print(f"[tp] wide {name}: X2 {tuple(X2.shape)} bf16 "
              f"({X2.numel() * X2.element_size()} bytes, d_local "
              f"{meta['d_local']}, D={D}, {n_blocks} blocks of {TP_WIDE_GBR} "
              f"rows a data shard, {n_s} sampled; set-up {setup!r} s); "
              f"{TP_WIDE_STEPS} steps, best of {TP_WIDE_REPEATS}: {rate!r} "
              f"steps/s ({[TP_WIDE_STEPS / x for x in secs]!r}); "
              f"{step_bytes} bytes/step (B3 + B4), "
              f"{step_bytes * rate / HBM_BYTES_PER_S!r} of 3.35 TB/s; launches "
              f"B3 {launches['fused_forward_gathered']}, B4 "
              f"{launches['fused_backward_gathered']} a run")
        if name == "2x2":
            out["wide_rate"] = rate
            ids0 = _first_step_ids(cfg_w, meta, n_data, dev)
            out["wide"] = tp_kernel_records(dev, X2[0],
                                            w0.view(n_model, D)[0], ids0,
                                            meta, TP_WIDE_GBR)
        del fn, X2, w0
        torch.cuda.empty_cache()
    out.update(_wide_pure_dp(dev, Xw, yw, cfg_w))
    print(f"[tp] wide: bench.py's ssgd_2d_mesh_step_speedup arms on one card: "
          f"2x2 split {out['wide_rate']!r} steps/s / 4x1 pure dp "
          f"{out['wide_dp_rate']!r} steps/s = "
          f"{out['wide_rate'] / out['wide_dp_rate']!r}: with the four shards "
          f"on one card there is no wire for the model axis to divide, so "
          f"this ratio prices the split on one card, not what an "
          f"interconnect would save")
    diff = float((weights["2x2"] - weights["2x1"]).abs().max())
    if not torch.allclose(weights["2x2"], weights["2x1"], rtol=2e-3,
                          atol=2e-3):
        raise AssertionError(f"wide 2x2 != 2x1: max |dw| {diff}")
    print(f"[tp] wide 2x2 vs 2x1 after {TP_WIDE_STEPS} steps: max |dw| "
          f"{diff!r} (rtol/atol 2e-3)")
    del Xw, yw
    _check_tp_cli(dev)
    for shape, recs in (("main", out["main"]), ("wide", out["wide"])):
        for k in ("B3", "B4"):
            r = recs[k]
            print(f"[kernels] ssgd {k} {shape} shape ({r['bytes']} bytes of "
                  f"X2): max |err| {r['max_abs_err']!r} vs plain; kernel "
                  f"{r['ms']!r} ms, plain {r['plain_ms']!r} ms, library "
                  f"{r['library_ms']!r} ms, bound {r['bound_ms']!r} ms "
                  f"({r['bound_by']})")
    return out


def _wide_pure_dp(dev, Xw, yw, cfg_w) -> dict:
    """bench.py's pure-dp arm of ``ssgd_2d_mesh_step_speedup``
    (bench.py:1051-1062) at the wide geometry: the same rows on a 4x1
    mesh through the one-pass fused_gather trainer (B1 on 16 KB rows),
    its steps/s; then B1, B2 and B6 on these wide rows against their
    plain versions, timed beside them, a library call and the bound."""
    import dataclasses

    import torch

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.ops import ssgd_kernels as tk
    from tpu_distalg_torch.parallel import get_mesh

    n_data = 4
    mesh = get_mesh(n_data, 1, device=dev)
    cfg = dataclasses.replace(cfg_w, feature_sharded=False)
    t0 = time.perf_counter()
    fn, X2, w0, meta = ssgd.prepare_fused(Xw, yw, mesh, cfg)
    D, yc, vc = meta["d_total"], meta["y_col"], meta["v_col"]
    te = (torch.zeros((1, D), device=dev), torch.zeros((1,), device=dev))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    n_blocks, n_s = ssgd.fused_gather_geometry(cfg, meta, n_data)
    fn(X2, None, None, *te, w0)
    secs = []
    for _ in range(TP_WIDE_REPEATS):
        _reset_launches()
        t1 = time.perf_counter()
        fn(X2, None, None, *te, w0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        launches = _launches()
        if launches["fused_grad_sum_gathered"] != TP_WIDE_STEPS * n_data:
            raise AssertionError(f"wide 4x1: B1 launched "
                                 f"{launches['fused_grad_sum_gathered']} "
                                 f"times in {TP_WIDE_STEPS} steps")
    rate = TP_WIDE_STEPS / min(secs)
    print(f"[tp] wide 4x1 pure dp (fused_gather, B1): X2 {tuple(X2.shape)} "
          f"{X2.dtype}, D={D} ({D * X2.element_size()}-byte rows), "
          f"{n_blocks} blocks of {TP_WIDE_GBR} rows a data shard, {n_s} "
          f"sampled; set-up {setup!r} s; {TP_WIDE_STEPS} steps, best of "
          f"{TP_WIDE_REPEATS}: {rate!r} steps/s "
          f"({[TP_WIDE_STEPS / x for x in secs]!r}); B1 "
          f"{launches['fused_grad_sum_gathered']} launches a run")

    recs = {}
    kw = dict(pack=meta["pack"], d_total=D, y_col=yc, v_col=vc,
              gather_block_rows=TP_WIDE_GBR)
    n_all = X2.shape[0] * meta["pack"] // TP_WIDE_GBR
    ids = torch.arange(n_all, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    w = torch.randn((D,), generator=g, device=dev) * 0.01
    w[yc:] = 0
    blocks = X2.reshape(-1, TP_WIDE_GBR, D)
    wq = w.to(X2.dtype)

    def lib1(ids_l, w16):
        x = torch.index_select(blocks, 0, ids_l).reshape(-1, D)
        r = (torch.sigmoid(torch.mv(x, w16).float()) - x[:, yc].float()) \
            * x[:, vc].float()
        return torch.mv(x.T, r.to(x.dtype)).float(), x[:, vc].float().sum()

    rows = n_all * TP_WIDE_GBR
    x_bytes = rows * D * X2.element_size()
    g1, c1 = tk.fused_grad_sum_gathered(X2, w, ids, **kw)
    r1, rc1 = tk.grad_sum_gathered_reference(X2, w, ids, **kw)
    if float(c1) != float(rc1):
        raise AssertionError(f"B1 wide: count {c1} != {rc1}")
    b = _bound_ms(x_bytes + 4 * (n_all + 2 * D + 1), 4 * rows * D)
    recs["B1"] = dict(
        max_abs_err=_assert_close("B1 wide", g1[:yc], r1[:yc], "random"),
        ms=_time_ms(lambda: tk.fused_grad_sum_gathered(X2, w, ids, **kw), 10,
                    warm=2),
        plain_ms=_time_ms(lambda: tk.grad_sum_gathered_reference(
            X2, w, ids, **kw), 3, warm=1),
        library_ms=_time_ms(lambda: lib1(ids.long(), wq), 3, warm=1),
        bound_ms=b[0], bound_by=b[1])
    T = 3
    ids_seg = ids[None].repeat(T, 1).contiguous()
    wk = tk.fused_train_gathered(X2, w, ids_seg, eta=0.1, **kw)
    wr = tk.train_gathered_reference(X2, w, ids_seg, eta=0.1, **kw)
    b = _bound_ms(T * x_bytes + 4 * (T * n_all + 3 * D),
                  T * (4 * rows * D + 3 * D))
    keep = torch.arange(D, device=dev) < yc
    ids_long = ids.long()

    def lib2():  # T steps of B1's library line and the update, as phase 6
        wt = w
        for _ in range(T):
            gt, ct = lib1(ids_long, torch.where(keep, wt, 0.0).to(X2.dtype))
            wt = wt - (0.1 / torch.clamp_min(ct, 1.0)) * torch.where(
                keep, gt, 0.0)
        return wt

    recs["B2"] = dict(
        max_abs_err=_assert_close(f"B2 wide ({T} steps)", wk, wr,
                                  _steps_kind(X2)),
        ms=_time_ms(lambda: tk.fused_train_gathered(X2, w, ids_seg, eta=0.1,
                                                    **kw), 5, warm=1),
        plain_ms=_time_ms(lambda: tk.train_gathered_reference(
            X2, w, ids_seg, eta=0.1, **kw), 2, warm=1),
        library_ms=_time_ms(lib2, 2, warm=1), bound_ms=b[0], bound_by=b[1])
    del fn, X2, w0, blocks
    torch.cuda.empty_cache()
    Xf = torch.as_tensor(Xw, device=dev)
    n, d = Xf.shape
    yf = torch.as_tensor(yw, device=dev)
    mask = (torch.arange(n, device=dev) % 3 != 0).float()
    wf = w[:d].contiguous()
    g6, c6 = tk.fused_grad_sum(Xf, yf, mask, wf)
    r6, rc6 = tk.grad_sum_reference(Xf, yf, mask, wf)
    if float(c6) != float(rc6):
        raise AssertionError(f"B6 wide: count {c6} != {rc6}")

    def lib6():
        return (torch.mv(Xf.T, (torch.sigmoid(torch.mv(Xf, wf)) - yf) * mask),
                mask.sum())

    b = _bound_ms(4 * (n * d + 2 * n + 2 * d + 1), 4 * n * d + 6 * n)
    recs["B6"] = dict(
        max_abs_err=_assert_close("B6 wide", g6, r6, "random"),
        ms=_time_ms(lambda: tk.fused_grad_sum(Xf, yf, mask, wf), 10, warm=2),
        plain_ms=_time_ms(lambda: tk.grad_sum_reference(Xf, yf, mask, wf), 3,
                          warm=1),
        library_ms=_time_ms(lib6, 3, warm=1), bound_ms=b[0], bound_by=b[1])
    del Xf
    torch.cuda.empty_cache()
    for name, shape in (("B1", f"{n_all} blocks of {TP_WIDE_GBR} rows, "
                               f"D={D} bf16"),
                        ("B2", f"{T} steps × {n_all} blocks, D={D} bf16"),
                        ("B6", f"X ({n}, {d}) float32")):
        r = recs[name]
        print(f"[kernels] ssgd {name} wide shape ({shape}): max |err| "
              f"{r['max_abs_err']!r} vs plain; kernel {r['ms']!r} ms, plain "
              f"{r['plain_ms']!r} ms, library {r['library_ms']!r} ms, bound "
              f"{r['bound_ms']!r} ms ({r['bound_by']})")
    return {"wide_dp_rate": rate, "wide_dp": recs}


def _first_step_ids(cfg, meta, n_data, dev):
    """Data shard 0's block ids at step 0, as the trainer draws them."""
    import torch

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.ops import sampling
    from tpu_distalg_torch.utils import prng

    n_blocks, n_s = ssgd.fused_gather_geometry(cfg, meta, n_data)
    key = prng.root_key(cfg.seed, dev)
    return sampling.sample_block_ids(
        prng.fold_in(key, torch.zeros(1, dtype=torch.int64, device=dev)),
        n_data, n_blocks, n_s)[0, 0].contiguous()


#: PageRank at bench.py's geometry (bench.py:104-106, :2662): vertices,
#: average degree, iterations per call (PR_ITERS_PER_CALL), and the
#: iterations after which the card is held against the CPU
PR_VERTICES, PR_AVG_DEGREE, PR_ITERS, PR_CHECK_ITERS = (
    1_000_000, 8.0, 50, 10)
#: timed runs of each sweep (the best is its iterations/s, as bench.py
#: takes the best of its repeats)
PR_REPEATS = 5
#: the reference's recorded toy ranks (tests/test_workloads.py:113-121)
PR_GOLDEN = [0.38891305880091237, 0.214416470596171, 0.3966704706029163]
#: B7/B8 random cases, per element against the plain version: rtol 1e-5
#: and atol 1e-8 (rows of up to ~40 edges drift a few 2⁻²⁴ in either
#: order), as tests/test_pallas_pagerank.py holds the JAX sweeps; the
#: 100k-edge hub row rtol 1e-4 (the plain version's atomics add in no
#: fixed order, and a float32 sum of 100k positive terms drifts about
#: 1e-5 of its value: 7.2e-6 for the CPU's sequential sum)
PR_RTOL, PR_HUB_RTOL, PR_ATOL = 1e-5, 1e-4, 1e-8


def _pr_rows(dev, rng, v, hub_degree, avg):
    """CSR rows: row 17 with ``hub_degree`` in-edges, every fifth row
    empty, the others Poisson(avg) edges; src uniform."""
    import torch

    deg = rng.poisson(avg, size=v)
    deg[::5] = 0
    if hub_degree:
        deg[17] = hub_degree
    rp = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=rp[1:])
    src = rng.integers(0, v, size=int(rp[-1])).astype(np.int32)
    return (torch.as_tensor(rp.astype(np.int32), device=dev),
            torch.as_tensor(src, device=dev))


def _pr_close(what, got, want, rtol) -> float:
    import torch

    if not torch.allclose(got, want, rtol=rtol, atol=PR_ATOL):
        raise AssertionError(f"{what}: not within rtol {rtol}, atol "
                             f"{PR_ATOL} of the plain version")
    return float((got - want).abs().max())


def _pr_check(dev, label, rp, src, rng, rtol) -> list:
    """B7 and B8 on one CSR against their plain versions: the exact case
    (x a multiple of 2⁻¹⁰ below 2⁻⁶, w_e = 1, integer c: every partial
    sum exact) bitwise with empty rows 0, the random case within
    ``rtol``, each replaying bitwise. Returns the random case's max
    |err| of B7 and B8."""
    import torch

    from tpu_distalg_torch.ops import pagerank_kernels as pk

    V, E = rp.shape[0] - 1, src.shape[0]
    empty = (rp[1:] == rp[:-1])
    errs = []
    for kind in ("exact", "random"):
        if kind == "exact":
            x = torch.as_tensor((rng.integers(0, 16, size=V) / 1024.0
                                 ).astype(np.float32), device=dev)
            w = torch.ones(E, device=dev)
            c = torch.as_tensor(rng.integers(-8, 9, size=E).astype(
                np.float32), device=dev)
        else:
            x, w, c = (torch.as_tensor(rng.random(n).astype(np.float32),
                                       device=dev) for n in (V, E, E))
        y7 = pk.spmv_table(rp, src, w, x)
        y8 = pk.scatter_table(rp, c)
        torch.cuda.synchronize()
        r7 = pk.spmv_table_reference(rp, src, w, x)
        r8 = pk.scatter_table_reference(rp, c)
        if kind == "exact":
            if not (torch.equal(y7, r7) and torch.equal(y8, r8)):
                raise AssertionError(f"B7/B8 {label}: exact case not "
                                     f"bitwise equal")
            if bool(empty.any()) and float(y7[empty].abs().max()) != 0.0:
                raise AssertionError(f"B7 {label}: an empty row is not 0")
        else:
            errs = [_pr_close(f"B7 {label}", y7, r7, rtol),
                    _pr_close(f"B8 {label}", y8, r8, rtol)]
        if not (torch.equal(y7, pk.spmv_table(rp, src, w, x))
                and torch.equal(y8, pk.scatter_table(rp, c))):
            raise AssertionError(f"B7/B8 {label}: replay differs")
    return errs


def _pr_degrees(dev, rng, deg):
    """CSR rows of in-degrees ``deg``, src uniform."""
    import torch

    rp = np.zeros(len(deg) + 1, np.int64)
    np.cumsum(deg, out=rp[1:])
    src = rng.integers(0, len(deg), size=int(rp[-1])).astype(np.int32)
    return (torch.as_tensor(rp.astype(np.int32), device=dev),
            torch.as_tensor(src, device=dev))


def check_pagerank_kernels_small(dev) -> None:
    """Phase 7a: B7 and B8 against their plain versions (``_pr_check``)
    on a hub row, empty rows, V not a multiple of any tile, every tile
    size (256 to 2048 path items); the slices of a 3-shard split (E and
    the slices' length not multiples of 4, so src and w start misaligned),
    w_e misaligned against src (scalar loads), shards without edges, rows
    across tile boundaries and rows longer than a tile."""
    import torch

    from tpu_distalg_torch.models import pagerank
    from tpu_distalg_torch.ops import graph as gops
    from tpu_distalg_torch.ops import pagerank_kernels as pk
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    cases = []
    for label, v, hub, avg in (
            ("hub row of 100000 in-edges, V=4099", 4099, 100_000, 8.0),
            ("V=1000003, average degree 6.4", 1_000_003, 0, 8.0),
            ("V=37, average degree 2", 37, 0, 2.5),
            ("V=20000, average degree 12", 20_000, 0, 15.0),
            ("V=5000, average degree 24", 5000, 0, 30.0)):
        rng = np.random.default_rng(v)
        cases.append((label, *_pr_rows(dev, rng, v, hub, avg), rng,
                      PR_HUB_RTOL if hub else PR_RTOL))
    for label, v, low, high, long_row in (
            ("rows across tile boundaries, one of 5000", 3000, 0, 700, 5000),
            ("rows longer than a tile", 40, 1500, 2600, 9000),
            ("rows around 16 edges (one thread or a warp)", 997, 0, 40, 0)):
        rng = np.random.default_rng(v + 1)
        deg = rng.integers(low, high + 1, size=v)
        deg[::7] = 0
        if long_row:
            deg[v // 2] = long_row
        cases.append((label, *_pr_degrees(dev, rng, deg), rng, PR_RTOL))
    for v in (1, 5000):
        cases.append((f"E=0, V={v}",
                      torch.zeros(v + 1, dtype=torch.int32, device=dev),
                      torch.zeros(0, dtype=torch.int32, device=dev),
                      np.random.default_rng(v), PR_RTOL))
    edges = datasets.erdos_renyi_edges(4000, 7.5, seed=3)
    for drop in range(16):   # E and the shards' slice length not 4k
        el = gops.prepare_edges(edges[:len(edges) - drop], 4000)
        if el.n_edges % 4 and -(-el.n_edges // 3) % 4:
            break
    de = pagerank.prepare_device_edges(el, get_mesh(data=3, device=dev))
    rng = np.random.default_rng(3)
    for s, (rp, src, w) in enumerate(de.shards):
        cases.append((f"shard {s} of 3 (src at byte {src.data_ptr() % 16} "
                      f"of 16)", rp, src, rng, PR_RTOL))
    for label, rp, src, rng, rtol in cases:
        errs = _pr_check(dev, label, rp, src, rng, rtol)
        plan = pk.tile_plan(rp, src.shape[0])
        print(f"[kernels] pagerank {label} ({src.shape[0]} edges, "
              f"{plan.n_tiles} tiles of {plan.items} items): exact case "
              f"bitwise, random max |err| B7 {errs[0]!r} B8 {errs[1]!r}, "
              f"replay bitwise")
    rp, src, w = de.shards[1]
    for k in (1, 2, 3):   # w_e at another offset from 16 bytes than src
        w2 = torch.cat([torch.zeros(k, device=dev), w])[k:]
        if (w2.data_ptr() - src.data_ptr()) % 16:
            break
    x = torch.as_tensor(rng.random(4000).astype(np.float32), device=dev)
    err = _pr_close("B7 w_e misaligned against src",
                    pk.spmv_table(rp, src, w2, x),
                    pk.spmv_table_reference(rp, src, w2, x), PR_RTOL)
    print(f"[kernels] pagerank B7 with w_e misaligned against src (scalar "
          f"loads): max |err| {err!r}")


#: the PageRank library's kernels as cuobjdump names them: the merge-path
#: tile kernel csr_tiles<kGather, kVec, kCeiling> of B7 and B8, with
#: 16-byte (main) and scalar loads, and the gather ceiling's probe
PR_KERNELS = {"B7": "csr_tilesILb1ELb1ELb0E", "B7 scalar": "csr_tilesILb1ELb0ELb0E",
              "B8": "csr_tilesILb0ELb1ELb0E", "B8 scalar": "csr_tilesILb0ELb0ELb0E",
              "gather ceiling": "csr_tilesILb1ELb1ELb1E"}
#: a 128-bit global load in SASS (LDG.E.128, LDG.E.128.CONSTANT, …)
LDG128 = r"LDG\.E[.A-Z0-9]*\.128"


def pagerank_sass() -> dict:
    """Phase 7's build check: for each B7/B8 kernel, its 128-bit global
    loads (``LDG128``) in SASS and its registers and spill bytes
    (``cuobjdump -sass`` and ``-res-usage``). Raises unless B7's and B8's
    main kernels hold 128-bit loads."""
    out = _sass_counts("pagerank", PR_KERNELS, (LDG128,))
    out = {k: {("LDG.128" if op == LDG128 else op): n for op, n in c.items()}
           for k, c in out.items()}
    print(f"[kernels] pagerank SASS (LDG.128 = 128-bit global loads; "
          f"registers a thread, stack and local bytes = spills): "
          f"{json.dumps(out)}")
    for k in ("B7", "B8"):
        if not out[k]["LDG.128"]:
            raise AssertionError(f"{k}'s main kernel has no 128-bit global "
                                 f"load in its SASS: {out[k]}")
    return out


def _pr_kernel_rec(dev, key, run, plain, lib, nbytes, flops) -> dict:
    """One kernel against its plain version, timed beside the plain
    version, the library call and the bound."""
    import torch

    got, want = run(), plain()
    torch.cuda.synchronize()
    err = _pr_close(f"{key}", got, want, PR_RTOL if "skewed" not in key
                    else PR_HUB_RTOL)
    bound = _bound_ms(nbytes, flops)
    rec = dict(max_abs_err=err, ms=_time_ms(run, 200),
               plain_ms=_time_ms(plain, 50), library_ms=_time_ms(lib, 50),
               bound_ms=bound[0], bound_by=bound[1])
    lib_err = float((lib() - want).abs().max())
    print(f"[kernels] pagerank {key}: max |err| {err!r} vs plain; kernel "
          f"{rec['ms']!r} ms, plain {rec['plain_ms']!r} ms, library "
          f"{rec['library_ms']!r} ms (max |err| {lib_err!r}), bound "
          f"{rec['bound_ms']!r} ms ({rec['bound_by']}, {nbytes} bytes)")
    return rec


def _pr_pair(dev, where, rp, src, w, x, plan) -> dict:
    """B7 and B8 records on one CSR: x positive like ranks, B8's input
    the pallas path's ``x[src]·w``; the library calls a CSR sparse
    product and ``segment_reduce``."""
    import warnings

    import torch

    from tpu_distalg_torch.ops import pagerank_kernels as pk

    V, E = rp.shape[0] - 1, src.shape[0]
    c = torch.index_select(x, 0, src) * w
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        A = torch.sparse_csr_tensor(rp, src, w, (V, V),
                                    check_invariants=False)
    offsets = rp.long()
    return {
        "B7": _pr_kernel_rec(
            dev, f"B7 {where} (V={V}, E={E})",
            lambda: pk.spmv_table(rp, src, w, x, plan),
            lambda: pk.spmv_table_reference(rp, src, w, x),
            lambda: A @ x, 4 * (2 * E + (V + 1) + 2 * V), 2 * E),
        "B8": _pr_kernel_rec(
            dev, f"B8 {where} (V={V}, E={E})",
            lambda: pk.scatter_table(rp, c, plan),
            lambda: pk.scatter_table_reference(rp, c),
            lambda: torch.segment_reduce(c, "sum", offsets=offsets,
                                         unsafe=True),
            4 * (E + (V + 1) + V), E)}


def pagerank_kernel_records(dev, de) -> dict:
    """Phase 7b: B7 and B8 at the main path's shape (the graph's CSR
    rows and prepared plan) against their plain versions, timed beside
    the plain version, the library call and the bound; the gather
    ceiling (``gather_ceiling``: B7's loads, gathers and products without
    the rows) beside B7; both kernels on the skewed graph
    (``tools/pagerank_profile.skewed_rows``: V 1M, zipf(2.0) in-degrees
    capped at 100,000; its rows of more than 10,000 edges drift as the
    hub row does, so it is held within ``PR_HUB_RTOL``)."""
    import torch

    from tpu_distalg_torch.ops import pagerank_kernels as pk
    from tpu_distalg_torch.tools.pagerank_profile import skewed_rows

    (rp, src, w), plan = de.shards[0], de.plans[0]
    V = de.n_vertices
    x = torch.as_tensor(np.random.default_rng(SEED + 17).random(V).astype(
        np.float32), device=dev)
    recs = _pr_pair(dev, "main shape", rp, src, w, x, plan)
    ceiling = pk.gather_ceiling(rp, src, w, x, plan)
    total = float(pk.spmv_table(rp, src, w, x, plan).double().sum())
    if abs(float(ceiling.double().sum()) - total) > 1e-5 * abs(total):
        raise AssertionError("the gather ceiling's tiles do not add up to "
                             "B7's sweep")
    recs["B7"]["gather_ceiling_ms"] = _time_ms(
        lambda: pk.gather_ceiling(rp, src, w, x, plan), 200)
    srp, ssrc = (torch.as_tensor(a, device=dev) for a in skewed_rows())
    sw = torch.as_tensor(np.random.default_rng(SEED + 18).random(
        ssrc.shape[0]).astype(np.float32), device=dev)
    skewed = _pr_pair(dev, "skewed graph", srp, ssrc, sw, x,
                      pk.tile_plan(srp, ssrc.shape[0]))
    for key in ("B7", "B8"):
        recs[key].update({f"skewed_{k}": v for k, v in skewed[key].items()
                          if k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "max_abs_err")})
    print(f"[kernels] pagerank B7 gather ceiling at the main shape: "
          f"{recs['B7']['gather_ceiling_ms']!r} ms (B7 {recs['B7']['ms']!r}, "
          f"byte bound {recs['B7']['bound_ms']!r})")
    return recs


def run_pagerank(dev) -> dict:
    """Phase 7: the kernels, then the PageRank paths at bench.py's
    geometry. Returns the kernel records and each path's launches."""
    import torch

    import contextlib

    from tpu_distalg_torch import native
    from tpu_distalg_torch.models import pagerank
    from tpu_distalg_torch.ops import graph as gops
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    check_pagerank_kernels_small(dev)
    sass = pagerank_sass()
    mesh = get_mesh(data=1, device=dev)
    t0 = time.perf_counter()
    edges = datasets.erdos_renyi_edges(PR_VERTICES, PR_AVG_DEGREE, seed=0)
    print(f"[pagerank] graph: {len(edges)} edges drawn in "
          f"{time.perf_counter() - t0!r} s")
    cfg = pagerank.PageRankConfig(n_iterations=PR_ITERS, mode="standard")
    torch.cuda.synchronize()
    _reset_launches()
    t1 = time.perf_counter()
    res = pagerank.run(edges, mesh, cfg, PR_VERTICES)
    total = float(res.ranks.sum())
    main_s = time.perf_counter() - t1
    launches = {"auto": _launches()}
    if (launches["auto"]["spmv_table"], launches["auto"]["scatter_table"]
            ) != (PR_ITERS, 0):
        raise AssertionError(f"pagerank.run (auto): launches "
                             f"{launches['auto']}, want spmv_table "
                             f"{PR_ITERS} and scatter_table 0")
    if not (res.ranks.shape == (PR_VERTICES,)
            and bool(torch.isfinite(res.ranks).all())
            and abs(total - 1.0) <= 1e-4):
        raise AssertionError(
            f"pagerank.run: ranks {tuple(res.ranks.shape)}, finite "
            f"{bool(torch.isfinite(res.ranks).all())}, sum {total!r} (want "
            f"within 1e-4 of 1)")
    print(f"[pagerank] models.pagerank.run, standard, scatter=auto: "
          f"{PR_ITERS} iterations in {main_s!r} s with the host prep "
          f"(dedupe, dst sort, CSR upload); Σranks {total!r}; launches "
          f"{launches['auto']}")

    prep = {}
    for how in ("numpy forms", "C++ binding"):
        with (native.numpy_forms() if how == "numpy forms"
              else contextlib.nullcontext()):
            t1 = time.perf_counter()
            el = gops.prepare_edges(edges, PR_VERTICES)
            de = pagerank.prepare_device_edges(el, mesh)
            torch.cuda.synchronize()
            prep[how] = time.perf_counter() - t1
        if how == "numpy forms":
            de_np = de
    if not all(torch.equal(a, b) for s, t in zip(de_np.shards, de.shards)
               for a, b in zip(s, t)):
        raise AssertionError("pagerank prep: the binding's CSR differs from "
                             "the numpy forms'")
    del de_np
    print(f"[pagerank] prep: {prep['C++ binding']!r} s for {el.n_edges} "
          f"edges, {el.n_vertices} vertices through the C++ binding, "
          f"{prep['numpy forms']!r} s through its numpy forms (the same "
          f"CSR bit for bit)")
    recs = pagerank_kernel_records(dev, de)

    rates = {}
    for scatter in ("auto", "pallas", "xla"):
        fn = pagerank.make_run_fn(mesh, pagerank.PageRankConfig(
            n_iterations=PR_ITERS, mode="standard", scatter=scatter),
            PR_VERTICES)
        first, _ = fn(de)                        # warm
        want = {"auto": (PR_ITERS, 0), "pallas": (0, PR_ITERS),
                "xla": (0, 0)}[scatter]
        secs = []
        for _ in range(PR_REPEATS):
            torch.cuda.synchronize()
            _reset_launches()
            t1 = time.perf_counter()
            ranks, _ = fn(de)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            got = _launches()
            if (got["spmv_table"], got["scatter_table"]) != want:
                raise AssertionError(
                    f"scatter={scatter}: launches {got}, want "
                    f"(spmv_table, scatter_table) = {want}")
            if scatter != "xla" and not torch.equal(first, ranks):
                raise AssertionError(f"scatter={scatter}: two runs on the "
                                     f"card differ")
        if scatter == "pallas":
            launches["pallas"] = got
        rates[scatter] = PR_ITERS / min(secs)
        print(f"[pagerank] scatter={scatter}: {PR_ITERS} iterations in "
              f"{min(secs)!r} s (best of {PR_REPEATS}; slowest "
              f"{max(secs)!r} s) = {rates[scatter]!r} iter/s, "
              f"{1e9 / (rates[scatter] * el.n_edges)!r} ns/edge; Σranks "
              f"{float(ranks.sum())!r}; launches per run {got}"
              + ("" if scatter == "xla" else "; replay bitwise"))

    cfg10 = pagerank.PageRankConfig(n_iterations=PR_CHECK_ITERS,
                                    mode="standard")
    card = pagerank.make_run_fn(mesh, cfg10, PR_VERTICES)(de)[0].cpu()
    mesh_cpu = get_mesh(data=1, device="cpu")
    cpu = pagerank.make_run_fn(mesh_cpu, cfg10, PR_VERTICES)(
        pagerank.prepare_device_edges(el, mesh_cpu))[0]
    if not torch.allclose(card, cpu, rtol=PR_RTOL, atol=PR_ATOL):
        raise AssertionError("pagerank: card ranks after 10 iterations not "
                             "within rtol 1e-5, atol 1e-8 of the CPU port's")
    print(f"[pagerank] after {PR_CHECK_ITERS} iterations the card's ranks "
          f"are within rtol {PR_RTOL}, atol {PR_ATOL} of the CPU port's "
          f"(plain versions): max |d| {float((card - cpu).abs().max())!r}")

    _reset_launches()
    toy = pagerank.run(datasets.toy_graph_edges(), mesh)
    n7 = _launches()["spmv_table"]
    got = toy.ranks.cpu().numpy()
    if n7 != 2 * 10 or not np.allclose(got, PR_GOLDEN, rtol=0, atol=1e-5):
        raise AssertionError(f"reference mode toy graph: ranks {got}, B7 "
                             f"launches {n7} (want {PR_GOLDEN} to 1e-5, "
                             f"20 launches)")
    print(f"[pagerank] reference mode, toy graph: {got.tolist()} within "
          f"1e-5 of the golden; B7 launches {n7} (2 per iteration)")
    for key in ("B7", "B8"):
        recs[key]["sass"] = {k: v for k, v in sass.items()
                             if k.startswith(key) or (key == "B7"
                                                      and "ceiling" in k)}
    return {"recs": recs, "launches": launches, "rates": rates,
            "prep_s": prep}


#: k-means at bench.py's geometry (bench.py:2310-2314): points, dims,
#: clusters, Lloyd iterations a call, the mixture's spread; timed calls
#: of each fit (the best is its iterations/s); the rows and iterations of
#: the card-against-CPU check; the rows of the artifact's fit and the
#: points served
KM_POINTS, KM_DIM, KM_K, KM_ITERS, KM_SPREAD = 10_000_000, 16, 8, 50, 8.0
KM_REPEATS, KM_CHECK_ROWS, KM_CHECK_ITERS = 5, 100_000, 5
KM_ARTIFACT_ROWS, KM_SERVED = 200_000, 512
#: (n, dim, k) of B10's small cases: every row width (dpad 8 to 128), n a
#: multiple of nothing, the plan whose lane groups share a tile (k 256 at
#: dim 2 and 16) and the one whose centres stay in device memory (k 256
#: at dim 128)
KM_SMALL = ((777, 11, 5), (5003, 2, 2), (8192, 16, 8), (3001, 64, 3),
            (1500, 128, 8), (4099, 2, 256), (2050, 16, 256), (700, 128, 256),
            (100_003, 16, 8))


def _lattice_mixture(rng, n, dim, k):
    """Separated points: centre c at 10 × the digits of c in the smallest
    base with k lattice points, plus N(0, 0.5²) noise, so that no point
    is within 9 standard deviations of a boundary and no assignment
    hangs on a float32 rounding."""
    base = 2
    while base ** dim < k:
        base += 1
    digits = [(np.arange(k) // base ** j) % base if base ** j < k
              else np.zeros(k, np.int64) for j in range(dim)]
    centers = (10.0 * np.stack(digits, axis=1)).astype(np.float32)
    pts = centers[rng.integers(0, k, n)] + 0.5 * rng.normal(size=(n, dim))
    return pts.astype(np.float32), centers


def check_kmeans_kernel_small(dev) -> None:
    """Phase 8a: B10 against its plain version. Exact cases (entries in
    {-3..3}: every distance and sum an exact integer, ties included)
    bitwise; separated mixtures with equal counts and sums within 1e-5
    of the largest (the sums add in another order); rows masked in the
    tail and in between; a fixed input replaying bitwise; duplicate
    centres (the first takes the point) and a cluster left empty."""
    import torch

    from tpu_distalg_torch.ops import kmeans_kernels as kk

    for n, dim, k in KM_SMALL:
        rng = np.random.default_rng(n + dim + k)
        errs = []
        for kind in ("exact", "random"):
            if kind == "exact":
                pts = rng.integers(-3, 4, size=(n, dim)).astype(np.float32)
                cen = rng.integers(-3, 4, size=(k, dim)).astype(np.float32)
            else:
                pts, cen = _lattice_mixture(rng, n, dim, k)
            mask = np.ones(n, np.float32)
            mask[n - n // 10:] = 0.0
            mask[rng.integers(0, n, n // 7)] = 0.0
            X2, m2 = kk.pack_points(pts, mask, dim=dim, k=k, device=dev)
            c = torch.as_tensor(cen, device=dev)
            sums, counts = kk.fused_cluster_stats(X2, m2, c, dim=dim, k=k)
            torch.cuda.synchronize()
            r_sums, r_counts = kk.cluster_stats_reference(X2, m2, c,
                                                          dim=dim, k=k)
            if not (torch.equal(counts, r_counts)
                    and float(counts.sum()) == float(mask.sum())):
                raise AssertionError(f"B10 n={n} dim={dim} k={k} {kind}: "
                                     f"counts differ")
            errs.append(_assert_close(f"B10 n={n} dim={dim} k={k} {kind}",
                                      sums, r_sums, kind))
            again = kk.fused_cluster_stats(X2, m2, c, dim=dim, k=k)
            if not (torch.equal(again[0], sums)
                    and torch.equal(again[1], counts)):
                raise AssertionError(f"B10 n={n} dim={dim} k={k}: replay "
                                     f"differs")
        plan = kk.kernel_plan(k, kk.packed_geometry(dim, k)[0])
        print(f"[kernels] kmeans B10 n={n} dim={dim} k={k} ({plan.warps} "
              f"warps, {plan.tiles_per_warp} tile(s) a warp, centres in "
              f"{'shared' if plan.cen_in_smem else 'device'} memory): exact "
              f"case bitwise, mixture counts equal and sums max |err| "
              f"{errs[1]!r}, replay bitwise")
    pts = np.array([[1.0, 1.0], [5.0, 5.0]], np.float32)
    cen = np.array([[1.0, 1.0], [1.0, 1.0], [5.0, 5.0], [90.0, 90.0]],
                   np.float32)
    X2, m2 = kk.pack_points(pts, np.ones(2, np.float32), dim=2, k=4,
                            device=dev)
    sums, counts = kk.fused_cluster_stats(
        X2, m2, torch.as_tensor(cen, device=dev), dim=2, k=4)
    if counts.tolist() != [1.0, 0.0, 1.0, 0.0] or sums.tolist() != [
            [1.0, 1.0], [0.0, 0.0], [5.0, 5.0], [0.0, 0.0]]:
        raise AssertionError(f"B10 duplicate centres: counts "
                             f"{counts.tolist()}, sums {sums.tolist()}")
    print("[kernels] kmeans B10 duplicate centres and an empty cluster: "
          "counts [1, 0, 1, 0] (the first minimum takes the point)")


def kmeans_kernel_record(dev, points, X2, m2, mask, centers) -> dict:
    """Phase 8b: B10 at the main path's shape against its plain version,
    timed beside the plain version, the library line (``ops/kmeans``:
    matmul, argmin, one-hot matmul) and the bound."""
    import torch

    from tpu_distalg_torch.ops import kmeans as kops
    from tpu_distalg_torch.ops import kmeans_kernels as kk

    n, dim = points.shape
    k = centers.shape[0]
    kw = dict(dim=dim, k=k)
    sums, counts = kk.fused_cluster_stats(X2, m2, centers, **kw)
    r_sums, r_counts = kk.cluster_stats_reference(X2, m2, centers, **kw)
    if not torch.equal(counts, r_counts):
        raise AssertionError(f"B10 main shape: counts {counts.tolist()} != "
                             f"{r_counts.tolist()}")
    err = _assert_close("B10 main shape", sums, r_sums, "random")

    def lib():
        return kops.cluster_stats(points, mask,
                                  kops.assign_clusters(points, centers), k)

    l_sums, l_counts = lib()
    lib_err = float((l_sums - r_sums).abs().max())
    nbytes = 4 * (X2.numel() + m2.numel() + 2 * k * dim + k)
    bound = _bound_ms(nbytes, 4 * n * k * dim)
    rec = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: kk.fused_cluster_stats(X2, m2, centers, **kw),
                    50, warm=5),
        plain_ms=_time_ms(lambda: kk.cluster_stats_reference(
            X2, m2, centers, **kw), 5, warm=1),
        library_ms=_time_ms(lib, 10, warm=2),
        bound_ms=bound[0], bound_by=bound[1])
    print(f"[kernels] kmeans B10 main shape ({n} points x {dim}, k={k}): "
          f"counts equal, sums max |err| {err!r} vs plain (largest sum "
          f"{float(r_sums.abs().max())!r}); kernel {rec['ms']!r} ms, plain "
          f"{rec['plain_ms']!r} ms, library {rec['library_ms']!r} ms (counts "
          f"equal: {torch.equal(l_counts, r_counts)}, max |err| "
          f"{lib_err!r}), bound {rec['bound_ms']!r} ms ({rec['bound_by']}, "
          f"{nbytes} bytes)")
    return rec


def _recovered(centers, want) -> tuple:
    """bench.py's recovery check (bench.py:2327-2332): which true mean
    each centre is nearest to, and the largest such distance."""
    d = np.linalg.norm(centers[:, None, :] - want[None, :, :], axis=-1)
    return sorted(d.argmin(axis=1).tolist()), float(d.min(axis=1).max())


def run_kmeans(dev, workdir: str) -> dict:
    """Phase 8: the kernel, then the k-means paths at bench.py's
    geometry, then the artifact. Returns the kernel's record and each
    path's launches."""
    import torch

    from tpu_distalg_torch import serve
    from tpu_distalg_torch.models import kmeans
    from tpu_distalg_torch.ops import kmeans as kops
    from tpu_distalg_torch.parallel import build_sharded, get_mesh
    from tpu_distalg_torch.utils import datasets

    check_kmeans_kernel_small(dev)
    mesh = get_mesh(data=1, device=dev)
    make_rows, true_centers = datasets.gaussian_mixture_rows(
        k=KM_K, dim=KM_DIM, seed=0, spread=KM_SPREAD)
    cfg = kmeans.KMeansConfig(k=KM_K, n_iterations=KM_ITERS, seed=0,
                              init="farthest")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps = build_sharded(mesh, KM_POINTS, make_rows)
    c0 = kmeans.init_centers_scaled(make_rows, KM_POINTS, cfg, dev)
    X2, m2 = kmeans.pack_device(mesh, ps.data, ps.mask, dim=KM_DIM, k=KM_K)
    torch.cuda.synchronize()
    print(f"[kmeans] data: {KM_POINTS} points x {KM_DIM} float32 "
          f"({ps.data.numel() * 4} bytes) from gaussian_mixture_rows(k="
          f"{KM_K}, seed=0, spread={KM_SPREAD}) on the card, farthest-point "
          f"init, packed as X2 {tuple(X2.shape)} (a view: "
          f"{X2.data_ptr() == ps.data.data_ptr()}); set-up "
          f"{time.perf_counter() - t0!r} s")
    rec = kmeans_kernel_record(dev, ps.data, X2, m2, ps.mask, c0)

    want = true_centers().numpy()
    fits = (("fused", kmeans.make_fit_fn_fused(mesh, cfg, KM_DIM),
             (X2, m2), KM_ITERS),
            ("torch ops", kmeans.make_fit_fn(mesh, cfg),
             (ps.data, ps.mask), 0))
    centers, rates, launches = {}, {}, {}
    for name, fit, args, n_launches in fits:
        first, _, _ = fit(*args, c0)                     # warm
        secs = []
        for _ in range(KM_REPEATS):
            torch.cuda.synchronize()
            _reset_launches()
            t1 = time.perf_counter()
            got, assign, n_run = fit(*args, c0)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            launches[name] = _launches()
            if launches[name]["fused_cluster_stats"] != n_launches:
                raise AssertionError(
                    f"k-means ({name}): fused_cluster_stats launched "
                    f"{launches[name]['fused_cluster_stats']} time(s), want "
                    f"{n_launches}")
            if name == "fused" and not torch.equal(first, got):
                raise AssertionError("k-means (fused): two runs on the card "
                                     "differ")
        found, worst = _recovered(got.cpu().numpy(), want)
        if (n_run != KM_ITERS or found != list(range(KM_K))
                or not worst < 0.1
                or assign.shape[0] != X2.shape[0] * (128 // KM_DIM)):
            raise AssertionError(
                f"k-means ({name}): {n_run} iterations, true means found "
                f"{found}, worst distance {worst} (want all {KM_K} within "
                f"0.1)")
        centers[name] = got
        rates[name] = KM_ITERS / min(secs)
        print(f"[kmeans] {name}: {KM_ITERS} iterations in {min(secs)!r} s "
              f"(best of {KM_REPEATS}; slowest {max(secs)!r} s) = "
              f"{rates[name]!r} iter/s; every true mean recovered, the "
              f"worst within {worst!r}; launches per run {launches[name]}"
              + ("; replay bitwise" if name == "fused" else ""))
    diff = float((centers["fused"] - centers["torch ops"]).abs().max())
    if not diff <= 1e-3:
        raise AssertionError(f"k-means: fused and torch-op centres differ "
                             f"by {diff} (want <= 1e-3)")
    print(f"[kmeans] fused vs torch-op centres after {KM_ITERS} iterations: "
          f"max |d| {diff!r} (held to 1e-3); fused is "
          f"{rates['fused'] / rates['torch ops']!r} x the torch-op path")

    cfg5 = kmeans.KMeansConfig(k=KM_K, n_iterations=KM_CHECK_ITERS)
    cut, cut_m = ps.data[:KM_CHECK_ROWS], ps.mask[:KM_CHECK_ROWS]
    card = kmeans.make_fit_fn_fused(mesh, cfg5, KM_DIM)(
        *kmeans.pack_device(mesh, cut, cut_m, dim=KM_DIM, k=KM_K), c0)[0]
    mesh_cpu = get_mesh(data=1, device="cpu")
    cpu = kmeans.make_fit_fn_fused(mesh_cpu, cfg5, KM_DIM)(
        *kmeans.pack_device(mesh_cpu, cut.cpu(), cut_m.cpu(), dim=KM_DIM,
                            k=KM_K), c0.cpu())[0]
    diff = float((card.cpu() - cpu).abs().max())
    if not diff <= 1e-4:
        raise AssertionError(f"k-means: card vs CPU centres after "
                             f"{KM_CHECK_ITERS} iterations on "
                             f"{KM_CHECK_ROWS} rows differ by {diff}")
    print(f"[kmeans] after {KM_CHECK_ITERS} iterations on the first "
          f"{KM_CHECK_ROWS} rows the card's centres (B10) are within 1e-4 "
          f"of the CPU port's (plain version): max |d| {diff!r}")

    host = ps.data[:KM_ARTIFACT_ROWS].cpu().numpy()
    res = kmeans.fit(host, mesh, kmeans.KMeansConfig(
        k=KM_K, n_iterations=10, seed=0), checkpoint_dir=workdir,
        checkpoint_every=5)
    server = serve.Server(mesh, serve.ServeConfig(max_batch=MAX_BATCH,
                                                  max_delay_ms=2.0))
    try:
        model = server.add_artifact(workdir)
        payloads = list(host[-KM_SERVED:])
        replies, info = serve.run_closed_loop(server, "kmeans", payloads,
                                              concurrency=CONCURRENCY)
        stats = server.emit_counters()
    finally:
        server.close()
    expect = kops.assign_clusters(ps.data[KM_ARTIFACT_ROWS - KM_SERVED:
                                          KM_ARTIFACT_ROWS], res.centers)
    if (info["ok"] != KM_SERVED or info["failed"] or model.kind != "kmeans"
            or not np.array_equal(np.stack(replies), expect.cpu().numpy())):
        raise AssertionError(f"k-means serving: {info}; replies differ from "
                             f"assign_clusters")
    print(f"[kmeans] fit({KM_ARTIFACT_ROWS} rows, 10 iterations, "
          f"checkpoint_dir) -> load_artifact -> Server: {info['ok']}/"
          f"{KM_SERVED} replies in {stats['batches']} micro-batches, each "
          f"equal to assign_clusters; {info['qps']!r} req/s, p50 "
          f"{stats['p50_ms']!r} ms, p99 {stats['p99_ms']!r} ms")
    return {"rec": rec, "launches": launches, "rates": rates}


# ------------------------------------------------------------ phase 10

#: bench.py's attention geometry (bench.py:3087-3240): heads, head dim,
#: tokens at one hop, the long context, and the emulated ring's shards
ATT_H, ATT_D, ATT_S, ATT_S_LONG, ATT_SHARDS = 8, 128, 32768, 131072, 4
#: H100 SXM data-sheet dense bf16 tensor-core peak, FLOP/s
BF16_FLOPS = 989.4e12
#: (name, H, H_kv, S_q, S_kv, d, causal, q_off, k_off, bq, bkv): GQA on
#: the diagonal (crossing tiles), every tile full, dead then crossing,
#: no mask with H = H_kv, a 136-row tail, head dims 256, 384 and 512 (GQA,
#: causal and crossing; past 256 the output columns split over blocks)
ATT_SMALL = (("diagonal", 8, 2, 256, 256, 128, True, 0, 0, 128, 128),
             ("full", 8, 2, 128, 256, 128, True, 512, 0, 128, 256),
             ("dead_crossing", 4, 2, 384, 256, 128, True, 0, 256, 128, 128),
             ("noncausal", 4, 4, 256, 384, 128, False, 0, 0, 256, 128),
             ("tail", 8, 2, 136, 256, 128, True, 120, 0, 136, 128),
             ("d256", 2, 1, 256, 256, 256, True, 64, 0, 128, 128),
             ("d384", 4, 2, 256, 256, 384, True, 0, 0, 128, 128),
             ("d512", 4, 2, 136, 384, 512, True, 200, 0, 136, 128))
#: the bf16 band (tests_tpu/test_tpu_numerics.py:161), and float32 sums
#: in another order, each of the largest |plain| entry
TOL.update({"attn_float32": 1e-5, "attn_bfloat16": 2e-2})


def _att_t(x, dev, dtype):
    import torch

    return torch.as_tensor(np.asarray(x, np.float32)).to(dev, dtype)


def _att_m(m):
    """m with the sentinel mapped to −inf: a row that has seen no key
    keeps −inf or takes −1e30 depending on the tiling."""
    import torch

    return torch.where(m <= -5e29, float("-inf"), m)


def _att_fwd_case(dev, case, dtype, kind):
    """B11 on one small case: the kernel, the plain version, a second
    block folded onto each one's state (carry-in), and a replay."""
    import torch

    from tpu_distalg_torch.ops import attention_kernels as ak

    _, h, h_kv, s_q, s_kv, d, causal, q_off, k_off, bq, bkv = case
    rng = np.random.default_rng(s_q + s_kv + d)
    f32 = torch.float32
    if kind == "exact":        # q = 0: P is 1 or 0, every sum an integer
        q = np.zeros((h, s_q, d))
        v = rng.integers(-3, 4, (h_kv, s_kv, d))
        k = rng.integers(-3, 4, (h_kv, s_kv, d))
        st = (rng.integers(-8, 9, (h, s_q, d)), np.zeros((h, s_q, 1)),
              rng.integers(1, 5, (h, s_q, 1)))
    else:
        q, k, v = (rng.normal(size=s) for s in
                   ((h, s_q, d), (h_kv, s_kv, d), (h_kv, s_kv, d)))
        st = (np.zeros((h, s_q, d)), np.full((h, s_q, 1), -np.inf),
              np.zeros((h, s_q, 1)))
    q, k, v = (_att_t(x, dev, dtype) for x in (q, k, v))
    st = tuple(_att_t(x, dev, f32) for x in st)
    kw = dict(scale=0.5 if kind == "exact" else d ** -0.5, causal=causal,
              bq=bq, bkv=bkv)
    tol = "exact" if kind == "exact" else f"attn_{str(dtype)[6:]}"
    errs = []
    got = ak.flash_attention_block(q, k, v, *st, q_off, k_off, **kw)
    want = ak.flash_attention_block_reference(q, k, v, *st, q_off, k_off,
                                              **kw)
    for step in ("", " carried"):
        if step:
            got = ak.flash_attention_block(q, k, v, *got, q_off, k_off + 64,
                                           **kw)
            want = ak.flash_attention_block_reference(
                q, k, v, *want, q_off, k_off + 64, **kw)
        gm, wm = _att_m(got[1]), _att_m(want[1])
        if not torch.equal(torch.isneginf(gm), torch.isneginf(wm)):
            raise AssertionError(f"B11 {case[0]} {dtype} {kind}{step}: "
                                 f"rows with no key differ")
        fin = ~torch.isneginf(wm)
        for name, a, b in (("o", got[0], want[0]), ("m", gm[fin], wm[fin]),
                           ("l", got[2], want[2])):
            errs.append(_assert_close(
                f"B11 {case[0]} {dtype} {kind} {name}{step}", a, b, tol))
    again = ak.flash_attention_block(q, k, v, *st, q_off, k_off, **kw)
    first = ak.flash_attention_block(q, k, v, *st, q_off, k_off, **kw)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"B11 {case[0]} {dtype} {kind}: replay differs")
    return max(errs)


def _att_bwd_case(dev, case, dtype, kind, bq=None, bkv=None, do_dtype=None):
    """B12 on one small case against its plain version, and a replay.
    "exact_q0"/"exact_k0": lse = 0 and q or k zero, integers elsewhere,
    scale 0.5, so every product and sum is exact; "random": N(0, 1)
    inputs with the lse and delta of their causal prefix."""
    import torch

    from tpu_distalg_torch.ops import attention_kernels as ak

    name, h, h_kv, s_q, s_kv, d, causal, q_off, k_off, fbq, fbkv = case
    rng = np.random.default_rng(s_q + 7 * s_kv + d)
    f32 = torch.float32
    if kind.startswith("exact"):
        q = rng.integers(-2, 3, (h, s_q, d))
        k = rng.integers(-2, 3, (h_kv, s_kv, d))
        if kind == "exact_q0":
            q = np.zeros_like(q)
        else:
            k = np.zeros_like(k)
        q, k, v = (_att_t(x, dev, dtype) for x in
                   (q, k, rng.integers(-2, 3, (h_kv, s_kv, d))))
        do = _att_t(rng.integers(-2, 3, (h, s_q, d)), dev, f32)
        lse = torch.zeros((h, s_q, 1), device=dev)
        delta = _att_t(rng.integers(-20, 21, (h, s_q, 1)), dev, f32)
        scale = 0.5
    else:
        scale = d ** -0.5
        q, k, v = (_att_t(rng.normal(size=s), dev, dtype) for s in
                   ((h, s_q, d), (h_kv, s_kv, d), (h_kv, s_kv, d)))
        st = (torch.zeros((h, s_q, d), device=dev),
              torch.full((h, s_q, 1), float("-inf"), device=dev),
              torch.zeros((h, s_q, 1), device=dev))
        kw = dict(scale=scale, causal=causal, bq=fbq, bkv=fbkv)
        st = ak.flash_attention_block_reference(q, k, v, *st, q_off, k_off,
                                                **kw)
        if causal:             # keys before every query: no row is empty
            st = ak.flash_attention_block_reference(
                q, k, v, *st, q_off, min(q_off, k_off) - s_kv, **kw)
        do = _att_t(rng.normal(size=(h, s_q, d)), dev, f32)
        lse = st[1] + torch.log(st[2])
        delta = (do * st[0] / st[2]).sum(-1, keepdim=True)
    if do_dtype is not None:
        do = do.to(do_dtype)
    kw = dict(scale=scale, causal=causal, bq=bq or fbq, bkv=bkv or fbkv)
    got = ak.flash_attention_backward_block(q, k, v, do, lse, delta, q_off,
                                            k_off, **kw)
    want = ak.flash_attention_backward_block_reference(
        q, k, v, do, lse, delta, q_off, k_off, **kw)
    tol = "exact" if kind.startswith("exact") else f"attn_{str(dtype)[6:]}"
    errs = [_assert_close(f"B12 {name} {dtype} {kind} {n}", a, b, tol)
            for n, a, b in zip(("dq", "dk", "dv"), got, want)]
    again = ak.flash_attention_backward_block(q, k, v, do, lse, delta,
                                              q_off, k_off, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"B12 {name} {dtype} {kind}: replay differs")
    return max(errs)


#: the attention library's kernels as cuobjdump names them (mangled, in
#: an anonymous namespace): the bf16 Hopper kernels at d = 128 (<true>:
#: the block's own operand resident) and past it, and the float32 ones
ATT_KERNELS = (("B11 bf16 d=128", "10fwd_hopperILb1E"),
               ("B11 bf16 d>128", "10fwd_hopperILb0E"),
               ("B12 dQ bf16 d=128", "9dq_hopperILb1E"),
               ("B12 dQ bf16 d>128", "9dq_hopperILb0E"),
               ("B12 dK/dV bf16 d=128", "10dkv_hopperILb1E"),
               ("B12 dK/dV bf16 d>128", "10dkv_hopperILb0E"),
               ("B11 float32", "7fwd_f32"), ("B12 dQ float32", "6dq_f32"),
               ("B12 dK/dV float32", "7dkv_f32"))


def attention_sass() -> dict:
    """Phase 10's build check: per kernel of the attention library, the
    HGMMA (wgmma) and UTMALDG (TMA load) instructions in its SASS and
    its registers and spill bytes (``cuobjdump -sass`` and
    ``-res-usage``, from the CUDA toolkit). Raises unless every bf16
    kernel issues HGMMA and UTMALDG."""
    from tpu_distalg_torch.ops import _native

    tool = os.path.join(os.path.dirname(_native.find_nvcc()), "cuobjdump")
    lib = _native._lib_path("attention")

    def dump(flag):
        return subprocess.run([tool, flag, lib], capture_output=True,
                              text=True, timeout=120, check=True).stdout

    def which(line):
        return next((name for name, key in ATT_KERNELS if key in line), None)

    out = {name: {"HGMMA": 0, "UTMALDG": 0} for name, _ in ATT_KERNELS}
    name = None
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            name = which(line)
        elif name is not None:
            out[name]["HGMMA"] += "HGMMA" in line
            out[name]["UTMALDG"] += "UTMALDG" in line
    name = None
    for line in dump("-res-usage").splitlines():
        if line.strip().startswith("Function "):
            name = which(line)
        elif name is not None and "REG:" in line:
            fields = dict(f.split(":", 1) for f in line.split()
                          if ":" in f and not f.startswith("CONSTANT"))
            out[name].update(registers=int(fields["REG"]),
                             stack_bytes=int(fields["STACK"]),
                             local_bytes=int(fields["LOCAL"]))
            name = None
    print(f"[attention] SASS of csrc/attention.cu per kernel (HGMMA = wgmma, "
          f"UTMALDG = TMA tile loads; registers a thread, stack and local "
          f"bytes = spills): {json.dumps(out)}")
    for name, c in out.items():
        if "bf16" in name and not (c["HGMMA"] and c["UTMALDG"]):
            raise AssertionError(f"{name}: no HGMMA or no UTMALDG in its SASS "
                                 f"({c}): not on the Hopper path")
    return out


def check_attention_small(dev) -> None:
    """Phase 10a: B11 and B12 against their plain versions on small
    cases — causal and not, GQA and H = H_kv, dead, full and crossing
    tiles, carry-in state, a 136-row tail, head dim 256, the S 384 /
    256-block halving, float32 and bf16 (with a float32 and a bf16 dO);
    exact cases bitwise, random ones within ``TOL``, every one replayed
    bit for bit."""
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        worst = {"B11": 0.0, "B12": 0.0}
        for case in ATT_SMALL:
            for kind in ("exact", "random"):
                worst["B11"] = max(worst["B11"],
                                   _att_fwd_case(dev, case, dtype, kind))
            for kind in ("exact_q0", "exact_k0", "random"):
                worst["B12"] = max(worst["B12"],
                                   _att_bwd_case(dev, case, dtype, kind))
        halving = ("halving", 1, 1, 384, 384, 128, True, 0, 0, 128, 128)
        worst["B12"] = max(worst["B12"], _att_bwd_case(
            dev, halving, dtype, "random", bq=256, bkv=256))
        if dtype == torch.bfloat16:
            worst["B12"] = max(worst["B12"], _att_bwd_case(
                dev, ATT_SMALL[0], dtype, "random", do_dtype=dtype))
        print(f"[kernels] attention {dtype}: B11 and B12 on "
              f"{len(ATT_SMALL)} cases ({', '.join(c[0] for c in ATT_SMALL)}"
              f") + carry-in + the 384/256 halving: exact cases bitwise, "
              f"random max |err| B11 {worst['B11']!r}, B12 "
              f"{worst['B12']!r} (bound {TOL['attn_' + str(dtype)[6:]]} of "
              f"the largest entry), replays bitwise")


def _att_qkv(dev, s: int, seed: int):
    """bench.py's operands: (S, 8, 128) bf16 N(0, 1), here from a seeded
    generator on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((s, ATT_H, ATT_D), generator=g, device=dev,
                             dtype=torch.bfloat16) for _ in range(3))


def _att_flops(s: int) -> float:
    """bench.py's causal forward count: S²/2 keys × d × H × 2 matmuls ×
    2."""
    return s * s / 2 * ATT_D * ATT_H * 4


def _att_rate(what, s, ms, flops):
    print(f"[attention] {what}: {ms!r} ms a call, {s / ms * 1e3!r} "
          f"tokens/s, {flops / ms / 1e9!r} TFLOP/s")


def _band(what, got, want) -> float:
    """The bf16 band: |got − want| <= 2e-2 + 2e-2·|want| entrywise."""
    import torch

    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs()
    if not bool((err <= 2e-2 + 2e-2 * want.abs()).all()):
        raise AssertionError(f"{what}: max |err| {float(err.max())!r} "
                             f"outside the bf16 band")
    return float(err.max())


#: The checks at the main shapes hold a tensor by its relative error
#: ||got − want|| / ||want|| (Frobenius) over each tile of ATT_TILE rows
#: along the sequence (every head and column of those rows), so the
#: limit follows the entries' own size: large in early rows (few keys)
#: and early keys, small over most of the sequence. The whole tensor's
#: error is never above its worst tile's. ATT_REL is 2.5 bf16 ulps
#: (2⁻⁷ each) of relative error.
ATT_TILE, ATT_REL = 64, 2e-2


def _att_rel(got, want, seq_dim) -> tuple[float, float]:
    """(whole tensor, worst tile) relative error of ``got`` against
    ``want``; a tile where ``want`` is 0 counts 0 if ``got`` is 0 there,
    else inf."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    diff = got - want

    def tiles(x):
        x = x.movedim(seq_dim, 0)
        return x.reshape(-1, ATT_TILE, *x.shape[1:]).flatten(1).norm(dim=1)

    dn, wn = tiles(diff), tiles(want)
    rel = torch.where(wn > 0, dn / wn, torch.where(dn > 0, float("inf"),
                                                   0.0))
    rel = torch.where(torch.isnan(rel), float("inf"), rel)
    return float(diff.norm() / want.norm()), float(rel.max())


def _att_close(what, got, want, seq_dim) -> float:
    """``got`` within ATT_REL of ``want`` on every tile; finite. Returns
    the worst tile's relative error."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    whole, worst = _att_rel(got, want, seq_dim)
    if not worst <= ATT_REL:
        raise AssertionError(f"{what}: relative error {worst!r} on its "
                             f"worst {ATT_TILE}-row tile (whole tensor "
                             f"{whole!r}) > {ATT_REL}")
    return worst


def _att_control(what, wrong, want, seq_dim) -> float:
    """A deliberately wrong result must fail the limit of ``_att_close``:
    the check's own control. Returns the worst tile's relative error."""
    whole, worst = _att_rel(wrong, want, seq_dim)
    if worst <= ATT_REL:
        raise AssertionError(f"control {what}: relative error {worst!r} "
                             f"(whole tensor {whole!r}) passes the limit "
                             f"{ATT_REL}; the check cannot see this fault")
    print(f"[attention] control {what}: worst-tile relative error "
          f"{worst!r}, whole tensor {whole!r} (limit {ATT_REL}): caught")
    return worst


def _att_counts() -> dict:
    got = _launches()
    return {"B11": got["flash_attention_block"],
            "B12": got["flash_attention_backward_block"]}


def _att_expect(what, want: dict) -> None:
    got = _launches()
    for name, n in want.items():
        if got[name] != n:
            raise AssertionError(
                f"{what}: {name} launched {got[name]} time(s), expected {n}")


def _fwd_bwd(mesh, q, k, v, **kw):
    """Σ out² through ``ring_attention`` and its three cotangents (all
    consumed, as bench.py:3173-3177 asks)."""
    import torch

    from tpu_distalg_torch.parallel import ring_attention

    qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = ring_attention(qq, kk, vv, mesh, causal=True, use_flash=True,
                         **kw)
    grads = torch.autograd.grad((out * out).sum(), (qq, kk, vv))
    return out.detach(), grads


def _att_plain_grads(q, k, v):
    """The gradients of Σ out² at one hop, causal, from the plain
    versions of B11 and B12 alone: (S, H, d) float32 each."""
    import torch

    from tpu_distalg_torch.ops import attention_kernels as ak

    qh, kh, vh = (x.permute(1, 0, 2).contiguous() for x in (q, k, v))
    h, s, d = qh.shape
    kw = dict(scale=d ** -0.5, causal=True)
    o, m, l = ak.flash_attention_block_reference(
        qh, kh, vh, torch.zeros((h, s, d), device=q.device),
        torch.full((h, s, 1), float("-inf"), device=q.device),
        torch.zeros((h, s, 1), device=q.device), 0, 0, **kw)
    out = o / l
    do = 2 * out
    grads = ak.flash_attention_backward_block_reference(
        qh, kh, vh, do, m + torch.log(l), (do * out).sum(-1, keepdim=True),
        0, 0, **kw)
    return tuple(g.permute(1, 0, 2) for g in grads)


def attention_kernel_records(dev, q, k, v) -> dict:
    """Phase 10c: B11 and B12 at the 32k one-hop shape against their
    plain versions, timed beside the plain version, SDPA (forward, and
    its autograd backward) and the bound."""
    import torch

    from tpu_distalg_torch.ops import attention_kernels as ak

    s, scale = q.shape[0], ATT_D ** -0.5
    qh, kh, vh = (x.permute(1, 0, 2).contiguous() for x in (q, k, v))
    st = (torch.zeros((ATT_H, s, ATT_D), device=dev),
          torch.full((ATT_H, s, 1), float("-inf"), device=dev),
          torch.zeros((ATT_H, s, 1), device=dev))
    kw = dict(scale=scale, causal=True)
    o, m, l = ak.flash_attention_block(qh, kh, vh, *st, 0, 0, **kw)
    ro, rm, rl = ak.flash_attention_block_reference(qh, kh, vh, *st, 0, 0,
                                                    **kw)
    out, ref = o / l, ro / rl
    rel = {n: _att_close(f"B11 32k {n}", a, b, 1) for n, a, b in
           (("o", o, ro), ("m", m, rm), ("l", l, rl), ("out", out, ref))}
    err_o = float((o - ro).abs().max())
    err = float((out - ref).abs().max())
    # controls: the forward stopped at half the keys; the first 128 keys
    # (the least K/V block JAX's checks take) dropped, so rows 0-127 see
    # no key
    half, cut = s // 2, 128
    ctl = {}
    for c, (kc, vc, k0) in (("half the keys", (kh[:, :half], vh[:, :half],
                                               0)),
                            ("first 128 keys dropped",
                             (kh[:, cut:], vh[:, cut:], cut))):
        wo, _, wl = ak.flash_attention_block(qh, kc, vc, *st, 0, k0,
                                             bkv=cut, **kw)
        ctl[c] = [_att_control(f"B11 32k {n}, {c}", a, b, 1)
                  for n, a, b in (("o", wo, ro), ("l", wl, rl))]
        del wo, wl
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qh[None], kh[None], vh[None], is_causal=True)[0]
    lib_err = float((lib_out.float() - ref).abs().max())
    flops = _att_flops(s)
    nbytes = 3 * qh.numel() * 2 + 2 * 4 * (o.numel() + m.numel() + l.numel())
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    b11 = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: ak.flash_attention_block(qh, kh, vh, *st, 0, 0,
                                                     **kw), 10, warm=2),
        plain_ms=_time_ms(lambda: ak.flash_attention_block_reference(
            qh, kh, vh, *st, 0, 0, **kw), 2, warm=1),
        library_ms=_time_ms(lambda: sdpa(qh[None], kh[None], vh[None],
                                         is_causal=True), 10, warm=2),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    print(f"[kernels] attention B11 at 32k (q, k, v {tuple(qh.shape)} "
          f"bf16, causal, one hop): worst {ATT_TILE}-row tile relative "
          f"error vs plain {rel!r} (limit {ATT_REL}; controls {ctl!r}), "
          f"o max |err| {err_o!r}, normalised out max |err| {err!r} "
          f"(SDPA vs plain {lib_err!r}); "
          f"kernel {b11['ms']!r} ms ({flops / b11['ms'] / 1e9!r} TFLOP/s), "
          f"plain {b11['plain_ms']!r} ms, SDPA {b11['library_ms']!r} ms, "
          f"bound {b11['bound_ms']!r} ms ({b11['bound_by']}: {flops!r} "
          f"FLOP, {nbytes} bytes)")

    lse = m + torch.log(l)
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    do = torch.randn(qh.shape, generator=g, device=dev)
    delta = (do * out).sum(-1, keepdim=True)
    got = ak.flash_attention_backward_block(qh, kh, vh, do, lse, delta, 0, 0,
                                            **kw)
    want = ak.flash_attention_backward_block_reference(
        qh, kh, vh, do, lse, delta, 0, 0, **kw)
    names = ("dq", "dk", "dv")
    rel = {n: _att_close(f"B12 32k {n}", a, b, 1)
           for n, a, b in zip(names, got, want)}
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    # controls: dK/dV from the first 64-row query tile only; dQ from the
    # first 128 keys only (the least K/V block JAX's checks take)
    tile, cut = ATT_TILE, 128
    _, wk, wv = ak.flash_attention_backward_block(
        qh[:, :tile], kh, vh, do[:, :tile], lse[:, :tile], delta[:, :tile],
        0, 0, **kw)
    ctl = {"dk, first query tile": _att_control(
        "B12 32k dk, first query tile only", wk, want[1], 1),
        "dv, first query tile": _att_control(
        "B12 32k dv, first query tile only", wv, want[2], 1)}
    del wk, wv
    wq = ak.flash_attention_backward_block(
        qh, kh[:, :cut], vh[:, :cut], do, lse, delta, 0, 0, **kw)[0]
    ctl["dq, first 128 keys"] = _att_control(
        "B12 32k dq, first 128 keys only", wq, want[0], 1)
    del wq
    lq, lk, lv = (x[None].detach().requires_grad_(True) for x in (qh, kh, vh))
    lout = sdpa(lq, lk, lv, is_causal=True)
    ldo = do[None].to(torch.bfloat16)

    def lib_bwd():
        return torch.autograd.grad(lout, (lq, lk, lv), ldo,
                                   retain_graph=True)

    lib_err = max(float((a[0].float() - b).abs().max())
                  for a, b in zip(lib_bwd(), want))
    nbytes = (3 * qh.numel() * 2 + 4 * (do.numel() + 2 * lse.numel())
              + 4 * 3 * qh.numel())
    t_ops, t_bytes = 2.5 * flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    b12 = dict(
        max_abs_err=max(errs),
        ms=_time_ms(lambda: ak.flash_attention_backward_block(
            qh, kh, vh, do, lse, delta, 0, 0, **kw), 5, warm=1),
        plain_ms=_time_ms(lambda: ak.flash_attention_backward_block_reference(
            qh, kh, vh, do, lse, delta, 0, 0, **kw), 1, warm=1),
        library_ms=_time_ms(lib_bwd, 5, warm=1),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    print(f"[kernels] attention B12 at 32k (dO float32; both passes): "
          f"worst {ATT_TILE}-row tile relative error vs plain {rel!r} "
          f"(limit {ATT_REL}; controls {ctl!r}); dq, "
          f"dk, dv max |err| {errs!r} (largest "
          f"{[float(w.abs().max()) for w in want]!r}; SDPA's backward vs "
          f"plain {lib_err!r}); kernel {b12['ms']!r} ms "
          f"({2.5 * flops / b12['ms'] / 1e9!r} TFLOP/s of the function's "
          f"5 tile matmuls; the two passes run 7), plain "
          f"{b12['plain_ms']!r} ms, SDPA backward {b12['library_ms']!r} ms, "
          f"bound {b12['bound_ms']!r} ms ({b12['bound_by']}: "
          f"{2.5 * flops!r} FLOP, {nbytes} bytes)")
    return {"B11": b11, "B12": b12}


def run_attention(dev) -> dict:
    """Phase 10: the small cases, then ring attention at bench.py's
    geometry through the port's entry points: one hop at 32k (flash
    forward; the torch-op path at kv_chunk 2048 beside it; forward +
    backward through the autograd.Function), an emulated 4-shard ring at
    32k (contiguous and zigzag, forward and gradients, against the one
    hop), one hop at 128k (forward, forward + backward), then the
    kernel records. Returns the records and each path's launches."""
    import torch

    from tpu_distalg_torch.parallel import (
        get_mesh,
        ring_attention,
        zigzag_inverse,
        zigzag_order,
    )

    sass = attention_sass()
    check_attention_small(dev)
    mesh1 = get_mesh(data=1, device=dev)
    mesh4 = get_mesh(data=ATT_SHARDS, device=dev)
    s = ATT_S
    q, k, v = _att_qkv(dev, s, SEED)
    flops = _att_flops(s)
    launches = {}
    b11, b12 = "flash_attention_block", "flash_attention_backward_block"

    _reset_launches()
    with torch.no_grad():
        out1 = ring_attention(q, k, v, mesh1, causal=True, use_flash=True)
    torch.cuda.synchronize()
    launches["32k forward"] = _att_counts()
    _att_expect("32k one-hop forward", {b11: 1, b12: 0})
    with torch.no_grad():
        ms = _time_ms(lambda: ring_attention(q, k, v, mesh1, causal=True,
                                             use_flash=True), 5, warm=1)
        _att_rate("32k one hop, flash forward", s, ms, flops)
        ref = ring_attention(q, k, v, mesh1, causal=True, kv_chunk=2048)
        what = "32k flash vs torch-op path (kv_chunk 2048)"
        err = _band(what, out1, ref)
        rel = _att_close(what, out1, ref, 0)
        med = float(ref.abs().median())
        ms_x = _time_ms(lambda: ring_attention(
            q, k, v, mesh1, causal=True, kv_chunk=2048), 2, warm=1)
    del ref
    print(f"[attention] 32k torch-op path at kv_chunk 2048: {ms_x!r} ms a "
          f"call ({flops / ms_x / 1e9!r} TFLOP/s); flash within the bf16 "
          f"band of it (max |err| {err!r}; median |out| {med!r}) and "
          f"within {ATT_REL} on every {ATT_TILE}-row tile (worst {rel!r})")

    _reset_launches()
    out_fb, grads1 = _fwd_bwd(mesh1, q, k, v)
    torch.cuda.synchronize()
    launches["32k forward + backward"] = _att_counts()
    _att_expect("32k one-hop forward + backward", {b11: 1, b12: 1})
    if not torch.equal(out_fb, out1):
        raise AssertionError("32k: the autograd.Function's forward differs "
                             "from the plain forward call")
    rel = {nm: _att_close(f"32k one-hop {nm} vs plain", g_, w, 0)
           for nm, g_, w in zip(("dq", "dk", "dv"), grads1,
                                _att_plain_grads(q, k, v))}
    print(f"[attention] 32k one-hop gradients of sum(out²) against the "
          f"plain B11 and B12 on the same inputs: worst {ATT_TILE}-row "
          f"tile relative error {rel!r} (limit {ATT_REL})")
    ms = _time_ms(lambda: _fwd_bwd(mesh1, q, k, v), 3, warm=1)
    _att_rate("32k one hop, flash forward + backward", s, ms, 3.5 * flops)

    # the emulated ring: offsets != 0, dK/dV travelling with their blocks
    n = ATT_SHARDS
    live = n * (n + 1) // 2
    _reset_launches()
    out4, grads4 = _fwd_bwd(mesh4, q, k, v)
    torch.cuda.synchronize()
    launches["32k 4-shard ring"] = _att_counts()
    _att_expect(f"32k {n}-shard ring forward + backward",
                {b11: live, b12: live})
    errs = [_att_close(f"32k {n}-shard ring {nm} vs one hop", a, b, 0)
            for nm, a, b in zip(("out", "dq", "dk", "dv"),
                                (out4, *grads4), (out1, *grads1))]
    ms = _time_ms(lambda: _fwd_bwd(mesh4, q, k, v), 2, warm=1)
    print(f"[attention] 32k emulated {n}-shard contiguous ring: {live} live "
          f"steps (B11 {live}, B12 {live} launches), out and gradients "
          f"within {ATT_REL} of the one hop on every {ATT_TILE}-row tile "
          f"(worst relative error {errs!r})")
    _att_rate(f"32k {n}-shard contiguous ring, flash forward + backward",
              s, ms, 3.5 * flops)
    del out4, grads4

    perm = torch.as_tensor(zigzag_order(n, s), device=dev)
    inv = torch.as_tensor(zigzag_inverse(n, s), device=dev)
    zig = n * (2 * n + 1)     # per shard: my + 1, n and n − my pairs
    _reset_launches()
    outz, gradsz = _fwd_bwd(mesh4, q[perm], k[perm], v[perm],
                            layout="zigzag")
    torch.cuda.synchronize()
    launches["32k 4-shard zigzag"] = _att_counts()
    _att_expect(f"32k {n}-shard zigzag forward + backward",
                {b11: zig, b12: zig})
    errs = [_att_close(f"32k {n}-shard zigzag {nm} vs one hop", a[inv], b,
                       0)
            for nm, a, b in zip(("out", "dq", "dk", "dv"),
                                (outz, *gradsz), (out1, *grads1))]
    ms = _time_ms(lambda: _fwd_bwd(mesh4, q[perm], k[perm], v[perm],
                                   layout="zigzag"), 2, warm=1)
    print(f"[attention] 32k emulated {n}-shard zigzag ring: {zig} chunk-pair "
          f"launches of B11 and of B12, out and gradients within "
          f"{ATT_REL} of the one hop on every {ATT_TILE}-row tile after "
          f"undoing the layout (worst relative error {errs!r})")
    _att_rate(f"32k {n}-shard zigzag ring, flash forward + backward", s, ms,
              3.5 * flops)
    del outz, gradsz, out1, grads1, out_fb

    recs = attention_kernel_records(dev, q, k, v)
    del q, k, v

    s_long = ATT_S_LONG
    ql, kl, vl = _att_qkv(dev, s_long, SEED + 1)
    _reset_launches()
    with torch.no_grad():
        out = ring_attention(ql, kl, vl, mesh1, causal=True, use_flash=True)
        torch.cuda.synchronize()
        launches["128k forward"] = _att_counts()
        _att_expect("128k forward", {b11: 1, b12: 0})
        ms = _time_ms(lambda: ring_attention(ql, kl, vl, mesh1, causal=True,
                                             use_flash=True), 2, warm=0)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("128k forward: non-finite values")
    _att_rate("128k one hop, flash forward", s_long, ms,
              _att_flops(s_long))
    del out
    _reset_launches()
    out, grads = _fwd_bwd(mesh1, ql, kl, vl)
    torch.cuda.synchronize()
    launches["128k forward + backward"] = _att_counts()
    _att_expect("128k forward + backward", {b11: 1, b12: 1})
    if not all(bool(torch.isfinite(x).all()) for x in (out, *grads)):
        raise AssertionError("128k forward + backward: non-finite values")
    del out, grads
    ms = _time_ms(lambda: _fwd_bwd(mesh1, ql, kl, vl), 1, warm=0)
    _att_rate("128k one hop, flash forward + backward", s_long, ms,
              3.5 * _att_flops(s_long))
    print(f"[attention] launches by path (B11, B12): {launches}")
    return {"recs": recs, "launches": launches, "sass": sass}


# ------------------------------------------------------------ phase 11

#: the local-update family at bench.py's MA geometry (bench.py:2248-2266):
#: phase 6's packed rows, rounds of local steps each, the rounds of the
#: card-against-CPU check, and the replica counts (bench.py's one chip,
#: the reference's n_slices = 4)
LOCAL_ROUNDS, LOCAL_L, LOCAL_CHECK_ROUNDS, LOCAL_REPLICAS = 300, 5, 5, (1, 4)
#: card against the CPU port after LOCAL_CHECK_ROUNDS rounds: bf16 rows,
#: held as B2 is over many steps (1e-3 of the largest entry); fused_train
#: against fused_gather after the full run, as phase 6 holds them
LOCAL_TOL, LOCAL_PATHS_TOL = 1e-3, 2e-2
#: the breast-cancer runs' bands (MA: the reference's golden 0.853801;
#: BMUF and EASGD: 0.929825), read over the last sixth of the rounds;
#: the card's mean there within LOCAL_MEAN_TOL of the CPU port's
LOCAL_BANDS = {"ma": 0.85, "bmuf": 0.92, "easgd": 0.92}
LOCAL_MEAN_TOL = 0.04


def _local_configs():
    from tpu_distalg_torch.models import bmuf, easgd, ma

    return {"ma": ma.MAConfig(), "bmuf": bmuf.BMUFConfig(),
            "easgd": easgd.EASGDConfig()}


def _local_timed(run, n_replicas: int, replica_bytes: int) -> dict:
    """One warm run, one on the host's clock ending in a synchronize
    (with every launch counter set to 0 just before it and read just
    after), one under the profiler (the device time). Rates count
    LOCAL_ROUNDS × LOCAL_L local steps a run (bench.py's metric step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_distalg_torch.tools.profiling import device_us

    run()
    torch.cuda.synchronize()
    _reset_launches()
    t1 = time.perf_counter()
    w, ws, _, _ = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _launches()
    if not (bool(torch.isfinite(w).all()) and bool(torch.isfinite(ws).all())):
        raise AssertionError("non-finite local-SGD models")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_op = device_us(prof)
    device = sum(by_op.values()) / 1e6
    steps = LOCAL_ROUNDS * LOCAL_L
    rate = steps / wall
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_s": wall, "local_steps_per_s": rate,
            "device_us_per_round_by_op": {
                k[:48]: v / LOCAL_ROUNDS for k, v in top},
            "replica_local_steps_per_s": n_replicas * rate,
            "device_s": device, "device_idle_share": 1.0 - device / wall,
            "bytes_per_local_step": n_replicas * replica_bytes,
            "hbm_share": n_replicas * replica_bytes * rate / HBM_BYTES_PER_S,
            "launches": launches, "w": w, "ws": ws}


def _local_tail(accs) -> tuple:
    tail = np.asarray(accs)[-(len(accs) // 6):]
    return float(tail.max()), float(tail.mean())


def run_local_sgd(dev, sg: dict) -> dict:
    """Phase 11: MA, BMUF and EASGD (``models/local_sgd.py``) on
    ``fused_train`` (B2: R launches a round) and ``fused_gather`` (B1: R·L
    launches a round) over phase 6's packed rows, on 1 and 4 emulated
    replicas; the card against the CPU port after 5 rounds on 4
    replicas; the breast-cancer task as bench.py runs it. Returns the
    launch counts of each timed run."""
    import dataclasses
    import warnings

    import torch

    from tpu_distalg_torch.models import local_sgd
    from tpu_distalg_torch.models.ssgd import fused_gather_geometry
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    X2, meta = sg["X2"], sg["meta"]
    D, d = meta["d_total"], meta["y_col"]
    X2_cpu = None
    out = {}
    for R in LOCAL_REPLICAS:
        mesh = get_mesh(data=R, device=dev)
        te = (torch.zeros((1, D), device=dev), torch.zeros((1,), device=dev))
        for name, preset in _local_configs().items():
            finals = {}
            for sampler in ("fused_train", "fused_gather"):
                cfg = dataclasses.replace(
                    preset, n_iterations=LOCAL_ROUNDS,
                    n_local_iterations=LOCAL_L, eval_test=False,
                    sampler=sampler, x_dtype="bfloat16", fused_pack=16,
                    gather_block_rows=SSGD_GBR, shuffle_seed=0)
                fn = local_sgd.make_train_fn_fused(mesh, cfg, meta)
                state = local_sgd.init_state(cfg, d, D, R, dev)
                n_s = fused_gather_geometry(cfg, meta, R)[1]
                replica_bytes = n_s * SSGD_GBR * D * X2.element_size()
                key = f"{name} {sampler} R={R}"
                if name == "ma":
                    rec = _local_timed(lambda: fn(X2, *te, *state), R,
                                       replica_bytes)
                    print(f"[local] {key}: {LOCAL_ROUNDS} rounds x {LOCAL_L} "
                          f"local steps in {rec['wall_s']!r} s = "
                          f"{rec['local_steps_per_s']!r} local steps/s "
                          f"({rec['replica_local_steps_per_s']!r} replica "
                          f"local steps/s); device {rec['device_s']!r} s, "
                          f"idle share {rec['device_idle_share']!r}; "
                          f"{rec['bytes_per_local_step']} bytes a local "
                          f"step, {rec['hbm_share']!r} of 3.35 TB/s; "
                          f"device µs a round by op (top 4) "
                          f"{rec['device_us_per_round_by_op']}; "
                          f"launches "
                          f"{ {k: v for k, v in rec['launches'].items() if v} }")
                else:
                    _reset_launches()
                    w, ws, _, _ = fn(X2, *te, *state)
                    torch.cuda.synchronize()
                    rec = {"launches": _launches(), "w": w, "ws": ws}
                    if not bool(torch.isfinite(ws).all()):
                        raise AssertionError(f"{key}: non-finite models")
                want = {"fused_train": ("fused_train_gathered",
                                        R * LOCAL_ROUNDS),
                        "fused_gather": ("fused_grad_sum_gathered",
                                         R * LOCAL_ROUNDS * LOCAL_L)}
                for path, (kernel, count) in want.items():
                    got = rec["launches"][kernel]
                    if got != (count if path == sampler else 0):
                        raise AssertionError(
                            f"{key}: {kernel} launched {got} time(s), want "
                            f"{count if path == sampler else 0}")
                finals[sampler] = (rec.pop("w"), rec.pop("ws"))
                out[key] = rec
                if R == 4:   # the card against the CPU port, 5 rounds
                    if X2_cpu is None:
                        X2_cpu = X2.cpu()
                    c5 = dataclasses.replace(cfg, n_iterations=LOCAL_CHECK_ROUNDS)
                    fn_card = local_sgd.make_train_fn_fused(mesh, c5, meta)
                    fn_cpu = local_sgd.make_train_fn_fused(
                        get_mesh(data=R, device="cpu"), c5, meta)
                    w_c, ws_c, _, _ = fn_card(X2, *te, *state)
                    w_h, ws_h, _, _ = fn_cpu(
                        X2_cpu, *(t.cpu() for t in te),
                        *(t.cpu() for t in state))
                    for label, got, want in (("w", w_c, w_h),
                                             ("ws", ws_c, ws_h)):
                        err = float((got.cpu() - want).abs().max())
                        if err > LOCAL_TOL * float(want.abs().max()):
                            raise AssertionError(
                                f"{key}: {label} card vs CPU after "
                                f"{LOCAL_CHECK_ROUNDS} rounds: max |err| "
                                f"{err}")
                    print(f"[local] {key}: card vs CPU port after "
                          f"{LOCAL_CHECK_ROUNDS} rounds: max |dw| "
                          f"{float((w_c.cpu() - w_h).abs().max())!r}, max "
                          f"|dws| {float((ws_c.cpu() - ws_h).abs().max())!r}"
                          f" (held to {LOCAL_TOL} of the largest entry)")
            (wt, wst), (wg, wsg) = finals["fused_train"], finals["fused_gather"]
            diff = max(float((wt - wg).abs().max()),
                       float((wst - wsg).abs().max()))
            if not (torch.allclose(wt, wg, rtol=LOCAL_PATHS_TOL,
                                   atol=LOCAL_PATHS_TOL)
                    and torch.allclose(wst, wsg, rtol=LOCAL_PATHS_TOL,
                                       atol=LOCAL_PATHS_TOL)):
                raise AssertionError(f"{name} R={R}: fused_train != "
                                     f"fused_gather: max |dw| {diff}")
            print(f"[local] {name} R={R}: fused_train vs fused_gather after "
                  f"{LOCAL_ROUNDS} rounds (bf16): max |dw| {diff!r}, max |w| "
                  f"{float(wg.abs().max())!r} (held to rtol/atol "
                  f"{LOCAL_PATHS_TOL}, as phase 6)")
    del X2_cpu

    data = datasets.breast_cancer_split()
    for name, preset in _local_configs().items():
        cfg = dataclasses.replace(preset, sampler="fused_train",
                                  gather_block_rows=64, fused_pack=4,
                                  shuffle_seed=0)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="fused_gather:")
            card = local_sgd.train(*data, get_mesh(data=1, device=dev), cfg)
            cpu = local_sgd.train(*data, get_mesh(data=1, device="cpu"), cfg)
        (cb, cm), (hb, hm) = (_local_tail(card.accs.cpu()),
                              _local_tail(cpu.accs))
        band = LOCAL_BANDS[name]
        if not (cb >= band and hb >= band and abs(cm - hm) <= LOCAL_MEAN_TOL):
            raise AssertionError(
                f"{name} breast cancer: tail best card {cb} / CPU {hb} (want "
                f">= {band}), tail mean card {cm} / CPU {hm} (want within "
                f"{LOCAL_MEAN_TOL})")
        print(f"[local] breast cancer, {name} fused_train (bench.py's "
              f"settings, 1 replica, {cfg.n_iterations} rounds): final acc "
              f"card {card.final_acc!r}, CPU {cpu.final_acc!r}; last "
              f"{cfg.n_iterations // 6} rounds best {cb!r} / {hb!r}, mean "
              f"{cm!r} / {hm!r} (band >= {band})")
    return out


# ------------------------------------------------------------ phase 12

#: Monte Carlo: darts on one shard in chunks (bench.py's chunk), the
#: chunks compared bitwise with the CPU port, and the 5σ band on π
#: (σ = 4·√(p(1−p)/n), p = π/4: 5.0e-5 at 2³⁰ darts)
MC_DARTS, MC_CHUNK, MC_CHECK_CHUNKS, MC_BAND = 1 << 30, 1 << 20, 8, 2.5e-4
#: the closure at bench.py's geometry (bench.py:1102-1213): the parity
#: DAG, the scale DAG (count pinned to the host DP) and the Erdős–Rényi
#: graph of the dense path. bench.py's V = 6200 closes to 8,722,362
#: paths, under its own 10⁷ floor (its check would raise "grow
#: CLOSURE_V"), so the scale DAG also runs at CLOSURE_FLOOR_V, the
#: least multiple of 100 whose closure clears it (10,316,480 paths)
CLOSURE_PARITY, CLOSURE_SCALE, CLOSURE_MIN_PATHS, CLOSURE_ER = (
    (120, 5, 1), (6200, 8, 0), 10_000_000, 4096)
CLOSURE_FLOOR_V = 6800
#: the `fixed` sampler on phase 6's float32 rows; the breast-cancer run
#: on 8 emulated shards, read over its last steps (its float32 histories
#: part from the JAX package's at step 401 on the CPU, and both end at
#: 0.918 there)
FIXED_SHARDS, FIXED_TAIL, FIXED_TAIL_MEANS = 8, 200, 0.03
#: the 100M-row scale path as bench.py's _bench_ssgd_scale runs it
#: (bench.py:2166-2232), its expected geometry, and the held-out floor
#: (the task's Bayes rate is about 0.78)
SCALE_ROWS, SCALE_FEATURES, SCALE_GBR, SCALE_STEPS, SCALE_REPEATS = (
    100_000_000, 30, 131072, 500, 3)
SCALE_N_PADDED, SCALE_BLOCKS, SCALE_SAMPLED = 100_007_936, 763, 76
SCALE_X2_BYTES, SCALE_HELDOUT, SCALE_ACC_FLOOR = 8_000_634_880, 4096, 0.70
#: synthetic rows, card against the CPU port: float32 X within 1e-6
#: (absolute and relative) plus 4 ulp of the uniform carried through
#: erfinv's slope (√(π/2)·exp(v²/2): a one-ulp difference of x² near
#: |u| = 1 moves v by up to ~3e-4); y exact on rows whose margin is
#: above 1e-4, the others exempt and counted
ROW_TOL, ROW_UNIFORM_ULPS, ROW_MARGIN = 1e-6, 4, 1e-4


def _peak_rss_gb() -> float:
    """The host's peak resident set so far (``ru_maxrss``, the kernel's
    high-water mark VmHWM, in KB on Linux), GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _row_tol(v):
    """ROW_TOL's bound for float32 normals ``v`` (numpy)."""
    slope = np.sqrt(np.pi / 2) * np.exp(np.minimum(v.astype(np.float64) ** 2
                                                   / 2, 80.0))
    return ROW_TOL * (1 + np.abs(v)) + ROW_UNIFORM_ULPS * 2.0**-24 * slope


def _check_rows(what, X_card, y_card, X_cpu, y_cpu, margin) -> int:
    """Card rows against the CPU port's: X within _row_tol, y exact
    apart from rows of |margin| <= ROW_MARGIN; returns the exempt
    count."""
    Xc, Xh = X_card.cpu().numpy(), X_cpu.numpy()
    bad = np.abs(Xc - Xh) > _row_tol(Xh)
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} entries of X off "
                             f"by more than the tolerance (max |err| "
                             f"{float(np.abs(Xc - Xh).max())})")
    exempt = np.abs(margin.numpy()) <= ROW_MARGIN
    diff = y_card.cpu().numpy() != y_cpu.numpy()
    if (diff & ~exempt).any():
        raise AssertionError(f"{what}: {int((diff & ~exempt).sum())} labels "
                             f"differ outside the exempt rows")
    return int(exempt.sum())


def _run_mc(dev) -> dict:
    import math

    import torch

    from tpu_distalg_torch.models import monte_carlo
    from tpu_distalg_torch.ops import sampling
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import prng

    cfg = monte_carlo.MonteCarloConfig(n=MC_DARTS, chunk=MC_CHUNK)
    mesh = get_mesh(data=1, device=dev)
    monte_carlo.estimate_pi(get_mesh(data=1, device=dev),
                            monte_carlo.MonteCarloConfig(n=MC_CHUNK))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pi, n_used = monte_carlo.estimate_pi(mesh, cfg)
    secs = time.perf_counter() - t0
    if n_used != MC_DARTS or not abs(pi - math.pi) <= MC_BAND:
        raise AssertionError(f"mc: pi {pi!r} from {n_used} darts (want "
                             f"within {MC_BAND} of pi from {MC_DARTS})")
    n = MC_CHECK_CHUNKS * MC_CHUNK
    card = sampling.mc_circle_hits_chunked(
        prng.fold_in(prng.root_key(cfg.seed, dev), 0), n, MC_CHUNK)
    cpu = sampling.mc_circle_hits_chunked(
        prng.fold_in(prng.root_key(cfg.seed), 0), n, MC_CHUNK)
    if not torch.equal(card.cpu(), cpu):
        raise AssertionError(f"mc: the first {MC_CHECK_CHUNKS} chunks' hits "
                             f"differ, card {card.tolist()} CPU "
                             f"{cpu.tolist()}")
    print(f"[mc] {n_used} darts on one shard in chunks of {MC_CHUNK}: pi "
          f"{pi!r} (|err| {abs(pi - math.pi)!r} <= {MC_BAND}, 5 sigma) in "
          f"{secs!r} s = {n_used / secs!r} darts/s; the first "
          f"{MC_CHECK_CHUNKS} chunks' hits equal the CPU port's bit for bit")
    return {"pi": pi, "seconds": secs, "darts_per_s": n_used / secs}


def _closure_pairs(res) -> set:
    return set(map(tuple, np.asarray(res.paths).tolist()))


def _dense_pairs(res, V) -> set:
    return set(zip(*np.nonzero(res.paths.cpu().numpy()[:V, :V])))


def _run_closure(dev) -> dict:
    import torch

    from tpu_distalg_torch.models import transitive_closure as tc
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    mesh, cpu = get_mesh(data=1, device=dev), get_mesh(data=1, device="cpu")
    V, deg, seed = CLOSURE_PARITY
    pe = datasets.closure_dag_edges(V, deg, seed=seed)
    dense = tc.run(pe, mesh, n_vertices=V)
    sparse = tc.run_sparse_auto(pe, mesh, n_vertices=V)
    sparse_cpu = tc.run_sparse_auto(pe, cpu, n_vertices=V)
    dense_cpu = tc.run(pe, cpu, n_vertices=V)
    if not (_dense_pairs(dense, V) == _closure_pairs(sparse)
            and np.array_equal(sparse.paths, sparse_cpu.paths)
            and torch.equal(dense.paths.cpu(), dense_cpu.paths)
            and dense.n_rounds == dense_cpu.n_rounds
            and sparse.n_rounds == sparse_cpu.n_rounds):
        raise AssertionError(f"closure parity graph (V={V}): dense "
                             f"{dense.n_paths}, sparse {sparse.n_paths}, CPU "
                             f"{sparse_cpu.n_paths} paths differ")
    print(f"[closure] parity DAG V={V}: dense and run_sparse_auto give the "
          f"same {sparse.n_paths} pairs ({dense.n_rounds} / "
          f"{sparse.n_rounds} rounds), both equal to the CPU port's")

    _, deg, seed = CLOSURE_SCALE
    scale = {}
    for V in (CLOSURE_SCALE[0], CLOSURE_FLOOR_V):
        scale[V] = _closure_scale(dev, mesh, V, deg, seed)
    if scale[CLOSURE_FLOOR_V]["n_paths"] < CLOSURE_MIN_PATHS:
        raise AssertionError(f"closure task too small at V="
                             f"{CLOSURE_FLOOR_V}: "
                             f"{scale[CLOSURE_FLOOR_V]['n_paths']} paths")

    er = datasets.erdos_renyi_edges(CLOSURE_ER, 2.0)
    tc.run(er, mesh)                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = tc.run(er, mesh)
    dense_s = time.perf_counter() - t0
    er_sparse = tc.run_sparse_auto(er, mesh)
    if dense.n_paths != er_sparse.n_paths:
        raise AssertionError(f"closure ER V={CLOSURE_ER}: dense "
                             f"{dense.n_paths} != sparse {er_sparse.n_paths}")
    # a V x V 0/1 product (the closure's own matrix) in bf16, the port's
    # choice on the card, against float32: the same mask, and their times
    ops = {dt: dense.paths.to(dt) for dt in (torch.bfloat16, torch.float32)}
    masks = {dt: (o @ o) > 0 for dt, o in ops.items()}
    if not torch.equal(masks[torch.bfloat16], masks[torch.float32]):
        raise AssertionError("closure: bf16 and float32 products differ")
    prod_ms = {str(dt).split(".")[1]: _time_ms(lambda o=o: (o @ o) > 0, 20)
               for dt, o in ops.items()}
    print(f"[closure] dense run on Erdos-Renyi V={CLOSURE_ER}, average "
          f"degree 2: {dense.n_paths} paths (= run_sparse_auto's) in "
          f"{dense.n_rounds} rounds, {dense_s!r} s = "
          f"{dense_s / dense.n_rounds!r} s a round; the round's product "
          f"(V x V, 0/1) in ms: {prod_ms}, the same mask")
    return scale


def _closure_scale(dev, mesh, V: int, deg: int, seed: int) -> dict:
    """The forward random DAG of V vertices through ``run_sparse_auto``
    from 1.1× the host DP's count, as bench.py runs it: the count equal
    to the DP's, paths/s, rounds and regrows, and one run under the
    profiler."""
    import torch

    from tpu_distalg_torch.models import transitive_closure as tc
    from tpu_distalg_torch.telemetry import events as tevents
    from tpu_distalg_torch.tools.profiling import window
    from tpu_distalg_torch.utils import datasets

    edges = datasets.closure_dag_edges(V, deg, seed=seed)
    t0 = time.perf_counter()
    want = datasets.closure_host_count(V, edges)
    host_s = time.perf_counter() - t0

    def scale():
        return tc.run_sparse_auto(edges, mesh, n_vertices=V,
                                  start_capacity=int(want * 1.1))

    scale()                                            # warm
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tel-") as tel:
        sink = tevents.configure(tel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = scale()
        secs = time.perf_counter() - t0
        regrows = sink.counters().get("closure.capacity_regrows", 0)
        tevents.configure(False)
    if res.n_paths != want:
        raise AssertionError(f"closure V={V}: {res.n_paths} paths != host "
                             f"DP {want}")
    prof = window(scale, 1)
    print(f"[closure] scale DAG V={V}, degree {deg}, {len(edges)} edges: "
          f"run_sparse_auto(start_capacity={int(want * 1.1)}) found "
          f"{res.n_paths} paths (= the host DP's, {host_s!r} s on the host) "
          f"in {res.n_rounds} rounds, {regrows} regrow(s), {secs!r} s = "
          f"{res.n_paths / secs!r} paths/s; a run on the host's clock and "
          f"under the profiler (µs): {json.dumps(prof)}")
    return {"n_paths": res.n_paths, "paths_per_s": res.n_paths / secs,
            "rounds": res.n_rounds, "regrows": regrows, **prof}


def _run_fixed(dev, X, y) -> dict:
    import torch

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.ops import sampling
    from tpu_distalg_torch.parallel import get_mesh, parallelize
    from tpu_distalg_torch.utils import datasets, prng

    mesh = get_mesh(data=1, device=dev)
    cfg = ssgd.SSGDConfig(n_iterations=SSGD_STEPS, eval_test=False,
                          sampler="fixed")
    Xs, ys = parallelize(X, mesh), parallelize(y, mesh)
    fn = ssgd.make_train_fn(mesh, cfg, Xs.n_padded)
    n_local = Xs.n_padded
    b_local = max(1, round(cfg.mini_batch_fraction * n_local))
    for t in range(3):
        card = sampling.fixed_row_ids(prng.root_key(cfg.seed, dev), t, 1,
                                      n_local, b_local)
        cpu = sampling.fixed_row_ids(prng.root_key(cfg.seed), t, 1, n_local,
                                     b_local)
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"fixed: step {t}'s row ids differ from the "
                                 f"CPU port's")
    d = X.shape[1]
    w0 = ssgd.logistic.init_weights(prng.root_key(cfg.init_seed, dev), d)
    te = (torch.zeros((1, d), device=dev), torch.zeros((1,), device=dev))

    def run():
        return fn(Xs.data, ys.data, Xs.mask, *te, w0)

    run()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    w, _ = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in _launches().items() if v}
    if launches or not bool(torch.isfinite(w).all()):
        raise AssertionError(f"fixed: launches {launches} (want none), "
                             f"finite {bool(torch.isfinite(w).all())}")
    rate = SSGD_STEPS / secs
    step_bytes = b_local * d * 4
    print(f"[ssgd] fixed on phase 6's float32 rows ({n_local} x {d}, "
          f"{b_local} rows a step): {SSGD_STEPS} steps in {secs!r} s = "
          f"{rate!r} steps/s; {step_bytes} bytes/step of gathered rows, "
          f"{step_bytes * rate / HBM_BYTES_PER_S!r} of 3.35 TB/s; steps 0-2's "
          f"row ids equal the CPU port's; no kernel launched (the JAX "
          f"package's fixed sampler runs none)")

    data = datasets.breast_cancer_split()
    cfg = ssgd.SSGDConfig(sampler="fixed")
    card = ssgd.train(*data, get_mesh(data=FIXED_SHARDS, device=dev), cfg)
    cpu = ssgd.train(*data, get_mesh(data=FIXED_SHARDS, device="cpu"), cfg)
    tc_, th = card.accs.cpu().numpy()[-FIXED_TAIL:], \
        cpu.accs.numpy()[-FIXED_TAIL:]
    if not (tc_.max() >= SSGD_BAND and th.max() >= SSGD_BAND
            and abs(float(tc_.mean()) - float(th.mean())) <= FIXED_TAIL_MEANS):
        raise AssertionError(
            f"fixed breast cancer on {FIXED_SHARDS} shards: last "
            f"{FIXED_TAIL} steps best card {tc_.max()} / CPU {th.max()} "
            f"(want >= {SSGD_BAND}), mean {tc_.mean()} / {th.mean()} (want "
            f"within {FIXED_TAIL_MEANS})")
    print(f"[ssgd] breast cancer, fixed on {FIXED_SHARDS} emulated shards, "
          f"{cfg.n_iterations} steps: final acc card {card.final_acc!r}, CPU "
          f"{cpu.final_acc!r} (the JAX package 0.918129 on the CPU); last "
          f"{FIXED_TAIL} steps best {float(tc_.max())!r} / "
          f"{float(th.max())!r}, mean {float(tc_.mean())!r} / "
          f"{float(th.mean())!r}")
    return {"steps_per_s": rate, "final_acc": card.final_acc}


def _scale_b1_record(dev, X2, w, meta, ids_all) -> dict:
    """B1 at the scale shape against its plain version, timed over the
    trainer's draws in turn beside the library line and the bound."""
    import torch

    from tpu_distalg_torch.ops import ssgd_kernels as tk
    from tpu_distalg_torch.tools.ssgd_gathered_timing import rotating_ms

    D, yc, vc = meta["d_total"], meta["y_col"], meta["v_col"]
    kw = dict(pack=meta["pack"], d_total=D, y_col=yc, v_col=vc,
              gather_block_rows=SCALE_GBR)
    ids1 = ids_all[0]
    g, c = tk.fused_grad_sum_gathered(X2, w, ids1, **kw)
    gr, cr = tk.grad_sum_gathered_reference(X2, w, ids1, **kw)
    if float(c) != float(cr):
        raise AssertionError(f"B1 scale shape: count {c} != {cr}")
    err = _assert_close("B1 scale shape", g[:yc], gr[:yc], "random")
    g2, _ = tk.fused_grad_sum_gathered(X2, w, ids1, **kw)
    if not torch.equal(g, g2):
        raise AssertionError("B1 scale shape: two calls differ")
    blocks = X2.reshape(-1, SCALE_GBR, D)
    wq = w.to(X2.dtype)

    def lib1(ids):
        x = torch.index_select(blocks, 0, ids).reshape(-1, D)
        r = (torch.sigmoid(torch.mv(x, wq).float()) - x[:, yc].float()) \
            * x[:, vc].float()
        return torch.mv(x.T, r.to(x.dtype)).float(), x[:, vc].float().sum()

    n_s = ids1.shape[0]
    rows = n_s * SCALE_GBR
    step_bytes = rows * D * X2.element_size()
    bound = _bound_ms(step_bytes + 4 * (n_s + D + D + 1), 4 * rows * D)
    b1 = rotating_ms(lambda d: tk.fused_grad_sum_gathered(X2, w, d, **kw),
                     list(ids_all[:50]))
    lib = rotating_ms(lib1, list(ids_all[:20].long()))
    return {"scale_max_abs_err": err, "scale_ms": b1["device_ms"],
            "scale_wall_ms": b1["wall_ms"],
            "scale_plain_ms": _time_ms(lambda: tk.grad_sum_gathered_reference(
                X2, w, ids1, **kw), 5, 1),
            "scale_library_ms": lib["device_ms"],
            "scale_bound_ms": bound[0], "scale_bound_by": bound[1],
            "scale_bytes_per_call": step_bytes}


def _run_scale(dev) -> dict:
    import torch

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.ops import sampling
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.tools.profiling import window
    from tpu_distalg_torch.utils import datasets, metrics, prng

    mesh = get_mesh(data=1, device=dev)
    cfg = ssgd.SSGDConfig(
        n_iterations=SCALE_STEPS, eval_test=False, x_dtype="bfloat16",
        sampler="fused_gather", gather_block_rows=SCALE_GBR, init_seed=7)
    torch.cuda.synchronize()
    rss0 = _peak_rss_gb()
    t0 = time.perf_counter()
    fn, X2, w0, meta = ssgd.prepare_fused_synthetic(
        SCALE_ROWS, SCALE_FEATURES, mesh, cfg)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    rss_gb = _peak_rss_gb() - rss0
    n_blocks, n_s = ssgd.fused_gather_geometry(cfg, meta, 1)
    x2_bytes = X2.numel() * X2.element_size()
    if (meta["n_padded"], n_blocks, n_s, x2_bytes) != (
            SCALE_N_PADDED, SCALE_BLOCKS, SCALE_SAMPLED, SCALE_X2_BYTES):
        raise AssertionError(f"scale geometry: n_padded {meta['n_padded']}, "
                             f"{n_blocks} blocks, {n_s} sampled, {x2_bytes} "
                             f"bytes")
    if not rss_gb < 1.0:
        raise AssertionError(f"scale: host peak RSS grew {rss_gb} GB")
    D = meta["d_total"]
    step_bytes = n_s * SCALE_GBR * D * X2.element_size()
    print(f"[scale] {SCALE_ROWS} rows x {SCALE_FEATURES} features made on the "
          f"card in {gen_s!r} s (host peak RSS, ru_maxrss, +{rss_gb!r} GB): X2 "
          f"{tuple(X2.shape)} {X2.dtype} = {x2_bytes} bytes, {X2.numel()} "
          f"elements; {n_blocks} blocks of {SCALE_GBR} rows, {n_s} sampled a "
          f"step = {step_bytes} bytes/step (bound "
          f"{step_bytes / HBM_BYTES_PER_S * 1e3!r} ms at 3.35 TB/s)")

    # the card's rows against the CPU port's generator
    make_rows = datasets.synthetic_two_class_rows(SCALE_FEATURES, 0)
    rows = X2.view(-1, D)
    exempt = 0
    for lo in (0, SCALE_ROWS - 4096):
        ids = torch.arange(lo, lo + 4096, dtype=torch.int64)
        Xh, yh = make_rows(ids)
        Xc, yc = make_rows(ids.to(dev))
        w_true = prng.normal(prng.fold_in(prng.root_key(0), 0),
                             (SCALE_FEATURES,))
        noise = prng.logistic(prng.fold_in(prng.fold_in(
            prng.fold_in(prng.root_key(0), 1), ids), 7), ())
        margin = Xh @ w_true * float(2.0 / np.sqrt(np.float32(30))) + noise
        exempt += _check_rows(f"scale rows from {lo}", Xc, yc, Xh, yh, margin)
        packed = rows[lo:lo + 4096].float()
        if not (torch.equal(packed[:, :SCALE_FEATURES],
                            Xc.to(X2.dtype).float())
                and torch.equal(packed[:, meta["y_col"]], yc)
                and bool((packed[:, SCALE_FEATURES] == 1).all())
                and bool((packed[:, meta["v_col"]] == 1).all())
                and bool((packed[:, meta["v_col"] + 1:] == 0).all())):
            raise AssertionError(f"scale: packed rows from {lo} are not the "
                                 f"generator's")
    pad = rows[SCALE_ROWS:].float()
    if not bool((pad[:, meta["v_col"]] == 0).all()):
        raise AssertionError("scale: a padding row is valid")
    print(f"[scale] rows 0-4095 and the last 4096 valid rows: the card's X "
          f"within the stated tolerance of the CPU port's, y equal ({exempt} "
          f"rows of |margin| <= {ROW_MARGIN} exempt); packed bias, y, valid "
          f"and padding columns exact; padding rows invalid")

    te = (torch.zeros((1, D), device=dev), torch.zeros((1,), device=dev))

    def run():
        return fn(X2, None, None, *te, w0)

    run()
    torch.cuda.synchronize()
    _reset_launches()
    w, _ = run()
    torch.cuda.synchronize()
    launches = _launches()
    if launches["fused_grad_sum_gathered"] != SCALE_STEPS:
        raise AssertionError(f"scale: B1 launched "
                             f"{launches['fused_grad_sum_gathered']} times, "
                             f"want {SCALE_STEPS}")
    rates = []
    for _ in range(SCALE_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w2, _ = run()
        torch.cuda.synchronize()
        rates.append(SCALE_STEPS / (time.perf_counter() - t0))
        if not torch.equal(w2, w):
            raise AssertionError("scale: two runs on the card differ")
    best = max(rates)
    prof = window(run, SCALE_STEPS)
    d = SCALE_FEATURES + 1
    ids = torch.arange(SCALE_ROWS, SCALE_ROWS + SCALE_HELDOUT,
                       dtype=torch.int64, device=dev)
    X_ho, y_ho = make_rows(ids)
    X_ho = torch.cat([X_ho, torch.ones((SCALE_HELDOUT, 1), device=dev)], 1)
    acc = float(metrics.binary_accuracy(X_ho @ w[:d], y_ho))
    if not acc >= SCALE_ACC_FLOOR:
        raise AssertionError(f"scale: held-out accuracy {acc} < "
                             f"{SCALE_ACC_FLOOR}")
    share = step_bytes * best / HBM_BYTES_PER_S
    print(f"[scale] fused_gather, {SCALE_STEPS} steps: best of "
          f"{SCALE_REPEATS} {best!r} steps/s (all {rates}), {share!r} of "
          f"3.35 TB/s; B1 launched {launches['fused_grad_sum_gathered']} "
          f"times; a run on the host's clock and under the profiler (µs a "
          f"step): {json.dumps(prof)}; held-out accuracy on {SCALE_HELDOUT} "
          f"fresh rows {acc!r} (>= {SCALE_ACC_FLOOR}); two runs bit for bit")
    key = prng.root_key(cfg.seed, dev)
    ids_all = sampling.sample_block_ids(
        prng.fold_in(key, torch.arange(SCALE_STEPS, device=dev)), 1,
        n_blocks, n_s).reshape(SCALE_STEPS, n_s).contiguous()
    rec = _scale_b1_record(dev, X2, w0, meta, ids_all)
    print(f"[scale] B1 at the scale shape (rows of {D} bf16, blocks of "
          f"{SCALE_GBR} rows, X2 past 2**31 elements): {json.dumps(rec)}")
    return {"rec": rec, "launches": launches["fused_grad_sum_gathered"],
            "steps_per_s": best, "rates": rates, "hbm_share": share,
            "heldout_acc": acc, "generation_s": gen_s, "rss_gb": rss_gb,
            **prof}


def run_rest(dev, sg: dict) -> dict:
    """Phase 12: the rest of the reference's workloads (Monte Carlo, the
    transitive closure) and SSGD's last data paths (``fixed`` on phase
    6's rows, the 100M-row synthesis through B1). Each driven with the
    launch counters set to 0 just before it and read just after."""
    out = {}
    for name, run in (("mc", lambda: _run_mc(dev)),
                      ("closure", lambda: _run_closure(dev)),
                      ("fixed", lambda: _run_fixed(dev, sg["X"], sg["y"]))):
        _reset_launches()
        out[name] = run()
        launches = {k: v for k, v in _launches().items() if v}
        if launches:
            raise AssertionError(f"{name}: launched {launches}; the JAX "
                                 f"package runs this path in no kernel")
    out["scale"] = _run_scale(dev)
    return out


# ------------------------------------------------------------ phase 13

#: the sync layer at bench.py's SSGD geometry on its canonical comm mesh
#: (bench.py:90-104, COMM_CANONICAL_SHARDS = 4 emulated data shards):
#: phase 6's packed rows, 3 of 32 blocks a shard a step
SYNC_SHARDS = 4
SYNC_SCHEDULES = ("dense", "bucketed", "hier", "bf16", "int8", "int8@seq",
                  "topk:0.01")
#: steps a schedule's timed run (bench.py: 1500; cut for the script's
#: time, PERF.md §4: 500 in PRs 19–21, 250 since PR 22), steps a profiled
#: run (device time and ops a step), syncs a timed reduce, and the steps
#: of the card-against-CPU check
SYNC_STEPS = 250
SYNC_PROFILE_STEPS, SYNC_REDUCE_CALLS, SYNC_CHECK_STEPS = 200, 100, 5
#: card against the CPU port after SYNC_CHECK_STEPS steps, of the largest
#: |w|: B1 and its plain version add in other orders (phase 11's
#: standard); int8 and topk also round or select on those sums, and one
#: flipped stochastic-rounding code moves an entry by n·scale·η/count
SYNC_TOL, SYNC_TOL_ROUNDED = 1e-3, 1e-2
#: bench.py's comparison task (bench.py:425-519): 4096/1024 rows of the
#: normalised two-class task + bias, 1500 iterations on `bernoulli`; the
#: band: every schedule's final accuracy within COMPARE_HALF_BAND of
#: the JAX package's dense 0.765625 (its schedules span 0.764648 to
#: 0.767578 on the CPU, and the port's equal them, tests/test_torch_comms.py)
COMPARE_SCHEDULES = ("dense", "bucketed", "bf16", "int8", "topk", "hier")
COMPARE_ITERS, COMPARE_CENTRE, COMPARE_HALF_BAND = 1500, 0.765625, 0.006
#: bench.py's comm-bound geometry (bench.py:528-620)
COMM_D, COMM_ROWS, COMM_STEPS, COMM_REPEATS = 1 << 20, 8, 30, 3
#: bench.py's SSP straggler bench (bench.py:1226-1380) and a leave plan
SSP_PLAN = "seed=7;shard:straggle@p0.25=straggle:800"
SSP_LEAVE_PLAN = SSP_PLAN + ";shard:leave@p0.05=leave:2"
SSP_S, SSP_STEPS, SSP_REPEATS, SSP_CONV_ITERS, SSP_CONV_BAND = (
    8, 64, 3, 600, 0.01)
#: the straggle kernel against its plain version: 4 ulp of a float32
#: near 4096, a shard's sum (4096 lanes near 1)
STRAGGLE_TOL = 4 * 4096 * 2.0 ** -23
#: breast-cancer tails: `fused` at 4 shards over its last 200 steps, MA
#: at 4 replicas over its last 50 rounds. Card and CPU part within tens
#: of steps on these unnormalised features, and the tail means swing
#: with the schedule (0.61 to 0.89 on the CPU port), so the band is held
#: on each run's best and the means are reported; MA's card is held
#: against the CPU port after SYNC_CHECK_STEPS rounds, before they part,
#: and the round where their accuracies part is reported
SYNC_FUSED_TAIL, SYNC_MA_TAIL = 200, 50


def _device_profile(run, steps: int) -> dict:
    """Device µs and device ops (kernels and copies) a step, by op, over
    one profiled ``run()`` of ``steps`` steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us, ops, by = 0.0, 0, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        us += float(t)
        ops += int(e.count)
        by[e.key[:40]] = float(t) / steps
    top = dict(sorted(by.items(), key=lambda kv: -kv[1])[:5])
    return {"device_us": us / steps, "device_ops": ops / steps,
            "top": top}


def _timed(run):
    """Warm ``run()``, then one run on the host's clock with every
    launch counter set to 0 just before and read just after → (output
    of the warm run, output of the timed run, seconds, launches)."""
    import torch

    warm = run()
    torch.cuda.synchronize()
    _reset_launches()
    t1 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    return warm, out, secs, _launches()


def _want_launches(what: str, launches: dict, want: dict) -> None:
    """Raise unless exactly the kernels of ``want`` ran, as often as it
    says."""
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{what}: launched {got}, want {want}")


def _sync_reduce_checks(dev, sync_card, sync_cpu, per, res) -> dict:
    """One sync of the step's per-shard (Σ grad, count) through the
    schedule: the card's result against the CPU port's (bitwise), and
    its device time and ops over SYNC_REDUCE_CALLS calls."""
    import torch

    out_card = sync_card.reduce(per, res, 3)
    out_cpu = sync_cpu.reduce([tuple(x.cpu() for x in p) for p in per],
                              None if res is None else res.cpu(), 3)
    for got, want in zip(list(out_card[0]) + [out_card[1]],
                         list(out_cpu[0]) + [out_cpu[1]]):
        if (got is None) != (want is None) or (
                got is not None and not torch.equal(got.cpu(), want)):
            raise AssertionError(
                f"{sync_card.spec}: the card's reduce differs from the "
                f"CPU port's")
    prof = _device_profile(
        lambda: [sync_card.reduce(per, res, t)
                 for t in range(SYNC_REDUCE_CALLS)], SYNC_REDUCE_CALLS)
    return {"sync_device_us": prof["device_us"],
            "sync_device_ops": prof["device_ops"]}


def _sync_ssgd(dev, sg: dict) -> dict:
    """SSGD `fused_gather` (B1) at full width on 4 emulated shards under
    every schedule, SYNC_STEPS steps each; `fused` (B5) under int8 and
    topk."""
    import dataclasses

    import torch

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.ops import logistic, ssgd_kernels
    from tpu_distalg_torch.parallel import comms, get_mesh, partition
    from tpu_distalg_torch.utils import prng

    X2, meta = sg["X2"], sg["meta"]
    D, d = meta["d_total"], meta["y_col"]
    mesh = get_mesh(data=SYNC_SHARDS, device=dev)
    mesh_cpu = get_mesh(data=SYNC_SHARDS, device="cpu")
    te = (torch.zeros((1, D), device=dev), torch.zeros((1,), device=dev))
    w0 = torch.zeros((D,), dtype=torch.float32, device=dev)
    w0[:d] = logistic.init_weights(prng.root_key(7, dev), d)
    base = ssgd.SSGDConfig(
        n_iterations=SYNC_STEPS, eval_test=False, x_dtype="bfloat16",
        sampler="fused_gather", gather_block_rows=SSGD_GBR, shuffle_seed=0,
        init_seed=7)
    n_s = ssgd.fused_gather_geometry(base, meta, SYNC_SHARDS)[1]
    col_keep = (torch.arange(D, device=dev) < d).to(torch.float32)
    ids0 = ssgd._block_draws(mesh, base, meta)(
        torch.zeros((1,), dtype=torch.int64, device=dev))[0]
    per = [(g * col_keep, c) for g, c in (
        ssgd_kernels.fused_grad_sum_gathered(
            X2, w0, ids0[s], pack=meta["pack"], d_total=D,
            y_col=meta["y_col"], v_col=meta["v_col"],
            gather_block_rows=SSGD_GBR) for s in range(SYNC_SHARDS))]
    X2_cpu = X2.cpu()
    out, finals = {}, {}
    for sched in SYNC_SCHEDULES:
        cfg = dataclasses.replace(base, comm=sched)
        sync = comms.make_sync(sched, mesh, (comms.leaf((D,)),
                                             comms.leaf(())))
        sync_cpu = comms.make_sync(sched, mesh_cpu, (comms.leaf((D,)),
                                                     comms.leaf(())))
        res0 = (partition.place({"res": sync.init_state()}, "ssgd",
                                mesh)["res"] if sched != "dense" else None)
        tail = (res0,) if res0 is not None else ()

        def make(c, m=mesh):
            return ssgd.make_train_fn_fused(m, c, meta)

        fn = make(cfg)
        warm, res, secs, launches = _timed(
            lambda: fn(X2, None, None, *te, w0, *tail))
        _want_launches(f"fused_gather {sched}", launches,
                       {"fused_grad_sum_gathered": SYNC_SHARDS * SYNC_STEPS})
        if not torch.equal(warm[0], res[0]):
            raise AssertionError(f"fused_gather {sched}: two runs differ")
        w = res[0]
        if not bool(torch.isfinite(w).all()):
            raise AssertionError(f"fused_gather {sched}: non-finite w")
        finals[sched] = w
        fn_p = make(dataclasses.replace(cfg, n_iterations=SYNC_PROFILE_STEPS))
        prof = _device_profile(lambda: fn_p(X2, None, None, *te, w0, *tail),
                               SYNC_PROFILE_STEPS)
        res_mid = res[2] if len(res) == 3 else None
        rec = {"steps_per_s": SYNC_STEPS / secs,
               "wall_us_per_step": secs * 1e6 / SYNC_STEPS,
               "device_us_per_step": prof["device_us"],
               "device_ops_per_step": prof["device_ops"],
               "device_idle_share": 1.0 - prof["device_us"] * SYNC_STEPS
               / (secs * 1e6),
               "bytes_wire_per_sync": sync.stats()["bytes_wire"],
               "rounds_per_sync": sync.stats()["rounds"],
               "launches": launches["fused_grad_sum_gathered"],
               **_sync_reduce_checks(dev, sync, sync_cpu, per,
                                     res_mid if res_mid is not None
                                     else res0)}
        c5 = dataclasses.replace(cfg, n_iterations=SYNC_CHECK_STEPS)
        w_c = make(c5)(X2, None, None, *te, w0, *tail)[0]
        w_h = make(c5, mesh_cpu)(
            X2_cpu, None, None, *(t.cpu() for t in te), w0.cpu(),
            *(t.cpu() for t in tail))[0]
        err = float((w_c.cpu() - w_h).abs().max())
        tol = (SYNC_TOL_ROUNDED if sched.startswith(("int8", "topk"))
               else SYNC_TOL) * float(w_h.abs().max())
        if err > tol:
            raise AssertionError(f"fused_gather {sched}: card vs CPU port "
                                 f"after {SYNC_CHECK_STEPS} steps: {err}")
        rec["card_vs_cpu_5_steps"] = err
        out[sched] = rec
        print(f"[sync] fused_gather {sched} on {SYNC_SHARDS} shards: "
              f"{rec['steps_per_s']!r} steps/s, wall "
              f"{rec['wall_us_per_step']!r} µs/step, device "
              f"{rec['device_us_per_step']!r} µs/step in "
              f"{rec['device_ops_per_step']!r} ops (top {prof['top']}), "
              f"idle {rec['device_idle_share']!r}; the sync alone "
              f"{rec['sync_device_us']!r} device µs in "
              f"{rec['sync_device_ops']!r} ops, = CPU port bitwise; "
              f"{rec['bytes_wire_per_sync']} wire bytes/sync (ring "
              f"model), {rec['rounds_per_sync']} rounds; B1 "
              f"{rec['launches']}; card vs CPU after {SYNC_CHECK_STEPS} "
              f"steps {err!r} (tol {tol!r}); max |w - w_dense| "
              f"{float((w - finals['dense']).abs().max())!r}")
    if not torch.equal(finals["int8"], finals["int8@seq"]):
        raise AssertionError("int8@seq differs from int8")
    print("[sync] int8@seq = int8 bitwise; every schedule replays bitwise")
    dense_ops = out["dense"]["device_ops_per_step"]
    for sched, rec in out.items():
        rec["ops_added_per_step"] = rec["device_ops_per_step"] - dense_ops
    print(f"[sync] device ops a step each schedule adds over dense: "
          f"{ {k: v['ops_added_per_step'] for k, v in out.items()} }")

    fused = {}
    for sched in ("dense", "int8", "topk:0.01"):
        cfg = dataclasses.replace(base, sampler="fused", comm=sched,
                                  fused_block_rows=SSGD_GBR)
        fn = ssgd.make_train_fn_fused(mesh, cfg, meta)
        sync = comms.make_sync(sched, mesh, (comms.leaf((D,)),
                                             comms.leaf(())))
        tail = ((partition.place({"res": sync.init_state()}, "ssgd",
                                 mesh)["res"],) if sched != "dense" else ())
        warm, res, secs, launches = _timed(
            lambda: fn(X2, None, None, *te, w0, *tail))
        _want_launches(f"fused {sched}", launches,
                       {"fused_grad_sum_packed": SYNC_SHARDS * SYNC_STEPS})
        if not torch.equal(warm[0], res[0]):
            raise AssertionError(f"fused {sched}: two runs differ")
        # the card against the CPU port (B5's plain version draws the
        # same threefry mask), as fused_gather above
        c5 = dataclasses.replace(cfg, n_iterations=SYNC_CHECK_STEPS)
        w_c = ssgd.make_train_fn_fused(mesh, c5, meta)(
            X2, None, None, *te, w0, *tail)[0]
        w_h = ssgd.make_train_fn_fused(mesh_cpu, c5, meta)(
            X2_cpu, None, None, *(t.cpu() for t in te), w0.cpu(),
            *(t.cpu() for t in tail))[0]
        err = float((w_c.cpu() - w_h).abs().max())
        tol = (SYNC_TOL_ROUNDED if sched != "dense" else SYNC_TOL) * float(
            w_h.abs().max())
        if err > tol:
            raise AssertionError(f"fused {sched}: card vs CPU port after "
                                 f"{SYNC_CHECK_STEPS} steps: {err}")
        fused[sched] = {"steps_per_s": SYNC_STEPS / secs,
                        "launches": launches["fused_grad_sum_packed"],
                        "card_vs_cpu_5_steps": err}
        print(f"[sync] fused (B5) {sched} on {SYNC_SHARDS} shards: "
              f"{SYNC_STEPS / secs!r} steps/s; B5 "
              f"{fused[sched]['launches']}; replays bitwise; card vs CPU "
              f"after {SYNC_CHECK_STEPS} steps {err!r} (tol {tol!r}); max "
              f"|w - w_dense| "
              f"{float((res[0] - finals['dense']).abs().max())!r} "
              f"(fused_gather's dense run)")
    del X2_cpu
    return {"fused_gather": out, "fused": fused}


def _tail(accs, n: int) -> tuple:
    a = np.asarray(accs)[-n:]
    return float(a.max()), float(a.mean())


def _sync_breast_cancer(dev) -> dict:
    """The reference task at 4 shards under the schedules: SSGD `fused`
    (B5; JAX runs it only on a TPU: the card's run is held by the tail's
    best, the CPU port's in tests/test_torch_comms_trainers.py) and MA on
    `fused_train` (B2) and `fused_gather` (B1) at bench.py's settings
    and MA `ssp:4` on `bernoulli`, on the card and the CPU port."""
    import dataclasses
    import warnings

    from tpu_distalg_torch.models import ma, ssgd
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    data = datasets.breast_cancer_split()
    card, cpu = (get_mesh(data=SYNC_SHARDS, device=dev),
                 get_mesh(data=SYNC_SHARDS, device="cpu"))
    runs = []
    for comm in ("dense", "int8", "topk:0.01"):
        runs.append((f"ssgd fused {comm}", ssgd, ssgd.SSGDConfig(
            sampler="fused", fused_pack=4, fused_block_rows=64, comm=comm),
            SYNC_FUSED_TAIL, SSGD_BAND, False))
    for comm in ("int8", "topk:0.01"):
        for sampler in ("fused_train", "fused_gather"):
            runs.append((f"ma {sampler} {comm}", ma, ma.MAConfig(
                sampler=sampler, gather_block_rows=64, fused_pack=4,
                shuffle_seed=0, comm=comm), SYNC_MA_TAIL,
                LOCAL_BANDS["ma"], True))
    runs.append(("ma bernoulli ssp:4", ma, ma.MAConfig(sync="ssp:4"),
                 SYNC_MA_TAIL, LOCAL_BANDS["ma"], True))
    out = {}
    for label, mod, cfg, n, band, on_cpu in runs:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="fused_gather:")
            _reset_launches()
            rc = mod.train(*data, card, cfg)
            launches = {k: v for k, v in _launches().items() if v}
            if on_cpu:
                rh = mod.train(*data, cpu, cfg)
                c5 = dataclasses.replace(cfg, n_iterations=SYNC_CHECK_STEPS)
                w_c = mod.train(*data, card, c5).w.cpu()
                w_h = mod.train(*data, cpu, c5).w
        cb, cm = _tail(rc.accs.cpu(), n)
        hb, hm = _tail(rh.accs, n) if on_cpu else (band, None)
        if not (cb >= band and hb >= band):
            raise AssertionError(
                f"{label}: breast cancer tail best card {cb} / CPU {hb} "
                f"(want >= {band})")
        out[label] = {"final_acc": rc.final_acc, "tail_best": cb,
                      "tail_mean": cm, "cpu_tail_mean": hm,
                      "launches": launches}
        cpu_part = ""
        if on_cpu:
            # held before the trajectories part; the tails are read
            # after they have (the round they part at is printed)
            err = float((w_c - w_h).abs().max())
            tol = (SYNC_TOL_ROUNDED if cfg.comm != "dense"
                   else SYNC_TOL) * float(w_h.abs().max())
            if not err <= tol:
                raise AssertionError(
                    f"{label}: breast cancer card vs CPU port after "
                    f"{SYNC_CHECK_STEPS} rounds: {err} (tol {tol})")
            differ = np.nonzero(np.asarray(rc.accs.cpu())
                                != np.asarray(rh.accs))[0]
            part = int(differ[0]) + 1 if differ.size else None
            out[label].update(card_vs_cpu_5_rounds=err,
                              accs_part_at_round=part)
            cpu_part = (f"; CPU final {rh.final_acc!r}, last {n} best "
                        f"{hb!r}, mean {hm!r}; card vs CPU after "
                        f"{SYNC_CHECK_STEPS} rounds {err!r} (tol {tol!r}), "
                        f"accuracies part at round {part}")
        print(f"[sync] breast cancer, {label} on {SYNC_SHARDS} shards: "
              f"final acc {rc.final_acc!r}, last {n} best {cb!r}, mean "
              f"{cm!r} (band >= {band}){cpu_part}; launches {launches}")
    return out


def _sync_compare(dev) -> dict:
    """bench.py's comparison (run_comm_comparison): every schedule on
    the converging 4096/1024 task, 1500 `bernoulli` iterations."""
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    X, y = datasets.synthetic_two_class(4096 + 1024, 30, seed=0)
    X = datasets.add_bias_column(X)
    data = (X[:4096], y[:4096], X[4096:], y[4096:])
    mesh = get_mesh(data=SYNC_SHARDS, device=dev)
    out = {}
    for sched in COMPARE_SCHEDULES:
        cfg = ssgd.SSGDConfig(n_iterations=COMPARE_ITERS, comm=sched,
                              eval_every=COMPARE_ITERS // 10)
        t1 = time.perf_counter()
        res = ssgd.train(*data, mesh, cfg)
        acc = res.final_acc
        secs = time.perf_counter() - t1
        st = ssgd._comm_sync(mesh, cfg, X.shape[1]).stats()
        out[sched] = {"bytes_wire_per_sync": st["bytes_wire"],
                      "bytes_logical_per_sync": st["bytes_logical"],
                      "rounds_per_sync": st["rounds"], "final_acc": acc,
                      "seconds": secs}
    base = out["dense"]
    for sched, rec in out.items():
        rec["wire_reduction_vs_dense"] = (base["bytes_wire_per_sync"]
                                          / rec["bytes_wire_per_sync"])
        rec["acc_delta_vs_dense"] = rec["final_acc"] - base["final_acc"]
        if abs(rec["final_acc"] - COMPARE_CENTRE) > COMPARE_HALF_BAND:
            raise AssertionError(
                f"comparison {sched}: final acc {rec['final_acc']} outside "
                f"{COMPARE_CENTRE} ± {COMPARE_HALF_BAND}")
        print(f"[sync] comparison task, {sched}: "
              f"{rec['bytes_wire_per_sync']} wire bytes/sync (ring model; "
              f"{rec['wire_reduction_vs_dense']!r}x less than dense), final "
              f"acc {rec['final_acc']!r} ({rec['acc_delta_vs_dense']!r} vs "
              f"dense), {rec['seconds']!r} s for {COMPARE_ITERS} iterations")
    if out["int8"]["wire_reduction_vs_dense"] < 3 or \
            out["topk"]["wire_reduction_vs_dense"] < 4:
        raise AssertionError("int8 must cut bytes_wire >= 3x and topk >= "
                             "4x against dense (bench.py:445-449)")
    return out


def _best_rate(run, steps: int, repeats: int) -> tuple[float, float]:
    """Best steps/s over ``repeats`` timed runs (after a warm one) and
    the spread (worst/best − 1)."""
    import torch

    run()
    torch.cuda.synchronize()
    rates = []
    for _ in range(repeats):
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rates.append(steps / (time.perf_counter() - t1))
    return max(rates), max(rates) / min(rates) - 1.0


def _comm_bound_rates(dev, scheds) -> dict:
    """bench.py's comm-bound geometry (run_comm_step_speedup, and
    run_tuned_step_speedup's): d 2^20, 8 rows a shard, every row in the
    batch, 30 steps, best of 3; ``{sched: {steps_per_s, spread}}``."""
    import torch

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import comms, get_mesh, parallelize

    mesh = get_mesh(data=SYNC_SHARDS, device=dev)
    rows = COMM_ROWS * SYNC_SHARDS
    rng = np.random.default_rng(0)
    X = rng.standard_normal((rows, COMM_D)).astype(np.float32)
    y = (X @ rng.standard_normal(COMM_D).astype(np.float32) > 0).astype(
        np.float32)
    Xs, ys = parallelize(X, mesh), parallelize(y, mesh)
    te = (torch.zeros((1, COMM_D), device=dev), torch.zeros((1,), device=dev))
    w0 = torch.zeros((COMM_D,), device=dev)
    out = {}
    for sched in scheds:
        cfg = ssgd.SSGDConfig(n_iterations=COMM_STEPS, eval_test=False,
                              comm=sched, mini_batch_fraction=1.0)
        fn = ssgd.make_train_fn(mesh, cfg, Xs.n_padded, d=COMM_D)
        tail = () if sched == "dense" else (torch.as_tensor(
            comms.make_sync(sched, mesh, (comms.leaf((COMM_D,)),
                                          comms.leaf(()))).init_state(),
            device=dev),)
        rate, spread = _best_rate(
            lambda: fn(Xs.data, ys.data, Xs.mask, *te, w0, *tail),
            COMM_STEPS, COMM_REPEATS)
        out[sched] = {"steps_per_s": rate, "spread": spread}
    return out


def _sync_comm_bound(dev) -> dict:
    """bench.py's comm-bound geometry (run_comm_step_speedup): each
    schedule's rate and its ratio to dense."""
    out = _comm_bound_rates(dev, ("dense", "int8", "int8@seq", "topk:0.01"))
    for sched in ("int8", "int8@seq", "topk:0.01"):
        out[sched]["ratio_vs_dense"] = (out[sched]["steps_per_s"]
                                        / out["dense"]["steps_per_s"])
    print(f"[sync] comm-bound geometry (d {COMM_D}, {COMM_ROWS} rows a "
          f"shard, {COMM_STEPS} steps, best of {COMM_REPEATS}): "
          f"{json.dumps(out)}; wire: emulated on one card (the shards' "
          f"buffers share its memory: no transfer for a schedule to "
          f"shrink, so the ratios time the schedules' own work)")
    return out


def _sync_ssp(dev, sg: dict) -> dict:
    """bench.py's SSP straggler bench (run_ssp_straggler_speedup) on the
    comparison task, its equal-loss steps, then `ssp:8` on
    `fused_gather` at full width under the plan (replayed bitwise) and
    under a leave plan (two or more membership epochs)."""
    import dataclasses

    import torch

    from tpu_distalg_torch import faults
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.ops import logistic
    from tpu_distalg_torch.parallel import get_mesh, parallelize, partition
    from tpu_distalg_torch.parallel import ssp as pssp
    from tpu_distalg_torch.utils import datasets, prng

    mesh = get_mesh(data=SYNC_SHARDS, device=dev)
    X, y = datasets.synthetic_two_class(4096 + 1024, 30, seed=0)
    X = datasets.add_bias_column(X)
    Xtr, ytr, Xte, yte = X[:4096], y[:4096], X[4096:], y[4096:]
    d = X.shape[1]
    Xs, ys = parallelize(Xtr, mesh), parallelize(ytr, mesh)
    te = (torch.zeros((1, d), device=dev), torch.zeros((1,), device=dev))
    w0 = torch.zeros((d,), device=dev)
    plan = faults.FaultPlan.parse(SSP_PLAN)
    n_win, padded = pssp.window_grid(SSP_STEPS, SSP_S)
    extra = pssp.compile_straggle_schedule(padded, SYNC_SHARDS, plan=plan)
    extra[SSP_STEPS:] = 0
    cfg = ssgd.SSGDConfig(n_iterations=SSP_STEPS, eval_test=False)
    bsp_fn = ssgd.make_bsp_straggler_fn(mesh, cfg, Xs.n_padded, extra)
    bsp_rate, bsp_spread = _best_rate(
        lambda: bsp_fn(Xs.data, ys.data, Xs.mask, *te, w0), SSP_STEPS,
        SSP_REPEATS)
    cfg_ssp = dataclasses.replace(cfg, sync=f"ssp:{SSP_S}")
    ssp_fn = ssgd.make_ssp_train_fn(
        mesh, cfg_ssp, Xs.n_padded, d, active=(True,) * SYNC_SHARDS,
        n_win_seg=n_win, total_ticks=SSP_STEPS)
    st = partition.place(dict(zip(
        ("w", "clocks", "pend", "basegen", "wl", "accd", "res"),
        ssgd.ssp_init_state(mesh, cfg_ssp, d, w=w0))), "ssgd", mesh)
    seg = extra.reshape(n_win, SSP_S, SYNC_SHARDS)
    ssp_rate, ssp_spread = _best_rate(
        lambda: ssp_fn(Xs.data, ys.data, Xs.mask, *te, st["w"], st["clocks"],
                       st["pend"], st["basegen"], st["wl"], st["accd"],
                       st["res"], seg, 0), SSP_STEPS, SSP_REPEATS)
    straggle_rec = _check_straggle_kernel(dev, extra)
    cell_ms = straggle_rec["ms"]
    speed = {"ssgd_ssp_straggler_speedup": ssp_rate / bsp_rate,
             "ssp_steps_per_s": ssp_rate, "bsp_steps_per_s": bsp_rate,
             "ssp_spread": ssp_spread, "bsp_spread": bsp_spread,
             "straggled_cells": int(np.count_nonzero(extra)),
             "straggle_cell_device_us": cell_ms * 1e3}
    print(f"[sync] SSP straggler bench (ssp:{SSP_S}, {SYNC_SHARDS} shards, "
          f"plan {SSP_PLAN}, {SSP_STEPS} steps, best of {SSP_REPEATS}): "
          f"{json.dumps(speed)}; on one card the shards run one after "
          f"another, so both arms pay every delay")

    conv = {}
    for name, c in (("bsp", ssgd.SSGDConfig(n_iterations=SSP_CONV_ITERS)),
                    ("ssp", ssgd.SSGDConfig(n_iterations=SSP_CONV_ITERS,
                                            sync=f"ssp:{SSP_S}"))):
        conv[name] = np.asarray(ssgd.train(Xtr, ytr, Xte, yte, mesh,
                                           c).accs.cpu())
    target = float(conv["bsp"][-1]) - SSP_CONV_BAND

    def first_reach(accs):
        idx = np.nonzero(accs >= target)[0]
        return int(idx[0]) + 1 if idx.size else None

    bsp_steps = first_reach(conv["bsp"]) or SSP_CONV_ITERS
    ssp_steps = first_reach(conv["ssp"])
    if ssp_steps is None:
        raise AssertionError(
            f"ssp never reached the BSP band (target {target}, ssp final "
            f"{float(conv['ssp'][-1])}) in {SSP_CONV_ITERS} steps")
    speed["ssgd_ssp_equal_loss_steps"] = ssp_steps / bsp_steps
    print(f"[sync] SSP equal-loss steps at {SSP_CONV_ITERS} iterations, band "
          f"{SSP_CONV_BAND}: BSP {bsp_steps}, SSP {ssp_steps} = "
          f"{ssp_steps / bsp_steps!r}x (target {target!r})")

    X2, meta = sg["X2"], sg["meta"]
    D, dd = meta["d_total"], meta["y_col"]
    w0f = torch.zeros((D,), dtype=torch.float32, device=dev)
    w0f[:dd] = logistic.init_weights(prng.root_key(7, dev), dd)
    te_f = (torch.zeros((1, D), device=dev), torch.zeros((1,), device=dev))
    cfg_f = ssgd.SSGDConfig(
        n_iterations=SSGD_STEPS, eval_test=False, x_dtype="bfloat16",
        sampler="fused_gather", gather_block_rows=SSGD_GBR, shuffle_seed=0,
        sync=f"ssp:{SSP_S}")
    runs = {}
    for label, spec in (("plan", SSP_PLAN), ("replay", SSP_PLAN),
                        ("leave", SSP_LEAVE_PLAN)):
        faults.configure(spec)
        try:
            _reset_launches()
            pssp.straggle_work.launches = 0
            t1 = time.perf_counter()
            res, epochs = ssgd.train_prepared_ssp(
                mesh, cfg_f, (X2, None, None), *te_f, w0f,
                n_padded=meta["n_padded"], meta=meta)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            launches = {k: v for k, v in _launches().items() if v}
        finally:
            faults.configure(False)
        runs[label] = (res.w, len(epochs), secs, launches,
                       pssp.straggle_work.launches)
    ticks = pssp.window_grid(SSGD_STEPS, SSP_S)[1]
    for label, (w, n_ep, secs, launches, n_straggle) in runs.items():
        _want_launches(f"ssp fused_gather {label}", launches,
                       {"fused_grad_sum_gathered": SYNC_SHARDS * ticks})
        if not bool(torch.isfinite(w).all()):
            raise AssertionError(f"ssp fused_gather {label}: non-finite w")
        print(f"[sync] ssp:{SSP_S} fused_gather at full width, {label}: "
              f"{SSGD_STEPS} ticks in {secs!r} s = {SSGD_STEPS / secs!r} "
              f"ticks/s; {n_ep} membership epoch(s); launches {launches}, "
              f"straggle work {n_straggle}")
    # `fused` (B5) under the plan, once a shard a tick
    faults.configure(SSP_PLAN)
    try:
        _reset_launches()
        t1 = time.perf_counter()
        res_f, _ = ssgd.train_prepared_ssp(
            mesh, dataclasses.replace(cfg_f, sampler="fused",
                                      fused_block_rows=SSGD_GBR),
            (X2, None, None), *te_f, w0f, n_padded=meta["n_padded"],
            meta=meta)
        torch.cuda.synchronize()
        secs_f = time.perf_counter() - t1
        _want_launches("ssp fused", _launches(),
                       {"fused_grad_sum_packed": SYNC_SHARDS * ticks})
    finally:
        faults.configure(False)
    if not bool(torch.isfinite(res_f.w).all()):
        raise AssertionError("ssp fused: non-finite w")
    speed["fused_ssp_ticks_per_s"] = SSGD_STEPS / secs_f
    speed["fused_ssp_launches"] = SYNC_SHARDS * ticks
    print(f"[sync] ssp:{SSP_S} fused (B5) at full width under the plan: "
          f"{SSGD_STEPS / secs_f!r} ticks/s; B5 {SYNC_SHARDS * ticks}")
    if not torch.equal(runs["plan"][0], runs["replay"][0]):
        raise AssertionError("ssp fused_gather: the replay differs")
    if runs["leave"][1] < 2:
        raise AssertionError("the leave plan gave fewer than 2 epochs")
    print("[sync] ssp fused_gather: the replay under the plan equals the "
          "first run bitwise")
    speed["fused_gather_ssp_ticks_per_s"] = SSGD_STEPS / runs["plan"][2]
    speed["fused_gather_ssp_launches"] = runs["plan"][3].get(
        "fused_grad_sum_gathered", 0)
    speed["leave_epochs"] = runs["leave"][1]
    speed["straggle_launches"] = runs["plan"][4]
    speed["straggle_rec"] = straggle_rec
    return speed


def _check_straggle_kernel(dev, extra) -> dict:
    """The straggle kernel (csrc/ssp.cu) against its plain version on
    the bench's own cells: one shard at 800 units, the schedule's row
    with the most shards straggling, and every shard at 800. Each pass
    adds about 2 ulp of 4096 to a straggling shard's sum, so
    STRAGGLE_TOL fails a loop short by 3 of its passes, a skipped loop
    and another shard's units. Times the one-shard cell, as the bench
    pays it."""
    import torch

    from tpu_distalg_torch.parallel import ssp as pssp

    busiest = extra[int(np.argmax(np.count_nonzero(extra, axis=1)))]
    cells = torch.tensor(np.stack([
        [800] + [0] * (SYNC_SHARDS - 1), busiest,
        [800] * SYNC_SHARDS]), dtype=torch.int32, device=dev)
    got = torch.stack([pssp.straggle_work(c) for c in cells])
    want = torch.stack([pssp.straggle_work_reference(c, 1.0)
                        for c in cells])
    err = float((got - want).abs().max())
    if not err <= STRAGGLE_TOL:
        raise AssertionError(
            f"straggle kernel vs its plain version on cells "
            f"{cells.tolist()}: {err} (tol {STRAGGLE_TOL})")
    cell = cells[0]
    units = int(cell.sum())
    bound, by = _bound_ms(8 * SYNC_SHARDS,
                          2 * pssp.STRAGGLE_LANES * units)
    rec = {"max_abs_err": err, "tol": STRAGGLE_TOL,
           "cells": cells.tolist(),
           "ms": _time_ms(lambda: pssp.straggle_work(cell), n=50),
           "plain_ms": _time_ms(
               lambda: pssp.straggle_work_reference(cell, 1.0), n=3,
               warm=1),
           "bound_ms": bound, "bound_by": by, "library_ms": None}
    print(f"[sync] straggle kernel = its plain version on the bench's "
          f"cells {cells.tolist()}: max abs err {err!r} (tol "
          f"{STRAGGLE_TOL}); {units} units: {rec['ms']!r} ms, plain "
          f"{rec['plain_ms']!r} ms, bound {bound!r} ms ({by})")
    return rec


def _sync_local(dev, sg: dict) -> dict:
    """MA at bench.py's MA geometry (300 rounds × 5 local steps) on 4
    emulated replicas, `fused_train` (B2) and `fused_gather` (B1),
    under int8 and topk."""
    import dataclasses

    import torch

    from tpu_distalg_torch.models import local_sgd, ma
    from tpu_distalg_torch.parallel import comms, get_mesh, partition

    X2, meta = sg["X2"], sg["meta"]
    D, d = meta["d_total"], meta["y_col"]
    R = SYNC_SHARDS
    mesh = get_mesh(data=R, device=dev)
    mesh_cpu = get_mesh(data=R, device="cpu")
    X2_cpu = X2.cpu()
    te = (torch.zeros((1, D), device=dev), torch.zeros((1,), device=dev))
    out = {}
    for sched in ("int8", "topk:0.01"):
        for sampler in ("fused_train", "fused_gather"):
            cfg = dataclasses.replace(
                ma.MAConfig(), n_iterations=LOCAL_ROUNDS,
                n_local_iterations=LOCAL_L, eval_test=False, sampler=sampler,
                x_dtype="bfloat16", fused_pack=16,
                gather_block_rows=SSGD_GBR, shuffle_seed=0, comm=sched)
            fn = local_sgd.make_train_fn_fused(mesh, cfg, meta)
            state = local_sgd.init_state(cfg, d, D, R, dev)
            res0 = partition.place({"res": comms.make_sync(
                sched, mesh, (comms.leaf((D,)),)).init_state()},
                "local_sgd", mesh)["res"]
            warm, res, secs, launches = _timed(
                lambda: fn(X2, *te, *state, res0))
            kernel, count = (
                ("fused_train_gathered", R * LOCAL_ROUNDS)
                if sampler == "fused_train"
                else ("fused_grad_sum_gathered", R * LOCAL_ROUNDS * LOCAL_L))
            _want_launches(f"ma {sampler} {sched}", launches,
                           {kernel: count})
            if not torch.equal(warm[0], res[0]):
                raise AssertionError(f"ma {sampler} {sched}: runs differ")
            # the card against the CPU port after SYNC_CHECK_STEPS
            # rounds: the kernel, then the schedule's combine
            c5 = dataclasses.replace(cfg, n_iterations=SYNC_CHECK_STEPS)
            w_c = local_sgd.make_train_fn_fused(mesh, c5, meta)(
                X2, *te, *state, res0)[0]
            w_h = local_sgd.make_train_fn_fused(mesh_cpu, c5, meta)(
                X2_cpu, *(t.cpu() for t in te),
                *local_sgd.init_state(cfg, d, D, R, "cpu"), res0.cpu())[0]
            err = float((w_c.cpu() - w_h).abs().max())
            tol = SYNC_TOL_ROUNDED * float(w_h.abs().max())
            if not err <= tol:
                raise AssertionError(
                    f"ma {sampler} {sched}: card vs CPU port after "
                    f"{SYNC_CHECK_STEPS} rounds: {err} (tol {tol})")
            rate = LOCAL_ROUNDS * LOCAL_L / secs
            out[f"{sampler} {sched}"] = {"local_steps_per_s": rate,
                                         "launches": launches[kernel],
                                         "card_vs_cpu_5_rounds": err}
            print(f"[sync] MA {sampler} {sched}, {R} replicas: "
                  f"{LOCAL_ROUNDS} rounds x {LOCAL_L} local steps in "
                  f"{secs!r} s = {rate!r} local steps/s; {kernel} "
                  f"{launches[kernel]}; replays bitwise; card vs CPU "
                  f"after {SYNC_CHECK_STEPS} rounds {err!r} (tol {tol!r})")
    del X2_cpu
    return out


def _sync_launches(sync: dict, key: str) -> dict:
    """Phase 13's launches of B1, B2 or B5, by path."""
    if key == "B5":
        return {**{f"ssgd fused {k}": v["launches"]
                   for k, v in sync["ssgd"]["fused"].items()},
                "ssgd fused ssp:8": sync["ssp"]["fused_ssp_launches"],
                **{f"breast cancer {k}": v["launches"][
                    "fused_grad_sum_packed"]
                   for k, v in sync["breast_cancer"].items()
                   if "fused_grad_sum_packed" in v["launches"]}}
    kernel = ("fused_grad_sum_gathered" if key == "B1"
              else "fused_train_gathered")
    out = {}
    if key == "B1":
        out.update({f"ssgd fused_gather {k}": v["launches"]
                    for k, v in sync["ssgd"]["fused_gather"].items()})
        out["ssgd fused_gather ssp:8"] = sync["ssp"][
            "fused_gather_ssp_launches"]
    out.update({f"ma {k}": v["launches"] for k, v in sync["local"].items()
                if k.startswith("fused_gather" if key == "B1"
                                else "fused_train")})
    out.update({f"breast cancer {k}": v["launches"][kernel]
                for k, v in sync["breast_cancer"].items()
                if kernel in v["launches"]})
    return out


def run_sync(dev, sg: dict) -> dict:
    """Phase 13: the sync layer (``parallel/comms.py``, ``ssp.py``,
    ``membership.py``) on the SGD family, each path driven with the
    launch counters set to 0 just before it and read just after."""
    out, t0 = {}, time.perf_counter()
    for key, part in (("ssgd", lambda: _sync_ssgd(dev, sg)),
                      ("compare", lambda: _sync_compare(dev)),
                      ("comm_bound", lambda: _sync_comm_bound(dev)),
                      ("ssp", lambda: _sync_ssp(dev, sg)),
                      ("local", lambda: _sync_local(dev, sg)),
                      ("breast_cancer", lambda: _sync_breast_cancer(dev))):
        out[key] = part()
        t0 = _phase(f"sync: {key}", t0)
    print(f"[sync] summary: {json.dumps({k: v for k, v in out.items() if k in ('compare', 'comm_bound', 'ssp')})}")
    return out


# ------------------------------------------------------------ phase 14

#: the out-of-core paths at bench.py's row widths (bench.py:2375-2652),
#: depths cut for the script's time (PERF.md §4 lists each cut):
#: streamed SSGD on a 2²⁴-row cache (bench.py: 2²⁷), 125 features +
#: bias, pack 16, bf16, 2048-row blocks; 4 sampled blocks a step
#: (bench.py's 2 MB) and 64 (32 MB), STREAM_STEPS steps, best of
#: STREAM_REPEATS; STREAM_CHECK_STEPS streamed steps against resident
#: fused_gather, on 1 and STREAM_CHECK_SHARDS shards, and a run
#: segmented at STREAM_SEGMENT
STREAM_ROWS, STREAM_FEATURES, STREAM_PACK, STREAM_GBR = 1 << 24, 125, 16, 2048
STREAM_SAMPLED, STREAM_STEPS, STREAM_REPEATS = (4, 64), 30, 3
STREAM_CHECK_STEPS, STREAM_CHECK_SHARDS, STREAM_SEGMENT = 100, 4, 50
#: virtual SSGD at bench.py's geometry (10⁹ logical rows × 30 features,
#: fraction 0.01, 131,072-row blocks), VIRTUAL_STEPS of its 200 steps,
#: run twice (bitwise), host peak RSS growth under 1 GB
VIRTUAL_ROWS, VIRTUAL_FEATURES, VIRTUAL_GBR = 1_000_000_000, 30, 131072
VIRTUAL_FRACTION, VIRTUAL_STEPS, VIRTUAL_HELDOUT = 0.01, 8, 8192
#: minibatch k-means on a streamed mixture of 2²⁴ points (bench.py:
#: 2²⁸), k 8, dim 16, 2048-row blocks, 4 blocks a step, 30 steps; every
#: true mean some centre's nearest within OOC_KM_RECOVER (bench.py's check)
OOC_KM_POINTS, OOC_KM_K, OOC_KM_DIM, OOC_KM_BLOCK = 1 << 24, 8, 16, 2048
OOC_KM_STEPS, OOC_KM_BLOCKS, OOC_KM_RECOVER = 30, 4, 0.5
#: streamed ALS on a 16384² rank-64 f32 R (bench.py: 65536²), 512-row
#: blocks, lam 0, one sweep and one rmse pass
OOC_ALS_M, OOC_ALS_N, OOC_ALS_K, OOC_ALS_BLOCK = 16384, 16384, 64, 512


def _rss_now_gb() -> float:
    """The host's resident set now (VmRSS), GB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1e6
    raise RuntimeError("no VmRSS in /proc/self/status")


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _rate_gb(nbytes: int, fn, n: int) -> float:
    """Best GB/s of ``fn()`` moving ``nbytes``, over ``n`` calls."""
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return nbytes / best / 1e9


def _pinned_copy_gb(dev, nbytes: int) -> float:
    """A pinned host → card ``copy_`` of ``nbytes`` in this run, GB/s."""
    import torch

    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)

    def once():
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()

    once()
    return _rate_gb(nbytes, once, 10)


def _stream_b1_record(staged, w, meta) -> dict:
    """B1 on one staged batch (the streamed step's shape: the identity
    block index) against its plain version, timed beside the library
    line and the bound (the batch is warm in L2 after the first call)."""
    import torch

    from tpu_distalg_torch.ops import ssgd_kernels as tk

    D, yc, vc = meta["d_total"], meta["y_col"], meta["v_col"]
    X = staged[0]
    n_s = X.shape[0] * meta["pack"] // STREAM_GBR
    ids = torch.arange(n_s, dtype=torch.int32, device=X.device)
    kw = dict(pack=meta["pack"], d_total=D, y_col=yc, v_col=vc,
              gather_block_rows=STREAM_GBR)
    g, c = tk.fused_grad_sum_gathered(X, w, ids, **kw)
    gr, cr = tk.grad_sum_gathered_reference(X, w, ids, **kw)
    if float(c) != float(cr):
        raise AssertionError(f"B1 stream shape: count {c} != {cr}")
    err = _assert_close("B1 stream shape", g[:yc], gr[:yc], "random")
    x = X.reshape(-1, D)
    wq = w.to(X.dtype)

    def lib():
        r = (torch.sigmoid(torch.mv(x, wq).float()) - x[:, yc].float()) \
            * x[:, vc].float()
        return torch.mv(x.T, r.to(x.dtype)).float(), x[:, vc].float().sum()

    rows = n_s * STREAM_GBR
    nbytes = rows * D * X.element_size()
    bound = _bound_ms(nbytes + 4 * (n_s + D + D + 1), 4 * rows * D)
    return {"stream_max_abs_err": err,
            "stream_ms": _time_ms(lambda: tk.fused_grad_sum_gathered(
                X, w, ids, **kw)),
            "stream_plain_ms": _time_ms(lambda: tk.grad_sum_gathered_reference(
                X, w, ids, **kw), 20, 2),
            "stream_library_ms": _time_ms(lib, 50, 5),
            "stream_bound_ms": bound[0], "stream_bound_by": bound[1],
            "stream_bytes_per_call": nbytes}


def _stream_ssgd(dev, workdir: str) -> dict:
    """(a) streamed SSGD from a disk cache through B1, against resident
    fused_gather on the same bytes."""
    import dataclasses

    import torch

    from tpu_distalg_torch.data.sharded import _to_device
    from tpu_distalg_torch.models import ssgd, ssgd_stream
    from tpu_distalg_torch.ops import logistic
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.tools.profiling import window
    from tpu_distalg_torch.utils import datasets, metrics, prng

    path = os.path.join(workdir, "stream")
    rss0 = _peak_rss_gb()
    t0 = time.perf_counter()
    X2, meta, (X_te, y_te) = datasets.streamed_packed_cache(
        path, n_rows=STREAM_ROWS, n_features=STREAM_FEATURES, n_shards=1,
        pack=STREAM_PACK, gather_block_rows=STREAM_GBR, seed=0)
    gen_s = time.perf_counter() - t0
    D, d = meta["d_total"], STREAM_FEATURES + 1
    n_blocks = STREAM_ROWS // STREAM_GBR
    cache_bytes = X2.shape[0] * X2.shape[1] * 2
    print(f"[stream] cache of {STREAM_ROWS} rows x {STREAM_FEATURES} + bias "
          f"(D {D} bf16, pack {STREAM_PACK}) = {cache_bytes} bytes made in "
          f"{gen_s!r} s (host peak RSS +{_peak_rss_gb() - rss0!r} GB)")
    mesh = get_mesh(data=1, device=dev)
    w0 = torch.zeros((D,), dtype=torch.float32, device=dev)
    w0[:d] = logistic.init_weights(prng.root_key(7, dev), d)
    Xt = torch.from_numpy(np.pad(np.asarray(X_te, np.float32),
                                 ((0, 0), (0, D - d)))).to(dev)
    yt = torch.from_numpy(np.asarray(y_te, np.float32)).to(dev)
    t = np.load(path + ".test.npz")
    teacher = float(np.mean((X_te @ t["w_true"] > 0) == (y_te > 0.5)))

    def cfg(n_s, steps):
        return ssgd.SSGDConfig(
            n_iterations=steps, eval_test=False, sampler="fused_gather",
            x_dtype="bfloat16", mini_batch_fraction=n_s / n_blocks,
            gather_block_rows=STREAM_GBR, init_seed=7, shuffle_seed=None)

    out = {"generation_s": gen_s, "cache_bytes": cache_bytes,
           "teacher_ceiling_acc": teacher, "launches": {}}
    for n_s in STREAM_SAMPLED:
        tr = ssgd_stream.StreamTrainer(X2, meta, mesh, cfg(n_s, STREAM_STEPS))
        step_bytes = tr.h2d_bytes_per_step
        w = tr.run(w0, 0, 3)[0]   # warm: the page cache, the kernel
        _sync(dev)
        rates, t_abs = [], 3
        for _ in range(STREAM_REPEATS):
            _reset_launches()
            t1 = time.perf_counter()
            w = tr.run(w, t_abs, STREAM_STEPS)[0]
            _sync(dev)
            rates.append(STREAM_STEPS / (time.perf_counter() - t1))
            t_abs += STREAM_STEPS
            _want_launches(f"stream {n_s} blocks", _launches(),
                           {"fused_grad_sum_gathered": STREAM_STEPS})
        out["launches"][f"{n_s} blocks, a timed run"] = STREAM_STEPS
        best = max(rates)
        t1 = time.perf_counter()
        ids = tr.block_ids(0, STREAM_STEPS)    # a run's draws, on the card
        draw_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        for _ in tr.dataset.stream(ids):       # the pipeline, no step
            pass
        _sync(dev)
        stream_only = STREAM_STEPS / (time.perf_counter() - t1)
        serial = _rate_gb(step_bytes, lambda: (tr.dataset.stage(ids[0]),
                                               _sync(dev)), 5)
        host = tr.dataset.host_batch(ids[1])
        buf = getattr(host, "array", host)     # a pinned buffer on a card
        gather = _rate_gb(step_bytes, lambda: tr.dataset.gather(
            ids[1], out=buf), 5)
        on_card = torch.device(dev).type == "cuda"
        pinned = _pinned_copy_gb(dev, step_bytes) if on_card else None
        prof = (window(lambda: tr.run(w0, 3, STREAM_STEPS), STREAM_STEPS)
                if on_card else {})
        if on_card and n_s == STREAM_SAMPLED[-1]:
            out["b1"] = _stream_b1_record(tr.dataset.stage(ids[2]), w0, meta)
            print(f"[stream] B1 on a staged batch of {n_s} blocks: "
                  f"{json.dumps(out['b1'])}")
        achieved = step_bytes * best / 1e9
        acc = float(metrics.binary_accuracy(Xt @ w, yt))
        rec = {"h2d_bytes_per_step": step_bytes, "steps_per_s": best,
               "rates": rates, "achieved_h2d_gb_per_s": achieved,
               "pinned_copy_gb_per_s": pinned,
               "serial_stage_gb_per_s": serial,
               "h2d_overlap_vs_serial": achieved / serial,
               "host_gather_gb_per_s": gather,
               "draws_ms_a_run": draw_ms,
               "pipeline_alone_steps_per_s": stream_only,
               "heldout_acc": acc, "steps_trained": t_abs,
               "device_idle_share": prof.get("device_idle_share"),
               "wall_us_per_step": prof.get("wall_us_per_step"),
               "device_us_per_step": prof.get("device_us_per_step"),
               "device_us_per_step_by_op": prof.get(
                   "device_us_per_step_by_op")}
        out[f"{n_s}_blocks"] = rec
        print(f"[stream] {n_s} blocks of {STREAM_GBR} rows a step "
              f"({step_bytes} bytes H2D): {json.dumps(rec)}; teacher "
              f"ceiling {teacher!r}")

    # 100 streamed steps = resident fused_gather on the same bytes, on
    # one shard and on STREAM_CHECK_SHARDS
    X2_dev = _to_device(X2, torch.bfloat16, dev)
    for shards in (1, STREAM_CHECK_SHARDS):
        m = get_mesh(data=shards, device=dev)
        c = cfg(STREAM_SAMPLED[0] * shards, STREAM_CHECK_STEPS)
        meta_s = dict(meta)
        _reset_launches()
        w_res, _ = ssgd.make_train_fn_fused(m, c, meta_s)(
            X2_dev, None, None, None, None, w0)
        _sync(dev)
        res_launches = _launches()
        _reset_launches()
        w_str, _ = ssgd_stream.StreamTrainer(X2, meta_s, m, c).run(
            w0, 0, STREAM_CHECK_STEPS)
        _sync(dev)
        str_launches = _launches()
        want = {"fused_grad_sum_gathered": STREAM_CHECK_STEPS * shards}
        _want_launches(f"resident fused_gather on {shards}", res_launches,
                       want)
        _want_launches(f"streamed on {shards}", str_launches, want)
        if not torch.equal(w_res, w_str):
            raise AssertionError(
                f"stream: {STREAM_CHECK_STEPS} streamed steps on {shards} "
                f"shard(s) differ from resident fused_gather (max |diff| "
                f"{float((w_res - w_str).abs().max())})")
        out["launches"][f"check {shards} shard(s)"] = str_launches[
            "fused_grad_sum_gathered"]
        print(f"[stream] {STREAM_CHECK_STEPS} streamed steps on {shards} "
              f"shard(s) = resident fused_gather bit for bit; B1 launched "
              f"{str_launches['fused_grad_sum_gathered']} times on each")
    del X2_dev
    # a segmented run (stopped after its first segment, resumed) equals
    # a straight one
    c = cfg(STREAM_SAMPLED[0], STREAM_CHECK_STEPS)
    ck = os.path.join(workdir, "stream_ck")
    _reset_launches()
    straight = ssgd_stream.train(X2, meta, mesh, c, X_te, y_te)
    ssgd_stream.train(X2, meta, mesh, dataclasses.replace(
        c, n_iterations=STREAM_SEGMENT), X_te, y_te, checkpoint_dir=ck,
        checkpoint_every=STREAM_SEGMENT)
    seg = ssgd_stream.train(X2, meta, mesh, c, X_te, y_te, checkpoint_dir=ck,
                            checkpoint_every=STREAM_SEGMENT)
    _sync(dev)
    out["launches"]["straight + segmented"] = _launches()[
        "fused_grad_sum_gathered"]
    if not torch.equal(straight.w, seg.w):
        raise AssertionError("stream: the segmented run differs from the "
                             "straight one")
    print(f"[stream] segmented at {STREAM_SEGMENT} (stopped after the first "
          f"segment, resumed) = straight bit for bit")
    del X2     # the cache stays for phase 16
    return out


def _virtual_ssgd(dev) -> dict:
    """(b) virtual SSGD: rows regenerated from their ids every step."""
    import torch

    from tpu_distalg_torch.models import ssgd, ssgd_virtual
    from tpu_distalg_torch.ops import logistic
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import metrics, prng

    mesh = get_mesh(data=1, device=dev)
    data = ssgd_virtual.VirtualData(n_rows=VIRTUAL_ROWS,
                                    n_features=VIRTUAL_FEATURES, data_seed=0)
    cfg = ssgd.SSGDConfig(
        n_iterations=VIRTUAL_STEPS, eval_test=False, sampler="virtual",
        mini_batch_fraction=VIRTUAL_FRACTION,
        gather_block_rows=VIRTUAL_GBR, init_seed=7)
    fn = ssgd_virtual.make_train_fn(mesh, cfg, data)
    _, n_blocks, n_s = ssgd_virtual._geometry(cfg, data, 1)
    w0 = logistic.init_weights(prng.root_key(7, dev), data.d)
    _sync(dev)
    rss0, now0 = _peak_rss_gb(), _rss_now_gb()
    ws, secs = [], []
    for _ in range(2):
        _reset_launches()
        t0 = time.perf_counter()
        w, _ = fn(None, None, None, None, None, w0)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        ws.append(w)
        _want_launches("virtual", _launches(), {})
    rss_gb = _peak_rss_gb() - rss0
    now_gb = _rss_now_gb() - now0
    if not torch.equal(ws[0], ws[1]):
        raise AssertionError("virtual: two runs differ")
    if not (rss_gb < 1.0 and now_gb < 1.0):
        raise AssertionError(f"virtual: host RSS grew {rss_gb} GB at its "
                             f"peak, {now_gb} GB now")
    X_ho, y_ho = ssgd_virtual.heldout_set(data, VIRTUAL_HELDOUT, dev)
    acc = float(metrics.binary_accuracy(X_ho @ ws[0], y_ho))
    rows = n_s * VIRTUAL_GBR
    rec = {"steps_per_s": VIRTUAL_STEPS / min(secs), "seconds": secs,
           "rows_regenerated_per_step": rows,
           "rows_regenerated_per_s": rows * VIRTUAL_STEPS / min(secs),
           "n_blocks": n_blocks, "n_sampled": n_s,
           "host_peak_rss_growth_gb": rss_gb, "host_rss_growth_gb": now_gb,
           "heldout_acc": acc}
    print(f"[virtual] {VIRTUAL_ROWS} logical rows x {VIRTUAL_FEATURES}, "
          f"{VIRTUAL_STEPS} steps, twice (bit for bit): {json.dumps(rec)}")
    return rec


def _kmeans_streamed(dev, workdir: str) -> dict:
    """(c) minibatch k-means on a streamed mixture, the same bytes also
    virtual and resident."""
    import torch

    from tpu_distalg_torch.data import ShardedDataset, builders
    from tpu_distalg_torch.models import kmeans
    from tpu_distalg_torch.parallel import get_mesh

    mesh = get_mesh(data=1, device=dev)
    path = os.path.join(workdir, "points")
    t0 = time.perf_counter()
    ds_s, truth = builders.gaussian_points_dataset(
        mesh, OOC_KM_POINTS, dim=OOC_KM_DIM, k=OOC_KM_K, seed=0, block_rows=OOC_KM_BLOCK,
        backend="streamed", path=path)
    gen_s = time.perf_counter() - t0
    nbytes = ds_s.n2 * ds_s.pd * ds_s.itemsize
    dss = {"streamed": ds_s,
           "virtual": ShardedDataset.from_array(
               np.array(ds_s.storage), mesh, block_rows=OOC_KM_BLOCK,
               meta=ds_s.meta),
           "resident": ShardedDataset.from_array(
               ds_s.storage, mesh, block_rows=OOC_KM_BLOCK, meta=ds_s.meta,
               backend="resident")}
    cfg = kmeans.KMeansConfig(k=OOC_KM_K, seed=0)
    c0 = kmeans.init_centers_from_dataset(ds_s, OOC_KM_K, cfg.seed)
    out, centers = {"generation_s": gen_s, "dataset_bytes": nbytes}, {}
    step_bytes = ds_s.h2d_bytes_per_step(OOC_KM_BLOCKS)
    for name, ds in dss.items():
        kmeans.fit_minibatch(ds, cfg, n_steps=3, mini_batch_blocks=OOC_KM_BLOCKS,
                             centers0=c0)       # warm
        _sync(dev)
        _reset_launches()
        t1 = time.perf_counter()
        res = kmeans.fit_minibatch(ds, cfg, n_steps=OOC_KM_STEPS,
                                   mini_batch_blocks=OOC_KM_BLOCKS, centers0=c0)
        _sync(dev)
        rate = OOC_KM_STEPS / (time.perf_counter() - t1)
        _want_launches(f"kmeans {name}", _launches(), {})
        centers[name] = res.centers
        out[name] = {"steps_per_s": rate,
                     "achieved_gb_per_s": step_bytes * rate / 1e9}
    if not (torch.equal(centers["streamed"], centers["virtual"])
            and torch.equal(centers["virtual"], centers["resident"])):
        raise AssertionError("kmeans: centres differ across backends")
    got = centers["streamed"].cpu().numpy()
    d2 = np.linalg.norm(got[:, None, :] - truth[None, :, :], axis=-1)
    worst = float(d2.min(axis=1).max())
    recovered = (sorted(d2.argmin(axis=1).tolist()) == list(range(OOC_KM_K))
                 and worst < OOC_KM_RECOVER)
    if not recovered:
        raise AssertionError(f"kmeans: centres_recovered false (worst "
                             f"{worst})")
    out.update(centers_recovered=recovered, worst=worst,
               h2d_bytes_per_step=step_bytes)
    print(f"[kmeans stream] {OOC_KM_POINTS} points x {OOC_KM_DIM} (k {OOC_KM_K}, "
          f"{nbytes} bytes) made in {gen_s!r} s; {OOC_KM_STEPS} steps of "
          f"{OOC_KM_BLOCKS} blocks: {json.dumps(out)}; centres bit for bit "
          f"across streamed, virtual, resident; every true mean recovered")
    del dss, ds_s     # the cache stays for phase 16
    return out


def _als_streamed(dev, workdir: str) -> dict:
    """(d) streamed ALS: one sweep and one rmse pass, each backend."""
    import torch

    from tpu_distalg_torch.data import ShardedDataset, builders
    from tpu_distalg_torch.models import als
    from tpu_distalg_torch.parallel import get_mesh

    mesh = get_mesh(data=1, device=dev)
    path = os.path.join(workdir, "als")
    t0 = time.perf_counter()
    ds_s, _ = builders.rank_k_rows_dataset(
        mesh, OOC_ALS_M, OOC_ALS_N, OOC_ALS_K, seed=0, block_rows=OOC_ALS_BLOCK,
        backend="streamed", path=path)
    gen_s = time.perf_counter() - t0
    nbytes = ds_s.n2 * ds_s.pd * ds_s.itemsize
    dss = {"resident": ShardedDataset.from_array(
               ds_s.storage, mesh, block_rows=OOC_ALS_BLOCK, meta=ds_s.meta,
               backend="resident"),
           "virtual": ShardedDataset.from_array(
               np.array(ds_s.storage), mesh, block_rows=OOC_ALS_BLOCK,
               meta=ds_s.meta),
           "streamed": ds_s}
    cfg = als.ALSConfig(m=OOC_ALS_M, n=OOC_ALS_N, k=OOC_ALS_K, lam=0.0, n_iterations=1)
    out, res = {"generation_s": gen_s, "dataset_bytes": nbytes}, {}
    for name, ds in dss.items():
        _sync(dev)
        _reset_launches()
        t1 = time.perf_counter()
        res[name] = als.fit_streamed(ds, cfg, rmse_every=0)
        _sync(dev)
        dt = time.perf_counter() - t1
        _want_launches(f"als {name}", _launches(), {})
        out[name] = {"sweeps_per_s": 1 / dt, "rows_solved_per_s": OOC_ALS_M / dt,
                     "achieved_gb_per_s": 2 * nbytes / dt / 1e9,
                     "rmse_after_1_sweep": float(res[name].rmse_history[-1])}
    for name in ("virtual", "streamed"):
        for f in ("U", "V", "rmse_history"):
            if not torch.equal(getattr(res[name], f),
                               getattr(res["resident"], f)):
                raise AssertionError(f"als: {name} {f} differs from "
                                     f"resident")
    print(f"[als stream] R {OOC_ALS_M} x {OOC_ALS_N} rank {OOC_ALS_K} f32 ({nbytes} "
          f"bytes) made in {gen_s!r} s; one sweep + one rmse pass, blocks of "
          f"{OOC_ALS_BLOCK} rows: {json.dumps(out)}; U, V, rmse bit for bit "
          f"across resident, virtual, streamed")
    del dss, ds_s
    for suffix in (".bin", ".meta.json"):
        os.remove(path + suffix)
    return out


#: phase 14's caches, under the checkout's ``build/``; phase 16 reads
#: the streamed SSGD and k-means ones, then the directory is deleted
OOC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "phase14")


def run_out_of_core(dev, workdir: str) -> dict:
    """Phase 14: the data subsystem's four consumers, each path driven
    with the launch counters set to 0 just before it and read just
    after; the streamed SSGD (``stream``) and k-means (``points``)
    caches stay in ``workdir`` for phase 16, the ALS cache is deleted."""
    # virtual first: its host RSS check reads the peak so far
    out = {"virtual": _virtual_ssgd(dev)}
    out["stream"] = _stream_ssgd(dev, workdir)
    out["kmeans"] = _kmeans_streamed(dev, workdir)
    out["als"] = _als_streamed(dev, workdir)
    return out


# ------------------------------------------------------------ phase 15

#: streamed PageRank at bench.py's geometry (bench.py:2753-2810,
#: PR100M_* :111-114): α 1.6, average in-degree 16, 65,536-edge blocks,
#: chunks of 2²⁴ edges, combine auto, one warm-up sweep and GRAPH_SWEEPS
#: timed ones; V cut from 10⁸ (19.2 GB of edges) to 2²³ to fit the
#: script's time (PERF.md §4)
GRAPH_VERTICES, GRAPH_AVG_IN, GRAPH_ALPHA = 1 << 23, 16.0, 1.6
GRAPH_BLOCK, GRAPH_CHUNK, GRAPH_SWEEPS = 1 << 16, 1 << 24, 2
#: staged batches in the profiled window of a sweep (its steady state)
GRAPH_WINDOW_BATCHES = 300
#: the checks at V 2²⁰ (a deduped power-law edge list, 201 MB of edge
#: rows) on 1 and GRAPH_CHECK_SHARDS emulated shards, GRAPH_CHECK_ITERS
#: sweeps, segments of GRAPH_CHECK_SEGMENT; the engine against the
#: resident CSR path within PR_RTOL / PR_ATOL, sparse against dense
#: within GRAPH_COMBINE_RTOL (the same sums in another order)
GRAPH_CHECK_VERTICES, GRAPH_CHECK_SHARDS = 1 << 20, 4
GRAPH_CHECK_ITERS, GRAPH_CHECK_SEGMENT, GRAPH_COMBINE_RTOL = 4, 2, 1e-5
#: B7 on a hub batch (n = 196,608 edges into one dst): against a float64
#: sum of the same products within GRAPH_B7_F64_RTOL (B7 sums in tiles:
#: 1.8e-8 measured), and against its plain version run on the CPU within
#: (n − 1)·2⁻²⁴, the bound on a float32 sum of n positive terms in any
#: order: the plain version's sequential adds (and on the card its
#: atomics, in no fixed order) lose up to 4.5e-4 of the hub's sum where a
#: few large ranks come first (PERF.md §6)
GRAPH_B7_F64_RTOL = 1e-6


def _b7_batch_record(dev, staged, ranks) -> dict:
    """B7 on one staged hub batch (its rows one run into vertex 0, over
    every tile) against its plain version and a float64 sum, timed
    beside the plain version, cuSPARSE's CSR product and the bound (each
    input read once: row_ptr, src, w and y, and x at this batch's
    distinct sources). ``batch_ms`` is B7 on a plan made beforehand;
    ``batch_call_ms`` the call as the engine makes it (the plan made in
    the call), with the plan and the run structure also timed apart."""
    import warnings

    import torch

    from tpu_distalg_torch.ops import graph as gops
    from tpu_distalg_torch.ops import pagerank_kernels as pk

    rp, src, w, _ = gops.block_runs(staged, 0, 8)
    n = src.shape[0]
    runs = int((rp[1:] > rp[:-1]).sum())
    got = pk.spmv_table(rp, src, w, ranks)
    want = pk.spmv_table_reference(rp.cpu(), src.cpu(), w.cpu(),
                                   ranks.cpu()).to(dev)
    on_card = pk.spmv_table_reference(rp, src, w, ranks)
    exact = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, pk._rows(rp), ranks.double()[src.long()] * w.double())
    torch.cuda.synchronize()

    def rel(y):
        return float(((y.double() - exact).abs()
                      / exact.abs().clamp_min(1e-30)).max())

    f64 = {"b7": rel(got), "plain_cpu": rel(want),
           "plain_card_atomics": rel(on_card)}
    print(f"[graph] B7 hub batch ({runs} run(s), {n} edges): largest "
          f"relative error against a float64 sum: {json.dumps(f64)}")
    if f64["b7"] > GRAPH_B7_F64_RTOL:
        raise AssertionError(f"B7 hub batch: {f64['b7']!r} from the float64 "
                             f"sum, want <= {GRAPH_B7_F64_RTOL}")
    err = _pr_close(f"B7 hub batch ({runs} run(s), {n} edges)", got, want,
                    (n - 1) * 2.0 ** -24)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        A = torch.sparse_csr_tensor(rp, src, w, (n, ranks.shape[0]),
                                    check_invariants=False)
    plan = pk.tile_plan(rp, n)
    distinct = int(torch.unique(src).numel())
    nbytes = 4 * (n + 1) + 8 * n + 4 * n + 4 * distinct
    bound = _bound_ms(nbytes, 2 * n)
    rec = {"batch_max_abs_err": err, "batch_runs": runs,
           "batch_rel_err_vs_float64": f64,
           "batch_edges": n,
           "batch_ms": _time_ms(lambda: pk.spmv_table(rp, src, w, ranks,
                                                      plan)),
           "batch_call_ms": _time_ms(lambda: pk.spmv_table(rp, src, w,
                                                           ranks)),
           "batch_plain_ms": _time_ms(
               lambda: pk.spmv_table_reference(rp, src, w, ranks), 20, 2),
           "batch_library_ms": _time_ms(lambda: A @ ranks, 50, 5),
           "batch_bound_ms": bound[0], "batch_bound_by": bound[1],
           "batch_bytes": nbytes,
           "batch_tile_plan_ms": _time_ms(lambda: pk.tile_plan(rp, n)),
           "batch_runs_ms": _time_ms(lambda: gops.block_runs(staged, 0, 8))}
    acc = torch.zeros(9, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    for _ in range(50):
        gops.accumulate_block(acc, ranks, staged, 0)
    torch.cuda.synchronize()
    rec["batch_accumulate_wall_ms"] = (time.perf_counter() - t0) * 1e3 / 50
    return rec


def _graph_checks(dev, workdir: str) -> dict:
    """The engine's contracts on the card at V 2²⁰, on 1 and
    GRAPH_CHECK_SHARDS emulated shards: streamed = virtual = resident
    bit for bit, a replay bit for bit, segmented = straight, sparse vs
    dense, and the engine vs the resident CSR path; B7 launches counted
    on each run."""
    import torch

    from tpu_distalg_torch import graphs
    from tpu_distalg_torch.graphs import engine
    from tpu_distalg_torch.models import pagerank
    from tpu_distalg_torch.parallel import get_mesh

    # a power-law multigraph's rows, deduped into a plain edge list (the
    # resident path dedupes what it is given)
    mm, header = graphs.build_powerlaw_block_cache(
        os.path.join(workdir, "pl20"), n_vertices=GRAPH_CHECK_VERTICES,
        n_shards=1, avg_in_degree=GRAPH_AVG_IN, alpha=GRAPH_ALPHA, seed=1,
        block_edges=GRAPH_BLOCK, chunk_edges=GRAPH_CHUNK)
    edges = np.asarray(mm[:header["geom"]["n_edges"], :2], np.int64)
    out = {}
    for shards in (1, GRAPH_CHECK_SHARDS):
        path = os.path.join(workdir, f"e20_s{shards}")
        graphs.build_edge_block_cache(
            edges, path, n_shards=shards, block_edges=GRAPH_BLOCK,
            n_vertices=GRAPH_CHECK_VERTICES)
        mesh = get_mesh(data=shards, device=dev)
        cfg = graphs.StreamedPageRankConfig(n_iterations=GRAPH_CHECK_ITERS)
        ranks, launches = {}, {}
        for backend in ("streamed", "virtual", "resident", "replay"):
            gd = graphs.open_graph_dataset(
                path, mesh, backend="streamed" if backend == "replay"
                else backend)
            n_batches = len(engine._block_schedule(
                gd.ds.n_blocks, shards, cfg.batch_blocks))
            _reset_launches()
            res = graphs.run_streamed_pagerank(gd, cfg)
            _sync(dev)
            launches[backend] = _launches()["spmv_table"]
            _want_launches(f"graph {backend} on {shards}", _launches(), {
                "spmv_table": GRAPH_CHECK_ITERS * n_batches * shards})
            ranks[backend] = res.ranks
        for backend in ("virtual", "resident", "replay"):
            if not torch.equal(ranks[backend], ranks["streamed"]):
                raise AssertionError(
                    f"graph on {shards} shard(s): {backend} differs from "
                    f"streamed (max |d| "
                    f"{float((ranks[backend] - ranks['streamed']).abs().max())})")
        gd = graphs.open_graph_dataset(path, mesh)
        ck = os.path.join(workdir, f"ck{shards}")
        graphs.run_streamed_pagerank(gd, graphs.StreamedPageRankConfig(
            n_iterations=GRAPH_CHECK_SEGMENT), checkpoint_dir=ck,
            checkpoint_every=GRAPH_CHECK_SEGMENT)
        seg = graphs.run_streamed_pagerank(gd, cfg, checkpoint_dir=ck,
                                           checkpoint_every=GRAPH_CHECK_SEGMENT)
        if not torch.equal(seg.ranks, ranks["streamed"]):
            raise AssertionError(f"graph on {shards} shard(s): segmented "
                                 f"differs from straight")
        other = {"sparse": "dense", "dense": "sparse"}[
            engine.resolve_combine("auto", gd.k_sparse, gd.n_vertices,
                                   shards)]
        alt = graphs.run_streamed_pagerank(gd, graphs.StreamedPageRankConfig(
            n_iterations=GRAPH_CHECK_ITERS, combine=other)).ranks
        d_comb = _pr_close(f"graph {other} vs auto on {shards}", alt,
                           ranks["streamed"], GRAPH_COMBINE_RTOL)
        res_ranks = pagerank.run(edges, mesh, pagerank.PageRankConfig(
            n_iterations=GRAPH_CHECK_ITERS, mode="standard"),
            GRAPH_CHECK_VERTICES).ranks
        d_res = _pr_close(f"graph engine vs resident on {shards}",
                          ranks["streamed"], res_ranks, PR_RTOL)
        out[f"{shards} shard(s)"] = {
            "edges": gd.n_edges, "k_sparse": gd.k_sparse,
            "launches": launches, "max_abs_d_other_combine": d_comb,
            "max_abs_d_vs_resident_csr": d_res}
        print(f"[graph] V {GRAPH_CHECK_VERTICES} ({gd.n_edges} deduped "
              f"edges) on {shards} shard(s): streamed = virtual = resident "
              f"= replay bit for bit, segmented = straight; {other} combine "
              f"within rtol {GRAPH_COMBINE_RTOL} (max |d| {d_comb!r}); vs "
              f"models.pagerank standard within rtol {PR_RTOL}, atol "
              f"{PR_ATOL} (max |d| {d_res!r}); B7 launches {launches}")
    return out


def run_graph(dev) -> dict:
    """Phase 15: streamed PageRank at bench.py's geometry (V cut to 2²³)
    through the graph engine and B7 on each staged batch, then the
    engine's checks at V 2²⁰; the caches live under ``build/`` and are
    deleted."""
    import shutil

    import torch

    import dataclasses

    from tpu_distalg_torch import graphs, native
    from tpu_distalg_torch.graphs import engine
    from tpu_distalg_torch.parallel import comms, get_mesh
    from tpu_distalg_torch.tools.profiling import window

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase15")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        native.reset_calls()
        t0 = time.perf_counter()
        _, header = graphs.build_powerlaw_block_cache(
            os.path.join(workdir, "pl"), n_vertices=GRAPH_VERTICES,
            n_shards=1, avg_in_degree=GRAPH_AVG_IN, alpha=GRAPH_ALPHA,
            seed=0, block_edges=GRAPH_BLOCK, chunk_edges=GRAPH_CHUNK)
        gen_s = time.perf_counter() - t0
        packs = native.calls["pack_edge_rows"]
        if not native.available() or packs["numpy"] or not packs["native"]:
            raise AssertionError(f"graph ingest: the C++ binding did not "
                                 f"run ({native.load_error()}; {packs})")
        geom = header["geom"]
        E = int(geom["n_edges"])
        edge_bytes = E * 12
        print(f"[graph] power-law cache V {GRAPH_VERTICES}, {E} edges "
              f"({edge_bytes} bytes of rows, k {geom['k_sparse']}, window "
              f"{geom['window']}) made in {gen_s!r} s through the C++ "
              f"binding ({packs['native']} pack_edge_rows calls native, "
              f"{packs['numpy']} numpy)")
        mesh = get_mesh(data=1, device=dev)
        gd = graphs.open_graph_dataset(os.path.join(workdir, "pl"), mesh)
        cfg = graphs.StreamedPageRankConfig(n_iterations=GRAPH_SWEEPS)
        ids = engine._block_schedule(gd.ds.n_blocks, 1, cfg.batch_blocks)
        n_batches = len(ids)
        graphs.run_streamed_pagerank(gd, dataclasses.replace(
            cfg, n_iterations=1))                       # warm
        _sync(dev)
        _reset_launches()
        t0 = time.perf_counter()
        res = graphs.run_streamed_pagerank(gd, cfg)
        total = float(res.ranks.sum())
        dt = time.perf_counter() - t0
        launches = _launches()
        _want_launches("graph streamed sweeps", launches,
                       {"spmv_table": GRAPH_SWEEPS * n_batches})
        if not (bool(torch.isfinite(res.ranks).all())
                and abs(total - 1.0) <= 1e-3):
            raise AssertionError(f"graph: ranks finite "
                                 f"{bool(torch.isfinite(res.ranks).all())}, "
                                 f"sum {total!r}")
        st = comms.rank_combine_stats(gd.k_sparse, gd.n_vertices, 1)
        batch_bytes = gd.ds.h2d_bytes_per_step(ids.shape[2])
        host = gd.ds.host_batch(ids[1])
        gather = _rate_gb(batch_bytes, lambda: gd.ds.gather(
            ids[1], out=getattr(host, "array", host)), 5)

        zeros_fn, accum_fn, _, _ = engine.make_sweep_fns(gd, cfg)

        def partial():
            acc = zeros_fn()
            for staged in gd.ds.stream(ids[:GRAPH_WINDOW_BATCHES]):
                acc = accum_fn(acc, staged, res.ranks)

        prof = window(partial, GRAPH_WINDOW_BATCHES)
        out = {"generation_s": gen_s, "n_edges": E, "edge_bytes": edge_bytes,
               "k_sparse": gd.k_sparse, "window": gd.window,
               "staged_batches_per_sweep": n_batches,
               "batch_bytes": batch_bytes,
               "sweeps_per_s": GRAPH_SWEEPS / dt,
               "ns_per_edge": 1e9 * dt / (GRAPH_SWEEPS * E),
               "h2d_gb_per_s": edge_bytes * GRAPH_SWEEPS / dt / 1e9,
               "host_gather_gb_per_s": gather,
               "combine": res.combine,
               "combine_bytes_wire_per_sweep": res.comm_stats["bytes_wire"],
               "combine_bytes_dense_ring_per_sweep": st["bytes_dense_ring"],
               "b7_launches_per_sweep": launches["spmv_table"] / GRAPH_SWEEPS,
               "launches": launches["spmv_table"], **prof}
        print(f"[graph] streamed, combine={res.combine}: {GRAPH_SWEEPS} "
              f"sweeps in {dt!r} s = {out['sweeps_per_s']!r} sweeps/s, "
              f"{out['ns_per_edge']!r} ns/edge, {out['h2d_gb_per_s']!r} GB/s "
              f"H2D; {n_batches} staged batches of {batch_bytes} bytes a "
              f"sweep, B7 launched {launches['spmv_table']} times (batches x "
              f"shards x sweeps); wire {res.comm_stats['bytes_wire']} B a "
              f"sweep vs dense ring {st['bytes_dense_ring']} B; host gather "
              f"{gather!r} GB/s; Σranks {total!r}")
        print(f"[graph] {GRAPH_WINDOW_BATCHES} staged batches profiled: "
              f"{json.dumps(prof)}")
        staged = gd.ds.stage(ids[0])[0]
        out["b7"] = _b7_batch_record(dev, staged, res.ranks)
        print(f"[graph] B7 on the first staged batch (the hub): "
              f"{json.dumps(out['b7'])}")
        del gd, res, staged
        out["checks"] = _graph_checks(dev, workdir)
        if native.calls["pack_edge_rows"]["numpy"] or \
                native.calls["counting_sort_perm"]["numpy"]:
            raise AssertionError(f"graph ingest fell back to numpy: "
                                 f"{native.calls}")
        out["native_calls"] = {k: dict(v) for k, v in native.calls.items()}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


# ------------------------------------------------------------ phase 16

#: phase 16's workloads (``tools/multiproc_run.py``) and the kernel each
#: launches, by B number
MP_KERNELS = {"ssgd_fused_gather": ("B1",), "ssgd_fused": ("B5",),
              "ma_fused_train": ("B2",), "ma_fused_gather": ("B1",),
              "ssgd_tp": ("B3", "B4"), "kmeans_fused": ("B10",),
              "pagerank_auto": ("B7",), "pagerank_pallas": ("B8",),
              **{f"sync_{c}": ("B1",) for c in (
                  "dense", "bucketed", "hier", "bf16", "int8", "int8_seq",
                  "topk", "ssp_straggle", "ssp_leave")},
              "sync_ma_int8": ("B2",), "sync_ma_topk": ("B2",),
              # bench.py's straggler bench on `bernoulli`: no kernel
              "sync_bsp_straggler": (), "sync_ssp_straggler": ()}
#: the workloads that crossed processes last and their kernels;
#: ``serve_dense`` merges with a matmul (no B9), minibatch k-means and
#: ALS and the closure run torch ops
MP_A9_KERNELS = {"als": (), "serve_sparse": ("B9",), "serve_dense": (),
                 "closure_dense": (), "closure_sparse": (),
                 "stream_ssgd": ("B1",), "stream_kmeans": (),
                 "stream_pagerank": ("B7",),
                 "ring_contiguous": ("B11", "B12"),
                 "ring_zigzag": ("B11", "B12"), "ulysses": ("B11", "B12")}
#: the closure of bench.py's DAG at V 6800 (the host DP's count,
#: ``utils/datasets.closure_host_count``)
MP_CLOSURE_PATHS = 10_316_480
MP_TIMEOUT_S = 600
#: phase 16's results a rank holds only its rows of (the replicas'
#: models, which the ``local_sgd`` table cuts over the data axis)
MP_ROW_SHARDED = ("ma_fused_train/ws", "ma_fused_gather/ws",
                  "sync_ma_int8/ws", "sync_ma_topk/ws", "als/U",
                  "als_ckpt/U", "closure_dense/rows") + tuple(
    f"{w}/{k}_sha" for w in ("ring_contiguous", "ring_zigzag", "ulysses")
    for k in ("out", "dq", "dk", "dv"))
#: results that depend on the timing of a run (the batches a closed loop
#: made), kept but not compared
MP_UNCOMPARED = ("serve_sparse/batches", "serve_dense/batches")
#: results a rank holds an uneven part of: the sparse closure's pairs, a
#: process's slots of the buffer; the ranks' parts in order are the whole
MP_UNEVEN_ROWS = ("closure_sparse/rows",)
#: the one process's results of the checkpoint split across a restart
#: that the ranks do not make (they write the first half)
MP_ONE_PROCESS_ONLY = ("sync_ckpt/w_resumed", "sync_ckpt/w")


def _mp_spawn(out: str, tag: str, args_for: list) -> list:
    """Start one ``multiproc_run`` process per argument list, all at
    once; wait for all; raise with their output unless each exits 0."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs, logs = [], []
    for i, extra in enumerate(args_for):
        log = open(os.path.join(out, f"{tag}{i}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpu_distalg_torch.tools.multiproc_run",
             "--out", out, *extra], cwd=repo, env=env, stdout=log,
            stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=MP_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for p, log in zip(procs, logs):
        log.seek(0)
        texts.append(log.read())
        log.close()
        if p.returncode != 0:
            raise AssertionError(f"phase 16 {tag} process exited "
                                 f"{p.returncode}:\n{texts[-1][-4000:]}")
    return texts


def _mp_load(out: str, tag: str) -> tuple:
    with np.load(os.path.join(out, f"{tag}.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(out, f"{tag}.json")) as f:
        return arrays, json.load(f)


def run_multiproc(dev, ooc_dir: str) -> dict:
    """Phase 16: two gloo ranks on the card, one process alone and a
    world-1 NCCL group, each its own process; their results compared bit
    for bit. ``ooc_dir`` holds phase 14's caches. Returns each kernel's
    launches a rank and the rates."""
    import torch

    from tpu_distalg_torch.tools import multiproc_run

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()   # the card's memory to the children
    names = list(MP_KERNELS)
    a9 = [w for w in multiproc_run.A9_WORKLOADS if w != "als_ckpt"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mp-") as out:
        nccl_out = os.path.join(out, "nccl")
        os.makedirs(nccl_out)
        common = ["--ooc-dir", ooc_dir, "--cache-dir", out]
        everything = ["--workloads", ",".join(multiproc_run.WORKLOADS)]
        t0 = time.perf_counter()
        _mp_spawn(out, "rank", [
            ["--init", f"file://{out}/rendezvous", "--world", "2",
             "--rank", str(r), *everything, *common] for r in (0, 1)])
        t_pair = time.perf_counter() - t0
        _mp_spawn(out, "single", [["--no-profile", *everything, *common]])
        _mp_spawn(nccl_out, "nccl", [
            ["--init", f"file://{nccl_out}/rendezvous", "--world", "1",
             "--rank", "0", "--workloads", ",".join(
                 ["ssgd_fused_gather", "sync_hier",
                  *multiproc_run.A9_WORKLOADS]), "--no-profile", *common]])
        single, s_info = _mp_load(out, "single")
        ranks = [_mp_load(out, f"rank{r}") for r in (0, 1)]
        nccl, n_info = _mp_load(nccl_out, "rank0")
    for r, (_, info) in enumerate(ranks):
        if (info["backend"], info["process_count"], info["local_data"]) != (
                "gloo", 2, [r]):
            raise AssertionError(f"rank {r}: {info['backend']} over "
                                 f"{info['process_count']} processes, shards "
                                 f"{info['local_data']}")
    if (n_info["backend"], n_info["process_count"]) != ("nccl", 1):
        raise AssertionError(f"world-1 group: backend {n_info['backend']}")
    for key, whole in single.items():
        if key in MP_ONE_PROCESS_ONLY or key in MP_UNCOMPARED:
            continue
        for r, (arrays, _) in enumerate(ranks):
            got = arrays[key]
            want = whole
            if key in MP_UNEVEN_ROWS:
                lo = sum(len(a[key]) for a, _ in ranks[:r])
                want = whole[lo:lo + len(got)]
                if r == 1 and lo + len(got) != len(whole):
                    raise AssertionError(f"phase 16: the ranks hold "
                                         f"{lo + len(got)} of {key}'s "
                                         f"{len(whole)} rows")
            elif key in MP_ROW_SHARDED:
                # rank r holds its rows of a row-sharded result
                n = whole.shape[0] // 2
                want = whole[r * n:(r + 1) * n]
            if got.shape != want.shape:
                raise AssertionError(f"phase 16: rank {r}'s {key} is "
                                     f"{got.shape}, want {want.shape}")
            if got.tobytes() != want.tobytes():
                raise AssertionError(
                    f"phase 16: rank {r}'s {key} differs from one process "
                    f"× 2 shards (largest difference "
                    f"{float(np.abs(got - want).max())!r})")
    for key, got in nccl.items():
        if key in MP_UNCOMPARED:
            continue
        if got.tobytes() != single[key].tobytes():
            raise AssertionError(f"phase 16: the NCCL group's {key} differs "
                                 f"from one process's")
    if single["sync_ckpt/w_resumed"].tobytes() != \
            single["sync_ckpt/w"].tobytes():
        raise AssertionError("phase 16: the run the pair checkpointed and "
                             "one process resumed differs from the "
                             "straight run")
    for f in ("U", "V"):
        if single[f"als_ckpt/{f}"].tobytes() != single[f"als/{f}"].tobytes():
            raise AssertionError(f"phase 16: ALS resumed from its "
                                 f"checkpoint differs from the straight "
                                 f"fit ({f})")
    for name in ("closure_dense", "closure_sparse"):
        if int(single[f"{name}/n"]) != MP_CLOSURE_PATHS:
            raise AssertionError(f"phase 16: {name} closed to "
                                 f"{int(single[f'{name}/n'])} paths, not "
                                 f"{MP_CLOSURE_PATHS}")
    print(f"[multiproc] 2 gloo ranks on one card ({t_pair!r} s for the "
          f"pair, start-up and data included): every result of "
          f"{len(single) - len(MP_ONE_PROCESS_ONLY) - len(MP_UNCOMPARED)} "
          f"equals one process × 2 shards (the sync_* runs × 4) bit for "
          f"bit; a run the pair checkpointed at step {_mp_half()} and one "
          f"process resumed equals the straight run, ALS resumed from "
          f"its checkpoint the straight fit; a world-1 NCCL group's "
          f"ssgd_fused_gather, sync_hier and {', '.join(a9)} too")
    rates, launches = {}, {}
    for name in names:
        st = [info["stats"][name] for _, info in ranks]
        one = s_info["stats"][name]
        d = st[0]["dist"]
        rates[name] = {
            "steps_per_s_ranks": [x["steps_per_s"] for x in st],
            "steps_per_s_one_process": one["steps_per_s"],
            "collectives": d["collectives"], "bytes_sent": d["bytes_sent"],
            "host_copies": d["host_copies"],
            "host_copy_share": [x["host_copy_share"] for x in st],
            "idle_share": [x["idle_share"] for x in st],
            "setup_seconds": [x["setup_seconds"] for x in st],
            "window_wall_us_per_step": [x["window_wall_us_per_step"]
                                        for x in st],
            "device_us_per_step": [x["device_us_per_step"] for x in st]}
        if "bytes_closed_form" in st[0]:
            rates[name].update(
                bytes_sent_ranks=[x["dist"]["bytes_sent"] for x in st],
                bytes_closed_form=[x["bytes_closed_form"] for x in st],
                bytes_dense=[x["bytes_dense"] for x in st])
            print(f"[multiproc] {name}: bytes sent a rank "
                  f"{rates[name]['bytes_sent_ranks']} = the closed form "
                  f"{rates[name]['bytes_closed_form']}, dense's all-gather "
                  f"{rates[name]['bytes_dense']}")
        launches[name] = st[0]["launches"]
        print(f"[multiproc] {name}: {rates[name]['steps_per_s_ranks']} "
              f"steps/s a rank vs {one['steps_per_s']!r} in one process; "
              f"{d['collectives']} collectives, {d['bytes_sent']} B sent a "
              f"rank, {d['host_copies']} host copies "
              f"({rates[name]['host_copy_share']} of the wall time); idle "
              f"share {rates[name]['idle_share']}; launches a rank "
              f"{launches[name]}; set-up {rates[name]['setup_seconds']} s; "
              f"profiled window "
              f"{rates[name]['window_wall_us_per_step']} µs a step wall, "
              f"{rates[name]['device_us_per_step']} µs device")
    for name in a9:
        st = [info["stats"][name] for _, info in ranks]
        one = s_info["stats"][name]
        d = [x["dist"] for x in st]
        rates[name] = {
            "steps": one["steps"],
            "steps_per_s_ranks": [x["steps_per_s"] for x in st],
            "steps_per_s_one_process": one["steps_per_s"],
            "steps_per_s_nccl": n_info["stats"][name]["steps_per_s"],
            "seconds_ranks": [x["seconds"] for x in st],
            "seconds_one_process": one["seconds"],
            "collectives": [x["collectives"] for x in d],
            "bytes_sent": [x["bytes_sent"] for x in d],
            "host_copies": [x["host_copies"] for x in d],
            "host_copy_share": [x["host_copy_share"] for x in st],
            "setup_seconds": [x["setup_seconds"] for x in st]}
        launches[name] = [x["launches"] for x in st]
        print(f"[multiproc] {name}: {rates[name]['seconds_ranks']} s a "
              f"rank ({rates[name]['steps_per_s_ranks']} steps/s, "
              f"{one['steps']} steps) vs {one['seconds']!r} s in one "
              f"process, {rates[name]['steps_per_s_nccl']!r} steps/s in "
              f"the NCCL group; {rates[name]['collectives']} collectives, "
              f"{rates[name]['bytes_sent']} B sent, "
              f"{rates[name]['host_copies']} host copies "
              f"({rates[name]['host_copy_share']} of the wall time) a "
              f"rank; launches a rank {launches[name]}; set-up "
              f"{rates[name]['setup_seconds']} s")
    for key, wrapper in (("B1", "fused_grad_sum_gathered"),
                         ("B7", "spmv_table"), ("B9", "fused_matmul_topk"),
                         ("B11", "flash_attention_block"),
                         ("B12", "flash_attention_backward_block")):
        for r in (0, 1):
            n = sum(launches[w][r].get(wrapper, 0)
                    for w, keys in MP_A9_KERNELS.items() if key in keys)
            if n < 1:
                raise AssertionError(f"phase 16: rank {r} launched {key} "
                                     f"no time on the workloads that "
                                     f"cross processes now")
    for name in ("closure_dense", "closure_sparse"):
        print(f"[multiproc] {name}: {int(single[f'{name}/n'])} paths in "
              f"{int(single[f'{name}/rounds'])} rounds on every arm")
    n1 = n_info["stats"]["ssgd_fused_gather"]
    print(f"[multiproc] NCCL world 1, ssgd_fused_gather: "
          f"{n1['steps_per_s']!r} steps/s, {n1['dist']['collectives']} "
          f"all-gathers, {n1['dist']['host_copies']} host copies")
    sp = {"ranks": [st["sync_ssp_straggler"]["steps_per_s"]
                    / st["sync_bsp_straggler"]["steps_per_s"]
                    for st in (info["stats"] for _, info in ranks)],
          "one_process": s_info["stats"]["sync_ssp_straggler"][
              "steps_per_s"] / s_info["stats"]["sync_bsp_straggler"][
              "steps_per_s"]}
    print(f"[multiproc] SSP straggler speedup (ssp:8 over BSP, bench.py's "
          f"plan): {sp['ranks']} a rank of two, {sp['one_process']!r} in "
          f"one process × 4 shards")
    h1 = n_info["stats"]["sync_hier"]
    print(f"[multiproc] NCCL world 1, sync_hier (4 shards in the "
          f"process): {h1['steps_per_s']!r} steps/s against "
          f"{s_info['stats']['sync_hier']['steps_per_s']!r} with no "
          f"group, {h1['dist']['collectives']} collectives")
    ck = [info["stats"]["sync_ckpt"] for _, info in ranks]
    print(f"[multiproc] sync_ckpt: the pair's first half in "
          f"{[x['seconds'] for x in ck]} s a rank, "
          f"{[x['dist']['bytes_sent'] for x in ck]} B sent a rank (the "
          f"syncs and the checkpoint's gathers); one process's resume, "
          f"straight run and half in "
          f"{s_info['stats']['sync_ckpt']['seconds']!r} s")
    return {"rates": rates, "launches": launches,
            "nccl_steps_per_s": n1["steps_per_s"], "ssp_speedup": sp}


# ------------------------------------------------------------ phase 17

#: (a): phase 6's fused_gather geometry, checkpointed in segments, under
#: a plan that corrupts one save, kills one segment and fails one write
REC_STEPS, REC_EVERY, REC_RESTARTS = 1500, 250, 3
REC_PLAN = "seed=5;ckpt:write@1=corrupt;segment:run@2=kill;ckpt:write@3=oserror"
#: (b), the command line's part: fused_gather on the reference task
#: (breast cancer, 569 rows), slowed at each segment so a SIGTERM lands
#: inside the run; (b)'s full-width part runs in _rec_restarts
PREEMPT_ARGS = ["ssgd", "--sampler", "fused_gather", "--fused-pack", "4",
                "--gather-block-rows", "32", "--shuffle-seed", "0",
                "--n-iterations", "1500", "--checkpoint-every", "250",
                "--quiet"]
PREEMPT_PLAN = "seed=1;segment:run@*=hang:0.4"
#: (c): phase 4's artifact under a torn first read and a 10% batch loss
SERVE_PLAN = "seed=3;ckpt:read@0=corrupt;data:gather@p0.1=oserror"
SERVE_RETRIES = 8
#: (d): one plan each, as tests/test_torch_chaos.py holds them against
#: the JAX package: (workload, shards, plan, iterations, segment)
CHAOS_CASES = (
    ("lr", 8, "seed=5;ckpt:write@1=corrupt;segment:run@2=kill", None, None),
    ("ssgd", 8, "seed=13;ckpt:write@1=oserror;segment:run@2=kill", None,
     None),
    ("kmeans", 8, "seed=5;ckpt:write@1=corrupt;segment:run@2=kill", None,
     None),
    ("als", 8, "seed=5;ckpt:write@1=kill;ckpt:read@0=oserror", None, None),
    ("kmeans_stream", 4, "seed=8;data:gather@1=kill", None, None),
    ("pagerank_stream", 4, "seed=8;data:gather@3=oserror;segment:run@1=kill",
     None, None),
    ("ssp", 4, "seed=9;shard:straggle@p0.2=straggle:25", 64, 16),
    ("serve", 8, "seed=3;ckpt:read@0=corrupt;data:gather@2=oserror", None,
     None))
#: (e): a hang past the supervisor's deadline at the first init attempt
INIT_PLAN, INIT_TIMEOUT, INIT_RETRIES = "seed=4;backend:init@0=hang:0.3", \
    0.05, 20


def _same(what: str, got, want) -> None:
    import torch

    g = got.cpu() if isinstance(got, torch.Tensor) else torch.as_tensor(got)
    w = want.cpu() if isinstance(want, torch.Tensor) else torch.as_tensor(want)
    if not torch.equal(g, w):
        raise AssertionError(f"{what}: not bitwise equal")


def _sigterm_after_first_checkpoint(run, d: str):
    """Run ``run()`` with the preemption handlers installed while a
    thread sends this process SIGTERM once the first checkpoint is in
    ``d``; return the ``Preempted`` it raised. The handlers before it
    are put back."""
    import signal
    import threading

    from tpu_distalg_torch.faults import preempt
    from tpu_distalg_torch.utils import checkpoint

    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    done = threading.Event()

    def watch():
        while not done.is_set():
            if checkpoint.latest_step(d) is not None:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.001)

    preempt.reset()
    if not preempt.install():
        raise AssertionError("(b) the preemption handlers did not install")
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        run()
    except preempt.Preempted as e:
        return e
    finally:
        done.set()
        watcher.join()
        for sig, handler in before.items():
            signal.signal(sig, handler)
        seen = preempt.signals_seen()
        preempt.reset()
    raise AssertionError(f"(b) the run ended without stopping at a "
                         f"boundary (signals seen {seen})")


def _rec_restarts(dev, smi: str) -> dict:
    """(a): B1 at phase 6's geometry, straight, in undisturbed segments
    and under REC_PLAN with run_with_restarts; then (b) at the same
    geometry: SIGTERM after the first checkpoint stops the run at a
    boundary with rc 75, and the resumed run's final checkpoint equals
    the undisturbed segmented run's bit for bit."""
    import dataclasses

    import torch

    from tpu_distalg_torch import faults
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import checkpoint, datasets

    mesh = get_mesh(data=1, device=dev)
    X, y = datasets.synthetic_two_class(SSGD_ROWS, SSGD_FEATURES, seed=0)
    X = datasets.add_bias_column(X)
    cfg = ssgd.SSGDConfig(
        n_iterations=REC_STEPS, eval_test=False, x_dtype="bfloat16",
        sampler="fused_gather", gather_block_rows=SSGD_GBR, shuffle_seed=0,
        init_seed=7)
    _, X2, w0, meta = ssgd.prepare_fused(X, y, mesh, cfg)
    del X, y
    te = (torch.zeros((1, meta["d_total"]), device=dev),
          torch.zeros((1,), device=dev))
    cfg = dataclasses.replace(cfg, sampler="fused_gather")

    def train(d=None):
        return ssgd.train_prepared(mesh, cfg, X2, w0, meta, *te,
                                   checkpoint_dir=d,
                                   checkpoint_every=REC_EVERY)

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-rec-") as work:
        train()                                  # warm
        torch.cuda.synchronize()
        for name, run in (
                ("straight", lambda: train()),
                ("segmented", lambda: train(os.path.join(work, "seg"))),
                ("chaos", lambda: checkpoint.run_with_restarts(
                    lambda: train(os.path.join(work, "chaos")),
                    max_restarts=REC_RESTARTS, logger=lambda m: None))):
            if name == "chaos":
                reg = faults.configure(REC_PLAN)
            _reset_launches()
            t1 = time.perf_counter()
            try:
                res = run()
                torch.cuda.synchronize()
            finally:
                if name == "chaos":
                    fired = list(reg.fired)
                    faults.configure(False)
            out[name] = {"s": time.perf_counter() - t1, "w": res.w,
                         "accs": res.accs,
                         "b1": _launches()["fused_grad_sum_gathered"]}
        pre = os.path.join(work, "pre")
        _reset_launches()
        t1 = time.perf_counter()
        stop = _sigterm_after_first_checkpoint(lambda: train(pre), pre)
        torch.cuda.synchronize()
        pre_s, pre_b1 = (time.perf_counter() - t1,
                         _launches()["fused_grad_sum_gathered"])
        _reset_launches()
        t1 = time.perf_counter()
        res = train(pre)
        torch.cuda.synchronize()
        out["resumed"] = {"s": time.perf_counter() - t1, "w": res.w,
                          "accs": res.accs,
                          "b1": _launches()["fused_grad_sum_gathered"]}
        (got, s1), (want, s2) = (checkpoint.restore(pre),
                                 checkpoint.restore(os.path.join(work,
                                                                 "seg")))
        if s1 != s2 or len(got["state"]) != len(want["state"]):
            raise AssertionError(f"(b) final steps {s1} vs {s2}")
        for i, (g, w) in enumerate(zip(got["state"], want["state"])):
            _same(f"(b) final checkpoint leaf {i} vs the segmented run's",
                  g, w)
        _same("(b) final checkpoint accs vs the segmented run's",
              got["accs"], want["accs"])
    if stop.code != faults.PREEMPTED_RC or stop.step is None or \
            stop.step % REC_EVERY or not 0 < stop.step < REC_STEPS:
        raise AssertionError(f"(b) stopped with code {stop.code} at step "
                             f"{stop.step}: want {faults.PREEMPTED_RC} at "
                             f"a boundary inside the run")
    if pre_b1 != stop.step or out["resumed"]["b1"] != REC_STEPS - stop.step:
        raise AssertionError(
            f"(b) B1 launches {pre_b1} to the stop at {stop.step} and "
            f"{out['resumed']['b1']} on the resume: want {REC_STEPS} in all")
    for name in ("segmented", "chaos", "resumed"):
        _same(f"(a) {name} w vs straight", out[name]["w"],
              out["straight"]["w"])
        _same(f"(a) {name} accs vs straight", out[name]["accs"],
              out["straight"]["accs"])
    want_fired = [("ckpt:write", 1, "corrupt"), ("segment:run", 2, "kill"),
                  ("ckpt:write", 3, "oserror")]
    if fired != want_fired:
        raise AssertionError(f"(a) fired {fired}, want {want_fired}")
    # the kill lands before the third segment runs, and the resume comes
    # back from step 250 (step 500's file is the corrupt one): one segment
    # of REC_EVERY steps runs twice
    want_b1 = out["segmented"]["b1"] + REC_EVERY
    if out["segmented"]["b1"] != REC_STEPS or out["chaos"]["b1"] != want_b1:
        raise AssertionError(
            f"(a) B1 launches: segmented {out['segmented']['b1']}, chaos "
            f"{out['chaos']['b1']}, want {REC_STEPS} and {want_b1}")
    cost = out["chaos"]["s"] - out["segmented"]["s"]
    print(f"[recovery] (a) fused_gather (B1) {SSGD_ROWS} rows, {REC_STEPS} "
          f"steps in segments of {REC_EVERY} under {REC_PLAN!r}, "
          f"max_restarts {REC_RESTARTS}: w and accs bitwise equal to the "
          f"undisturbed segmented run and to the straight one; fired "
          f"{fired}; B1 launches {out['chaos']['b1']} = {REC_STEPS} + the "
          f"replayed segment's {REC_EVERY}; straight "
          f"{out['straight']['s']!r} s, segmented {out['segmented']['s']!r}"
          f" s, under faults {out['chaos']['s']!r} s: recovery cost "
          f"{cost!r} s [{smi}]")
    print(f"[recovery] (b) fused_gather (B1) {SSGD_ROWS} rows, {REC_STEPS} "
          f"steps in segments of {REC_EVERY}, SIGTERM to this process "
          f"after the first checkpoint: Preempted (rc {stop.code}) at step "
          f"{stop.step} after {pre_s!r} s and {pre_b1} B1 launches; the "
          f"resume ran {out['resumed']['b1']} B1 launches in "
          f"{out['resumed']['s']!r} s, its final checkpoint bitwise equal "
          f"to the undisturbed segmented run's and w and accs to the "
          f"straight run's [{smi}]")
    return {"straight_s": out["straight"]["s"],
            "segmented_s": out["segmented"]["s"],
            "chaos_s": out["chaos"]["s"], "recovery_s": cost,
            "b1_launches": out["chaos"]["b1"], "fired": fired,
            "preempted_at": stop.step, "preempted_s": pre_s,
            "resumed_s": out["resumed"]["s"],
            "preempt_b1_launches": pre_b1 + out["resumed"]["b1"]}


def _rec_preempt(dev, smi: str) -> dict:
    """(b), the command line's part: a ``ssgd --checkpoint-dir`` child on
    the card (the reference task), SIGTERM after its first checkpoint:
    rc 75 and the ``[preempted]`` line; the re-run ends bitwise equal to
    an undisturbed run of the same configuration in this process."""
    import signal

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import checkpoint, datasets

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-pre-") as work:
        d, ref = os.path.join(work, "ck"), os.path.join(work, "ref")
        cmd = [sys.executable, "-m", "tpu_distalg_torch.cli", *PREEMPT_ARGS,
               "--checkpoint-dir", d, "--fault-plan", PREEMPT_PLAN]
        t1 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        try:
            while checkpoint.latest_step(d) is None:
                if proc.poll() is not None:
                    raise AssertionError(
                        f"(b) the child ended first: rc {proc.returncode}"
                        f"\n{proc.communicate()[1][-3000:]}")
                if time.perf_counter() - t1 > 300:
                    raise AssertionError("(b) no checkpoint in 300 s")
                time.sleep(0.01)
            proc.send_signal(signal.SIGTERM)
            _, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != 75 or "[preempted]" not in err:
            raise AssertionError(f"(b) rc {proc.returncode}, want 75\n"
                                 f"{err[-3000:]}")
        stopped = checkpoint.latest_step(d)
        again = subprocess.run(cmd, cwd=root, env=env, text=True,
                               capture_output=True, timeout=300)
        if again.returncode != 0:
            raise AssertionError(f"(b) re-run rc {again.returncode}\n"
                                 f"{again.stderr[-3000:]}")
        secs = time.perf_counter() - t1
        _reset_launches()
        ssgd.train(*datasets.breast_cancer_split(), get_mesh(device=dev),
                   ssgd.SSGDConfig(n_iterations=1500, sampler="fused_gather",
                                   fused_pack=4, gather_block_rows=32,
                                   shuffle_seed=0),
                   checkpoint_dir=ref, checkpoint_every=250)
        b1 = _launches()["fused_grad_sum_gathered"]
        (got, s1), (want, s2) = checkpoint.restore(d), checkpoint.restore(ref)
        if s1 != s2 or len(got["state"]) != len(want["state"]):
            raise AssertionError(f"(b) final steps {s1} vs {s2}")
        for i, (a, b) in enumerate(zip(got["state"], want["state"])):
            _same(f"(b) state leaf {i}", a, b)
        _same("(b) accs", got["accs"], want["accs"])
    if b1 != 1500:
        raise AssertionError(f"(b) the reference launched B1 {b1} times")
    print(f"[recovery] (b) CLI child ssgd fused_gather (B1) on the card "
          f"on the reference task (breast cancer, 569 rows), SIGTERM after "
          f"the first checkpoint: rc 75 at step {stopped}; the re-run ends "
          f"at step {s1}, its checkpoint bitwise equal to an undisturbed "
          f"run's in this process (B1 launches {b1}); both children "
          f"{secs!r} s, start-up and {PREEMPT_PLAN!r}'s sleep before each "
          f"segment included [{smi}]")
    return {"stopped_at": stopped, "children_s": secs}


def _rec_serve(dev, artifact: str, smi: str) -> dict:
    """(c): phase 4's artifact served through B9 undisturbed and under
    SERVE_PLAN; replies bitwise equal, batches failed, one re-read."""
    from tpu_distalg_torch import faults, serve
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.telemetry import events as tevents

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tel-") as tel:
        for name in ("undisturbed", "faulted"):
            sink = tevents.configure(os.path.join(tel, name))
            if name == "faulted":
                reg = faults.configure(SERVE_PLAN)
            _reset_launches()
            server = serve.Server(get_mesh(device=dev), serve.ServeConfig(
                max_batch=MAX_BATCH, max_delay_ms=2.0, k_top=K_TOP))
            try:
                server.add_artifact(artifact)
                results, info = serve.run_closed_loop(
                    server, "als", list(SERVE_IDS), concurrency=CONCURRENCY,
                    retries=SERVE_RETRIES)
                stats = server.emit_counters()
            finally:
                server.close()
                if name == "faulted":
                    fired = list(reg.fired)
                    faults.configure(False)
            runs[name] = {"results": results, "info": info, "stats": stats,
                          "b9": _launches()["topk"],
                          "counters": sink.counters()}
            tevents.configure(False)
    ok, bad = runs["undisturbed"], runs["faulted"]
    for r in (ok, bad):
        if r["info"]["failed"] or any(x is None for x in r["results"]):
            raise AssertionError(f"(c) unanswered requests: {r['info']}")
    for j, ((va, ia), (vb, ib)) in enumerate(zip(ok["results"],
                                                bad["results"])):
        _same(f"(c) reply {j} scores", vb, va)
        _same(f"(c) reply {j} ids", ib, ia)
    failed = bad["stats"]["failed_batches"]
    rereads = bad["counters"].get("serve.artifact_reread", 0)
    if failed < 1 or rereads != 1:
        raise AssertionError(f"(c) failed batches {failed}, re-reads "
                             f"{rereads}: the plan did not act")
    ok_batches = bad["stats"]["batches"] - failed
    if bad["b9"] < ok_batches or ok["b9"] < ok["stats"]["batches"]:
        raise AssertionError(f"(c) B9 launched {bad['b9']} / {ok['b9']} "
                             f"times for {ok_batches} / "
                             f"{ok['stats']['batches']} batches")
    print(f"[recovery] (c) ALS {USERS}x{ITEMS} rank {RANK} served through "
          f"B9, {REQUESTS} requests, retries {SERVE_RETRIES}, under "
          f"{SERVE_PLAN!r}: replies bitwise equal to the undisturbed "
          f"server's; {failed} failed batch(es), "
          f"{bad['info']['retries']} client retries, {rereads} artifact "
          f"re-read, {len(fired)} fault(s) fired; B9 launches "
          f"{bad['b9']} (undisturbed {ok['b9']}); p50/p99 "
          f"{bad['stats']['p50_ms']!r}/{bad['stats']['p99_ms']!r} ms "
          f"under faults vs {ok['stats']['p50_ms']!r}/"
          f"{ok['stats']['p99_ms']!r} ms undisturbed; {bad['info']['qps']!r}"
          f" vs {ok['info']['qps']!r} req/s [{smi}]")
    return {"failed_batches": failed, "rereads": rereads,
            "b9_launches": bad["b9"], "p99_ms": bad["stats"]["p99_ms"],
            "p99_ms_undisturbed": ok["stats"]["p99_ms"],
            "qps": bad["info"]["qps"], "qps_undisturbed": ok["info"]["qps"]}


def _rec_chaos(dev, smi: str) -> dict:
    """(d): run_chaos on the card for the eight workloads, each equal and
    firing what the port fires on the CPU."""
    from tpu_distalg_torch.faults import chaos
    from tpu_distalg_torch.parallel import get_mesh

    out = {}
    for workload, n, plan, iters, every in CHAOS_CASES:
        fired = {}
        for where in ("cpu", dev):
            with tempfile.TemporaryDirectory(prefix="chip-smoke-cs-") as w:
                _reset_launches()
                t1 = time.perf_counter()
                res = chaos.run_chaos(
                    workload, get_mesh(data=n, device=where), plan=plan,
                    workdir=w, n_iterations=iters, checkpoint_every=every)
                secs = time.perf_counter() - t1
            if not res.equal:
                raise AssertionError(f"(d) {workload} on {where}: "
                                     f"{res.verdict()}")
            fired[str(where)] = res.fired
        if fired["cpu"] != fired[str(dev)]:
            raise AssertionError(f"(d) {workload}: fired {fired[str(dev)]} "
                                 f"on the card, {fired['cpu']} on the CPU")
        launches = {k: v for k, v in _launches().items() if v}
        if workload == "pagerank_stream" and \
                not launches.get("spmv_table"):
            raise AssertionError("(d) pagerank_stream launched no B7")
        out[workload] = {"s": secs, "fired": len(res.fired),
                         "restarts": res.restarts_logged,
                         "launches": launches}
        print(f"[recovery] (d) chaos {workload} on {n} shard(s) under "
              f"{plan!r}: equal, {len(res.fired)} fault(s) fired as on the "
              f"CPU, {res.restarts_logged} restart(s), {secs!r} s; "
              f"launches {launches} [{smi}]")
    return out


def _rec_init(dev, smi: str) -> dict:
    """(e): init_backend under a hang past its deadline returns the card."""
    from tpu_distalg_torch import faults
    from tpu_distalg_torch.telemetry import supervisor
    from tpu_distalg_torch.utils.device import resolve_device

    reg = faults.configure(INIT_PLAN)
    t1 = time.perf_counter()
    try:
        got = supervisor.init_backend(timeout=INIT_TIMEOUT,
                                      retries=INIT_RETRIES, backoff=0.0,
                                      log=lambda m: None)
    finally:
        fired = list(reg.fired)
        faults.configure(False)
    secs = time.perf_counter() - t1
    if got != resolve_device("cuda") or got.type != "cuda" or \
            fired != [("backend:init", 0, "hang")]:
        raise AssertionError(f"(e) init_backend gave {got}, fired {fired}")
    print(f"[recovery] (e) init_backend under {INIT_PLAN!r}, deadline "
          f"{INIT_TIMEOUT} s: {got} after {secs!r} s [{smi}]")
    return {"s": secs}


def run_recovery(dev, artifact: str) -> dict:
    """Phase 17: recovery on the card, (a)-(e)."""
    smi = _nvidia_smi()
    t0 = time.perf_counter()
    out = {"restarts": _rec_restarts(dev, smi)}
    t0 = _phase("recovery (a) restarts, (b) preemption at full width", t0)
    out["preempt"] = _rec_preempt(dev, smi)
    t0 = _phase("recovery (b) preemption of a command-line child", t0)
    out["serve"] = _rec_serve(dev, artifact, smi)
    t0 = _phase("recovery (c) serving", t0)
    out["chaos"] = _rec_chaos(dev, smi)
    t0 = _phase("recovery (d) chaos", t0)
    out["init"] = _rec_init(dev, smi)
    _phase("recovery (e) init", t0)
    return out


# ------------------------------------------------------------ phase 18

#: (a): the reference task through the command line's --profile, B1 a
#: step (breast cancer; 300 steps, cut from 1500 to keep the trace small)
PROFILE_ARGS = ["ssgd", "--sampler", "fused_gather", "--fused-pack", "4",
                "--gather-block-rows", "32", "--shuffle-seed", "0",
                "--n-iterations", "300", "--quiet"]
PROFILE_STEPS = 300
#: kernel names of B1 in a trace (the ring and the wide-row forms)
B1_KERNEL_RE = re.compile(r"grad_(ring|wide)_kernel")
#: (b)-(d): bench.py's cluster geometry (bench.py:1400-1460, :1553)
CL_SLOTS, CL_WINDOWS, CL_S, CL_EVERY, CL_ROWS = 3, 24, 4, 8, 4096
CL_COMM = "int8:5"
CL_KILL_PLAN = "seed=7;cluster:worker@37=kill"     # (window 12, slot 1)
CL_COORD_PLAN = "seed=11;cluster:coordinator@12=kill"
#: (e): run_cluster_wire_bench's geometry (bench.py:1626-1700)
WIRE_D, WIRE_ROWS, WIRE_TEST, WIRE_WINDOWS = 8192, 1024, 512, 8
#: (f): the chaos workload under tests/test_torch_chaos.py's plan
CL_CHAOS_PLAN = "seed=7;cluster:coordinator@4=kill"


def _child_env() -> tuple[str, dict]:
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TDA_TELEMETRY_DIR="", TDA_FAULT_PLAN="")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return root, env


def _cl_profile(dev, sg: dict, smi: str) -> dict:
    """(a): ``--profile DIR`` on a command-line child: its trace holds
    B1's kernel exactly as often as the same command launches B1 (run
    once in this process to count), and B1's device µs a step."""
    import contextlib
    import glob
    import io

    from tpu_distalg_torch import cli
    from tpu_distalg_torch.utils import profiling

    _reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        if cli.main(["--device", dev.type, *PROFILE_ARGS]) != 0:
            raise AssertionError("(a) cli ssgd failed in this process")
    launches = _launches()["fused_grad_sum_gathered"]
    if launches != PROFILE_STEPS:
        raise AssertionError(f"(a) B1 launched {launches} times for "
                             f"{PROFILE_STEPS} steps")
    root, env = _child_env()
    for attempt in range(3):   # a CUPTI trace has once held no kernels
        with tempfile.TemporaryDirectory(prefix="chip-smoke-prof-") as d:
            t1 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "tpu_distalg_torch.cli", "--device",
                 dev.type, "--profile", d, *PROFILE_ARGS], cwd=root, env=env,
                capture_output=True, text=True, timeout=300)
            secs = time.perf_counter() - t1
            if r.returncode:
                raise AssertionError(f"(a) child rc {r.returncode}\n"
                                     f"{r.stderr[-3000:]}")
            files = glob.glob(os.path.join(d, "*" + profiling.TRACE_SUFFIX))
            if len(files) != 1:
                raise AssertionError(f"(a) traces written: {files}")
            size = os.path.getsize(files[0])
            with open(files[0]) as f:
                doc = json.load(f)
        kernels = [e for e in doc["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "kernel"]
        if kernels:
            break
    b1 = [e for e in kernels if B1_KERNEL_RE.search(e.get("name", ""))]
    labelled = any(e.get("name") == "cli:ssgd" for e in doc["traceEvents"])
    if len(b1) != launches or not labelled:
        raise AssertionError(f"(a) the trace holds {len(b1)} B1 kernel "
                             f"events for {launches} launches (cli:ssgd "
                             f"labelled: {labelled}; {len(kernels)} kernel "
                             f"events in all)")
    us = sum(float(e["dur"]) for e in b1) / len(b1)
    main_us = sg["recs"]["B1"]["ms"] * 1e3
    print(f"[cluster] (a) --profile on a CLI child (ssgd fused_gather, "
          f"breast cancer, {PROFILE_STEPS} steps): one trace of {size} "
          f"bytes, {len(b1)} B1 kernel events = {launches} launches "
          f"({B1_KERNEL_RE.pattern}: {b1[0]['name']!r}); B1 {us!r} µs a "
          f"step from the trace at 32-row blocks of 569 rows, beside "
          f"phase 6's {main_us!r} µs at 1,048,576 rows; child {secs!r} s, "
          f"attempt {attempt + 1} [{smi}]")
    return {"launches": launches, "trace_events": len(b1), "b1_us": us,
            "trace_bytes": size, "child_s": secs}


def _cl_config(**over):
    from tpu_distalg_torch import cluster as clus

    return clus.ClusterConfig(**{
        "n_slots": CL_SLOTS, "n_windows": CL_WINDOWS, "staleness": CL_S,
        "heartbeat_timeout": 3.0, "comm": CL_COMM,
        "checkpoint_every": CL_EVERY,
        "train": clus.TrainTask(n_rows=CL_ROWS), **over})


def _cl_run(cfg, where, what: str) -> dict:
    from tpu_distalg_torch import cluster as clus

    res = clus.run_local_cluster(cfg, spawn="thread", timeout=300.0,
                                 device=where)
    if res["version"] != cfg.n_windows:
        raise AssertionError(f"{what} on {where} stopped at window "
                             f"{res['version']}/{cfg.n_windows}")
    res["digest"] = clus.event_digest(res)
    return res


def _cl_elastic(dev, smi: str) -> dict:
    """(b): bench.py's elastic-against-restart pair, workers on the card;
    each arm's digest equals the same run's on the CPU port."""
    out = {}
    for where in (dev, "cpu"):
        for policy in ("elastic", "restart"):
            with tempfile.TemporaryDirectory(prefix="chip-smoke-cl-") as d:
                out[str(where), policy] = _cl_run(_cl_config(
                    plan_spec=CL_KILL_PLAN, policy=policy,
                    checkpoint_dir=d), where, f"(b) {policy}")
    e, r = out[str(dev), "elastic"], out[str(dev), "restart"]
    if e["respawns"] < 1 or r["restarts"] < 1:
        raise AssertionError(f"(b) the kill never fired (respawns "
                             f"{e['respawns']}, restarts {r['restarts']})")
    for policy in ("elastic", "restart"):
        a, b = out[str(dev), policy], out["cpu", policy]
        if a["digest"] != b["digest"]:
            raise AssertionError(f"(b) {policy}: digest {a['digest']} on "
                                 f"the card, {b['digest']} on the CPU")
    ratio = r["wall_seconds"] / e["wall_seconds"]
    print(f"[cluster] (b) {CL_SLOTS} thread workers on the card, "
          f"{CL_WINDOWS} windows × s {CL_S}, {CL_ROWS} + 1024 rows × 30 + "
          f"bias, {CL_COMM}, a checkpoint every {CL_EVERY}, "
          f"{CL_KILL_PLAN!r}: elastic {e['wall_seconds']!r} s (acc "
          f"{e['accuracy']!r}, {e['respawns']} respawn), restart "
          f"{r['wall_seconds']!r} s (acc {r['accuracy']!r}, "
          f"{r['restarts']} restart): restart / elastic = {ratio!r}; "
          f"digests {e['digest']} and {r['digest']} equal the CPU port's; "
          f"the CPU port's walls {out['cpu', 'elastic']['wall_seconds']!r} "
          f"and {out['cpu', 'restart']['wall_seconds']!r} s [{smi}]")
    return {"elastic_s": e["wall_seconds"], "restart_s": r["wall_seconds"],
            "ratio": ratio, "acc_elastic": e["accuracy"],
            "acc_restart": r["accuracy"], "digest": e["digest"]}


def _cl_push_pull(dev, smi: str) -> dict:
    """(c): bench.py's ``cluster_push_pull_ms``: one worker on the card,
    16 windows at s 2 under int8:5; the median push → commit → pull."""
    res = _cl_run(_cl_config(n_slots=1, n_windows=16, staleness=2,
                             checkpoint_every=8), dev, "(c)")
    st = res["worker_stats"][0]
    if not st.get("pushes") or not st.get("push_pull_ms_p50"):
        raise AssertionError(f"(c) no push timings: {st}")
    mean = st["push_pull_ms_total"] / st["pushes"]
    print(f"[cluster] (c) push -> commit -> pull on a one-worker cluster "
          f"(card, {CL_COMM}, 16 windows × s 2): median "
          f"{st['push_pull_ms_p50']!r} ms, mean {mean!r} ms over "
          f"{st['pushes']} pushes [{smi}]")
    return {"p50_ms": st["push_pull_ms_p50"], "mean_ms": mean}


def _cl_cli(dev, tag: str, work: str, plan: str | None
            ) -> tuple[dict, object]:
    from tpu_distalg_torch.utils import checkpoint

    root, env = _child_env()
    d = os.path.join(work, tag)
    cmd = [sys.executable, "-m", "tpu_distalg_torch.cli", "--device",
           dev.type, "cluster", "--role", "local", "--spawn", "process",
           "--coordinator-spawn", "process", "--workers", str(CL_SLOTS),
           "--n-windows", str(CL_WINDOWS), "--sync", f"ssp:{CL_S}",
           "--comm", CL_COMM, "--n-rows", str(CL_ROWS),
           "--heartbeat-timeout", "15", "--checkpoint-every", str(CL_EVERY),
           "--checkpoint-dir", d, "--deadline", "300"]
    if plan:
        cmd += ["--fault-plan", plan]
    t1 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True, timeout=420)
    secs = time.perf_counter() - t1
    if r.returncode:
        raise AssertionError(f"(d) {tag}: rc {r.returncode}\n"
                             f"{r.stderr[-3000:]}")
    line = [x for x in r.stdout.splitlines()
            if x.startswith("cluster_result: ")][-1]
    res = json.loads(line[len("cluster_result: "):])
    res["s"] = secs
    payload, step = checkpoint.restore(d)
    if step != CL_WINDOWS:
        raise AssertionError(f"(d) {tag}: newest checkpoint at {step}")
    return res, payload["center.w"]


def _cl_coordinator_kill(dev, smi: str) -> dict:
    """(d): ``tda cluster --role local --spawn process --coordinator-spawn
    process`` with process workers on the card, undisturbed and under a
    coordinator kill: the recovered final center (the last checkpoint)
    equals the undisturbed one bit for bit."""
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cd-") as work:
        und, w_und = _cl_cli(dev, "undisturbed", work, None)
        got, w_got = _cl_cli(dev, "kill", work, CL_COORD_PLAN)
    if got["recoveries"] != 1 or not got["recovery_ms"]:
        raise AssertionError(f"(d) the kill never fired or was never "
                             f"measured: {got}")
    if w_got.tobytes() != w_und.tobytes() or \
            got["event_digest"] != und["event_digest"]:
        raise AssertionError(f"(d) recovered center or digest differs: "
                             f"{got['event_digest']} vs "
                             f"{und['event_digest']}")
    print(f"[cluster] (d) CLI, process coordinator and 3 process workers "
          f"on the card at (b)'s geometry under {CL_COORD_PLAN!r}: "
          f"recovered in {got['recovery_ms']} ms, "
          f"{got['wal_records_replayed']} WAL record(s) replayed; final "
          f"center bitwise the undisturbed run's (digest "
          f"{und['event_digest']}, acc {got['accuracy']!r}); runs "
          f"{und['s']!r} s and {got['s']!r} s, process start-up included "
          f"[{smi}]")
    return {"recovery_ms": got["recovery_ms"],
            "wal_records_replayed": got["wal_records_replayed"],
            "undisturbed_s": und["s"], "kill_s": got["s"]}


def _cl_wire(dev, smi: str) -> dict:
    """(e): bench.py's wire bench, dense against int8:5, thread workers
    on the card: frame bytes from ``transport.wire_stats``."""
    from tpu_distalg_torch import cluster as clus
    from tpu_distalg_torch.cluster import transport
    from tpu_distalg_torch.faults.chaos import SSP_CHAOS_ACC_BAND

    base = dict(n_windows=WIRE_WINDOWS, staleness=2, heartbeat_timeout=10.0,
                train=clus.TrainTask(n_rows=WIRE_ROWS, test_rows=WIRE_TEST,
                                     n_features=WIRE_D))
    arms = {}
    for comm in ("dense", CL_COMM):
        transport.wire_stats_reset()
        res = _cl_run(_cl_config(comm=comm, **base), dev, f"(e) {comm}")
        st = transport.wire_stats()
        push, pull = st.get("push", {}), st.get("center", {})
        if not push.get("bytes") or not pull.get("bytes"):
            raise AssertionError(f"(e) {comm}: no frames counted: {st}")
        arms[comm] = (res, push, pull)
    (rd, pd, qd), (rc, pc, qc) = arms["dense"], arms[CL_COMM]
    band = abs(rc["accuracy"] - rd["accuracy"])
    if band > SSP_CHAOS_ACC_BAND:
        raise AssertionError(f"(e) {CL_COMM} ended {band} from dense's "
                             f"accuracy (band {SSP_CHAOS_ACC_BAND})")
    total_d, total_c = pd["bytes"] + qd["bytes"], pc["bytes"] + qc["bytes"]
    print(f"[cluster] (e) the wire, d {WIRE_D}, {WIRE_ROWS} + {WIRE_TEST} "
          f"rows, {WIRE_WINDOWS} windows, 3 workers on the card: dense "
          f"{pd['bytes']} push + {qd['bytes']} pull bytes, {CL_COMM} "
          f"{pc['bytes']} + {qc['bytes']}: {total_d / total_c!r}x (push "
          f"{pd['bytes'] / pc['bytes']!r}x, pull {qd['bytes'] / qc['bytes']!r}"
          f"x); accuracies {rd['accuracy']!r} and {rc['accuracy']!r} "
          f"(within {SSP_CHAOS_ACC_BAND}) [{smi}]")
    return {"dense_bytes": total_d, "compressed_bytes": total_c,
            "ratio": total_d / total_c, "acc_dense": rd["accuracy"],
            "acc_compressed": rc["accuracy"]}


def _cl_chaos(dev, smi: str) -> dict:
    """(f): ``run_chaos("cluster")`` with workers on the card: equal,
    firing what the CPU fires."""
    from tpu_distalg_torch.faults import chaos
    from tpu_distalg_torch.parallel import get_mesh

    fired = {}
    for where in ("cpu", dev):
        with tempfile.TemporaryDirectory(prefix="chip-smoke-cc-") as w:
            t1 = time.perf_counter()
            res = chaos.run_chaos("cluster", get_mesh(data=1, device=where),
                                  plan=CL_CHAOS_PLAN, workdir=w)
            secs = time.perf_counter() - t1
        if not res.equal:
            raise AssertionError(f"(f) on {where}: {res.verdict()}")
        fired[str(where)] = res.fired
    if fired["cpu"] != fired[str(dev)] or not fired["cpu"]:
        raise AssertionError(f"(f) fired {fired}")
    print(f"[cluster] (f) chaos cluster under {CL_CHAOS_PLAN!r} on the "
          f"card: equal, fired {fired[str(dev)]} as on the CPU, {secs!r} s "
          f"[{smi}]")
    return {"s": secs}


def run_cluster(dev, sg: dict) -> dict:
    """Phase 18: the profiler entry point and the cluster runtime on the
    card, (a)-(f)."""
    smi = _nvidia_smi()
    t0 = time.perf_counter()
    out = {"profile": _cl_profile(dev, sg, smi)}
    t0 = _phase("cluster (a) --profile", t0)
    out["elastic"] = _cl_elastic(dev, smi)
    t0 = _phase("cluster (b) elastic against restart", t0)
    out["push_pull"] = _cl_push_pull(dev, smi)
    t0 = _phase("cluster (c) push -> commit -> pull", t0)
    out["coordinator_kill"] = _cl_coordinator_kill(dev, smi)
    t0 = _phase("cluster (d) coordinator kill", t0)
    out["wire"] = _cl_wire(dev, smi)
    t0 = _phase("cluster (e) wire", t0)
    out["chaos"] = _cl_chaos(dev, smi)
    _phase("cluster (f) chaos", t0)
    return out


# ------------------------------------------------------------ phase 19

#: (b): ``ssgd --tune PROFILE`` through the command line on phase 6's
#: sampler (breast cancer, the command line's task), against the same
#: command with the resolved knobs spelled out
TUNE_CLI_ARGS = ["ssgd", "--sampler", "fused_gather", "--fused-pack", "4",
                 "--gather-block-rows", "32", "--shuffle-seed", "0",
                 "--n-iterations", "300"]
TUNE_CLI_STEPS = 300
#: (c): run_rowstore_bench's geometry (bench.py:1719-1760) and phase 15's
#: V 2^20 check geometry on 4 shards (the power-law multigraph, not
#: deduped): (label, V, in-degree, seed, edges a block), 8 iterations
RS_CACHES = (("bench", 8192, 8.0, 3, 512),
             ("v2^20", 1 << 20, 16.0, 1, 1 << 16))
RS_SHARDS, RS_ALPHA, RS_ITERS = 4, 1.6, 8
RS_KILL = "cluster:ps@3=kill"
#: (c): fit_rowstore at the JAX package's test geometry and at the
#: serving geometry (2 sweeps, a row budget under n)
ALS_RS = (("test", dict(m=48, n=320, k=5, n_iterations=6, lam=0.01, seed=2),
           dict(density=0.03, ps_shards=3, user_block=8,
                model_budget_rows=200)),
          ("serving", dict(m=USERS, n=ITEMS, k=RANK, n_iterations=2,
                           lam=0.01, seed=0),
           dict(density=0.08, ps_shards=2, user_block=32,
                model_budget_rows=16000)))
#: (d): run_cluster_serve_bench's geometry (bench.py:1809-1900)
CS_DIM, CS_K, CS_REQ, CS_CONC, CS_HIT = 16, 8, 384, 8, 13
#: (d): phase 4's artifact served over 1 and 4 shard replicas
CS_ALS_REQ, CS_ALS_SHARDS = 512, 4


def _tn_cli(dev, args: list) -> str:
    root, env = _child_env()
    r = subprocess.run(
        [sys.executable, "-m", "tpu_distalg_torch.cli", "--device",
         dev.type, *args], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    if r.returncode:
        raise AssertionError(f"(a) {' '.join(args)}: rc {r.returncode}\n"
                             f"{r.stderr[-3000:]}")
    return r.stdout


def _tn_tune(dev, work: str, smi: str) -> dict:
    """(a): ``tda tune`` on the card, then with ``--collective`` over 4
    emulated data shards; both profiles load and say ``cuda``."""
    import socket

    from tpu_distalg_torch import tune as ttune

    out = {}
    for tag, extra in (("rig", []),
                       ("collective", ["--collective", "--n-slices",
                                       str(SYNC_SHARDS),
                                       "--no-backend-init"])):
        d = os.path.join(work, tag)
        t1 = time.perf_counter()
        text = _tn_cli(dev, ["tune", "--out-dir", d, *extra])
        secs = time.perf_counter() - t1
        prof, path = ttune.newest_profile(d, rig=socket.gethostname())
        if prof is None or prof["backend"] != "cuda":
            raise AssertionError(f"(a) {tag}: profile {path} backend "
                                 f"{prof and prof['backend']}")
        m = prof["measurements"]
        if tag == "rig" and m["backend_init_s"] is None:
            raise AssertionError("(a) backend_init_s was not measured")
        if tag == "collective" and (m["collective"] or {}).get(
                "n_shards") != SYNC_SHARDS:
            raise AssertionError(f"(a) collective: {m['collective']}")
        for line in text.splitlines():
            print(f"[tune] (a) {line} [{smi}]")
        print(f"[tune] (a) {tag} profile {prof['profile_id']} (rig "
              f"{prof['rig']!r}, backend cuda, {secs!r} s with start-up): "
              f"{json.dumps(m)} [{smi}]")
        out[tag] = {"path": path, "profile": prof, "s": secs}
    return out


def _tn_step(dev, prof: dict) -> dict:
    """``prof`` resolved for bench.py's run_tuned_step_speedup geometry
    and, where the resolved schedule is not the default, both arms timed
    (default, tuned, tuned, default: the best of each)."""
    from tpu_distalg_torch import tune as ttune

    res = ttune.resolve(prof, ttune.Workload(
        d=COMM_D, n_workers=SYNC_SHARDS, transport="device",
        n_shards=SYNC_SHARDS))
    default = str(ttune.defaults.DEFAULT_GEOMETRY["comm"])
    tuned = res.comm_string()
    line = {"comm_default": default, "comm_tuned": tuned,
            "predicted_sync_ms": res.predicted_sync_ms(),
            "why": res.choices["comm"].why}
    if tuned == default:
        rates = _comm_bound_rates(dev, (default,))
        return {**line, "value": 1.0, "identical_geometry": True,
                "default_steps_per_s": rates[default]["steps_per_s"]}
    rates = {}
    for sched in (default, tuned, tuned, default):
        got = _comm_bound_rates(dev, (sched,))[sched]
        if got["steps_per_s"] > rates.get(sched, {}).get("steps_per_s", 0):
            rates[sched] = got
    return {**line, "identical_geometry": False, "rates": rates,
            "value": rates[tuned]["steps_per_s"]
            / rates[default]["steps_per_s"]}


def _tn_tuned_ssgd(dev, tn: dict, smi: str) -> dict:
    """(b): (a)'s profile resolved for bench.py's run_tuned_step_speedup
    geometry — ratio 1.0 with ``identical_geometry`` where it keeps the
    default, a failure where a different schedule runs slower — and the
    collective profile likewise, as a finding (its psum over emulated
    shards is priced as a wire, which one card does not have); then
    ``ssgd --tune PROFILE`` (the collective one) through the command
    line in this process against its resolved knobs spelled out: the
    weights bitwise, B1's launches the steps × shards."""
    import contextlib
    import io

    from tpu_distalg_torch import cli

    line = _tn_step(dev, tn["rig"]["profile"])
    if not line["identical_geometry"] and line["value"] < 1.0:
        raise AssertionError(f"(b) the resolved {line['comm_tuned']} ran "
                             f"slower than {line['comm_default']}: {line}")
    print(f"[tune] (b) tuned_step_speedup on (a)'s profile at d {COMM_D}, "
          f"{COMM_ROWS} rows a shard, {SYNC_SHARDS} shards, {COMM_STEPS} "
          f"steps, best of {COMM_REPEATS}: {json.dumps(line)} [{smi}]")
    coll = _tn_step(dev, tn["collective"]["profile"])
    print(f"[tune] (b) finding: the same geometry on the collective "
          f"profile ({SYNC_SHARDS} emulated shards on one card): "
          f"{json.dumps(coll)} [{smi}]")
    path = tn["collective"]["path"]

    def run(args):
        buf, err = io.StringIO(), io.StringIO()
        _reset_launches()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            if cli.main(["--device", dev.type, *args]) != 0:
                raise AssertionError(f"(b) cli {args} failed")
        _sync(dev)
        ws = [x for x in buf.getvalue().splitlines()
              if x.startswith("Final w: ")]
        return ws[-1], _launches()["fused_grad_sum_gathered"], err.getvalue()

    w_tuned, b1, err = run(TUNE_CLI_ARGS + ["--tune", path])
    knobs = dict((x.split(": ", 1)[0][5:-1], x.split(": ", 1)[1])
                 for x in err.splitlines() if x.startswith("tune["))
    spelled = TUNE_CLI_ARGS + ["--comm", "dense", "--mesh-shape",
                               f"{SYNC_SHARDS}x1"]
    if not (knobs.get("mesh_shape", "").startswith(f"{SYNC_SHARDS}x1 ")
            and knobs.get("comm", "").startswith("dense ")):
        raise AssertionError(f"(b) resolved {knobs}")
    w_spelled, b1_spelled, _ = run(spelled)
    if w_tuned != w_spelled:
        raise AssertionError("(b) --tune's weights differ from the run "
                             "with its knobs spelled out")
    want = TUNE_CLI_STEPS * SYNC_SHARDS
    if b1 != want or b1_spelled != want:
        raise AssertionError(f"(b) B1 launched {b1} / {b1_spelled} times, "
                             f"want {want}")
    print(f"[tune] (b) ssgd --tune {os.path.basename(path)} "
          f"(fused_gather, breast cancer, {TUNE_CLI_STEPS} steps) resolved "
          f"{json.dumps(knobs)}; weights bitwise the run with --comm dense "
          f"--mesh-shape {SYNC_SHARDS}x1 spelled out; B1 {b1} launches "
          f"(steps × shards) [{smi}]")
    return {"tuned_step": line, "collective_step": coll,
            "cli_launches": b1}


def _rs_cluster(dev, smi: str) -> dict:
    """(c): ``--ps-mode rowstore`` with 3 thread workers on the card at
    phase 18's geometry: the center bitwise the replicated mode's, dense
    and int8:5."""
    out = {}
    for comm in ("dense", CL_COMM):
        rep = _cl_run(_cl_config(comm=comm), dev, f"(c) {comm} replicated")
        row = _cl_run(_cl_config(comm=comm, ps_mode="rowstore"), dev,
                      f"(c) {comm} rowstore")
        if np.asarray(rep["center"]["w"]).tobytes() != \
                np.asarray(row["center"]["w"]).tobytes() or \
                rep["digest"] != row["digest"]:
            raise AssertionError(f"(c) {comm}: rowstore's center or digest "
                                 f"differs from replicated's")
        out[comm] = {"replicated_s": rep["wall_seconds"],
                     "rowstore_s": row["wall_seconds"],
                     "accuracy": row["accuracy"], "digest": row["digest"]}
    print(f"[rowstore] (c) --ps-mode rowstore, {CL_SLOTS} thread workers "
          f"on the card, {CL_WINDOWS} windows × s {CL_S}, {CL_ROWS} rows: "
          f"centers bitwise the replicated runs' under dense and {CL_COMM}: "
          f"{json.dumps(out)} [{smi}]")
    return out


def _rs_blocks(path: str) -> int:
    """The edge blocks the fleet's workers hold (a block with a nonzero
    weight), so B7's launches an iteration."""
    from tpu_distalg_torch.data import cache as dcache
    from tpu_distalg_torch.graphs import ingest

    mm, header = dcache.open_cache(path, layout=ingest.LAYOUT)
    geom = header["geom"]
    S, be = int(geom["n_shards"]), int(geom["block_edges"])
    n = 0
    for s in range(S):
        w = np.ascontiguousarray(
            dcache.shard_view(mm, S, s)[:, 2]).view(np.float32)
        n += np.unique(np.flatnonzero(w != 0.0) // be).size
    return n


def _rs_pagerank(dev, work: str, smi: str) -> dict:
    """(c): run_cluster_pagerank on the card at bench.py's rowstore
    geometry and at V 2^20: iterations/s, the sparse pull fraction, B7's
    launches; the ranks within 1e-6 of the engine on the card, Σ within
    1e-4 of 1, and a PS kill replayed from the WAL bitwise."""
    from tpu_distalg_torch import graphs
    from tpu_distalg_torch.cluster import rowstore
    from tpu_distalg_torch.parallel import get_mesh

    out = {}
    for label, V, deg, seed, block in RS_CACHES:
        path = os.path.join(work, f"pl_{label}")
        t1 = time.perf_counter()
        graphs.build_powerlaw_block_cache(
            path, n_vertices=V, n_shards=RS_SHARDS, avg_in_degree=deg,
            alpha=RS_ALPHA, seed=seed, block_edges=block,
            chunk_edges=GRAPH_CHUNK)
        gen_s = time.perf_counter() - t1
        blocks = _rs_blocks(path)
        _reset_launches()
        res = rowstore.run_cluster_pagerank(
            path, rowstore.ClusterPageRankConfig(n_iterations=RS_ITERS),
            device=dev)
        launches = _launches()
        _want_launches(f"(c) cluster pagerank {label}", launches,
                       {"spmv_table": RS_ITERS * blocks})
        gd = graphs.open_graph_dataset(
            path, get_mesh(data=RS_SHARDS, device=dev))
        # one block a staged step: the fleet's association (a worker
        # adds its window's block sums one edge block at a time); at the
        # engine's default 4 the sums group otherwise, and the gap grows
        # with the block (6.7e-5 at V 2^14, 4096-edge blocks, in the JAX
        # package as in the port)
        want = graphs.run_streamed_pagerank(gd, graphs.StreamedPageRankConfig(
            n_iterations=RS_ITERS, batch_blocks=1)).ranks.cpu().numpy()
        err = float(np.max(np.abs(res["ranks"] - want)))
        total = float(np.sum(res["ranks"], dtype=np.float64))
        if err > 1e-6 or abs(total - 1.0) > 1e-4:
            raise AssertionError(f"(c) {label}: ranks {err!r} from the "
                                 f"engine, Σ {total!r}")
        killed = rowstore.run_cluster_pagerank(
            path, rowstore.ClusterPageRankConfig(
                n_iterations=RS_ITERS, plan_spec=RS_KILL,
                wal_dir=os.path.join(work, f"wal_{label}")), device=dev)
        if killed["recoveries"] < 1 or \
                killed["ranks"].tobytes() != res["ranks"].tobytes() or \
                killed["event_digest"] != res["event_digest"]:
            raise AssertionError(f"(c) {label}: the {RS_KILL} run did not "
                                 f"replay bitwise")
        out[label] = {
            "n_vertices": V, "iters_per_s": res["iters_per_sec"],
            "sparse_pull_fraction": res["sparse_pull_fraction"],
            "peak_pull_rows": res["peak_pull_rows"],
            "b7_launches": launches["spmv_table"], "blocks": blocks,
            "max_abs_err_vs_engine": err, "rank_sum": total,
            "killed_iters_per_s": killed["iters_per_sec"],
            "generation_s": gen_s}
        print(f"[rowstore] (c) cluster PageRank, {label} (V {V}, "
              f"{RS_SHARDS} shards, in-degree {deg}, α {RS_ALPHA}, {block}-"
              f"edge blocks, {RS_ITERS} iterations) on the card: "
              f"{json.dumps(out[label])}; {RS_KILL!r} replayed bitwise "
              f"[{smi}]")
    return out


def _rs_als(dev, smi: str) -> dict:
    """(c): fit_rowstore on the card under a row budget below n."""
    from tpu_distalg_torch.models import als

    out = {}
    for label, cfg, kw in ALS_RS:
        _reset_launches()
        t1 = time.perf_counter()
        res = als.fit_rowstore(als.ALSConfig(**cfg), device=dev, **kw)
        secs = time.perf_counter() - t1
        hist = [float(x) for x in res["rmse_history"]]
        if not (np.isfinite(hist).all() and hist[-1] < hist[0]
                and res["peak_pull_rows"] <= kw["model_budget_rows"]
                < cfg["n"]):
            raise AssertionError(f"(c) fit_rowstore {label}: {hist}, peak "
                                 f"{res['peak_pull_rows']}")
        out[label] = {"peak_pull_rows": res["peak_pull_rows"],
                      "sparse_pull_fraction": res["sparse_pull_fraction"],
                      "rmse_history": hist,
                      "s_per_sweep": secs / cfg["n_iterations"],
                      "rows_pulled": res["rows_pulled"],
                      "rows_pushed": res["rows_pushed"]}
        print(f"[rowstore] (c) fit_rowstore {label} ({cfg['m']} × "
              f"{cfg['n']}, rank {cfg['k']}, density {kw['density']}, "
              f"budget {kw['model_budget_rows']} rows, {cfg['n_iterations']}"
              f" sweeps, float64 batched solves on the card): "
              f"{json.dumps(out[label])} [{smi}]")
    return out


def _cs_bench(dev, smi: str) -> dict:
    """(d): run_cluster_serve_bench on the card: req/s, the client p99
    under a seeded replica kill, availability; the disturbed replies
    bitwise the undisturbed ones."""
    from tpu_distalg_torch import faults
    from tpu_distalg_torch.cluster import serve

    rng = np.random.default_rng(13)
    center = {"centers": rng.standard_normal((CS_K, CS_DIM)).astype(
        np.float32)}
    payloads = list(rng.standard_normal((CS_REQ, CS_DIM)).astype(np.float32))
    cfg = serve.FleetConfig(kind="kmeans", n_replicas=3, version=1,
                            max_delay_ms=1.0)
    arms = []
    for plan in (None, f"seed=13;cluster:replica@{CS_HIT}=kill"):
        faults.configure(plan or False)
        try:
            fleet = serve.ServeFleet(cfg, center, device=dev).start()
            try:
                res, info = serve.run_fleet_closed_loop(
                    fleet, payloads, concurrency=CS_CONC,
                    retries=10 if plan else 0, retry_backoff_s=0.05)
                st = fleet.stats()
                killed = [r.slot for r in fleet.replicas if r.killed]
            finally:
                fleet.stop()
        finally:
            faults.configure(False)
        if info["failed"] or info["ok"] != CS_REQ:
            raise AssertionError(f"(d) burst incomplete: {info}")
        arms.append((np.stack([v for v, _, _ in res]), info, st, killed))
    (ya, ia, _sa, ka), (yb, ib, sb, kb) = arms
    if ka or not kb or ya.tobytes() != yb.tobytes():
        raise AssertionError(f"(d) kill fired {kb} (undisturbed {ka}); "
                             f"replies equal {ya.tobytes() == yb.tobytes()}")
    out = {"qps": ia["qps"], "p50_ms": ia["p50_ms"], "p99_ms": ia["p99_ms"],
           "p99_under_kill_ms": ib["p99_ms"],
           "availability": ib["availability"], "reroutes": sb["reroutes"],
           "client_retries": ib["retries"], "killed": kb}
    print(f"[serve] (d) cluster_serve bench, 3 k-means replicas on the card "
          f"(dim {CS_DIM}, k {CS_K}), {CS_REQ} requests, concurrency "
          f"{CS_CONC}: {json.dumps(out)}; disturbed replies bitwise the "
          f"undisturbed [{smi}]")
    return out


def _cs_als(dev, artifact: str, smi: str) -> dict:
    """(d): phase 4's ALS artifact over 1 replica and over 4 shard
    replicas on the card, sparse and dense merge: merged replies bitwise
    the one replica's; B9 = shards × (micro-batches + warm-ups) on sparse,
    none on dense; the replies against the plain version by the tie
    rule."""
    import torch

    from tpu_distalg_torch.cluster import serve
    from tpu_distalg_torch.ops import topk
    from tpu_distalg_torch.serve import artifacts

    root, state, _ = artifacts.load_artifact_state(artifact)
    kind, center = serve.center_of_state(root, state)
    ids = [np.int32(i) for i in
           np.random.default_rng(3).integers(0, USERS, size=CS_ALS_REQ)]
    out, replies = {}, {}
    for merge in ("sparse", "dense"):
        for n in (1, CS_ALS_SHARDS):
            _reset_launches()
            fleet = serve.ServeFleet(serve.FleetConfig(
                kind=kind, n_replicas=n, sharded=True, merge=merge,
                k_top=K_TOP, max_batch=MAX_BATCH, max_delay_ms=2.0,
                version=1), center, device=dev).start()
            try:
                res, info = serve.run_fleet_closed_loop(
                    fleet, ids, concurrency=CONCURRENCY)
                batches = sum(link.batcher.snapshot().batches
                              for link in fleet.router._links.values())
            finally:
                fleet.stop()
            launches = _launches()["topk"]
            want = batches + n if merge == "sparse" else 0
            if info["failed"] or launches != want:
                raise AssertionError(f"(d) {merge} × {n}: {info['failed']} "
                                     f"failed, B9 {launches} launches, "
                                     f"want {want}")
            replies[merge, n] = res
            out[f"{merge}_{n}"] = {
                "qps": info["qps"], "p50_ms": info["p50_ms"],
                "p99_ms": info["p99_ms"], "micro_batches": batches,
                "b9_launches": launches}
        for (a, _va, _), (b, _vb, _) in zip(replies[merge, 1],
                                            replies[merge, CS_ALS_SHARDS]):
            if a[0].tobytes() != b[0].tobytes() or \
                    a[1].tobytes() != b[1].tobytes():
                raise AssertionError(f"(d) {merge}: {CS_ALS_SHARDS} shards' "
                                     f"replies differ from one replica's")
    got = replies["sparse", CS_ALS_SHARDS][:256]
    q = torch.as_tensor(center["U"][np.asarray(ids[:256])])
    ref_v, ref_i = topk.matmul_topk_reference(
        q, torch.as_tensor(center["V"]), 0, center["V"].shape[0],
        k=K_TOP + 1)
    topk.assert_topk_close(np.stack([v[0] for v, _, _ in got]),
                           np.stack([v[1] for v, _, _ in got]), ref_v, ref_i)
    print(f"[serve] (d) phase 4's artifact ({USERS} × {ITEMS}, rank {RANK}, "
          f"k {K_TOP}) over 1 and {CS_ALS_SHARDS} shard replicas on the "
          f"card, {CS_ALS_REQ} requests, max batch {MAX_BATCH}: "
          f"{json.dumps(out)}; merged replies bitwise one replica's, sparse "
          f"and dense; B9 = micro-batches + a warm-up a replica [{smi}]")
    return out


def _cs_process(dev, work: str, smi: str) -> dict:
    """(d): two process replicas on the card (``python -m
    tpu_distalg_torch.cli --device cuda cluster --role replica``), the
    first killed after 3 batches: every reply the in-process replica
    model's bits."""
    from tpu_distalg_torch.cluster import serve
    from tpu_distalg_torch.utils import checkpoint

    rng = np.random.default_rng(13)
    centers = rng.standard_normal((CS_K, CS_DIM)).astype(np.float32)
    ckpt = os.path.join(work, "km")
    checkpoint.save(ckpt, "kmeans_lloyd", [centers], 1)
    X = rng.standard_normal((128, CS_DIM)).astype(np.float32)
    t1 = time.perf_counter()
    fleet = serve.ServeFleet(
        serve.FleetConfig(kind="kmeans", n_replicas=2, artifact=ckpt,
                          fault_slot=0, max_delay_ms=1.0),
        spawn="process", plan_spec="seed=1;cluster:replica@3=kill",
        device=dev).start()
    up = time.perf_counter() - t1
    try:
        res, info = serve.run_fleet_closed_loop(
            fleet, list(X), concurrency=4, retries=5, retry_backoff_s=0.05)
        st = fleet.stats()
    finally:
        fleet.stop()
    want = serve.ReplicaModel("kmeans", {"centers": centers},
                              device=dev).score_frame({"x": X})["y"]
    got = np.asarray([v for v, _, _ in res])
    if info["failed"] or st["dead"] != [0] or not np.array_equal(got, want):
        raise AssertionError(f"(d) process replicas: {info}, dead "
                             f"{st['dead']}, replies equal "
                             f"{np.array_equal(got, want)}")
    out = {"start_s": up, "qps": info["qps"], "p99_ms": info["p99_ms"],
           "reroutes": st["reroutes"], "dead": st["dead"]}
    print(f"[serve] (d) 2 process replicas on the card, replica 0 killed "
          f"by seed=1;cluster:replica@3=kill: {json.dumps(out)}; replies "
          f"bitwise [{smi}]")
    return out


def run_tune_rowstore_serving(dev, artifact: str) -> dict:
    """Phase 19: the autotuner, the sharded row store and cluster serving
    on the card, (a)-(d)."""
    import shutil

    smi = _nvidia_smi()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "phase19")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    try:
        tn = _tn_tune(dev, work, smi)
        t0 = _phase("tune (a) tda tune", t0)
        out = {"tune": tn, **_tn_tuned_ssgd(dev, tn, smi)}
        t0 = _phase("tune (b) tuned ssgd", t0)
        out["rowstore_cluster"] = _rs_cluster(dev, smi)
        out["rowstore_pagerank"] = _rs_pagerank(dev, work, smi)
        out["rowstore_als"] = _rs_als(dev, smi)
        t0 = _phase("rowstore (c)", t0)
        out["serve_bench"] = _cs_bench(dev, smi)
        out["serve_als"] = _cs_als(dev, artifact, smi)
        out["serve_process"] = _cs_process(dev, work, smi)
        _phase("cluster serving (d)", t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def _mp_half() -> int:
    from tpu_distalg_torch.tools import multiproc_run

    return multiproc_run.SYNC_CKPT_STEPS // 2


def _mp_launches(mp: dict, key: str) -> dict:
    """Phase 16's launches a rank of the kernel ``key``, by workload
    (each rank's, for the workloads that crossed last)."""
    return {name: mp["launches"][name]
            for name, keys in {**MP_KERNELS, **MP_A9_KERNELS}.items()
            if key in keys}


def _phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[time] {name}: {now - t0!r} s")
    return now


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    from tpu_distalg_torch.ops import _native
    from tpu_distalg_torch.utils.device import resolve_device

    t_start = t0 = time.perf_counter()
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    print(_nvidia_smi())
    t0 = _phase("device", t0)

    builds = [_native.build(name) for name in _native.LIBRARIES]  # at once
    for b in builds:
        _native.finish(b)
    for name in _native.LIBRARIES:
        _native.load(name)
    print(f"[build] nvcc built "
          f"{', '.join(f'csrc/{n}.cu' for n in _native.LIBRARIES)} in "
          f"{time.perf_counter() - t0!r} s")
    t0 = _phase("build", t0)

    rec = check_topk_kernel(dev)
    check_ssgd_kernels_small(dev)
    check_tp_kernels_small(dev)
    t0 = _phase("kernels", t0)
    check_als_small(dev)

    # removed by run_recovery's caller, or at exit if a phase before it
    # fails
    rec_tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-artifact-")
    rec_dir = rec_tmp.name
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as workdir:
        _reset_launches()
        run = run_main_path(dev, workdir)
        launches = _launches()["topk"]
        if launches < 1 or launches < run["stats"]["batches"]:
            raise AssertionError(
                f"fused_matmul_topk launched {launches} time(s) for "
                f"{run['stats']['batches']} batches: the main path did "
                f"not go through the kernel")
        check_served(dev, workdir, run)
        print(f"[serve] fused_matmul_topk launches on the main path: "
              f"{launches}")
        # phase 17 serves this artifact again, under faults
        from tpu_distalg_torch.utils import checkpoint

        newest = f"step_{checkpoint.latest_step(workdir)}.npz"
        shutil.copy(os.path.join(workdir, newest),
                    os.path.join(rec_dir, newest))
        t0 = _phase("als + serve", t0)
        sharded = run_sharded(dev, workdir, run)
        del run
    t0 = _phase("sharded als + serve", t0)

    sg = run_ssgd(dev)
    t0 = _phase("ssgd", t0)

    pr = run_pagerank(dev)
    t0 = _phase("pagerank", t0)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as workdir:
        km = run_kmeans(dev, workdir)
    t0 = _phase("kmeans", t0)

    tp = run_ssgd_tp(dev, sg)
    t0 = _phase("ssgd tp", t0)

    att = run_attention(dev)
    t0 = _phase("attention", t0)

    local = run_local_sgd(dev, sg)
    t0 = _phase("local sgd", t0)

    sync = run_sync(dev, sg)
    del sg["X2"]
    t0 = _phase("sync schedules + ssp", t0)

    rest = run_rest(dev, sg)
    del sg["X"], sg["y"]
    t0 = _phase("mc + closure + fixed + scale", t0)

    shutil.rmtree(OOC_DIR, ignore_errors=True)
    os.makedirs(OOC_DIR)
    try:
        ooc = run_out_of_core(dev, OOC_DIR)
        t0 = _phase("out-of-core: streamed + virtual ssgd, kmeans, als", t0)
        # phase 16 before phase 15: it reads phase 14's caches, and the
        # disk then never holds them beside phase 15's graph cache
        mp = run_multiproc(dev, OOC_DIR)
        t0 = _phase("the data axis across processes", t0)
    finally:
        shutil.rmtree(OOC_DIR, ignore_errors=True)

    graph = run_graph(dev)
    t0 = _phase("graph engine: streamed pagerank", t0)

    try:
        run_recovery(dev, rec_dir)
        t0 = _phase("recovery on the card", t0)

        cl = run_cluster(dev, sg)
        t0 = _phase("profiler + cluster runtime", t0)

        # phase 4's artifact is served again in (d)
        p19 = run_tune_rowstore_serving(dev, rec_dir)
        t0 = _phase("tune + rowstore + cluster serving", t0)
    finally:
        rec_tmp.cleanup()

    ssgd_src = "tpu_distalg_torch/csrc/ssgd.cu"
    pallas = "tpu_distalg/ops/pallas_kernels.py"
    kernels = [{
        "name": "topk.fused_matmul_topk", "route": "cuda",
        "source": "tpu_distalg_torch/csrc/topk.cu",
        "replaces": "tpu_distalg/ops/pallas_topk.py:109",
        "launches": launches, **rec,
        "sharded_launches": sharded["sparse"]["launches"],
        "cluster_serve_launches": {
            k: v["b9_launches"] for k, v in p19["serve_als"].items()},
        "process_launches": _mp_launches(mp, "B9"),
        **{f"slice_{k}": sharded["slice"][k]
           for k in ("ms", "wall_ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by")}}]
    for key, name, line, path in (
            ("B6", "fused_grad_sum", 92, "bernoulli"),
            ("B1", "fused_grad_sum_gathered", 277, "fused_gather"),
            ("B2", "fused_train_gathered", 442, "fused_train"),
            ("B5", "fused_grad_sum_packed", 737, "fused")):
        wide = tp["wide_dp"].get(key, {})
        local_launches = {k: v["launches"][name] for k, v in local.items()
                          if v["launches"][name]}
        kernels.append({
            "name": f"ssgd_kernels.{name}", "route": "cuda",
            "source": ssgd_src, "replaces": f"{pallas}:{line}",
            "launches": sg["launches"][path][name], **sg["recs"][key],
            **{f"wide_{k}": v for k, v in wide.items()
               if k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            **({"local_sgd_launches": local_launches}
               if local_launches else {}),
            **({"sync_launches": _sync_launches(sync, key)}
               if key in ("B1", "B2", "B5") else {}),
            **({"process_launches": _mp_launches(mp, key)}
               if key in ("B1", "B2", "B5") else {}),
            **({"scale_launches": rest["scale"]["launches"],
                **rest["scale"]["rec"],
                "stream_launches": ooc["stream"]["launches"],
                **ooc["stream"]["b1"],
                "profiled_cli_launches": cl["profile"]["launches"],
                "profiled_cli_trace_us": cl["profile"]["b1_us"],
                "tuned_cli_launches": p19["cli_launches"]}
               if key == "B1" else {})})
    for key, name, line in (("B3", "fused_forward_gathered", 590),
                            ("B4", "fused_backward_gathered", 668)):
        main, wide = tp["main"][key], tp["wide"][key]
        kernels.append({
            "name": f"ssgd_kernels.{name}", "route": "cuda",
            "source": ssgd_src, "replaces": f"{pallas}:{line}",
            "launches": tp["main_launches"][name],
            **{k: v for k, v in main.items() if k != "bytes"},
            **({"sass": sg["recs"]["B3_sass"]} if key == "B3" else {}),
            "process_launches": _mp_launches(mp, key),
            **{f"wide_{k}": v for k, v in wide.items()
               if k in ("ms", "plain_ms", "library_ms", "bound_ms")}})
    for key, name, line, path in (("B7", "spmv_table", 457, "auto"),
                                  ("B8", "scatter_table", 498, "pallas")):
        kernels.append({
            "name": f"pagerank_kernels.{name}", "route": "cuda",
            "source": "tpu_distalg_torch/csrc/pagerank.cu",
            "replaces": f"tpu_distalg/ops/pallas_pagerank.py:{line}",
            "launches": pr["launches"][path][name], **pr["recs"][key],
            "process_launches": _mp_launches(mp, key),
            **({"streamed_launches": graph["launches"],
                "streamed_launches_per_sweep":
                    graph["b7_launches_per_sweep"], **graph["b7"],
                "rowstore_launches": {
                    k: v["b7_launches"]
                    for k, v in p19["rowstore_pagerank"].items()}}
               if key == "B7" else {})})
    kernels.append({
        "name": "kmeans_kernels.fused_cluster_stats", "route": "cuda",
        "source": "tpu_distalg_torch/csrc/kmeans.cu",
        "replaces": "tpu_distalg/ops/pallas_kmeans.py:176",
        "launches": km["launches"]["fused"]["fused_cluster_stats"],
        **km["rec"], "process_launches": _mp_launches(mp, "B10")})
    for key, name, line in (("B11", "flash_attention_block", 166),
                            ("B12", "flash_attention_backward_block", 374)):
        kernels.append({
            "name": f"attention_kernels.{name}", "route": "cuda",
            "source": "tpu_distalg_torch/csrc/attention.cu",
            "replaces": f"tpu_distalg/ops/pallas_attention.py:{line}",
            "launches": att["launches"]["32k 4-shard ring"][key],
            **att["recs"][key], "process_launches": _mp_launches(mp, key),
            "sass": {k: v for k, v in att["sass"].items()
                     if k.startswith(key)}})
    kernels.append({
        "name": "ssp.straggle_work", "route": "cuda",
        "source": "tpu_distalg_torch/csrc/ssp.cu",
        "replaces": "tpu_distalg/parallel/ssp.py:166",
        "note": "stands in for a plain-JAX lax.fori_loop, not a Pallas "
                "kernel; launches are the ssp:8 fused_gather run's under "
                "the straggle plan",
        "launches": sync["ssp"]["straggle_launches"],
        **sync["ssp"]["straggle_rec"]})
    print(f"[time] total: {time.perf_counter() - t_start!r} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
