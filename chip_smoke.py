"""Drive the PyTorch/CUDA port (``tpu_distalg_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. device: the card's name, and its power limit from nvidia-smi;
  2. build: nvcc builds every kernel of the main path from ``csrc/``;
  3. kernels: each kernel against its plain PyTorch version on the card —
     exact integer cases bitwise, random cases by the tie-tolerance rule
     — and its time beside the plain version's, a library call's and
     the card's bound;
  4. ALS: the card against the CPU at a small size, then the main path's
     training at full width (4096 users × 16384 items, rank 64);
  5. serve: the trained artifact loaded into the micro-batching server
     and 2048 requests answered through the kernel, each checked against
     the plain version;
  6. the kernels line, then the last line
     ``{"ok": true, "device": {"platform": "gpu", ...}}``.

The launch counters are set to 0 just before the main path (phases 4's
full-width fit and 5) and read just after it, so the kernels line shows
that the path went through every kernel.
"""

from __future__ import annotations

import json
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
    rec = None
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
        ms = _time_ms(lambda: topk.fused_matmul_topk(Qd, Vd, 0, N, k=k))
        plain_ms = _time_ms(
            lambda: topk.matmul_topk_reference(Qd, Vd, 0, N, k=k))
        library_ms = _time_ms(lambda: torch.topk(Qd @ Vd.T, k, dim=1))
        bound_ms, bound_by = _topk_bound_ms(B, N, d, k)
        print(f"[kernels] topk random B={B} d={d} N={N} k={k}: within the "
              f"tie-tolerance rule (rtol 1e-5), max |err| {err!r}; "
              f"kernel {ms!r} ms, plain {plain_ms!r} ms, torch.matmul+"
              f"torch.topk {library_ms!r} ms, bound {bound_ms!r} ms "
              f"({bound_by}); V warm in L2 where it fits (50 MB)")
        if N == ITEMS:  # the main path's shape
            rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms}
        del Qd, Vd
    return rec


def check_als_small(dev) -> None:
    """Phase 4a: ALS on the card against the port's own CPU run."""
    from tpu_distalg_torch.models import als

    cfg = als.ALSConfig(m=512, n=2048, k=16, n_iterations=3, seed=SEED)
    gpu = als.fit(cfg, device=dev).rmse_history.cpu().numpy()
    cpu = als.fit(cfg, device="cpu").rmse_history.numpy()
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

    cfg = als.ALSConfig(lam=0.0, m=USERS, n=ITEMS, k=RANK,
                        n_iterations=SWEEPS, seed=SEED)
    # bench.py's full-width target (bench.py:2984-2986): exactly rank
    # 64 with N(0, 0.3²) factors. synthesize_rank_k's U[0,1) factors
    # share one dominant direction at rank 64, which leaves the first
    # sweep's float32 factors too ill-conditioned: the rmse then stalls
    # near 8e-4 of RMS(R) (python -m tpu_distalg_torch.tools.als_precision)
    rng = np.random.default_rng(SEED)
    R = (rng.normal(0.0, 0.3, (USERS, RANK)).astype(np.float32)
         @ rng.normal(0.0, 0.3, (ITEMS, RANK)).astype(np.float32).T)
    rms_r = float(np.sqrt(np.mean(np.square(R, dtype=np.float64))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = als.fit(cfg, R, device=dev, checkpoint_dir=workdir)
    hist = res.rmse_history.cpu().numpy()
    fit_s = time.perf_counter() - t0
    print(f"[als] {USERS}x{ITEMS} rank {RANK}, lam 0.0, {SWEEPS} sweeps: "
          f"rmse {hist.tolist()}; fit {fit_s!r} s including R to the card "
          f"and the artifact save ({fit_s / SWEEPS!r} s/sweep at most)")
    if not hist[-1] < 1e-3 * rms_r:
        raise AssertionError(f"final rmse {hist[-1]} not below 1e-3 x "
                             f"RMS(R) = {1e-3 * rms_r}")
    del R, res

    cfg_s = serve.ServeConfig(max_batch=MAX_BATCH, max_delay_ms=2.0,
                              k_top=K_TOP)
    server = serve.Server(cfg_s, device=dev)
    try:
        server.add_artifact(workdir)
        rng = np.random.default_rng(SEED + 7)
        ids = rng.integers(0, USERS, size=REQUESTS)
        results, info = serve.run_closed_loop(
            server, "als", list(ids), concurrency=CONCURRENCY)
        stats = server.emit_counters()
    finally:
        server.close()
    return {"ids": ids, "results": results, "info": info, "stats": stats}


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
    Q = U[torch.as_tensor(run["ids"], device=dev)].contiguous()
    rv, ri = topk.matmul_topk_reference(Q, V, 0, V.shape[0], k=K_TOP + 1)
    gv = np.stack([v for v, _ in run["results"]])
    gi = np.stack([i for _, i in run["results"]])
    topk.assert_topk_close(gv, gi, rv, ri, rtol=1e-5)
    print(f"[serve] {info['ok']}/{REQUESTS} replies in {stats['batches']} "
          f"micro-batches, each equal to the plain version by the "
          f"tie-tolerance rule; {info['qps']!r} req/s (closed loop, "
          f"{CONCURRENCY} workers), p50 {stats['p50_ms']!r} ms, p99 "
          f"{stats['p99_ms']!r} ms, {stats['shed']} shed")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    from tpu_distalg_torch.ops import _native, topk
    from tpu_distalg_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    print(_nvidia_smi())

    t0 = time.perf_counter()
    builds = [_native.build(name) for name in ("topk",)]  # all at once
    for b in builds:
        _native.finish(b)
    _native.load("topk")
    print(f"[build] nvcc built csrc/topk.cu in "
          f"{time.perf_counter() - t0!r} s")

    rec = check_topk_kernel(dev)
    check_als_small(dev)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as workdir:
        topk.fused_matmul_topk.launches = 0
        run = run_main_path(dev, workdir)
        launches = topk.fused_matmul_topk.launches
        if launches < 1 or launches < run["stats"]["batches"]:
            raise AssertionError(
                f"fused_matmul_topk launched {launches} time(s) for "
                f"{run['stats']['batches']} batches: the main path did "
                f"not go through the kernel")
        check_served(dev, workdir, run)
    print(f"[serve] fused_matmul_topk launches on the main path: "
          f"{launches}")

    print(json.dumps({"kernels": [{
        "name": "topk.fused_matmul_topk", "route": "cuda",
        "source": "tpu_distalg_torch/csrc/topk.cu",
        "replaces": "tpu_distalg/ops/pallas_topk.py:109",
        "launches": launches, **rec}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
