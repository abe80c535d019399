"""Command line of the port: train ALS, then serve its artifact.

    python -m tpu_distalg_torch.cli [--device {cuda,cpu}] als \\
        --m 4096 --n 16384 --k 64 --lam 0.0 --n-iterations 5 \\
        --checkpoint-dir D                     # prints artifact_path: D
    python -m tpu_distalg_torch.cli serve --artifact D --max-batch 32 \\
        --requests 2048 --concurrency 8

The lines printed match the JAX package's ``tda als`` and ``tda serve``.
Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpu_distalg_torch.cli")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("als", help="ALS matrix factorisation")
    a.add_argument("--m", type=int, default=100)
    a.add_argument("--n", type=int, default=500)
    a.add_argument("--k", type=int, default=10)
    a.add_argument("--lam", type=float, default=0.01)
    a.add_argument("--n-iterations", type=int, default=5)
    a.add_argument("--seed", type=int, default=0)
    a.add_argument("--checkpoint-dir", default=None,
                   help="save the trained factors here as an artifact")

    s = sub.add_parser("serve", help="serve ALS artifacts under load")
    s.add_argument("--artifact", action="append", required=True,
                   help="checkpoint directory (repeatable)")
    s.add_argument("--max-batch", type=int, default=16)
    s.add_argument("--max-delay-ms", type=float, default=5.0)
    s.add_argument("--queue-depth", type=int, default=128)
    s.add_argument("--k-top", type=int, default=10)
    s.add_argument("--requests", type=int, default=256)
    s.add_argument("--concurrency", type=int, default=4)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.cmd == "als":
        from tpu_distalg_torch.models import als

        cfg = als.ALSConfig(lam=args.lam, m=args.m, n=args.n, k=args.k,
                            n_iterations=args.n_iterations, seed=args.seed)
        res = als.fit(cfg, device=args.device,
                      checkpoint_dir=args.checkpoint_dir)
        for t, e in enumerate(res.rmse_history.cpu().numpy()):
            print(f"iterations: {t}, rmse: {float(e):f}")
        if args.checkpoint_dir:
            from tpu_distalg_torch.telemetry import events as tevents

            tevents.emit("artifact_path", workload="als",
                         path=args.checkpoint_dir)
            print(f"artifact_path: {args.checkpoint_dir}")
    elif args.cmd == "serve":
        import numpy as np

        from tpu_distalg_torch import serve

        cfg = serve.ServeConfig(
            max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
            queue_depth=args.queue_depth, k_top=args.k_top)
        server = serve.Server(cfg, device=args.device)
        try:
            for path in args.artifact:
                model = server.add_artifact(path)
                print(f"[serve] {model.kind} model {model.name!r} from "
                      f"{path} (meta: {model.meta})")
            rng = np.random.default_rng(0)
            for name, model in server.models.items():
                n_users = max(1, model.meta["n_users"])
                payloads = list(rng.integers(0, n_users,
                                             size=args.requests))
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
