"""B1 and B2 on the card at bench.py's geometry (1,048,576 rows × 125
features + bias, bf16 packed X, 8192-row blocks, 13 of 128 sampled a
step), on the draws the trainer makes, so the rows are cold as a
training step finds them (27.3 MB a step against a 50 MB L2); or, with
``--geometry epsilon``, at epsilon's (400,000 rows × 2,000 features +
bias, 4,016-byte rows, 1024-row blocks, 39 of 391 sampled, 160 MB a
step: the wide ring).

    python -m tpu_distalg_torch.tools.ssgd_gathered_timing [--geometry epsilon]

Prints one JSON line: the card's name and power limit, then per call
of B1 (``fused_grad_sum_gathered``) over the first ``B1_DRAWS`` steps'
block ids in turn its device time (the calls queued behind a sleeping
kernel, so the card runs them back to back with no host gap) and its
wall time back to back (host clock, ending in a synchronize), the same
for B1's library line; B2 (``fused_train_gathered``) per launch of 125
steps over the 12 segments of the 1500 steps' ids in turn, with and
without ``skip_update``, and the update chain per step (their
difference); the ``fused_train`` and ``fused_gather`` trainers' steps/s
over 1500 steps (best of two runs). It uses only the wrappers' and the
trainer's public entry points, so it times any checkout of the port.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

ROWS, FEATURES, GBR, STEPS, MEGA = 1 << 20, 125, 8192, 1500, 125
#: (rows, features, block rows) by ``--geometry``
GEOMETRIES = {"bench": (ROWS, FEATURES, GBR), "epsilon": (400_000, 2000, 1024)}
#: B1's draws a timing (each call a new draw of 13 blocks); the library
#: line runs about ten torch ops a call, so it takes fewer to keep its
#: launches queued behind the sleep
B1_DRAWS, LIB_DRAWS = 200, 50


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _sleep_cycles_per_ms() -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 50_000_000
    torch.cuda._sleep(cycles)           # warm
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def rotating_ms(fn, draws) -> dict:
    """Per call of ``fn(d)`` over ``draws`` in turn: ``device_ms`` (CUDA
    events around the calls, queued behind a sleeping kernel so that
    the card runs them without host gaps), ``wall_ms`` (back to back on
    the host's clock, ending in a synchronize) and ``gapless`` (the host
    had queued every call before the sleep ended; if not, device_ms
    holds host gaps too)."""
    n = len(draws)
    for d in draws[:3]:
        fn(d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for d in draws:
        fn(d)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    sleep_ms = 3.0 * wall_ms * n + 5.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms()))
    t0 = time.perf_counter()
    start.record()
    for d in draws:
        fn(d)
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return {"device_ms": start.elapsed_time(end) / n, "wall_ms": wall_ms,
            "gapless": queued_ms < sleep_ms}


def trainer_draws(cfg, meta, dev):
    """The (STEPS, n_s) block ids the trainer draws, step by step."""
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.ops import sampling
    from tpu_distalg_torch.utils import prng

    n_blocks, n_s = ssgd.fused_gather_geometry(cfg, meta, 1)
    key = prng.root_key(cfg.seed, dev)
    return sampling.sample_block_ids(
        prng.fold_in(key, torch.arange(STEPS, device=dev)), 1, n_blocks,
        n_s).reshape(STEPS, n_s).contiguous()


def main(argv=None) -> int:
    import argparse
    import dataclasses

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.ops import ssgd_kernels as tk
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES), default="bench")
    rows, features, gbr = GEOMETRIES[ap.parse_args(argv).geometry]
    dev = torch.device("cuda")
    mesh = get_mesh(data=1, device=dev)
    X, y = datasets.synthetic_two_class(rows, features, seed=0)
    X = datasets.add_bias_column(X)
    cfg = ssgd.SSGDConfig(
        n_iterations=STEPS, eval_test=False, x_dtype="bfloat16",
        sampler="fused_train", gather_block_rows=gbr, shuffle_seed=0,
        init_seed=7, mega_steps=MEGA)
    fn_train, X2, w0, meta = ssgd.prepare_fused(X, y, mesh, cfg)
    fn_gather = ssgd.make_train_fn_fused(
        mesh, dataclasses.replace(cfg, sampler="fused_gather"), meta)
    ids = trainer_draws(cfg, meta, dev)
    D, yc, vc = meta["d_total"], meta["y_col"], meta["v_col"]
    kw = dict(pack=meta["pack"], d_total=D, y_col=yc, v_col=vc,
              gather_block_rows=gbr)
    blocks = X2.reshape(-1, gbr, D)
    wq = w0.to(X2.dtype)

    def lib1(ids_l):
        x = torch.index_select(blocks, 0, ids_l).reshape(-1, D)
        r = (torch.sigmoid(torch.mv(x, wq).float()) - x[:, yc].float()) \
            * x[:, vc].float()
        return torch.mv(x.T, r.to(x.dtype)).float(), x[:, vc].float().sum()

    out = {"card": card(), "torch": torch.__version__}
    out["B1"] = rotating_ms(
        lambda d: tk.fused_grad_sum_gathered(X2, w0, d, **kw),
        list(ids[:B1_DRAWS]))
    out["B1_library"] = rotating_ms(lib1, list(ids[:LIB_DRAWS].long()))
    segs = list(ids.reshape(STEPS // MEGA, MEGA, -1))
    out["B2_per_125_steps"] = rotating_ms(
        lambda d: tk.fused_train_gathered(X2, w0, d, eta=0.1, **kw), segs)
    out["B2_skip_update"] = rotating_ms(
        lambda d: tk.fused_train_gathered(X2, w0, d, eta=0.1,
                                          skip_update=True, **kw), segs)
    out["B2_chain_us_per_step"] = (
        out["B2_per_125_steps"]["device_ms"]
        - out["B2_skip_update"]["device_ms"]) / MEGA * 1e3
    te = (torch.zeros((1, D), device=dev), torch.zeros((1,), device=dev))
    for name, fn in (("fused_train", fn_train), ("fused_gather", fn_gather)):
        fn(X2, None, None, *te, w0)
        rates = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(X2, None, None, *te, w0)
            torch.cuda.synchronize()
            rates.append(STEPS / (time.perf_counter() - t0))
        out[f"{name}_steps_per_s"] = rates
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
