"""Where B1's and B2's time goes on the card: diagnostic builds of
``csrc/ssgd.cu`` at bench.py's geometry, on the trainer's draws; with
``--geometry epsilon`` at epsilon's 4 KB rows, on the wide ring (base
and no_copy only: the trace's stamps are in the narrow body).

    python -m tpu_distalg_torch.tools.ssgd_ring_probe [--geometry epsilon] [variant ...]

Each variant is a copy of the package under ``build/ssgd_probe/<name>/``
whose ``csrc/ssgd.cu`` is edited (the checkout's source is never
touched), built there and run in its own process:

  * ``base``: unchanged;
  * ``no_copy``: the producer arms each ring slot without copying, so the
    consumers run the row body over stale shared memory: the consumers'
    arithmetic, the partials and B2's chain without any device-memory
    traffic for the rows (its results are not gradients);
  * ``trace``: ``clock64`` stamps by consumer thread 0 of every block. B2,
    per step from the 6th: consuming the step's stages (from the first
    wait to the block's partial written), the grid barrier, the fold of
    the partials, the update and the recast of w. B1, per launch: from
    the block's start to its first stage landed, to its partial written,
    to its ticket, and the last block's fold (a block's start is after
    it has staged w). Cycles are turned into µs with the SM clock
    measured over the same launch (``%globaltimer``).

For base and no_copy it prints B1's and B3's (``fused_forward_gathered``
on the same rows, which shares the ring's producer) device time a call
and B2's per 125 steps with and without ``skip_update``, as
``ssgd_gathered_timing`` times them; for trace the medians and 10th/90th percentiles over blocks and
steps. One JSON line per variant, each beside the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_DIR = os.path.join(os.path.dirname(_PKG), "build", "ssgd_probe")

#: source edits per variant: (text in csrc/ssgd.cu, its replacement)
_NO_COPY = [
    ("      mbar_expect_tx(full + slot, bytes);  // releases the mask's writes",
     "      mbar_expect_tx(full + slot, 0u);\n      bytes = 0;"),
    ("        if (b >= 0 && b < a.n_blocks)\n          bulk_copy(",
     "        if (bytes && b >= 0 && b < a.n_blocks)\n          bulk_copy("),
]
_TRACE = [
    ("  int slot = 0, phase = 0;\n",
     "  int slot = 0, phase = 0;\n"
     "  long long* probe = reinterpret_cast<long long*>(\n"
     "      partial + 2 * static_cast<size_t>(nb) * Wp);\n"
     "  const bool stamp = threadIdx.x == 0;\n"
     "  long long gt;\n"
     "  if (!TRAIN && stamp) probe[blockIdx.x * 8] = clock64();\n"),
    ("    float acc[VPL][N] = {};\n    float cnt = 0.0f;\n"
     "    for (int i0 = r0; i0 < r1; i0 += a.stage_rows) {\n"
     "      mbar_wait(full + slot, phase);\n",
     "    float acc[VPL][N] = {};\n    float cnt = 0.0f;\n"
     "    if (TRAIN && stamp) {\n"
     "      probe[(blockIdx.x * T_steps + t) * 8] = clock64();\n"
     "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt));\n"
     "      probe[(blockIdx.x * T_steps + t) * 8 + 6] = gt;\n"
     "    }\n"
     "    for (int i0 = r0; i0 < r1; i0 += a.stage_rows) {\n"
     "      mbar_wait(full + slot, phase);\n"
     "      if (!TRAIN && stamp && i0 == r0) probe[blockIdx.x * 8 + 1] = "
     "clock64();\n"),
    ("    consumer_sync<kRingConsumers>();\n    if (!TRAIN) {\n"
     "      if (threadIdx.x == 0) {\n",
     "    consumer_sync<kRingConsumers>();\n"
     "    if (stamp) probe[TRAIN ? (blockIdx.x * T_steps + t) * 8 + 1\n"
     "                           : blockIdx.x * 8 + 2] = clock64();\n"
     "    if (!TRAIN) {\n      if (threadIdx.x == 0) {\n"),
    ("      consumer_sync<kRingConsumers>();\n      if (*flag) {\n",
     "      consumer_sync<kRingConsumers>();\n"
     "      if (stamp) {\n"
     "        probe[blockIdx.x * 8 + 3] = clock64();\n"
     "        probe[blockIdx.x * 8 + 4] = probe[blockIdx.x * 8 + 3];\n"
     "      }\n"
     "      if (*flag) {\n"),
    ("        if (threadIdx.x == 0) counters[0] = 0u;\n",
     "        if (threadIdx.x == 0) counters[0] = 0u;\n"
     "        if (stamp) probe[blockIdx.x * 8 + 4] = clock64();\n"),
    ("    const int S = fold_slices(buf, nb, Wp, scratch);\n",
     "    if (stamp) probe[(blockIdx.x * T_steps + t) * 8 + 2] = clock64();\n"
     "    const int S = fold_slices(buf, nb, Wp, scratch);\n"
     "    if (stamp) probe[(blockIdx.x * T_steps + t) * 8 + 3] = clock64();\n"),
    ("    load_wq<T, VPL>(w_s, a.L, G, a.y_col, wq);\n  }\n",
     "    load_wq<T, VPL>(w_s, a.L, G, a.y_col, wq);\n"
     "    if (stamp) {\n"
     "      probe[(blockIdx.x * T_steps + t) * 8 + 4] = clock64();\n"
     "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt));\n"
     "      probe[(blockIdx.x * T_steps + t) * 8 + 7] = gt;\n"
     "    }\n  }\n"),
]
VARIANTS = {"base": [], "no_copy": _NO_COPY, "trace": _TRACE}


def make_variant(name: str) -> str:
    """A copy of the package with the variant's edits; returns its root."""
    root = os.path.join(PROBE_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_PKG, os.path.join(root, "tpu_distalg_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(root, "tpu_distalg_torch", "csrc", "ssgd.cu")
    with open(src) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the edit's anchor is not found "
                               f"once in csrc/ssgd.cu: {old!r}")
        text = text.replace(old, new)
    # tda: ignore[TDA030] -- a probe run by hand: it edits a scratch
    # copy of the package, never a run's state
    with open(src, "w") as f:
        f.write(text)
    return root


def _setup(geometry: str):
    import torch

    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.tools import ssgd_gathered_timing as tm
    from tpu_distalg_torch.utils import datasets

    rows, features, gbr = tm.GEOMETRIES[geometry]
    dev = torch.device("cuda", 0)
    X, y = datasets.synthetic_two_class(rows, features, seed=0)
    X = datasets.add_bias_column(X)
    cfg = ssgd.SSGDConfig(
        n_iterations=tm.STEPS, eval_test=False, x_dtype="bfloat16",
        sampler="fused_train", gather_block_rows=gbr, shuffle_seed=0,
        init_seed=7, mega_steps=tm.MEGA)
    _, X2, w0, meta = ssgd.prepare_fused(X, y, get_mesh(data=1, device=dev),
                                         cfg)
    kw = dict(pack=meta["pack"], d_total=meta["d_total"],
              y_col=meta["y_col"], v_col=meta["v_col"],
              gather_block_rows=gbr)
    return dev, X2, w0, tm.trainer_draws(cfg, meta, dev), kw


def _times(dev, X2, w0, ids, kw) -> dict:
    from tpu_distalg_torch.ops import ssgd_kernels as tk
    from tpu_distalg_torch.tools import ssgd_gathered_timing as tm

    segs = list(ids.reshape(tm.STEPS // tm.MEGA, tm.MEGA, -1))
    b1 = tm.rotating_ms(lambda d: tk.fused_grad_sum_gathered(X2, w0, d, **kw),
                        list(ids[:tm.B1_DRAWS]))
    b2 = tm.rotating_ms(lambda d: tk.fused_train_gathered(X2, w0, d, eta=0.1,
                                                          **kw), segs)
    skip = tm.rotating_ms(lambda d: tk.fused_train_gathered(
        X2, w0, d, eta=0.1, skip_update=True, **kw), segs)
    b3kw = dict(pack=kw["pack"], d_total=kw["d_total"], y_col=kw["y_col"],
                v_col=kw["v_col"], gather_block_rows=kw["gather_block_rows"])
    b3 = tm.rotating_ms(lambda d: tk.fused_forward_gathered(X2, w0, d,
                                                            **b3kw),
                        list(ids[:tm.B1_DRAWS]))
    return {"B1_device_ms": b1["device_ms"], "B3_device_ms": b3["device_ms"],
            "B2_ms_per_125_steps": b2["device_ms"],
            "B2_skip_update_ms": skip["device_ms"],
            "B2_chain_us_per_step": (b2["device_ms"] - skip["device_ms"])
            / tm.MEGA * 1e3}


def _spread(x) -> list:
    return [float(v) for v in np.percentile(x, [10, 50, 90])]


def _trace(dev, X2, w0, ids, kw) -> dict:
    import torch

    from tpu_distalg_torch.ops import _native
    from tpu_distalg_torch.ops import ssgd_kernels as tk
    from tpu_distalg_torch.tools import ssgd_gathered_timing as tm

    T, n_s = tm.MEGA, ids.shape[1]
    plan = tk.gathered_plan(n_s * kw["gather_block_rows"], kw["d_total"],
                            X2.dtype, _native.sm_count(dev.index))
    nb, wp = plan["blocks"], (kw["d_total"] + 4) // 4 * 4
    off = tk.WORK_COUNTERS + 2 * nb * wp
    work = torch.zeros(off + 2 * 8 * nb * T, device=dev)
    _native._WORKSPACES[("ssgd", dev.index, _native.stream(dev))] = work
    out = {}
    for seg in range(3):
        tk.fused_train_gathered(X2, w0, ids[seg * T:(seg + 1) * T], eta=0.1,
                                **kw)
    torch.cuda.synchronize()
    st = work[off:off + 2 * 8 * nb * T].view(torch.int64).reshape(
        nb, T, 8).cpu().numpy()
    cyc = (st[0, -1, 4] - st[0, 0, 0]) / (st[0, -1, 7] - st[0, 0, 6])
    s = st[:, 5:, :5].astype(np.float64) / cyc / 1e3      # µs
    out["sm_clock_ghz"] = float(cyc)
    out["B2_us_per_step"] = {
        "consume": _spread(s[..., 1] - s[..., 0]),
        "barrier": _spread(s[..., 2] - s[..., 1]),
        "fold": _spread(s[..., 3] - s[..., 2]),
        "update_and_recast": _spread(s[..., 4] - s[..., 3]),
        "period": _spread(st[:, 6:, 0] / cyc / 1e3 - st[:, 5:-1, 0]
                          / cyc / 1e3)}
    for _ in range(3):
        tk.fused_grad_sum_gathered(X2, w0, ids[0], **kw)
    torch.cuda.synchronize()
    b = work[off:off + 2 * 8 * nb].view(torch.int64).reshape(
        nb, 8).cpu().numpy().astype(np.float64) / cyc / 1e3
    last = int(np.argmax(b[:, 4] - b[:, 3]))
    out["B1_us"] = {
        "start_to_first_stage": _spread(b[:, 1] - b[:, 0]),
        "first_stage_to_partial": _spread(b[:, 2] - b[:, 1]),
        "partial_to_ticket": _spread(b[:, 3] - b[:, 2]),
        "last_block_fold": float(b[last, 4] - b[last, 3]),
        "last_block_start_to_end": float(b[last, 4] - b[last, 0])}
    return out


def run(name: str, geometry: str) -> dict:
    """Measure the variant whose package is on sys.path."""
    from tpu_distalg_torch.tools.ssgd_gathered_timing import card

    args = _setup(geometry)
    out = {"variant": name, "geometry": geometry, "card": card()}
    out.update(_trace(*args) if name == "trace" else _times(*args))
    return out


def main(argv=None) -> int:
    import argparse

    from tpu_distalg_torch.tools import ssgd_gathered_timing as tm

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--run"]:
        print(json.dumps(run(argv[1], argv[2])))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--geometry", choices=sorted(tm.GEOMETRIES),
                    default="bench")
    ap.add_argument("variants", nargs="*", help=f"of {list(VARIANTS)}")
    args = ap.parse_args(argv)
    names = args.variants or list(VARIANTS)
    if set(names) - set(VARIANTS):
        ap.error(f"unknown variants {sorted(set(names) - set(VARIANTS))}")
    if args.geometry != "bench":
        if "trace" in args.variants:
            ap.error("the trace variant stamps the narrow body only")
        names = [n for n in names if n != "trace"]
    for name in names:
        root = make_variant(name)
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, "-m",
                        "tpu_distalg_torch.tools.ssgd_ring_probe", "--run",
                        name, args.geometry], cwd=root, env=env, check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
