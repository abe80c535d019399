"""Where B9's time goes on the card: diagnostic builds of
``csrc/topk.cu`` at the serving shape and beside it.

    python -m tpu_distalg_torch.tools.topk_probe [variant ...]

Each variant is a copy of the package under ``build/topk_probe/<name>/``
whose ``csrc/topk.cu`` is edited (the checkout's source is never
touched), built there and run in its own process:

  * ``base``: unchanged;
  * ``no_select``: the blocks score their items but offer none of them
    (the scores only feed a branch that is never taken, and the early
    bound is off): the loads, the FMAs and the stage barriers alone;
  * ``loads_only``: ``no_select`` without the FMAs (the stages still
    land): what the loads and barriers cost;
  * ``fma_only``: ``no_select`` without the copies (the FMAs read stale
    shared memory): what the arithmetic costs;
  * ``no_merge``: the last block of a query tile writes its own list
    without taking in the other blocks' lists: everything but the
    cross-block merge;
  * the pruning mechanisms, each switched off alone (these builds still
    return the exact top k, and are held to the plain version):
    ``no_warp_bound`` (the warp's early bound while a list fills, k <=
    32), ``no_heads_bound`` (the merge's bound from the lists' heads),
    ``no_alive`` (the merge's bit a list, which stops loading a list
    once an entry of it is turned away) and ``no_rank_merge`` (every
    flush by the bitonic sort and the merge path, none by ranks);
  * ``trace``: ``clock64`` stamps by thread 0 of every block into the
    workspace past ``TRACE_OFFSET``: its scoring loop, the part of it
    spent waiting for stages and in selection, its ticket, and the last
    block's merge.

Results of the diagnostic builds are not top-k results. Every variant
named is built first, all at once; a name may be given twice (``base``
first and last shows the run's drift). For each variant it
prints, beside the card's name and power limit, B9's device time a call
(CUPTI, ``tools/topk_profile``'s method) at the cases of
``tools/topk_profile.CASES`` (trace: the stamps' spreads), one JSON line
per variant.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_DIR = os.path.join(os.path.dirname(_PKG), "build", "topk_probe")

#: source edits per variant: (text in csrc/topk.cu, its replacement)
_NO_SELECT = [
    ("      select<F, QV, true>(s, cv, ci, cq, pend);\n",
     "      if (pend == 0x5a5a5a5au && cv[0] == 1.5f && cv[F - 1] == 2.5f)\n"
     "        s.qcnt[0] = ci[0] + cq[0];\n"),
    # with no selection the lists never fill: the early bound would run
    # at every sub-tile instead of the first
    ("      if (k <= 32 && __syncthreads_or(filling)) {\n",
     "      if (k < 0 && __syncthreads_or(filling)) {\n")]
#: the builds that switch one pruning mechanism off: still exact
MECHANISMS = {
    "no_warp_bound": [
        ("      if (k <= 32 && __syncthreads_or(filling)) {\n",
         "      if (k < 0 && __syncthreads_or(filling)) {\n")],
    "no_heads_bound": [("  if (k <= 32) {\n", "  if (k < 0) {\n")],
    "no_alive": [
        ("  if (alive_words > NB * SUB * kRow) alive = nullptr;\n",
         "  alive = nullptr;\n")],
    "no_rank_merge": [("  if (n <= kCount) {\n", "  if (false) {\n")],
}
VARIANTS = {
    "base": [],
    "no_select": _NO_SELECT,
    "loads_only": _NO_SELECT + [
        ("    for (int f = 0; f < kDk; f += 4) {\n",
         "    for (int f = kDk; f < kDk; f += 4) {\n")],
    "fma_only": _NO_SELECT + [
        ("    if (st >= n_st) {\n    } else if (VEC) {\n",
         "    if (true) {\n    } else if (VEC) {\n")],
    "no_merge": [
        ("  for (int e0 = 0; e0 < n_e; e0 += round) {\n",
         "  for (int e0 = n_e; e0 < n_e; e0 += round) {\n")],
    "trace": [
        ("  const int k = a.k;\n  const int tid = threadIdx.x;\n",
         "  const int k = a.k;\n  const int tid = threadIdx.x;\n"
         "  long long* prb = reinterpret_cast<long long*>(a.tickets) + "
         "TRACE_OFFSET + blockIdx.x * 16;\n"
         "  long long t_wait = 0, t_sel = 0, t_a, gt;\n"
         "  const long long t_start = clock64();\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt));\n"
         "  if (tid == 0) prb[7] = gt;\n"),
        ("    issue(st + NB - 1);\n",
         "    t_a = clock64();\n    issue(st + NB - 1);\n"),
        ("    __syncthreads();\n    const int u = st / n_dc;\n",
         "    __syncthreads();\n    t_wait += clock64() - t_a;\n"
         "    const int u = st / n_dc;\n"),
        ("      select<F, QV, true>(s, cv, ci, cq, pend);\n",
         "      t_a = clock64();\n      select<F, QV, true>(s, cv, ci, cq, pend);\n"
         "      t_sel += clock64() - t_a;\n"),
        ("  if (a.n_ranges == 1) {  // the block's lists are the result\n",
         "  if (tid == 0) {\n    prb[0] = t_start;\n    prb[1] = clock64();\n"
         "    prb[2] = t_wait;\n    prb[3] = t_sel;\n    prb[4] = n_st;\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt));\n"
         "    prb[8] = gt;\n  }\n"
         "  if (a.n_ranges == 1) {  // the block's lists are the result\n"),
        ("  if (!*flag) return;\n",
         "  if (tid == 0) prb[5] = clock64();\n  if (!*flag) return;\n"),
        ("  if (tid == 0) a.tickets[qtile] = 0u;  // every block of the tile "
         "is done\n}\n",
         "  if (tid == 0) a.tickets[qtile] = 0u;\n"
         "  if (tid == 0) prb[6] = clock64();\n}\n"),
    ],
    **MECHANISMS,
}
#: where the trace variant writes its stamps: 64-bit words past the head
#: of the workspace, beyond what the traced cases' plans use
TRACE_OFFSET = 1 << 20


def make_variant(name: str) -> str:
    """A copy of the package with the variant's edits; returns its root."""
    root = os.path.join(PROBE_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_PKG, os.path.join(root, "tpu_distalg_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(root, "tpu_distalg_torch", "csrc", "topk.cu")
    with open(src) as f:
        text = f.read()
    if name == "trace":
        text = text.replace("namespace {\n",
                            f"namespace {{\nconstexpr long long TRACE_OFFSET"
                            f" = {TRACE_OFFSET};\n", 1)
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the edit's anchor is not found "
                               f"once in csrc/topk.cu: {old!r}")
        text = text.replace(old, new)
    # tda: ignore[TDA030] -- a probe run by hand: it edits a scratch
    # copy of the package, never a run's state
    with open(src, "w") as f:
        f.write(text)
    return root


def run(name: str) -> dict:
    """Measure the variant whose package is on sys.path."""
    import numpy as np
    import torch

    from tpu_distalg_torch.ops import topk
    from tpu_distalg_torch.tools.topk_profile import CASES, _profile, card

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    out = {"variant": name, "card": card()}
    for N, k, calls in CASES:
        Q = torch.as_tensor(rng.normal(size=(32, 64)).astype(np.float32),
                            device=dev)
        V = torch.as_tensor(rng.normal(size=(N, 64)).astype(np.float32),
                            device=dev)
        if name == "trace":
            out[f"N{N}_k{k}"] = _trace(topk, dev, Q, V, N, k)
            continue
        if name in MECHANISMS or name == "base":
            gv, gi = topk.fused_matmul_topk(Q, V, 0, N, k=k)
            rv, ri = topk.matmul_topk_reference(Q, V, 0, N, k=k + 1)
            topk.assert_topk_close(gv, gi, rv, ri, rtol=1e-5)
        _, act = _profile(lambda: topk.fused_matmul_topk(Q, V, 0, N, k=k),
                          calls)
        out[f"N{N}_k{k}_device_ms"] = sum(
            t for n, (t, _) in act.items() if "topk" in n) / calls / 1e3
    return out


def _trace(topk, dev, Q, V, N: int, k: int) -> dict:
    """The trace build's stamps (thread 0 of every block, ``clock64``):
    per block the whole scoring loop, the part of it spent waiting for
    stages (issue to the barrier after the wait) and in selection, the
    ticket, and the last block's merge; µs by the SM clock measured over
    the loop (``%globaltimer``); 10th, 50th and 90th percentiles over
    blocks, the merge's largest."""
    import numpy as np
    import torch

    from tpu_distalg_torch.ops import _native

    plan = topk.topk_plan(Q.shape[0], N, k, None,
                          _native.sm_count(dev.index))
    words = 2 * TRACE_OFFSET + 2 * 16 * plan["blocks"]
    ws = torch.zeros((words,), dtype=torch.int32, device=dev)
    key = ("topk state", dev.index, _native.stream(dev))
    _native._WORKSPACES[key] = ws
    for _ in range(3):
        topk.fused_matmul_topk(Q, V, 0, N, k=k)
    torch.cuda.synchronize()
    st = ws[2 * TRACE_OFFSET:].view(torch.int64).reshape(
        -1, 16)[:plan["blocks"]].cpu().numpy().astype(np.float64)
    del _native._WORKSPACES[key]
    ghz = float(np.median((st[:, 1] - st[:, 0]) / (st[:, 8] - st[:, 7])))
    us = st / ghz / 1e3

    def spread(x):
        return [float(v) for v in np.percentile(x, [10, 50, 90])]

    merge = us[:, 6] - us[:, 5]
    return {"sm_clock_ghz": ghz, "stages": int(st[0, 4]),
            "loop_us": spread(us[:, 1] - us[:, 0]),
            "waiting_us": spread(us[:, 2]), "select_us": spread(us[:, 3]),
            "ticket_us": spread(us[:, 5] - us[:, 1]),
            "merge_us_max": float(merge.max()),
            "blocks": plan["blocks"]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--run"]:
        print(json.dumps(run(argv[1])))
        return 0
    names = argv or list(VARIANTS)
    roots = {name: make_variant(name) for name in dict.fromkeys(names)}
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "from tpu_distalg_torch.ops import _native; "
         "_native.finish(_native.build('topk'))"], cwd=root,
        env=dict(os.environ, PYTHONPATH=root)) for name, root in
        roots.items()}
    for name, proc in builds.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{name}: the build failed")
    for name in names:
        env = dict(os.environ, PYTHONPATH=roots[name])
        subprocess.run([sys.executable, "-m",
                        "tpu_distalg_torch.tools.topk_probe", "--run",
                        name], cwd=roots[name], env=env, check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
