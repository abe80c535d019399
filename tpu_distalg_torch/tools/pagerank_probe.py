"""What binds B7 and B8 on the card: diagnostic builds of
``csrc/pagerank.cu`` at bench.py's PageRank shape and on the skewed graph.

    python -m tpu_distalg_torch.tools.pagerank_probe [variant ...]

Each variant is a copy of the package under
``build/pagerank_probe/<name>/`` whose ``csrc/pagerank.cu`` is edited
(the checkout's source is never touched), built there and run in its own
process:

  * ``base``: unchanged;
  * ``gather_only``: B7's entry point runs the gather ceiling (the same
    tiles, stream loads, gathers and products, no row_ptr, no row sums, no
    tickets; one value a tile): what the gathers alone cost;
  * ``no_gather``: B7 without the gathers (each product takes its src id's
    bits for x[src]): the streams and the row structure alone;
  * ``scalar_loads``: B7 and B8 read src, w and c as 4-byte scalars on the
    same grid instead of 16-byte vectors;
  * ``t512_i4096``: blocks of 512 threads on tiles of at most 4096 path
    items (``pagerank_kernels.MAX_TILE_ITEMS``) instead of 256 on 2048;
  * ``no_fence``: the ticket's two memory fences left out (a race in
    principle; timing only);
  * ``no_combine``: rows summed in parts (over more than one tile
    boundary, or with more than 64 edges before it) not combined: what
    the tickets cost;
  * ``plain_loads``: the streams without their cache hints (L1 and L2
    as for any read-only load);
  * ``no_rows``: short rows' reads and adds left out (they write 0): what
    the row phase costs.

``base``, ``scalar_loads``, ``t512_i4096`` and ``plain_loads`` still
compute the sweeps and are held to the plain versions (rtol 1e-5 at the
main shape); ``gather_only``, ``no_gather``, ``no_fence``,
``no_combine`` and ``no_rows`` do not.
Every variant named is built first, all at once; a name may be given
twice (``base`` first and last shows the run's drift). For each variant
it prints, beside the card's name and power limit, B7's and B8's device
ms a call (CUDA events and CUPTI, ``tools/pagerank_profile``'s method)
at the main shape and on the skewed graph, one JSON line per variant.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_DIR = os.path.join(os.path.dirname(_PKG), "build", "pagerank_probe")

_GATHERS = ("""        xv[s].x = __ldg(x + sv[s].x);
        xv[s].y = __ldg(x + sv[s].y);
        xv[s].z = __ldg(x + sv[s].z);
        xv[s].w = __ldg(x + sv[s].w);
""", """        xv[s] = make_float4(__int_as_float(sv[s].x), __int_as_float(sv[s].y),
                            __int_as_float(sv[s].z), __int_as_float(sv[s].w));
""")
_TILES = "MAX_TILE_ITEMS, MIN_TILE_ITEMS, TARGET_TILES = 2048, 256, 1024"
#: source edits per variant: (text in csrc/pagerank.cu, its replacement),
#: or (file under the package, text, replacement)
VARIANTS = {
    "base": [],
    "gather_only": [
        ("  return launch<true, false>(\n      static_cast<const int*>"
         "(row_ptr), static_cast<const int*>(src),",
         "  return launch<true, true>(\n      static_cast<const int*>"
         "(row_ptr), static_cast<const int*>(src),")],
    "no_gather": [_GATHERS,
                  ("    if (se >= 0) sx = __ldg(x + ss);\n",
                   "    if (se >= 0) sx = __int_as_float(ss);\n")],
    "scalar_loads": [
        ("  const bool vec = !kGather || ((reinterpret_cast<uintptr_t>(src) ^",
         "  const bool vec = false && ((reinterpret_cast<uintptr_t>(src) ^")],
    "t512_i4096": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 512;"),
                   ("constexpr int kMaxItems = 2048;",
                    "constexpr int kMaxItems = 4096;"),
                   ("ops/pagerank_kernels.py", _TILES,
                    _TILES.replace("2048", "4096"))],
    "no_fence": [("    __threadfence();\n    last = atomicAdd(",
                  "    last = atomicAdd("),
                 ("  if (!__shfl_sync(kFull, last, 0)) return;\n"
                  "  __threadfence();\n",
                  "  if (!__shfl_sync(kFull, last, 0)) return;\n")],
    "no_combine": [("  if (r < 0) return;\n", "  return;\n")],
    "plain_loads": [
        ('      "{%0, %1, %2, %3}, [%4], %5;"', '      "{%0, %1, %2, %3}, [%4];"'),
        ('  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 "',
         '  asm("ld.global.nc.v4.s32 "'),
        ('  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;"',
         '  asm("ld.global.nc.s32 %0, [%1];"')],
    "no_rows": [("    for (int i = b; i < e; ++i) acc = __fadd_rn(acc, "
                 "prod[i - base]);\n", "")],
}
#: the variants that still compute B7 and B8
EXACT = ("base", "scalar_loads", "t512_i4096", "plain_loads")


def make_variant(name: str) -> str:
    """A copy of the package with the variant's edits; returns its root."""
    root = os.path.join(PROBE_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_PKG, os.path.join(root, "tpu_distalg_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for edit in VARIANTS[name]:
        rel, old, new = edit if len(edit) == 3 else ("csrc/pagerank.cu",
                                                     *edit)
        path = os.path.join(root, "tpu_distalg_torch", rel)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the edit's anchor is not found "
                               f"once in {rel}: {old!r}")
        # tda: ignore[TDA030] -- a probe run by hand: it edits a
        # scratch copy of the package, never a run's state
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def run(name: str, graph: str) -> dict:
    """Measure the variant whose package is on sys.path."""
    import numpy as np
    import torch

    from tpu_distalg_torch.models import pagerank
    from tpu_distalg_torch.ops import graph as gops
    from tpu_distalg_torch.ops import pagerank_kernels as pk
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.tools import pagerank_profile as prof

    mesh = get_mesh(data=1, device="cuda")
    dev = mesh.device
    g = np.load(graph)
    el = gops.EdgeList(src=g["src"], dst=g["dst"],
                       n_vertices=prof.N_VERTICES,
                       out_degree=g["out_degree"])
    de = pagerank.prepare_device_edges(el, mesh)
    (rp, src, w), plan = de.shards[0], de.plans[0]
    x = torch.as_tensor(np.random.default_rng(17).random(
        prof.N_VERTICES).astype(np.float32), device=dev)
    out = {"variant": name, "card": prof.card()}
    if name in EXACT:
        c = torch.index_select(x, 0, src) * w
        torch.testing.assert_close(pk.spmv_table(rp, src, w, x, plan),
                                   pk.spmv_table_reference(rp, src, w, x),
                                   rtol=1e-5, atol=1e-8)
        torch.testing.assert_close(pk.scatter_table(rp, c, plan),
                                   pk.scatter_table_reference(rp, c),
                                   rtol=1e-5, atol=1e-8)
    out["main"] = prof._kernel_times(pk, rp, src, w, x, plan)
    srp, ssrc = (torch.as_tensor(a, device=dev) for a in prof.skewed_rows())
    sw = torch.as_tensor(np.random.default_rng(18).random(
        ssrc.shape[0]).astype(np.float32), device=dev)
    out["skewed"] = prof._kernel_times(pk, srp, ssrc, sw, x,
                                       pk.tile_plan(srp, ssrc.shape[0]))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--run"]:
        print(json.dumps(run(argv[1], argv[2])), flush=True)
        return 0
    from tpu_distalg_torch.tools import pagerank_profile

    names = argv or list(VARIANTS)
    roots = {name: make_variant(name) for name in dict.fromkeys(names)}
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "from tpu_distalg_torch.ops import _native; "
         "_native.finish(_native.build('pagerank'))"], cwd=root,
        env=dict(os.environ, PYTHONPATH=root)) for name, root in
        roots.items()}
    graph = pagerank_profile.prepare_graph()
    for name, proc in builds.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{name}: the build failed")
    for name in names:
        env = dict(os.environ, PYTHONPATH=roots[name])
        subprocess.run([sys.executable, "-m",
                        "tpu_distalg_torch.tools.pagerank_probe", "--run",
                        name, graph], cwd=roots[name], env=env, check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
