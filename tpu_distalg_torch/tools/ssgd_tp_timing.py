"""B3 (``fused_forward_gathered``) on the card at the tp split's main
shapes: bench.py's SSGD geometry (1,048,576 rows × 125 features + bias,
bf16, 8192-row blocks, 13 of 128 sampled a step) on a 1×1 and an
emulated 1×2 mesh, over the block ids the trainer draws, so the rows
are cold as a training step finds them (27.3 MB a step at 1×1 against a
50 MB L2).

    python -m tpu_distalg_torch.tools.ssgd_tp_timing

Prints the card's name and power limit, then one JSON line per mesh:
per call of B3 over the first ``DRAWS`` steps' ids in turn (at 1×2 each
step calls it once per model slice, as the trainer does) its device
time (calls queued behind a sleeping kernel, so the card runs them back
to back with no host gap) and its wall time back to back (host clock,
ending in a synchronize), the same for the library line
(``index_select`` of the sampled blocks, then ``torch.mv`` in bf16) over
``LIB_DRAWS`` steps, and the bytes of X2 a call reads. It uses only the
wrapper's and the trainer's public entry points, so it times any
checkout of the port.
"""

from __future__ import annotations

import json

import torch

from tpu_distalg_torch.tools.ssgd_gathered_timing import (
    FEATURES,
    GBR,
    ROWS,
    STEPS,
    card,
    rotating_ms,
    trainer_draws,
)

#: steps whose draws a timing walks (each a new draw of 13 blocks); the
#: library line runs two torch ops a call, so it takes fewer
DRAWS, LIB_DRAWS = 200, 50


def main() -> int:
    from tpu_distalg_torch.models import ssgd
    from tpu_distalg_torch.ops import ssgd_kernels as tk
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.utils import datasets

    dev = torch.device("cuda")
    print(card())
    X, y = datasets.synthetic_two_class(ROWS, FEATURES, seed=0)
    X = datasets.add_bias_column(X)
    cfg = ssgd.SSGDConfig(
        n_iterations=STEPS, eval_test=False, x_dtype="bfloat16",
        sampler="fused_gather", gather_block_rows=GBR, shuffle_seed=0,
        init_seed=7, feature_sharded=True)
    for n_model in (1, 2):
        mesh = get_mesh(1, n_model, device=dev)
        _, X2, w0, meta = ssgd.prepare_fused_tp(X, y, mesh, cfg)
        P, D = meta["pack"], meta["d_total"]
        kw = dict(pack=P, d_total=D, y_col=meta["y_col"],
                  v_col=meta["v_col"], gather_block_rows=GBR)
        ids = trainer_draws(cfg, meta, dev)
        w_m = w0.view(n_model, D)
        calls = [(m, ids[t]) for t in range(DRAWS) for m in range(n_model)]
        lib_calls = [(m, ids[t].long()) for t in range(LIB_DRAWS)
                     for m in range(n_model)]
        blocks = [X2[m].reshape(-1, GBR, D) for m in range(n_model)]
        w16 = [w_m[m].to(X2.dtype) for m in range(n_model)]
        b3 = rotating_ms(
            lambda c: tk.fused_forward_gathered(X2[c[0]], w_m[c[0]], c[1],
                                                **kw), calls)
        lib = rotating_ms(
            lambda c: torch.mv(torch.index_select(blocks[c[0]], 0, c[1])
                               .reshape(-1, D), w16[c[0]]), lib_calls)
        print(json.dumps({
            "what": "B3 fused_forward_gathered, cold rows",
            "mesh": f"1x{n_model}", "D": D, "pack": P,
            "sampled_rows": int(ids.shape[1]) * GBR,
            "bytes_per_call": int(ids.shape[1]) * GBR * D
            * X2.element_size(),
            "calls": len(calls), "device_ms": b3["device_ms"],
            "wall_ms": b3["wall_ms"], "gapless": b3["gapless"],
            "library_device_ms": lib["device_ms"],
            "library_wall_ms": lib["wall_ms"],
            "library_gapless": lib["gapless"]}))
        del X2, w0, blocks, w16
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
