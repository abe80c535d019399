"""Where the SSGD paths' time goes on the card, at bench.py's geometry
(1,048,576 rows × 125 features + bias, bf16 packed X, 8192-row blocks,
fraction 0.1; f32 X for ``bernoulli``).

    python -m tpu_distalg_torch.tools.ssgd_profile

For ``fused_train`` (kernel B2), ``fused_gather`` (B1), ``bernoulli``
with ``use_pallas`` (B6), ``fused`` (B5) and the tensor-parallel split
of ``fused_gather`` (B3 and B4) on emulated 1×1 and 1×2 meshes, and at
bench.py's mesh2d width (65,536 rows × 8192 features, every 1024-row
block sampled) on a 2×2 mesh, it runs a window of steps under
``torch.profiler`` (CUPTI) and prints, per step, the host's wall time
(the window ends in ``torch.cuda.synchronize()``), the device time of
each kernel or copy, their sum, the device's idle share (1 − device
time / wall time) and, for the split, B3's and B4's share of the device
time (B4's fold launch included). One JSON object per line.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.parallel import get_mesh, parallelize
from tpu_distalg_torch.tools.profiling import window
from tpu_distalg_torch.utils import datasets

#: the kernel names of B3 and B4 (and B4's fold, which the split shares
#: with no other kernel)
TP_KERNELS = ("forward_narrow_kernel", "forward_wide_kernel",
              "backward_kernel", "reduce_partials")
TP_GROUPS = {"B3 + B4": TP_KERNELS}


def _tp_runs(X, y, cfg, shapes, steps):
    """A run of ``steps`` steps of the split per (data, model) shape."""
    runs = {}
    for n_data, n_model in shapes:
        mesh = get_mesh(data=n_data, model=n_model, device="cuda")
        c = dataclasses.replace(cfg, sampler="fused_gather", n_iterations=steps,
                                feature_sharded=True)
        fn, X2, w0, meta = ssgd.prepare_fused_tp(X, y, mesh, c)
        te = (torch.zeros((1, n_model * meta["d_total"]), device="cuda"),
              torch.zeros((1,), device="cuda"))
        runs[(n_data, n_model)] = (
            lambda fn=fn, X2=X2, te=te, w0=w0: fn(X2, None, None, *te, w0))
    return runs


def main() -> int:
    mesh = get_mesh(data=1, device="cuda")
    X, y = datasets.synthetic_two_class(1 << 20, 125, seed=0)
    X = datasets.add_bias_column(X)
    cfg = ssgd.SSGDConfig(
        eval_test=False, x_dtype="bfloat16", sampler="fused_train",
        gather_block_rows=8192, shuffle_seed=0, init_seed=7)
    windows = {"fused_train": 250, "fused_gather": 125, "bernoulli": 25,
               "fused": 125}
    fn_t, X2, w0, meta = ssgd.prepare_fused(
        X, y, mesh, dataclasses.replace(cfg,
                                        n_iterations=windows["fused_train"]))
    fn_g = ssgd.make_train_fn_fused(mesh, dataclasses.replace(
        cfg, sampler="fused_gather", n_iterations=windows["fused_gather"]),
        meta)
    fn_f = ssgd.make_train_fn_fused(mesh, dataclasses.replace(
        cfg, sampler="fused", fused_block_rows=cfg.gather_block_rows,
        n_iterations=windows["fused"]), meta)
    Xs, ys = parallelize(X, mesh), parallelize(y, mesh)
    fn_b = ssgd.make_train_fn(mesh, ssgd.SSGDConfig(
        n_iterations=windows["bernoulli"], eval_test=False,
        use_pallas=True), Xs.n_padded)
    te = (torch.zeros((1, meta["d_total"]), device=mesh.device),
          torch.zeros((1,), device=mesh.device))
    te_plain = (torch.zeros((1, X.shape[1]), device=mesh.device), te[1])
    w0p = w0[:X.shape[1]].contiguous()
    runs = {
        "fused_train": lambda: fn_t(X2, None, None, *te, w0),
        "fused_gather": lambda: fn_g(X2, None, None, *te, w0),
        "bernoulli": lambda: fn_b(Xs.data, ys.data, Xs.mask, *te_plain,
                                  w0p),
        "fused": lambda: fn_f(X2, None, None, *te, w0),
    }
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}))
    for name, run in runs.items():
        print(json.dumps({"path": name, "steps": windows[name],
                          **window(run, windows[name])}))
    del runs, fn_t, fn_g, fn_f, fn_b, X2, Xs, ys
    tp_steps = 125
    for (n_data, n_model), run in _tp_runs(
            X, y, dataclasses.replace(cfg, gather_block_rows=8192),
            ((1, 1), (1, 2)), tp_steps).items():
        print(json.dumps({"path": f"fused_gather tp {n_data}x{n_model}",
                          "steps": tp_steps,
                          **window(run, tp_steps, TP_GROUPS)}))
    rng = np.random.default_rng(0)
    Xw = rng.standard_normal((65536, 8192)).astype(np.float32)
    yw = (Xw[:, 0] > 0).astype(np.float32)
    wide_steps = 30
    for (n_data, n_model), run in _tp_runs(
            Xw, yw, dataclasses.replace(cfg, mini_batch_fraction=1.0,
                                        gather_block_rows=1024,
                                        shuffle_seed=None),
            ((2, 2),), wide_steps).items():
        print(json.dumps({"path": f"fused_gather tp wide {n_data}x{n_model}",
                          "steps": wide_steps,
                          **window(run, wide_steps, TP_GROUPS)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
