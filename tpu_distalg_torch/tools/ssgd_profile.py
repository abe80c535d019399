"""Where the SSGD paths' time goes on the card, at bench.py's geometry
(1,048,576 rows × 125 features + bias, bf16 packed X, 8192-row blocks,
fraction 0.1; f32 X for ``bernoulli``).

    python -m tpu_distalg_torch.tools.ssgd_profile

For ``fused_train`` (kernel B2), ``fused_gather`` (B1), ``bernoulli``
with ``use_pallas`` (B6) and ``fused`` (B5) it runs a window of steps under
``torch.profiler`` (CUPTI) and prints, per step, the host's wall time
(the window ends in ``torch.cuda.synchronize()``), the device time of
each kernel or copy, their sum, and the device's idle share
(1 − device time / wall time). One JSON object per line.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from tpu_distalg_torch.models import ssgd
from tpu_distalg_torch.parallel import get_mesh, parallelize
from tpu_distalg_torch.tools.profiling import window
from tpu_distalg_torch.utils import datasets


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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
