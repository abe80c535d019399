"""Where a ring-attention call's time goes on the card, at bench.py's
geometry (``bench.py:3087-3240``): 32,768 tokens, 8 heads, head dim
128, bf16, causal, one hop (one card), q, k, v N(0, 1) from a seeded
``torch.Generator`` on the card.

    python -m tpu_distalg_torch.tools.attention_profile

For the flash forward (kernel B11), the flash forward + backward
(B11, then the B12 ring: its dQ and dK/dV passes; loss Σ out², all
three cotangents taken) and the torch-op forward at ``kv_chunk`` 2048,
it runs a few calls under ``torch.profiler`` (CUPTI) and prints, per
call, the host's wall time (the window ends in
``torch.cuda.synchronize()``), the device time of the top kernels and
copies, their sum, the device's idle share (1 − device time / wall
time), and the share of the device time in B11, B12's two passes and
everything else (the layout copies, lse, delta, o / l: the prep ops).
Tokens/s and TFLOP/s count the causal forward as S²/2·d·H·4 FLOP and
the forward + backward as 3.5 times that (bench.py's counts). Last, the
one op B12's wrapper adds for bf16 q: the float32 dO rounded to bf16
before the launch (TMA copies without converting), timed alone with
CUDA events at this shape. One JSON object per line.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from tpu_distalg_torch.parallel import get_mesh, ring_attention
from tpu_distalg_torch.tools.profiling import window

S, H, D, SEED = 32768, 8, 128, 0
GROUPS = {"B11 flash_attention_block": ("fwd_hopper", "fwd_f32"),
          "B12 dQ pass": ("dq_hopper", "dq_f32"),
          "B12 dK/dV pass": ("dkv_hopper", "dkv_f32")}


def qkv(s: int, dev, seed: int = SEED):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((s, H, D), generator=g, device=dev,
                             dtype=torch.bfloat16) for _ in range(3))


def main() -> int:
    mesh = get_mesh(data=1, device="cuda")
    dev = mesh.device
    q, k, v = qkv(S, dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": card, "torch": torch.__version__,
                      "seq_len": S, "heads": H, "head_dim": D,
                      "dtype": "bfloat16", "causal": True}))
    flops = S * S / 2 * D * H * 4
    kw = dict(causal=True, use_flash=True)

    def fwd(n):
        def run():
            with torch.no_grad():
                for _ in range(n):
                    ring_attention(q, k, v, mesh, **kw)
        return run

    def fwd_bwd(n):
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))

        def run():
            for _ in range(n):
                out = ring_attention(qq, kk, vv, mesh, **kw)
                torch.autograd.grad((out * out).sum(), (qq, kk, vv))
        return run

    def torch_ops(n):
        def run():
            with torch.no_grad():
                for _ in range(n):
                    ring_attention(q, k, v, mesh, causal=True, kv_chunk=2048)
        return run

    for name, make, n, work in (("flash forward", fwd, 8, flops),
                                ("flash forward + backward", fwd_bwd, 4,
                                 3.5 * flops),
                                ("torch-op forward, kv_chunk 2048",
                                 torch_ops, 2, flops)):
        t0 = time.perf_counter()
        rec = window(make(n), n, groups=GROUPS)
        wall_s = rec["wall_us_per_step"] * 1e-6
        print(json.dumps({"path": name, "calls": n, **rec,
                          "tokens_per_s": S / wall_s,
                          "tflops_per_s": work / wall_s / 1e12,
                          "window_s": time.perf_counter() - t0}))
    do = torch.randn((H, S, D), device=dev)
    for _ in range(3):
        do.to(torch.bfloat16)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        do.to(torch.bfloat16)
    end.record()
    torch.cuda.synchronize()
    print(json.dumps({"op": "B12 wrapper: dO float32 -> bf16",
                      "ms": start.elapsed_time(end) / 20,
                      "bytes": do.numel() * 6}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
