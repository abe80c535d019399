"""Carry trained parameters from the JAX package into the port.

The two packages share no file format the port reads (the JAX package
checkpoints as flax msgpack), so parameters cross as numpy arrays:
``np.asarray`` of the JAX arrays on that side, these functions on this
side.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_distalg_torch.utils.device import resolve_device


def als_params_from_jax(U_np, V_np, *,
                        device: str | torch.device | None = None):
    """ALS factors ``U`` (users, r) and ``V`` (items, r) as contiguous
    float32 tensors on ``device``."""
    dev = resolve_device(device)
    U = np.array(U_np, np.float32)  # a copy: JAX's arrays are read-only
    V = np.array(V_np, np.float32)
    if U.ndim != 2 or V.ndim != 2 or U.shape[1] != V.shape[1]:
        raise ValueError(f"U {U.shape} vs V {V.shape}: want (users, r) "
                         f"and (items, r)")
    return (torch.from_numpy(U).to(dev).contiguous(),
            torch.from_numpy(V).to(dev).contiguous())
