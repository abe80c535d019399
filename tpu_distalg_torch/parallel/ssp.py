"""Stale-synchronous coordination: bounded staleness for the SGD family.

Port of ``tpu_distalg/parallel/ssp.py``: :class:`SyncSpec` with
``parse`` and ``spec`` (``:62-121``), :func:`window_grid`,
:func:`compile_straggle_schedule`, :func:`straggle_work`,
:func:`entangle`, :func:`staleness_weights`, :func:`observed_staleness`,
:func:`emit_ssp_counters` and :func:`emit_stall_avoided`
(``:123-259``).

Shards advance up to ``s`` ticks ahead of the slowest, the cross-shard
merge runs once per ``s``-tick window, and a clock vector gates only the
shards past the bound. The straggle and membership schedules are
compiled on the host from the seeded fault plan (``shard:straggle`` /
``shard:leave`` rules, :mod:`tpu_distalg_torch.faults.registry`), one
probe per (tick, shard) cell in row-major order, so they equal the JAX
package's and a run replayed under the same plan is bitwise equal.

On one card the emulated shards run one after another on one stream, so
the straggle delays of different shards do not overlap as they do on
the JAX package's host mesh (one thread per device): both the BSP and
the SSP arm pay every delay, and SSP saves only its merges.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.faults import registry as fregistry

#: default staleness bound (ticks a shard may run ahead of the slowest)
DEFAULT_STALENESS = 4
#: default per-age decay of a late contribution's merge weight
DEFAULT_DECAY = 0.5
#: one straggle unit = one pass of the interference loop over a
#: (STRAGGLE_LANES,) float32 vector
STRAGGLE_LANES = 4096

SYNC_MODES = ("bsp", "ssp")


@dataclasses.dataclass(frozen=True)
class SyncSpec:
    """One run's synchronization discipline: ``bsp`` (lock-step, the
    default), ``ssp`` (the default bound), ``ssp:8`` (bound 8 ticks),
    ``ssp:8:0.7`` (bound 8, staleness-weight decay 0.7)."""

    mode: str = "bsp"
    staleness: int = DEFAULT_STALENESS
    decay: float = DEFAULT_DECAY

    def __post_init__(self):
        if self.mode not in SYNC_MODES:
            raise ValueError(
                f"unknown sync mode {self.mode!r}; want one of "
                f"{', '.join(SYNC_MODES)} (spellings: 'bsp', 'ssp', "
                f"'ssp:s', 'ssp:s:decay')")
        if self.staleness < 1:
            raise ValueError(
                f"ssp staleness bound must be >= 1, got {self.staleness}")
        if not (0.0 < self.decay <= 1.0):
            raise ValueError(
                f"ssp decay must be in (0, 1], got {self.decay}")

    @classmethod
    def parse(cls, text: str | "SyncSpec" | None) -> "SyncSpec":
        if isinstance(text, cls):
            return text
        if not text:
            return cls()
        parts = str(text).split(":")
        kw = {}
        if parts[0] != "ssp" and len(parts) > 1:
            raise ValueError(
                f"bad --sync spelling {text!r}: only 'ssp' takes "
                f"arguments ('ssp:s', 'ssp:s:decay')")
        if len(parts) >= 2 and parts[1]:
            kw["staleness"] = int(parts[1])
        if len(parts) >= 3 and parts[2]:
            kw["decay"] = float(parts[2])
        if len(parts) > 3:
            raise ValueError(
                f"bad --sync spelling {text!r}: want 'bsp', 'ssp', "
                f"'ssp:s' or 'ssp:s:decay'")
        return cls(mode=parts[0], **kw)

    @property
    def is_ssp(self) -> bool:
        return self.mode == "ssp"

    def spec(self) -> str:
        if self.mode == "bsp":
            return "bsp"
        return f"ssp:{self.staleness}:{self.decay:g}"


def window_grid(n_ticks: int, staleness: int) -> tuple[int, int]:
    """(n_windows, padded_ticks): ticks grouped into full
    ``staleness``-length windows; the trailing pad ticks are masked."""
    n_win = max(1, -(-n_ticks // staleness))
    return n_win, n_win * staleness


def compile_straggle_schedule(n_ticks: int, n_shards: int, *,
                              plan=None) -> np.ndarray:
    """The (n_ticks, n_shards) int32 interference schedule from the
    plan's ``shard:straggle`` rules: cell (t, k) holds the straggle
    units shard k pays at tick t. One probe per cell in row-major order
    against a fresh quiet registry built from the plan (a pure function
    of the plan); its fires are mirrored into the live registry's
    ledger. No plan compiles all zeros."""
    live = fregistry.active()
    if plan is None:
        plan = live.plan if live is not None else None
    out = np.zeros((n_ticks, n_shards), np.int32)
    if plan is None or not any(
            r.point == "shard:straggle" for r in plan.rules):
        return out
    reg = fregistry.FaultRegistry(plan, quiet=True)
    for t in range(n_ticks):
        for k in range(n_shards):
            hit = reg.probe("shard:straggle")
            if hit is not None:
                _, arg = hit
                out[t, k] = int(arg if arg is not None
                                else fregistry.DEFAULT_STRAGGLE_UNITS)
    if live is not None and live.plan == plan:
        live.record(reg.fired)
    return out


def straggle_work_reference(units: torch.Tensor, salt: float
                            ) -> torch.Tensor:
    """The plain version: for each shard s, ``units[s]`` passes of
    ``v ← v·1.0000001 + 1e-7`` over a (STRAGGLE_LANES,) float32 vector
    filled with ``salt``, then its sum → (S,) float32."""
    u = units.to(torch.int64)
    v = torch.full((u.shape[0], STRAGGLE_LANES), float(salt),
                   dtype=torch.float32, device=u.device)
    a = torch.tensor(1.0000001, dtype=torch.float32, device=u.device)
    b = torch.tensor(1e-7, dtype=torch.float32, device=u.device)
    for i in range(int(u.max()) if u.numel() else 0):
        v = torch.where((i < u)[:, None], v * a + b, v)
    return v.sum(dim=1)


def straggle_work(units: torch.Tensor, salt: float = 1.0) -> torch.Tensor:
    """The compiled-in straggler (JAX ``ssp.py:166``) for every shard of
    one tick: ``units`` (S,) int32, shard s paying ``units[s]`` passes of
    the interference loop. On the CPU the plain version; on a CUDA
    tensor one launch of ``csrc/ssp.cu`` (counted in
    ``straggle_work.launches``). The returned sums must never enter the
    trainer's state."""
    if units.device.type == "cpu":
        return straggle_work_reference(units, salt)
    from tpu_distalg_torch.ops import _native

    dev = _native.cuda_device(units)
    _native.check_tensor("units", units, (torch.int32,), 1)
    units = units.contiguous()
    out = torch.empty((units.shape[0],), dtype=torch.float32, device=dev)
    lib = _native.load("ssp")
    rc = lib.tda_straggle(units.data_ptr(), units.shape[0], float(salt),
                          out.data_ptr(), _native.stream(dev))
    _native.check(lib, rc, "tda_straggle")
    straggle_work.launches += 1
    return out


straggle_work.launches = 0


def entangle(state, dummy):
    """The JAX package ties ``dummy``'s computation into ``state``'s
    dependencies with an optimization barrier so XLA cannot drop the
    straggle work. Eager torch runs every op it is given, so this is the
    identity; the work has run when :func:`straggle_work` returns."""
    del dummy
    return state


def staleness_weights(ages, active, took, decay: float):
    """Merge weights for one window: ``decay**age`` for the active shards
    that have a contribution, 0 for everyone else (``ssp.py:200``)."""
    w = torch.tensor(decay, dtype=torch.float32,
                     device=ages.device) ** ages.to(torch.float32)
    return torch.where(active & took, w, torch.zeros_like(w))


def observed_staleness(ages_max, ages_mean) -> dict:
    """Host summary of the per-window age traces."""
    am = np.asarray(ages_max)
    return {
        "max_staleness": int(am.max()) if am.size else 0,
        "mean_staleness": (float(np.asarray(ages_mean).mean())
                           if am.size else 0.0),
        "merges": int(am.size),
    }


def emit_ssp_counters(spec: SyncSpec, stats: dict, *,
                      straggle_ticks: int = 0, gated_ticks: int = 0,
                      epochs: int = 1) -> None:
    """Bump the ``ssp.*`` counters and gauges (no-op without
    telemetry)."""
    from tpu_distalg_torch.telemetry import events as tevents

    tevents.counter("ssp.merges", stats.get("merges", 0))
    tevents.counter("ssp.straggle_ticks", straggle_ticks)
    tevents.counter("ssp.gated_ticks", gated_ticks)
    tevents.counter("ssp.membership_epochs", epochs)
    tevents.gauge("ssp.max_staleness", stats.get("max_staleness", 0))
    tevents.gauge("ssp.mean_staleness",
                  round(stats.get("mean_staleness", 0.0), 4))
    tevents.gauge("ssp.bound", spec.staleness)


def emit_stall_avoided(bsp_seconds: float, ssp_seconds: float,
                       n_ticks: int) -> float:
    """Record the measured stall time SSP avoided against BSP over the
    same tick schedule; returns the ms fed to ``ssp.stall_ms_avoided``."""
    from tpu_distalg_torch.telemetry import events as tevents

    ms = max(0.0, (bsp_seconds - ssp_seconds) * 1e3)
    tevents.counter("ssp.stall_ms_avoided", int(round(ms)))
    tevents.counter("ssp.stall_ticks_measured", n_ticks)
    return ms
