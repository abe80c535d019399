"""Deterministic fault injection and preemption (port of the JAX
package's ``faults/``): a seeded, replayable plan that fires at every
I/O and supervision seam and compiles into the SSP straggle and
membership schedules (:mod:`registry`), a SIGTERM/SIGINT handler that
stops at the next checkpointed boundary with rc 75 (:mod:`preempt`),
and the chaos harness that runs small workloads under a plan and holds
the recovered result bit for bit against an undisturbed run
(:mod:`chaos`, ``tda chaos``; imported on use, as it pulls in the
models)."""

from tpu_distalg_torch.faults import preempt, registry
from tpu_distalg_torch.faults.preempt import PREEMPTED_RC, Preempted
from tpu_distalg_torch.faults.registry import (
    ENV_PLAN,
    KINDS,
    POINTS,
    FaultPlan,
    FaultRegistry,
    FaultRule,
    InjectedCorruptionError,
    InjectedKill,
    InjectedOSError,
    active,
    configure,
    enabled,
    inject,
    probe,
)

__all__ = [
    "ENV_PLAN", "KINDS", "POINTS", "PREEMPTED_RC",
    "Preempted", "FaultPlan",
    "FaultRegistry", "FaultRule", "InjectedCorruptionError", "InjectedKill",
    "InjectedOSError", "active", "configure", "enabled", "inject", "preempt",
    "probe", "registry",
]
