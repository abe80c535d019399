"""Seeded fault plans: the part of the JAX package's ``faults/`` that
compiles a plan into SSP straggle and membership schedules and fires
at the data subsystem's seams (:mod:`registry`). The chaos harness,
preemption and the injection seams at checkpoint and segment
boundaries wait for ROADMAP A12."""

from tpu_distalg_torch.faults import registry
from tpu_distalg_torch.faults.registry import (
    ENV_PLAN,
    KINDS,
    POINTS,
    PORTED_POINTS,
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
    "ENV_PLAN", "KINDS", "POINTS", "PORTED_POINTS", "FaultPlan",
    "FaultRegistry", "FaultRule", "InjectedCorruptionError", "InjectedKill",
    "InjectedOSError", "active", "configure", "enabled", "inject", "probe",
    "registry",
]
