"""The autotuner (port of ``tpu_distalg/tune/``): measured rig profiles
and the cost-model geometry resolver.

* :mod:`tune.defaults` — the one table of hand-pinned geometry (what
  ``--tune off`` runs),
* :mod:`tune.profile` — the seeded ``tda tune`` profiling pass and the
  versioned, rig-tagged ``RigProfile`` JSON artifact (the JAX package's
  bytes),
* :mod:`tune.resolve` — the cost model joining profiles against the
  closed-form comm accounting, and the per-knob resolver (explicit flag
  > resolved > default, every choice with a WHY).
"""

from tpu_distalg_torch.tune import defaults
from tpu_distalg_torch.tune.profile import (
    SCHEMA_VERSION,
    ProfileError,
    build_profile,
    load_profile,
    measure_collective,
    measure_rig,
    newest_profile,
    profile_crc,
    save_profile,
)
from tpu_distalg_torch.tune.resolve import (
    KNOBS,
    Choice,
    Resolution,
    Workload,
    emit_resolution,
    resolve,
    schedule_seconds,
)

__all__ = [
    "Choice", "KNOBS", "ProfileError", "Resolution", "SCHEMA_VERSION",
    "Workload", "build_profile", "defaults", "emit_resolution",
    "load_profile", "measure_collective", "measure_rig",
    "newest_profile", "profile_crc", "resolve", "save_profile",
    "schedule_seconds",
]
