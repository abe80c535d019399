"""Geometry defaults (port of ``tpu_distalg/tune/``): :mod:`defaults`,
the one table of hand-pinned geometry. The rig profile, the resolver
and ``tda tune`` / ``--tune`` wait for ROADMAP A12.4."""

from tpu_distalg_torch.tune import defaults

__all__ = ["defaults"]
