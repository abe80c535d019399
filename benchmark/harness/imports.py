"""The check that nothing of the JAX package, or JAX itself, is loaded.

Module names are compared by their top-level name (the part before the
first dot) as a whole word: the port ``tpu_distalg_torch`` begins with
the JAX package's name ``tpu_distalg`` and is allowed.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpu_distalg"})


def forbidden(names=None) -> list:
    """Sorted top-level names among ``names`` (default: ``sys.modules``)
    that are forbidden."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
