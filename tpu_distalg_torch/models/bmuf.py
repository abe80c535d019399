"""BMUF: blockwise model update filtering.

Port of ``tpu_distalg/models/bmuf.py``: MA plus a block momentum on the
averaged update, ``δ ← μ·δ + ζ·(w_avg − w); w ← w + δ`` (the
reference's ``bmuf.py:113-114``, μ 0.9 and ζ 0.1 at ``:24-25``). δ
starts random, as in the reference (``bmuf.py:95``), unless
``random_delta_init=False``.
"""

from __future__ import annotations

import dataclasses

from tpu_distalg_torch.models import local_sgd
from tpu_distalg_torch.models.local_sgd import TrainResult
from tpu_distalg_torch.parallel import Mesh


@dataclasses.dataclass(frozen=True)
class BMUFConfig(local_sgd.LocalSGDConfig):
    n_iterations: int = 300
    n_local_iterations: int = 5
    global_update: str = "bmuf"
    resync: bool = True
    mu: float = 0.9
    zeta: float = 0.1


def train(X_train, y_train, X_test, y_test, mesh: Mesh,
          config: BMUFConfig = BMUFConfig(), *,
          checkpoint_dir: str | None = None,
          checkpoint_every: int = 100) -> TrainResult:
    return local_sgd.train(X_train, y_train, X_test, y_test, mesh, config,
                           checkpoint_dir=checkpoint_dir,
                           checkpoint_every=checkpoint_every)
