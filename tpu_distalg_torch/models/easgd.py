"""EASGD: elastic averaging SGD.

Port of ``tpu_distalg/models/easgd.py``. The replicas are not resynced
to the center; each round every replica takes one elastic step
``w_i ← w_i − η·ḡ − α·(w_i − w)`` (the reference's ``easgd.py:41-45``)
with α = η·ρ (``:24``), and the center blends ``w ← (1 − β)·w +
β·mean(w_i)`` with β = R·α (``:25,106``), R the mesh's replicas, unless
β is given.
"""

from __future__ import annotations

import dataclasses

from tpu_distalg_torch.models import local_sgd
from tpu_distalg_torch.models.local_sgd import TrainResult
from tpu_distalg_torch.parallel import Mesh

_RHO = 0.1   # easgd.py:23
_ETA = 0.1   # easgd.py:21


@dataclasses.dataclass(frozen=True)
class EASGDConfig(local_sgd.LocalSGDConfig):
    n_iterations: int = 1500
    n_local_iterations: int = 1   # one local step a round (easgd.py:95-104)
    eta: float = _ETA
    rho: float = _RHO
    elastic_alpha: float | None = None  # None → α = η·ρ (easgd.py:24)
    global_update: str = "easgd"
    resync: bool = False
    beta: float | None = None     # None → R·α when the trainer is built

    def __post_init__(self):
        if self.elastic_alpha is None:
            object.__setattr__(self, "elastic_alpha", self.eta * self.rho)


def train(X_train, y_train, X_test, y_test, mesh: Mesh,
          config: EASGDConfig = EASGDConfig(), *,
          checkpoint_dir: str | None = None,
          checkpoint_every: int = 100) -> TrainResult:
    return local_sgd.train(X_train, y_train, X_test, y_test, mesh, config,
                           checkpoint_dir=checkpoint_dir,
                           checkpoint_every=checkpoint_every)
