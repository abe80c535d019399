"""MA: model averaging (local SGD).

Port of ``tpu_distalg/models/ma.py``: a preset of the local-update
harness (:mod:`.local_sgd`) with the reference's ``ma.py`` semantics,
300 rounds of 5 local steps, the plain average as the combine and every
replica resynced to the center each round.
"""

from __future__ import annotations

import dataclasses

from tpu_distalg_torch.models import local_sgd
from tpu_distalg_torch.models.local_sgd import TrainResult
from tpu_distalg_torch.parallel import Mesh


@dataclasses.dataclass(frozen=True)
class MAConfig(local_sgd.LocalSGDConfig):
    n_iterations: int = 300
    n_local_iterations: int = 5
    global_update: str = "average"
    resync: bool = True


def train(X_train, y_train, X_test, y_test, mesh: Mesh,
          config: MAConfig = MAConfig(), *,
          checkpoint_dir: str | None = None,
          checkpoint_every: int = 100) -> TrainResult:
    return local_sgd.train(X_train, y_train, X_test, y_test, mesh, config,
                           checkpoint_dir=checkpoint_dir,
                           checkpoint_every=checkpoint_every)
