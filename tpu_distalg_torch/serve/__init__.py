"""Online serving (port of ``tpu_distalg/serve/``): bounded queue →
deadline-or-size dispatch → pad to ``max_batch`` → one batched predict
(ALS: through the fused top-k kernel) → one device→host copy → scatter
replies."""

from tpu_distalg_torch.serve.artifacts import (
    ServedModel,
    als_model,
    kmeans_model,
    load_artifact,
    lr_model,
)
from tpu_distalg_torch.serve.batcher import (
    MicroBatcher,
    Reply,
    ServeClosedError,
    ServeOverloadError,
)
from tpu_distalg_torch.serve.server import ServeConfig, Server, run_closed_loop

__all__ = [
    "MicroBatcher",
    "Reply",
    "ServeClosedError",
    "ServeConfig",
    "ServeOverloadError",
    "ServedModel",
    "Server",
    "als_model",
    "kmeans_model",
    "load_artifact",
    "lr_model",
    "run_closed_loop",
]
