"""The emulated data and model axes: mesh, row and feature sharding,
shard-order sums."""

from tpu_distalg_torch.parallel.collectives import (
    model_sum,
    tree_allreduce_sum,
)
from tpu_distalg_torch.parallel.mesh import Mesh, get_mesh
from tpu_distalg_torch.parallel.sharding import (
    ShardedMatrix,
    build_sharded,
    pad_features,
    pad_rows,
    parallelize,
    shard_features,
)
