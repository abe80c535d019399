"""The emulated data axis: mesh, row sharding, allreduce."""

from tpu_distalg_torch.parallel.collectives import tree_allreduce_sum
from tpu_distalg_torch.parallel.mesh import Mesh, get_mesh
from tpu_distalg_torch.parallel.sharding import (
    ShardedMatrix,
    build_sharded,
    pad_rows,
    parallelize,
)
