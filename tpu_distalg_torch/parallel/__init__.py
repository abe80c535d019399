"""The emulated data and model axes: mesh, row and feature sharding,
shard-order sums, the sequence-parallel rings (ring and Ulysses
attention), and in submodules the rule-table placement
(``partition``), the sync schedules (``comms``), bounded staleness
(``ssp``) and elastic membership (``membership``)."""

from tpu_distalg_torch.parallel.collectives import (
    model_sum,
    tree_allreduce_sum,
)
from tpu_distalg_torch.parallel.mesh import Mesh, get_mesh
from tpu_distalg_torch.parallel.ring import (
    alltoall_head_to_seq,
    alltoall_seq_to_head,
    ring_allgather_matmul,
    ring_attention,
    softmax_attention,
    ulysses_attention,
    zigzag_inverse,
    zigzag_order,
)
from tpu_distalg_torch.parallel.sharding import (
    ShardedMatrix,
    build_sharded,
    pad_features,
    pad_rows,
    parallelize,
    shard_features,
)
