"""The data and model axes, emulated in one process or spread over a
``torch.distributed`` group: mesh and process group, row and feature
sharding, shard-order sums, per-shard execution (``spmd``), the
sequence-parallel rings (ring and Ulysses attention), and in submodules
the rule-table placement (``partition``), the sync schedules
(``comms``), bounded staleness (``ssp``) and elastic membership
(``membership``)."""

from tpu_distalg_torch.parallel.collectives import (
    gather_shards,
    model_sum,
    tree_allreduce_sum,
)
from tpu_distalg_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    emulate_devices,
    get_mesh,
    local_device_count,
    multihost_initialize,
)
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
from tpu_distalg_torch.parallel.spmd import data_parallel, replica_index
