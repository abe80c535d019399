"""Multi-process elastic runtime — coordinator/worker over TCP (port of
``tpu_distalg/cluster/``).

A coordinator owning rendezvous, the cross-process SSP clock, heartbeat
failure detection, the write-ahead ledger and durable center
checkpoints (:mod:`coordinator`, :mod:`wal`); N workers each running the
port's SGD-family trainers on their device (:mod:`worker`); and a
parameter-server tier applying staleness-weighted (``decay**age``) delta
merges in numpy (:mod:`ps`) — all over a length-prefixed framed-numpy
TCP transport (no pickle, a deadline on every blocking receive;
:mod:`transport`). Frames and WAL records are the JAX package's byte for
byte, so workers and coordinators of the two packages join each other,
and under one seeded fault plan a run gives the JAX package's merge and
membership sequences (:func:`local.event_digest`). ``--comm
{dense,int8[:seed],topk[:frac]}`` selects the wire schedule (the host
codecs of ``parallel/comms.py``).

The sharded row store (:mod:`rowstore`: ``--ps-mode rowstore``, per-row
versions, :func:`rowstore.run_cluster_pagerank` with its workers on the
device) keeps state row-partitioned. Cluster serving (:mod:`serve`,
:mod:`router`: ``--role replica|router``) puts replicas that score on
their device behind a micro-batching router with re-route, hot swap and
WAL recovery.
"""

from tpu_distalg_torch.cluster import ps, rowstore, transport, wal
from tpu_distalg_torch.cluster.rowstore import (
    ClusterPageRankConfig,
    RowStore,
    run_cluster_pagerank,
)
from tpu_distalg_torch.cluster.coordinator import (
    ClusterAborted,
    ClusterConfig,
    Coordinator,
    TrainTask,
    center_accuracy,
    compile_coordinator_schedule,
)
from tpu_distalg_torch.cluster.local import event_digest, run_local_cluster
from tpu_distalg_torch.cluster.worker import (
    compile_worker_schedule,
    run_worker,
    strip_kills,
)

__all__ = [
    "ClusterAborted",
    "ClusterConfig",
    "ClusterPageRankConfig",
    "Coordinator",
    "RowStore",
    "TrainTask",
    "center_accuracy",
    "compile_coordinator_schedule",
    "compile_worker_schedule",
    "event_digest",
    "ps",
    "rowstore",
    "run_cluster_pagerank",
    "run_local_cluster",
    "run_worker",
    "strip_kills",
    "transport",
    "wal",
]
