"""The one table of hand-pinned geometry (port of
``tpu_distalg/tune/defaults.py``, value for value).

``models/`` and ``cluster/`` take their geometry defaults from here; this
table is what ``--tune off`` runs. The resolver (``tune/resolve.py``)
overrides them per rig from a measured profile under ``--tune auto`` or
``--tune PROFILE``.

stdlib only: the cluster's coordinator and transport import it before
any device work.
"""

from __future__ import annotations

#: flat-vector bucket size for the bucketed/int8 ring schedules
#: (``CommSpec.bucket_elems``) — 64k f32 elems = 256 KB buckets
BUCKET_ELEMS = 1 << 16

#: top-k sparsification fraction (``CommSpec.topk_fraction``)
TOPK_FRACTION = 0.01

#: parameter-server tier width (``ClusterConfig.ps_shards`` and the
#: ``ParameterServer``/``RowStore`` constructors)
PS_SHARDS = 2

#: worker slot count of the local cluster (``ClusterConfig.n_slots``)
CLUSTER_SLOTS = 3

#: every Nth commit ships a dense version-pinned pull instead of a
#: delta (coordinator pull-noise bound — see
#: ``cluster/coordinator.py``)
PULL_REFRESH_WINDOWS = 16

#: rows per gathered out-of-core block, per workload family (the
#: transfer granularity of ``--block-rows``)
BLOCK_ROWS = {
    "data": 4096,      # generic ShardedDataset blocks
    "kmeans": 2048,    # point blocks (kmeans CLI default)
    "als": 256,        # rating-row blocks (als CLI default)
}

#: edges per streamed graph block (``--block-edges``)
BLOCK_EDGES = 1 << 16

#: rows per sampled gather block of the fused SGD samplers
#: (``--gather-block-rows``)
GATHER_BLOCK_ROWS = 1024

#: the data-axis size the README's canonical reduction claims are
#: pinned to (bench.py COMM_CANONICAL_SHARDS)
CANONICAL_DATA_SHARDS = 4

#: per-collective dispatch overhead assumed for device schedules when
#: the profile carries no measured collective RTT (seconds)
DEVICE_DISPATCH_SECONDS = 20e-6

#: the knob-name -> allowed-default-values table TDA120 lints against:
#: an int literal assigned to one of these names in ``models/`` or
#: ``cluster/`` must be one of ITS allowed values (i.e. this table's
#: spelling) or carry a reasoned TDA120 suppression pin
GEOMETRY_KNOBS: dict[str, tuple[int, ...]] = {
    "bucket_elems": (BUCKET_ELEMS,),
    "ps_shards": (PS_SHARDS,),
    # the PS/RowStore/HostModel constructors' parameter spelling; a
    # mesh-derived n_shards is never a literal, so only true pins land
    # here — 1 is the unsharded identity, 4 the canonical data axis
    "n_shards": (1, PS_SHARDS, CANONICAL_DATA_SHARDS),
    "n_slots": (CLUSTER_SLOTS,),
    "pull_refresh_windows": (PULL_REFRESH_WINDOWS,),
    "block_rows": tuple(sorted(set(BLOCK_ROWS.values()))),
    "block_edges": (BLOCK_EDGES,),
    "gather_block_rows": (GATHER_BLOCK_ROWS,),
}

#: the default choice per resolver knob — what ``--tune off`` runs,
#: and the baseline the resolver's WHY strings compare against
DEFAULT_GEOMETRY: dict[str, object] = {
    "comm": "dense",
    "bucket_elems": BUCKET_ELEMS,
    "topk_fraction": TOPK_FRACTION,
    "mesh_shape": None,            # all devices, pure data parallel
    "ps_shards": PS_SHARDS,
    "ps_mode": "replicated",
    "block_rows": BLOCK_ROWS["data"],
    "block_edges": BLOCK_EDGES,
    "pull_refresh_windows": PULL_REFRESH_WINDOWS,
}
