"""The out-of-core graph engine: streamed CSR PageRank (port of
``tpu_distalg/graphs/``).

  ``ingest``  edge lists → destination-sorted CSR edge-block caches in
              the packed-cache format (``data/cache.py``), byte for byte
              the JAX package's, through the C++ ingest's binding
              (``native/``); a chunked generator writes synthetic
              power-law graphs dst-sorted by construction, so a
              billion-edge cache never holds its edge list;
  ``engine``  streamed sweeps: blocks flow disk gather ∥ H2D ∥ sweep
              through the ``data/`` prefetch pipeline, each staged batch
              is summed by kernel B7 into its shard's O(window)
              destination slice, and the windows combine sparsely
              (``comms.sparse_allreduce`` of each shard's distinct
              destinations) or densely. Only O(V) state lives on the
              device.

Consumers: ``cli.py pagerank --data-backend streamed|virtual`` and
``chip_smoke.py``'s graph phase.
"""

from tpu_distalg_torch.graphs.engine import (
    GraphDataset,
    StreamedPageRankConfig,
    StreamedPageRankResult,
    open_graph_dataset,
    resolve_combine,
    run_streamed_pagerank,
)
from tpu_distalg_torch.graphs.ingest import (
    BLOCK_FORMAT_VERSION,
    DEFAULT_BLOCK_EDGES,
    LAYOUT,
    build_edge_block_cache,
    build_powerlaw_block_cache,
    powerlaw_in_degree_counts,
)

__all__ = [
    "BLOCK_FORMAT_VERSION",
    "DEFAULT_BLOCK_EDGES",
    "GraphDataset",
    "LAYOUT",
    "StreamedPageRankConfig",
    "StreamedPageRankResult",
    "build_edge_block_cache",
    "build_powerlaw_block_cache",
    "open_graph_dataset",
    "powerlaw_in_degree_counts",
    "resolve_combine",
    "run_streamed_pagerank",
]
