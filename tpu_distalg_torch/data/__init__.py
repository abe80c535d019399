"""Out-of-core sharded datasets (port of ``tpu_distalg/data/``).

  ``sharded``   :class:`ShardedDataset`: one block-addressable row
                matrix behind three placements (``resident`` on the
                device, ``virtual`` in host memory, ``streamed`` a disk
                memmap), staging the same batches from each;
  ``cache``     the versioned packed-cache disk format (the JAX
                package's bytes and header; atomic publish, stale-tmp
                sweep);
  ``pipeline``  the prefetch engine (a producer thread, pinned buffers
                and a side CUDA stream: gather ∥ H2D ∥ compute) and the
                host block sampler;
  ``builders``  the k-means points and ALS rank-k rows, the same bytes
                behind any backend.

Consumers: ``models/ssgd_stream``, ``models/kmeans.fit_minibatch``,
``models/als.fit_streamed`` and the CLI's ``--data-backend``. The
directory also ships the breast-cancer data (``breast_cancer.csv``).
"""

from tpu_distalg_torch.data.sharded import (
    BACKENDS,
    ShardedDataset,
    block_geometry,
)
from tpu_distalg_torch.data.pipeline import (
    Prefetcher,
    ProducerDiedError,
    make_host_block_sampler,
    stream_staged,
)
from tpu_distalg_torch.data import builders, cache

__all__ = [
    "BACKENDS",
    "Prefetcher",
    "ProducerDiedError",
    "ShardedDataset",
    "block_geometry",
    "builders",
    "cache",
    "make_host_block_sampler",
    "stream_staged",
]
