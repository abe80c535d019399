"""PyTorch/CUDA port of ``tpu_distalg``.

A second package beside the JAX one: the same workloads, written in
PyTorch, with every Pallas kernel of the JAX package rewritten by hand
for Hopper (CUDA C++ under ``csrc/``). It imports ``torch`` and never
``jax`` or anything of ``tpu_distalg``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`tpu_distalg_torch.utils.device.resolve_device`); asking for
``cuda`` without a card raises.

Ported so far: ALS training (``models/als.py``), its artifact
(``utils/checkpoint.py``) and micro-batched top-k serving
(``serve/``) through the fused matmul+top-k kernel (``ops/topk.py``,
``csrc/topk.cu``); SSGD logistic regression (``models/ssgd.py``) on
the port's threefry (``utils/prng.py``), the emulated data axis
(``parallel/``) and four gradient kernels (``ops/ssgd_kernels.py``,
``csrc/ssgd.cu``); resident PageRank (``models/pagerank.py``) over a
dst-sorted CSR (``ops/graph.py``) with two sweep kernels
(``ops/pagerank_kernels.py``, ``csrc/pagerank.cu``); k-means
(``models/kmeans.py``) through torch ops (``ops/kmeans.py``) or the
one-pass cluster-statistics kernel (``ops/kmeans_kernels.py``,
``csrc/kmeans.cu``), its artifacts and SSGD's served beside ALS's; the
SGD family's sync schedules and stale-synchronous training
(``parallel/comms.py``, ``parallel/ssp.py``, ``parallel/membership.py``,
``faults/registry.py``); the out-of-core data subsystem (``data/``:
packed caches, ``ShardedDataset``'s three backends, the pinned prefetch
pipeline) with streamed and virtual SSGD (``models/ssgd_stream.py``,
``models/ssgd_virtual.py``), minibatch k-means and streamed ALS.
"""
