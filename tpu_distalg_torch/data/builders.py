"""Dataset builders: the same bytes, whichever backend holds them.

Port of ``tpu_distalg/data/builders.py``. Each builder makes one
workload's dataset from ``(seed, geometry)`` in numpy alone, in chunks
whose size depends on the row width only and whose generators are keyed
on the chunk index, so its bytes equal the JAX package's bit for bit,
whatever the backend: ``resident`` and ``virtual`` hold the array (on
the device, in host memory), ``streamed`` writes or reopens a packed
cache (``cache.py``) and memmaps it.

Layouts:

  ``points_valid_f32``  k-means points ``[x_0..x_{dim-1}, valid]``;
                        padding rows carry valid 0;
  ``dense_rows_f32``    ALS rating rows, raw ``(m, n)`` R; padding rows
                        are zero, which solves to zero factor rows that
                        touch neither the Grams nor the rmse.
"""

from __future__ import annotations

import numpy as np

from tpu_distalg_torch.data import cache as dcache
from tpu_distalg_torch.data.sharded import ShardedDataset
from tpu_distalg_torch.telemetry import events as tevents

POINTS_LAYOUT = "points_valid_f32"
DENSE_ROWS_LAYOUT = "dense_rows_f32"
#: a generation chunk's bytes: a function of the row width alone, so the
#: chunking never changes the bytes (each chunk's generator is keyed on
#: its index)
_GEN_CHUNK_BYTES = 64 << 20


def _gen_chunk_rows(row_bytes: int) -> int:
    return max(1, _GEN_CHUNK_BYTES // int(row_bytes))


def _padded_rows(n_rows: int, n_shards: int, block_rows: int) -> int:
    mult = n_shards * block_rows
    return -(-n_rows // mult) * mult


def _place(mesh, *, n2: int, pd: int, block_rows: int, meta: dict,
           backend: str, path: str | None, header: dict, write_bin):
    """Build or reopen the cache (``streamed``), or fill an array and
    wrap it (``resident``, ``virtual``)."""
    if backend == "streamed":
        if path is None:
            raise ValueError("backend='streamed' needs a cache path")
        mm, _ = dcache.open_or_build(path, header=header,
                                     write_bin=write_bin)
        return ShardedDataset(mm, mesh, block_rows=block_rows, meta=meta,
                              backend="streamed")
    out = np.zeros((n2, pd), np.float32)
    write_bin(out)
    return ShardedDataset.from_array(out, mesh, block_rows=block_rows,
                                     meta=meta, backend=backend)


def gaussian_points_dataset(mesh, n_rows: int, *, dim: int = 16,
                            k: int = 8, seed: int = 0,
                            spread: float = 8.0,
                            block_rows: int = 2048,
                            backend: str = "resident",
                            path: str | None = None):
    """A Gaussian-mixture point set in the ``points_valid_f32`` layout
    (the k-means benchmark family). Returns ``(dataset, true_centers)``,
    the mixture means for recovery checks."""
    n_shards = mesh.n_data
    n2 = _padded_rows(n_rows, n_shards, block_rows)
    pd = dim + 1  # + the validity column
    centers = (np.random.default_rng(seed).normal(size=(k, dim))
               * spread).astype(np.float32)
    chunk_rows = _gen_chunk_rows(pd * 4)

    def write_chunks(out: np.ndarray):
        for ci, lo in enumerate(range(0, n2, chunk_rows)):
            tevents.mark(f"data:points_gen@{lo}/{n2}", emit_event=False)
            hi = min(lo + chunk_rows, n2)
            g = np.random.default_rng((seed, 1, ci))
            assign = g.integers(0, k, size=hi - lo)
            out[lo:hi, :dim] = centers[assign] + g.normal(
                size=(hi - lo, dim)).astype(np.float32)
            out[lo:hi, dim] = (np.arange(lo, hi) < n_rows).astype(
                np.float32)

    geom = dict(n_rows=n_rows, dim=dim, k=k, seed=seed, spread=spread,
                block_rows=block_rows, n_shards=n_shards)
    header = dcache.make_header(layout=POINTS_LAYOUT, dtype=np.float32,
                                shape=(n2, pd), geom=geom)
    ds = _place(mesh, n2=n2, pd=pd, block_rows=block_rows,
                meta=dict(geom, layout=POINTS_LAYOUT), backend=backend,
                path=path, header=header, write_bin=write_chunks)
    return ds, centers


def rank_k_rows_dataset(mesh, m: int, n: int, k: int, *, seed: int = 0,
                        noise_sigma: float = 0.0,
                        block_rows: int = 256,
                        backend: str = "resident",
                        path: str | None = None):
    """An (exactly or noisily) rank-k rating matrix R = U₀·V₀ᵀ in the
    ``dense_rows_f32`` layout (``models/als.synthesize_rank_k``'s
    distribution, made a row chunk at a time). Returns
    ``(dataset, (U0, V0))``."""
    n_shards = mesh.n_data
    m2 = _padded_rows(m, n_shards, block_rows)
    rng = np.random.default_rng(seed)
    U0 = rng.random((m, k), dtype=np.float32)
    V0 = rng.random((n, k), dtype=np.float32)
    chunk_rows = _gen_chunk_rows(n * 4)

    def write_chunks(out: np.ndarray):
        for ci, lo in enumerate(range(0, m2, chunk_rows)):
            tevents.mark(f"data:rankk_gen@{lo}/{m2}", emit_event=False)
            hi = min(lo + chunk_rows, m2)
            top = min(hi, m)
            if top > lo:
                block = U0[lo:top] @ V0.T
                if noise_sigma:
                    g = np.random.default_rng((seed, 2, ci))
                    block = block + noise_sigma * g.standard_normal(
                        block.shape).astype(np.float32)
                out[lo:top] = block
            if hi > m:  # zero padding rows, inert for ALS
                out[max(lo, m):hi] = 0.0

    geom = dict(m=m, n=n, k=k, seed=seed, noise_sigma=noise_sigma,
                block_rows=block_rows, n_shards=n_shards)
    header = dcache.make_header(layout=DENSE_ROWS_LAYOUT, dtype=np.float32,
                                shape=(m2, n), geom=geom)
    ds = _place(mesh, n2=m2, pd=n, block_rows=block_rows,
                meta=dict(geom, layout=DENSE_ROWS_LAYOUT), backend=backend,
                path=path, header=header, write_bin=write_chunks)
    return ds, (U0, V0)
