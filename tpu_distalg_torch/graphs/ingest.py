"""Edge lists into destination-sorted CSR edge-block caches.

Port of ``tpu_distalg/graphs/ingest.py``, numpy on the host as there;
the caches equal the JAX package's byte for byte (``.bin``,
``.meta.json`` and the three aux payloads), so either package's engine
opens the other's. Edges land in the packed-cache format
(:mod:`..data.cache`) as ``(n_rows, 3)`` int32 rows ``[src, dst,
bits(w)]`` in the ``csr_edge_blocks_i32`` layout: globally sorted by
destination, padded at the tail with inert edges (zero weight, the last
real dst) to whole blocks on every shard, and sharded contiguously, so
shard s owns rows ``[s·L, (s+1)·L)``. Any contiguous row range is a
dst-sorted block, and each shard covers one contiguous destination
window ``[lo_s, lo_s + window)``: its partial ranks live in an
O(window) accumulator, and the combine touches only the destinations
it has edges into.

The header's ``geom`` holds the sweep geometry (vertex and edge counts,
block size, shard windows, the sparse combine's width ``k``); three aux
payloads hold the out-degrees and each shard's distinct-destination
offsets with their validity mask.

Two builders: :func:`build_edge_block_cache` for an edge array in host
memory (dedupe, degrees, the dst counting sort and the row packing
through :mod:`..native`), and :func:`build_powerlaw_block_cache`, which
writes a synthetic power-law graph already dst-sorted, a chunk of edges
at a time, so a billion-edge cache never holds its edge list.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from tpu_distalg_torch import native
from tpu_distalg_torch.data import cache as dcache
from tpu_distalg_torch.ops.graph import inv_out_degree, prepare_edges
from tpu_distalg_torch.telemetry import events as tevents

LAYOUT = "csr_edge_blocks_i32"
#: bumped when the row packing or the geometry contract changes; carried
#: in geom, so an old cache fails loudly
BLOCK_FORMAT_VERSION = 1
ROW_WIDTH = 3  # [src, dst, bits(w)] int32
DEFAULT_BLOCK_EDGES = 1 << 16
#: aux payload names (``<path>.<name>`` files beside the .bin)
AUX_DEG = "deg"      # (V,) int32 out-degrees
AUX_DIDX = "didx"    # (n_shards, k) int32 LOCAL window offsets
AUX_DMASK = "dmask"  # (n_shards, k) f32 validity (0 = padding pair)
#: edge rows a chunk of the power-law builder draws at once; the bytes
#: are a function of (seed, chunk index), so the chunk size is part of
#: the geometry
POWERLAW_CHUNK_EDGES = 1 << 24


def _geom_arrays(counts_real: np.ndarray, n_vertices: int,
                 n_shards: int, block_edges: int):
    """The sweep geometry from the per-destination edge counts alone
    (both builders share it): ``(geom, ids, mask, n_rows, pad_dst)`` —
    the JSON geometry, each shard's distinct-destination LOCAL offsets
    ``(S, k)`` and their validity mask, the padded row count, and the
    destination the padding rows repeat."""
    V = int(n_vertices)
    counts_real = np.asarray(counts_real, np.int64)
    E = int(counts_real.sum())
    if E == 0:
        raise ValueError("cannot build an edge-block cache from an "
                         "empty edge list")
    if V > np.iinfo(np.int32).max:
        raise ValueError(
            f"{V} vertices exceed the int32 id width of the "
            f"{LAYOUT} layout")
    gran = n_shards * block_edges
    n_rows = -(-E // gran) * gran
    n_pad = n_rows - E
    # padding repeats the LAST REAL dst, so the last shard's window stays
    # tight (dst = V-1 would stretch it over the tail of absent vertices)
    pad_dst = int(np.flatnonzero(counts_real)[-1])
    counts_pad = counts_real.copy()
    counts_pad[pad_dst] += n_pad
    cum = np.zeros(V + 1, np.int64)
    np.cumsum(counts_pad, out=cum[1:])
    L = n_rows // n_shards
    starts = np.arange(n_shards, dtype=np.int64) * L
    lo = (np.searchsorted(cum, starts, side="right") - 1).astype(np.int64)
    hi = (np.searchsorted(cum, starts + L - 1, side="right") - 1
          ).astype(np.int64)
    window = int((hi - lo + 1).max())
    window = -(-window // 8) * 8  # the JAX package's sublane alignment
    # each shard's distinct REAL destinations as LOCAL offsets; a dst
    # whose rows straddle a shard boundary is in both shards
    locals_, k = [], 1
    for s in range(n_shards):
        d = np.flatnonzero(counts_real[lo[s]:hi[s] + 1]).astype(np.int32)
        locals_.append(d)
        k = max(k, len(d))
    ids = np.zeros((n_shards, k), np.int32)
    mask = np.zeros((n_shards, k), np.float32)
    for s, d in enumerate(locals_):
        ids[s, :len(d)] = d
        mask[s, :len(d)] = 1.0
    geom = {
        "bv": BLOCK_FORMAT_VERSION,
        "n_vertices": V,
        "n_edges": E,
        "block_edges": int(block_edges),
        "n_shards": int(n_shards),
        "window": window,
        "k_sparse": int(k),
        "lo": [int(x) for x in lo],
    }
    return geom, ids, mask, int(n_rows), pad_dst


def _aux_writers(deg: np.ndarray, ids: np.ndarray, mask: np.ndarray):
    deg_i32 = np.ascontiguousarray(deg, np.int32)
    return [
        (AUX_DEG, lambda tmp: deg_i32.tofile(tmp)),
        (AUX_DIDX, lambda tmp: np.ascontiguousarray(ids).tofile(tmp)),
        (AUX_DMASK, lambda tmp: np.ascontiguousarray(mask).tofile(tmp)),
    ]


def build_edge_block_cache(edges: np.ndarray, path: str, *,
                           n_shards: int,
                           block_edges: int = DEFAULT_BLOCK_EDGES,
                           n_vertices: int | None = None,
                           source: dict | None = None):
    """Ingest an in-memory ``(E, 2)`` edge array into a complete (or
    reopened) edge-block cache at ``path``; returns ``(memmap,
    header)``. Dedupe, out-degrees, the dst counting sort, the per-edge
    ``1/out_degree[src]`` and the row packing run once, here, through
    :mod:`..native`.

    ``source`` tags the geometry with the edges' provenance; without it
    a sha1 of the edge bytes stands in. A reopen checks the source and
    the build parameters without re-running the pipeline, so other
    edges at the same path raise instead of sweeping the wrong graph."""
    if source is None:
        source = {"kind": "edges",
                  "sha1": hashlib.sha1(
                      np.ascontiguousarray(edges, np.int64).tobytes()
                  ).hexdigest()}
    if dcache.exists(path):
        mm, header = dcache.open_cache(path, layout=LAYOUT)
        geom = header["geom"]
        n_v = (int(n_vertices) if n_vertices is not None
               else int(np.asarray(edges).max()) + 1)
        expect = {"bv": BLOCK_FORMAT_VERSION, "n_vertices": n_v,
                  "n_shards": int(n_shards),
                  "block_edges": int(block_edges),
                  "source": dict(source)}
        got = {k: geom.get(k) for k in expect}
        if got != expect:
            raise ValueError(
                f"edge-block cache at {path!r} was built with "
                f"{got}, this call wants {expect}; delete the cache "
                f"or use another path")
        return mm, header
    el = prepare_edges(edges, n_vertices)
    counts = np.bincount(el.dst, minlength=el.n_vertices)
    geom, ids, mask, n_rows, pad_dst = _geom_arrays(
        counts, el.n_vertices, n_shards, block_edges)
    geom["source"] = dict(source)
    header = dcache.make_header(layout=LAYOUT, dtype="int32",
                                shape=[n_rows, ROW_WIDTH], geom=geom)

    order = native.counting_sort_perm(el.dst, el.n_vertices)
    src_o = el.src[order].astype(np.int64)
    dst_o = el.dst[order].astype(np.int64)
    w = inv_out_degree(el.out_degree)[src_o]
    packed = native.pack_edge_rows(src_o, dst_o, w)
    E = el.n_edges

    def write_bin(mm):
        mm[:E] = packed
        mm[E:, 0] = 0
        mm[E:, 1] = pad_dst
        mm[E:, 2] = 0  # bits(0.0f): an inert weight

    tevents.counter("graph.ingest_edges", E)
    return dcache.build_cache(path, header=header, write_bin=write_bin,
                              aux=_aux_writers(el.out_degree, ids, mask))


def powerlaw_in_degree_counts(n_vertices: int, avg_in_degree: float,
                              alpha: float) -> np.ndarray:
    """The power-law in-degree profile the synthetic builder writes:
    ``in_deg(d) = rint(A·(d+1)^-alpha)``, ``A`` set so the edge count
    lands near ``n_vertices·avg_in_degree``. Low ids are the hubs; the
    tail has in-degree zero."""
    d = np.arange(n_vertices, dtype=np.float64)
    base = (d + 1.0) ** (-float(alpha))
    A = n_vertices * float(avg_in_degree) / float(base.sum())
    counts = np.rint(A * base).astype(np.int64)
    counts[0] = max(int(counts[0]), 1)
    return counts


def build_powerlaw_block_cache(path: str, *, n_vertices: int,
                               n_shards: int,
                               avg_in_degree: float = 8.0,
                               alpha: float = 1.6, seed: int = 0,
                               block_edges: int = DEFAULT_BLOCK_EDGES,
                               chunk_edges: int = POWERLAW_CHUNK_EDGES):
    """Write a synthetic power-law graph straight into a dst-sorted block
    cache in O(V + chunk) host memory; returns ``(memmap, header)``.

    Destinations come in ascending order from
    :func:`powerlaw_in_degree_counts`, so no sort is needed. Chunks are
    ranges of EDGE rows (a hub's edges span as many chunks as they
    need); sources are uniform draws keyed ``rng((seed, chunk))``, so
    the degree pass and the write see the same edges. Self-loops and
    duplicates stay (a multigraph; ``geom['source']`` says so)."""
    V = int(n_vertices)
    counts = powerlaw_in_degree_counts(V, avg_in_degree, alpha)
    geom, ids, mask, n_rows, pad_dst = _geom_arrays(
        counts, V, n_shards, block_edges)
    geom["source"] = {"kind": "powerlaw", "n_vertices": V,
                      "avg_in_degree": float(avg_in_degree),
                      "alpha": float(alpha), "seed": int(seed),
                      "chunk_edges": int(chunk_edges),
                      "deduped": False}
    header = dcache.make_header(layout=LAYOUT, dtype="int32",
                                shape=[n_rows, ROW_WIDTH], geom=geom)
    if dcache.exists(path):
        return dcache.open_cache(path, layout=LAYOUT, expect_geom=geom)

    E = int(counts.sum())
    cum = np.zeros(V + 1, np.int64)
    np.cumsum(counts, out=cum[1:])
    chunks = [(e0, min(E, e0 + chunk_edges))
              for e0 in range(0, E, chunk_edges)]

    def chunk_src(ci, n_c):
        return np.random.default_rng((seed, ci)).integers(
            0, V, size=n_c, dtype=np.int64)

    def chunk_dst(e0, e1):
        # vertex v owns rows [cum[v], cum[v+1]): rows [e0, e1) span
        # v0..v1, the end vertices' counts trimmed to the overlap
        v0 = int(np.searchsorted(cum, e0, side="right")) - 1
        v1 = int(np.searchsorted(cum, e1 - 1, side="right")) - 1
        c = counts[v0:v1 + 1].copy()
        c[0] -= e0 - cum[v0]
        c[-1] -= cum[v1 + 1] - e1
        return np.repeat(np.arange(v0, v1 + 1, dtype=np.int64), c)

    # pass 1: the out-degree histogram (O(V) ints, O(chunk) edges)
    deg = np.zeros(V, np.int64)
    with tevents.span("graph:ingest_degree", n_vertices=V, n_edges=E):
        for ci, (e0, e1) in enumerate(chunks):
            deg += np.bincount(chunk_src(ci, e1 - e0), minlength=V)
    inv = inv_out_degree(deg)

    def write_bin(mm):
        for ci, (e0, e1) in enumerate(chunks):
            src = chunk_src(ci, e1 - e0)
            mm[e0:e1] = native.pack_edge_rows(src, chunk_dst(e0, e1),
                                              inv[src])
            tevents.mark("data:cache_build", emit_event=False)
        mm[E:, 0] = 0
        mm[E:, 1] = pad_dst
        mm[E:, 2] = 0

    tevents.counter("graph.ingest_edges", E)
    return dcache.build_cache(path, header=header, write_bin=write_bin,
                              aux=_aux_writers(deg, ids, mask))


def read_aux(path: str, geom: dict):
    """The three aux payloads beside a complete block cache, ``(deg,
    didx, dmask)``, their shapes checked against the geometry. A missing
    file raises ``FileNotFoundError`` naming the remedy (a partial or
    legacy publish)."""
    V = int(geom["n_vertices"])
    S, k = int(geom["n_shards"]), int(geom["k_sparse"])
    out = []
    for name, dtype, shape in ((AUX_DEG, np.int32, (V,)),
                               (AUX_DIDX, np.int32, (S, k)),
                               (AUX_DMASK, np.float32, (S, k))):
        p = dcache.aux_path(path, name)
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"edge-block cache at {path!r} has no {name!r} aux "
                f"payload — a partial or pre-{LAYOUT} publish; delete "
                f"the cache and re-ingest")
        arr = np.fromfile(p, dtype=dtype)
        if arr.size != int(np.prod(shape)):
            raise ValueError(
                f"aux payload {p!r} holds {arr.size} elements, "
                f"geometry wants {shape}")
        out.append(arr.reshape(shape))
    return tuple(out)
