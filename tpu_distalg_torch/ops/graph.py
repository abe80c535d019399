"""Graph ops: the host prep of PageRank and the closure, a streamed edge
block's rank contributions, and the dense closure's round.

Port of ``tpu_distalg/ops/graph.py``:

  * :class:`EdgeList` and :func:`prepare_edges` (``:22-67``): dedupe and
    out-degrees through the C++ ingest's binding (:mod:`..native`, with
    its byte-identical numpy forms where the library cannot load);
  * :func:`inv_out_degree`: the one definition of PageRank's per-edge
    weight (JAX keeps it in ``graphs/ingest.py:149``;
    :mod:`..graphs.ingest` takes it from here);
  * :func:`decode_edge_rows` and :func:`block_contribs` (``:107-132``):
    one staged batch of ``csr_edge_blocks_i32`` rows summed into a
    shard's destination window. JAX gathers ``ranks[src]·w`` and
    ``segment_sum``\\ s it onto ``dst − lo``. On the card a scatter-add
    adds with float atomics in no fixed order, so here the batch's runs
    of equal dst are the rows of a CSR matrix summed by kernel B7
    (:func:`..ops.pagerank_kernels.spmv_table`), and each run's sum is
    then added to the window at its dst: JAX's order of adds (a batch's
    per-dst sum first, then the add to the window), with no host sync
    and no atomics. B7's tile plan is made per batch, since every
    staged batch is a new input;
  * :func:`closure_step` and :func:`path_count` (``:135-150``): a
    boolean matmul as a float product tested ``> 0``, and a popcount.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch import native


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Deduplicated static-shape graph: the adjacency-list replacement."""

    src: np.ndarray  # (E,) int32, sorted by (src, dst)
    dst: np.ndarray  # (E,) int32
    n_vertices: int
    out_degree: np.ndarray  # (V,) int32

    @property
    def n_edges(self) -> int:
        return len(self.src)


def inv_out_degree(deg: np.ndarray) -> np.ndarray:
    """Per-vertex ``1/out_degree`` (0 for sinks), float32 — the one
    definition of PageRank's per-edge weight ``w_e = inv_deg[src]``."""
    deg = np.asarray(deg).astype(np.float32)
    return np.where(deg > 0, 1.0 / np.maximum(deg, 1.0),
                    0.0).astype(np.float32)


def prepare_edges(edges: np.ndarray,
                  n_vertices: int | None = None) -> EdgeList:
    """Dedupe an (E, 2) edge array and precompute out-degrees through
    :mod:`..native` (``links.distinct()`` + ``groupByKey``,
    ``pagerank.py:41``).

    ``n_vertices=None`` infers max id + 1; a count at or below the
    largest id raises (it would index the degree table out of range)."""
    src, dst = native.dedupe_edges_pair(np.asarray(edges))
    max_id = max(int(src.max()) if len(src) else -1,
                 int(dst.max()) if len(dst) else -1)
    if n_vertices is None:
        n_vertices = max_id + 1
    elif n_vertices <= max_id:
        raise ValueError(
            f"n_vertices={n_vertices} but the edge list references "
            f"vertex id {max_id}; pass n_vertices >= {max_id + 1} or "
            f"None to infer it")
    if len(src) and min(int(src.min()), int(dst.min())) < 0:
        raise ValueError("vertex ids must be non-negative")
    return EdgeList(src=src.astype(np.int32), dst=dst.astype(np.int32),
                    n_vertices=int(n_vertices),
                    out_degree=native.out_degree(src, n_vertices))


def decode_edge_rows(rows: torch.Tensor):
    """Split packed ``(E, 3)`` int32 cache rows into contiguous ``src``,
    ``dst`` (int32) and ``w`` (float32: the bits column viewed as
    float), the device-side inverse of ``native.pack_edge_rows``."""
    cols = rows.t().contiguous()
    return cols[0], cols[1], cols[2].view(torch.float32)


def block_runs(rows: torch.Tensor, lo: int, window: int):
    """The runs of equal dst in one dst-sorted batch of ``n`` packed rows
    as a CSR matrix of ``n`` rows: ``(row_ptr, src, w, slot)``. Run r
    (numbered by a ``cumsum`` of the heads ``dst[i] != dst[i−1]``) is
    row r, its edges ``[row_ptr[r], row_ptr[r+1])``; the rows past the
    last run are empty at ``n``. ``slot[r]`` is run r's dst − ``lo``, its
    place in the window, and ``window`` (a trash slot) for an empty row.
    Fixed sizes, made on the rows' device without a host sync."""
    src, dst, w = decode_edge_rows(rows)
    n, dev = src.shape[0], rows.device
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = dst[1:] != dst[:-1]
    # a head writes its run's entry; every other edge the spare one at n+1
    at = torch.where(head, torch.cumsum(head, 0) - 1, n + 1)
    row_ptr = torch.full((n + 2,), n, dtype=torch.int32, device=dev)
    row_ptr.scatter_(0, at, torch.arange(n, dtype=torch.int32, device=dev))
    slot = torch.full((n + 2,), window, dtype=torch.int64, device=dev)
    slot.scatter_(0, at, dst.long() - lo)
    return row_ptr[:n + 1], src, w, slot[:n]


def accumulate_block(acc: torch.Tensor, ranks: torch.Tensor,
                     rows: torch.Tensor, lo: int) -> None:
    """Add one batch's rank contributions into a shard's window
    accumulator ``acc`` (window + 1,) float32, in place: B7 sums each run
    (``spmv_table``: the kernel on the card, its plain version on the
    CPU), then each run's sum is added at its slot. The real slots are
    unique, so the add is a gather, an add and a store (no atomics); the
    empty rows' zeros land in the trash slot ``acc[window]``."""
    from tpu_distalg_torch.ops import pagerank_kernels as pk

    row_ptr, src, w, slot = block_runs(rows, lo, acc.shape[0] - 1)
    y = pk.spmv_table(row_ptr, src, w, ranks)
    acc.index_put_((slot,), acc.index_select(0, slot) + y)


def block_contribs(ranks: torch.Tensor, rows: torch.Tensor, lo: int,
                   window: int) -> torch.Tensor:
    """One staged batch's rank contributions in the owning shard's
    destination window, (window,) float32: ``Σ ranks[src]·w`` over the
    batch's edges into each dst, at ``dst − lo`` (JAX
    ``ops/graph.py:119``). Padding rows (zero weight, the last real dst)
    add zeros."""
    acc = torch.zeros(window + 1, dtype=torch.float32, device=ranks.device)
    accumulate_block(acc, ranks, rows, lo)
    return acc[:window]


def closure_operand(x: torch.Tensor) -> torch.Tensor:
    """A 0/1 matrix as the closure product's operand: bfloat16 on the
    card, float32 on the CPU. The operands are 0 and 1, so every
    partial sum is a count >= 0; however a sum is rounded (bf16 or
    float32, whatever the order), a zero count stays 0 and a positive
    one positive, so the ``> 0`` mask is the same for either type.
    bf16 runs on the tensor cores; float32 products run at full
    precision (TF32 off, :func:`..utils.device.resolve_device`)."""
    return x.to(torch.bfloat16 if x.device.type == "cuda"
                else torch.float32)


def closure_step(paths: torch.Tensor, edges_op: torch.Tensor
                 ) -> torch.Tensor:
    """One linear-closure round: new (x, z) ≙ edge (x, y) ∘ path (y, z),
    then the union — the reference's join with reversed edges, union
    and distinct (``transitive_closure.py:33-37``) as a boolean matmul
    and a logical or. ``paths`` is (V, V) bool, ``edges_op`` the edge
    set as :func:`closure_operand`; the product is tested ``> 0``."""
    composed = (edges_op @ closure_operand(paths)) > 0
    return paths | composed


def path_count(paths: torch.Tensor) -> torch.Tensor:
    """``paths.count()`` (``transitive_closure.py:38``), int64."""
    return paths.sum(dtype=torch.int64)
