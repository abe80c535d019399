"""Host graph prep for PageRank and the closure, in numpy, and the
dense closure's round.

Port of ``tpu_distalg/ops/graph.py::EdgeList``/``prepare_edges`` and of
the host helpers it and the sweep prep take from
``tpu_distalg/native/__init__.py`` (``dedupe_edges_pair``,
``out_degree``, ``counting_sort_perm``, ``parse_edges_text``) and
``tpu_distalg/graphs/ingest.py::inv_out_degree``. The JAX package runs
the helpers in C++ (``native/graph_ingest.cpp``) when that library is
built; these are the numpy forms of the same functions, which sort and
dedupe the same way, so both packages get the same integer arrays. At
8M edges numpy takes seconds; a binding of the C++ ingest waits for the
out-of-core slice (ROADMAP A10).

:func:`closure_step` and :func:`path_count` are the port of the JAX
package's transitive-closure ops (``ops/graph.py:135-150``), which run
outside any Pallas kernel: a boolean matmul as a float product tested
``> 0``, and a popcount.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def dedupe_edges_pair(edges: np.ndarray):
    """Sorted, deduplicated (src, dst) int64 columns of an (E, 2) int
    edge array — ``links.distinct()`` set semantics (reference
    ``pagerank.py:41``)."""
    edges = np.ascontiguousarray(edges, dtype=np.int64).reshape(-1, 2)
    uniq = np.unique(edges, axis=0)
    return (np.ascontiguousarray(uniq[:, 0]),
            np.ascontiguousarray(uniq[:, 1]))


def out_degree(src: np.ndarray, n_vertices: int) -> np.ndarray:
    """(n_vertices,) int32 count of each id in ``src``."""
    src = np.ascontiguousarray(src, dtype=np.int64)
    if len(src) and (int(src.min()) < 0 or int(src.max()) >= n_vertices):
        raise ValueError(
            f"src id out of range for n_vertices={n_vertices}: "
            f"[{int(src.min())}, {int(src.max())}]")
    return np.bincount(src, minlength=n_vertices).astype(np.int32)


def counting_sort_perm(keys: np.ndarray, key_range: int) -> np.ndarray:
    """Stable argsort (int64) of integer keys in ``[0, key_range)`` —
    the host prep behind PageRank's dst-sorted edge layout."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if len(keys) and (keys.min() < 0 or keys.max() >= key_range):
        raise ValueError(
            f"counting_sort_perm: key out of range [0, {key_range})")
    return np.argsort(keys, kind="stable")


def parse_edges_text(path: str) -> np.ndarray:
    """Parse a '#'-commented whitespace edge-list file into (E, 2)
    int64."""
    return np.loadtxt(path, dtype=np.int64, comments="#",
                      ndmin=2).reshape(-1, 2)


def inv_out_degree(deg: np.ndarray) -> np.ndarray:
    """Per-vertex ``1/out_degree`` (0 for sinks), float32 — the one
    definition of PageRank's per-edge weight ``w_e = inv_deg[src]``."""
    deg = np.asarray(deg).astype(np.float32)
    return np.where(deg > 0, 1.0 / np.maximum(deg, 1.0),
                    0.0).astype(np.float32)


def prepare_edges(edges: np.ndarray,
                  n_vertices: int | None = None) -> EdgeList:
    """Dedupe an (E, 2) edge array and precompute out-degrees.

    ``n_vertices=None`` infers max id + 1; a count at or below the
    largest id raises (it would index the degree table out of range)."""
    src, dst = dedupe_edges_pair(np.asarray(edges))
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
                    out_degree=out_degree(src, n_vertices))


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
