"""PageRank sweep kernels: the dst-sorted CSR plan, B7 and B8.

Port of ``tpu_distalg/ops/pallas_pagerank.py``:

  * B7 :func:`spmv_table` (``spmv_table`` :457): the fused sweep,
    ``y[v] = Σ_{e in row v} x[src[e]]·w_e[e]``;
  * B8 :func:`scatter_table` (``scatter_table`` :498): the scatter-add of
    per-edge contributions already in dst order,
    ``y[v] = Σ_{e in row v} c[e]``.

Row v is the edges ``[row_ptr[v], row_ptr[v+1])`` of the dst-sorted
edge list (:func:`plan_csr`). The TPU planners ``plan_scatter`` and
``plan_spmv`` are not ported: their chunks and windows exist only to fit
VMEM and the (8, 128) tiling, and they give up on graphs too sparse or
too skewed for their caps. The CSR plan has no caps, so it exists for
every graph.

Beside each wrapper is its plain PyTorch version (``*_reference``): an
``index_add_`` of the per-edge products onto the rows' dst ids (on the
card ``index_add_`` adds with float atomics, so the plain version is a
check, never a path). A wrapper takes its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel
(``csrc/pagerank.cu``, counted in ``<wrapper>.launches``) or raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_distalg_torch.ops import _native
from tpu_distalg_torch.ops import graph as gops

#: the kernels index edges with 32-bit ints
MAX_EDGES = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class CSRPlan:
    """The dst-sorted edge list as CSR rows, on the host.

    ``src`` (E,) int32 and ``w_e`` (E,) float32 (``inv_deg[src]``) are in
    dst order, stable within a dst; ``row_ptr`` (V+1,) int32. Emulated
    shard s owns the contiguous edge range ``bounds[s] = (lo, hi)``, the
    JAX package's split of the dst-sorted list."""

    src: np.ndarray
    w_e: np.ndarray
    row_ptr: np.ndarray
    bounds: tuple[tuple[int, int], ...]

    def shard_row_ptr(self, s: int) -> np.ndarray:
        """Shard s's own CSR offsets over its slice of the edges."""
        lo, hi = self.bounds[s]
        return (np.clip(self.row_ptr, lo, hi) - lo).astype(np.int32)


def shard_bounds(n_edges: int, n_shards: int) -> tuple[tuple[int, int], ...]:
    """Each shard's ``[lo, hi)`` of the real edges: the list padded to a
    multiple of ``n_shards`` and cut into equal slices
    (``tpu_distalg/models/pagerank.py:300-309``)."""
    per = (n_edges + (-n_edges) % n_shards) // n_shards
    return tuple((min(s * per, n_edges), min((s + 1) * per, n_edges))
                 for s in range(n_shards))


def plan_csr(el: gops.EdgeList, n_shards: int = 1) -> CSRPlan:
    """The dst-sorted CSR of ``el`` and its split over ``n_shards``."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    E, V = el.n_edges, el.n_vertices
    if E > MAX_EDGES:
        raise ValueError(f"{E} edges: the kernels take at most "
                         f"{MAX_EDGES} (32-bit edge ids)")
    order = gops.counting_sort_perm(el.dst, V)
    src = el.src[order].astype(np.int32)
    w_e = gops.inv_out_degree(el.out_degree)[src]
    row_ptr = np.zeros(V + 1, np.int64)
    np.cumsum(np.bincount(el.dst, minlength=V), out=row_ptr[1:])
    return CSRPlan(src=src, w_e=w_e, row_ptr=row_ptr.astype(np.int32),
                   bounds=shard_bounds(E, n_shards))


# ---------------------------------------------------------------- plain


def _rows(row_ptr):
    """The dst id of every edge, expanded from the CSR offsets."""
    V = row_ptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(V, device=row_ptr.device),
        (row_ptr[1:] - row_ptr[:-1]).long())


def spmv_table_reference(row_ptr, src, w_e, x):
    """Plain B7: ``zeros(V).index_add_(0, dst, x[src]·w_e)``."""
    V = row_ptr.shape[0] - 1
    return torch.zeros(V, dtype=torch.float32, device=x.device).index_add_(
        0, _rows(row_ptr), x[src.long()] * w_e)


def scatter_table_reference(row_ptr, c):
    """Plain B8: ``zeros(V).index_add_(0, dst, c)``."""
    V = row_ptr.shape[0] - 1
    return torch.zeros(V, dtype=torch.float32, device=c.device).index_add_(
        0, _rows(row_ptr), c)


# -------------------------------------------------------------- kernels


def lanes_per_row(n_edges: int, n_rows: int) -> int:
    """Lanes the kernels give each row: the power of two in [4, 32]
    nearest above the average degree."""
    avg = n_edges / max(n_rows, 1)
    g = 4
    while g < 32 and g < avg:
        g *= 2
    return g


def _check_sizes(row_ptr, n_edges, what):
    if row_ptr.shape[0] < 1:
        raise ValueError(f"{what}: row_ptr needs V + 1 >= 1 entries")
    if n_edges > MAX_EDGES:
        raise ValueError(f"{what}: {n_edges} edges exceed {MAX_EDGES}")


def _check_kernel_rows(V, what):
    if V < 1:
        raise ValueError(f"{what}: the CUDA kernel needs V >= 1 rows")


def spmv_table(row_ptr, src, w_e, x):
    """B7: ``y[v] = Σ_{e in row v} x[src[e]]·w_e[e]``, (V,) float32.

    ``row_ptr`` (V+1,) int32 with ``row_ptr[0] = 0`` and
    ``row_ptr[V] = E``; ``src`` (E,) int32 ids in ``[0, len(x))``;
    ``w_e`` (E,) and ``x`` float32. The values are not checked on the
    card (that would cost a sync per call): ``row_ptr`` must be
    non-decreasing and ``src`` in range, as :func:`plan_csr` makes them.
    A CPU tensor goes to
    :func:`spmv_table_reference`; a CUDA tensor launches the kernel
    (``spmv_table.launches``) or raises."""
    _native.check_tensor("row_ptr", row_ptr, (torch.int32,), 1)
    _native.check_tensor("src", src, (torch.int32,), 1)
    _native.check_tensor("w_e", w_e, (torch.float32,), 1)
    _native.check_tensor("x", x, (torch.float32,), 1)
    _check_sizes(row_ptr, src.shape[0], "spmv_table")
    if w_e.shape[0] != src.shape[0]:
        raise ValueError(f"src {tuple(src.shape)} and w_e "
                         f"{tuple(w_e.shape)} disagree")
    if all(t.device.type == "cpu" for t in (row_ptr, src, w_e, x)):
        return spmv_table_reference(row_ptr, src, w_e, x)
    dev = _native.cuda_device(row_ptr, src, w_e, x)
    V, E = row_ptr.shape[0] - 1, src.shape[0]
    _check_kernel_rows(V, "spmv_table")
    row_ptr, src, w_e, x = (t.contiguous() for t in (row_ptr, src, w_e, x))
    lib = _native.load("pagerank")
    y = torch.empty((V,), dtype=torch.float32, device=dev)
    rc = lib.tda_pagerank_spmv(
        row_ptr.data_ptr(), src.data_ptr(), w_e.data_ptr(), x.data_ptr(), V,
        lanes_per_row(E, V), y.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _native.check(lib, rc, "spmv_table")
    spmv_table.launches += 1
    return y


spmv_table.launches = 0


def scatter_table(row_ptr, c):
    """B8: ``y[v] = Σ_{e in row v} c[e]``, (V,) float32, for
    contributions ``c`` (E,) float32 already in dst order; ``row_ptr``
    as for :func:`spmv_table`, with ``row_ptr[V] = E``. A CPU tensor
    goes to :func:`scatter_table_reference`; a CUDA tensor launches the
    kernel (``scatter_table.launches``) or raises."""
    _native.check_tensor("row_ptr", row_ptr, (torch.int32,), 1)
    _native.check_tensor("c", c, (torch.float32,), 1)
    _check_sizes(row_ptr, c.shape[0], "scatter_table")
    if row_ptr.device.type == "cpu" and c.device.type == "cpu":
        return scatter_table_reference(row_ptr, c)
    dev = _native.cuda_device(row_ptr, c)
    V, E = row_ptr.shape[0] - 1, c.shape[0]
    _check_kernel_rows(V, "scatter_table")
    row_ptr, c = row_ptr.contiguous(), c.contiguous()
    lib = _native.load("pagerank")
    y = torch.empty((V,), dtype=torch.float32, device=dev)
    rc = lib.tda_pagerank_segment_sum(
        row_ptr.data_ptr(), c.data_ptr(), V, lanes_per_row(E, V),
        y.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _native.check(lib, rc, "scatter_table")
    scatter_table.launches += 1
    return y


scatter_table.launches = 0

#: the kernels of this module, for resetting and reading launch counts
KERNELS = (spmv_table, scatter_table)
