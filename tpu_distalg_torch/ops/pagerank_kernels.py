"""PageRank sweep kernels: the dst-sorted CSR plan, B7 and B8.

Port of ``tpu_distalg/ops/pallas_pagerank.py``:

  * B7 :func:`spmv_table` (``spmv_table`` :457): the fused sweep,
    ``y[v] = Σ_{e in row v} x[src[e]]·w_e[e]``;
  * B8 :func:`scatter_table` (``scatter_table`` :498): the scatter-add of
    per-edge contributions already in dst order,
    ``y[v] = Σ_{e in row v} c[e]``.

Row v is the edges ``[row_ptr[v], row_ptr[v+1])`` of the dst-sorted
edge list (:func:`plan_csr`). On the card both kernels take a
:class:`TilePlan` (:func:`tile_plan`: tiles of equal work on the merge
path of row ends and edges), made once per prepared graph. The TPU planners ``plan_scatter`` and
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

#: path items (row ends plus edges) a tile takes at most and at least, and
#: the tiles a graph should give before its tiles shrink (about 8 a
#: block's SM on a 132-SM card); csrc/pagerank.cu's kMaxItems
MAX_TILE_ITEMS, MIN_TILE_ITEMS, TARGET_TILES = 2048, 256, 1024


def tile_items(n_rows: int, n_edges: int) -> int:
    """Path items a tile of the kernels takes, from the shapes alone:
    ``MAX_TILE_ITEMS``, halved down to ``MIN_TILE_ITEMS`` while the graph
    would give fewer than ``TARGET_TILES`` tiles."""
    items = MAX_TILE_ITEMS
    while items > MIN_TILE_ITEMS and n_rows + n_edges < items * TARGET_TILES:
        items //= 2
    return items


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The kernels' tiles over one CSR matrix. The merge path is the
    ``n_rows`` row ends and ``n_edges`` edges in order (a row's end after
    its edges); tile t is its items ``[t·items, (t+1)·items)``. The rows
    whose ends fall in tile t are ``[rows_before[t], rows_before[t+1])``
    and its edges ``[t·items − rows_before[t], …)``, so every tile holds at
    most ``items`` rows and edges together, however long a row is (a row
    that crosses tiles is summed in parts). ``rows_before`` (n_tiles + 1,)
    int32 lies on the kernels' device."""

    n_rows: int
    n_edges: int
    items: int
    rows_before: torch.Tensor

    @property
    def n_tiles(self) -> int:
        return self.rows_before.shape[0] - 1


def tile_plan(row_ptr, n_edges: int) -> TilePlan:
    """The :class:`TilePlan` of CSR offsets ``row_ptr`` (V+1,) over
    ``n_edges`` edges, made on ``row_ptr``'s device: a pure function of
    them, made once per prepared graph (:mod:`..models.pagerank`), or by a
    wrapper called without one."""
    V = row_ptr.shape[0] - 1
    items = tile_items(V, n_edges)
    n_items = V + n_edges
    n_tiles = max(1, -(-n_items // items))
    dev = row_ptr.device
    diag = (torch.arange(n_tiles + 1, device=dev, dtype=torch.int64)
            * items).clamp_(max=n_items)
    # the path position of row r's end: its edges and the r row ends before
    ends = row_ptr[1:].long() + torch.arange(V, device=dev)
    rows_before = torch.searchsorted(ends, diag, side="left")
    return TilePlan(n_rows=V, n_edges=n_edges, items=items,
                    rows_before=rows_before.to(torch.int32))


def _check_sizes(row_ptr, n_edges, what):
    if row_ptr.shape[0] < 1:
        raise ValueError(f"{what}: row_ptr needs V + 1 >= 1 entries")
    if n_edges > MAX_EDGES:
        raise ValueError(f"{what}: {n_edges} edges exceed {MAX_EDGES}")


def _kernel_plan(plan, row_ptr, n_edges, dev, what) -> TilePlan:
    """The plan a launch runs on: the caller's, checked against the
    shapes, or one made on the card."""
    V = row_ptr.shape[0] - 1
    if V < 1:
        raise ValueError(f"{what}: the CUDA kernel needs V >= 1 rows")
    if plan is None:
        return tile_plan(row_ptr, n_edges)
    if (plan.n_rows, plan.n_edges) != (V, n_edges) or \
            plan.rows_before.device != dev or \
            plan.rows_before.dtype != torch.int32:
        raise ValueError(
            f"{what}: the plan is for {plan.n_rows} rows and "
            f"{plan.n_edges} edges on {plan.rows_before.device}, the call "
            f"has {V} rows and {n_edges} edges on {dev}")
    return plan


def _launch(entry, what, dev, plan, streams, ceiling=False):
    """Launch ``entry`` of the library over ``plan`` on the current
    stream, ``streams`` its leading tensor operands; returns its float32
    output, (V,) or for the ceiling (n_tiles,). The tickets (zero, and
    left zero by every launch) and the parts each have a workspace of
    their own per (device, stream), so no plan reads another's
    leftovers."""
    lib = _native.load("pagerank")
    stream = _native.stream(dev)
    streams = [t.contiguous() for t in streams]   # held until the launch
    scratch = ()
    if not ceiling:
        scratch = tuple(_native.workspace(tag, dev, stream, n, dtype)
                        .data_ptr() for tag, n, dtype in (
                            ("pagerank tickets", plan.n_tiles, torch.int32),
                            ("pagerank parts", 2 * plan.n_tiles,
                             torch.float32)))
    y = torch.empty((plan.n_tiles if ceiling else plan.n_rows,),
                    dtype=torch.float32, device=dev)
    rc = getattr(lib, entry)(
        *(t.data_ptr() for t in streams), plan.n_rows,
        plan.n_edges, plan.rows_before.data_ptr(), plan.n_tiles, plan.items,
        *scratch, y.data_ptr(), dev.index, stream)
    _native.check(lib, rc, what)
    return y


def _check_spmv(row_ptr, src, w_e, x):
    _native.check_tensor("row_ptr", row_ptr, (torch.int32,), 1)
    _native.check_tensor("src", src, (torch.int32,), 1)
    _native.check_tensor("w_e", w_e, (torch.float32,), 1)
    _native.check_tensor("x", x, (torch.float32,), 1)
    _check_sizes(row_ptr, src.shape[0], "spmv_table")
    if w_e.shape[0] != src.shape[0]:
        raise ValueError(f"src {tuple(src.shape)} and w_e "
                         f"{tuple(w_e.shape)} disagree")


def spmv_table(row_ptr, src, w_e, x, plan: TilePlan | None = None):
    """B7: ``y[v] = Σ_{e in row v} x[src[e]]·w_e[e]``, (V,) float32.

    ``row_ptr`` (V+1,) int32 with ``row_ptr[0] = 0`` and
    ``row_ptr[V] = E``; ``src`` (E,) int32 ids in ``[0, len(x))``;
    ``w_e`` (E,) and ``x`` float32. The values are not checked on the
    card (that would cost a sync per call): ``row_ptr`` must be
    non-decreasing and ``src`` in range, as :func:`plan_csr` makes them.
    ``plan``: the :func:`tile_plan` of ``row_ptr``, made once per graph;
    without one the call makes it on the card. A CPU tensor goes to
    :func:`spmv_table_reference`; a CUDA tensor launches the kernel
    (``spmv_table.launches``) or raises."""
    _check_spmv(row_ptr, src, w_e, x)
    if all(t.device.type == "cpu" for t in (row_ptr, src, w_e, x)):
        return spmv_table_reference(row_ptr, src, w_e, x)
    dev = _native.cuda_device(row_ptr, src, w_e, x)
    plan = _kernel_plan(plan, row_ptr, src.shape[0], dev, "spmv_table")
    y = _launch("tda_pagerank_spmv", "spmv_table", dev, plan,
                (row_ptr, src, w_e, x))
    spmv_table.launches += 1
    return y


spmv_table.launches = 0


def scatter_table(row_ptr, c, plan: TilePlan | None = None):
    """B8: ``y[v] = Σ_{e in row v} c[e]``, (V,) float32, for
    contributions ``c`` (E,) float32 already in dst order; ``row_ptr``
    and ``plan`` as for :func:`spmv_table`, with ``row_ptr[V] = E``. A
    CPU tensor goes to :func:`scatter_table_reference`; a CUDA tensor
    launches the kernel (``scatter_table.launches``) or raises."""
    _native.check_tensor("row_ptr", row_ptr, (torch.int32,), 1)
    _native.check_tensor("c", c, (torch.float32,), 1)
    _check_sizes(row_ptr, c.shape[0], "scatter_table")
    if row_ptr.device.type == "cpu" and c.device.type == "cpu":
        return scatter_table_reference(row_ptr, c)
    dev = _native.cuda_device(row_ptr, c)
    plan = _kernel_plan(plan, row_ptr, c.shape[0], dev, "scatter_table")
    y = _launch("tda_pagerank_segment_sum", "scatter_table", dev, plan,
                (row_ptr, c))
    scatter_table.launches += 1
    return y


scatter_table.launches = 0


def gather_ceiling(row_ptr, src, w_e, x, plan: TilePlan | None = None):
    """A measurement on no path: B7's loads, gathers and products over
    ``plan``'s tiles without the row structure, one sum a tile
    (n_tiles,). Its time is the floor the gathers set for B7 (the "gather
    ceiling", PERF.md §6). CUDA tensors only; not counted in ``KERNELS``."""
    _check_spmv(row_ptr, src, w_e, x)
    dev = _native.cuda_device(row_ptr, src, w_e, x)
    plan = _kernel_plan(plan, row_ptr, src.shape[0], dev, "gather_ceiling")
    return _launch("tda_pagerank_gather_ceiling", "gather_ceiling", dev,
                   plan, (row_ptr, src, w_e, x), ceiling=True)


#: the kernels of this module, for resetting and reading launch counts
KERNELS = (spmv_table, scatter_table)
