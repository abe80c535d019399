"""The partition-rule engine on the emulated mesh.

Port of ``tpu_distalg/parallel/partition.py``. A model's placement is a
:class:`RuleTable`: an ordered list of ``(regex, spec)`` rules matched
against the named leaves of a tree (dict keys, dataclass fields and
sequence indices joined with ``/``). The first matching rule wins; a
0-d or size-1 leaf replicates without consulting the table; a leaf no
rule matches is a hard :class:`PartitionRuleError`. A spec is a tuple
with one entry a dimension: an axis name (``DATA_AXIS``,
``MODEL_AXIS``), a tuple of them, or ``None`` for a dimension that is
not cut; ``()`` is replicated. Every table of the JAX package is
registered below, as data.

A placement is two things: the padding a layout needs
(:func:`pad_amounts`) and the rule that cuts a tensor into the views
each shard holds (:func:`shards`). :func:`put` and :func:`place` bring
a global array to the mesh's device in its table's layout; in a process
group (``mesh.process_count > 1``) they keep only the block of this
process's data shards, and :func:`shards` yields only those shards,
keyed by global id. A process never holds another's rows:
:func:`gather` brings a row-sharded leaf together only when asked.
:func:`constrain` checks that a layout can be cut, and :func:`reshard`
applies the pad and slice of the JAX package's pad-reshard-slice round
trip and emits the ``reshard.*`` counters and the ``reshard`` event.
Its plan (:func:`reshard_stats`) classifies each leaf's change of
layout into the collective the JAX package's partitioner would run
(``noop``, ``slice``, ``all_gather``, ``all_to_all``, ``gather_slice``)
and counts its bytes under the same ring model, so its integers equal
the JAX package's for the same tree, tables and mesh shape. On one card
``bytes_wire`` is that model's count, not bytes that crossed a link.
Across processes a leaf the source cuts over the data axis and the
destination replicates (or re-pads on that axis) is brought together
with ``collectives.allgather_rows``; a leaf that stays cut the same way
keeps this process's rows; a replicated leaf the destination cuts keeps
this process's block. The plan's integers stay the ones of the global
tree, and ``reshard.bytes_sent`` counts what this process really sent.

Every trainer places its tensors through these tables: ALS
(``als_train``, ``als_serve``), SSGD (``lr``, ``ssgd``, ``ssgd_tp``),
the local-update family (``local_sgd``), k-means (``kmeans``) and
PageRank (``pagerank``); ``parallel/sharding.py`` is a thin caller.

Row ownership (:func:`row_bounds`, :class:`LeafOwnership`,
:class:`RowOwnershipMap`) is host arithmetic in numpy, as in the JAX
package: the cluster's parameter server splits its center with it
(``cluster/ps.py``), and :func:`row_block_stats` counts out-of-core
row blocks. Their results equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import torch

from tpu_distalg_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from tpu_distalg_torch.telemetry import events as tevents


class PartitionRuleError(ValueError):
    """A leaf no rule matches, an unknown table name, or a reshard
    between tables that do not cover the same leaves."""


def _spec_tuple(spec) -> tuple:
    """A spec without its trailing ``None`` entries: ``("data",)`` and
    ``("data", None)`` place an array of one rank identically."""
    t = tuple(spec)
    while t and t[-1] is None:
        t = t[:-1]
    return t


def specs_equal(a, b) -> bool:
    return _spec_tuple(a) == _spec_tuple(b)


@dataclasses.dataclass(frozen=True)
class RuleTable:
    """An ordered ``(regex, spec)`` rule list naming one model's
    placement. ``spec_for`` is the whole matching contract."""

    name: str
    rules: tuple  # ((pattern, spec), ...)

    def spec_for(self, leaf_name: str, shape: tuple) -> tuple:
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return ()  # never partition a scalar value
        for pat, spec in self.rules:
            if re.search(pat, leaf_name) is not None:
                return tuple(spec)
        raise PartitionRuleError(
            f"no partition rule in table {self.name!r} matches leaf "
            f"{leaf_name!r} (shape {tuple(shape)}) — every non-scalar "
            f"leaf must be named by a rule; add one to the table in "
            f"parallel/partition.py (rules: "
            f"{[p for p, _ in self.rules]})")


# --------------------------------------------------------------- registry

_REGISTRY: dict[str, RuleTable] = {}


def register(table: RuleTable, *, replace: bool = False) -> RuleTable:
    if not replace and table.name in _REGISTRY:
        raise PartitionRuleError(
            f"rule table {table.name!r} is already registered")
    _REGISTRY[table.name] = table
    return table


def table(name: str | RuleTable) -> RuleTable:
    if isinstance(name, RuleTable):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise PartitionRuleError(
            f"unknown rule table {name!r} (registered: "
            f"{sorted(_REGISTRY)})") from None


def registered() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ----------------------------------------------------- row ownership


def row_bounds(n_rows: int, n_shards: int) -> np.ndarray:
    """The ``(n_shards + 1,)`` int64 cut points of ``np.array_split``'s
    contract over ``n_rows`` leading-dim rows: the first ``n_rows %
    n_shards`` shards own ``n_rows // n_shards + 1`` rows, the rest
    ``n_rows // n_shards`` — uneven splits are first-class (a shard
    count that does not divide the model axis is the NORMAL case).
    Shard ``i`` owns ``[bounds[i], bounds[i + 1])``."""
    if n_shards < 1:
        raise PartitionRuleError(
            f"n_shards must be >= 1, got {n_shards}")
    base, extra = divmod(int(n_rows), int(n_shards))
    sizes = np.full((int(n_shards),), base, np.int64)
    sizes[:extra] += 1
    return np.concatenate(
        [np.zeros((1,), np.int64), np.cumsum(sizes, dtype=np.int64)])


@dataclasses.dataclass(frozen=True)
class LeafOwnership:
    """One leaf's placement across row shards: either row-partitioned
    (``bounds`` holds the cut points) or whole on shard ``owner``."""

    name: str
    shape: tuple
    sharded: bool
    bounds: np.ndarray | None = None
    owner: int = 0

    def range_of(self, shard: int) -> tuple[int, int]:
        """The ``[lo, hi)`` leading-dim row range ``shard`` owns (an
        empty range for a non-owner of a whole leaf)."""
        if self.sharded:
            return int(self.bounds[shard]), int(self.bounds[shard + 1])
        n = int(self.shape[0]) if len(self.shape) else 1
        return (0, n) if shard == self.owner else (0, 0)

    def owner_of(self, rows: np.ndarray) -> np.ndarray:
        """Per-row owning shard ids (int64), vectorized."""
        rows = np.asarray(rows, np.int64)
        if not self.sharded:
            return np.full(rows.shape, self.owner, np.int64)
        return np.searchsorted(self.bounds, rows, side="right") - 1


class RowOwnershipMap:
    """The partition-table-driven row-ownership map — ONE derivation of
    "which shard owns which leading-dim rows of which leaf", used by
    the PS tier's center sharding (``cluster/ps.split_center``). A leaf whose spec in
    the model's rule table shards ANY dim row-splits on axis 0 with
    ``np.array_split`` arithmetic (:func:`row_bounds` — the historical
    ``ps.split_center`` slicing, now first-class); a replicated-spec or
    scalar leaf lives whole on shard 0. Derived from the SAME
    :class:`RuleTable` that drives the device-side ``shardings()`` —
    one table per model names both placements."""

    def __init__(self, shapes: dict, table_name, n_shards: int):
        if n_shards < 1:
            raise PartitionRuleError(
                f"n_shards must be >= 1, got {n_shards}")
        tbl = table(table_name)
        self.table_name = tbl.name
        self.n_shards = int(n_shards)
        self.leaves: dict[str, LeafOwnership] = {}
        for name, shape in shapes.items():
            shape = tuple(int(d) for d in shape)
            spec = tbl.spec_for(name, shape)
            sharded = any(e is not None for e in tuple(spec))
            if sharded and len(shape) >= 1 and shape[0] >= 1:
                self.leaves[name] = LeafOwnership(
                    name, shape, True,
                    bounds=row_bounds(shape[0], self.n_shards))
            else:
                self.leaves[name] = LeafOwnership(
                    name, shape, False, owner=0)

    @classmethod
    def for_center(cls, center: dict, table_name,
                   n_shards: int) -> "RowOwnershipMap":
        return cls({k: np.asarray(v).shape for k, v in center.items()},
                   table_name, n_shards)

    def __getitem__(self, name: str) -> LeafOwnership:
        try:
            return self.leaves[name]
        except KeyError:
            raise PartitionRuleError(
                f"leaf {name!r} is not in the {self.table_name!r} "
                f"ownership map (known: {sorted(self.leaves)})"
            ) from None

    def split(self, center: dict) -> list[dict]:
        """Per-shard sub-dicts of ``center`` (row slices copied) — the
        exact byte-level output of the historical
        ``ps.split_center``."""
        shards: list[dict] = [{} for _ in range(self.n_shards)]
        for name, leaf in center.items():
            leaf = np.asarray(leaf)
            own = self[name]
            if own.sharded:
                for i in range(self.n_shards):
                    lo, hi = own.range_of(i)
                    shards[i][name] = leaf[lo:hi].copy()
            else:
                shards[own.owner][name] = leaf.copy()
        return shards

    def join(self, shards: list[dict]) -> dict:
        """Inverse of :meth:`split` — concatenate row slices in shard
        order, pass whole leaves through."""
        out: dict = {}
        for name, own in self.leaves.items():
            pieces = [sh[name] for sh in shards if name in sh]
            if not pieces:
                continue
            out[name] = (pieces[0].copy() if len(pieces) == 1
                         else np.concatenate(pieces, axis=0))
        return out


# ---------------------------------------------------------- leaf naming


def _flatten(tree, path: tuple) -> list:
    """``[(path, leaf), ...]`` in the JAX package's leaf order: dict keys
    sorted, sequences by index, dataclasses by field."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k],
                                                          path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for j, v in enumerate(tree)
                for x in _flatten(v, path + (str(j),))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _flatten(getattr(tree, f.name), path + (f.name,))]
    if tree is None:
        return []
    return [(path, tree)]


def _name(path: tuple) -> str:
    return "/".join(path) or "leaf"


def named_leaves(tree) -> list[tuple[str, Any]]:
    """``[(path_name, leaf), ...]``: the names the rule regexes match."""
    return [(_name(p), v) for p, v in _flatten(tree, ())]


def _tree_map_named(fn, tree):
    """Map ``fn(name, leaf)`` over the tree, keeping its structure."""
    def go(t, path):
        if isinstance(t, dict):
            return {k: go(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [go(v, path + (str(j),)) for j, v in enumerate(t)]
            return out if isinstance(t, list) else tuple(out)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{
                f.name: go(getattr(t, f.name), path + (f.name,))
                for f in dataclasses.fields(t)})
        if t is None:
            return None
        return fn(_name(path), t)

    return go(tree, ())


def _shape(leaf) -> tuple:
    return tuple(int(d) for d in np.shape(leaf))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def match_partition_rules(tbl, tree):
    """The tree of specs table ``tbl`` gives ``tree``'s leaves."""
    t = table(tbl)
    return _tree_map_named(lambda name, leaf: t.spec_for(name, _shape(leaf)),
                           tree)


# ----------------------------------------------------- layouts on a mesh


def _axis_size(mesh: Mesh, axis: str) -> int:
    if axis == DATA_AXIS:
        return mesh.n_data
    if axis == MODEL_AXIS:
        return mesh.n_model
    raise PartitionRuleError(f"unknown mesh axis {axis!r} (the emulated "
                             f"mesh has {DATA_AXIS!r} and {MODEL_AXIS!r})")


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _spec_dim_degrees(spec, mesh: Mesh) -> list[int]:
    """The shard count the spec imposes on each dimension (1: not cut)."""
    return [1 if entry is None else int(np.prod(
        [_axis_size(mesh, ax) for ax in _axes(entry)]))
        for entry in tuple(spec)]


def _local_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.n_local if axis == DATA_AXIS else _axis_size(mesh, axis)


def _local_dim_degrees(spec, mesh: Mesh) -> list[int]:
    """The blocks this process's part of each dimension holds: the data
    axis counts only its own shards."""
    for entry in tuple(spec):
        axes = () if entry is None else _axes(entry)
        if DATA_AXIS in axes[1:] and mesh.process_count > 1:
            raise PartitionRuleError(
                f"spec {tuple(spec)} cuts a dimension over the data axis "
                f"inside another: this process's shards would not be "
                f"contiguous")
    return [1 if entry is None else int(np.prod(
        [_local_axis_size(mesh, ax) for ax in _axes(entry)]))
        for entry in tuple(spec)]


def local_block(x, spec, mesh: Mesh, model_slice: int | None = None):
    """This process's block of a global array under ``spec``: each
    dimension cut over the data axis narrowed to the process's shards
    (a view; ``x`` itself with one process). With ``model_slice``, ``x``
    is already that model slice's block of every dimension the model
    axis cuts, so only the data axis narrows it. The trainers take their
    rows of a draw made over every row (a mask's uniforms, the block
    draws) through it."""
    if mesh.process_count == 1:
        return x
    _local_dim_degrees(spec, mesh)   # refuses a non-contiguous layout
    lo = mesh.local_data.start
    for i, entry in enumerate(tuple(spec)):
        axes = () if entry is None else _axes(entry)
        if not axes or axes[0] != DATA_AXIS:
            continue
        inner = 1 if model_slice is not None else int(np.prod(
            [_axis_size(mesh, a) for a in axes[1:]]))
        n = x.shape[i] // (mesh.n_data * inner)
        a, b = lo * inner * n, (lo + mesh.n_local) * inner * n
        x = x[(slice(None),) * i + (slice(a, b),)]
    return x


def held_index(s: int, mesh: Mesh) -> int:
    """Global data shard ``s``'s position among this process's shards
    (``s`` itself with one process)."""
    i = s - mesh.local_data.start
    if not 0 <= i < mesh.n_local:
        raise ValueError(f"data shard {s} is not held by process "
                         f"{mesh.process_index} ({mesh.local_data})")
    return i


def data_block(x, s: int, mesh: Mesh, dim: int = 0):
    """Global data shard ``s``'s view of this process's tensor ``x``
    whose dimension ``dim`` is cut over the data axis alone: the view
    :func:`shards` gives shard ``s`` under such a spec, without making
    the others' (the trainers call it a shard a step)."""
    n = x.shape[dim] // mesh.n_local
    return x.narrow(dim, held_index(s, mesh) * n, n)


def pad_amounts(shape, spec, mesh: Mesh) -> tuple[int, ...]:
    """Tail padding of each dimension that makes ``shape`` divisible by
    the spec's shard counts: all zeros when the layout is even."""
    degs = _spec_dim_degrees(spec, mesh)
    return tuple(
        ((-int(dim)) % degs[i]) if i < len(degs) and degs[i] > 1 else 0
        for i, dim in enumerate(shape))


def spec_shards(spec, mesh: Mesh) -> int:
    """The number of distinct shards the spec cuts an array into on this
    mesh (1: replicated)."""
    return int(np.prod([_axis_size(mesh, ax) for entry in tuple(spec)
                        if entry is not None for ax in _axes(entry)]))


def _canonical_spec(spec, mesh: Mesh) -> tuple:
    """The spec with size-1 axes dropped: ``("data", "model")`` on a 4×1
    mesh places as ``("data",)`` does."""
    out = []
    for entry in tuple(spec):
        axes = () if entry is None else tuple(
            a for a in _axes(entry) if _axis_size(mesh, a) > 1)
        out.append(None if not axes else (axes if len(axes) > 1
                                          else axes[0]))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def shards(x, spec, mesh: Mesh) -> dict[int, list]:
    """The views of this process's tensor ``x`` that each of its shards
    holds under ``spec``: ``out[s][m]`` is shard (data ``s``, model
    ``m``)'s, for the global data shards ``s`` of ``mesh.local_data``
    (every shard with one process). A dimension cut over one axis takes
    that axis's coordinate; over a tuple of axes, their coordinates
    row-major, as the JAX package's shard index. The views share ``x``'s
    storage; a dimension the spec's shard count does not divide raises
    (pad it first: :func:`pad_amounts`)."""
    shape = _shape(x)
    spec = tuple(spec)
    degs = _local_dim_degrees(spec, mesh)
    for i, (dim, deg) in enumerate(zip(shape, degs)):
        if dim % deg:
            raise PartitionRuleError(
                f"dimension {i} of size {dim} does not split into {deg} "
                f"shards under spec {spec}; pad it first (pad_amounts)")
    coords = {DATA_AXIS: 0, MODEL_AXIS: 0}

    def view():
        idx = []
        for i, entry in enumerate(spec):
            if entry is None or degs[i] == 1:
                idx.append(slice(None))
                continue
            j = 0
            for ax in _axes(entry):
                j = j * _local_axis_size(mesh, ax) + coords[ax]
            n = shape[i] // degs[i]
            idx.append(slice(j * n, (j + 1) * n))
        return x[tuple(idx)]

    out = {}
    for s in mesh.local_data:
        row = []
        for m in range(mesh.n_model):
            coords[DATA_AXIS] = held_index(s, mesh)
            coords[MODEL_AXIS] = m
            row.append(view())
        out[s] = row
    return out


# ----------------------------------------------------- generated fns


def _to_device(x, mesh: Mesh) -> torch.Tensor:
    """``x`` as a tensor on the mesh's device (a tensor already there
    passes through)."""
    if isinstance(x, torch.Tensor):
        return x if x.device == mesh.device else x.to(mesh.device)
    return torch.as_tensor(np.asarray(x), device=mesh.device)


def _as_array(x):
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def put(x, leaf_name: str, tbl, mesh: Mesh, *,
        model_slice: int | None = None) -> torch.Tensor:
    """Place one global array per its table rule: this process's block
    of it (the whole array with one process) on the mesh's device, in a
    layout its shards can cut. With ``model_slice``, ``x`` is that model
    slice's block of every dimension the rule cuts over the model axis,
    and only its data rows are cut."""
    x = _as_array(x)
    spec = table(tbl).spec_for(leaf_name, _shape(x))
    if model_slice is None:
        constrain(x, leaf_name, tbl, mesh, local=False)
    x = local_block(x, spec, mesh, model_slice)
    return _to_device(x, mesh)


def place(tree, tbl, mesh: Mesh):
    """Place every leaf of ``tree`` per its table rule. Idempotent: a
    tensor already on the mesh's device is taken as placed and passes
    through untouched; anything else is a global array, of which this
    process's block takes one copy to the device."""
    t = table(tbl)

    def one(name, x):
        if isinstance(x, torch.Tensor) and x.device == mesh.device:
            t.spec_for(name, _shape(x))
            return x
        x = _as_array(x)
        return _to_device(local_block(x, t.spec_for(name, _shape(x)),
                                       mesh), mesh)

    return _tree_map_named(one, tree)


def constrain(x, leaf_name: str, tbl, mesh: Mesh, *, local: bool = True):
    """The table's layout for one tensor: raises unless the rule names
    the leaf and its shards cut ``x`` evenly; returns ``x``. ``x`` is
    this process's block (``local``) or the global array."""
    spec = table(tbl).spec_for(leaf_name, _shape(x))
    degs = (_local_dim_degrees(spec, mesh) if local
            else _spec_dim_degrees(spec, mesh))
    if any(dim % deg for dim, deg in zip(_shape(x), degs)):
        raise PartitionRuleError(
            f"leaf {leaf_name!r} of shape {_shape(x)} does not split "
            f"evenly under {spec} on a {mesh.n_data}x{mesh.n_model} mesh")
    return x


def gather(tree, tbl=None, mesh: Mesh | None = None):
    """Host copies (numpy) of every leaf. With a table and a mesh that
    spans processes, a leaf the table cuts over the data axis (on its
    first dimension) is first brought together from every process's
    rows; nothing crosses otherwise."""
    from tpu_distalg_torch.parallel.collectives import allgather_rows

    t = None if tbl is None else table(tbl)

    def one(name, x):
        if not isinstance(x, torch.Tensor):
            return np.array(x)
        if t is not None and mesh is not None and mesh.process_count > 1:
            spec = t.spec_for(name, _shape(x))
            if spec and spec[0] is not None and \
                    _axes(spec[0])[0] == DATA_AXIS:
                x = allgather_rows(x.contiguous(), mesh, uneven=True)
        return x.detach().cpu().numpy().copy()

    return _tree_map_named(one, tree)


# ------------------------------------------------------------- reshard


def _leaf_plan(shape, dtype, src_spec, dst_spec, mesh: Mesh,
               true_shape=None) -> dict:
    """One leaf's src→dst change of layout: the collective class it
    needs and its wire bytes a shard under the ring model, as the JAX
    package counts them (``B`` the leaf's bytes at the moved shape):

      same layout        none                0
      repl → shard       local slice         0
      shard → repl       ring all-gather     B·(n_s−1)/n_s
      shard → shard,     all-to-all          (B/n_s)·(n_s−1)/n_s
      equal degree
      shard → shard,     all-gather + slice  B·(n_s−1)/n_s
      degree change

    ``bytes_host_roundtrip`` is what a gather to the host and a put back
    would move (2·B). A dst layout that does not divide a dimension pads
    it (``pad``, ``padded_shape``, ``bytes_padding``); ``true_shape``
    slices a previously padded input back first."""
    true = tuple(true_shape) if true_shape is not None else tuple(shape)
    pads = pad_amounts(true, dst_spec, mesh)
    moved = tuple(t + p for t, p in zip(true, pads))
    itemsize = _itemsize(dtype)
    nbytes = int((int(np.prod(moved)) if moved else 1) * itemsize)
    true_bytes = int((int(np.prod(true)) if true else 1) * itemsize)
    n_s = spec_shards(src_spec, mesh)
    n_d = spec_shards(dst_spec, mesh)
    reshaped = tuple(true) != tuple(shape) or any(pads)
    if not reshaped and _canonical_spec(src_spec, mesh) == \
            _canonical_spec(dst_spec, mesh):
        op, wire = "noop", 0.0
    elif n_s == 1:
        op, wire = "slice", 0.0
    elif n_d == 1:
        op, wire = "all_gather", nbytes * (n_s - 1) / n_s
    elif n_s == n_d:
        op, wire = "all_to_all", (nbytes / n_s) * (n_s - 1) / n_s
    else:
        op, wire = "gather_slice", nbytes * (n_s - 1) / n_s
    plan = {"op": op, "bytes_wire": int(round(wire)),
            "bytes_logical": nbytes,
            "bytes_host_roundtrip": 0 if op == "noop" else 2 * nbytes}
    if any(pads):
        plan["pad"] = pads
        plan["bytes_padding"] = nbytes - true_bytes
        plan["padded_shape"] = moved
    if tuple(true) != tuple(shape):
        plan["true_shape"] = tuple(true)
    return plan


def _dtype(leaf):
    return getattr(leaf, "dtype", np.float32)


def reshard_stats(tree, src_tbl, dst_tbl, mesh: Mesh, *,
                  true_shapes: dict | None = None) -> dict:
    """The whole tree's reshard plan and byte totals (no device work).
    ``true_shapes`` maps a leaf's name to its shape before an earlier
    uneven reshard padded it. Raises :class:`PartitionRuleError` when a
    table does not name a leaf."""
    src_t, dst_t = table(src_tbl), table(dst_tbl)
    leaves: dict[str, dict] = {}
    tot_wire = tot_logical = tot_host = tot_pad = n_moved = 0
    for name, leaf in named_leaves(tree):
        shape = _shape(leaf)
        plan = _leaf_plan(shape, _dtype(leaf), src_t.spec_for(name, shape),
                          dst_t.spec_for(name, shape), mesh,
                          true_shape=(true_shapes or {}).get(name))
        leaves[name] = plan
        tot_wire += plan["bytes_wire"]
        tot_logical += plan["bytes_logical"]
        tot_host += plan["bytes_host_roundtrip"]
        tot_pad += plan.get("bytes_padding", 0)
        n_moved += plan["op"] != "noop"
    return {"leaves": leaves, "bytes_wire": tot_wire,
            "bytes_logical": tot_logical,
            "bytes_host_roundtrip": tot_host,
            "bytes_padding": tot_pad,
            "n_leaves": len(leaves), "n_moved": n_moved,
            "src": src_t.name, "dst": dst_t.name}


def _relayout(x: torch.Tensor, plan: dict) -> torch.Tensor:
    """Slice a padded input back to its true shape, then pad it for the
    destination's shard counts."""
    true, pads = plan.get("true_shape"), plan.get("pad")
    if true is not None and _shape(x) != tuple(true):
        x = x[tuple(slice(0, s) for s in true)]
    if pads is not None:
        x = torch.nn.functional.pad(
            x, [p for pad in reversed(pads) for p in (0, int(pad))])
    return x


def _data_cut(spec) -> bool:
    """Whether ``spec`` cuts the first dimension over the data axis."""
    spec = tuple(spec)
    return bool(spec) and spec[0] is not None and \
        _axes(spec[0])[0] == DATA_AXIS


class _Global:
    """A leaf's global shape and dtype, for the plan of a tree whose
    data-cut leaves this process holds only its rows of."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype


def _global_tree(tree, src_t: RuleTable, mesh: Mesh):
    """``tree`` with each data-cut leaf's rows summed over the processes
    (one small all-gather for them all; the processes may hold different
    counts, as a result cut to its true rows does)."""
    from tpu_distalg_torch.parallel.collectives import allgather_rows

    leaves = named_leaves(tree)
    cut = [name for name, x in leaves
           if _data_cut(src_t.spec_for(name, _shape(x)))]
    rows = torch.as_tensor([[_shape(x)[0] for name, x in leaves
                             if name in cut]], dtype=torch.int64,
                           device=mesh.device)
    total = dict(zip(cut, (allgather_rows(rows, mesh).sum(0).tolist()
                           if cut else [])))

    def one(name, x):
        shape = _shape(x)
        if name in total:
            shape = (int(total[name]),) + shape[1:]
        return _Global(shape, _dtype(x))

    return _tree_map_named(one, tree)


def _reshard_leaf(x: torch.Tensor, shape: tuple, src_spec, dst_spec,
                  plan: dict, mesh: Mesh) -> torch.Tensor:
    """One leaf across processes: ``x`` this process's part under
    ``src_spec`` of the global array of ``shape`` → its part under
    ``dst_spec`` (see the module docstring)."""
    from tpu_distalg_torch.parallel.collectives import allgather_rows

    src_cut, dst_cut = _data_cut(src_spec), _data_cut(dst_spec)
    rows_kept = (plan.get("pad", (0,))[0] == 0
                 and plan.get("true_shape", shape)[0] == shape[0]
                 and x.shape[0] * mesh.process_count == shape[0])
    if src_cut and dst_cut and rows_kept:
        # stays cut the same way: this process's rows, the other
        # dimensions re-laid out
        local = {k: (x.shape[0],) + tuple(v[1:]) if k == "true_shape"
                 else (0,) + tuple(v[1:]) if k == "pad" else v
                 for k, v in plan.items()}
        return _relayout(x, local)
    if src_cut:
        x = allgather_rows(x.contiguous(), mesh, uneven=True)
    x = _relayout(x, plan)
    return local_block(x, dst_spec, mesh) if dst_cut else x


def reshard(tree, src_tbl, dst_tbl, mesh: Mesh, *, emit: bool = True,
            true_shapes: dict | None = None):
    """Re-lay ``tree`` out from ``src_tbl``'s placement to ``dst_tbl``'s
    on the mesh's device: each leaf sliced back to its true shape (for
    names in ``true_shapes``) and zero-padded where the destination does
    not divide it, as the JAX package's pad-reshard-slice program does.
    Across processes each leaf is this process's part of the global
    array, in and out (the module docstring says which crosses). Emits
    the ``reshard.*`` counters and the ``reshard`` event unless ``emit``
    is False."""
    from tpu_distalg_torch.parallel import collectives

    src_t, dst_t = table(src_tbl), table(dst_tbl)
    across = mesh.process_count > 1
    sent0 = collectives.COUNTERS["bytes_sent"]
    shapes = _global_tree(tree, src_t, mesh) if across else tree
    st = reshard_stats(shapes, src_t, dst_t, mesh, true_shapes=true_shapes)
    gshape = dict(named_leaves(shapes))

    def one(name, x):
        x, plan = _to_device(x, mesh), st["leaves"][name]
        if not across:
            return _relayout(x, plan)
        shape = gshape[name].shape
        return _reshard_leaf(x, shape, src_t.spec_for(name, shape),
                             dst_t.spec_for(name, shape), plan, mesh)

    out = _tree_map_named(one, tree)
    st["bytes_sent"] = collectives.COUNTERS["bytes_sent"] - sent0
    if emit:
        emit_reshard_counters(st)
    return out


def host_gather_reshard(tree, dst_tbl, mesh: Mesh,
                        true_shapes: dict | None = None, *,
                        src_tbl=None):
    """The baseline :func:`reshard` stands for: every leaf to the host,
    sliced and padded there, then placed in the destination layout. Its
    output equals :func:`reshard`'s bitwise. Across processes the
    leaves ``src_tbl`` cuts over the data axis are first brought
    together from every process, so it needs the source table there."""
    if mesh.process_count > 1 and src_tbl is None:
        raise ValueError("host_gather_reshard across processes needs "
                         "src_tbl: the leaves it cuts over the data "
                         "axis are gathered from every process")
    dst_t = table(dst_tbl)

    def one(name, x):
        true = (true_shapes or {}).get(name)
        if true is not None and x.shape != tuple(true):
            x = x[tuple(slice(0, s) for s in true)]
        pads = pad_amounts(x.shape, dst_t.spec_for(name, x.shape), mesh)
        if any(pads):
            x = np.pad(x, [(0, int(p)) for p in pads])
        return x

    return place(_tree_map_named(one, gather(tree, src_tbl, mesh)),
                 dst_tbl, mesh)


def emit_reshard_counters(st: dict) -> dict:
    """Bump the ``reshard.*`` counters for one reshard and record the
    event (nothing when telemetry is off)."""
    tevents.counter("reshard.bytes_wire", st["bytes_wire"])
    tevents.counter("reshard.bytes_logical", st["bytes_logical"])
    tevents.counter("reshard.bytes_host_avoided",
                    st["bytes_host_roundtrip"])
    tevents.counter("reshard.leaves", st["n_moved"])
    tevents.counter("reshard.syncs", 1)
    tevents.counter("reshard.bytes_sent", st.get("bytes_sent", 0))
    tevents.emit("reshard", src=st["src"], dst=st["dst"],
                 n_leaves=st["n_leaves"], n_moved=st["n_moved"],
                 bytes_wire=st["bytes_wire"])
    return st


def row_block_stats(n_rows: int, block_rows: int, *,
                    n_shards: int = 1, row_bytes: int = 4) -> dict:
    """Out-of-core row-block accounting (pure arithmetic, no mesh):
    how many gathered blocks a ``block_rows`` granularity yields per
    shard, the pad rows divisibility costs, and the per-block wire
    bytes. The autotuner's block-rows chooser joins this against the
    measured copy bandwidth; it is the block-granularity sibling of
    :func:`reshard_stats`'s ``bytes_padding`` accounting."""
    n_rows = max(1, int(n_rows))
    block_rows = max(1, int(block_rows))
    n_shards = max(1, int(n_shards))
    per_shard = -(-n_rows // n_shards)             # ceil
    n_blocks = -(-per_shard // block_rows)
    padded = n_blocks * block_rows * n_shards
    pad_rows = padded - n_rows
    return {"n_blocks": int(n_blocks),
            "rows_per_shard": int(per_shard),
            "padded_rows": int(padded),
            "pad_rows": int(pad_rows),
            "waste_fraction": float(pad_rows) / float(padded),
            "block_bytes": int(block_rows) * int(row_bytes)}



# ------------------------------------------------- registered tables
#
# Every model's placement, as the JAX package registers it
# (``tpu_distalg/parallel/partition.py:755-862``).

_D, _M = DATA_AXIS, MODEL_AXIS

#: LR, plain SSGD, the SGD family's replicated center
TABLE_LR = register(RuleTable("lr", (
    (r"^(w|weights|delta)$", ()),
    (r"^(res|residual)$", (_D, None)),
    (r"^(X2?|X_data)$", (_D, None)),
    (r"^(y|mask|valid)$", (_D,)),
    (r"^(X_test|y_test|accs?|acc0?|clocks?|pend|basegen|stale)$", ()),
)))

#: plain SSGD: LR's layout plus the per-shard SSP window carries
TABLE_SSGD = register(RuleTable("ssgd", (
    (r"^(wl|accd|ws)$", (_D, None)),
) + TABLE_LR.rules))

#: the tp split: packed rows over data × model, weights over model
TABLE_SSGD_TP = register(RuleTable("ssgd_tp", (
    (r"^(X2?|X_data)$", (_D, _M)),
    (r"^(w|weights)$", (_M,)),
    (r"^(res|residual)$", (_D, None)),
    (r"^(y|mask|valid)$", (_D,)),
    (r"^(X_test|y_test|accs?|acc0?)$", ()),
)))

#: feature-sharded bernoulli SSGD: the tp split's placement
TABLE_SSGD_FEATURE_SHARDED = register(
    RuleTable("ssgd_feature_sharded", TABLE_SSGD_TP.rules))

#: the local-update family: a replicated center, per-replica models
TABLE_LOCAL_SGD = register(RuleTable("local_sgd", (
    (r"^(ws|res|residual)$", (_D, None)),
    (r"^(w|weights|delta)$", ()),
    (r"^(X2?|X_data)$", (_D, None)),
    (r"^(y|mask|valid)$", (_D,)),
    (r"^(X_test|y_test|accs?|acc0?|clocks?|stale)$", ()),
)))
for _alias in ("ma", "bmuf", "easgd"):
    register(RuleTable(_alias, TABLE_LOCAL_SGD.rules))

#: k-means: points over data, centres replicated
TABLE_KMEANS = register(RuleTable("kmeans", (
    (r"^(points|X2|m2)$", (_D, None)),
    (r"^(mask|valid)$", (_D,)),
    (r"^(centers|n_seen)$", ()),
)))

#: ALS training: ratings and user factors over data, item factors over
#: model (``fit`` pads n so this always engages); ``V0``, V at a
#: segment's entry, replicated
TABLE_ALS_TRAIN = register(RuleTable("als_train", (
    (r"^(R|U)$", (_D, None)),
    (r"^V0$", ()),
    (r"^V$", (_M, None)),
)))

#: ALS serving: user factors replicated, item factors over model;
#: reshard('als_train' → 'als_serve') is the train→serve seam
TABLE_ALS_SERVE = register(RuleTable("als_serve", (
    (r"^U$", ()),
    (r"^V$", (_M, None)),
)))

#: the dense transitive closure: the path matrix over data
TABLE_CLOSURE = register(RuleTable("closure_dense", (
    (r"^(paths|edges)$", (_D, None)),
)))

#: PageRank: edge and plan arrays over data, ranks and degrees replicated
TABLE_PAGERANK = register(RuleTable("pagerank", (
    (r"^(src|dst|w_e|emask|gbase|sbase|base)$", (_D,)),
    (r"^(src_lane|src_row|dst_row|dst_lane|row|lane)$", (_D, None)),
    (r"^(ranks|inv_deg|has_out)$", ()),
)))

#: cluster-sharded PageRank: the rank vector row-partitioned
TABLE_PAGERANK_CLUSTER = register(RuleTable("pagerank_cluster", (
    (r"^ranks$", (_D,)),
    (r"^(deg|inv_deg|has_out)$", ()),
)))

#: streamed SSGD's eval operands, replicated
TABLE_SSGD_STREAM = register(RuleTable("ssgd_stream", (
    (r"^(X_test|y_test)$", ()),
) + TABLE_LR.rules))

#: the reshard pairs the system exercises (train→serve; the 2-D SSGD
#: layouts to and from pure data parallelism)
RESHARD_PAIRS = (
    ("als_train", "als_serve"),
    ("als_serve", "als_train"),
    ("ssgd_feature_sharded", "ssgd"),
    ("ssgd", "ssgd_feature_sharded"),
)
