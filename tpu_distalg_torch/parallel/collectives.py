"""Sums over the mesh axes, in one process or across processes.

Port of ``tpu_distalg/parallel/collectives.py::tree_allreduce_sum``:
each shard's tuple of tensors is summed leaf by leaf in shard order
(0, 1, 2, …), which fixes the float rounding, so a run replays bitwise.
With one shard it returns the shard's own tensors. :func:`model_sum`
is the model axis's psum (``comms.psum(z, MODEL_AXIS)`` in the JAX
package's tensor-parallel SSGD): the slices' partial tensors added in
model order; the model axis never leaves a process.

Across processes (a mesh with ``distributed``) the rule holds for the
GLOBAL shards: a process sends its per-shard partials, never their
local sum, because ``((a+b)+c)+d`` is not ``(a+b)+(c+d)`` in float.
Each psum is one ``all_gather`` of one flat byte buffer holding every
leaf of this process's shards (:func:`gather_shards`); the pieces are
then added in global shard order on the device. So P processes × L
shards equal one process × P·L emulated shards bit for bit. The price
is that an all-gather carries D× the bytes of an allreduce; a
fixed-order reduce that sends less is later work. Under ``gloo`` a
device buffer crosses through a host copy that is made here and
counted, not through gloo's partial CUDA support; under ``nccl`` the
buffer stays on the card. :data:`COUNTERS` holds the collectives, the
bytes this process sent (``(P−1)·B`` for a buffer of B bytes) and the
host copies with their seconds.

The compressed schedules of :mod:`.comms` move less than the partials:
they run on :func:`permute`, one hop of a permutation of the global
shards (the JAX package's ``ppermute``), on :func:`ring_gather`
(``n−1`` hops of the ring s → s+1 mod n) and on :func:`all_to_all`. In
a hop, a buffer whose source and destination shard share a process
stays on the device; the buffers one process sends another travel as
one point-to-point message (``isend``/``irecv``, all posted before any
is waited on, each wait bounded by ``mesh.DEFAULT_TIMEOUT_S``). So on
the ring only the hop from a process's last shard to the next process's
first shard crosses. Every message is counted in :data:`COUNTERS`.
"""

from __future__ import annotations

import datetime
import time

import torch

#: this process's collectives since :func:`reset_counters`
COUNTERS = {"collectives": 0, "bytes_sent": 0, "host_copies": 0,
            "host_copy_seconds": 0.0}


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0.0 if k == "host_copy_seconds" else 0


def _exchange(buf: torch.Tensor, n_proc: int) -> list[torch.Tensor]:
    """Every process's uint8 ``buf`` (all of one size), in process order,
    on ``buf``'s device."""
    import torch.distributed as dist

    COUNTERS["collectives"] += 1
    COUNTERS["bytes_sent"] += buf.numel() * (n_proc - 1)
    if buf.device.type == "cpu" or dist.get_backend() == "nccl":
        out = [torch.empty_like(buf) for _ in range(n_proc)]
        dist.all_gather(out, buf)
        return out
    t0 = time.perf_counter()
    host = buf.cpu()
    COUNTERS["host_copy_seconds"] += time.perf_counter() - t0
    out = [torch.empty_like(host) for _ in range(n_proc)]
    dist.all_gather(out, host)
    t0 = time.perf_counter()
    back = torch.cat(out).to(buf.device)
    COUNTERS["host_copy_seconds"] += time.perf_counter() - t0
    COUNTERS["host_copies"] += 2
    return list(back.split(buf.numel()))


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def gather_shards(per_shard, mesh=None) -> list[tuple]:
    """Every global data shard's tuple of leaves, in global shard order.
    ``per_shard`` holds this process's shards (all of them without a
    process group); across processes their leaves travel in one flat
    buffer of one all-gather and come back as views of it."""
    per = [tuple(leaves) for leaves in per_shard]
    if mesh is None or not mesh.distributed:
        return per
    if len(per) != mesh.n_local:
        raise ValueError(f"this process holds {mesh.n_local} shards, got "
                         f"{len(per)} partials")
    buf, layout = _pack([x for leaves in per for x in leaves])
    n_leaves = len(per[0])
    out = []
    for b in _exchange(buf, mesh.process_count):
        flat = _unpack(b, layout)
        out += [tuple(flat[i:i + n_leaves])
                for i in range(0, len(flat), n_leaves)]
    return out


def tree_allreduce_sum(per_shard, mesh=None):
    """``per_shard``: one tuple of tensors per shard (this process's
    shards, with a ``mesh`` that spans processes) → the tuple of
    leafwise sums over every global shard, taken in shard order. Without
    a process group nothing is gathered: the shards are all here."""
    if mesh is not None and mesh.distributed:
        per_shard = gather_shards(per_shard, mesh)
    else:
        per_shard = list(per_shard)
    if not per_shard:
        raise ValueError("tree_allreduce_sum needs at least one shard")
    acc = list(per_shard[0])
    for leaves in per_shard[1:]:
        if len(leaves) != len(acc):
            raise ValueError("shards hold different numbers of leaves")
        acc = [a + b for a, b in zip(acc, leaves)]
    return tuple(acc)


def row_counts(n: int, mesh) -> list[int]:
    """Every process's count ``n`` (of rows, of pairs), in process
    order: one small all-gather (``[n]`` without a process group)."""
    if not mesh.distributed:
        return [int(n)]
    t = torch.tensor([int(n)], dtype=torch.int64, device=mesh.device)
    return [int(b.view(torch.int64)[0])
            for b in _exchange(_bytes(t), mesh.process_count)]


def rank0_first(mesh, build):
    """``build()`` in process 0 first, then in the others, which find
    what it made (a disk cache every process opens is written once, not
    raced); ``build()`` alone without a process group."""
    first = mesh.process_count == 1 or mesh.process_index == 0
    if not first:
        row_counts(0, mesh)            # process 0 has built
    out = build()
    if first and mesh.process_count > 1:
        row_counts(0, mesh)
    return out


def allgather_rows(x: torch.Tensor, mesh, *, uneven: bool = False
                   ) -> torch.Tensor:
    """A row-sharded tensor brought together: every process's rows
    along dim 0, in process order (this process's own rows without a
    process group). ``uneven``: the processes may hold different row
    counts, traded first (:func:`row_counts`); each block is padded to
    the largest for the gather and cut back after."""
    if not mesh.distributed:
        return x
    counts = (row_counts(x.shape[0], mesh) if uneven
              else [x.shape[0]] * mesh.process_count)
    rows = max(counts)
    if rows == 0 or 0 in tuple(x.shape[1:]):
        return x.new_empty((sum(counts),) + tuple(x.shape[1:]))
    if x.shape[0] < rows:
        x = torch.cat([x, x.new_zeros((rows - x.shape[0],)
                                      + tuple(x.shape[1:]))])
    shape = (rows,) + tuple(x.shape[1:])
    bufs = _exchange(_bytes(x), mesh.process_count)
    return torch.cat([b.view(x.dtype).reshape(shape)[:c]
                      for b, c in zip(bufs, counts)])


def broadcast_bytes(buf: torch.Tensor | None, nbytes: int, mesh,
                    src: int = 0) -> torch.Tensor:
    """Process ``src``'s flat uint8 ``buf`` of ``nbytes`` bytes on every
    process (``buf`` is ignored elsewhere; the same ``nbytes`` is given
    everywhere). Host buffers go over gloo as they are; under NCCL
    they cross on the card. Counted in :data:`COUNTERS`: the source
    sends ``(P−1)·nbytes``."""
    import torch.distributed as dist

    if not mesh.distributed or mesh.process_count == 1:
        return buf
    on_card = dist.get_backend() == "nccl"
    where = mesh.device if on_card else torch.device("cpu")
    if mesh.process_index == src:
        t = buf.to(where).contiguous()
        COUNTERS["bytes_sent"] += t.numel() * (mesh.process_count - 1)
    else:
        t = torch.empty((nbytes,), dtype=torch.uint8, device=where)
    COUNTERS["collectives"] += 1
    dist.broadcast(t, src)
    return t.cpu() if on_card else t


def model_sum(per_slice):
    """``per_slice``: one tensor per model slice → their sum, added in
    model order 0, 1, …"""
    (total,) = tree_allreduce_sum((t,) for t in per_slice)
    return total


# --------------------------------------------- point-to-point hops


def _pack(leaves) -> tuple[torch.Tensor, list]:
    """``leaves`` as one flat uint8 buffer, each leaf after the first
    starting at a multiple of the widest leaf's item size (so its view
    of the bytes is aligned), and the layout to cut it back
    (:func:`packed_nbytes` counts its bytes)."""
    align = max(x.element_size() for x in leaves)
    parts, layout = [], []
    for i, x in enumerate(leaves):
        b = _bytes(x)
        parts.append(b)
        pad = (-b.numel()) % align if i + 1 < len(leaves) else 0
        if pad:
            parts.append(b.new_zeros(pad))
        layout.append((tuple(x.shape), x.dtype, b.numel(), b.numel() + pad))
    return (parts[0] if len(parts) == 1 else torch.cat(parts)), layout


def packed_nbytes(leaves) -> int:
    """The bytes :func:`_pack` makes of leaves of (bytes, item size)."""
    align = max(isz for _, isz in leaves)
    return sum(nb + ((-nb) % align if i + 1 < len(leaves) else 0)
               for i, (nb, _) in enumerate(leaves))


def _unpack(buf: torch.Tensor, layout: list) -> list[torch.Tensor]:
    out, off = [], 0
    for shape, dtype, nb, stride in layout:
        out.append(buf[off:off + nb].view(dtype).reshape(shape))
        off += stride
    return out


def send_recv(sends: dict, recvs: dict, device) -> dict:
    """Point-to-point: ``sends[q]`` a flat uint8 buffer for process q,
    ``recvs[q]`` the bytes expected from process q → ``{q: uint8
    buffer on device}``. Every send and receive is posted before any is
    waited on, so no order of the processes deadlocks; each wait fails
    after ``mesh.DEFAULT_TIMEOUT_S``. Under gloo a card's buffers go
    through counted host copies; under NCCL they stay on the card."""
    import torch.distributed as dist

    from tpu_distalg_torch.parallel.mesh import DEFAULT_TIMEOUT_S

    if not sends and not recvs:
        return {}
    staged = device.type != "cpu" and dist.get_backend() != "nccl"
    where = torch.device("cpu") if staged else device
    COUNTERS["collectives"] += 1
    works, keep = [], []
    for q in sorted(sends):
        buf = sends[q]
        if staged:
            t0 = time.perf_counter()
            buf = buf.cpu()
            COUNTERS["host_copy_seconds"] += time.perf_counter() - t0
            COUNTERS["host_copies"] += 1
        COUNTERS["bytes_sent"] += buf.numel()
        keep.append(buf)
        works.append(dist.isend(buf, q))
    got = {}
    for q in sorted(recvs):
        got[q] = torch.empty((recvs[q],), dtype=torch.uint8, device=where)
        works.append(dist.irecv(got[q], q))
    wait = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    for w in works:
        w.wait(wait)
    del keep
    if staged:
        for q in got:
            t0 = time.perf_counter()
            got[q] = got[q].to(device)
            COUNTERS["host_copy_seconds"] += time.perf_counter() - t0
            COUNTERS["host_copies"] += 1
    return got


#: the routing of a permutation by (n_data, process layout, perm,
#: device), its row indices on the device
_PLANS: dict = {}


def _plan(mesh, perm: tuple, dev) -> tuple:
    """``(local_src, local_dst, sends, recvs)`` of one hop: the local
    rows that stay in this process and where they land, the rows sent
    to each other process (ascending source shard) and the rows each
    other process's message fills (the same order), as index tensors on
    ``dev`` (``local_src`` None when no row stays)."""
    key = (mesh.n_data, mesh.process_count, mesh.process_index, perm,
           str(dev))
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    n, L, base = mesh.n_data, mesh.n_local, mesh.local_data.start
    if sorted(perm) != list(range(n)):
        raise ValueError(f"not a permutation of {n} shards: {perm}")
    me = mesh.process_index
    local_src, local_dst, sends, recvs = [], [], {}, {}
    for s, d in enumerate(perm):
        src_here, dst_here = s // L == me, d // L == me
        if src_here and dst_here:
            local_src.append(s - base)
            local_dst.append(d - base)
        elif src_here:
            sends.setdefault(d // L, []).append(s - base)
        elif dst_here:
            recvs.setdefault(s // L, []).append(d - base)

    def idx(rows):
        return torch.as_tensor(rows, dtype=torch.int64, device=dev)

    plan = _PLANS[key] = (
        idx(local_src) if local_src else None, idx(local_dst),
        {q: idx(r) for q, r in sends.items()},
        {q: idx(r) for q, r in recvs.items()})
    return plan


def permute(bufs, mesh, perm) -> tuple:
    """One hop: ``bufs`` a tuple of (L, …) stacks, row i global shard
    ``local_data[i]``'s buffer; global shard s's buffers go to shard
    ``perm[s]`` → the tuple of stacks each shard of this process
    received. Across processes the rows one process sends another
    travel as one message (:func:`send_recv`); the rest is a copy on
    the device."""
    bufs = tuple(bufs)
    perm = tuple(int(d) for d in perm)
    if not mesh.distributed:
        inv = [0] * len(perm)
        for s, d in enumerate(perm):
            inv[d] = s
        idx = torch.as_tensor(inv, device=bufs[0].device)
        return tuple(b.index_select(0, idx) for b in bufs)
    dev = bufs[0].device
    local_src, local_dst, sends, recvs = _plan(mesh, perm, dev)
    out = [torch.empty_like(b) for b in bufs]
    if local_src is not None:
        for o, b in zip(out, bufs):
            o.index_copy_(0, local_dst, b.index_select(0, local_src))
    packed, layouts = {}, {}
    for q, rows in sends.items():
        packed[q], _ = _pack([b.index_select(0, rows) for b in bufs])
    for q, rows in recvs.items():
        _, layouts[q] = _pack([b[:rows.numel()] for b in bufs])
    got = send_recv(packed, {q: sum(s for *_, s in lay)
                              for q, lay in layouts.items()}, dev)
    for q, rows in recvs.items():
        for o, x in zip(out, _unpack(got[q], layouts[q])):
            o.index_copy_(0, rows, x)
    return tuple(out)


def ring_perm(n: int) -> tuple:
    """The ring s → (s + 1) mod n."""
    return tuple((s + 1) % n for s in range(n))


def shard_ids(mesh, device) -> torch.Tensor:
    """This process's global data shard ids (every shard without a
    process group), as a tensor."""
    ids = mesh.local_data if mesh.distributed else range(mesh.n_data)
    return torch.as_tensor(list(ids), dtype=torch.int64, device=device)


def ring_gather(bufs, mesh) -> tuple:
    """The JAX package's origin-placed ring all-gather
    (``comms.py:239-290``) across processes: ``bufs`` a tuple of (L, …)
    stacks of this process's shards → the tuple of (n, …) stacks, row j
    global shard j's buffer, equal on every shard. ``n−1`` hops of the
    ring; each hop sends one buffer over each process boundary."""
    bufs = tuple(bufs)
    n = mesh.n_data
    ids = shard_ids(mesh, bufs[0].device)
    outs = [b.new_zeros((n,) + tuple(b.shape[1:])) for b in bufs]
    for o, b in zip(outs, bufs):
        o[ids] = b
    cur = bufs
    for s in range(n - 1):
        cur = permute(cur, mesh, ring_perm(n))
        src = (ids - s - 1) % n
        for o, c in zip(outs, cur):
            o[src] = c
    return tuple(outs)


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (L, n, …): row i's piece j goes from this process's shard
    ``local_data[i]`` to global shard j → (n, L, …): piece [j, i] came
    from global shard j to local shard i. Across processes each pair of
    processes trades one message of L·L pieces."""
    if not mesh.distributed:
        return x
    n, L = mesh.n_data, x.shape[0]
    base, P, me = mesh.local_data.start, mesh.process_count, \
        mesh.process_index
    out = x.new_empty((n, L) + tuple(x.shape[2:]))
    out[base:base + L] = x[:, base:base + L]
    sends = {q: _bytes(x[:, q * L:(q + 1) * L])
             for q in range(P) if q != me}
    got = send_recv(sends, {q: sends[q].numel() for q in sends}, x.device)
    for q, buf in got.items():
        out[q * L:(q + 1) * L] = buf.view(x.dtype).reshape(
            (L, L) + tuple(x.shape[2:]))
    return out


def allreduce_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max of ``x`` over the processes (``lax.pmax``):
    one small all-gather; the max is exact in any order."""
    if not mesh.distributed:
        return x
    return allgather_rows(x.reshape(1, -1).contiguous(), mesh).amax(
        dim=0).reshape(x.shape)
