"""The sync schedules of the SGD family, on the emulated data axis.

Port of ``tpu_distalg/parallel/comms.py``: the schedules behind one
:class:`CommSync` (``:104-790``), their closed-form byte accounting and
telemetry (``:792-958``), the numpy host codecs (``:960-1131``), the
candidate merge and the ring all-gather that serving rides
(``:248-290``, ``:1134-1178``).

Schedules (every one deterministic and bitwise replayable):

  ``dense``     each leaf summed over the shards in shard order
                (:func:`tree_allreduce_sum`), the default;
  ``bucketed``  the flat vector in buckets, each reduced by the ring:
                n−1 reduce-scatter steps, then an all-gather;
  ``hier``      the ring inside each of g groups, the groups' partial
                chunks added in group order, then the gather;
  ``bf16``      each leaf cast to bfloat16, summed, cast back;
  ``int8``      per bucket, seeded stochastic rounding to int8 against
                the shards' shared max-abs scale, the chunks' int8
                codes added exactly in int32 at their owner, a second
                seeded rounding there, and the int8 gather;
  ``topk``      the k largest |·| of (gradient + residual) per shard,
                combined by :func:`sparse_allreduce`; the rest carried
                as the error-feedback residual.

A shard's buffers are rows of a shard-major stack on one device, as in
:func:`ring_allgather`. A collective is the same arithmetic in the same
order over that stack: the ring's block b, for one, is reduced as
x₍b₊ₙ₋₁₎ + (… + (x₍b₊₁₎ + x_b)), the order in which it travels round
the JAX package's ring, and each ring step is one op over the whole
stack. Nothing crosses a link on one card: ``bytes_wire`` in
:meth:`CommSync.stats` is the ring model's count of what each shard
would send (``2·B·(n−1)/n`` for an all-reduce of B bytes at the wire
precision), not bytes that moved. The JAX package's double-buffered
bucket pipeline overlaps a bucket's exchange with the previous bucket's
unpacking; on one stream there is nothing to overlap, so ``@seq`` and
the pipeline issue the same ops (:func:`_pipelined_buckets`) and agree
bitwise by construction.

Compression applies to float leaves with more than one element; scalars
and integer leaves (counts) always go dense.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpu_distalg_torch.parallel.collectives import tree_allreduce_sum
from tpu_distalg_torch.parallel.mesh import DATA_AXIS
from tpu_distalg_torch.utils import prng

SCHEDULES = ("dense", "bucketed", "hier", "bf16", "int8", "topk")

#: float leaves with more elements than this are compressed; the rest
#: (and every integer leaf) go dense
MIN_COMPRESS_ELEMS = 1
#: int8's rounding draws are made for a group of consecutive syncs at
#: once: at most this many syncs, and about this many words a group
NOISE_GROUP_SYNCS, NOISE_WORDS_PER_GROUP = 256, 1 << 22


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """One run's schedule and knobs (JAX ``comms.py:146-215``).

    ``parse`` takes the CLI spelling: a schedule with an optional
    ``:arg`` — ``topk:0.01`` (kept fraction), ``bucketed:65536``
    (elements a bucket), ``hier:2`` (groups; 0 = infer), ``int8:7``
    (rounding seed; ``int8:7:4096`` also sets the bucket) — and an
    optional ``@seq`` (``@ov``, the default, spelled out) suffix."""

    schedule: str = "dense"
    bucket_elems: int = 1 << 16
    topk_fraction: float = 0.01
    hier_groups: int = 0
    seed: int = 0
    overlap: bool = True

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"unknown comm schedule {self.schedule!r}; want one of "
                f"{', '.join(SCHEDULES)}")
        if not (0.0 < self.topk_fraction <= 1.0):
            raise ValueError(
                f"topk_fraction must be in (0, 1], got "
                f"{self.topk_fraction}")
        if self.bucket_elems < 1:
            raise ValueError(
                f"bucket_elems must be >= 1, got {self.bucket_elems}")

    @classmethod
    def parse(cls, text: str | "CommSpec" | None) -> "CommSpec":
        if isinstance(text, cls):
            return text
        if not text:
            return cls()
        text = str(text)
        kw = {}
        if text.endswith("@seq"):
            text, kw["overlap"] = text[: -len("@seq")], False
        elif text.endswith("@ov"):
            text = text[: -len("@ov")]
        name, _, arg = text.partition(":")
        if arg:
            if name == "topk":
                kw["topk_fraction"] = float(arg)
            elif name == "bucketed":
                kw["bucket_elems"] = int(arg)
            elif name == "hier":
                kw["hier_groups"] = int(arg)
            elif name == "int8":
                seed, _, bucket = arg.partition(":")
                kw["seed"] = int(seed)
                if bucket:
                    kw["bucket_elems"] = int(bucket)
            else:
                raise ValueError(
                    f"comm schedule {name!r} takes no argument "
                    f"(got {text!r})")
        return cls(schedule=name, **kw)

    @property
    def stateful(self) -> bool:
        """Whether the schedule carries error-feedback residuals."""
        return self.schedule == "topk"


def _axis_size(mesh, axis_name: str) -> int:
    if axis_name == DATA_AXIS:
        return int(mesh.n_data)
    return int(mesh.n_model)


def infer_groups(mesh, axis_name: str = DATA_AXIS) -> int:
    """Groups for ``hier``. The emulated mesh has no slices or host
    processes to read (JAX ``comms.py:218``), so the JAX package's flat
    rule applies: 2 when the axis is even and larger than 2, else 1."""
    n = _axis_size(mesh, axis_name)
    return 2 if n % 2 == 0 and n > 2 else 1


def leaf(shape, dtype=torch.float32) -> torch.Tensor:
    """An example leaf for :func:`make_sync` (shape and dtype only)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _eligible(x) -> bool:
    return x.dtype.is_floating_point and x.numel() > MIN_COMPRESS_ELEMS


def ring_allgather(per_shard):
    """``per_shard``: one tuple of buffers per shard, in shard order →
    the tuple of shard-major ``(S, …)`` stacks, row j shard j's buffer,
    as the JAX package's origin-placed ring leaves it on every shard
    (``comms.py:248-290``)."""
    per_shard = [tuple(bufs) for bufs in per_shard]
    if not per_shard:
        raise ValueError("ring_allgather needs at least one shard")
    if len({len(bufs) for bufs in per_shard}) != 1:
        raise ValueError("shards hold different numbers of buffers")
    return tuple(torch.stack(leaf_) for leaf_ in zip(*per_shard))


#: the ring's gather order by (n, device), made once
_RING_ORDERS: dict = {}


def _ring_fold(blocks: torch.Tensor) -> torch.Tensor:
    """The ring's reduce-scatter order over a shard-major stack:
    ``blocks`` (n, n, …) holds shard i's block b at [i, b]; block b
    ends up reduced as x₍b₊ₙ₋₁₎ + (… + (x₍b₊₁₎ + x_b)), where JAX's
    ``_ring_allreduce`` leaves it (at shard b − 1). One gather puts
    step j's operands of every block in row j, then n − 1 adds."""
    n = blocks.shape[0]
    key = (n, str(blocks.device))
    order = _RING_ORDERS.get(key)
    if order is None:
        ar = torch.arange(n)
        order = _RING_ORDERS[key] = (((ar[:, None] + ar[None, :]) % n) * n
                                     + ar[None, :]).reshape(-1).to(
                                         blocks.device)
    y = blocks.reshape((n * n,) + blocks.shape[2:]).index_select(
        0, order).view(blocks.shape)
    acc = y[0]
    for j in range(1, n):
        acc = y[j] + acc
    return acc


def _ring_allreduce(v: torch.Tensor) -> torch.Tensor:
    """JAX ``comms.py:293``: ``v`` (n, …, n·chunk), row i shard i's flat
    vector → the ring all-reduce (…, n·chunk) every shard holds."""
    n = v.shape[0]
    if n == 1:
        return v[0]
    blocks = v.unflatten(-1, (n, -1)).movedim(-2, 1)   # (n, n_b, …, chunk)
    return _ring_fold(blocks).movedim(0, -2).flatten(-2)


def _hier_allreduce(v: torch.Tensor, g: int) -> torch.Tensor:
    """JAX ``comms.py:344``: ``v`` (n, …, m·chunk) over g groups of
    m = n/g shards (shard G·m + L): the ring inside each group, the
    owned chunks of the g groups added in group order (from zero, as
    JAX accumulates them), then the all-gathers."""
    n = v.shape[0]
    m = n // g
    if m == 1 or g == 1:
        return _ring_allreduce(v)
    blocks = v.unflatten(-1, (m, -1)).movedim(-2, 1)   # (n, m_b, …, chunk)
    per_group = blocks.unflatten(0, (g, m))            # (g, m, m_b, …)
    parts = [_ring_fold(per_group[G]) for G in range(g)]
    own = torch.zeros_like(parts[0])
    for p in parts:
        own = own + p
    return own.movedim(0, -2).flatten(-2)


def _scatter_add_ordered(out: torch.Tensor, idx: torch.Tensor,
                         vals: torch.Tensor, *, unique: bool = False
                         ) -> torch.Tensor:
    """``out.at[idx].add(vals)`` in the order XLA applies the updates:
    duplicates of one index are added one after another in their order
    in ``idx``. Each round adds the r-th occurrence of every index, so
    no round writes an index twice and no float atomics run."""
    idx = idx.to(torch.int64)
    if unique:
        out[idx] = out[idx] + vals
        return out
    order = torch.argsort(idx, stable=True)
    s = idx[order]
    pos = torch.arange(s.numel(), device=idx.device)
    new = torch.ones_like(s, dtype=torch.bool)
    new[1:] = s[1:] != s[:-1]
    start = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                         dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r
        i = idx[sel]
        out[i] = out[i] + vals[sel]
    return out


def sparse_allreduce(vals: torch.Tensor, idx: torch.Tensor, length: int, *,
                     unique: bool = False) -> torch.Tensor:
    """JAX ``comms.py:419``: every shard's (value, index) pairs, as
    shard-major (S, k) stacks → the dense (length,) sum, the shards'
    pairs added in origin order (shard 0 first) onto zeros. Duplicate
    indices within a shard add one after another (``unique=True`` skips
    the check when there are none, as for a top-k's pairs)."""
    out = torch.zeros((length,), dtype=vals.dtype, device=vals.device)
    for j in range(vals.shape[0]):
        out = _scatter_add_ordered(out, idx[j], vals[j], unique=unique)
    return out


def _pipelined_buckets(buckets, exchange, finish, overlap: bool,
                       compute=None):
    """JAX ``comms.py:456``: ``finish(exchange(buckets))`` over every
    bucket at once (``buckets`` (S, n_buckets, bucket)), and the
    ``compute`` thunk of sync-independent trainer math: after the
    exchange is issued (``overlap``, as JAX evaluates it next to the
    first in-flight bucket) or before it (``@seq``). On one stream the
    two orders issue the same ops; the results are equal bitwise.
    Returns ``(outputs, aux)``."""
    if not overlap:
        aux = compute() if compute is not None else None
        return finish(exchange(buckets)), aux
    inflight = exchange(buckets)
    aux = compute() if compute is not None else None
    return finish(inflight), aux


class CommSync:
    """One sync point's schedule (JAX ``comms.py:504``), built from the
    spec, the mesh and an example tuple of leaves, called once a sync
    round with every shard's leaves.

    ``reduce(per_shard, res, t)`` → ``(summed, res_new)``: ``per_shard``
    one tuple of leaves per shard, ``summed`` the one tuple every shard
    holds after the sync, ``res`` the (n_shards, ef_elems) float32
    error-feedback residual (``None`` or zero-width for stateless
    schedules). ``t`` is the absolute sync id, folded into the int8
    rounding keys so a resumed run replays the same noise."""

    def __init__(self, spec: CommSpec, mesh, example, *,
                 axis_name: str = DATA_AXIS):
        self.spec = spec
        self.axis_name = axis_name
        self.n_shards = _axis_size(mesh, axis_name)
        self.groups = spec.hier_groups or infer_groups(mesh, axis_name)
        if self.spec.schedule == "hier" and self.n_shards % self.groups:
            raise ValueError(
                f"hier: {self.groups} groups do not divide the "
                f"'{axis_name}' axis size {self.n_shards}")
        leaves = list(example)
        self._noise = None          # int8's draws for a group of syncs
        self._eligible_mask = [_eligible(x) for x in leaves]
        self._sizes = [int(np.prod(tuple(x.shape))) for x in leaves]
        self.ef_elems = sum(
            s for s, e in zip(self._sizes, self._eligible_mask) if e)

    @property
    def stateful(self) -> bool:
        return self.spec.stateful and self.ef_elems > 0

    def init_state(self) -> np.ndarray:
        """Host zero residual (n_shards, ef_elems), zero-width for
        stateless schedules, so every comm run keeps one layout."""
        width = self.ef_elems if self.stateful else 0
        return np.zeros((self.n_shards, width), np.float32)

    def reduce(self, per_shard, res=None, t=0, compute=None):
        """Allreduce-sum under the schedule → ``(summed, res_new)``, or
        ``(summed, res_new, compute())`` with a ``compute`` thunk."""
        per_shard = [tuple(x) for x in per_shard]
        if len(per_shard) != self.n_shards:
            raise ValueError(f"CommSync built for {self.n_shards} shards, "
                             f"got {len(per_shard)}")
        if self.spec.schedule == "dense" or self.n_shards == 1:
            out = tree_allreduce_sum(per_shard)
            if compute is None:
                return out, res
            return out, res, compute()
        return self._reduce_split(per_shard, res, t, compute)

    def reduce_mean(self, per_shard, res=None, t=0, compute=None):
        """Allreduce-mean: ``dense`` sums and divides; ``topk``
        compresses x/n so the residual tracks the mean's scale; the
        others sum under the schedule, then divide."""
        # XLA divides by the constant n as a product with its float32
        # reciprocal, and so does the port (on the card, torch would too)
        inv = 1.0 / self.n_shards
        if self.spec.schedule == "dense" or self.n_shards == 1:
            ret = self.reduce(per_shard, res, t, compute)
            return (tuple(x * inv for x in ret[0]),) + tuple(ret[1:])
        if self.spec.schedule == "topk":
            scaled = [tuple(x * inv for x in leaves) for leaves in per_shard]
            return self._reduce_split(scaled, res, t, compute)
        ret = self._reduce_split([tuple(x) for x in per_shard], res, t,
                                 compute)
        return (tuple(x * inv for x in ret[0]),) + tuple(ret[1:])

    def _reduce_split(self, per_shard, res, t, compute=None):
        """The ineligible leaves summed dense, the eligible ones through
        the schedule."""
        if len(self._eligible_mask) != len(per_shard[0]):
            raise ValueError(
                f"CommSync built for {len(self._eligible_mask)} leaves,"
                f" got {len(per_shard[0])}")
        comp = [[x for x, e in zip(leaves, self._eligible_mask) if e]
                for leaves in per_shard]
        comp_out, res_new, aux = self._run_schedule(comp, res, t, compute)
        dense = [i for i, e in enumerate(self._eligible_mask) if not e]
        dense_out = dict(zip(dense, tree_allreduce_sum(
            tuple(leaves[i] for i in dense) for leaves in per_shard))
            if dense else ())
        it = iter(comp_out)
        out = tuple(next(it) if e else dense_out[i]
                    for i, e in enumerate(self._eligible_mask))
        return (out, res_new) if compute is None else (out, res_new, aux)

    def _run_schedule(self, comp, res, t, compute=None):
        sched = self.spec.schedule
        shapes = [tuple(x.shape) for x in comp[0]]
        dtypes = [x.dtype for x in comp[0]]
        sizes = [int(np.prod(s)) for s in shapes]
        dev = comp[0][0].device

        def unflatten(v):
            out, off = [], 0
            for shape, dt, sz in zip(shapes, dtypes, sizes):
                out.append(v[off:off + sz].reshape(shape).to(dt))
                off += sz
            return out

        if sched == "bf16":
            # bf16 on the wire; XLA adds the bf16 values in float32 in
            # shard order and rounds the sum to bf16 once
            aux = compute() if compute is not None else None
            out = []
            for i, dt in enumerate(dtypes):
                acc = comp[0][i].to(torch.bfloat16).to(torch.float32)
                for leaves in comp[1:]:
                    acc = acc + leaves[i].to(torch.bfloat16).to(
                        torch.float32)
                out.append(acc.to(torch.bfloat16).to(dt))
            return out, res, aux

        flat = torch.stack([
            torch.cat([x.to(torch.float32).reshape(-1) for x in leaves])
            for leaves in comp])                       # (S, e)

        if sched == "topk":
            flat = flat + res.to(dev)
            k = max(1, int(round(self.spec.topk_fraction
                                 * max(1, self.ef_elems))))
            # lax.top_k keeps the lower index on ties: a stable sort
            order = torch.sort(flat.abs(), dim=1, descending=True,
                               stable=True).indices
            idx = order[:, :k]
            vals = torch.gather(flat, 1, idx)
            aux = compute() if compute is not None else None
            out = sparse_allreduce(vals, idx, flat.shape[1], unique=True)
            contrib = torch.zeros_like(flat).scatter_(1, idx, vals)
            return unflatten(out), flat - contrib, aux

        if sched in ("bucketed", "hier", "int8"):
            n = self.n_shards
            g = self.groups if sched == "hier" else 1
            m = max(1, n // g)
            n_blocks = m if (sched == "hier" and m > 1 and g > 1) else n
            e = flat.shape[1]
            if sched in ("bucketed", "int8"):
                n_buckets = max(1, math.ceil(e / self.spec.bucket_elems))
            else:
                n_buckets = 1
            bucket = n_blocks * math.ceil(
                max(1, e) / (n_buckets * n_blocks))
            pad = n_buckets * bucket - e
            buckets = torch.nn.functional.pad(flat, (0, pad)).view(
                n, n_buckets, bucket)
            if sched == "int8":
                exchange, finish = self._int8_bucket_ring(bucket, t, dev)
            else:
                def exchange(b):
                    return (_ring_allreduce(b) if sched == "bucketed"
                            else _hier_allreduce(b, g))

                def finish(b):
                    return b

            out, aux = _pipelined_buckets(
                buckets, exchange, finish, self.spec.overlap, compute)
            return unflatten(out.reshape(-1)[:e]), res, aux

        raise AssertionError(f"unreachable schedule {sched!r}")

    def _int8_noise(self, t: int, nb: int, bucket: int, dev):
        """The int8 ring's uniforms of sync ``t``: ``u`` (S, NB, bucket),
        shard j's bucket i under ``fold_in(key_j, 2i)``, and ``u2`` (NB,
        S, bucket/S), chunk c's under ``fold_in(key_c, 2i + 1)``, with
        ``key_j = fold_in(fold_in(key(seed), t), j)``. A draw's values
        depend only on its key and counter, so the syncs of a group are
        drawn at once (a few hundred torch ops a group, not a sync) and
        equal one-at-a-time draws bitwise. The first sync draws only its
        own; later ones a group at a time."""
        n = self.n_shards
        chunk = bucket // n
        words = 2 * n * nb * bucket
        group = max(1, min(NOISE_GROUP_SYNCS, NOISE_WORDS_PER_GROUP // words))
        tag = (nb, bucket, str(dev))
        c = self._noise
        if c is None:
            group = 1               # a lone sync draws only its own
        if c is None or c[0] != tag or not c[1] <= t < c[1] + len(c[2]):
            ts = torch.arange(t, t + group, dtype=torch.int64, device=dev)
            keys = prng.fold_in(
                prng.fold_in(prng.key(self.spec.seed, dev), ts)[:, None, :],
                torch.arange(n, device=dev))                 # (G, S, 2)
            two_i = 2 * torch.arange(nb, device=dev)
            u = prng.uniform(prng.fold_in(keys[:, :, None, :], two_i),
                             (bucket,))                  # (G, S, NB, bucket)
            u2 = prng.uniform(prng.fold_in(keys[:, None, :, :],
                                           (two_i + 1)[:, None]),
                              (chunk,))                  # (G, NB, S, chunk)
            c = self._noise = (tag, t, u, u2)
        return c[2][t - c[1]], c[3][t - c[1]]

    def _int8_bucket_ring(self, bucket: int, t, dev):
        """The native int8 ring (JAX ``comms.py:713-765``) over every
        bucket at once. ``exchange``: the scale is the max over shards
        of max|b| over 127 (at least 1e-30); shard j rounds its bucket i
        with ``uniform(fold_in(key_j, 2i))``, ``key_j =
        fold_in(fold_in(key(seed), t), j)``; chunk c of every shard
        goes to shard c, whose int32 sum is exact; shard c rounds it
        again with ``fold_in(key_c, 2i + 1)`` (:meth:`_int8_noise`).
        ``finish``: the int8 codes times n·scale. XLA writes both
        divisions by a constant (by 127, by n) as products with the
        float32 reciprocal; so does the port, on the CPU and the card."""
        n = self.n_shards
        chunk = bucket // n

        def exchange(b):
            nb = b.shape[1]
            u, u2 = self._int8_noise(int(t), nb, bucket, dev)
            scale = torch.clamp_min(
                b.abs().amax(dim=(0, 2)) * (1.0 / 127.0),
                1e-30)                                           # (NB,)
            q = torch.clamp(torch.floor(b / scale[None, :, None] + u),
                            -127, 127).to(torch.int8)
            s_int = q.view(n, nb, n, chunk).to(torch.int32).sum(dim=0)
            q2 = torch.clamp(
                torch.floor(s_int.to(torch.float32) * (1.0 / n) + u2),
                -127, 127).to(torch.int8)
            return q2, scale

        def finish(carry):
            q2, scale = carry
            return (q2.to(torch.float32)
                    * (scale * float(n))[:, None, None]).reshape(
                        q2.shape[0], -1)

        return exchange, finish

    def stats(self) -> dict:
        """Per-sync byte accounting (:func:`schedule_stats`): the ring
        model's per-shard wire bytes at the schedule's precision, the
        float32 logical payload and the collective rounds."""
        dense_elems = sum(
            s for s, e in zip(self._sizes, self._eligible_mask) if not e)
        return schedule_stats(
            self.spec.schedule, n_shards=self.n_shards,
            compressible_elems=self.ef_elems, dense_elems=dense_elems,
            bucket_elems=self.spec.bucket_elems,
            topk_fraction=self.spec.topk_fraction, groups=self.groups)


def schedule_stats(schedule: str, *, n_shards: int,
                   compressible_elems: int, dense_elems: int = 0,
                   bucket_elems: int = 1 << 16,
                   topk_fraction: float = 0.01,
                   groups: int = 1) -> dict:
    """JAX ``comms.py:792``: the closed-form per-sync bytes and rounds of
    one schedule under the ring model."""
    n = n_shards
    ce = compressible_elems
    ring = 2.0 * (n - 1) / n if n > 1 else 0.0
    b_logical = 4 * (ce + dense_elems)
    dense_wire = 4 * dense_elems * ring
    if schedule == "dense" or n == 1:
        wire = 4 * ce * ring + dense_wire
        rounds = 1
    elif schedule == "bf16":
        wire = 2 * ce * ring + dense_wire
        rounds = 1 + (1 if dense_elems else 0)
    elif schedule == "int8":
        nb = max(1, math.ceil(max(1, ce) / bucket_elems))
        wire = ce * ring + 4 * nb * ring + dense_wire
        rounds = 3 * nb + (1 if dense_elems else 0)
    elif schedule == "topk":
        k = max(1, int(round(topk_fraction * max(1, ce))))
        wire = 8 * k * (n - 1) + dense_wire
        rounds = 1 + (1 if dense_elems else 0)
    elif schedule == "bucketed":
        wire = 4 * ce * ring + dense_wire
        rounds = max(1, math.ceil(max(1, ce) / bucket_elems)) \
            + (1 if dense_elems else 0)
    elif schedule == "hier":
        g = max(1, groups)
        m = max(1, n // g)
        ici = 4 * ce * (2.0 * (m - 1) / m if m > 1 else 0.0)
        dcn = 4 * (ce / m) * (2.0 * (g - 1) / g if g > 1 else 0.0)
        wire = ici + dcn + dense_wire
        rounds = 3 + (1 if dense_elems else 0)
    else:  # pragma: no cover
        raise AssertionError(schedule)
    return {"bytes_wire": int(round(wire)),
            "bytes_logical": int(round(b_logical)),
            "rounds": int(rounds)}


def make_sync(spec, mesh, example, *, axis_name: str = DATA_AXIS):
    """A :class:`CommSync` from a :class:`CommSpec` or its CLI string."""
    return CommSync(CommSpec.parse(spec), mesh, example,
                    axis_name=axis_name)


def emit_sync_counters(sync: CommSync, n_syncs: int) -> dict:
    """Bump the ``comm.*`` counters for ``n_syncs`` syncs (no-op without
    telemetry); returns the per-sync stats."""
    from tpu_distalg_torch.telemetry import events as tevents

    st = sync.stats()
    tevents.counter("comm.bytes_wire", st["bytes_wire"] * n_syncs)
    tevents.counter("comm.bytes_logical", st["bytes_logical"] * n_syncs)
    tevents.counter("comm.rounds", st["rounds"] * n_syncs)
    tevents.counter("comm.syncs", n_syncs)
    return st


def rank_combine_stats(k: int, length: int, n: int) -> dict:
    """JAX ``comms.py:871``: bytes of a window-sparse vector combine
    (``8k(n−1)``) beside the dense ring's and the logical payload."""
    ring = 2.0 * (n - 1) / n if n > 1 else 0.0
    return {
        "bytes_wire": int(8 * k * max(0, n - 1)),
        "bytes_dense_ring": int(round(4 * length * ring)),
        "bytes_logical": int(4 * length),
        "rounds": 1,
    }


def emit_rank_combine_counters(k: int, length: int, n: int, *,
                               n_syncs: int = 1,
                               combine: str = "sparse") -> dict:
    """Bump the counters of ``n_syncs`` rank combines; returns the
    per-sync accounting (no-op without telemetry)."""
    from tpu_distalg_torch.telemetry import events as tevents

    st = rank_combine_stats(k, length, n)
    wire = (st["bytes_wire"] if combine == "sparse"
            else st["bytes_dense_ring"])
    tevents.counter("comm.bytes_wire", wire * n_syncs)
    tevents.counter("comm.bytes_logical", st["bytes_logical"] * n_syncs)
    tevents.counter("comm.rounds", st["rounds"] * n_syncs)
    tevents.counter("comm.syncs", n_syncs)
    tevents.counter("graph.combine_bytes_wire", wire * n_syncs)
    tevents.counter("graph.combine_bytes_dense_ring",
                    st["bytes_dense_ring"] * n_syncs)
    tevents.counter("graph.combine_syncs", n_syncs)
    return st


# ------------------------------------------------ the numpy host codecs
#
# JAX ``comms.py:924-1131``: the schedules' host spelling, pure functions
# of (spec.seed, the caller's integer path), so every process rebuilds
# the same bytes. ``encode(vec)`` compresses ``vec + residual`` and
# returns the new residual when the caller carries one.

#: seed-path direction tags of a push and of a pull
PUSH_SEED_TAG = 1
PULL_SEED_TAG = 2


def host_rng(seed: int, *path: int) -> np.random.Generator:
    """A counter-based generator keyed by ``(seed, path...)`` (Philox
    under a SeedSequence)."""
    ss = np.random.SeedSequence(
        entropy=int(seed) & 0xFFFFFFFFFFFFFFFF,
        spawn_key=tuple(int(p) & 0xFFFFFFFF for p in path))
    return np.random.Generator(np.random.Philox(ss))


class HostCodec:
    """Base: a stateless vector codec; the residual rides the caller."""

    name = "?"

    def __init__(self, spec: "CommSpec"):
        self.spec = spec

    def encode(self, vec: np.ndarray, residual: np.ndarray | None,
               *path: int):
        """``(arrays, residual_new)`` for one float32 vector."""
        raise NotImplementedError

    def decode(self, arrays: dict, length: int) -> np.ndarray:
        """The dense float32 ``(length,)`` reconstruction."""
        raise NotImplementedError


class Int8HostCodec(HostCodec):
    """Seeded stochastic rounding to int8 against a max-abs scale."""

    name = "int8"

    def encode(self, vec, residual, *path):
        x = np.asarray(vec, np.float32)
        if residual is not None:
            x = x + residual
        scale = np.float32(max(float(np.max(np.abs(x)))
                               if x.size else 0.0, 1e-30) / 127.0)
        u = host_rng(self.spec.seed, *path).random(
            x.shape, dtype=np.float32)
        q = np.clip(np.floor(x / scale + u), -127, 127).astype(np.int8)
        arrays = {"q": q, "scale": np.full((1,), scale, np.float32)}
        res_new = (x - q.astype(np.float32) * scale
                   if residual is not None else None)
        return arrays, res_new

    def decode(self, arrays, length):
        q = np.asarray(arrays["q"])
        wide = q.astype(np.int32)
        return (wide.astype(np.float32)
                * np.float32(arrays["scale"])).reshape(length)


class TopkHostCodec(HostCodec):
    """The k largest-|·| entries as (value, index) pairs."""

    name = "topk"

    def k_for(self, length: int) -> int:
        return max(1, int(round(self.spec.topk_fraction
                                * max(1, length))))

    def encode(self, vec, residual, *path):
        x = np.asarray(vec, np.float32)
        if residual is not None:
            x = x + residual
        k = self.k_for(x.size)
        idx = np.argsort(-np.abs(x), kind="stable")[:k].astype(np.int32)
        vals = x[idx]
        arrays = {"vals": vals, "idx": idx}
        if residual is None:
            return arrays, None
        res_new = x.copy()
        res_new[idx] = 0.0
        return arrays, res_new

    def decode(self, arrays, length):
        out = np.zeros((length,), np.float32)
        np.add.at(out, np.asarray(arrays["idx"], np.int64),
                  np.asarray(arrays["vals"], np.float32))
        return out


#: the schedules a host wire takes
HOST_SCHEDULES = ("dense", "int8", "topk")


def make_host_codec(spec) -> HostCodec | None:
    """The host codec of a spec, ``None`` for ``dense``."""
    spec = CommSpec.parse(spec)
    if spec.schedule not in HOST_SCHEDULES:
        raise ValueError(
            f"comm schedule {spec.schedule!r} has no host-wire "
            f"codec; the cluster tier takes one of "
            f"{', '.join(HOST_SCHEDULES)}")
    if spec.schedule == "int8":
        return Int8HostCodec(spec)
    if spec.schedule == "topk":
        return TopkHostCodec(spec)
    return None


def make_host_pull_codec(spec) -> HostCodec | None:
    """The pull direction's codec: int8 under every compressed mode
    (``None`` for dense)."""
    spec = CommSpec.parse(spec)
    return (None if make_host_codec(spec) is None
            else Int8HostCodec(spec))


def encode_tree(codec: HostCodec, tree: dict,
                residuals: dict | None, *path: int):
    """Per-leaf host encode of a flat ``{name: ndarray}`` tree under
    seed path ``(*path, leaf_index)`` → ``(arrays, residuals_new)``."""
    arrays: dict = {}
    res_new: dict | None = None if residuals is None else {}
    for i, name in enumerate(sorted(tree)):
        leaf_ = np.asarray(tree[name], np.float32).ravel()
        res = None if residuals is None else residuals.get(
            name, np.zeros_like(leaf_))
        parts, r = codec.encode(leaf_, res, *path, i)
        for part, arr in parts.items():
            arrays[f"{name}.{part}"] = arr
        if res_new is not None:
            res_new[name] = r
    return arrays, res_new


def decode_tree(codec: HostCodec, arrays: dict,
                template: dict) -> dict:
    """Inverse of :func:`encode_tree` under a shape template."""
    out = {}
    for name in sorted(template):
        shape = np.asarray(template[name]).shape
        length = int(np.prod(shape, dtype=np.int64)) if shape else 1
        prefix = f"{name}."
        parts = {k[len(prefix):]: v for k, v in arrays.items()
                 if k.startswith(prefix)}
        out[name] = codec.decode(parts, length).reshape(shape)
    return out


def merge_topk_pairs_host(all_vals, all_idx, *, k: int):
    """The numpy spelling of ``ops.topk.merge_topk_pairs``: (S, B, K)
    shard-major stacks of (value, index) pairs → the global top k of
    each row, value descending, ties toward the lower index."""
    v = np.moveaxis(np.asarray(all_vals, np.float32), 0, 1)
    i = np.moveaxis(np.asarray(all_idx, np.int32), 0, 1)
    B = v.shape[0]
    v = v.reshape(B, -1)
    i = i.reshape(B, -1)
    out_v = np.empty((B, k), np.float32)
    out_i = np.empty((B, k), np.int32)
    for b in range(B):
        # lexsort: the LAST key is primary — (-value asc, index asc)
        order = np.lexsort((i[b], -v[b]))[:k]
        out_v[b] = v[b][order]
        out_i[b] = i[b][order]
    return out_v, out_i


def zero_residuals(template: dict) -> dict:
    """Fresh residuals for a tree template: one flat float32 zero vector
    per leaf."""
    return {name: np.zeros(
        int(np.prod(np.asarray(template[name]).shape,
                    dtype=np.int64)), np.float32)
        for name in template}


def emit_overlap_counters(hidden_ms: float, comm_ms: float) -> None:
    """Bump ``comm.overlap_hidden_ms`` and ``comm.sync_ms`` (no-op
    without telemetry)."""
    from tpu_distalg_torch.telemetry import events as tevents

    tevents.counter("comm.overlap_hidden_ms",
                    max(0, int(round(hidden_ms))))
    tevents.counter("comm.sync_ms", max(0, int(round(comm_ms))))
