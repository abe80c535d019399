"""Seeded fault plans, compiled the way the JAX package compiles them.

Port of ``tpu_distalg/faults/registry.py`` (stdlib only there and here):
``POINTS`` and ``KINDS`` (``:138-199``), the defaults (``:199-202``),
the injected-error classes (``:205-222``), :class:`FaultRule`
(``:225``), :class:`FaultPlan` with its inline and JSON spellings
(``:273-326``), ``_point_seed`` (``:328``), :class:`FaultRegistry`
(``:333-480``) and the process-global ``configure`` / ``active`` /
``enabled`` / ``probe`` / ``inject`` (``:482-527``).

A plan compiles to the same firings as in the JAX package: the same
per-point seeds (``(seed << 20) ^ crc32(point)``), the same
``random.Random`` draws in the same order, one draw per invocation of a
point for each probability rule whether or not it fires, and the first
matching rule wins. Every seam fires on the invocation JAX's fires on,
so one plan fires the same faults in both packages:

  ``ckpt:write``      ``utils/checkpoint.save``: the npz body about to
                      reach the disk, in each supervised attempt (across
                      processes only process 0, the one writer, writes);
  ``ckpt:read``       ``utils/checkpoint.restore``: the bytes just read,
                      before the CRC check;
  ``cache:write``     ``data/cache.build_cache``, each attempt;
  ``data:gather``     ``data/sharded.py`` (a staged batch) and
                      ``serve/batcher.py`` (a micro-batch, on the leader);
  ``data:h2d``        ``data/sharded.py``, a batch's copy to the card;
  ``backend:init``    ``telemetry/supervisor.init_backend``, each attempt;
  ``segment:run``     before each segment of ``run_segmented`` and each
                      window segment of ``membership.run_elastic``;
  ``shard:straggle``, ``shard:leave``  probed by the SSP schedule
                      compilers (``parallel/ssp.py``, ``membership.py``);
  ``cluster:worker``  probed once per (window, slot) by
                      ``cluster/worker.compile_worker_schedule``
                      (``kill``, ``straggle``);
  ``cluster:rpc``     ``cluster/transport.py``'s framed send and receive
                      (``oserror``, ``hang``);
  ``cluster:coordinator``  probed once per window by
                      ``cluster/coordinator.compile_coordinator_schedule``
                      (``kill``, ``hang`` at the window's commit point);
  ``cluster:wal``     ``cluster/wal.py``'s append, on the encoded record
                      (``corrupt``, ``oserror``, ``hang``);
  ``cluster:replica``  ``cluster/serve.py``, a replica's score seam,
                      each scored frame (``kill``, ``hang``);
  ``cluster:ps``      probed once per window by
                      ``cluster/rowstore.compile_point_schedule`` (the
                      merge seam, after the commit record is durable).

Plan spec (``--fault-plan`` / ``$TDA_FAULT_PLAN``): a JSON file
(``{"seed": 42, "rules": [{"point": ..., "hit": 2|"*", "prob": 0.1,
"kind": ..., "arg": ...}]}``) or an inline string
``seed=7;ckpt:write@1=corrupt;segment:run@2=kill``. ``point@N=kind``
fires on the N-th invocation (0-based), ``@*`` on every one, ``@pP``
with probability P from the point's seeded generator.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
import zlib

from tpu_distalg_torch.telemetry import events as tevents

ENV_PLAN = "TDA_FAULT_PLAN"

POINTS = (
    "ckpt:write",
    "ckpt:read",
    "cache:write",
    "data:gather",
    "data:h2d",
    "backend:init",
    "segment:run",
    "shard:straggle",
    "shard:leave",
    "cluster:worker",
    "cluster:rpc",
    "cluster:coordinator",
    "cluster:wal",
    "cluster:replica",
    "cluster:ps",
)

KINDS = ("oserror", "hang", "corrupt", "kill", "straggle", "leave")

#: the scheduling kinds and the points that consume them
_SCHEDULING_KINDS = {"straggle": ("shard:straggle", "cluster:worker"),
                     "leave": ("shard:leave",)}

#: points that take only a restricted set of kinds
_POINT_KINDS = {
    "shard:straggle": ("straggle",),
    "shard:leave": ("leave",),
    "cluster:worker": ("straggle", "kill"),
    "cluster:rpc": ("oserror", "hang"),
    "cluster:coordinator": ("kill", "hang"),
    "cluster:wal": ("oserror", "hang", "corrupt"),
    "cluster:replica": ("kill", "hang"),
    "cluster:ps": ("kill", "hang"),
}

DEFAULT_HANG_SECONDS = 0.05
DEFAULT_CORRUPT_BYTES = 8
DEFAULT_STRAGGLE_UNITS = 200
DEFAULT_LEAVE_WINDOWS = 2


class InjectedOSError(OSError):
    """A scheduled transient I/O fault."""


class InjectedCorruptionError(InjectedOSError):
    """Scheduled in-flight corruption detected at the seam."""


class InjectedKill(RuntimeError):
    """The thread executing this work was killed."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """Fire ``kind`` at ``point`` when the invocation index matches
    ``hit`` (``None`` = every invocation) or, with ``prob``, with that
    probability from the point's seeded generator."""

    point: str
    kind: str
    hit: int | None = None
    prob: float | None = None
    arg: float | None = None

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r}; valid points: "
                f"{', '.join(POINTS)}")
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; valid kinds: "
                f"{', '.join(KINDS)}")
        if self.prob is not None and not 0.0 < self.prob <= 1.0:
            raise ValueError(
                f"fault probability must be in (0, 1], got {self.prob}")
        if self.hit is not None and self.hit < 0:
            raise ValueError(f"fault hit index must be >= 0, got {self.hit}")
        want_points = _SCHEDULING_KINDS.get(self.kind)
        if want_points is not None and self.point not in want_points:
            raise ValueError(
                f"scheduling kind {self.kind!r} fires at "
                f"{' / '.join(map(repr, want_points))} only "
                f"(got {self.point!r})")
        allowed = _POINT_KINDS.get(self.point)
        if allowed is not None and self.kind not in allowed:
            sched = all(k in _SCHEDULING_KINDS for k in allowed)
            raise ValueError(
                f"point {self.point!r} takes "
                f"{'scheduling ' if sched else ''}kinds only "
                f"({', '.join(allowed)}), got {self.kind!r}")

    def spec(self) -> str:
        where = (f"p{self.prob}" if self.prob is not None
                 else "*" if self.hit is None else str(self.hit))
        arg = f":{self.arg}" if self.arg is not None else ""
        return f"{self.point}@{where}={self.kind}{arg}"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed plus an ordered rule schedule."""

    seed: int = 0
    rules: tuple[FaultRule, ...] = ()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """An inline ``seed=..;point@hit=kind[:arg];..`` spec or a JSON
        plan file path (detected by existence or a ``.json`` suffix)."""
        spec = spec.strip()
        if spec.endswith(".json") or os.path.isfile(spec):
            with open(spec) as f:
                doc = json.load(f)
            rules = []
            for r in doc.get("rules", []):
                hit = r.get("hit")
                rules.append(FaultRule(
                    point=r["point"], kind=r["kind"],
                    hit=None if hit in (None, "*") else int(hit),
                    prob=(None if r.get("prob") is None
                          else float(r["prob"])),
                    arg=(None if r.get("arg") is None
                         else float(r["arg"]))))
            return cls(seed=int(doc.get("seed", 0)), rules=tuple(rules))
        seed = 0
        rules = []
        for term in (t.strip() for t in spec.split(";") if t.strip()):
            if term.startswith("seed="):
                seed = int(term[len("seed="):])
                continue
            try:
                where_part, kind_part = term.split("=", 1)
                point, where = where_part.rsplit("@", 1)
            except ValueError:
                raise ValueError(
                    f"bad fault-plan term {term!r}: want "
                    f"'point@hit=kind[:arg]' (hit = N, '*', or 'pP') "
                    f"or 'seed=N'") from None
            kind, _, arg = kind_part.partition(":")
            rules.append(FaultRule(
                point=point, kind=kind,
                hit=(None if where in ("*",) or where.startswith("p")
                     else int(where)),
                prob=(float(where[1:]) if where.startswith("p")
                      else None),
                arg=float(arg) if arg else None))
        return cls(seed=seed, rules=tuple(rules))

    def spec(self) -> str:
        """The canonical inline spelling (parse/spec round-trips)."""
        return ";".join([f"seed={self.seed}"]
                        + [r.spec() for r in self.rules])


def _point_seed(seed: int, point: str, hit: int | None = None) -> int:
    tag = point if hit is None else f"{point}#{hit}"
    return (seed << 20) ^ zlib.crc32(tag.encode())


class FaultRegistry:
    """The live injector for one :class:`FaultPlan`: per-point
    invocation counters, per-point seeded generators (probability
    rules) and the record of every fault fired (``fired``)."""

    def __init__(self, plan: FaultPlan, *, sleep=time.sleep,
                 quiet: bool = False):
        self.plan = plan
        self._sleep = sleep
        self._quiet = quiet  # no telemetry: the schedule compilers'
        #                      plan-pure scratch registries
        self._lock = threading.Lock()
        self._hits: dict[str, int] = {}
        self._rngs: dict[str, random.Random] = {}
        self.fired: list[tuple[str, int, str]] = []

    def _match(self, point: str, hit: int) -> FaultRule | None:
        """First matching rule for this invocation. Probability rules
        draw once per invocation of their point whether or not they
        fire, so the schedule is a function of the invocation order."""
        chosen = None
        for rule in self.plan.rules:
            if rule.point != point:
                continue
            if rule.prob is not None:
                rng = self._rngs.setdefault(point, random.Random(
                    _point_seed(self.plan.seed, point)))
                fires = rng.random() < rule.prob
            else:
                fires = rule.hit is None or rule.hit == hit
            if fires and chosen is None:
                chosen = rule
        return chosen

    def _consume(self, point: str):
        """One invocation of ``point``: bump, match, record, emit.
        Returns ``(rule | None, hit)``."""
        if point not in POINTS:
            raise ValueError(
                f"unknown injection point {point!r}; valid points: "
                f"{', '.join(POINTS)}")
        with self._lock:
            hit = self._hits.get(point, 0)
            self._hits[point] = hit + 1
            rule = self._match(point, hit)
            if rule is not None:
                self.fired.append((point, hit, rule.kind))
        if rule is not None and not self._quiet:
            tevents.emit("fault_injected", point=point, hit=hit,
                         kind=rule.kind, arg=rule.arg)
            tevents.counter("faults.injected")
            tevents.counter(f"faults.{rule.kind}")
        return rule, hit

    def probe(self, point: str):
        """Schedule-compilation seam: consume one invocation of
        ``point``; ``(kind, arg)`` when a rule fires, else ``None``."""
        rule, _ = self._consume(point)
        if rule is None:
            return None
        return rule.kind, rule.arg

    def inject(self, point: str, payload=None):
        """An injection point: returns ``payload`` (possibly corrupted);
        may raise or stall per the plan."""
        rule, hit = self._consume(point)
        if rule is None:
            return payload
        if rule.kind in _SCHEDULING_KINDS:
            return payload
        if rule.kind == "oserror":
            raise InjectedOSError(
                f"[fault] injected transient OSError at {point}#{hit}")
        if rule.kind == "hang":
            self._sleep(rule.arg if rule.arg is not None
                        else DEFAULT_HANG_SECONDS)
            return payload
        if rule.kind == "kill":
            raise InjectedKill(
                f"[fault] injected thread death at {point}#{hit}")
        if payload is None:
            raise InjectedCorruptionError(
                f"[fault] injected corruption detected in flight at "
                f"{point}#{hit}")
        return self._corrupt(point, hit, payload,
                             n_bytes=int(rule.arg or DEFAULT_CORRUPT_BYTES))

    def _corrupt(self, point: str, hit: int, payload, *, n_bytes: int):
        """Flip ``n_bytes`` bytes of ``payload`` at seed-deterministic
        positions."""
        buf = bytearray(payload)
        if not buf:
            return bytes(buf)
        rng = random.Random(_point_seed(self.plan.seed, point, hit))
        for _ in range(max(1, n_bytes)):
            buf[rng.randrange(len(buf))] ^= 0xFF
        return bytes(buf)

    def record(self, fires) -> list:
        """Mirror fires observed by a scratch registry into this one's
        ledger, skipping any already there (a recompilation of the same
        schedule); returns the newly recorded fires."""
        with self._lock:
            seen = set(self.fired)
            new = [f for f in fires if f not in seen]
            self.fired.extend(new)
        for point, hit, kind in new:
            tevents.emit("fault_injected", point=point, hit=hit,
                         kind=kind, arg=None)
            tevents.counter("faults.injected")
            tevents.counter(f"faults.{kind}")
        return new

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def summary(self) -> dict:
        with self._lock:
            return {"plan": self.plan.spec(),
                    "hits": dict(self._hits),
                    "fired": [{"point": p, "hit": h, "kind": k}
                              for p, h, k in self.fired]}


_LOCK = threading.Lock()
_REGISTRY: FaultRegistry | None = None


def configure(spec: str | FaultPlan | None | bool = None,
              *, sleep=time.sleep) -> FaultRegistry | None:
    """Select the process-global registry. ``spec=None`` falls back to
    ``$TDA_FAULT_PLAN``; unset or empty disables injection (the
    default); ``spec=False`` disables whatever the variable says. Each
    call starts a fresh registry."""
    global _REGISTRY
    if spec is False:
        plan = None
    elif isinstance(spec, FaultPlan):
        plan = spec
    else:
        raw = spec or os.environ.get(ENV_PLAN) or None
        plan = FaultPlan.parse(raw) if raw else None
    with _LOCK:
        _REGISTRY = FaultRegistry(plan, sleep=sleep) if plan else None
        return _REGISTRY


def active() -> FaultRegistry | None:
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY is not None


def inject(point: str, payload=None):
    """Module-level injection point: one global read with no plan."""
    reg = _REGISTRY
    if reg is None:
        return payload
    return reg.inject(point, payload)


def probe(point: str):
    """Module-level schedule probe: ``(kind, arg)`` when a rule fires on
    this invocation, else ``None`` (always ``None`` with no plan)."""
    reg = _REGISTRY
    if reg is None:
        return None
    return reg.probe(point)
