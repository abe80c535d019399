"""Determinism rules — the bitwise-replay contract (TDA001, TDA002).

PR 3's chaos harness asserts a recovered run is BITWISE-equal to an
undisturbed one, and PR 2's cache format requires content to be a pure
function of the header. Both die the moment library code reads wall
clock into a value, draws from an unseeded RNG, or lets hash/filesystem
iteration order leak into anything emitted.
"""

from __future__ import annotations

import ast

from tpu_distalg_torch.analysis import engine
from tpu_distalg_torch.analysis.engine import Rule, call_name

#: wall-clock reads that poison a replayed value (time.monotonic /
#: perf_counter measure DURATIONS and are fine)
_WALL_CLOCK = {
    "time.time", "time.time_ns",
    "datetime.now", "datetime.datetime.now",
    "datetime.utcnow", "datetime.datetime.utcnow",
    "datetime.today", "datetime.datetime.today",
    "date.today", "datetime.date.today",
}

#: the module-level (hidden-global-state, unseedable-per-call) random API
_RANDOM_FNS = {
    "random", "randint", "randrange", "uniform", "shuffle", "choice",
    "choices", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "vonmisesvariate", "seed", "getrandbits",
}

#: np.random.X that IS the seeded API (everything else on np.random is
#: the legacy global-state interface)
_NP_SEEDED_OK = {
    "default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
    "MT19937", "BitGenerator",
}


class WallClockAndUnseededRandom(Rule):
    code = "TDA001"
    name = "wall-clock / unseeded RNG in library code"
    invariant = ("bitwise replay: every value a run produces must be a "
                 "function of (config, seed, step)")

    def applies(self, ctx):
        # library code only; telemetry OWNS wall-clock timestamps (they
        # annotate events, they never feed a computed value)
        return ctx.is_library and not ctx.is_telemetry

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            if name in _WALL_CLOCK:
                yield self.violation(
                    ctx, node,
                    f"{name}() in library code — wall clock voids the "
                    f"bitwise-replay contract; use time.monotonic()/"
                    f"perf_counter() for durations, or thread a "
                    f"timestamp in from the caller")
            elif name.startswith("random.") \
                    and name.split(".", 1)[1] in _RANDOM_FNS:
                yield self.violation(
                    ctx, node,
                    f"{name}() uses the process-global RNG — replay "
                    f"cannot reseed it per call site; use "
                    f"random.Random(seed) (or jax threefry keyed on "
                    f"the step)")
            elif (name.startswith("np.random.")
                  or name.startswith("numpy.random.")):
                fn = name.rsplit(".", 1)[1]
                if fn not in _NP_SEEDED_OK:
                    yield self.violation(
                        ctx, node,
                        f"{name}() is numpy's legacy global-state RNG; "
                        f"use np.random.default_rng(seed) so the draw "
                        f"is a function of an explicit seed")


#: iteration sources whose order is hash- or filesystem-dependent
_FILESYSTEM_CALLS = {"os.listdir", "listdir", "glob.glob",
                     "glob.iglob", "iglob"}
_HASH_CALLS = {"set", "frozenset"}
_UNORDERED_CALLS = _FILESYSTEM_CALLS | _HASH_CALLS


class UnorderedIteration(Rule):
    code = "TDA002"
    name = "unordered iteration feeding downstream order"
    invariant = ("collective and serialization order must not depend "
                 "on hash seed or filesystem enumeration order")

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.For, ast.AsyncFor)):
                continue
            found = self._unordered(node.iter)
            if found is not None:
                src, kind = found
                yield self.violation(
                    ctx, node,
                    f"iterating {src} — its order is {kind}-dependent "
                    f"and will differ across runs/hosts; wrap in "
                    f"sorted(...) when the order can reach a "
                    f"collective, a serialized artifact, or any "
                    f"emitted output")

    @staticmethod
    def _unordered(it) -> tuple[str, str] | None:
        if isinstance(it, (ast.Set, ast.SetComp)):
            return "a set literal", "hash"
        if isinstance(it, ast.Call):
            name = engine.call_name(it)
            if name in _FILESYSTEM_CALLS:
                return f"{name}(...)", "filesystem-enumeration"
            if name in _HASH_CALLS:
                return f"{name}(...)", "hash"
        return None


RULES = (WallClockAndUnseededRandom(), UnorderedIteration())
