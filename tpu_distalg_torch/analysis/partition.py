"""Partition-engine coverage (TDA080) — no raw sharding construction
in model or serving code.

The partition-rule engine (``parallel/partition.py``) is the single
place a model's placement lives: one registered :class:`RuleTable` per
model, matched over named pytree leaves, with the generated
place/gather/reshard functions carrying the layout AND the byte
accounting. A hand-built ``NamedSharding`` (or a bare ``PartitionSpec``
fed to a placement op) added to a model afterwards is a layout the
rule table never names: the 2-D ``--mesh-shape`` config can't re-shape
it, ``reshard`` can't plan over it, and the golden-hash placement pins
don't cover it — the exact per-model hand-rolling the engine replaced.
TDA080 keeps ``tpu_distalg_torch/models/`` and ``tpu_distalg_torch/serve/`` clean:
placement goes through ``partition.put`` / ``place`` / ``ensure`` /
``leaf_sharding`` (or stays inside ``parallel/``), never through raw
construction.

Flagged shapes (in ``models/`` and ``serve/``)::

    NamedSharding(mesh, P('data'))          # raw sharding construction
    jax.sharding.NamedSharding(mesh, spec)
    jax.device_put(x, some_sharding)        # hand placement (2+ args)
    jax.device_put(x, device=s)             # keyword spelling
    PositionalSharding(...)                 # any sharding ctor family
    with_sharding_constraint(x, P('data'))  # bare spec into a
                                            #   placement op

Fine::

    partition.put(x, 'w', 'ssgd', mesh)     # the engine owns it
    partition.leaf_sharding('als_train', 'V', mesh)
    shard_map(f, mesh, in_specs=(P('data'),), out_specs=P())
                                            # program specs, not
                                            #   placement — unflagged
    jax.device_put(x)                       # bare staging, no layout
    lax.with_sharding_constraint(x, rows)   # a name bound from the
                                            #   engine — unflagged
"""

from __future__ import annotations

import ast

from tpu_distalg_torch.analysis.engine import PKG, Rule, call_name, pkg_dir

#: sharding constructors whose appearance in model/serve code IS the
#: violation (wherever the result flows)
_SHARDING_CTORS = ("NamedSharding", "PositionalSharding",
                   "GSPMDSharding", "SingleDeviceSharding")

#: placement ops: the second positional arg (or ``device=``) names a
#: layout — exactly what must come from a rule table
_PLACEMENT_OPS = ("device_put", "with_sharding_constraint")


def _tail(name: str | None) -> str | None:
    return None if name is None else name.rsplit(".", 1)[-1]


class RawShardingInModels(Rule):
    code = "TDA080"
    name = "raw sharding construction outside the partition engine"
    invariant = (f"every placement in {PKG}/models/ and "
                 f"{PKG}/serve/ routes through the partition-rule "
                 "engine (parallel/partition.py — put/place/ensure/"
                 "leaf_sharding over a registered RuleTable), so one "
                 "rule table names each model's layout, 2-D meshes "
                 "stay a --mesh-shape config, and reshard plans/"
                 "accounts every layout change")

    def applies(self, ctx):
        return (pkg_dir("models") in ctx.path
                or pkg_dir("serve") in ctx.path)

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _tail(call_name(node))
            if name in _SHARDING_CTORS:
                yield self.violation(
                    ctx, node,
                    f"raw {name}(...) in model/serve code — placement "
                    f"belongs to a registered rule table; use "
                    f"partition.put/place/ensure, or "
                    f"partition.leaf_sharding(table, leaf, mesh) when "
                    f"a sharding object itself is needed")
                continue
            if name in _PLACEMENT_OPS:
                yield from self._check_placement(ctx, node, name)

    def _check_placement(self, ctx, call: ast.Call, name: str):
        """``device_put(x, s)`` / ``with_sharding_constraint(x, s)``:
        an explicit layout arg is a hand placement UNLESS it is an
        engine call (``partition.*``). A bare name (``rows``) is
        allowed for ``with_sharding_constraint`` only — inside-jit
        constraint code legitimately closes over an engine-derived
        sharding — while ``device_put`` with ANY explicit layout must
        spell the engine call at the site (restored-state re-puts are
        exactly where hand layouts creep back in)."""
        layout = call.args[1] if len(call.args) >= 2 else None
        if layout is None:
            for kw in call.keywords:
                # device_put spells it device=/sharding=,
                # with_sharding_constraint spells it shardings=
                if kw.arg in ("device", "sharding", "shardings"):
                    layout = kw.value
                    break
        if layout is None:
            return  # bare staging: no layout named
        if isinstance(layout, ast.Call):
            lname = call_name(layout) or ""
            if lname.split(".")[0] == "partition":
                return  # engine-derived at the site
            # any other call producing the layout (a spec ctor, a
            # sharding ctor, a local helper) is a hand placement
            yield self.violation(
                ctx, call,
                f"{name}() with a hand-built layout — derive it "
                f"from the rule table instead "
                f"(partition.put/ensure, or partition."
                f"leaf_sharding(table, leaf, mesh))")
            return
        if name == "device_put":
            yield self.violation(
                ctx, call,
                "device_put() with an explicit layout in model/serve "
                "code — route the placement through the partition "
                "engine (partition.put/place/ensure) so the rule "
                "table stays the single owner of this model's layout")


RULES = (RawShardingInModels(),)
