"""Fault-seam coverage — raw durable writes in library code (TDA030).

PR 3 wired deterministic fault injection at seven seams, and the chaos
suite's guarantee ("every recovery path provably recovers") is only as
exhaustive as those seams: a new ``open(..., 'w')`` or ``os.replace``
that bypasses them is durable-state mutation the chaos schedule can
never reach — the coverage rots silently as code grows. This rule makes
the seam set self-policing: any raw write/rename in ``tpu_distalg_torch/``
must sit in a function that also routes through ``faults.inject`` (the
blessed atomic-publish helpers — ``utils/checkpoint.save``,
``data/cache.build_cache`` — already do).
"""

from __future__ import annotations

import ast

from tpu_distalg_torch.analysis.engine import PKG, Rule, call_name

#: modes that create/overwrite durable bytes ('a' append is the
#: telemetry event log's mode and is not an atomic-publish concern)
_WRITE_MODE_CHARS = ("w", "x")


def _write_mode(call: ast.Call) -> str | None:
    """The mode string of an ``open`` call when it writes, else None."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
            and any(c in mode.value for c in _WRITE_MODE_CHARS):
        return mode.value
    return None


def _has_inject(fn) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name is not None \
                    and name.rsplit(".", 1)[-1] == "inject":
                return True
    return False


class RawDurableWrite(Rule):
    code = "TDA030"
    name = "raw durable write outside a fault seam"
    invariant = (f"every durable-state mutation in {PKG}/ routes "
                 "through a faults.inject seam or a blessed "
                 "atomic-publish helper, so chaos coverage stays "
                 "exhaustive")

    def applies(self, ctx):
        # the analysis package itself is host-side dev tooling (it
        # writes baselines and applies fixes); it never runs inside a
        # chaos schedule, so its writes are not seam-coverage gaps
        return ctx.is_library and "/analysis/" not in ctx.path

    def check(self, ctx):
        yield from self._scan(ctx, ctx.tree, covered=False)

    def _scan(self, ctx, node, covered):
        for child in ast.iter_child_nodes(node):
            child_covered = covered
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                child_covered = covered or _has_inject(child)
            if isinstance(child, ast.Call):
                name = call_name(child)
                if name == "open" and not covered:
                    mode = _write_mode(child)
                    if mode is not None:
                        yield self.violation(
                            ctx, child,
                            f"raw open(..., {mode!r}) outside any "
                            f"faults.inject seam — route durable "
                            f"writes through utils/checkpoint.save, "
                            f"data/cache.build_cache, or add an "
                            f"injection point so chaos schedules can "
                            f"reach this write")
                elif name in ("os.replace", "os.rename") \
                        and not covered:
                    yield self.violation(
                        ctx, child,
                        f"{name}() outside any faults.inject seam — "
                        f"a publish/rename the chaos suite cannot "
                        f"exercise; use the blessed atomic-publish "
                        f"helpers or add an injection point")
            yield from self._scan(ctx, child, child_covered)


RULES = (RawDurableWrite(),)
