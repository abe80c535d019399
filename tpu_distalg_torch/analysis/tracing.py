"""Trace-purity rules — jit bodies and hot step loops (TDA010, TDA011).

DrJAX-style MapReduce-in-JAX work (PAPERS.md) identifies trace-purity
mistakes as the dominant correctness hazard in JAX frameworks: a
``print`` or telemetry emit inside a ``jit``-decorated function runs
ONCE at trace time (then never again — the operator watches a silent
log and calls it a hang), and a mutation of nonlocal state from a
traced body bakes one trace's value into every later step. The sibling
hazard is performance-shaped: a host sync (``float``, ``np.asarray``,
``.item()``, ``.block_until_ready``) inside a per-step loop turns an
async dispatch pipeline into a lockstep crawl — the exact driver-loop
pathology this repo's bench exists to beat (one observed case: ~60
us/step of host round-trip charged to the device rate).
"""

from __future__ import annotations

import ast
import re

from tpu_distalg_torch.analysis.engine import (Rule, call_name,
                                         dotted_name, root_name)

#: decorator name tails that mean "this function body is traced"
_TRACED_TAILS = {"jit", "shard_map", "pallas_call"}

#: telemetry emitters (events.py API) — side effects at trace time
_TELEMETRY_BASES = {"tevents", "events", "telemetry"}
_TELEMETRY_FNS = {"emit", "mark", "counter", "gauge", "span", "bump",
                  "write"}

_STEP_NAME_RE = re.compile(
    r"^(n_|num_)?(steps?|iters?|iterations?|sweeps?|rounds?|epochs?)$",
    re.IGNORECASE)

#: host-sync calls by dotted name
_SYNC_CALLS = {"np.asarray", "numpy.asarray", "jax.device_get",
               "jax.block_until_ready"}
#: host-sync calls by method tail (any receiver)
_SYNC_METHODS = {"item", "block_until_ready"}


def _decorator_is_traced(dec) -> bool:
    """@jax.jit, @jit, @pl.pallas_call(...), @partial(jax.jit, ...)."""
    if isinstance(dec, ast.Call):
        name = call_name(dec)
        if name is not None and name.rsplit(".", 1)[-1] == "partial" \
                and dec.args:
            return _decorator_is_traced(dec.args[0])
        dec = dec.func
    name = None
    if isinstance(dec, (ast.Name, ast.Attribute)):
        name = dotted_name(dec)
    return name is not None and name.rsplit(".", 1)[-1] in _TRACED_TAILS


def _local_bindings(fn: ast.AST) -> set:
    """Names bound by plain assignment / for-targets / with-as inside
    ``fn`` (parameters excluded on purpose: arguments are the caller's
    objects — mutating them through a trace is exactly the bug)."""
    out: set[str] = set()
    for node in ast.walk(fn):
        targets = []
        if isinstance(node, (ast.Assign,)):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign,
                               ast.For, ast.AsyncFor)):
            targets = [node.target]
        elif isinstance(node, (ast.withitem,)) and node.optional_vars:
            targets = [node.optional_vars]
        elif isinstance(node, ast.comprehension):
            targets = [node.target]
        for t in targets:
            _bound_names(t, out)
    return out


def _bound_names(target, out: set) -> None:
    """Names BOUND by an assignment target. Recurses into tuple/list
    unpacking but stops at Attribute/Subscript — ``state['k'] = v``
    binds nothing, it mutates ``state``."""
    if isinstance(target, ast.Name):
        out.add(target.id)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            _bound_names(elt, out)
    elif isinstance(target, ast.Starred):
        _bound_names(target.value, out)


class TracedSideEffects(Rule):
    code = "TDA010"
    name = "Python side effect inside a traced function"
    invariant = ("jit/shard_map/pallas_call bodies run ONCE at trace "
                 "time — effects there are not per-step behavior")

    def check(self, ctx):
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if not any(_decorator_is_traced(d)
                       for d in fn.decorator_list):
                continue
            yield from self._check_body(ctx, fn)

    def _check_body(self, ctx, fn):
        local = _local_bindings(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name == "print":
                    yield self.violation(
                        ctx, node,
                        "print() inside a traced function runs once "
                        "at trace time, then never again — return the "
                        "value, or use jax.debug.print for per-step "
                        "output")
                elif name is not None and "." in name:
                    base, attr = name.rsplit(".", 1)
                    if base.split(".")[0] in _TELEMETRY_BASES \
                            and attr in _TELEMETRY_FNS:
                        yield self.violation(
                            ctx, node,
                            f"telemetry {name}() inside a traced "
                            f"function fires at trace time only — the "
                            f"event log would show one mark for N "
                            f"steps; emit from the host loop around "
                            f"the call instead")
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                kind = ("global" if isinstance(node, ast.Global)
                        else "nonlocal")
                yield self.violation(
                    ctx, node,
                    f"{kind} write from a traced function bakes one "
                    f"trace-time value into the compiled program; "
                    f"thread state through the function's "
                    f"arguments/returns")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        root = root_name(t)
                        if root is not None and root not in local:
                            yield self.violation(
                                ctx, t,
                                f"mutation of nonlocal object "
                                f"{root!r} inside a traced function "
                                f"happens at trace time, not per "
                                f"step; return the new value instead")


def _walk_pruning_defs(node):
    """Yield the loop body's nodes, skipping nested function/lambda
    SUBTREES — a deferred body does not execute per iteration."""
    stack = [node]
    while stack:
        cur = stack.pop()
        if cur is not node and isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                      ast.Lambda)):
            continue
        yield cur
        stack.extend(ast.iter_child_nodes(cur))


def _is_hot_loop(node, ctx) -> bool:
    if node.lineno in ctx.markers.hot_loops:
        return True
    if isinstance(node, (ast.For, ast.AsyncFor)) \
            and isinstance(node.iter, ast.Call) \
            and call_name(node.iter) == "range":
        for arg in node.iter.args:
            for leaf in ast.walk(arg):
                seg = None
                if isinstance(leaf, ast.Name):
                    seg = leaf.id
                elif isinstance(leaf, ast.Attribute):
                    seg = leaf.attr
                if seg is not None and _STEP_NAME_RE.match(seg):
                    return True
    return False


class HostSyncInHotLoop(Rule):
    code = "TDA011"
    name = "host sync inside a step loop"
    invariant = ("per-step host syncs serialize the dispatch pipeline "
                 "— sync at phase boundaries, not inside the loop")

    def applies(self, ctx):
        # tests sync to assert — that is their job
        return not ctx.is_test

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.For, ast.AsyncFor,
                                     ast.While)):
                continue
            if not _is_hot_loop(node, ctx):
                continue
            for sub in _walk_pruning_defs(node):
                if not isinstance(sub, ast.Call):
                    continue
                v = self._sync(ctx, sub)
                if v is not None:
                    yield v

    def _sync(self, ctx, call):
        name = call_name(call)
        if name == "float" and len(call.args) == 1 \
                and not isinstance(call.args[0], ast.Constant):
            return self.violation(
                ctx, call,
                "float() on a (device) value every step blocks on the "
                "transfer; accumulate device-side and format once at "
                "the phase boundary")
        if name in _SYNC_CALLS:
            return self.violation(
                ctx, call,
                f"{name}() inside a step loop forces a host sync per "
                f"iteration; hoist it to the segment/phase boundary")
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _SYNC_METHODS:
            return self.violation(
                ctx, call,
                f".{call.func.attr}() inside a step loop forces a "
                f"host sync per iteration; hoist it to the "
                f"segment/phase boundary")
        return None


RULES = (TracedSideEffects(), HostSyncInHotLoop())
