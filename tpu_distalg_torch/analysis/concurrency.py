"""Concurrency rules — thread targets and thread construction (TDA020,
TDA021).

Every background thread this repo runs (telemetry heartbeat, prefetch
producer, supervisor init worker, bench hard-deadline) follows two
conventions that were each earned the hard way: shared state written
from a thread body is written under a lock (the r5 bench's spliced
ADVICE summary was exactly an unlocked dual-writer), and every
``threading.Thread`` states ``daemon=`` explicitly (an inherited
non-daemon default once kept a finished run alive until an outside
SIGKILL — the difference between rc 0 and a timeout).
"""

from __future__ import annotations

import ast

from tpu_distalg_torch.analysis.engine import (Rule, call_name, dotted_name,
                                         root_name)


def _is_thread_call(call: ast.Call) -> bool:
    name = call_name(call)
    return name in ("threading.Thread", "Thread")


def _thread_entry_functions(tree: ast.Module):
    """(function node, how) pairs that run ON a thread: named
    ``target=`` of a Thread(...) call, or ``run`` methods of classes
    whose bases end in ``Thread``."""
    target_names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_thread_call(node):
            for kw in node.keywords:
                if kw.arg == "target" and isinstance(kw.value,
                                                     ast.Name):
                    target_names.add(kw.value.id)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            thread_base = any(
                (dotted_name(b) or "").rsplit(".", 1)[-1] == "Thread"
                for b in node.bases)
            if thread_base:
                for item in node.body:
                    if isinstance(item, ast.FunctionDef) \
                            and item.name == "run":
                        yield item, f"{node.name}.run"
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in target_names:
            yield node, f"Thread target {node.name}"


def _lockish(expr) -> bool:
    """``with self._lock: ...`` / ``with _EMIT_LOCK: ...`` — any name
    segment containing 'lock' (case-insensitive) counts; so does the
    ``.acquire()``-less ``with lock_for(x):`` helper shape."""
    for leaf in ast.walk(expr):
        seg = None
        if isinstance(leaf, ast.Name):
            seg = leaf.id
        elif isinstance(leaf, ast.Attribute):
            seg = leaf.attr
        if seg is not None and "lock" in seg.lower():
            return True
    return False


class UnlockedThreadWrite(Rule):
    code = "TDA020"
    name = "unlocked shared-state write from a thread body"
    invariant = ("state shared with a thread is written under a lock "
                 "or handed off through a queue — never bare")

    def check(self, ctx):
        for fn, how in _thread_entry_functions(ctx.tree):
            local = self._locals(fn)
            yield from self._scan(ctx, fn, how, local,
                                  under_lock=False)

    @staticmethod
    def _locals(fn) -> set:
        out = set()
        for node in ast.walk(fn):
            targets = []
            if isinstance(node, ast.Assign):
                targets = [t for t in node.targets
                           if isinstance(t, ast.Name)]
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign,
                                   ast.For)):
                if isinstance(node.target, ast.Name):
                    targets = [node.target]
            out.update(t.id for t in targets)
        return out

    def _scan(self, ctx, node, how, local, under_lock):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                continue
            locked = under_lock
            if isinstance(child, (ast.With, ast.AsyncWith)):
                if any(_lockish(item.context_expr)
                       for item in child.items):
                    locked = True
            if isinstance(child, (ast.Assign, ast.AugAssign)) \
                    and not locked:
                targets = (child.targets
                           if isinstance(child, ast.Assign)
                           else [child.target])
                for t in targets:
                    if not isinstance(t, (ast.Attribute,
                                          ast.Subscript)):
                        continue
                    root = root_name(t)
                    if root is None or root in local:
                        continue
                    yield self.violation(
                        ctx, t,
                        f"{how} writes shared state "
                        f"({ast.unparse(t)}) without a lock held in "
                        f"the enclosing scope — wrap in 'with "
                        f"<lock>:' or hand the value through a "
                        f"queue.Queue")
            yield from self._scan(ctx, child, how, local, locked)


class ImplicitThreadDaemon(Rule):
    code = "TDA021"
    name = "threading.Thread without explicit daemon="
    invariant = ("thread lifetime is stated, not inherited — a "
                 "non-daemon leftover blocks interpreter exit; a "
                 "daemon leftover dies mid-write")

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and _is_thread_call(node) \
                    and not any(kw.arg == "daemon"
                                for kw in node.keywords):
                yield self.violation(
                    ctx, node,
                    "threading.Thread(...) without daemon= — state "
                    "the lifetime explicitly (daemon=True: may die "
                    "mid-write at exit; daemon=False: must be "
                    "joined); `tda lint --fix` inserts daemon=False, "
                    "the inherited default")


RULES = (UnlockedThreadWrite(), ImplicitThreadDaemon())
