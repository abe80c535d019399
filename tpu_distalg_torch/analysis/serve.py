"""Serving liveness discipline (TDA060).

The serving layer's availability contract is structural: the request
queue is BOUNDED (a full queue sheds with ``ServeOverloadError`` —
backpressure the client can see — instead of growing until the host
OOMs under overload), and no thread ever blocks on a queue without a
timeout (the dispatch loop must keep observing its stop flag, and a
wedged producer must surface as a timeout, not a silent hang — the same
lesson ``data/pipeline.Prefetcher``'s liveness guard encodes). One
forgotten ``queue.Queue()`` or bare ``.get()`` silently voids both;
TDA060 makes the convention machine-checked for ``tpu_distalg_torch/serve/``
and the distributed serving plane (``cluster/serve.py``,
``cluster/router.py``), which carries the identical contract over TCP.

Flagged shapes::

    queue.Queue()                  # unbounded — grows until OOM
    queue.Queue(0) / Queue(-1)     # maxsize <= 0 is spelled-out
    queue.Queue(maxsize=0)         #   unbounded per the queue docs
    q.get()                        # blocks forever
    q.get(True) / q.get(1)         # explicit block, still no timeout
    q.get(block=True)
    q.get(timeout=None)            # spelled-out block-forever

Fine::

    queue.Queue(maxsize=depth)     # bounded
    q.get(timeout=POLL_SECONDS)    # bounded wait
    q.get_nowait() / q.get(block=False) / q.get(0)
    d.get(key) / d.get(key, default)   # dict.get — non-numeric key
                                       # or two positional args
"""

from __future__ import annotations

import ast

from tpu_distalg_torch.analysis.engine import PKG, Rule, call_name, pkg_dir


def _is_queue_ctor(call: ast.Call) -> bool:
    name = call_name(call)
    return name in ("queue.Queue", "Queue", "queue.LifoQueue",
                    "LifoQueue", "queue.PriorityQueue", "PriorityQueue")


def _maxsize_arg(call: ast.Call):
    """The ctor's maxsize expression, or None when omitted."""
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "maxsize":
            return kw.value
    return None


def _static_value(expr):
    """The expression's numeric value when statically decidable
    (constants and negated constants — ``Queue(-1)`` parses as a
    UnaryOp, not a Constant), else None for dynamic expressions."""
    if isinstance(expr, ast.Constant) and \
            isinstance(expr.value, (bool, int, float)):
        return expr.value
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.USub) \
            and isinstance(expr.operand, ast.Constant) \
            and isinstance(expr.operand.value, (int, float)):
        return -expr.operand.value
    return None


class ServeLivenessDiscipline(Rule):
    code = "TDA060"
    name = "unbounded queue / blocking get without timeout in serve/"
    invariant = ("serving stays live under overload: request queues "
                 "are bounded (full = shed, never grow-until-OOM) and "
                 "every blocking queue get carries a timeout so stop "
                 "flags and wedged producers are always observable")

    def applies(self, ctx):
        # the serving PLANE, not just the serve/ package: the cluster
        # router and replica modules carry the same bounded-queue /
        # observable-stop availability contract over TCP
        if pkg_dir("serve") in ctx.path:
            return True
        return ctx.path.endswith((f"{PKG}/cluster/serve.py",
                                  f"{PKG}/cluster/router.py"))

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if _is_queue_ctor(node):
                size = _maxsize_arg(node)
                # queue docs: maxsize <= 0 means INFINITE — so a
                # statically non-positive size (0, -1, …) is the
                # unbounded shape too, not just an omitted arg
                val = None if size is None else _static_value(size)
                unbounded = size is None or (val is not None
                                             and val <= 0)
                if unbounded:
                    yield self.violation(
                        ctx, node,
                        "unbounded queue in the serving layer — under "
                        "overload it grows until the host OOMs instead "
                        "of shedding; construct with maxsize=<depth> "
                        "and shed on queue.Full")
                continue
            yield from self._check_get(ctx, node)

    def _check_get(self, ctx, call: ast.Call):
        name = call_name(call)
        if name is None or not name.endswith(".get"):
            return
        if len(call.args) > 2:
            return  # not the queue.get(block[, timeout]) signature
        if call.args:
            block = _static_value(call.args[0])
            if block is None:
                return  # dict.get(key[, default]) — non-numeric key
            if not block:
                return  # get(False)/get(0): non-blocking
            # truthy numeric block arg (True, 1, …): block-forever
            # unless a REAL timeout bounds it — fall through
        timeout, has_timeout = None, False
        if len(call.args) == 2:
            timeout, has_timeout = call.args[1], True
        for kw in call.keywords:
            if kw.arg == "timeout":
                timeout, has_timeout = kw.value, True
            elif kw.arg == "block" and \
                    isinstance(kw.value, ast.Constant) \
                    and not kw.value.value:
                return  # block=False: non-blocking
        if has_timeout and not (
                isinstance(timeout, ast.Constant)
                and timeout.value is None):
            # a dynamic or non-None timeout bounds the wait;
            # timeout=None is the spelled-out block-forever and
            # falls through to the violation
            return
        yield self.violation(
            ctx, call,
            "blocking .get() without a timeout in the serving layer — "
            "the waiter can never observe a stop flag or a dead "
            "producer; use .get(timeout=...) (loop on queue.Empty) or "
            ".get_nowait()")


RULES = (ServeLivenessDiscipline(),)
