"""The wire-protocol contract — extraction + the TDA11x family.

The multi-process tier speaks a hand-rolled framed-TCP protocol
(``cluster/transport.py``): every frame is ``(kind, meta, arrays)``,
every handler dispatches on the kind literal, and the review history
shows ONE bug class recurring in every round — protocol-contract
drift. A frame kind nobody handles rots into a silent drop; a meta key
one encoder forgets raises a KeyError two modules away; a request site
that never checks for an ``error`` reply misreads a dying
coordinator's answer as a genuine rejection (the PR 13 class); a
resume frame without the incarnation token defeats the zombie fencing
it exists for; an ack that leaves the socket before its WAL record is
durable is a recovery that forgets acknowledged state.

This module recovers the contract FROM SOURCE — per file, into the
project-graph summary (:func:`extract_protocol`, riding
``summarize_context``), so the interprocedural rules and the
``tda protocol`` renderer see one spelling:

* **send sites** — ``send_frame``/``request`` calls with a literal
  kind (plus module-local *forwarders*: any function with a ``kind``
  parameter that passes it on to a send API, e.g. the worker's
  ``rpc``/``_Link.request``), the meta-dict keys each site writes
  (one-level local dataflow: ``dict(ident, window=w)`` resolves
  through ``ident = {"slot": ..., "inc": ...}``), and — for round
  trips — the reply kinds the site's unpacked result is compared
  against (``k != "welcome"``-style catch-alls count as rejection
  handling; comparisons credit the nearest preceding unpack, mirrored
  across ``try``/``except`` redial twins).
* **handler branches** — functions with ``kind``+``meta`` parameters
  (or a ``recv_frame`` unpack) dispatching on kind literals; per
  branch: the kinds matched, the meta keys read (``meta["k"]`` =
  required, ``meta.get("k")`` = optional), the reply kinds returned
  (literal tuples, followed through same-module helper calls), whether
  the branch consults a ``*fenced*`` gate, and the WAL kinds it
  appends.
* **WAL ordering** — per function, every send/append interleaving on
  every branch path (the TDA114 raw verdicts).

What deliberately does NOT resolve (each counted, shown by
``tda protocol``): non-literal kind strings (``wal.append`` replay
passthrough, ``send_frame(conn, *reply)`` star-unpacks), meta dicts
built from attributes (``dict(self.ident)``), non-literal meta keys,
and reply-direction payload contracts (the welcome meta). See the
"Protocol graph" subsection in ARCHITECTURE.md.

The rules (all interprocedural, all over the library surface only):

==========  =========================================================
TDA110      frame-kind bijectivity: every sent kind has a handler in
            some peer module and every handled kind is sent somewhere
TDA111      payload-key contract: a key a decoder of kind K reads
            without a default is written by EVERY resolvable encoder
            of K
TDA112      request/reply pairing: a round trip's accepted reply
            kinds are kinds some handler of K actually sends (or a
            local synthetic like the worker link's ``reset``), and an
            ``error``-kind reply is explicitly handled
TDA113      incarnation-fencing completeness: every resolvable
            encoder of a fenced kind (one whose handler consults the
            ``*fenced*`` gate) populates the ``inc`` token
TDA114      WAL-before-ack at protocol scope: no branch path sends a
            frame before the WAL append in the same handler
==========  =========================================================

Layering: stdlib + engine only (same bare-host contract as the rest
of :mod:`tpu_distalg_torch.analysis`).
"""

from __future__ import annotations

import ast

from tpu_distalg_torch.analysis import engine
from tpu_distalg_torch.analysis.engine import call_name
from tpu_distalg_torch.analysis.project import ProjectRule, _walk_functions

#: transport round-trip / one-way send APIs (matched by trailing name)
SEND_APIS = ("send_frame", "request")
#: frame byte encoders — payload construction, NOT a network send
#: (the WAL rides these; its kinds are ledger records, not wire kinds)
ENCODE_APIS = ("encode_frame", "encode_frame_parts")
#: the receive side — an unpack of one of these starts a dispatch
RECV_APIS = ("recv_frame",)

_PATH_CAP = 64          # TDA114 per-function branch-path budget
_FOLLOW_DEPTH = 4       # handler-branch helper-call follow budget


def _tail(name: str | None) -> str:
    return (name or "").rsplit(".", 1)[-1]


def _own_walk(node):
    """ast.walk minus nested function bodies (they are scanned as
    their own scopes). Lambdas stay in — ``supervised(lambda:
    self.wal.append(...))`` is this function's append."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield child
        stack.extend(ast.iter_child_nodes(child))


def _params(fn) -> list:
    args = fn.args
    return [a.arg for a in args.posonlyargs + args.args]


def _literal_kind(call: ast.Call):
    """``(kind, index)`` of the first literal-string positional among
    the leading args — the kind slot of every frame API shape
    (``send_frame(sock, "k", ...)`` / ``link.request("k", ...)``) —
    else ``(None, -1)`` (a dynamic site)."""
    for i, a in enumerate(call.args[:3]):
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value, i
    return None, -1


def _meta_arg(call: ast.Call, kind_idx: int):
    if 0 <= kind_idx and kind_idx + 1 < len(call.args):
        return call.args[kind_idx + 1]
    for kw in call.keywords:
        if kw.arg == "meta":
            return kw.value
    return None


def _is_wal_append(call: ast.Call) -> bool:
    """``<something wal-ish>.append(...)`` — the attribute chain left
    of ``.append`` carries a ``wal`` segment (``self.wal.append``,
    ``self._wal.append``, ``wal.append``)."""
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == "append"):
        return False
    chain = call_name(call) or ""
    return "wal" in chain.rsplit(".", 1)[0].lower()


def _compare_kinds(test, var: str):
    """``(kinds, negative)`` when ``test`` compares Name ``var``
    against string literals (``==``/``!=``/``in``/``not in``; ``or``
    chains union) — else None."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        kinds, neg = [], False
        for v in test.values:
            m = _compare_kinds(v, var)
            if m is None:
                return None
            kinds.extend(m[0])
            neg = neg or m[1]
        return (kinds, neg) if kinds else None
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Name)
            and test.left.id == var):
        return None
    op, comp = test.ops[0], test.comparators[0]
    if isinstance(comp, ast.Constant) and isinstance(comp.value, str):
        kinds = [comp.value]
    elif isinstance(comp, (ast.Tuple, ast.List, ast.Set)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in comp.elts):
        kinds = [e.value for e in comp.elts]
    else:
        return None
    if isinstance(op, ast.Eq) or isinstance(op, ast.In):
        return kinds, False
    if isinstance(op, ast.NotEq) or isinstance(op, ast.NotIn):
        return kinds, True
    return None


def _terminates(stmts) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


# ---------------------------------------------------------------------
# meta-dict key resolution (one-level local dataflow)


def _resolve_keys(expr, fn, depth: int = 0):
    """``(keys, maybe, dynamic)`` for a meta expression: ``keys`` are
    written on every path, ``maybe`` only conditionally (a second
    assignment's extras, a ``meta["k"] = ...`` patch), ``dynamic``
    means the dict cannot be resolved from literals + one-level local
    dataflow (``dict(self.ident)`` and friends) — TDA111/TDA113 skip
    dynamic encoders rather than guess."""
    if depth > 5 or expr is None:
        return set(), set(), depth > 5
    if isinstance(expr, ast.Constant) and expr.value is None:
        return set(), set(), False
    if isinstance(expr, ast.Dict):
        keys, maybe, dyn = set(), set(), False
        for k, v in zip(expr.keys, expr.values):
            if k is None:                      # {**base, ...}
                k2, m2, d2 = _resolve_keys(v, fn, depth + 1)
                keys |= k2
                maybe |= m2
                dyn = dyn or d2
            elif isinstance(k, ast.Constant) and isinstance(k.value,
                                                            str):
                keys.add(k.value)
            else:
                dyn = True                     # non-literal key
        return keys, maybe, dyn
    if isinstance(expr, ast.Call) and _tail(call_name(expr)) == "dict":
        keys, maybe, dyn = set(), set(), False
        if expr.args:
            k2, m2, d2 = _resolve_keys(expr.args[0], fn, depth + 1)
            keys |= k2
            maybe |= m2
            dyn = dyn or d2
        for kw in expr.keywords:
            if kw.arg is None:
                dyn = True
            else:
                keys.add(kw.arg)
        return keys, maybe, dyn
    if isinstance(expr, ast.Name):
        assigns = [n for n in _own_walk(fn)
                   if isinstance(n, ast.Assign)
                   and len(n.targets) == 1
                   and isinstance(n.targets[0], ast.Name)
                   and n.targets[0].id == expr.id]
        if not assigns:
            return set(), set(), True
        keys, maybe, dyn = None, set(), False
        for a in assigns:
            k2, m2, d2 = _resolve_keys(a.value, fn, depth + 1)
            maybe |= m2 | k2
            dyn = dyn or d2
            keys = k2 if keys is None else keys & k2
        for n in _own_walk(fn):        # conditional `name["k"] = v`
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Subscript) \
                    and isinstance(n.targets[0].value, ast.Name) \
                    and n.targets[0].value.id == expr.id \
                    and isinstance(n.targets[0].slice, ast.Constant):
                maybe.add(n.targets[0].slice.value)
        keys = keys or set()
        return keys, maybe - keys, dyn
    return set(), set(), True


# ---------------------------------------------------------------------
# the per-module extractor


class _ModuleScan:
    def __init__(self, tree, imports: dict):
        self.tree = tree
        self.imports = imports
        self.fns = list(_walk_functions(tree))
        self.class_methods = {(cls, fn.name): fn
                              for _, cls, fn in self.fns
                              if cls is not None}
        self.module_defs = {fn.name: fn for _, cls, fn in self.fns
                            if cls is None}
        self.forwarders = self._find_forwarders()

    # -- forwarders ---------------------------------------------------

    def _find_forwarders(self) -> dict:
        """name -> 'send' | 'encode' | 'wal' for module-local
        functions with a ``kind`` parameter that pass it on to a frame
        API (or to another forwarder — fixpoint)."""
        out: dict = {}
        cands = [(q, fn) for q, _, fn in self.fns
                 if "kind" in _params(fn)]
        for _ in range(3):                    # chains are short
            grew = False
            for qual, fn in cands:
                if fn.name in out:
                    continue
                for call in ast.walk(fn):     # lambdas included
                    if not isinstance(call, ast.Call):
                        continue
                    if not any(isinstance(n, ast.Name)
                               and n.id == "kind"
                               for a in call.args
                               for n in ast.walk(a)):
                        continue
                    tail = _tail(call_name(call))
                    if tail in SEND_APIS:
                        out[fn.name] = "send"
                    elif _is_wal_append(call):
                        out[fn.name] = "wal"
                    elif tail in ENCODE_APIS:
                        out.setdefault(fn.name, "encode")
                    elif tail in out and tail != fn.name:
                        out.setdefault(fn.name, out[tail])
                if fn.name in out:
                    grew = True
            if not grew:
                break
        return out

    def _local_def(self, call: ast.Call):
        """The module-local def a call resolves to — only when the
        callee does NOT root in an imported module (``link.request``
        resolves to ``_Link.request``; ``transport.request`` stays the
        base API)."""
        tail = _tail(call_name(call))
        if isinstance(call.func, ast.Name):
            return self.module_defs.get(tail)
        root = (call_name(call) or "").split(".", 1)[0]
        if root in self.imports:
            return None
        for (_, name), fn in self.class_methods.items():
            if name == tail:
                return fn
        return self.module_defs.get(tail)

    def _call_class(self, call: ast.Call) -> str | None:
        """'send' / 'encode' / 'wal' / None for one call node."""
        tail = _tail(call_name(call))
        if tail in SEND_APIS:
            return "send"
        if _is_wal_append(call):
            return "wal"
        if tail in ENCODE_APIS:
            return "encode"
        if tail in self.forwarders:
            root = (call_name(call) or "").split(".", 1)[0]
            if root not in self.imports or isinstance(call.func,
                                                      ast.Name):
                return self.forwarders[tail]
        return None

    # -- round-trip reply discipline -----------------------------------

    def _unpack_credits(self, fn):
        """Per request-ish call (by line): the reply kinds its
        unpacked result is compared against + whether any comparison
        is a catch-all rejection (``!=``/``not in``). Comparisons
        credit the nearest preceding unpack of the same name; a
        try-body unpack and an except-handler re-unpack of the same
        name (the redial-twin idiom — the comparison after the
        ``try`` credits only the handler's) share credits."""
        unpacks = []        # [line, var, credits, negative]
        trys = [n for n in _own_walk(fn) if isinstance(n, ast.Try)]

        for n in _own_walk(fn):
            if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.value, ast.Call)):
                continue
            cls = self._call_class(n.value)
            tail = _tail(call_name(n.value))
            if cls != "send" and tail not in RECV_APIS:
                continue
            tgt = n.targets[0]
            var = None
            if isinstance(tgt, ast.Tuple) and tgt.elts \
                    and isinstance(tgt.elts[0], ast.Name):
                var = tgt.elts[0].id
            if var is not None and var != "_":
                unpacks.append([n.value.lineno, var, set(), False])
        for n in _own_walk(fn):
            if not isinstance(n, (ast.Compare, ast.BoolOp)):
                continue
            for var in sorted({u[1] for u in unpacks}):
                m = _compare_kinds(n, var)
                if m is None:
                    continue
                cands = [u for u in unpacks
                         if u[1] == var and u[0] <= n.lineno]
                if not cands:
                    continue
                hit = max(cands, key=lambda u: u[0])
                hit[2].update(m[0])
                hit[3] = hit[3] or m[1]
                break
        # redial twins: an unpack in a Try's BODY and one in its
        # except HANDLER (same var) are the same logical round trip —
        # a comparison after the try credits only the later (handler)
        # unpack, so copy credits across the pair. Unpacks that merely
        # share a try body do NOT share credits.
        def _within(line, stmts):
            return any(s.lineno <= line <= (s.end_lineno or s.lineno)
                       for s in stmts)

        for t in trys:
            in_body = [u for u in unpacks if _within(u[0], t.body)]
            in_handlers = [u for u in unpacks
                           if any(_within(u[0], h.body)
                                  for h in t.handlers)]
            for b in in_body:
                for h in in_handlers:
                    if b[1] != h[1]:
                        continue
                    kinds = b[2] | h[2]
                    neg = b[3] or h[3]
                    b[2], h[2] = set(kinds), set(kinds)
                    b[3] = h[3] = neg
        return {u[0]: (u[2], u[3]) for u in unpacks}

    def _chain_credits(self, call: ast.Call, depth: int = 0):
        """Reply kinds checked INSIDE a forwarder chain (the worker's
        ``rpc`` folds ``reset``/``error`` for every call site)."""
        if depth > 2:
            return set(), False
        target = self._local_def(call)
        if target is None or _tail(call_name(call)) \
                not in dict(self.forwarders, **{a: "send"
                                                for a in SEND_APIS}):
            return set(), False
        kinds, neg = set(), False
        credits = self._unpack_credits(target)
        for k, n in credits.values():
            kinds |= k
            neg = neg or n
        for inner in _own_walk(target):
            if isinstance(inner, ast.Call) \
                    and self._call_class(inner) == "send":
                k2, n2 = self._chain_credits(inner, depth + 1)
                kinds |= k2
                neg = neg or n2
        return kinds, neg

    # -- send / encode / wal sites -------------------------------------

    def scan_sites(self):
        sends, encodes, wals, n_dynamic = [], [], [], 0
        for qual, _cls, fn in self.fns:
            credits = self._unpack_credits(fn)
            recv_lines = sorted(
                n.lineno for n in _own_walk(fn)
                if isinstance(n, ast.Call)
                and _tail(call_name(n)) in RECV_APIS)
            for call in _own_walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                cls = self._call_class(call)
                if cls is None:
                    continue
                kind, kidx = _literal_kind(call)
                if kind is None:
                    if cls == "send":
                        n_dynamic += 1
                    continue
                if cls == "wal":
                    wals.append({"kind": kind, "fn": qual,
                                 "line": call.lineno})
                    continue
                if cls == "encode":
                    encodes.append({"kind": kind, "fn": qual,
                                    "line": call.lineno})
                    continue
                keys, maybe, dyn = _resolve_keys(
                    _meta_arg(call, kidx), fn)
                is_request = _tail(call_name(call)) != "send_frame" \
                    or not any(r < call.lineno for r in recv_lines)
                accepts, rejects = credits.get(call.lineno,
                                               (set(), False))
                c_kinds, c_neg = self._chain_credits(call)
                sends.append({
                    "kind": kind, "fn": qual, "line": call.lineno,
                    "role": "request" if is_request else "reply",
                    "keys": sorted(keys), "maybe": sorted(maybe),
                    "dynamic": dyn,
                    "accepts": sorted(accepts | c_kinds),
                    "rejects": rejects or c_neg,
                })
        return sends, encodes, wals, n_dynamic

    # -- synthetic local replies ----------------------------------------

    def scan_synthetics(self):
        """Literal reply tuples returned by send-forwarders — kinds a
        round trip can legitimately receive that no HANDLER sends (the
        worker link's ``("reset", welcome, center)``). Full ast.walk:
        the synthetic return typically lives in the retry closure
        nested inside the forwarder."""
        out = []
        for qual, _cls, fn in self.fns:
            if self.forwarders.get(fn.name) != "send":
                continue
            for n in ast.walk(fn):
                if isinstance(n, ast.Return) \
                        and isinstance(n.value, ast.Tuple) \
                        and n.value.elts \
                        and isinstance(n.value.elts[0], ast.Constant) \
                        and isinstance(n.value.elts[0].value, str):
                    out.append({"kind": n.value.elts[0].value,
                                "fn": qual, "line": n.lineno})
        return out

    # -- handler dispatch -------------------------------------------------

    def scan_handlers(self):
        out = []
        for qual, cls, fn in self.fns:
            params = _params(fn)
            if "kind" in params and any(p in ("meta", "meta_")
                                        for p in params):
                meta = "meta" if "meta" in params else "meta_"
                out.extend(self._dispatch(fn, cls, qual, "kind", meta))
                continue
            # recv_frame unpack dispatch (accept loops)
            for n in _own_walk(fn):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Tuple) \
                        and isinstance(n.value, ast.Call) \
                        and _tail(call_name(n.value)) in RECV_APIS:
                    elts = n.targets[0].elts
                    if elts and isinstance(elts[0], ast.Name):
                        meta = elts[1].id if len(elts) > 1 and \
                            isinstance(elts[1], ast.Name) else None
                        out.extend(self._dispatch(
                            fn, cls, qual, elts[0].id, meta))
                    break
        return out

    def _dispatch(self, fn, cls, qual, kind_var, meta_var):
        branches = []
        self._scan_block(list(fn.body), fn, cls, kind_var, meta_var,
                         branches)
        return branches

    def _scan_block(self, stmts, fn, cls, kind_var, meta_var,
                    branches):
        for i, st in enumerate(stmts):
            if isinstance(st, ast.If):
                m = _compare_kinds(st.test, kind_var)
                if m is not None and not m[1]:
                    branches.append(self._branch(
                        m[0], st.body, st.lineno, fn, cls, qual=None))
                    self._scan_block(st.orelse, fn, cls, kind_var,
                                     meta_var, branches)
                elif m is not None and m[1] and _terminates(st.body):
                    # `if kind != "route": reject; continue` — the
                    # REST of this block is the kind's handler
                    branches.append(self._branch(
                        m[0], stmts[i + 1:], st.lineno, fn, cls,
                        qual=None))
                else:
                    self._scan_block(st.body, fn, cls, kind_var,
                                     meta_var, branches)
                    self._scan_block(st.orelse, fn, cls, kind_var,
                                     meta_var, branches)
            elif isinstance(st, (ast.While, ast.For)):
                self._scan_block(st.body, fn, cls, kind_var, meta_var,
                                 branches)
            elif isinstance(st, ast.Try):
                for blk in (st.body, st.orelse, st.finalbody):
                    self._scan_block(blk, fn, cls, kind_var, meta_var,
                                     branches)
                for h in st.handlers:
                    self._scan_block(h.body, fn, cls, kind_var,
                                     meta_var, branches)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                self._scan_block(st.body, fn, cls, kind_var, meta_var,
                                 branches)
        # meta_var reads in the branch bodies are collected by _branch
        # against the dispatch function's meta name; nothing to do here

    def _branch(self, kinds, stmts, line, fn, cls, qual):
        facts = {"reads": {}, "replies": set(), "fenced": False,
                 "wal": set()}
        enclosing = fn
        meta = None
        params = _params(fn)
        if "meta" in params:
            meta = "meta"
        elif "meta_" in params:
            meta = "meta_"
        else:
            for n in _own_walk(fn):        # the recv-unpack meta name
                if isinstance(n, ast.Assign) \
                        and isinstance(n.targets[0], ast.Tuple) \
                        and isinstance(n.value, ast.Call) \
                        and _tail(call_name(n.value)) in RECV_APIS:
                    elts = n.targets[0].elts
                    if len(elts) > 1 and isinstance(elts[1], ast.Name):
                        meta = elts[1].id
                    break
        self._collect(stmts, meta, cls, facts, set(), 0)
        qual = next((q for q, _c, f in self.fns if f is enclosing),
                    fn.name)
        return {"kinds": sorted(set(kinds)), "fn": qual, "line": line,
                "reads": sorted([k, req] for k, req
                                in facts["reads"].items()),
                "replies": sorted(facts["replies"]),
                "fenced": facts["fenced"],
                "wal": sorted(facts["wal"])}

    def _collect(self, stmts, meta, cls, facts, visited, depth):
        """Branch facts from statements: meta reads, literal reply
        tuples (returned or sent), fence-gate calls, WAL kinds —
        following same-module helper calls that touch the meta."""
        for st in stmts:
            for n in [st] + list(_own_walk(st)):
                if isinstance(n, ast.Subscript) and meta \
                        and isinstance(n.value, ast.Name) \
                        and n.value.id == meta \
                        and isinstance(n.slice, ast.Constant) \
                        and isinstance(n.slice.value, str) \
                        and isinstance(n.ctx, ast.Load):
                    facts["reads"][n.slice.value] = True
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "get" and meta \
                        and isinstance(n.func.value, ast.Name) \
                        and n.func.value.id == meta and n.args \
                        and isinstance(n.args[0], ast.Constant) \
                        and isinstance(n.args[0].value, str):
                    facts["reads"].setdefault(n.args[0].value, False)
                if isinstance(n, ast.Return) \
                        and isinstance(n.value, ast.Tuple) \
                        and n.value.elts \
                        and isinstance(n.value.elts[0], ast.Constant) \
                        and isinstance(n.value.elts[0].value, str):
                    facts["replies"].add(n.value.elts[0].value)
                if isinstance(n, ast.Return) \
                        and isinstance(n.value, ast.Call):
                    # `return self._handle_score(arrays)` — the
                    # callee's returns ARE this branch's replies,
                    # whether or not the meta flows in
                    self._collect_call(n.value, meta, cls, facts,
                                       visited, depth, forced=True)
                if isinstance(n, ast.Call):
                    self._collect_call(n, meta, cls, facts, visited,
                                       depth)

    def _collect_call(self, call, meta, cls, facts, visited, depth,
                      forced=False):
        tail = _tail(call_name(call))
        if "fenc" in tail:
            facts["fenced"] = True
        ccls = self._call_class(call)
        kind, _ = _literal_kind(call)
        if ccls == "wal" and kind is not None:
            facts["wal"].add(kind)
        if ccls == "send" and kind is not None:
            facts["replies"].add(kind)
        if depth >= _FOLLOW_DEPTH or ccls is not None:
            return
        # follow a same-module helper the meta flows into (or whose
        # return IS the branch's reply)
        target = None
        if isinstance(call.func, ast.Attribute) \
                and isinstance(call.func.value, ast.Name) \
                and call.func.value.id == "self" and cls is not None:
            target = self.class_methods.get((cls, call.func.attr))
        elif isinstance(call.func, ast.Name):
            target = self.module_defs.get(call.func.id)
        if target is None or id(target) in visited:
            return
        touches_meta = meta is not None and any(
            isinstance(n, ast.Name) and n.id == meta
            for a in call.args for n in ast.walk(a))
        if not forced and not touches_meta and meta is not None:
            return
        visited.add(id(target))
        new_meta = None
        tparams = _params(target)
        if tparams and tparams[0] == "self":
            tparams = tparams[1:]
        for j, a in enumerate(call.args):
            if isinstance(a, ast.Name) and a.id == meta \
                    and j < len(tparams):
                new_meta = tparams[j]
                break
        tcls = next((c for _, c, f in self.fns if f is target), None)
        self._collect(list(target.body), new_meta, tcls, facts,
                      visited, depth + 1)

    # -- TDA114: send/append interleavings ------------------------------

    def scan_wal_order(self):
        out = []
        for qual, _cls, fn in self.fns:
            events = self._path_events(list(fn.body))
            seen = set()
            for path in events:
                sent = None            # (kind, line) of first send
                for ev, kind, line in path:
                    if ev == "send":
                        sent = sent or (kind, line)
                    elif ev == "wal" and sent is not None:
                        key = (sent[1], kind)
                        if key not in seen:
                            seen.add(key)
                            out.append({
                                "fn": qual, "line": sent[1],
                                "send_kind": sent[0],
                                "wal_kind": kind})
        return out

    def _stmt_events(self, st):
        events = []
        for n in ast.walk(st):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not isinstance(n, ast.Call):
                continue
            cls = self._call_class(n)
            kind, _ = _literal_kind(n)
            if kind is None:
                continue
            if cls == "send":
                events.append(("send", kind, n.lineno))
            elif cls == "wal":
                events.append(("wal", kind, n.lineno))
        return sorted(events, key=lambda e: e[2])

    def _path_events(self, stmts):
        """Every branch path's (event, kind, line) sequence, loops
        taken once, ``return``/``raise`` terminating, capped at
        ``_PATH_CAP`` paths."""
        paths = [([], True)]          # (events, still-live)

        def extend(branches):
            nonlocal paths
            new = []
            for ev, live in paths:
                if not live:
                    new.append((ev, live))
                    continue
                for bev, blive in branches:
                    if len(new) >= _PATH_CAP:
                        break
                    new.append((ev + bev, blive))
            paths = new[:_PATH_CAP]

        for st in stmts:
            if all(not live for _, live in paths):
                break
            if isinstance(st, ast.If):
                cond = [(self._stmt_events(st.test), True)]
                extend(cond)
                body = self._sub_paths(st.body)
                orelse = self._sub_paths(st.orelse) or [([], True)]
                extend(body + orelse)
            elif isinstance(st, (ast.While, ast.For)):
                extend([([], True)]
                       + self._sub_paths(st.body))
            elif isinstance(st, ast.Try):
                body = self._sub_paths(st.body)
                handlers = [p for h in st.handlers
                            for p in self._sub_paths(h.body)]
                extend(body + (handlers or []))
                if st.finalbody:
                    extend(self._sub_paths(st.finalbody))
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                extend(self._sub_paths(st.body))
            elif isinstance(st, (ast.Return, ast.Raise)):
                extend([(self._stmt_events(st), False)])
            elif isinstance(st, (ast.Break, ast.Continue)):
                extend([([], False)])
            else:
                extend([(self._stmt_events(st), True)])
        return [ev for ev, _ in paths]

    def _sub_paths(self, stmts):
        if not stmts:
            return []
        sub = self._path_events(stmts)
        # _path_events loses liveness at this boundary; a terminated
        # sub-path simply carries no further events, which is the same
        # thing for ordering purposes
        return [(ev, True) for ev in sub]


def extract_protocol(tree, imports: dict) -> dict:
    """One module's protocol-graph contribution (JSON-able; empty
    lists when the module never touches the wire)."""
    scan = _ModuleScan(tree, imports)
    sends, encodes, wals, n_dynamic = scan.scan_sites()
    doc = {
        "sends": sorted(sends, key=lambda s: (s["line"], s["kind"])),
        "encodes": sorted(encodes,
                          key=lambda s: (s["line"], s["kind"])),
        "wal_appends": sorted(wals,
                              key=lambda s: (s["line"], s["kind"])),
        "handlers": sorted(scan.scan_handlers(),
                           key=lambda h: (h["line"],)),
        "synthetics": sorted(scan.scan_synthetics(),
                             key=lambda s: (s["line"], s["kind"])),
        "wal_order": sorted(scan.scan_wal_order(),
                            key=lambda s: (s["line"],)),
        "n_dynamic_sends": n_dynamic,
    }
    return doc


# ---------------------------------------------------------------------
# the assembled contract (rules + `tda protocol` share this)


def build_contract(project) -> dict:
    """Aggregate every library module's protocol facts into one
    contract: per frame kind its senders, handlers, reply kinds,
    required/optional payload keys and fencing; plus WAL record kinds,
    synthetic local replies, and the deliberately-unresolved counts."""
    frames: dict = {}
    wal_records: dict = {}
    encodes: dict = {}
    synthetics: dict = {}
    wal_order: list = []
    n_dynamic = 0

    def frame(kind):
        return frames.setdefault(kind, {"senders": [], "handlers": []})

    for s in project.library():
        proto = s.get("protocol")
        if not proto:
            continue
        path = s["path"]
        for site in proto["sends"]:
            frame(site["kind"])["senders"].append(
                dict(site, path=path))
        for h in proto["handlers"]:
            for kind in h["kinds"]:
                frame(kind)["handlers"].append(dict(h, path=path))
        for w in proto["wal_appends"]:
            wal_records.setdefault(w["kind"], []).append(
                dict(w, path=path))
        for e in proto["encodes"]:
            encodes.setdefault(e["kind"], []).append(
                dict(e, path=path))
        for syn in proto["synthetics"]:
            synthetics.setdefault(syn["kind"], []).append(
                dict(syn, path=path))
        for o in proto["wal_order"]:
            wal_order.append(dict(o, path=path))
        n_dynamic += proto["n_dynamic_sends"]

    return {"frames": frames, "wal_records": wal_records,
            "encodes": encodes, "synthetics": synthetics,
            "wal_order": wal_order, "n_dynamic_sends": n_dynamic}


def _required_keys(entry) -> dict:
    """key -> (path, line) for keys some handler reads WITHOUT a
    default."""
    out: dict = {}
    for h in entry["handlers"]:
        for key, required in h["reads"]:
            if required:
                out.setdefault(key, (h["path"], h["line"]))
    return out


def _reply_kinds(entry) -> set:
    out = set()
    for h in entry["handlers"]:
        out.update(h["replies"])
    return out


# ---------------------------------------------------------------------
# the rules


class _ProtocolRule(ProjectRule):
    def check_project(self, project):
        contract = build_contract(project)
        if not contract["frames"]:
            return
        yield from self.check_contract(project, contract)

    def check_contract(self, project, contract):
        raise NotImplementedError


class FrameKindBijectivity(_ProtocolRule):
    code = "TDA110"
    name = "frame kind sent with no handler, or handled but never sent"
    invariant = (
        "the wire contract is bijective: every frame kind some peer "
        "sends has a dispatch branch in some handler module, and "
        "every dispatch branch matches a kind something actually "
        "sends — an unhandled kind rots into a silent error reply, a "
        "dead branch into unreviewed protocol surface")

    def check_contract(self, project, contract):
        frames = contract["frames"]
        any_requests = any(
            s["role"] == "request"
            for e in frames.values() for s in e["senders"])
        any_handlers = any(e["handlers"] for e in frames.values())
        if not (any_requests and any_handlers):
            return    # single-sided surface (one file linted): no
            #           bijectivity claim is decidable
        for kind in sorted(frames):
            entry = frames[kind]
            requests = [s for s in entry["senders"]
                        if s["role"] == "request"]
            if requests and not entry["handlers"]:
                seen = set()
                for s in requests:
                    if s["path"] in seen:
                        continue
                    seen.add(s["path"])
                    yield self.project_violation(
                        project, s["path"], s["line"],
                        f"frame kind '{kind}' is sent here but no "
                        f"handler in any module dispatches on it — "
                        f"the receiver's unknown-kind fallthrough "
                        f"answers 'error' and the frame rots into a "
                        f"silent drop; add a dispatch branch or "
                        f"retire the send")
            elif entry["handlers"] and not requests:
                seen = set()
                for h in entry["handlers"]:
                    if h["path"] in seen:
                        continue
                    seen.add(h["path"])
                    yield self.project_violation(
                        project, h["path"], h["line"],
                        f"frame kind '{kind}' has a dispatch branch "
                        f"here but nothing on the lint surface sends "
                        f"it — dead protocol surface no review "
                        f"exercises; retire the branch or restore "
                        f"the sender")


class PayloadKeyContract(_ProtocolRule):
    code = "TDA111"
    name = "meta key a decoder requires that an encoder never writes"
    invariant = (
        "a meta key any handler of kind K reads without a default "
        "(meta[\"k\"]) is written by every resolvable encoder of K — "
        "the missing-key spelling is a KeyError that fires two "
        "modules and one process boundary away from the encoder that "
        "caused it")

    def check_contract(self, project, contract):
        for kind in sorted(contract["frames"]):
            entry = contract["frames"][kind]
            required = _required_keys(entry)
            if not required:
                continue
            for s in entry["senders"]:
                if s["role"] != "request" or s["dynamic"]:
                    continue
                missing = sorted(set(required) - set(s["keys"]))
                if not missing:
                    continue
                key = missing[0]
                rpath, rline = required[key]
                yield self.project_violation(
                    project, s["path"], s["line"],
                    f"encoder of '{kind}' omits meta key(s) "
                    f"{missing} that {rpath}:{rline} reads without a "
                    f"default — a KeyError in the handler, one "
                    f"process away from this send; write the key(s) "
                    f"or give the read a .get default")


class RequestReplyPairing(_ProtocolRule):
    code = "TDA112"
    name = ("request accepts a reply kind its handler never sends, "
            "or never handles an error-kind reply")
    invariant = (
        "every round trip's accepted reply kinds are kinds some "
        "handler of the request actually sends (or a local synthetic "
        "like the worker link's 'reset'), and every round trip "
        "explicitly handles an 'error' reply — a dying peer's error "
        "frame misread as a genuine rejection was the PR 13 "
        "coordinator-kill bug")

    def check_contract(self, project, contract):
        frames = contract["frames"]
        synthetic = set(contract["synthetics"])
        seen_err: set = set()
        for kind in sorted(frames):
            entry = frames[kind]
            if not entry["handlers"]:
                continue      # TDA110's finding, not a pairing claim
            replies = _reply_kinds(entry) | synthetic | {"error"}
            for s in entry["senders"]:
                if s["role"] != "request":
                    continue
                for acc in s["accepts"]:
                    if acc in replies:
                        continue
                    yield self.project_violation(
                        project, s["path"], s["line"],
                        f"request '{kind}' checks its reply against "
                        f"'{acc}', a kind no handler of '{kind}' "
                        f"sends (handlers reply "
                        f"{sorted(_reply_kinds(entry)) or ['<none>']})"
                        f" — the comparison can never be true; fix "
                        f"the kind or the handler")
                handles_error = "error" in s["accepts"] or s["rejects"]
                if not handles_error \
                        and (s["path"], kind) not in seen_err:
                    seen_err.add((s["path"], kind))
                    yield self.project_violation(
                        project, s["path"], s["line"],
                        f"request '{kind}' never checks for an "
                        f"'error' reply (no == 'error' and no "
                        f"catch-all != rejection on the unpacked "
                        f"kind) — a fenced-out or dying peer's error "
                        f"frame would be silently adopted as data "
                        f"(the PR 13 class); raise on k == 'error' "
                        f"or reject non-expected kinds")


class IncarnationFencing(_ProtocolRule):
    code = "TDA113"
    name = "encoder of a fenced frame kind omits the 'inc' token"
    invariant = (
        "every resolvable encoder of a fenced frame kind (one whose "
        "handler consults the *fenced* gate) populates the 'inc' "
        "incarnation token — a token-less frame is invisible to the "
        "zombie fencing and either acts for a dead incarnation or "
        "reads as its liveness (the PR 13 round-2 class)")

    def check_contract(self, project, contract):
        frames = contract["frames"]
        for kind in sorted(frames):
            entry = frames[kind]
            if not any(h["fenced"] for h in entry["handlers"]):
                continue
            for s in entry["senders"]:
                if s["role"] != "request" or s["dynamic"]:
                    continue
                if "inc" in s["keys"]:
                    continue
                yield self.project_violation(
                    project, s["path"], s["line"],
                    f"'{kind}' is a fenced kind (its handler "
                    f"consults the incarnation gate) but this "
                    f"encoder never writes the 'inc' token — the "
                    f"frame is either rejected as a zombie's or, "
                    f"worse, keeps a dying incarnation looking "
                    f"alive; send dict(ident, ...) like the other "
                    f"encoders")


class WalBeforeAck(_ProtocolRule):
    code = "TDA114"
    name = "frame sent before the WAL append on some branch path"
    invariant = (
        "write-AHEAD at protocol scope (TDA091 generalized beyond "
        "fsync syntax): in any handler that both appends a WAL "
        "record and sends a frame, the append dominates the send on "
        "every branch path — an ack that escapes before its record "
        "is a recovery that silently forgets acknowledged state")

    def check_contract(self, project, contract):
        for o in sorted(contract["wal_order"],
                        key=lambda o: (o["path"], o["line"])):
            yield self.project_violation(
                project, o["path"], o["line"],
                f"'{o['send_kind']}' frame leaves the socket before "
                f"the WAL append of '{o['wal_kind']}' on this branch "
                f"path — the peer can observe state a crashed "
                f"recovery would forget; append (and fsync) before "
                f"the send")


RULES = (FrameKindBijectivity(), PayloadKeyContract(),
         RequestReplyPairing(), IncarnationFencing(), WalBeforeAck())


# ---------------------------------------------------------------------
# `tda protocol` rendering


def _mods(entries) -> str:
    return ", ".join(sorted({e["path"] for e in entries})) or "—"


def contract_rows(contract) -> list:
    """One deterministic row per frame kind:
    ``(kind, senders, handlers, replies, required, optional,
    fenced)``."""
    rows = []
    for kind in sorted(contract["frames"]):
        entry = contract["frames"][kind]
        if not entry["handlers"] and not any(
                s["role"] == "request" for s in entry["senders"]):
            continue    # reply-direction kind ('error', 'welcome'):
            #             it shows up in the replies column instead
        required = sorted(_required_keys(entry))
        optional = sorted(
            {k for h in entry["handlers"]
             for k, req in h["reads"] if not req} - set(required))
        rows.append((
            kind,
            _mods([s for s in entry["senders"]
                   if s["role"] == "request"]),
            _mods(entry["handlers"]),
            ", ".join(sorted(_reply_kinds(entry))) or "—",
            ", ".join(required) or "—",
            ", ".join(optional) or "—",
            "yes" if any(h["fenced"] for h in entry["handlers"])
            else "",
        ))
    return rows


_COLUMNS = ("kind", "senders", "handlers", "replies",
            "required keys", "optional keys", "fenced")

_PREAMBLE = (
    f"Generated by `python -m {engine.PKG}.cli protocol --format md` — "
    f"do not edit by hand. `python -m {engine.PKG}.cli protocol "
    f"--check` (run by `chip_smoke.py` and the port's tests) fails "
    f"when this file drifts from the extracted contract; regenerate "
    f"with `python -m {engine.PKG}.cli protocol --format md > "
    f"{engine.PKG}/PROTOCOL.md`. Module paths only (no line numbers), "
    f"so the table is stable under unrelated edits.")


def render_md(contract) -> str:
    lines = ["# Wire protocol contract", "", _PREAMBLE, "",
             "## Frames", ""]
    rows = contract_rows(contract)
    lines.append("| " + " | ".join(_COLUMNS) + " |")
    lines.append("|" + "---|" * len(_COLUMNS))
    for row in rows:
        lines.append("| " + " | ".join(row) + " |")
    lines += ["", "## WAL record kinds", "",
              "| record kind | appended by |", "|---|---|"]
    for kind in sorted(contract["wal_records"]):
        lines.append(f"| {kind} | "
                     f"{_mods(contract['wal_records'][kind])} |")
    if contract["synthetics"]:
        lines += ["", "## Synthetic local replies", "",
                  "Reply kinds a crash-tolerant link can hand its "
                  "caller that no remote handler ever sends:", ""]
        for kind in sorted(contract["synthetics"]):
            lines.append(
                f"- `{kind}` — "
                f"{_mods(contract['synthetics'][kind])}")
    lines += ["", "## Deliberately unresolved", "",
              f"- {contract['n_dynamic_sends']} send site(s) with a "
              f"non-literal frame kind (WAL replay passthroughs, "
              f"`send_frame(conn, *reply)` star-unpacks) — excluded "
              f"from the tables above.",
              "- Meta dicts built from attributes "
              "(`dict(self.ident)`) resolve as *dynamic* and are "
              "skipped by the key/fencing rules.",
              "- Reply-direction payload keys (what a *reply's* meta "
              "must carry, e.g. the welcome) are out of scope.",
              ""]
    return "\n".join(lines)


def render_text(contract) -> str:
    rows = contract_rows(contract)
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows
              else len(c) for i, c in enumerate(_COLUMNS)]
    out = ["  ".join(c.ljust(w) for c, w in zip(_COLUMNS, widths))]
    out.append("  ".join("-" * w for w in widths))
    for row in rows:
        out.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    out.append("")
    out.append("wal records: " + (", ".join(
        f"{k} ({_mods(v)})" for k, v in
        sorted(contract["wal_records"].items())) or "none"))
    if contract["synthetics"]:
        out.append("synthetic local replies: "
                   + ", ".join(sorted(contract["synthetics"])))
    out.append(f"unresolved dynamic-kind send sites: "
               f"{contract['n_dynamic_sends']}")
    return "\n".join(out)


def render_json(contract) -> dict:
    rows = contract_rows(contract)
    return {
        "frames": [dict(zip(_COLUMNS, row)) for row in rows],
        "frame_sites": {
            kind: entry for kind, entry in
            sorted(contract["frames"].items())},
        "wal_records": {k: v for k, v in
                        sorted(contract["wal_records"].items())},
        "synthetics": {k: v for k, v in
                       sorted(contract["synthetics"].items())},
        "n_dynamic_sends": contract["n_dynamic_sends"],
    }
