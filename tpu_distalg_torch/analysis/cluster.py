"""Cluster transport discipline (TDA090).

The multi-process runtime's availability and safety contract is
structural, like the serving layer's (TDA060): every blocking socket
receive in ``tpu_distalg_torch/cluster/`` is DEADLINE-BOUNDED (a partitioned
peer must surface as :class:`~tpu_distalg_torch.cluster.transport.
TransportTimeout`, never wedge a coordinator thread forever), and
every payload that hits the wire is LENGTH-PREFIX FRAMED through the
transport's encoder (an unframed ``sendall`` desynchronizes the
stream — the receiver reads the bytes as a length prefix and either
allocates garbage or wedges; it is also how pickle-shaped ad-hoc
payloads would sneak in). One forgotten bare ``recv()`` or raw
``sendall(b"...")`` silently voids both; TDA090 makes the convention
machine-checked.

Flagged shapes::

    conn, _ = listener.accept()        # no settimeout in scope
    data = sock.recv(4096)             # no settimeout in scope
    sock.settimeout(None)              # spelled-out block-forever
    sock.sendall(b"hello")             # unframed payload
    sock.sendall(payload)              # payload not built by a
                                       #   frame encoder in scope

Fine::

    sock.settimeout(remaining)         # then recv/accept in the same
    chunk = sock.recv(n)               #   function: deadline-bounded
    buf = encode_frame(kind, meta)     # framed, then sent
    sock.sendall(buf)
    sock.sendall(encode_frame(...))    # framed inline

The deadline check is function-scoped: a ``.settimeout(x)`` call with
a non-``None`` argument anywhere in the SAME function body arms every
receive in it (the transport's ``_recv_exact`` shape — recompute the
remaining budget, set it, read). ``settimeout(None)`` does not count:
that is the spelled-out block-forever.
"""

from __future__ import annotations

import ast

from tpu_distalg_torch.analysis.engine import PKG, Rule, call_name, pkg_dir

_RECV_METHODS = ("recv", "recvfrom", "recv_into", "recvmsg")


def _attr_method(call: ast.Call) -> str | None:
    """The trailing attribute name of a method-style call
    (``x.y.recv(...)`` -> ``'recv'``), else None."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _direct_calls(fn: ast.AST):
    """Calls belonging DIRECTLY to ``fn`` — nested function bodies are
    excluded (they are checked as their own scope, with their own
    settimeout evidence)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _has_deadline(fn: ast.AST) -> bool:
    """True when the function arms a non-None socket timeout."""
    for call in _direct_calls(fn):
        if _attr_method(call) != "settimeout":
            continue
        if call.args and isinstance(call.args[0], ast.Constant) \
                and call.args[0].value is None:
            continue  # settimeout(None): the spelled-out block-forever
        if call.args or call.keywords:
            return True
    return False


def _frame_names(tree: ast.AST) -> set[str]:
    """Names that produce framed bytes: anything imported from or
    defined as a ``*frame*`` encoder (``encode_frame`` is the
    transport's; a sibling module may alias it)."""
    names = {"encode_frame"}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and "frame" in node.name and node.name.startswith(
                    ("encode", "frame", "make", "build")):
            names.add(node.name)
    return names


def _is_framed(arg, framed_vars: set[str], frame_fns: set[str]) -> bool:
    if isinstance(arg, ast.Call):
        name = call_name(arg)
        return bool(name) and (
            name.split(".")[-1] in frame_fns
            or "frame" in name.split(".")[-1])
    if isinstance(arg, ast.Name):
        return arg.id in framed_vars
    return False


class ClusterTransportDiscipline(Rule):
    code = "TDA090"
    name = ("unbounded socket receive / unframed sendall in "
            "cluster/")
    invariant = (
        "the cluster runtime stays live and speaks one wire format: "
        "every blocking socket receive is deadline-bounded (a "
        "partition surfaces as TransportTimeout, never a wedged "
        "thread) and every sendall payload is length-prefix framed "
        "by the transport encoder (an unframed write desynchronizes "
        "the stream)")

    def applies(self, ctx):
        return pkg_dir("cluster") in ctx.path

    def check(self, ctx):
        frame_fns = _frame_names(ctx.tree)
        scopes = [n for n in ast.walk(ctx.tree)
                  if isinstance(n, (ast.FunctionDef,
                                    ast.AsyncFunctionDef))]
        for fn in scopes:
            yield from self._check_scope(ctx, fn, frame_fns)

    def _check_scope(self, ctx, fn, frame_fns):
        has_deadline = _has_deadline(fn)
        # variables assigned from a frame encoder in this scope are
        # framed payloads (buf = encode_frame(...); sock.sendall(buf))
        framed_vars: set[str] = set()
        for call in _direct_calls(fn):
            method = _attr_method(call)
            if method == "settimeout" and call.args and \
                    isinstance(call.args[0], ast.Constant) and \
                    call.args[0].value is None and not has_deadline:
                yield self.violation(
                    ctx, call,
                    "settimeout(None) is the spelled-out block-"
                    "forever — every blocking receive in cluster/ "
                    "must carry a real deadline (TransportTimeout is "
                    "the partition observable)")
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    _is_framed(node.value, framed_vars, frame_fns):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        framed_vars.add(tgt.id)
        for call in _direct_calls(fn):
            method = _attr_method(call)
            if method in _RECV_METHODS or method == "accept":
                if not has_deadline:
                    yield self.violation(
                        ctx, call,
                        f".{method}() with no socket timeout armed in "
                        f"this function — a dead or partitioned peer "
                        f"wedges this thread forever; call "
                        f".settimeout(<remaining deadline>) before "
                        f"blocking (transport._recv_exact is the "
                        f"shape)")
            elif method == "sendall":
                if not call.args or not _is_framed(
                        call.args[0], framed_vars, frame_fns):
                    yield self.violation(
                        ctx, call,
                        "sendall of a payload not built by the frame "
                        "encoder — an unframed write desynchronizes "
                        "the length-prefixed stream (and is how "
                        "ad-hoc pickle-shaped payloads sneak in); "
                        "route it through transport.encode_frame / "
                        "send_frame")


def _calls_fsync(fn: ast.AST) -> bool:
    """True when the function calls an fsync (``os.fsync`` or a
    ``*fsync*`` helper like the WAL's ``_fsync_dir``) — the marker of
    the fsync-rename discipline."""
    for call in _direct_calls(fn):
        name = None
        if isinstance(call.func, ast.Attribute):
            name = call.func.attr
        elif isinstance(call.func, ast.Name):
            name = call.func.id
        if name is not None and "fsync" in name:
            return True
    return False


def _write_capable_mode(call: ast.Call) -> str | None:
    """The mode string of an ``open`` call when it can MUTATE the file
    (w/x/a/+ — append is exactly the WAL's mode, and durable bytes
    are durable bytes), else None."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if isinstance(mode, ast.Constant) and \
            isinstance(mode.value, str) and \
            any(c in mode.value for c in "wxa+"):
        return mode.value
    return None


class WalDurabilityDiscipline(Rule):
    code = "TDA091"
    name = ("file write outside the WAL/checkpoint fsync-rename "
            "discipline, or a WAL append not durable before the "
            "socket send")
    invariant = (
        "the coordinator's crash-tolerance contract is write-AHEAD: "
        f"durable state in {PKG}/cluster/ is mutated only "
        "inside fsync-disciplined helpers (cluster/wal.py, "
        "utils/checkpoint), and a record's bytes are flushed+fsynced "
        "BEFORE the ack that depends on them leaves the socket — a "
        "buffered write that an ack escapes ahead of is a recovery "
        "that silently forgets acknowledged state")

    def applies(self, ctx):
        return pkg_dir("cluster") in ctx.path

    def check(self, ctx):
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef,
                               ast.AsyncFunctionDef)):
                yield from self._check_fn(ctx, fn)

    def _check_fn(self, ctx, fn):
        has_fsync = _calls_fsync(fn)
        writes, sends, flushes, fsyncs = [], [], [], []
        for call in _direct_calls(fn):
            name = call_name(call)
            method = _attr_method(call)
            if name == "open":
                mode = _write_capable_mode(call)
                if mode is not None and not has_fsync:
                    yield self.violation(
                        ctx, call,
                        f"open(..., {mode!r}) in cluster/ with no "
                        f"fsync in this function — durable cluster "
                        f"state goes through the WAL/checkpoint "
                        f"fsync-rename helpers (cluster/wal.py, "
                        f"utils/checkpoint), not ad-hoc writes a "
                        f"crash can tear silently")
            elif name in ("os.replace", "os.rename") \
                    and not has_fsync:
                yield self.violation(
                    ctx, call,
                    f"{name}() in cluster/ with no fsync in this "
                    f"function — a rename-publish whose directory "
                    f"entry a power cut can lose; use the "
                    f"WAL/checkpoint fsync-rename helpers")
            if method == "write":
                writes.append(call)
            elif method == "sendall" or (
                    name is not None
                    and name.rsplit(".", 1)[-1] == "send_frame"):
                sends.append(call)
            elif method == "flush":
                flushes.append(call)
            if name is not None and "fsync" in name.rsplit(
                    ".", 1)[-1]:
                fsyncs.append(call)
        # SOURCE order: _direct_calls walks an AST stack whose order
        # is arbitrary — pairing must judge each write against its
        # genuinely FIRST later send, or an unfsynced nearer send
        # hides behind a safe farther one (a false negative in the
        # exact hole this rule exists to close)
        sends.sort(key=lambda c: c.lineno)
        for w in writes:
            for s in sends:
                if s.lineno <= w.lineno:
                    continue
                ok = (any(w.lineno < f.lineno <= s.lineno
                          for f in flushes)
                      and any(w.lineno < y.lineno <= s.lineno
                              for y in fsyncs))
                if not ok:
                    yield self.violation(
                        ctx, s,
                        "socket send after a WAL/file write with no "
                        "flush+fsync between them — the ack can "
                        "escape ahead of the record's durability, "
                        "and a recovered coordinator would forget "
                        "state a worker already observed; fsync "
                        "before the send (wal.WriteAheadLog.append "
                        "is the shape)")
                break  # one finding per write: its FIRST later send


RULES = (ClusterTransportDiscipline(), WalDurabilityDiscipline())
