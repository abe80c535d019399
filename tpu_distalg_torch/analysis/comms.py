"""Comms-layer coverage — raw collectives in model code (TDA050) and
wire-dtype discipline in the comms layer itself (TDA051).

PR 5 built ``tpu_distalg_torch/parallel/comms.py`` as the single instrumented
choke point for cross-shard gradient/parameter traffic: every sync
routes through a :class:`CommSpec`-selected schedule and is accounted
in the ``comm.bytes_wire``/``bytes_logical``/``rounds`` telemetry
counters. A raw ``lax.psum`` added to a model afterwards is traffic the
knob cannot re-schedule and the counters never see — the byte
accounting rots silently as models grow. TDA050 keeps the choke point
exhaustive: model code calls the comms layer (``comms.psum`` /
``comms.pmean`` / a ``CommSync`` / the ``collectives`` tree wrappers),
never ``lax.psum``-family ops directly.

TDA051 polices the layer's round-11 headline: the compressed payloads
move NATIVELY on the wire. PR 5's honest caveat was exactly the
pattern this rule flags — a quantized buffer widened back to int32/f32
*as it entered the collective* (``lax.psum(q.astype(jnp.int32))``),
which moved 4 bytes/elem over the interconnect while the accounting
claimed 1. Widening a received buffer AFTER the collective (the exact
int32 accumulation of the native ring) is fine and unflagged; the
regression is the widening cast between quantize and the wire.
"""

from __future__ import annotations

import ast

from tpu_distalg_torch.analysis.engine import (PKG, Rule, call_name,
                                               dotted_name, pkg_dir)

#: the raw collective-reduction ops being policed (ppermute/all_gather
#: pipelines are algorithm structure, not gradient sync — the ring
#: kernels in parallel/ own those)
_RAW_OPS = ("psum", "pmean", "psum_scatter", "pmax", "pmin")

#: call roots that mean "the raw jax op" rather than a blessed wrapper
_RAW_ROOTS = ("lax", "jax")


class RawCollectiveInModels(Rule):
    code = "TDA050"
    name = "raw cross-shard collective outside the comms layer"
    invariant = (f"every cross-shard reduction in {PKG}/models/ "
                 "routes through parallel/comms (comms.psum, a "
                 "CommSync schedule) or the collectives tree wrappers, "
                 "so all gradient/parameter traffic stays behind the "
                 "one instrumented, --comm-schedulable choke point")

    def applies(self, ctx):
        return pkg_dir("models") in ctx.path

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None or "." not in name:
                continue
            parts = name.split(".")
            if parts[-1] in _RAW_OPS and parts[0] in _RAW_ROOTS:
                yield self.violation(
                    ctx, node,
                    f"raw {name}() in model code — route the "
                    f"reduction through {PKG}.parallel.comms "
                    f"(comms.{parts[-1]} for a verbatim psum, or a "
                    f"CommSync for schedulable gradient sync) so the "
                    f"--comm knob and the comm.bytes_wire accounting "
                    f"cover it")


#: collective ops whose ARGUMENTS must stay at wire precision — a
#: widening cast feeding any of these re-inflates the payload
_WIRE_OPS = ("psum", "pmean", "pmax", "pmin", "psum_scatter",
             "ppermute", "all_to_all", "all_gather")

#: the CLUSTER tier's wire entry points (tpu_distalg_torch/cluster/): a
#: frame handed to any of these goes byte-for-byte onto the TCP
#: socket, so a quantized buffer widened on its way in is the same
#: regression at the process boundary — the host codec's int8/pair
#: payload silently re-inflated to f32/int32 while
#: cluster_wire_reduction_vs_dense claims the compressed size.
#: Matched by call TAIL under any root (``transport.send_frame``, a
#: bare imported ``send_frame``, ``sock.sendall``/``sendmsg``).
_CLUSTER_WIRE_OPS = ("send_frame", "encode_frame",
                     "encode_frame_parts", "request", "sendall",
                     "sendmsg")

#: dtypes wider than int8 — casting a quantized buffer to any of these
#: before the collective silently reintroduces the int32-psum wire
_WIDER_THAN_INT8 = frozenset((
    "int16", "int32", "int64", "uint16", "uint32", "uint64",
    "float16", "bfloat16", "float32", "float64"))


def _dtype_token(node) -> str | None:
    """The dtype a cast names: ``jnp.int32`` → 'int32', ``'int32'`` →
    'int32', ``np.dtype('int32')``-style left unresolved (None)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    name = dotted_name(node)
    if name:
        return name.rsplit(".", 1)[-1]
    return None


def _is_quantize_expr(node) -> bool:
    """Does this expression produce a quantized buffer? Either spelling
    counts: an ``.astype(int8)`` cast anywhere in the subtree, or the
    clip-of-floor/round idiom (the PR 5 code quantized into an f32
    buffer — ``clip(floor(x/scale + u))`` — and THAT buffer took the
    widening cast on its way into the psum)."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        name = call_name(sub)
        if name is None:
            continue
        tail = name.rsplit(".", 1)[-1]
        if tail == "astype" and sub.args \
                and _dtype_token(sub.args[0]) in ("int8", "uint8"):
            return True
        if tail in ("clip", "clamp"):
            inner = any(
                isinstance(s, ast.Call)
                and (call_name(s) or "").rsplit(".", 1)[-1]
                in ("floor", "round", "rint")
                for s in ast.walk(sub))
            if inner:
                return True
    return False


class WideningCastOntoWire(Rule):
    code = "TDA051"
    name = "quantized buffer widened on its way into a collective"
    invariant = (f"in {PKG}/parallel/ a buffer produced by "
                 "quantization (astype(int8) or the clip(floor(...)) "
                 "idiom) enters collectives at wire precision, and in "
                 f"{PKG}/cluster/ it enters the framed TCP "
                 "transport (send_frame/encode_frame/request/sendall) "
                 "at wire precision — a dtype-widening .astype() "
                 "between the quantize and the wire call re-inflates "
                 "the payload to int32/f32 while the byte accounting "
                 "still claims the compressed size (the PR 5 "
                 "int32-psum regression, and its cluster-wire twin)")

    def applies(self, ctx):
        return (pkg_dir("parallel") in ctx.path
                or pkg_dir("cluster") in ctx.path)

    @staticmethod
    def _is_wire_call(ctx, name: str) -> bool:
        """A call that puts its arguments on a wire: the raw jax
        collectives (parallel/ and cluster/ alike), plus — in
        cluster/ files — the transport's framing/send entry points
        under any root."""
        parts = name.split(".")
        if parts[-1] in _WIRE_OPS and parts[0] in _RAW_ROOTS:
            return True
        return (pkg_dir("cluster") in ctx.path
                and parts[-1] in _CLUSTER_WIRE_OPS)

    def check(self, ctx):
        # outermost defs only: _check_function walks nested closures
        # itself (the native ring's `exchange` shape), so visiting them
        # again here would double-report every violation inside one
        nested = set()
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(fn):
                    if sub is not fn and isinstance(
                            sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        nested.add(sub)
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) \
                    or fn in nested:
                continue
            yield from self._check_function(ctx, fn)

    def _check_function(self, ctx, fn):
        # taint pass to fixpoint: names assigned from a quantize
        # expression, or from an expression that reads a tainted name
        # (the buffer may be renamed/reshaped/relayed before the wire)
        tainted: set[str] = set()
        assigns = []

        def _collect(target, value):
            if isinstance(target, ast.Name):
                assigns.append(([target.id], value))
            elif isinstance(target, (ast.Tuple, ast.List)):
                # `q, s = quantize(b), scale`: pair element-wise when
                # the shapes line up, so the sibling name is not
                # over-tainted; otherwise taint every Name in the
                # target (a starred/mismatched unpack of a quantize
                # expr still must not escape the rule)
                if isinstance(value, (ast.Tuple, ast.List)) \
                        and len(value.elts) == len(target.elts):
                    for t, v in zip(target.elts, value.elts):
                        _collect(t, v)
                else:
                    names = [n.id for n in ast.walk(target)
                             if isinstance(n, ast.Name)]
                    assigns.append((names, value))

        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    _collect(t, node.value)
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Name):
                assigns.append(([node.target.id], node.value))
        changed = True
        while changed:
            changed = False
            for targets, value in assigns:
                if not targets or set(targets) <= tainted:
                    continue
                reads = {n.id for n in ast.walk(value)
                         if isinstance(n, ast.Name)
                         and isinstance(n.ctx, ast.Load)}
                if _is_quantize_expr(value) or (reads & tainted):
                    tainted.update(targets)
                    changed = True

        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None or not self._is_wire_call(ctx, name):
                continue
            for arg in [*node.args,
                        *(kw.value for kw in node.keywords)]:
                yield from self._widened_args(ctx, arg, tainted)

    def _widened_args(self, ctx, arg, tainted):
        """Widening .astype() on a tainted (quantized) buffer anywhere
        inside this collective argument."""
        for sub in ast.walk(arg):
            if not isinstance(sub, ast.Call) \
                    or not isinstance(sub.func, ast.Attribute) \
                    or sub.func.attr != "astype" or not sub.args:
                continue
            dt = _dtype_token(sub.args[0])
            if dt not in _WIDER_THAN_INT8:
                continue
            recv = sub.func.value
            reads = {n.id for n in ast.walk(recv)
                     if isinstance(n, ast.Name)
                     and isinstance(n.ctx, ast.Load)}
            quantized = bool(reads & tainted) or _is_quantize_expr(recv)
            if quantized:
                yield self.violation(
                    ctx, sub,
                    f"quantized buffer cast to {dt} as it enters the "
                    f"collective — this re-inflates the wire payload "
                    f"the byte accounting claims is compressed "
                    f"(int8 must ride the wire natively; widen AFTER "
                    f"the exchange, like the native ring's local "
                    f"int32 accumulation)")


RULES = (RawCollectiveInModels(), WideningCastOntoWire())
