"""Geometry-literal discipline (TDA120) — hand-pinned tuner knobs in
``models/`` and ``cluster/`` stay in the tuner's default tables.

The autotuner (``tpu_distalg_torch/tune/``) makes run geometry a MEASURED
decision: ``tune/defaults.py`` is the one table of hand-pinned values
(what ``--tune off`` runs), and the resolver overrides them per rig
from a profiled cost model. A fresh int literal assigned to one of the
geometry knob names in ``tpu_distalg_torch/models/`` or
``tpu_distalg_torch/cluster/`` — a ``bucket_elems = 32768`` default, an
``n_shards: int = 4``, a ``block_rows=1024`` call-site pin — is
exactly the drift the tuner exists to end: one rig's folklore
re-hard-coded where neither the default table nor the resolver can
see it. The README's canonical numbers then silently depend on a
spelling no profile can re-derive.

Flagged (in ``models/`` and ``cluster/``)::

    block_rows = 1024                    # not in BLOCK_ROWS' values
    def f(*, ps_shards: int = 4): ...    # annotated default off-table
    RowStore(center, n_shards=4)         # call-site pin off-table

Fine::

    block_rows = 4096                    # a value the table spells
    n_shards=tune_defaults.PS_SHARDS     # sourced FROM the table
    bucket = spec.bucket_elems           # config-carried, not pinned
    block_rows = cfg.block_rows          # ditto
    n_shards = 4  # tda: ignore[TDA120] -- <why this rig-pin is right>

Values are folded with the module-consts resolver (``1 << 16`` and
``2 * HALF`` count as literals), so arithmetic re-spellings don't
evade the table.
"""

from __future__ import annotations

import ast

from tpu_distalg_torch.analysis.engine import Rule, const_int, pkg_dir

from tpu_distalg_torch.tune.defaults import GEOMETRY_KNOBS


def _keyword_pins(call: ast.Call):
    for kw in call.keywords:
        if kw.arg in GEOMETRY_KNOBS:
            yield kw.arg, kw.value, kw.value


def _assign_pins(node):
    """``(knob, value-node, report-node)`` for assignment-like pins."""
    if isinstance(node, ast.Assign):
        for tgt in node.targets:
            if isinstance(tgt, ast.Name) and tgt.id in GEOMETRY_KNOBS:
                yield tgt.id, node.value, node
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        tgt = node.target
        if isinstance(tgt, ast.Name) and tgt.id in GEOMETRY_KNOBS:
            yield tgt.id, node.value, node
    elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = node.args
        pos = a.posonlyargs + a.args
        for arg, default in zip(pos[len(pos) - len(a.defaults):],
                                a.defaults):
            if arg.arg in GEOMETRY_KNOBS:
                yield arg.arg, default, default
        for arg, default in zip(a.kwonlyargs, a.kw_defaults):
            if default is not None and arg.arg in GEOMETRY_KNOBS:
                yield arg.arg, default, default


class PinnedGeometryLiteral(Rule):
    code = "TDA120"
    name = "hand-pinned geometry literal outside the tuner tables"
    invariant = ("geometry knobs in models/ and cluster/ carry values "
                 "the tune/defaults.py table spells (or a reasoned "
                 "rig-pin), so the autotuner's resolver sees every "
                 "knob it is supposed to own")

    def applies(self, ctx):
        return (pkg_dir("models") in ctx.path
                or pkg_dir("cluster") in ctx.path)

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                pins = _keyword_pins(node)
            else:
                pins = _assign_pins(node)
            for knob, value, where in pins:
                folded = const_int(value, ctx.consts)
                if folded is None:
                    continue    # config-carried / attribute-sourced
                allowed = GEOMETRY_KNOBS[knob]
                if folded in allowed:
                    continue
                yield self.violation(
                    ctx, where,
                    f"geometry knob '{knob}' pinned to {folded}, "
                    f"which the tuner's default table does not spell "
                    f"(tune/defaults.py allows "
                    f"{', '.join(map(str, allowed))}) — one rig's "
                    f"folklore the resolver cannot see; source the "
                    f"value from tune.defaults, thread it through "
                    f"config, or keep the pin with a reasoned "
                    f"suppression")


RULES = (PinnedGeometryLiteral(),)
