"""The `tda lint` engine — AST rules, suppressions, reporting.

The framework's headline guarantees (bitwise replay, atomic publishes,
race-free emission, exhaustive fault seams) are CONVENTIONS: a single
``time.time()`` in a seeded path or a raw ``open(..., 'w')`` that
bypasses an injection seam silently voids them, and code review is the
only thing that has caught such regressions so far. This package turns
each convention into a machine-checked rule with a ``TDA0xx`` code —
the correctness floor scales with contributors instead of code review.

Layering: stdlib + :mod:`tpu_distalg_torch.telemetry` ONLY (like telemetry
and faults themselves) — ``tda lint`` must run in a bare host process
with no jax, no numpy, no backend.

Engine pieces (rules live in sibling modules, one file per invariant
family — see :data:`tpu_distalg_torch.analysis.RULES`):

  * :class:`Violation` — one finding, with a position-independent
    ``fingerprint`` (code + path + stripped source line) so baselines
    survive unrelated line drift;
  * :class:`LintContext` — a parsed file plus everything rules need:
    source lines, module-level integer constants (folded), path
    classification (library / telemetry / test code), and the comment
    markers;
  * suppressions — ``# tda: ignore[TDA0xx] -- reason`` on the flagged
    line or the line above. The reason text is REQUIRED: a bare
    ignore does not suppress and is itself reported as ``TDA000``
    (an unexplained suppression is a convention-violation with extra
    steps). ``# tda: hot-loop`` marks a loop for TDA011 the same way.
    Comments are found with :mod:`tokenize`, so look-alike text inside
    string literals (e.g. this package's own test fixtures) is inert.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import os
import re
import tokenize

#: rule codes must match this (and TDA000 is reserved for the engine:
#: syntax errors and malformed suppressions)
CODE_RE = re.compile(r"^TDA\d{3}$")

_IGNORE_RE = re.compile(
    r"tda:\s*ignore\[([A-Z0-9,\s]+)\]\s*(?:(?:--|:)\s*(\S.*))?")
_HOT_LOOP_RE = re.compile(r"tda:\s*hot-loop")

#: the package this analyzer polices, named once: every path scope of
#: every rule derives from it through :func:`pkg_dir`, and the messages
#: and invariants that name the package spell it from here
PKG = "tpu_distalg_torch"

_SKIP_DIRS = {".git", "__pycache__", ".bench_cache", ".pytest_cache",
              "node_modules", "build", "dist"}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding. ``snippet`` is the stripped source line — part of
    the fingerprint, so a baseline entry tracks the offending CODE, not
    its line number. ``end_line`` is the flagged statement's last line
    (suppression comments anywhere in that span apply)."""

    code: str
    message: str
    path: str
    line: int
    col: int
    snippet: str = ""
    end_line: int = 0

    @property
    def fingerprint(self) -> str:
        key = f"{self.code}|{self.path}|{self.snippet}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def text(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.code} {self.message}")

    def as_dict(self) -> dict:
        return {"code": self.code, "message": self.message,
                "path": self.path, "line": self.line, "col": self.col,
                "snippet": self.snippet,
                "fingerprint": self.fingerprint}


class Rule:
    """One invariant. Subclasses set the class attributes and implement
    :meth:`check`; :meth:`applies` narrows the rule to the code it
    protects (e.g. TDA001 polices library code, not tests)."""

    code: str = "TDA000"
    name: str = ""
    invariant: str = ""

    def applies(self, ctx: "LintContext") -> bool:
        return True

    def check(self, ctx: "LintContext"):
        raise NotImplementedError

    def violation(self, ctx: "LintContext", node,
                  message: str) -> Violation:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = ""
        if 1 <= line <= len(ctx.lines):
            snippet = ctx.lines[line - 1].strip()
        return Violation(code=self.code, message=message, path=ctx.path,
                         line=line, col=col, snippet=snippet,
                         end_line=getattr(node, "end_lineno", line)
                         or line)


def pkg_dir(*parts: str) -> str:
    """The path scope of a subpackage: ``pkg_dir("cluster")`` is
    ``"tpu_distalg_torch/cluster/"``, ``pkg_dir()`` the package's own
    ``"tpu_distalg_torch/"`` (rules test ``pkg_dir(...) in ctx.path``)."""
    return "/".join((PKG, *parts)) + "/"


# ---------------------------------------------------------------------
# shared AST helpers


def dotted_name(node) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    return dotted_name(call.func)


def root_name(node) -> str | None:
    """The leftmost Name of an Attribute/Subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def const_int(node, consts: dict) -> int | None:
    """Fold ``node`` to an int using literal arithmetic and the
    module-level constants in ``consts`` — the resolver behind the
    Pallas rules' "statically-computable" qualifier."""
    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, int) else None
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = const_int(node.operand, consts)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        left = const_int(node.left, consts)
        right = const_int(node.right, consts)
        if left is None or right is None:
            return None
        try:
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.FloorDiv):
                return left // right
            if isinstance(node.op, ast.Mod):
                return left % right
            if isinstance(node.op, ast.LShift):
                return left << right
            if isinstance(node.op, ast.RShift):
                return left >> right
            if isinstance(node.op, ast.Pow):
                return left ** right
        except (ZeroDivisionError, OverflowError, ValueError):
            return None
    return None


def _module_consts(tree: ast.Module) -> dict:
    """Module-level ``NAME = <int expr>`` bindings, folded iteratively
    so later constants may reference earlier ones."""
    consts: dict = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            v = const_int(stmt.value, consts)
            if v is not None:
                consts[stmt.targets[0].id] = v
    return consts


# ---------------------------------------------------------------------
# suppression / marker comments


@dataclasses.dataclass
class Suppression:
    line: int          # the code line this suppression covers
    comment_line: int  # where the comment itself sits
    codes: frozenset   # rule codes, e.g. {"TDA001"}
    reason: str        # required; "" marks a malformed suppression
    used: bool = False


@dataclasses.dataclass
class Markers:
    suppressions: list
    hot_loops: set  # code lines marked `# tda: hot-loop`
    malformed: list  # (line, message) pairs -> TDA000


def scan_markers(source: str) -> Markers:
    """Tokenize-based comment scan. An own-line comment covers the next
    code line; a trailing comment covers its own line."""
    comments: list[tuple[int, int, str]] = []  # (row, col, text)
    code_rows: set[int] = set()
    try:
        toks = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        toks = []
    for tok in toks:
        if tok.type == tokenize.COMMENT:
            comments.append((tok.start[0], tok.start[1], tok.string))
        elif tok.type not in (tokenize.NL, tokenize.NEWLINE,
                              tokenize.INDENT, tokenize.DEDENT,
                              tokenize.ENDMARKER):
            code_rows.add(tok.start[0])

    def covered_line(row: int, col: int) -> int:
        if row in code_rows:
            return row          # trailing comment
        nxt = [r for r in code_rows if r > row]
        return min(nxt) if nxt else row

    supps, hot, malformed = [], set(), []
    for row, col, text in comments:
        m = _IGNORE_RE.search(text)
        if m:
            codes = frozenset(
                c.strip() for c in m.group(1).split(",") if c.strip())
            reason = (m.group(2) or "").strip()
            target = covered_line(row, col)
            bad = [c for c in codes if not CODE_RE.match(c)]
            if bad:
                malformed.append(
                    (row, f"suppression names unknown code(s) "
                          f"{', '.join(sorted(bad))} — want TDA0xx"))
            supps.append(Suppression(line=target, comment_line=row,
                                     codes=codes, reason=reason))
        if _HOT_LOOP_RE.search(text):
            hot.add(covered_line(row, col))
    return Markers(suppressions=supps, hot_loops=hot,
                   malformed=malformed)


# ---------------------------------------------------------------------
# context + file/source entry points


@dataclasses.dataclass
class LintContext:
    path: str            # posix-normalized, as reported
    tree: ast.Module
    lines: list
    consts: dict
    markers: Markers
    is_library: bool     # under tpu_distalg_torch/ (the shipped package)
    is_telemetry: bool   # under tpu_distalg_torch/telemetry/ (owns wall time)
    is_test: bool        # under tests/ (host syncs are its job)


def norm_path(path: str) -> str:
    """Canonical posix spelling: ``./x`` == ``x`` == ``<cwd>/x`` — a
    baseline fingerprint must not depend on how the caller typed the
    path."""
    p = os.path.normpath(path)
    if os.path.isabs(p):
        rel = os.path.relpath(p)
        if not rel.startswith(".."):
            p = rel
    return p.replace(os.sep, "/")


def _classify(path: str) -> tuple[bool, bool, bool]:
    p = path
    lib = pkg_dir() in p and "/analysis/fixtures" not in p
    tel = pkg_dir("telemetry") in p
    test = "tests/" in p or os.path.basename(p).startswith("test_")
    return lib, tel, test


def make_context(source: str, path: str) -> LintContext:
    tree = ast.parse(source)
    path = norm_path(path)
    lib, tel, test = _classify(path)
    return LintContext(
        path=path, tree=tree,
        lines=source.splitlines(), consts=_module_consts(tree),
        markers=scan_markers(source), is_library=lib,
        is_telemetry=tel, is_test=test)


def _select(rules, select=None, ignore=None, known=None):
    """Filter ``rules`` by --select/--ignore codes. ``known`` widens
    the validation set (the CLI validates against per-file AND project
    rules together, then filters each family separately)."""
    known = set(known or ()) | {r.code for r in rules} | {"TDA000"}
    for group in (select or ()), (ignore or ()):
        for c in group:
            if c not in known:
                raise ValueError(
                    f"unknown rule code {c!r}; known: "
                    f"{', '.join(sorted(known))}")
    out = [r for r in rules
           if (not select or r.code in select)
           and (not ignore or r.code not in ignore)]
    return out


def apply_suppressions(violations, suppressions) -> list:
    """Drop findings covered by a REASONED suppression whose line sits
    in the finding's statement span; mark those suppressions used (the
    unused-pin report reads the flag). Shared by the per-file pass and
    the project pass so one pin serves both."""
    kept = []
    for v in sorted(violations, key=lambda v: (v.line, v.col,
                                               v.code)):
        span_end = max(v.line, v.end_line)
        supp = next(
            (s for s in suppressions
             if v.line <= s.line <= span_end
             and v.code in s.codes and s.reason),
            None)
        if supp is not None:
            supp.used = True
            continue
        kept.append(v)
    return kept


def marker_violations(ctx: "LintContext") -> list:
    """The engine's own TDA000 findings for one parsed file: bare
    (reasonless) suppressions and malformed markers."""
    out = []
    for s in ctx.markers.suppressions:
        if not s.reason:
            out.append(Violation(
                code="TDA000", path=ctx.path, line=s.comment_line,
                col=0,
                message=(
                    "suppression without a reason — write "
                    "'# tda: ignore[CODE] -- why it is safe' "
                    "(an unexplained ignore is unreviewable)"),
                snippet=ctx.lines[s.comment_line - 1].strip()
                if s.comment_line <= len(ctx.lines) else ""))
    for line, msg in ctx.markers.malformed:
        out.append(Violation(
            code="TDA000", path=ctx.path, line=line, col=0,
            message=msg,
            snippet=ctx.lines[line - 1].strip()
            if line <= len(ctx.lines) else ""))
    return out


def syntax_violation(path: str, e: SyntaxError) -> Violation:
    return Violation(
        code="TDA000", path=norm_path(path),
        line=e.lineno or 1, col=(e.offset or 1) - 1,
        message=f"file does not parse: {e.msg}",
        snippet=(e.text or "").strip())


def lint_source(source: str, path: str, rules, *,
                select=None, ignore=None) -> list:
    """Lint one source string. Returns surviving violations (TDA000
    engine findings included unless filtered)."""
    active = _select(rules, select, ignore)
    tda000 = (not select or "TDA000" in select) and \
        (not ignore or "TDA000" not in ignore)
    try:
        ctx = make_context(source, path)
    except SyntaxError as e:
        return [syntax_violation(path, e)] if tda000 else []

    found: list[Violation] = []
    for rule in active:
        if rule.applies(ctx):
            found.extend(rule.check(ctx))

    # suppressions: reasoned ones drop matching findings; bare ones
    # suppress NOTHING and are reported themselves
    kept = apply_suppressions(found, ctx.markers.suppressions)
    if tda000:
        kept.extend(marker_violations(ctx))
    return sorted(kept, key=lambda v: (v.line, v.col, v.code))


def lint_file(path: str, rules, *, select=None, ignore=None) -> list:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path, rules,
                           select=select, ignore=ignore)


def iter_python_files(paths):
    """Expand files/directories into a sorted .py file list (sorted so
    output and baselines are stable across filesystems — the linter
    holds itself to its own TDA002)."""
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in _SKIP_DIRS)
                out.extend(os.path.join(root, f)
                           for f in sorted(files)
                           if f.endswith(".py"))
        else:
            raise FileNotFoundError(f"no such path: {p}")
    return sorted(dict.fromkeys(out))
