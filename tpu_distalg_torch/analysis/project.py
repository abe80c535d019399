"""The project graph — whole-program context for the TDA1xx rules.

The TDA0xx rules each see ONE file, and the bug classes that kept
recurring in review are exactly the ones a single file cannot show: a
carry field that never reaches the checkpoint payload two modules away,
a CLI flag the subprocess launcher forgot to forward, a counter no
report line ever renders, an attribute two thread entries in different
files write under different locks. This module parses every file on the
lint surface ONCE into a JSON-able :func:`extract_summary` (defs,
dataclass fields, imports, string-literal tables, counter emissions,
argv builders, thread-entry writes, suppression markers), assembles
them into a :class:`ProjectContext` with cross-module symbol
resolution, and hands that to :class:`ProjectRule` subclasses — the
``TDA1xx`` family — alongside the unchanged per-file pass.

Summaries are content-addressed: :func:`build_project` caches them
under ``.bench_cache/lint_graph_torch.json`` keyed by source sha1, so
``tda lint --changed`` re-extracts only edited files while the
interprocedural rules still see the WHOLE program.

Layering: stdlib + :mod:`tpu_distalg_torch.analysis.engine` only — same
bare-host contract as the engine (no jax, no numpy).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import time

from tpu_distalg_torch.analysis import engine

#: bump when extract_summary's output shape OR semantics change —
#: stale cache entries from an older extractor must re-extract, not
#: half-parse (2: package-anchored module names; 3: wire-protocol
#: facts for the TDA11x family)
EXTRACT_VERSION = 3

#: the port's own cache file: the JAX package's analyzer keeps
#: ``lint_graph.json`` in the same directory, and neither reads the
#: other's summaries
CACHE_NAME = "lint_graph_torch.json"


def module_name(path: str) -> str:
    """Dotted module spelling of a repo-relative path:
    ``tpu_distalg_torch/cluster/local.py`` → ``tpu_distalg_torch.cluster.local``,
    package ``__init__.py`` collapses onto the package. A
    SUBDIRECTORY invocation (``cd tpu_distalg_torch && tda lint analysis``)
    prepends the enclosing package dirs above the cwd, so the name
    still matches absolute-import spellings and cross-module
    resolution does not silently degrade."""
    p = engine.norm_path(path)
    base = p[:-3] if p.endswith(".py") else p
    parts = [seg for seg in base.split("/") if seg not in (".", "")]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    if not os.path.isabs(p):
        d = os.getcwd()
        while os.path.isfile(os.path.join(d, "__init__.py")):
            parts.insert(0, os.path.basename(d))
            d = os.path.dirname(d)
    return ".".join(parts)


# ---------------------------------------------------------------------
# summary extraction (everything below must stay JSON-serializable)


def _str_consts(node) -> list:
    return [n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def _args_dests(node) -> set:
    """argparse dests read as ``args.<dest>`` anywhere under node."""
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and \
                isinstance(n.value, ast.Name) and n.value.id == "args":
            out.add(n.attr)
    return out


def _joined_prefix(node: ast.JoinedStr) -> str:
    """The leading constant text of an f-string (empty when it starts
    with a formatted value)."""
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            break
    return "".join(parts)


def _joined_pattern(node: ast.JoinedStr) -> str:
    """Regex matching every instantiation of an f-string name (the
    bench tripwire's template shape)."""
    import re as _re

    return "^" + "".join(
        _re.escape(v.value)
        if isinstance(v, ast.Constant) else ".+"
        for v in node.values) + "$"


def _is_dataclass_def(node: ast.ClassDef) -> bool:
    for d in node.decorator_list:
        target = d.func if isinstance(d, ast.Call) else d
        name = engine.dotted_name(target)
        if name is not None and name.rsplit(".", 1)[-1] == "dataclass":
            return True
    return False


def _fn_locals(fn) -> set:
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For)):
            if isinstance(node.target, ast.Name):
                out.add(node.target.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
    args = getattr(fn, "args", None)
    if args is not None:
        out.update(a.arg for a in args.args + args.kwonlyargs)
    return out


def _walk_functions(tree):
    """(qualname, class_name_or_None, node) for every function def,
    depth-first, qualified like ``Class.method``."""
    def rec(node, qual, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                q = f"{qual}.{child.name}" if qual else child.name
                yield q, cls, child
                yield from rec(child, q, cls)
            elif isinstance(child, ast.ClassDef):
                q = f"{qual}.{child.name}" if qual else child.name
                yield from rec(child, q, child.name)
            else:
                yield from rec(child, qual, cls)
    yield from rec(tree, "", None)


def _lock_segments(expr) -> set:
    """Lower-cased name segments containing 'lock' in a with-item —
    the cross-module spelling of concurrency._lockish."""
    out = set()
    for leaf in ast.walk(expr):
        seg = None
        if isinstance(leaf, ast.Name):
            seg = leaf.id
        elif isinstance(leaf, ast.Attribute):
            seg = leaf.attr
        if seg is not None and "lock" in seg.lower():
            out.add(seg.lower())
    return out


def _thread_entries(tree):
    """(class_name_or_None, function_node, how) triples that run ON a
    thread — Thread(target=name), Thread(target=self.meth), and
    ``run`` methods of Thread subclasses — resolved project-file-wide
    (the concurrency.py walker, grown method targets)."""
    plain_targets = set()
    method_targets = set()   # (class, method) via target=self.meth
    for qual, cls, fn in _walk_functions(tree):
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and (engine.call_name(node) or "").rsplit(
                        ".", 1)[-1] == "Thread"):
                continue
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                if isinstance(kw.value, ast.Name):
                    plain_targets.add(kw.value.id)
                elif isinstance(kw.value, ast.Attribute) and \
                        isinstance(kw.value.value, ast.Name) and \
                        kw.value.value.id == "self" and cls:
                    method_targets.add((cls, kw.value.attr))
    for qual, cls, fn in _walk_functions(tree):
        if cls is None and fn.name in plain_targets:
            yield None, fn, f"Thread target {fn.name}"
        elif cls is not None and (cls, fn.name) in method_targets:
            yield cls, fn, f"Thread target {cls}.{fn.name}"
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and any(
                (engine.dotted_name(b) or "").rsplit(".", 1)[-1]
                == "Thread" for b in node.bases):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) \
                        and item.name == "run":
                    yield node.name, item, f"{node.name}.run"


def _scan_thread_writes(cls, fn, how, out):
    local = _fn_locals(fn)

    def rec(node, held):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                continue
            now = held
            if isinstance(child, (ast.With, ast.AsyncWith)):
                segs = set()
                for item in child.items:
                    segs |= _lock_segments(item.context_expr)
                if segs:
                    now = held | segs
            if isinstance(child, (ast.Assign, ast.AugAssign)):
                targets = (child.targets
                           if isinstance(child, ast.Assign)
                           else [child.target])
                for t in targets:
                    if not isinstance(t, ast.Attribute):
                        continue
                    root = engine.root_name(t)
                    if root is None or (root in local
                                        and root != "self"):
                        continue
                    out.append({
                        "entry": how, "cls": cls, "attr": t.attr,
                        "self": root == "self",
                        "locks": sorted(now), "line": t.lineno})
            rec(child, now)
    rec(fn, frozenset())


def extract_summary(source: str, path: str) -> dict:
    """One file's project-graph contribution. Raises ``SyntaxError``
    for unparseable sources (callers record an ``error`` stub; the
    per-file pass owns the TDA000)."""
    return summarize_context(engine.make_context(source, path))


def summarize_context(ctx: "engine.LintContext") -> dict:
    """The extraction itself, from an already-parsed context —
    ``lint_tree`` hands its per-file contexts in so a cold-cache run
    parses each file once, not twice."""
    tree = ctx.tree
    mod = module_name(ctx.path)
    pkg_parts = mod.split(".")
    # module_name already collapsed __init__ onto its package, so a
    # package module strips one level FEWER for relative imports
    # (level=1 inside a package __init__ means the package itself)
    is_pkg = ctx.path.endswith("/__init__.py") \
        or ctx.path == "__init__.py"

    imports: dict = {}
    import_modules: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    imports[alias.asname] = alias.name
                else:
                    imports[alias.name.split(".")[0]] = \
                        alias.name.split(".")[0]
                import_modules.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # relative import: resolved against this module's
                # package (one level strips the module itself —
                # except in a package __init__, whose dotted name IS
                # the package)
                strip = node.level - 1 if is_pkg else node.level
                base = pkg_parts[:len(pkg_parts) - strip] \
                    if strip else list(pkg_parts)
                base += (node.module or "").split(".") \
                    if node.module else []
                base_mod = ".".join(p for p in base if p)
            else:
                base_mod = node.module or ""
            if base_mod:
                import_modules.add(base_mod)
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                imports[local] = f"{base_mod}.{alias.name}" \
                    if base_mod else alias.name
                import_modules.add(f"{base_mod}.{alias.name}"
                                   if base_mod else alias.name)

    str_tuples: dict = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, (ast.Tuple, ast.List,
                                            ast.Set)):
            elts = stmt.value.elts
            if elts and all(isinstance(e, ast.Constant)
                            and isinstance(e.value, str)
                            for e in elts):
                str_tuples[stmt.targets[0].id] = {
                    "values": [e.value for e in elts],
                    "line": stmt.lineno}

    dclasses: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and _is_dataclass_def(node):
            fields = {}
            for item in node.body:
                if isinstance(item, ast.AnnAssign) \
                        and isinstance(item.target, ast.Name):
                    fields[item.target.id] = item.lineno
            dclasses[node.name] = {"line": node.lineno,
                                   "fields": fields}

    attr_writes: list = []
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute):
                attr_writes.append([t.attr, t.lineno])

    payload_builders: list = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        pairs = [(k.value, v) for k, v in zip(node.keys, node.values)
                 if isinstance(k, ast.Constant)
                 and isinstance(k.value, str) and v is not None]
        if len(pairs) < 2:
            continue
        matched = [k for k, v in pairs
                   if any(isinstance(n, ast.Attribute) and n.attr == k
                          for n in ast.walk(v))]
        if len(matched) >= 2:
            payload_builders.append({
                "keys": [k for k, _ in pairs], "matched": matched,
                "line": node.lineno,
                "end_line": node.end_lineno or node.lineno})

    counter_emits: list = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and node.args):
            continue
        name = engine.call_name(node)
        kind = (name or "").rsplit(".", 1)[-1]
        if kind not in ("counter", "gauge"):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                        str):
            counter_emits.append({"kind": kind, "name": arg.value,
                                  "prefix": None,
                                  "line": node.lineno})
        elif isinstance(arg, ast.JoinedStr):
            prefix = _joined_prefix(arg)
            if prefix:
                counter_emits.append({"kind": kind, "name": None,
                                      "prefix": prefix,
                                      "line": node.lineno})

    metric_dicts: list = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        for k, v in zip(node.keys, node.values):
            if not (isinstance(k, ast.Constant)
                    and k.value == "metric"):
                continue
            if isinstance(v, ast.Constant) and isinstance(v.value,
                                                          str):
                metric_dicts.append({"name": v.value,
                                     "pattern": None,
                                     "line": node.lineno})
            elif isinstance(v, ast.JoinedStr):
                metric_dicts.append({"name": None,
                                     "pattern": _joined_pattern(v),
                                     "line": node.lineno})

    argparse_flags: dict = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument" and node.args):
            continue
        arg0 = node.args[0]
        if not (isinstance(arg0, ast.Constant)
                and isinstance(arg0.value, str)
                and arg0.value.startswith("--")):
            continue
        dest = arg0.value[2:].replace("-", "_")
        for kw in node.keywords:
            if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                dest = kw.value.value
        argparse_flags.setdefault(dest, [])
        if arg0.value not in argparse_flags[dest]:
            argparse_flags[dest].append(arg0.value)

    config_calls: list = []
    for qual, cls, fn in _walk_functions(tree):
        # one-level local dataflow, in line order: `spec =
        # SyncSpec.parse(args.sync)` makes `spec` carry dest 'sync'
        local_dests: dict = {}
        assigns = sorted(
            (n for n in ast.walk(fn) if isinstance(n, ast.Assign)
             and len(n.targets) == 1
             and isinstance(n.targets[0], ast.Name)),
            key=lambda n: n.lineno)
        for a in assigns:
            dests = set(_args_dests(a.value))
            for n in ast.walk(a.value):
                if isinstance(n, ast.Name) and n.id in local_dests:
                    dests |= local_dests[n.id]
            if dests:
                local_dests[a.targets[0].id] = dests
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and node.keywords):
                continue
            cname = (engine.call_name(node) or "").rsplit(".", 1)[-1]
            if not cname.endswith("Config"):
                continue
            fields = {}
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                dests = set(_args_dests(kw.value))
                for n in ast.walk(kw.value):
                    if isinstance(n, ast.Name) \
                            and n.id in local_dests:
                        dests |= local_dests[n.id]
                if dests:
                    fields[kw.arg] = sorted(dests)
            if fields:
                config_calls.append({"config": cname,
                                     "fields": fields,
                                     "line": node.lineno})

    spawners: list = []
    for qual, cls, fn in _walk_functions(tree):
        consts = _str_consts(fn)
        if "-m" not in consts or not any(".cli" in c or c == "cli"
                                         for c in consts):
            continue
        configs = []
        for a in fn.args.args + fn.args.kwonlyargs:
            ann = a.annotation
            if ann is None:
                continue
            name = engine.dotted_name(ann) or (
                ann.value if isinstance(ann, ast.Constant)
                and isinstance(ann.value, str) else None)
            if name is not None and \
                    name.rsplit(".", 1)[-1].endswith("Config"):
                configs.append(name.rsplit(".", 1)[-1])
        if configs:
            spawners.append({
                "func": qual, "line": fn.lineno,
                "flags": sorted({c for c in consts
                                 if c.startswith("--")}),
                "configs": configs})

    thread_writes: list = []
    for cls, fn, how in _thread_entries(tree):
        _scan_thread_writes(cls, fn, how, thread_writes)

    report_like = any(
        isinstance(n, ast.FunctionDef)
        and n.name in ("render", "summarize") for n in tree.body) \
        or "SUMMARY_ONLY_COUNTERS" in str_tuples \
        or "PER_WORKER_PREFIXES" in str_tuples
    report_strings = sorted({s for s in _str_consts(tree)
                             if len(s) <= 80}) if report_like else []

    # late import: protocol.py builds ON the project graph (ProjectRule
    # base, _walk_functions) while its extractor feeds the summaries
    from tpu_distalg_torch.analysis import protocol as _protocol

    return {
        "version": EXTRACT_VERSION,
        "path": ctx.path,
        "module": mod,
        "is_test": ctx.is_test,
        "is_library": ctx.is_library,
        "imports": imports,
        "import_modules": sorted(import_modules),
        "str_tuples": str_tuples,
        "dataclasses": dclasses,
        "attr_writes": attr_writes,
        "payload_builders": payload_builders,
        "counter_emits": counter_emits,
        "metric_dicts": metric_dicts,
        "argparse_flags": argparse_flags,
        "config_calls": config_calls,
        "spawners": spawners,
        "thread_writes": thread_writes,
        "report_like": report_like,
        "report_strings": report_strings,
        "protocol": _protocol.extract_protocol(tree, imports),
        "suppressions": [
            # tda: ignore[TDA100] -- `used` is per-run matching state
            # (which findings a pin absorbed THIS run), not part of
            # the durable marker; persisting it would be wrong
            {"line": s.line, "comment_line": s.comment_line,
             "codes": sorted(s.codes), "reason": s.reason}
            for s in ctx.markers.suppressions],
    }


# ---------------------------------------------------------------------
# the assembled graph


class ProjectContext:
    """Every summary, indexed by path and dotted module, plus the
    cross-module resolution helpers rules lean on. ``lines(path)``
    lazily (re)reads sources so cached summaries can still mint
    fingerprint snippets."""

    def __init__(self, summaries: dict):
        self.summaries = summaries          # norm path -> summary
        self.by_module = {s["module"]: s for s in summaries.values()
                          if "error" not in s}
        self._lines: dict = {}

    def __iter__(self):
        for path in sorted(self.summaries):
            s = self.summaries[path]
            if "error" not in s:
                yield s

    def library(self):
        """Non-test summaries — where the interprocedural contracts
        live (tests may emit fixture counters, spawn fixture threads)."""
        return (s for s in self if not s["is_test"])

    def lines(self, path: str) -> list:
        if path not in self._lines:
            try:
                with open(path, encoding="utf-8") as f:
                    self._lines[path] = f.read().splitlines()
            except OSError:
                self._lines[path] = []
        return self._lines[path]

    def snippet(self, path: str, line: int) -> str:
        lines = self.lines(path)
        return lines[line - 1].strip() if 1 <= line <= len(lines) \
            else ""

    def resolve_symbol(self, mod: str, sym: str, _depth: int = 0):
        """Follow re-export chains: ``(defining_summary, kind, info)``
        for a dataclass named ``sym`` importable from ``mod``, else
        None. One deliberate limit (documented in ARCHITECTURE): no
        dynamic dispatch, no decorator factories — a symbol is only
        resolved through literal ``import``/``from-import`` spellings."""
        if _depth > 5:
            return None
        s = self.by_module.get(mod)
        if s is None:
            return None
        if sym in s["dataclasses"]:
            return s, "dataclass", s["dataclasses"][sym]
        target = s["imports"].get(sym)
        if target and "." in target:
            m2, s2 = target.rsplit(".", 1)
            return self.resolve_symbol(m2, s2, _depth + 1)
        return None

    def visible_dataclasses(self, summary: dict):
        """(class_name, defining_summary, info) visible from a module:
        defined locally, imported by name, or reachable as an
        attribute of an imported module."""
        seen = {}
        for name, info in summary["dataclasses"].items():
            seen[name] = (summary, info)
        for local, target in summary["imports"].items():
            if target in self.by_module:
                for name, info in \
                        self.by_module[target]["dataclasses"].items():
                    seen.setdefault(name, (self.by_module[target],
                                           info))
            elif "." in target:
                m2, s2 = target.rsplit(".", 1)
                hit = self.resolve_symbol(m2, s2)
                if hit is not None:
                    seen.setdefault(s2, (hit[0], hit[2]))
        return [(name, s, info) for name, (s, info) in seen.items()]

    def connected(self, mod_a: str, mod_b: str) -> bool:
        """Modules share an import edge (either direction)."""
        a = self.by_module.get(mod_a)
        b = self.by_module.get(mod_b)
        if a is None or b is None:
            return False
        return mod_b in a["import_modules"] \
            or mod_a in b["import_modules"] \
            or any(t.startswith(mod_b + ".")
                   for t in a["import_modules"]) \
            or any(t.startswith(mod_a + ".")
                   for t in b["import_modules"])

    def suppressions_for(self, path: str):
        s = self.summaries.get(path)
        if s is None or "error" in s:
            return []
        return [engine.Suppression(
            line=d["line"], comment_line=d["comment_line"],
            codes=frozenset(d["codes"]), reason=d["reason"])
            for d in s["suppressions"]]


class ProjectRule(engine.Rule):
    """A rule that sees the whole program. ``check`` (the per-file
    hook) is a no-op; subclasses implement :meth:`check_project`."""

    def check(self, ctx):
        return ()

    def check_project(self, project: ProjectContext):
        raise NotImplementedError

    def project_violation(self, project, path, line, message,
                          end_line: int = 0):
        return engine.Violation(
            code=self.code, message=message, path=path, line=line,
            col=0, snippet=project.snippet(path, line),
            end_line=end_line or line)


# ---------------------------------------------------------------------
# content-hash cache + builder


def _load_cache(cache_path: str) -> dict:
    try:
        with open(cache_path, encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("version") == EXTRACT_VERSION:
            return doc.get("files", {})
    except (OSError, ValueError):
        pass
    return {}


def _save_cache(cache_path: str, files: dict) -> None:
    tmp = f"{cache_path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"version": EXTRACT_VERSION, "files": files}, f)
        os.replace(tmp, cache_path)
    except OSError:
        # cache is a luxury: an unwritable dir must not fail the lint
        try:
            os.unlink(tmp)
        except OSError:
            pass


def build_project(files, *, cache_dir: str | None = None,
                  sources: dict | None = None,
                  contexts: dict | None = None):
    """Extract every file (cache hits skipped), assemble the graph.
    Returns ``(ProjectContext, n_cached)``. ``sources``/``contexts``
    (norm_path-keyed) let the orchestrator share its per-file reads
    and parses so a cold-cache run does each once."""
    sources = sources or {}
    contexts = contexts or {}
    cache_path = os.path.join(cache_dir, CACHE_NAME) \
        if cache_dir else None
    old = _load_cache(cache_path) if cache_path else {}
    # a subset invocation must not evict the rest of the surface from
    # the shared cache — carry forward entries for files still on disk
    new_cache: dict = {p: e for p, e in old.items()
                       if os.path.exists(p)}
    summaries: dict = {}
    n_cached = 0
    for path in files:
        p = engine.norm_path(path)
        source = sources.get(p)
        if source is None:
            try:
                with open(path, encoding="utf-8") as f:
                    source = f.read()
            except OSError as e:
                summaries[p] = {"path": p, "module": module_name(p),
                                "error": str(e)}
                continue
        sha = hashlib.sha1(source.encode()).hexdigest()
        ent = old.get(p)
        if ent and ent.get("sha") == sha:
            summaries[p] = ent["summary"]
            n_cached += 1
        elif p in contexts:
            summaries[p] = summarize_context(contexts[p])
        else:
            try:
                summaries[p] = extract_summary(source, path)
            except SyntaxError as e:
                # the per-file pass reports the TDA000; the graph
                # just records the hole so rules skip it
                summaries[p] = {"path": p, "module": module_name(p),
                                "error": f"syntax: {e.msg}"}
        new_cache[p] = {"sha": sha, "summary": summaries[p]}
    if cache_path:
        _save_cache(cache_path, new_cache)
    return ProjectContext(summaries), n_cached


# ---------------------------------------------------------------------
# the whole-tree orchestrator (per-file pass + project pass + shared
# suppression accounting)


@dataclasses.dataclass
class LintResult:
    violations: list
    n_files: int        # project-graph surface
    n_linted: int       # files the per-file pass ran on
    n_cached: int       # graph summaries served from cache
    graph_seconds: float


def lint_tree(files, rules, project_rules, *, select=None, ignore=None,
              changed_only=None, cache_dir: str | None = None
              ) -> LintResult:
    """Lint ``files``: per-file TDA0xx rules over every file (or just
    ``changed_only`` paths when given — the ``--changed`` incremental
    mode), the TDA1xx project pass over the FULL surface, suppressions
    applied once across both so a pin consumed by either pass counts
    as used — and, on unfiltered runs, unused reasoned suppressions
    reported like stale baseline entries."""
    known = {r.code for r in tuple(rules) + tuple(project_rules)}
    active = engine._select(rules, select, ignore, known=known)
    active_project = engine._select(project_rules, select, ignore,
                                    known=known)
    tda000 = (not select or "TDA000" in select) and \
        (not ignore or "TDA000" not in ignore)

    per_file = list(files) if changed_only is None else [
        f for f in files if engine.norm_path(f) in changed_only]

    # read + parse the per-file targets ONCE; build_project reuses
    # these contexts for its cache misses instead of re-parsing
    sources: dict = {}
    contexts: dict = {}
    extra: list = []          # TDA000 findings minted here
    for path in per_file:
        p = engine.norm_path(path)
        with open(path, encoding="utf-8") as f:
            sources[p] = f.read()
        try:
            contexts[p] = engine.make_context(sources[p], path)
        except SyntaxError as e:
            if tda000:
                extra.append(engine.syntax_violation(path, e))

    t0 = time.monotonic()
    project, n_cached = (build_project(files, cache_dir=cache_dir,
                                       sources=sources,
                                       contexts=contexts)
                         if active_project
                         else (ProjectContext({}), 0))
    graph_seconds = time.monotonic() - t0

    found_by_path: dict = {}
    markers_by_path: dict = {}
    linted: set = set()
    for p in sorted(contexts):
        ctx = contexts[p]
        linted.add(ctx.path)
        markers_by_path[ctx.path] = ctx.markers
        bucket = found_by_path.setdefault(ctx.path, [])
        for rule in active:
            if rule.applies(ctx):
                bucket.extend(rule.check(ctx))
        if tda000:
            extra.extend(engine.marker_violations(ctx))

    for rule in active_project:
        for v in rule.check_project(project):
            found_by_path.setdefault(v.path, []).append(v)

    kept: list = list(extra)
    for path, found in found_by_path.items():
        markers = markers_by_path.get(path)
        supps = (markers.suppressions if markers is not None
                 else project.suppressions_for(path))
        kept.extend(engine.apply_suppressions(found, supps))

    # unused reasoned pins: only meaningful when every rule ran over
    # the file (a --select/--ignore run would misread filtered-out
    # findings as rot)
    if tda000 and not select and not ignore:
        for path in sorted(linted):
            markers = markers_by_path[path]
            for s in markers.suppressions:
                if s.reason and not s.used:
                    kept.append(engine.Violation(
                        code="TDA000", path=path,
                        line=s.comment_line, col=0,
                        message=(
                            f"suppression "
                            f"[{', '.join(sorted(s.codes))}] "
                            f"suppresses no findings — the pinned "
                            f"violation is gone; remove the comment "
                            f"(`tda lint --fix` does) so dead pins "
                            f"cannot mask a future regression"),
                        snippet=project.snippet(path, s.comment_line)
                        or _line_of(path, s.comment_line)))
    kept.sort(key=lambda v: (v.path, v.line, v.col, v.code))
    return LintResult(violations=kept, n_files=len(list(files)),
                      n_linted=len(linted), n_cached=n_cached,
                      graph_seconds=round(graph_seconds, 3))


def _line_of(path: str, line: int) -> str:
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        return lines[line - 1].strip() if 1 <= line <= len(lines) \
            else ""
    except OSError:
        return ""
