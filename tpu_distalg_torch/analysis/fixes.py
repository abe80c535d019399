"""``tda lint --fix`` — the mechanically-safe subset.

Only fixes whose behavior-preservation is decidable from the text are
applied:

  * TDA021: insert ``daemon=False`` into a ``threading.Thread(...)``
    call — False IS the inherited default, so the edit changes nothing
    but makes the lifetime reviewable (pick True by hand where a
    watcher thread must not block exit);
  * TDA000 (reasonless suppression): scaffold the required reason slot
    (``-- TODO: justify this suppression``). The scaffolded TODO counts
    as reason text, so the suppression takes effect immediately — but
    the TODO is grep-able and marks it for review.
  * TDA000 (unused suppression): a reasoned pin that suppresses zero
    findings is dead weight that could mask a future regression —
    remove the comment (the whole line when it stood alone, just the
    trailing comment otherwise). Nothing was being suppressed, so the
    removal cannot surface new findings.
  * TDA102 (stale waiver): a ``SUMMARY_ONLY_COUNTERS`` entry matching
    zero emitted counters is the waiver-table spelling of an unused
    suppression — delete the entry's line (the table keeps one entry
    per line). It waived nothing, so nothing new can fire.

Everything else (hoisting a host sync, adding a lock, routing a write
through a seam) changes semantics and stays a human's job.
"""

from __future__ import annotations

import ast
import re

from tpu_distalg_torch.analysis.concurrency import _is_thread_call

_IGNORE_BARE_RE = re.compile(r"(tda:\s*ignore\[[A-Z0-9,\s]+\])\s*$")
_IGNORE_COMMENT_RE = re.compile(
    r"\s*#\s*tda:\s*ignore\[[A-Z0-9,\s]*\].*$")
_STALE_WAIVER_RE = re.compile(r"waiver '([^']+)' in \w+ matches no")

TODO_REASON = "TODO: justify this suppression"


def fix_file(path: str, violations) -> int:
    """Apply safe fixes for ``violations`` (all within ``path``).
    Returns the number of edits written."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    fixed_source, n = fix_source(source, violations)
    if n:
        with open(path, "w", encoding="utf-8") as f:
            f.write(fixed_source)
    return n


def _last_code_char(lines, end_line: int, end_col: int) -> str:
    """The last non-whitespace character strictly before position
    (end_line, end_col), scanning backwards across lines."""
    col = end_col
    for idx in range(end_line, -1, -1):
        chunk = lines[idx][:col] if col is not None else lines[idx]
        stripped = chunk.rstrip()
        if stripped:
            return stripped[-1]
        col = None
    return ""


def fix_source(source: str, violations) -> tuple[str, int]:
    lines = source.splitlines(keepends=True)
    tree = ast.parse(source)
    edits = []  # (line_idx, fn) applied bottom-up

    daemon_lines = {v.line for v in violations if v.code == "TDA021"}
    if daemon_lines:
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and node.lineno in daemon_lines:
                if not _is_thread_call(node):
                    continue
                end_line = node.end_lineno - 1
                end_col = node.end_col_offset - 1  # the ')'
                # the last code char before the ')' decides the
                # separator: a trailing comma (multi-line call) or the
                # bare '(' (no args) must not gain a second comma
                last = _last_code_char(lines, end_line, end_col)
                sep = "" if last in (",", "(") else ", "
                edits.append((end_line, lambda s, c=end_col, p=sep:
                              s[:c] + f"{p}daemon=False" + s[c:]))

    for v in violations:
        if v.code == "TDA000" and "without a reason" in v.message:
            idx = v.line - 1

            def scaffold(s):
                return _IGNORE_BARE_RE.sub(
                    lambda m: f"{m.group(1)} -- {TODO_REASON}",
                    s.rstrip("\n")) + ("\n" if s.endswith("\n")
                                       else "")
            if _IGNORE_BARE_RE.search(lines[idx].rstrip("\n")):
                edits.append((idx, scaffold))
        elif v.code == "TDA000" and \
                "suppresses no findings" in v.message:
            idx = v.line - 1
            if idx >= len(lines):
                continue
            stripped = lines[idx].strip()

            def drop(s):
                if s.strip().startswith("#"):
                    return ""          # an own-line pin: delete it
                out = _IGNORE_COMMENT_RE.sub("", s.rstrip("\n"))
                return out + ("\n" if s.endswith("\n") else "")
            if stripped.startswith("#") or \
                    _IGNORE_COMMENT_RE.search(lines[idx]):
                edits.append((idx, drop))
                if not stripped.startswith("#"):
                    continue
                # an own-line pin's reason often wraps onto following
                # comment lines at the same indent — they are part of
                # the pin, not standalone prose; delete them too
                # (stop at code, a blank line, a different indent, or
                # a new tda: marker; trailing pins are left alone — a
                # comment under one is usually unrelated)
                indent = lines[idx][:len(lines[idx])
                                    - len(lines[idx].lstrip())]
                j = idx + 1
                while j < len(lines) \
                        and "tda:" not in lines[j] \
                        and lines[j].startswith(indent + "#"):
                    edits.append((j, lambda s: ""))
                    j += 1

    for v in violations:
        m = _STALE_WAIVER_RE.search(v.message) \
            if v.code == "TDA102" else None
        if m is None:
            continue
        entry = m.group(1)
        # v.line anchors at the waiver TUPLE's assignment; the entry
        # itself sits on its own line below (the table's committed
        # style). Scan to the tuple's close for the quoted entry and
        # drop that line, plus any continuation comment lines riding
        # under it.
        for j in range(v.line - 1, min(v.line + 200, len(lines))):
            text = lines[j]
            if f'"{entry}"' not in text and f"'{entry}'" not in text:
                if j > v.line - 1 and text.strip().startswith(")"):
                    break
                continue
            edits.append((j, lambda s: ""))
            k = j + 1
            while k < len(lines) \
                    and lines[k].lstrip().startswith("#"):
                edits.append((k, lambda s: ""))
                k += 1
            break

    n = 0
    for idx, fn in sorted(edits, key=lambda e: -e[0]):
        new = fn(lines[idx])
        if new != lines[idx]:
            lines[idx] = new
            n += 1
    return "".join(lines), n
