"""Cross-module lock discipline — TDA103.

TDA020 already polices the single-file convention (a thread body's
shared-state write holds *a* lock), but it cannot see the cross-file
failure: two thread entries in DIFFERENT modules each dutifully lock —
different locks — around writes to the same attribute. Each file lints
clean; the program still has the r5 spliced-ADVICE race, just spread
across an import boundary.

Detection, over the project graph: every thread-entry function's
attribute writes are collected with the set of lock-ish names held at
the write (``with self._lock:`` → ``{_lock}``). Writes are grouped
cross-module — ``self.attr`` writes by (class, attr) so unrelated
classes that happen to share a field name never collide; other writes
by attribute name, and only across modules that share an import edge
(an unconnected coincidence is noise, not shared state). A group
spanning two or more modules whose lock sets have an EMPTY
intersection is the finding: no common lock orders those writes.

Heuristic on purpose: lock identity is by NAME segment, so two
modules locking distinct objects both called ``_lock`` pass — the
rule trades that false-negative for zero-alias-analysis simplicity,
the same bargain TDA020 struck.
"""

from __future__ import annotations

import collections

from tpu_distalg_torch.analysis.project import ProjectRule


class CrossModuleLockDiscipline(ProjectRule):
    code = "TDA103"
    name = "cross-module thread writes without a common lock"
    invariant = ("an attribute written from thread entries in two or "
                 "more modules is written under one shared lock, not "
                 "one lock per module")

    def check_project(self, project):
        groups: dict = collections.defaultdict(list)
        for s in project.library():
            for w in s["thread_writes"]:
                key = (("self", w["cls"], w["attr"]) if w["self"]
                       else ("obj", w["attr"]))
                groups[key].append((s, w))
        for key, sites in sorted(groups.items()):
            mods = sorted({s["module"] for s, _ in sites})
            if len(mods) < 2:
                continue
            if key[0] == "obj" and not all(
                    project.connected(mods[0], m) or
                    any(project.connected(m, m2) for m2 in mods
                        if m2 != m)
                    for m in mods):
                continue
            common = None
            for _, w in sites:
                locks = set(w["locks"])
                common = locks if common is None else common & locks
            if common:
                continue
            attr = key[-1]
            for s, w in sites:
                others = ", ".join(m for m in mods
                                   if m != s["module"])
                held = (f"under {'/'.join(w['locks'])}"
                        if w["locks"] else "with no lock held")
                yield self.project_violation(
                    project, s["path"], w["line"],
                    f"{w['entry']} writes '{attr}' {held}, but "
                    f"thread entries in {others} also write it under "
                    f"a DIFFERENT lock — no common lock orders these "
                    f"writes (the cross-file race TDA020 cannot "
                    f"see); share one lock object across the "
                    f"modules")


RULES = (CrossModuleLockDiscipline(),)
