"""Lint baselines — grandfathered violations, pinned and auditable.

A baseline lets ``tda lint`` gate NEW violations in CI while known ones
are burned down: the committed ``tpu_distalg_torch/lint_baseline.json``
holds a
fingerprint per grandfathered finding (code + path + stripped source
line — line-number drift does not invalidate it). Two properties keep
it honest:

  * matching is a MULTISET per fingerprint: baselining one violation
    does not silently cover a second identical one added later;
  * a stale entry (its violation no longer exists) is an ERROR, not a
    quiet success — the baseline must shrink with the debt, or it
    becomes a pile of permanent exemptions nobody can audit.

``tda lint --update-baseline`` regenerates the file from the current
tree.
"""

from __future__ import annotations

import collections
import json
import os

from tpu_distalg_torch.analysis.engine import PKG

VERSION = 1


def save(path: str, violations) -> dict:
    """Write a baseline covering ``violations``; returns the document."""
    counts = collections.Counter(
        (v.code, v.path, v.fingerprint, v.snippet) for v in violations)
    doc = {
        "version": VERSION,
        "entries": [
            {"code": code, "path": p, "fingerprint": fp,
             "snippet": snippet, "count": n}
            for (code, p, fp, snippet), n in sorted(counts.items())
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("version") != VERSION:
        raise ValueError(
            f"baseline {path} has version {doc.get('version')!r}; "
            f"this linter speaks {VERSION} — regenerate with "
            f"'tda lint --update-baseline'")
    return doc


def apply(doc: dict, violations):
    """Split ``violations`` into (new, baselined) and report stale
    entries. Returns ``(new, baselined, stale)`` where ``stale`` is the
    list of baseline entries with fewer live matches than their
    count."""
    budget = {
        (e["code"], e["path"], e["fingerprint"]): int(e.get("count", 1))
        for e in doc.get("entries", [])
    }
    used: collections.Counter = collections.Counter()
    new, baselined = [], []
    for v in violations:
        key = (v.code, v.path, v.fingerprint)
        if used[key] < budget.get(key, 0):
            used[key] += 1
            baselined.append(v)
        else:
            new.append(v)
    stale = [
        e for e in doc.get("entries", [])
        if used[(e["code"], e["path"], e["fingerprint"])]
        < int(e.get("count", 1))
    ]
    return new, baselined, stale


#: the port's own baseline, inside its package: the repo root's
#: ``lint_baseline.json`` is the JAX package's, and ``--update-baseline``
#: must never overwrite it
DEFAULT_PATH = f"{PKG}/lint_baseline.json"


def resolve(path: str | None) -> str | None:
    """Default baseline: :data:`DEFAULT_PATH` under the cwd when it
    exists and no explicit path was given."""
    if path is not None:
        return path
    return DEFAULT_PATH if os.path.exists(DEFAULT_PATH) else None
