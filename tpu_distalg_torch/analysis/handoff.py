"""Subprocess config handoff — TDA101.

The bug class, caught twice in PR 13 review alone: the CLI parses a
flag into a config field, a launcher re-spawns that role as a
subprocess via ``python -m tpu_distalg_torch.cli ...`` — and forgets to
forward the flag. The child then runs on the DEFAULT: the coordinator
trains a different task (``--train-json``, round 1) or runs alien
heartbeat/deadline/grace timings (round 2). Nothing crashes; the two
processes just quietly disagree.

Detection, over the project graph: *consumption sites* are
``SomethingConfig(field=args.dest, ...)`` constructions anywhere (with
one level of local dataflow, so ``spec = SyncSpec.parse(args.sync)``
still maps ``staleness=spec.staleness`` back to ``--sync``); the
argparse registry (every literal ``add_argument("--flag")``) maps each
dest to its flag spelling. *Spawners* are functions that take a
parameter annotated with that config type AND build a
``python -m *.cli`` argv. For every config field consumed from args,
the spawner's argv literals must contain at least one of the field's
source flags — ANY one, because alternates like ``--train-json``
(which overrides ``--algo``/``--n-rows``) legitimately subsume the
rest.

Fields built from values the dataflow cannot see (derived in helpers,
environment fallbacks past one hop) are not checked — the rule's
promise is "no flag the CLI demonstrably feeds this field is dropped",
not full value tracking.
"""

from __future__ import annotations

import collections

from tpu_distalg_torch.analysis.project import ProjectRule


class SubprocessConfigHandoff(ProjectRule):
    code = "TDA101"
    name = "config field not forwarded to a spawned role"
    invariant = ("every config field the CLI feeds from a flag is "
                 "forwarded by the argv builder that re-spawns the "
                 "role — a lossy handoff trains/serves a different "
                 "configuration than the caller asked for")

    def check_project(self, project):
        dest_flags: dict = collections.defaultdict(set)
        consumed: dict = collections.defaultdict(dict)
        for s in project.library():
            for dest, flags in s["argparse_flags"].items():
                dest_flags[dest].update(flags)
            for call in s["config_calls"]:
                fields = consumed[call["config"]]
                for field, dests in call["fields"].items():
                    fields.setdefault(field, set()).update(dests)
        for s in project.library():
            for sp in s["spawners"]:
                have = set(sp["flags"])
                for cfg in sp["configs"]:
                    for field, dests in sorted(
                            consumed.get(cfg, {}).items()):
                        need = set()
                        for d in sorted(dests):
                            need |= dest_flags.get(d, set())
                        if need and not (need & have):
                            yield self.project_violation(
                                project, s["path"], sp["line"],
                                f"{cfg}.{field} is fed from the CLI "
                                f"({'/'.join(sorted(need))}) but "
                                f"{sp['func']} builds a subprocess "
                                f"argv that forwards none of those "
                                f"flags — the spawned role runs on "
                                f"the default (the --train-json "
                                f"class); forward one of them")


RULES = (SubprocessConfigHandoff(),)
