"""Checkpoint-carry completeness — TDA100.

The bug class: a trainer's cross-step state grows a field (the topk
EF residual riding the scan carry, PR 5) and the checkpoint payload
builder — often in a DIFFERENT module — keeps serializing the old
shape. Resume then silently reconstructs partial state: the run
completes, converges a little worse, and nothing errors. Review caught
it once; this rule makes the contract structural.

Detection, over the project graph: a *field serializer* is a dict
literal whose string keys read the same-named attributes off one
object (``{"status": st.status, "admit": st.admit, ...}``) and whose
matched keys are all fields of ONE dataclass visible (defined or
imported, re-exports followed) from the builder's module. For that
dataclass, any field that is MUTATED anywhere in library code (a plain
``obj.field = ...`` / ``obj.field += ...`` write — the "changes across
steps" signal) but absent from the serializer's keys is a finding:
either the payload must carry it, or a reasoned
``# tda: ignore[TDA100]`` on the builder must say why recovery is
correct without it (liveness clocks and connection fencing state are
the legitimate examples — see cluster/coordinator.py).

Deliberate limits: container-mutations (``st.pushes[w] = v``) do not
count as field mutation (those fields are usually reconstructed from
replayed records, not snapshots), and ``jax.tree.leaves(state)``-style
whole-tree payloads are structurally complete and never looked at.
"""

from __future__ import annotations

import collections

from tpu_distalg_torch.analysis.project import ProjectRule


class CheckpointCarryCompleteness(ProjectRule):
    code = "TDA100"
    name = "mutated state field missing from checkpoint payload"
    invariant = ("every cross-step-mutated field of a state container "
                 "reaches its serializer, or a reasoned pin says why "
                 "recovery is whole without it")

    def check_project(self, project):
        # attr name -> [(module, line)] across library code
        mutated: dict = collections.defaultdict(list)
        for s in project.library():
            for attr, line in s["attr_writes"]:
                mutated[attr].append((s["module"], line))
        for s in project.library():
            visible = project.visible_dataclasses(s)
            for pb in s["payload_builders"]:
                matched = set(pb["matched"])
                candidates = [
                    (name, ds, info) for name, ds, info in visible
                    if matched <= set(info["fields"])]
                if not candidates:
                    continue
                # the serializer's dataclass: the candidate whose
                # field set the matched keys cover best; an exact tie
                # is ambiguous and skipped
                scored = sorted(
                    candidates,
                    key=lambda c: (-len(matched & set(c[2]["fields"])),
                                   len(c[2]["fields"])))
                if len(scored) > 1 and \
                        set(scored[0][2]["fields"]) \
                        == set(scored[1][2]["fields"]):
                    continue
                name, ds, info = scored[0]
                keys = set(pb["keys"])
                for field in sorted(info["fields"]):
                    if field in keys or not mutated.get(field):
                        continue
                    wm, wl = mutated[field][0]
                    yield self.project_violation(
                        project, s["path"], pb["line"],
                        f"payload serializes {name} fields "
                        f"({', '.join(sorted(matched))}) but omits "
                        f"'{field}', which is mutated across steps "
                        f"(e.g. {wm}:{wl}) — a resume from this "
                        f"payload silently drops that state (the EF-"
                        f"residual class); carry it or pin with a "
                        f"reasoned '# tda: ignore[TDA100]' stating "
                        f"why recovery is correct without it",
                        end_line=pb["end_line"])


RULES = (CheckpointCarryCompleteness(),)
