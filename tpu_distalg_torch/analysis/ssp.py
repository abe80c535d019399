"""Stale-synchronous discipline (TDA070).

The SSP layer's determinism and liveness contracts are structural:

  * STRAGGLE/MEMBERSHIP SCHEDULES ARE SEEDED. The bitwise-replay
    acceptance ("same plan → same trajectory") holds because every
    schedule is a pure function of the seeded fault plan
    (``ssp.compile_straggle_schedule`` / ``membership.compile_epochs``
    probe a plan-pure registry). One ad-hoc ``np.random.default_rng()``
    or ``random.Random()`` — constructed UNSEEDED — feeding a
    staleness, straggle, membership or epoch schedule voids the replay
    contract silently: the run still looks deterministic until the day
    two replays disagree. (TDA001 bans unseeded RNG in library code
    broadly; TDA070 additionally catches the seeded-module spellings
    ``np.random.rand/random/randint`` that a schedule sketch typically
    reaches for, when their product is schedule-named.)

  * NO UNBOUNDED WAITS ON THE CLOCK VECTOR. The SSP gate is
    compiled-in (a masked no-op tick); host-side coordination code
    must never spin ``while clock...:`` without a deadline — a
    departed shard's frozen clock would wedge the waiter forever, the
    exact stall class the heartbeat/Prefetcher guards exist to make
    impossible. A bounded wait names its bound: the loop's condition
    or body references a ``deadline``/``timeout``/``budget``/``max_*``
    name, or the loop carries a ``break``-with-raise shape via those.

Flagged shapes::

    sched = np.random.default_rng().integers(...)     # unseeded rng →
    straggle_plan = random.Random().random()          #   schedule name
    np.random.rand(n_ticks)  # module-global RNG feeding a schedule
    while clocks.min() < t:                           # unbounded wait
        time.sleep(0.1)

Fine::

    rng = np.random.default_rng(seed)                 # seeded
    extra = compile_straggle_schedule(T, S)           # plan-pure
    deadline = time.monotonic() + budget
    while clocks.min() < t and time.monotonic() < deadline:
        ...
"""

from __future__ import annotations

import ast

from tpu_distalg_torch.analysis.engine import Rule, call_name, pkg_dir

#: RNG constructors that are unseeded exactly when called with no args
_SEEDABLE_CTORS = ("np.random.default_rng", "numpy.random.default_rng",
                   "random.Random")
#: module-global RNG draws — never seedable at the call site
_GLOBAL_DRAWS = ("np.random.rand", "np.random.random",
                 "np.random.randint", "np.random.randn",
                 "numpy.random.rand", "numpy.random.random",
                 "numpy.random.randint", "numpy.random.randn",
                 "random.random", "random.randint", "random.randrange")

#: names that mark a value as an SSP schedule product
_SCHEDULE_TOKENS = ("straggle", "stalen", "member", "epoch", "schedule")

#: names that mark a wait as bounded
_BOUND_TOKENS = ("deadline", "timeout", "budget", "max_")


def _is_schedule_name(name: str) -> bool:
    low = name.lower()
    return any(tok in low for tok in _SCHEDULE_TOKENS)


def _names_in(node):
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)} \
        | {n.attr for n in ast.walk(node)
           if isinstance(n, ast.Attribute)}


class SSPScheduleDiscipline(Rule):
    code = "TDA070"
    name = "unseeded SSP schedule / unbounded clock-vector wait"
    invariant = ("stale-synchronous schedules (straggle, staleness, "
                 "membership, epochs) are pure functions of the seeded "
                 "fault plan — ad-hoc unseeded RNG voids the bitwise-"
                 "replay acceptance — and no host code waits on the "
                 "clock vector without a deadline (a departed shard's "
                 "frozen clock must surface as a timeout, not a wedge)")

    def applies(self, ctx):
        return pkg_dir("parallel") in ctx.path

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign):
                yield from self._check_schedule_assign(ctx, node)
            elif isinstance(node, ast.While):
                yield from self._check_clock_wait(ctx, node)

    def _check_schedule_assign(self, ctx, node: ast.Assign):
        targets = [t.id for t in node.targets
                   if isinstance(t, ast.Name)]
        if not any(_is_schedule_name(t) for t in targets):
            return
        for sub in ast.walk(node.value):
            if not isinstance(sub, ast.Call):
                continue
            name = call_name(sub)
            if name is None:
                continue
            unseeded_ctor = (name in _SEEDABLE_CTORS
                             and not sub.args and not sub.keywords)
            if unseeded_ctor or name in _GLOBAL_DRAWS:
                yield self.violation(
                    ctx, sub,
                    f"{name}() feeding the schedule "
                    f"{'/'.join(targets)!r} is unseeded — an SSP "
                    f"straggle/membership schedule must be a pure "
                    f"function of the seeded fault plan "
                    f"(ssp.compile_straggle_schedule / "
                    f"membership.compile_epochs) or of an explicit "
                    f"seed, or the bitwise-replay contract is void")

    def _check_clock_wait(self, ctx, node: ast.While):
        cond_names = _names_in(node.test)
        if not any("clock" in n.lower() for n in cond_names):
            return
        scope = cond_names | set()
        for sub in node.body:
            scope |= _names_in(sub)
        bounded = any(
            any(tok in n.lower() for tok in _BOUND_TOKENS)
            for n in scope)
        if bounded:
            return
        yield self.violation(
            ctx, node,
            "unbounded wait on the clock vector — a departed or wedged "
            "shard's frozen clock stalls this loop forever; bound it "
            "with a deadline/timeout (and raise on expiry) or move the "
            "gate into the compiled program like ssp.make_*_train_fn's "
            "masked no-op tick")


RULES = (SSPScheduleDiscipline(),)
