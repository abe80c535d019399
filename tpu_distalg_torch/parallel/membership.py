"""Elastic shard membership: generation-numbered epochs.

Port of ``tpu_distalg/parallel/membership.py``: :class:`Epoch`,
:func:`compile_epochs`, :func:`emit_epoch_event`,
:func:`redistribute_clocks`, :func:`describe_renegotiation`,
:func:`run_elastic` and ``_cat_streams`` (``:47-337``).

Two mechanisms, both deterministic:

  * in-process epochs: :func:`compile_epochs` turns the seeded plan's
    ``shard:leave`` rules into a list of epochs (one probe per (window
    boundary, shard) cell, in order), so they equal the JAX package's. A
    departed shard keeps running its emulated program but is masked:
    zero merge weight, no local steps;
  * across processes: a checkpointed SSP run resumed on another shard
    count renegotiates instead of refusing. The checkpoint records the
    shard count that wrote it; the trainer re-derives per-shard state
    from the replicated center and :func:`redistribute_clocks`.

The JAX package's preemption exit (rc 75 at a window boundary after the
save) and its ``segment:run`` injection seam wait for ROADMAP A12.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

from tpu_distalg_torch.faults import registry as fregistry


@dataclasses.dataclass(frozen=True)
class Epoch:
    """One membership generation: windows [start, end) run with the
    fixed ``active`` shard set."""

    gen: int
    start: int
    end: int
    active: tuple[bool, ...]

    @property
    def n_active(self) -> int:
        return sum(self.active)


def compile_epochs(n_windows: int, n_shards: int, *,
                   plan=None) -> list[Epoch]:
    """Membership epochs from the plan's ``shard:leave`` rules: a fired
    ``leave:r`` marks the shard absent for the next ``ceil(r)`` windows
    (default 2), overlapping absences extend, a leave that would empty
    the active set keeps the longest-absent shard, and the generation
    increments at every change of the active set."""
    live = fregistry.active()
    if plan is None:
        plan = live.plan if live is not None else None
    absent_until = np.zeros(n_shards, np.int64)
    has_rules = plan is not None and any(
        r.point == "shard:leave" for r in plan.rules)
    reg = (fregistry.FaultRegistry(plan, quiet=True)
           if has_rules else None)
    epochs: list[Epoch] = []
    gen = 1
    cur: tuple[bool, ...] | None = None
    for b in range(n_windows):
        if has_rules:
            for k in range(n_shards):
                hit = reg.probe("shard:leave")
                if hit is None:
                    continue
                _, arg = hit
                away = int(np.ceil(arg if arg is not None
                                   else fregistry.DEFAULT_LEAVE_WINDOWS))
                absent_until[k] = max(absent_until[k], b + max(1, away))
        active = tuple(bool(absent_until[k] <= b)
                       for k in range(n_shards))
        if not any(active):
            keep = int(np.argmin(absent_until))
            active = tuple(k == keep for k in range(n_shards))
        if active != cur:
            if epochs:
                epochs[-1] = dataclasses.replace(epochs[-1], end=b)
            if cur is not None:
                gen += 1
            epochs.append(Epoch(gen=gen, start=b, end=n_windows,
                                active=active))
            cur = active
    if not epochs:
        epochs.append(Epoch(gen=1, start=0, end=n_windows,
                            active=(True,) * n_shards))
    if reg is not None and live is not None and live.plan == plan:
        live.record(reg.fired)
    return epochs


def emit_epoch_event(epoch: Epoch, *, reason: str,
                     prev_active: int | None = None) -> None:
    """A ``membership_epoch`` event (no-op without telemetry)."""
    from tpu_distalg_torch.telemetry import events as tevents

    tevents.emit("membership_epoch", gen=epoch.gen,
                 n_active=epoch.n_active,
                 prev_active=prev_active, reason=reason,
                 active=[int(a) for a in epoch.active])


def redistribute_clocks(clocks, n_new: int):
    """Clocks for a renegotiated geometry: every member of the new
    generation resumes at the maximum clock."""
    c = np.asarray(clocks)
    top = int(c.max()) if c.size else 0
    return np.full((n_new,), top, np.int64)


def describe_renegotiation(gen: int, n_old: int, n_new: int) -> str:
    return (f"[ssp] ring renegotiated: {n_old} -> {n_new} shard(s), "
            f"membership generation {gen} (geometry re-derived; "
            f"sharded state re-derived from the replicated center)")


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def run_elastic(checkpoint_dir: str | None, checkpoint_every: int,
                n_windows: int, n_shards: int, *, make_seg_fn, run_seg,
                state0, renegotiate=None, on_epoch=None, tag: str = "",
                ticks_per_window: int = 1, keep: int = 3, logger=None):
    """The elastic windowed training loop (JAX ``membership.py:149``).

    Each segment runs with one active set and one function
    (``make_seg_fn(active, n_win)``, cached per pair); segment
    boundaries are the union of epoch boundaries and every
    ``checkpoint_every`` windows. ``run_seg(fn, state, win0, n_win,
    epoch)`` returns ``(state, outs)``, ``outs`` a tuple of per-window
    streams concatenated across segments. With ``checkpoint_dir`` the
    state, the streams and the shard count are saved after each segment
    (:mod:`tpu_distalg_torch.utils.checkpoint`, the newest ``keep``
    kept); a resume on another shard count calls
    ``renegotiate(saved_leaves, saved_shards, start_window)``, and one
    under another tag (another bound, or a BSP checkpoint) raises.

    Returns ``(state, outs_concat, start_window, epochs)``."""
    from tpu_distalg_torch.telemetry import events as tevents
    from tpu_distalg_torch.utils import checkpoint as ckpt
    from tpu_distalg_torch.utils import metrics

    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    log = logger or functools.partial(print, file=sys.stderr)
    epochs = compile_epochs(n_windows, n_shards)
    state = tuple(state0)
    start = 0
    outs_parts: list[tuple[np.ndarray, ...]] = []

    restored = None
    if checkpoint_dir and ckpt.latest_step(checkpoint_dir) is not None:
        restored = ckpt.restore(checkpoint_dir)
    if restored is not None:
        payload, start = restored
        saved_tag = payload["tag"]
        if saved_tag != tag or "shards" not in payload:
            raise ValueError(
                f"checkpoint in {checkpoint_dir} holds workload "
                f"{saved_tag!r}, this run is {tag!r} — written by a "
                f"different workload or framework version; use a "
                f"fresh directory")
        if start > n_windows:
            raise ValueError(
                f"checkpoint in {checkpoint_dir} is at window {start}, "
                f"past n_windows={n_windows}; use a fresh directory")
        saved_shards = int(payload["shards"])
        saved_leaves = list(payload["state"])
        if saved_shards != n_shards:
            if renegotiate is None:
                raise ValueError(
                    f"checkpoint in {checkpoint_dir} was written at "
                    f"{saved_shards} shard(s), this mesh has "
                    f"{n_shards} and the workload does not support "
                    f"elastic renegotiation")
            cur = next((e for e in epochs if e.start <= start < e.end),
                       epochs[-1])
            state = tuple(renegotiate(saved_leaves, saved_shards, start))
            emit_epoch_event(cur, reason="renegotiated_resume",
                             prev_active=saved_shards)
            tevents.counter("ssp.membership_epochs")
            log(describe_renegotiation(cur.gen, saved_shards, n_shards))
        else:
            sig = [(tuple(v.shape), str(v.dtype)) for v in saved_leaves]
            want = [(tuple(_host(x).shape), str(_host(x).dtype))
                    for x in state0]
            if sig != want:
                raise ValueError(
                    f"checkpoint in {checkpoint_dir} state {sig} does "
                    f"not match this run's {want} — different config "
                    f"or framework version; use a fresh directory")
            state = tuple(saved_leaves)
        n_outs = sum(1 for k in payload if k.startswith("outs_"))
        outs_parts = [tuple(np.asarray(payload[f"outs_{i}"])
                            for i in range(n_outs))]

    seg_fns: dict = {}
    win = start
    # the epoch of the window before the resume point, so a resume that
    # lands on a membership change still runs on_epoch
    prev_epoch: Epoch | None = None
    if start > 0:
        prev_epoch = next((e for e in epochs
                           if e.start <= start - 1 < e.end), None)
    while win < n_windows:
        epoch = next(e for e in epochs if e.start <= win < e.end)
        if prev_epoch is not None and epoch.gen != prev_epoch.gen:
            emit_epoch_event(epoch, reason="membership_change",
                             prev_active=prev_epoch.n_active)
            tevents.counter("ssp.membership_epochs")
            log(f"[ssp] membership epoch {epoch.gen}: "
                f"{epoch.n_active}/{n_shards} shard(s) active")
            if on_epoch is not None:
                state = tuple(on_epoch(state, prev_epoch, epoch))
        prev_epoch = epoch
        seg_end = min(epoch.end,
                      ((win // checkpoint_every) + 1) * checkpoint_every,
                      n_windows)
        n_win = seg_end - win
        tevents.mark(f"ssp:{tag or 'train'}@w{win}", emit_event=False)
        key = (epoch.active, n_win)
        if key not in seg_fns:
            seg_fns[key] = make_seg_fn(epoch.active, n_win)
        state, outs = run_seg(seg_fns[key], state, win, n_win, epoch)
        state = tuple(state)
        metrics.guard_finite(
            [x for x in state if isinstance(x, torch.Tensor)
             and x.is_floating_point()],
            f"SSP state after window {seg_end}")
        outs_parts.append(tuple(_host(o) for o in outs))
        win = seg_end
        if checkpoint_dir:
            streams = _cat_streams(outs_parts)
            ckpt.save(checkpoint_dir, tag, [_host(x) for x in state], win,
                      extra={"shards": np.int64(n_shards),
                             **{f"outs_{i}": s
                                for i, s in enumerate(streams)}})
            ckpt.prune(checkpoint_dir, keep=keep)
            tevents.emit("checkpoint_saved",
                         step=win * ticks_per_window, tag=tag)
            tevents.counter("checkpoints_saved")
    return state, _cat_streams(outs_parts), start, epochs


def _cat_streams(parts) -> list[np.ndarray]:
    """Concatenate per-segment output tuples stream-wise, skipping empty
    tuples."""
    parts = [p for p in parts if p]
    if not parts:
        return []
    return [np.concatenate([p[i] for p in parts])
            for i in range(len(parts[0]))]
