"""The port's artifacts: ``step_<N>.npz`` with a CRC32 footer.

A file is an ``np.savez`` body (no pickle: the tag is a unicode array,
the state leaves are numeric arrays ``state_0``, ``state_1``, …)
followed by the JAX package's footer, ``\\x00TDACRC1`` and the
little-endian CRC32 of the body. Writes go to a temporary file that is
fsynced, atomically renamed into place, and the directory fsynced
after, so a crash leaves the old file or the new one, never half of
one. :func:`restore` checks the footer before it parses anything; a
missing or wrong footer raises :class:`CorruptCheckpointError`.

:func:`run_segmented` trains in checkpointed segments that resume bit
for bit (SSGD), keeping the newest three files.

Recovery (port of the JAX package's, ``tpu_distalg/utils/checkpoint.py``):

  * :func:`save` runs its write under ``telemetry.supervisor.supervised``,
    so a transient ``OSError`` is retried in place (:data:`SAVE_RETRIES`
    times); the ``ckpt:write`` fault seam fires inside each attempt on
    the npz body, after the footer's CRC was taken of the true body, so
    an injected corruption lands on disk and is caught when read back;
  * :func:`restore` passes the bytes it read through the ``ckpt:read``
    seam before the CRC check;
  * a resume quarantines a corrupt newest file (``*.corrupt``) and
    falls back to the next-older step in the same process
    (:func:`restore_newest_with_fallback`);
  * the ``segment:run`` seam fires before each segment, and a pending
    preemption (``faults.preempt``) stops the loop at the next boundary
    after that boundary's save (:func:`preempt_boundary_exit`, rc 75);
  * :func:`run_with_restarts` re-runs a failed job, which resumes from
    the newest checkpoint, with the JAX package's policy.

Across processes the directory is shared by the group, and
:func:`save_shared` keeps one writer: the leaves a process holds only
its rows of are gathered from every process (``allgather_rows``),
process 0 alone writes and prunes, and then every process checks that
it sees process 0's newest step (:func:`check_shared`); a directory
that is not shared raises on every process, naming it. The same
all-gather carries each process's outcome (written, failed with a
restartable error, failed for good) and whether it has a preemption
request: a write that fails on process 0 raises on every process at
once instead of leaving the others to wait out the group's timeout, and
one signalled process stops the whole group at the same boundary. On
resume every process reads the file and keeps its own rows
(:func:`local_rows`), and the processes check that they resumed at one
step.
The file holds what one process × P·L shards writes, so a run written
by P processes resumes in one, and the other way round, bit for bit.
(The JAX package writes from every host instead.)

The JAX package writes ``step_<N>.msgpack`` (flax serialisation),
which the port does not read: :func:`restore` raises a message naming
that format. The two packages exchange factors through numpy instead
(``tpu_distalg_torch/convert.py``).
"""

from __future__ import annotations

import io
import os
import re
import struct
import zipfile
import zlib

import numpy as np

from tpu_distalg_torch import faults
from tpu_distalg_torch.faults import preempt
from tpu_distalg_torch.telemetry import events as tevents

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")
_MSGPACK_RE = re.compile(r"^step_(\d+)\.msgpack$")
_CRC_MAGIC = b"\x00TDACRC1"
_CRC_FOOTER_LEN = len(_CRC_MAGIC) + 4

#: in-place retries of a checkpoint write after a transient OSError,
#: and the fixed pause between them (a longer outage is
#: run_with_restarts' to handle)
SAVE_RETRIES = 2
SAVE_BACKOFF_SECONDS = 0.05


class CorruptCheckpointError(ValueError):
    """A checkpoint file exists but fails its CRC or will not parse."""

    def __init__(self, path: str, msg: str):
        super().__init__(msg)
        self.path = path


def _fsync_dir(directory: str) -> None:
    """fsync the directory so the rename itself is durable. Some
    filesystems refuse directory fds; the rename already happened."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(ckpt_dir: str, tag: str, state, step: int, *,
         accs=None, extra: dict | None = None) -> str:
    """Write ``{"tag": tag, "state": [leaves]}`` (and the accuracy
    history ``accs``, and the named arrays of ``extra``, when given) as
    ``ckpt_dir/step_<step>.npz``; returns the path. A transient
    ``OSError`` is retried :data:`SAVE_RETRIES` times."""
    from tpu_distalg_torch.telemetry.supervisor import supervised

    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {"tag": np.asarray(tag)}
    for j, leaf in enumerate(state):
        # asarray, not ascontiguousarray: that would make a 0-d leaf 1-d
        arrays[f"state_{j}"] = np.asarray(leaf, order="C")
    if accs is not None:
        arrays["accs"] = np.asarray(accs, order="C")
    for name, value in (extra or {}).items():
        if name in arrays or name.startswith("state_"):
            raise ValueError(f"extra array name {name!r} is taken")
        arrays[name] = np.asarray(value, order="C")
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    body = buf.getvalue()
    footer = _CRC_MAGIC + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    tmp = f"{path}.{os.getpid()}.tmp"

    def write_once():
        data = faults.inject("ckpt:write", payload=body)
        with open(tmp, "wb") as f:
            f.write(data)
            f.write(footer)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(ckpt_dir)

    supervised(write_once, phase="ckpt:write", retries=SAVE_RETRIES,
               backoff=SAVE_BACKOFF_SECONDS,
               backoff_cap=SAVE_BACKOFF_SECONDS, jitter=0.0,
               retry_on=(OSError,), failure_counter="ckpt.write_failures",
               log=lambda m: None)
    return path


def _steps(ckpt_dir: str, pattern: re.Pattern) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := pattern.match(name)))


def list_steps(ckpt_dir: str) -> list[int]:
    """Every checkpoint step on disk, ascending."""
    return _steps(ckpt_dir, _STEP_RE)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _body(path: str, raw: bytes) -> bytes:
    if len(raw) < _CRC_FOOTER_LEN or \
            raw[-_CRC_FOOTER_LEN:-4] != _CRC_MAGIC:
        raise CorruptCheckpointError(
            path, f"corrupt checkpoint {path}: no CRC footer — the file "
                  f"was torn or was not written by this package")
    body = raw[:-_CRC_FOOTER_LEN]
    (want,) = struct.unpack("<I", raw[-4:])
    got = zlib.crc32(body) & 0xFFFFFFFF
    if got != want:
        raise CorruptCheckpointError(
            path, f"corrupt checkpoint {path}: CRC32 mismatch (stored "
                  f"{want:#010x}, computed {got:#010x})")
    return body


def restore(ckpt_dir: str, step: int | None = None) -> tuple[dict, int]:
    """Load ``({"tag": str, "state": [np.ndarray, ...]}, step)``, with
    ``"accs"`` and every ``extra`` array of :func:`save` when the file
    holds them; ``step=None`` loads the newest checkpoint. The bytes
    read pass the ``ckpt:read`` fault seam, then the CRC check."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            if _steps(ckpt_dir, _MSGPACK_RE):
                raise ValueError(
                    f"{ckpt_dir} holds only step_<N>.msgpack files, the "
                    f"JAX package's flax msgpack checkpoint format, which "
                    f"this package does not read — carry the factors "
                    f"across as numpy arrays (tpu_distalg_torch.convert)")
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    with open(path, "rb") as f:
        raw = f.read()
    raw = faults.inject("ckpt:read", payload=raw)
    body = _body(path, raw)
    try:
        with np.load(io.BytesIO(body), allow_pickle=False) as z:
            tag = str(z["tag"])
            n = sum(1 for name in z.files if name.startswith("state_"))
            state = [z[f"state_{j}"] for j in range(n)]
            extra = {name: z[name] for name in z.files
                     if name != "tag" and not name.startswith("state_")}
    except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:
        raise CorruptCheckpointError(
            path, f"corrupt checkpoint {path} ({type(e).__name__}: {e})"
        ) from e
    return {"tag": tag, "state": state, **extra}, step


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints; ``keep=0``
    deletes them all."""
    steps = list_steps(ckpt_dir)
    for step in steps[:-keep] if keep else steps:
        try:
            os.remove(os.path.join(ckpt_dir, f"step_{step}.npz"))
        except FileNotFoundError:
            pass


def quarantine(path: str, *, logger=None) -> bool:
    """Rename a corrupt checkpoint to ``<path>.corrupt`` so the next
    resume sees the step before it. Another process having renamed it
    first counts as done; returns False only when the rename fails for
    another reason."""
    try:
        # tda: ignore[TDA030] -- recovery rename of an ALREADY-corrupt
        # file, not a durable publish: a failure here is caught below
        # and reported, and injecting at it would shift the ckpt:write
        # hit counts every recorded chaos plan replays against
        os.replace(path, path + ".corrupt")
    except FileNotFoundError:
        return True
    except OSError as os_err:
        (logger or print)(
            f"could not quarantine corrupt checkpoint {path} "
            f"({os_err}); manual cleanup required")
        return False
    tevents.emit("quarantine", path=path)
    tevents.counter("quarantines")
    return True


def restore_newest_with_fallback(ckpt_dir: str, *, logger=None):
    """The resume read: the newest checkpoint, or, when it is corrupt,
    that file quarantined and the next-older step tried, in the same
    process. Returns ``(payload, step)``, or ``None`` when no
    restorable checkpoint remains."""
    while True:
        step = latest_step(ckpt_dir)
        if step is None:
            return None
        try:
            return restore(ckpt_dir, step)
        except CorruptCheckpointError as e:
            if not quarantine(e.path, logger=logger):
                raise
            (logger or print)(
                f"[quarantine] corrupt checkpoint {e.path} -> .corrupt; "
                f"falling back to the previous step in-process")
        except FileNotFoundError:
            continue  # renamed or pruned by another process: list again


def preempt_boundary_exit(step: int, tag: str,
                          requested: bool | None = None) -> None:
    """Raise :class:`~tpu_distalg_torch.faults.Preempted` (rc 75) after
    a ``preempted`` event when a preemption is pending (``requested``:
    the process group's agreed answer from :func:`save_shared`; by
    default this process's own flag). A no-op otherwise."""
    if requested is None:
        requested = preempt.requested()
    if not requested:
        return
    tevents.emit("preempted", step=step, tag=tag,
                 signals=list(preempt.signals_seen()))
    tevents.counter("preemptions")
    raise preempt.Preempted(step=step)


class CheckpointPeerError(RuntimeError):
    """Another process of the group failed to write the shared
    checkpoint with a restartable error: every process raises at the
    same boundary, so they restart together."""


def _group(mesh) -> bool:
    return (mesh is not None and getattr(mesh, "distributed", False)
            and mesh.process_count > 1)


def _allgather_ints(values, mesh) -> list[list[int]]:
    """Every process's ``values`` (a few ints), in process order: one
    small all-gather, which also lines the processes up."""
    import torch

    from tpu_distalg_torch.parallel.collectives import allgather_rows

    t = torch.as_tensor([list(values)], dtype=torch.int64,
                        device=mesh.device)
    return allgather_rows(t, mesh).cpu().tolist()


def _is_sharded(sharded, i: int) -> bool:
    return i < len(sharded) and bool(sharded[i])


def gather_state(state, mesh=None, sharded=()) -> list[np.ndarray]:
    """Host copies of the state leaves; across processes a leaf marked in
    ``sharded`` (this process's rows of a leaf cut over the data axis)
    is first brought together from every process, in process order."""
    import torch

    from tpu_distalg_torch.parallel.collectives import allgather_rows

    out = []
    for i, x in enumerate(state):
        t = torch.as_tensor(x)
        if _group(mesh) and _is_sharded(sharded, i):
            t = allgather_rows(t.to(mesh.device).contiguous(), mesh)
        out.append(np.asarray(t.detach().cpu().numpy()))
    return out


def local_rows(x: np.ndarray, mesh=None) -> np.ndarray:
    """This process's rows of a leaf the data axis cuts (all of them in
    one process)."""
    if not _group(mesh):
        return x
    from tpu_distalg_torch.parallel import DATA_AXIS, partition

    return partition.local_block(x, (DATA_AXIS,), mesh)


def check_shared(ckpt_dir: str, step, mesh=None) -> None:
    """Across processes: raise on every process unless each sees the
    same newest step in ``ckpt_dir`` (``step``, process 0's, when
    given)."""
    if not _group(mesh):
        return
    seen = latest_step(ckpt_dir)
    got = [v[0] for v in _allgather_ints([-1 if seen is None else seen],
                                         mesh)]
    want = got[0] if step is None else int(step)
    if any(v != want for v in got):
        shown = ", ".join(f"process {p}: "
                          + ("none" if v < 0 else f"step {v}")
                          for p, v in enumerate(got))
        raise ValueError(
            f"checkpoint directory {ckpt_dir} is not shared by the "
            f"{mesh.process_count} processes of the group (newest step "
            f"{shown}); give every process one directory they all see")


#: a process's outcome of a shared write, in the boundary all-gather
_WROTE, _FAILED, _FAILED_FOR_GOOD = 0, 1, 2


def save_shared(ckpt_dir: str, tag: str, state, step: int, *, mesh=None,
                sharded=(), accs=None, extra: dict | None = None,
                keep: int = 3) -> bool:
    """:func:`save` and :func:`prune` for a process group: the sharded
    leaves gathered, process 0 the one writer, then one all-gather of
    every process's outcome and preemption flag, and every process
    checks that it sees the step (:func:`check_shared`). A write that
    failed on process 0 raises there and, on every other process, a
    :class:`CheckpointPeerError` (``ValueError`` when it is a
    configuration error), at the same boundary. Returns whether any
    process has a preemption pending (in one process, this one's)."""
    leaves = gather_state(state, mesh, sharded)
    if not _group(mesh):
        save(ckpt_dir, tag, leaves, step, accs=accs, extra=extra)
        prune(ckpt_dir, keep=keep)
        return preempt.requested()
    err = None
    if mesh.process_index == 0:
        try:
            save(ckpt_dir, tag, leaves, step, accs=accs, extra=extra)
            prune(ckpt_dir, keep=keep)
        except Exception as e:  # noqa: BLE001 — told to the group first
            err = e
    outcome = (_WROTE if err is None else
               _FAILED_FOR_GOOD if isinstance(
                   err, (ValueError, TypeError, FileNotFoundError))
               else _FAILED)
    got = _allgather_ints([outcome, int(preempt.requested())], mesh)
    if err is not None:
        raise err
    bad = [(p, o) for p, (o, _) in enumerate(got) if o != _WROTE]
    if bad:
        p, o = bad[0]
        msg = (f"process {p} failed to write step {step} of the shared "
               f"checkpoint directory {ckpt_dir}")
        raise (ValueError if o == _FAILED_FOR_GOOD
               else CheckpointPeerError)(msg)
    check_shared(ckpt_dir, step, mesh)
    return any(flag for _, flag in got)


def run_segmented(checkpoint_dir: str, checkpoint_every: int,
                  n_iterations: int, make_seg_fn, run_seg, state0, *,
                  tag: str = "", stop_when=None, mesh=None, sharded=()):
    """Segmented, resumable training: the port of the JAX package's
    ``checkpoint.run_segmented``.

    Runs ``n_iterations`` steps as segments of ``checkpoint_every``;
    after each segment the state and the accuracy history so far are
    saved and the state is checked to be finite. A checkpoint in the
    directory resumes from its absolute step; the segment functions key
    their sampling on the absolute step (``t0``), so a segmented run
    equals a straight one bit for bit. ``make_seg_fn(seg_len)`` builds a
    segment (cached per length); ``run_seg(fn, state, t0)`` runs one
    and returns ``(state, accs)``; ``state0`` is a tuple of tensors.
    ``tag`` names the workload and, with the state's shapes and dtypes,
    must match on resume. ``stop_when(state)``, when given, is asked
    before every segment, a resumed run's first included: a fixpoint
    workload (k-means in converge mode) stops once it holds instead of
    running segments that change nothing. Returns ``(state, accs,
    start_step)``.

    Across processes (``mesh`` spanning a process group) the directory
    is shared: ``sharded[i]`` marks a leaf of which a process holds its
    rows, gathered into the file (:func:`save_shared`) and cut back on
    resume, so the file equals one process's. A process that sees
    another newest step than the others raises on every process.

    Recovery: the resume reads through :func:`restore_newest_with_fallback`
    (a corrupt newest file is quarantined and the step before it used),
    the ``segment:run`` fault seam fires before each segment, and once a
    preemption is pending (SIGTERM, ``faults.preempt``; across
    processes any process's) the loop raises
    :class:`~tpu_distalg_torch.faults.Preempted` at the next boundary
    after its checkpoint is saved. The newest three files are kept.
    """
    import torch

    from tpu_distalg_torch.parallel import mesh as pmesh
    from tpu_distalg_torch.utils import metrics

    if mesh is None and pmesh.process_count() > 1:
        raise ValueError(
            f"checkpointing {tag or 'this workload'} in a process group "
            f"needs its mesh (run_segmented(mesh=...)): the directory is "
            f"shared, and process 0 its one writer")
    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    state = tuple(state0)
    devices = [torch.as_tensor(x).device for x in state]
    rows = mesh.process_count if _group(mesh) else 1
    want = []
    for i, x in enumerate(state):
        a = np.asarray(torch.as_tensor(x).cpu())
        shape = tuple(a.shape)
        if _is_sharded(sharded, i):
            shape = (shape[0] * rows,) + shape[1:]
        want.append((shape, str(a.dtype)))
    start, accs_parts = 0, []
    check_shared(checkpoint_dir, None, mesh)
    restored = restore_newest_with_fallback(checkpoint_dir)
    if _group(mesh):
        got = [v[0] for v in _allgather_ints(
            [-1 if restored is None else restored[1]], mesh)]
        if any(v != got[0] for v in got):
            raise RuntimeError(
                f"the processes resumed {checkpoint_dir} at different "
                f"steps ({got}): a file changed under them")
    if restored is not None:
        payload, start = restored
        if start > n_iterations:
            raise ValueError(
                f"checkpoint in {checkpoint_dir} is at step {start}, past "
                f"n_iterations={n_iterations}; use a fresh directory or "
                f"raise n_iterations")
        sig = [(tuple(v.shape), str(v.dtype)) for v in payload["state"]]
        if payload["tag"] != tag or sig != want or "accs" not in payload:
            raise ValueError(
                f"checkpoint in {checkpoint_dir} is incompatible: it holds "
                f"workload {payload['tag']!r} with state {sig}, but this "
                f"run is {tag!r} with state {want}; use a fresh directory")
        state = tuple(torch.from_numpy(np.array(
            local_rows(v, mesh) if _is_sharded(sharded, i) else v)).to(dev)
            for i, (v, dev) in enumerate(zip(payload["state"], devices)))
        accs_parts = [np.asarray(payload["accs"])]
    seg_fns = {}
    t = start
    while t < n_iterations:
        if stop_when is not None and stop_when(state):
            break
        seg = min(checkpoint_every, n_iterations - t)
        # a segment that wedges leaves this mark for the heartbeat
        tevents.mark(f"segment:{tag or 'train'}@{t}", emit_event=False)
        faults.inject("segment:run")
        if seg not in seg_fns:
            seg_fns[seg] = make_seg_fn(seg)
        state, accs = run_seg(seg_fns[seg], state, t)
        state = tuple(state)
        metrics.guard_finite(list(state),
                             f"training state after step {t + seg}")
        t += seg
        accs_parts.append(np.asarray(torch.as_tensor(accs).cpu()))
        stop = save_shared(checkpoint_dir, tag, state, t, mesh=mesh,
                           sharded=sharded, accs=np.concatenate(accs_parts))
        tevents.emit("checkpoint_saved", step=t, tag=tag)
        tevents.counter("checkpoints_saved")
        if t < n_iterations:
            preempt_boundary_exit(t, tag, requested=stop)
    accs = (np.concatenate(accs_parts) if accs_parts
            else np.zeros((0,), np.float32))
    return state, accs, start


def run_with_restarts(run_once, max_restarts: int = 0, *, logger=None):
    """Run ``run_once()`` up to ``1 + max_restarts`` times: the job-level
    restart of the JAX package's ``checkpoint.run_with_restarts``.

    Any ``Exception`` (a device fault, the non-finite guard of
    :func:`run_segmented`, an injected fault) re-runs the job, which
    resumes from the newest checkpoint when it has a directory, so a
    recovered run equals an undisturbed one bit for bit. The last error
    is raised once the budget is spent (``restart_budget_exhausted``).
    ``ValueError``, ``TypeError`` and ``FileNotFoundError`` are
    configuration errors and are never retried; ``SystemExit`` (a
    :class:`~tpu_distalg_torch.faults.Preempted` boundary exit
    included) and ``KeyboardInterrupt`` are never caught. The one
    retried ``ValueError`` is :class:`CorruptCheckpointError`: its file
    is quarantined and the job re-run without spending the budget (each
    pass renames one file, so this ends), except at ``max_restarts=0``,
    which means no recovery at all."""
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    attempt = 0
    while True:
        try:
            return run_once()
        except CorruptCheckpointError as e:
            if max_restarts == 0:
                raise
            if not quarantine(e.path, logger=logger):
                raise
            (logger or print)(
                f"[quarantine] corrupt checkpoint {e.path} -> .corrupt; "
                f"resuming from the previous step (restart budget "
                f"untouched: {attempt}/{max_restarts} used)")
        except (ValueError, TypeError, FileNotFoundError):
            raise
        except Exception as e:  # noqa: BLE001 — anything restartable
            attempt += 1
            if attempt > max_restarts:
                tevents.emit("restart_budget_exhausted",
                             attempts=attempt - 1, of=max_restarts,
                             error=f"{type(e).__name__}: {e}")
                raise
            tevents.emit("restart", attempt=attempt, of=max_restarts,
                         error=f"{type(e).__name__}: {e}")
            tevents.counter("restarts")
            (logger or print)(
                f"[restart {attempt}/{max_restarts}] "
                f"{type(e).__name__}: {e} — re-running (resumes from "
                f"the latest checkpoint if one exists)")
