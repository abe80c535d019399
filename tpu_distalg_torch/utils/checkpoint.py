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

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")
_MSGPACK_RE = re.compile(r"^step_(\d+)\.msgpack$")
_CRC_MAGIC = b"\x00TDACRC1"
_CRC_FOOTER_LEN = len(_CRC_MAGIC) + 4


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
    ``ckpt_dir/step_<step>.npz``; returns the path."""
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
    with open(tmp, "wb") as f:
        f.write(body)
        f.write(footer)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(ckpt_dir)
    return path


def _steps(ckpt_dir: str, pattern: re.Pattern) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := pattern.match(name)))


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir, _STEP_RE)
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
    holds them; ``step=None`` loads the newest checkpoint."""
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
    steps = _steps(ckpt_dir, _STEP_RE)
    for step in steps[:-keep] if keep else steps:
        try:
            os.remove(os.path.join(ckpt_dir, f"step_{step}.npz"))
        except FileNotFoundError:
            pass


def run_segmented(checkpoint_dir: str, checkpoint_every: int,
                  n_iterations: int, make_seg_fn, run_seg, state0, *,
                  tag: str = "", stop_when=None):
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
    (Corrupt-file quarantine and preemption wait for the faults slice.)
    """
    import torch

    from tpu_distalg_torch.utils import metrics

    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    state = tuple(state0)
    devices = [torch.as_tensor(x).device for x in state]
    want = [(tuple(np.asarray(torch.as_tensor(x).cpu()).shape),
             str(np.asarray(torch.as_tensor(x).cpu()).dtype))
            for x in state]
    start, accs_parts = 0, []
    if latest_step(checkpoint_dir) is not None:
        payload, start = restore(checkpoint_dir)
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
        state = tuple(torch.from_numpy(np.array(v)).to(dev)
                      for v, dev in zip(payload["state"], devices))
        accs_parts = [np.asarray(payload["accs"])]
    seg_fns = {}
    t = start
    while t < n_iterations:
        if stop_when is not None and stop_when(state):
            break
        seg = min(checkpoint_every, n_iterations - t)
        if seg not in seg_fns:
            seg_fns[seg] = make_seg_fn(seg)
        state, accs = run_seg(seg_fns[seg], state, t)
        state = tuple(state)
        metrics.guard_finite(list(state),
                             f"training state after step {t + seg}")
        t += seg
        accs_parts.append(np.asarray(torch.as_tensor(accs).cpu()))
        save(checkpoint_dir, tag, [torch.as_tensor(x).cpu().numpy()
                                   for x in state], t,
             accs=np.concatenate(accs_parts))
        prune(checkpoint_dir)
    accs = (np.concatenate(accs_parts) if accs_parts
            else np.zeros((0,), np.float32))
    return state, accs, start
