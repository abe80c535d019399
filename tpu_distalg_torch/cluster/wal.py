"""Durable write-ahead ledger — the coordinator's crash-survival log.

Port of ``tpu_distalg/cluster/wal.py``: the records are the transport's
frames, so a segment's bytes equal the JAX package's for the same
appends. The center checkpoints the log sits on are the port's
``step_<N>.npz`` files (``utils/checkpoint.py``), not the JAX package's
msgpack, so a port coordinator does not resume from a JAX coordinator's
directory.

Workers are expendable; without this log the coordinator would be the
single point of failure: one process holds the membership ledger, the
cross-process SSP clock, and the merge pipeline in RAM, so its death
would strand every worker and discard all progress since the last
periodic center save. This module closes that hole: every state
transition the replay contract depends on — admissions and incarnation
grants, announced skips, window commits (slot-ordered contribution
digests *and* the applied delta bytes — a redo log; under a ``--comm``
wire codec these are the COMPRESSED payload bytes exactly as pushed,
so replay re-runs the same exact decode and the re-push dedup digests
match a resent frame by construction), membership epochs, admission
holds — is appended as a CRC-framed record and fsynced *before* the
corresponding ack leaves the socket. On restart
the coordinator replays the ledger on top of the newest durable center
checkpoint and resumes as if it never died; a half-committed window
(pushes that arrived but never committed) is simply absent from the
ledger, so it rolls back to its start — and because push acks are
DEFERRED until commit, no worker ever observed it: rollback is
invisible by construction, and the workers re-push the identical
deltas on reconnect.

Record format: exactly the wire format. Each record is one
``transport.encode_frame`` frame (magic + u32/u64 length prefix +
CRC32 + JSON meta + raw numpy buffers), concatenated into an
append-only segment file — the same torn/corrupt detection the
transport gives a socket, applied to a file. Replay stops at the
FIRST bad record and truncates there with a quarantine event
(mirroring the checkpoint CRC-footer contract). For the common
crash-mid-append case that is lossless: the torn tail was never fully
fsynced, so its ack never left. For silent MID-file corruption (bit
rot, or a seeded ``cluster:wal`` ``corrupt`` cell) it is a deliberate
consistency choice — the records after the bad one may be intact and
may even have been acked, but applying them across a hole would
replay a version GAP (a skipped commit) into an inconsistent center,
so recovery keeps the last consistent PREFIX, exactly like a database
redo log; the quarantine event records how many bytes were dropped so
the loss is visible, never silent.

Segments & truncation: one segment file ``wal_<base>.log`` per durable
center checkpoint, where ``base`` is the checkpoint's version. Every
segment opens with a ``base`` record carrying a full snapshot of the
coordinator's CONTROL state (version, generation, incarnation counter,
slot table, event history) — the data plane lives in the checkpoint,
the control plane in the snapshot, and everything since in the
records. At each new durable center the WAL rotates to a fresh
segment and deletes segments older than the oldest KEPT checkpoint
(``keep``), so a quarantined-corrupt newest checkpoint can still fall
back to an older step and roll the intervening commits forward from
the older segments' redo records.

Durability discipline: every append is
``write → flush → fsync`` before control returns — the caller's socket
send of the ack happens strictly after the record is durable — and
segment creation fsyncs the directory so the new file survives a power
cut, the same discipline as ``utils/checkpoint.save``.

Fault seam ``cluster:wal``: injected on the encoded record bytes at
the top of :meth:`WriteAheadLog.append` — ``corrupt`` really flips
bytes (the replay CRC catches it as a quarantined tail), ``oserror``
models a transient disk fault.

Record kinds (meta ``k``, one frame each):

  ``base``       segment header — full control-plane snapshot
  ``admit``      slot admission + incarnation grant (fencing)
  ``skip``       an announced busy-skip (dedup on replay)
  ``commit``     one SSP window: slot-ordered contribution digests +
                 the pushed delta bytes keyed ``{slot}/{leaf}`` — the
                 redo record. In rowstore PS mode each contribution
                 additionally carries its ``{slot}/{leaf}.rows``
                 int64 row-index array (the per-ROW redo record: the
                 replayed merge re-applies exactly those rows, and
                 the digest covers the index bytes too)
  ``rowcommit``  one row-store fleet commit (``rowstore.
                 run_cluster_pagerank``): every contribution's pushed
                 sparse row arrays keyed ``{slot}/{leaf}.rows`` +
                 ``{slot}/<codec parts>``, plus the combine's scalar
                 meta (the dangling-mass sum) — replay re-runs the
                 identical decode and row apply, bitwise
  ``leave``      membership epoch transition (a declared death)
  ``hold``       admission hold      ``bye``  worker departure
  ``done``       run completion

stdlib + numpy only, like the transport.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from tpu_distalg_torch import faults
from tpu_distalg_torch.cluster import transport
from tpu_distalg_torch.telemetry import events as tevents

#: segment filename pattern: wal_<base version, zero-padded>.log
_SEG_PREFIX = "wal_"
_SEG_SUFFIX = ".log"


class WalError(RuntimeError):
    """A WAL invariant broke in a way replay cannot repair (a segment
    whose HEADER record is unreadable — the snapshot is gone)."""


def delta_digest(arrays: dict) -> int:
    """CRC32 over a contribution's leaf names + raw bytes — the
    idempotence token: a worker re-delivering an already-committed
    push after a coordinator recovery must present the SAME bytes, and
    the commit record's digest is how the coordinator checks without
    keeping the delta itself in RAM forever."""
    crc = 0
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        crc = zlib.crc32(name.encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


def _segment_path(wal_dir: str, base: int) -> str:
    return os.path.join(wal_dir, f"{_SEG_PREFIX}{base:012d}{_SEG_SUFFIX}")


def segment_bases(wal_dir: str) -> list[int]:
    """The on-disk segment base versions, ascending."""
    if not os.path.isdir(wal_dir):
        return []
    out = []
    for name in sorted(os.listdir(wal_dir)):
        if name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX):
            try:
                out.append(int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]))
            except ValueError:
                continue
    return sorted(out)


def _fsync_dir(directory: str) -> None:
    """Directory fsync so a just-created segment survives a power cut
    — same best-effort contract as ``utils/checkpoint._fsync_dir``,
    kept here so the WAL (like the transport) imports only the
    standard library and numpy."""
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


def read_segment(path: str, *, truncate_torn: bool = True):
    """Read one segment file -> ``(records, torn_bytes)`` where
    ``records`` is ``[(kind, meta, arrays), ...]`` in append order.

    A torn / CRC-bad / short tail stops the read at the last GOOD
    record; when ``truncate_torn`` the file is truncated there (and
    fsynced) with a ``wal_quarantine`` event — the durable mirror of
    the checkpoint quarantine path. Returns the number of bytes
    dropped (0 on a clean read)."""
    with open(path, "rb") as f:
        raw = f.read()
    records = []
    off = 0
    psize = transport._PREFIX.size
    while off < len(raw):
        if off + psize > len(raw):
            break  # torn prefix
        magic, hlen, blen, crc = transport._PREFIX.unpack(
            raw[off:off + psize])
        if magic != transport.MAGIC or \
                hlen > transport.MAX_HEADER_BYTES:
            break  # desynchronized / corrupt prefix
        end = off + psize + hlen + blen
        if end > len(raw):
            break  # torn record body
        header = raw[off + psize:off + psize + hlen]
        body = raw[off + psize + hlen:end]
        got = zlib.crc32(header)
        got = zlib.crc32(body, got) & 0xFFFFFFFF
        if got != crc:
            break  # bit-rot / injected corruption: CRC catches it
        try:
            records.append(transport.parse_payload(header, body))
        except transport.TransportError:
            break
        off = end
    torn = len(raw) - off
    if torn and truncate_torn:
        with open(path, "r+b") as f:
            f.truncate(off)
            f.flush()
            os.fsync(f.fileno())
        tevents.emit("wal_quarantine", path=path, torn_bytes=torn,
                     kept_records=len(records))
        tevents.counter("cluster.wal_quarantines")
    return records, torn


class WriteAheadLog:
    """Append-only CRC-framed segments under ``wal_dir``; one open
    segment at a time. Not thread-safe by itself — the coordinator
    appends under its own state lock, which is also what orders the
    records."""

    def __init__(self, wal_dir: str):
        self.wal_dir = wal_dir
        self._f = None
        self.base: int | None = None
        os.makedirs(wal_dir, exist_ok=True)

    # ------------------------------------------------------- writing

    def open_segment(self, base: int, snapshot: dict) -> None:
        """Start (or re-open, after a recovery) the segment for the
        durable center at version ``base``. A segment is only usable
        when its FIRST record is a readable ``base`` snapshot — an
        existing file whose header was torn/quarantined away (or that
        is empty) is REWRITTEN fresh with the caller's current
        snapshot, because appending acked records to a headerless
        segment would hand the next recovery a file it must skip
        whole; a healthy existing segment appends after its current
        end (recovery continues the segment it replayed)."""
        self.close()
        path = _segment_path(self.wal_dir, base)
        fresh = True
        if os.path.exists(path):
            head, _torn = read_segment(path, truncate_torn=True)
            if head and head[0][0] == "base":
                fresh = False
            else:
                # headerless husk: the snapshot below supersedes it
                # (it is the FULL control state, so nothing is lost)
                with open(path, "r+b") as f:
                    f.truncate(0)
                    f.flush()
                    os.fsync(f.fileno())
        self._f = open(path, "ab")
        self.base = base
        if fresh:
            self.append("base", snapshot)
            _fsync_dir(self.wal_dir)

    def append(self, kind: str, meta: dict,
               arrays: dict | None = None) -> None:
        """One durable record: encode, (fault seam), write, flush,
        fsync — the caller's ack send happens strictly after this
        returns. A FAILED append rewinds the
        segment to the record boundary before re-raising: the caller
        retries transient OSErrors (``supervised``), and retrying on
        top of a half-landed copy would leave a torn or duplicate
        record MID-log — replay would either truncate there
        (discarding every later acked record) or apply the record's
        events twice."""
        if self._f is None:
            raise WalError("append on a closed WAL — open_segment "
                           "first")
        buf = faults.inject(
            "cluster:wal",
            payload=transport.encode_frame(kind, meta, arrays))
        start = self._f.tell()
        try:
            self._f.write(buf)
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError:
            try:
                self._f.truncate(start)
            except (OSError, ValueError):
                # double fault: the rewind itself failed — the
                # segment may be torn mid-log; refuse further appends
                # (the coordinator's supervised retry surfaces the
                # original error) rather than append after garbage
                try:
                    self._f.close()
                except (OSError, ValueError):
                    pass
                self._f = None
            raise
        tevents.counter("cluster.wal_appends")

    def rotate(self, base: int, snapshot: dict, *,
               keep_base: int | None = None) -> None:
        """Cut over to the segment for the new durable center at
        ``base`` and delete segments older than ``keep_base`` (the
        oldest KEPT checkpoint's version — older segments could only
        matter for falling back past checkpoints that no longer
        exist)."""
        self.open_segment(base, snapshot)
        if keep_base is not None:
            for b in segment_bases(self.wal_dir):
                if b < keep_base and b != base:
                    try:
                        os.remove(_segment_path(self.wal_dir, b))
                    except FileNotFoundError:
                        pass

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            self._f.close()
            self._f = None

    # ------------------------------------------------------- reading

    @staticmethod
    def replay(wal_dir: str, center_version: int):
        """The recovery read path: every record needed to roll forward
        from the restored center at ``center_version`` — ``(records,
        replay_base)`` where ``records`` is ``[(kind, meta, arrays),
        ...]`` across segments in base order starting at the newest
        segment whose base ≤ ``center_version`` (older segments'
        commits for windows already inside the restored center are
        skipped by the applier's version check), and ``replay_base``
        is the base of the NEWEST readable segment (the one recovery
        re-opens for appending). Empty dir -> ``([], None)``."""
        bases = segment_bases(wal_dir)
        if not bases:
            return [], None
        readable: dict[int, list] = {}
        for b in bases:
            segment, _torn = read_segment(_segment_path(wal_dir, b))
            if segment and segment[0][0] == "base":
                readable[b] = segment
            # else: a headerless husk (its base snapshot never became
            # durable, or was quarantined away) — it must not SHADOW
            # older readable segments, and open_segment rewrites it
            # before any new record lands in it
        if not readable:
            return [], None
        eligible = [b for b in readable if b <= center_version]
        # a segment newer than the restored center means the newer
        # checkpoint it sat on was quarantined: roll forward from the
        # older segments' redo records through it
        start = max(eligible) if eligible else min(readable)
        records: list = []
        replay_base = None
        for b in sorted(readable):
            if b < start:
                continue
            records.extend(readable[b])
            replay_base = b
        return records, replay_base
