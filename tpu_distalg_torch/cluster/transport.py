"""Length-prefixed TCP transport — framed numpy buffers, no pickle.

Port of ``tpu_distalg/cluster/transport.py``, byte for byte: the same
frames cross the wire and land in the WAL, so a port worker can join
the JAX package's coordinator and the other way round
(``docs/PROTOCOL.md``).

The cluster runtime's one wire format: every message is a single FRAME with
an explicit length prefix, every blocking receive carries a DEADLINE,
and the payload is JSON metadata plus raw C-contiguous numpy buffers —
never pickled code, so a compromised or version-skewed peer can
corrupt a training run's numbers but can never execute anything.

Frame layout (all integers little-endian)::

    magic  b"TDAC"                      4 bytes
    u32    header length                (JSON, <= MAX_HEADER_BYTES)
    u64    body length                  (<= max_frame bytes)
    u32    CRC32 of header || body      (a torn/corrupt frame is
                                         DETECTED, mirroring the
                                         checkpoint footer contract)
    header JSON: {"k": kind, "meta": {...},
                  "arrays": [{"n": name, "d": dtype, "s": shape}, ...]}
    body   the arrays' raw bytes, concatenated in header order

Failure taxonomy — every receive path lands in exactly one:

  * :class:`TransportClosed` — EOF (peer died / socket slammed): a
    ``kill -9``'d worker is observed HERE, immediately;
  * :class:`TransportTimeout` — the deadline expired mid-receive (a
    network partition / ``cluster:rpc hang`` injection);
  * :class:`FrameTooLarge` — a length prefix past ``max_frame`` (a
    corrupt prefix must not become a multi-GB allocation);
  * :class:`TransportError` — bad magic, CRC mismatch, or a dtype the
    safe set does not admit (object dtypes would be pickle by the
    back door).

Fault seam ``cluster:rpc`` (``faults/registry.py``): injected at the
top of :func:`send_frame` and :func:`recv_frame` — ``oserror`` models
a torn connection, ``hang`` a partition that the recv deadline and the
coordinator's heartbeat timeout must observe, not wedge on.

Stdlib + numpy only: workers and coordinator use it before (and
without) any torch import.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
import zlib

import numpy as np

from tpu_distalg_torch import faults
from tpu_distalg_torch.telemetry import events as tevents

MAGIC = b"TDAC"
_PREFIX = struct.Struct("<4sIQI")  # magic, header len, body len, crc

#: refuse headers past this (a header is a few hundred bytes of JSON)
MAX_HEADER_BYTES = 1 << 20
#: default ceiling for one frame's body (center pytrees are MBs, not GBs)
DEFAULT_MAX_FRAME_BYTES = 1 << 28
#: default bound for any single blocking receive
DEFAULT_DEADLINE_SECONDS = 30.0
#: dtype kinds a frame may carry — everything numeric/bool/bytes-free;
#: 'O' (object) would be pickle by the back door and is refused on
#: BOTH ends
SAFE_DTYPE_KINDS = frozenset("biufc")

_RECV_CHUNK = 1 << 20


class TransportError(RuntimeError):
    """Malformed frame: bad magic, CRC mismatch, unsafe dtype."""


class TransportClosed(TransportError):
    """EOF — the peer died or closed mid-frame (a truncated frame is
    this, not a parse error: the bytes simply stopped)."""


class TransportTimeout(TransportError):
    """The receive deadline expired — a partition or a wedged peer."""


class FrameTooLarge(TransportError):
    """A length prefix past the configured ceiling."""


def _inject_rpc() -> None:
    """The ``cluster:rpc`` fault seam, folded into the transport's
    failure taxonomy: an injected ``oserror`` IS a torn connection,
    so it must surface as :class:`TransportClosed` — the error every
    handler/reconnect path already rides — not as a raw ``OSError``
    that would skewer a coordinator handler thread."""
    try:
        faults.inject("cluster:rpc")
    except OSError as e:
        raise TransportClosed(
            f"injected torn connection: {e}") from e


def _check_dtype(dt: np.dtype) -> np.dtype:
    dt = np.dtype(dt)
    if dt.kind not in SAFE_DTYPE_KINDS:
        raise TransportError(
            f"refusing dtype {dt!r} on the wire (kind {dt.kind!r}): "
            f"only plain numeric/bool buffers are framed — object "
            f"dtypes would be pickle by the back door")
    return dt


def encode_frame_parts(kind: str, meta: dict | None = None,
                       arrays: dict | None = None) -> list:
    """The frame for ``(kind, meta, arrays)`` as its natural buffer
    list — ``[prefix + header, body chunk, body chunk, ...]`` — whose
    concatenation IS the wire frame. :func:`send_frame` hands this
    straight to ``socket.sendmsg`` (scatter-gather: the kernel walks
    the array buffers in place, no host-side concatenation of a
    multi-MB body), and :func:`encode_frame` joins it for callers
    that need one contiguous record (the WAL). ONE framing
    implementation, so the scatter-gather path can never drift a byte
    from the contiguous one."""
    specs, chunks = [], []
    for name, arr in (arrays or {}).items():
        a = np.ascontiguousarray(arr)
        _check_dtype(a.dtype)
        specs.append({"n": str(name), "d": a.dtype.str,
                      "s": list(a.shape)})
        # a zero-copy byte view, not a.tobytes(): the scatter-gather
        # send (and the CRC walk) read the array's own buffer — the
        # memoryview keeps the (possibly temporary) contiguous array
        # alive, and b"".join accepts it wherever one contiguous
        # record is needed (encode_frame / the WAL)
        # (a zero-size array has no bytes to view: the JAX package's
        # cast raises there, the port frames it)
        chunks.append(memoryview(a).cast("B") if a.size else b"")
    header = json.dumps(
        {"k": kind, "meta": meta or {}, "arrays": specs},
        separators=(",", ":")).encode()
    if len(header) > MAX_HEADER_BYTES:
        raise FrameTooLarge(
            f"frame header of {len(header)} bytes exceeds "
            f"{MAX_HEADER_BYTES} — metadata belongs in arrays")
    crc = zlib.crc32(header)
    for chunk in chunks:
        crc = zlib.crc32(chunk, crc)
    crc &= 0xFFFFFFFF
    body_len = sum(len(c) for c in chunks)
    return [_PREFIX.pack(MAGIC, len(header), body_len, crc) + header,
            *chunks]


def encode_frame(kind: str, meta: dict | None = None,
                 arrays: dict | None = None) -> bytes:
    """One contiguous wire frame for ``(kind, meta, arrays)``.
    ``meta`` must be JSON-serializable; ``arrays`` maps name ->
    ndarray (made C-contiguous here). Byte-identical to the
    concatenation of :func:`encode_frame_parts`."""
    return b"".join(encode_frame_parts(kind, meta, arrays))


# -- measured wire accounting ----------------------------------------
# Every frame that leaves through send_frame is counted here by KIND
# (its real encoded length — what actually crosses the TCP wire), so
# the bench's cluster_wire_reduction_vs_dense is MEASURED frame bytes,
# never a schedule-side estimate. Thread-mode clusters run both ends
# in one process; the kind split ('push' = worker->coordinator delta,
# 'center' = coordinator->worker pull) keeps the directions separate.

_WIRE_LOCK = threading.Lock()
_WIRE: dict[str, list[int]] = {}

#: frame kinds whose measured bytes also ride telemetry counters
#: (``cluster.wire_push_bytes`` / ``cluster.wire_center_bytes``) —
#: the hot-path payload directions; beats/polls stay out of the
#: counter namespace
_COUNTED_KINDS = ("push", "center")


def wire_stats_reset() -> None:
    with _WIRE_LOCK:
        _WIRE.clear()


def wire_stats() -> dict[str, dict[str, int]]:
    """``{kind: {"frames": n, "bytes": total}}`` since the last
    reset — the measured per-direction wire accounting."""
    with _WIRE_LOCK:
        return {k: {"frames": v[0], "bytes": v[1]}
                for k, v in _WIRE.items()}


def _account(kind: str, nbytes: int) -> None:
    with _WIRE_LOCK:
        slot = _WIRE.setdefault(kind, [0, 0])
        slot[0] += 1
        slot[1] += nbytes
    if kind in _COUNTED_KINDS:
        tevents.counter(f"cluster.wire_{kind}_bytes", nbytes)


def _send_parts(sock: socket.socket, parts: list,
                deadline: float | None) -> None:
    """Scatter-gather send of one frame's buffer list. ``sendmsg``
    walks the buffers in the kernel (bounded at 512 iovecs per call —
    comfortably under every IOV_MAX); a partial send resumes from the
    split point with memoryview slices. ``deadline`` bounds the WHOLE
    send, not each call: every retry's socket timeout is the time
    REMAINING, so a peer that trickle-drains a few KB per interval
    cannot keep the loop alive past the deadline (the ``sendall``
    contract this path replaces). Platforms without ``sendmsg`` fall
    back to ``sendall`` of the joined bytes — byte-identical on the
    wire by construction (the parts ARE the frame)."""
    if not hasattr(sock, "sendmsg"):
        sock.settimeout(deadline)
        # the parts ARE encode_frame_parts output: their join is
        # byte-identical to encode_frame
        sock.sendall(b"".join(parts))
        return
    deadline_at = None if deadline is None \
        else time.monotonic() + deadline
    views = [memoryview(p) for p in parts if len(p)]
    while views:
        if deadline_at is None:
            sock.settimeout(None)
        else:
            remaining = deadline_at - time.monotonic()
            if remaining <= 0:
                raise socket.timeout(
                    "send deadline expired mid-frame")
            sock.settimeout(remaining)
        sent = sock.sendmsg(views[:512])
        while sent:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


def send_frame(sock: socket.socket, kind: str,
               meta: dict | None = None, arrays: dict | None = None,
               *, deadline: float | None = DEFAULT_DEADLINE_SECONDS
               ) -> None:
    """Frame and send one message; ``deadline`` bounds the whole send
    (a full peer socket buffer must not wedge the sender forever)."""
    _inject_rpc()
    parts = encode_frame_parts(kind, meta, arrays)
    total = sum(len(p) for p in parts)
    _account(kind, total)
    try:
        _send_parts(sock, parts, deadline)
    except socket.timeout as e:
        raise TransportTimeout(
            f"send of {total}-byte {kind!r} frame timed out after "
            f"{deadline}s — peer wedged or partitioned") from e
    except (BrokenPipeError, ConnectionError, OSError) as e:
        raise TransportClosed(
            f"send of {kind!r} frame failed: {e}") from e


def _recv_exact(sock: socket.socket, n: int, deadline_at: float,
                what: str) -> bytes:
    """Exactly ``n`` bytes, every recv bounded by the remaining
    deadline; EOF mid-read is :class:`TransportClosed` naming how many
    bytes arrived (the truncated-frame diagnosis)."""
    parts, got = [], 0
    while got < n:
        remaining = deadline_at - time.monotonic()
        if remaining <= 0:
            raise TransportTimeout(
                f"receive deadline expired after {got}/{n} bytes "
                f"of {what}")
        sock.settimeout(remaining)
        try:
            chunk = sock.recv(min(n - got, _RECV_CHUNK))
        except socket.timeout as e:
            raise TransportTimeout(
                f"receive deadline expired after {got}/{n} bytes "
                f"of {what}") from e
        except (ConnectionError, OSError) as e:
            raise TransportClosed(
                f"connection lost after {got}/{n} bytes of {what}: "
                f"{e}") from e
        if not chunk:
            raise TransportClosed(
                f"peer closed after {got}/{n} bytes of {what} "
                f"(truncated frame)")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def parse_payload(header: bytes, body: bytes):
    """Decode a frame's header+body (CRC already verified) into
    ``(kind, meta, arrays)`` — shared by :func:`recv_frame` and the
    WAL's file reader (``cluster/wal.py``), so the wire format and the
    durable-record format can never drift."""
    try:
        doc = json.loads(header)
    except json.JSONDecodeError as e:
        raise TransportError(f"undecodable frame header: {e}") from e
    arrays, off = {}, 0
    for spec in doc.get("arrays", ()):
        dt = _check_dtype(np.dtype(spec["d"]))
        shape = tuple(int(x) for x in spec["s"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if off + nbytes > len(body):
            raise TransportError(
                f"array {spec['n']!r} ({shape}, {dt}) overruns the "
                f"frame body ({off + nbytes} > {len(body)})")
        arrays[spec["n"]] = np.frombuffer(
            body, dtype=dt, count=int(np.prod(shape, dtype=np.int64)),
            offset=off).reshape(shape).copy()
        off += nbytes
    return doc.get("k", "?"), doc.get("meta", {}), arrays


def recv_frame(sock: socket.socket, *,
               deadline: float = DEFAULT_DEADLINE_SECONDS,
               max_frame: int = DEFAULT_MAX_FRAME_BYTES):
    """Receive one frame -> ``(kind, meta, arrays)`` with every
    blocking read bounded by ``deadline`` seconds from entry."""
    _inject_rpc()
    deadline_at = time.monotonic() + deadline
    raw = _recv_exact(sock, _PREFIX.size, deadline_at, "frame prefix")
    magic, hlen, blen, crc = _PREFIX.unpack(raw)
    if magic != MAGIC:
        raise TransportError(
            f"bad frame magic {magic!r} — peer is not speaking the "
            f"cluster transport (or the stream desynchronized)")
    if hlen > MAX_HEADER_BYTES:
        raise FrameTooLarge(
            f"header length {hlen} exceeds {MAX_HEADER_BYTES}")
    if blen > max_frame:
        raise FrameTooLarge(
            f"frame body of {blen} bytes exceeds max_frame="
            f"{max_frame} — refusing the allocation (corrupt length "
            f"prefix, or raise max_frame for genuinely larger models)")
    header = _recv_exact(sock, hlen, deadline_at, "frame header")
    body = _recv_exact(sock, blen, deadline_at, "frame body")
    got_crc = zlib.crc32(header)
    got_crc = zlib.crc32(body, got_crc) & 0xFFFFFFFF
    if got_crc != crc:
        raise TransportError(
            f"frame CRC mismatch (stored {crc:#010x}, computed "
            f"{got_crc:#010x}) — corrupted in flight")
    return parse_payload(header, body)


def connect(host: str, port: int, *,
            deadline: float = DEFAULT_DEADLINE_SECONDS,
            attempts: int = 40, retry_sleep: float = 0.25
            ) -> socket.socket:
    """Dial the coordinator with bounded patience: a worker racing the
    coordinator's bind retries ``ConnectionRefusedError`` briefly, and
    every attempt carries a connect timeout."""
    last: Exception | None = None
    for _ in range(max(1, attempts)):
        try:
            sock = socket.create_connection((host, port),
                                            timeout=deadline)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock
        except (ConnectionRefusedError, socket.timeout, OSError) as e:
            last = e
            time.sleep(retry_sleep)
    raise TransportClosed(
        f"could not reach coordinator at {host}:{port} after "
        f"{attempts} attempts: {last}")


def request(sock: socket.socket, kind: str,
            meta: dict | None = None, arrays: dict | None = None,
            *, deadline: float = DEFAULT_DEADLINE_SECONDS):
    """One request/response round trip on a worker's connection."""
    send_frame(sock, kind, meta, arrays, deadline=deadline)
    return recv_frame(sock, deadline=deadline)
