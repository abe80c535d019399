"""The measured half of the autotuner: ``tda tune`` rig profiles (port of
``tpu_distalg/tune/profile.py``).

A short seeded profiling pass measures what the rig does:

* framed-TCP loopback wire bandwidth and RTT, through the cluster
  transport's real frame path (magic, header JSON, CRC32),
* host memcpy bandwidth (the shared-memory "wire" of one host),
* the host's float32 numpy matmul FLOP/s (``a @ b``; the resolver does
  not read it),
* host RAM,
* each host ``--comm`` codec's encode and decode throughput,
* optionally the psum of the port's own collectives over a mesh's data
  shards (:func:`measure_collective`) and the wall time of a cold child
  that imports torch and initialises the run's device.

The result persists as the JAX package's versioned, rig-tagged
``RigProfile`` JSON with a CRC over the canonical encoding, byte for
byte: a profile written by either package loads in the other.
``load_profile`` rejects schema drift and bit rot.

Every measurement is seeded (``np.random.default_rng``) and sized by
constants, so two passes on one rig give byte-identical profiles but for
the timings and the timestamp; the tests pin the clock through the
``clock`` parameter. ``created_unix`` is handed in by the caller.

numpy and stdlib at module level; :func:`measure_collective` imports
torch.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import zlib

import numpy as np

from tpu_distalg_torch.parallel import comms as pcomms

#: bump on any change to the measurement field set — ``load_profile``
#: rejects other versions instead of resolving from a half-understood
#: artifact
SCHEMA_VERSION = 1

#: profile artifact filename prefix (``newest_profile`` globs this)
PROFILE_PREFIX = "RIGPROFILE_"

#: env override for where profiles live (default: ``.tda_profiles``
#: under the working directory)
PROFILE_DIR_ENV = "TDA_PROFILE_DIR"

#: loopback bandwidth payload per frame (f32 elems) and frame count
_WIRE_ELEMS = 1 << 20
_WIRE_FRAMES = 8
_RTT_PINGS = 32

#: memcpy / codec / matmul working-set sizes
_MEMCPY_ELEMS = 1 << 23
_CODEC_ELEMS = 1 << 18
_MATMUL_N = 512

#: repeat counts (best-of)
_REPEATS = 3

#: quick mode divides the working sets by this (the artifact records
#: which mode ran)
_QUICK_DIV = 8

#: the cold child of :func:`_measure_backend_init`, by device type
_INIT_CHILD = {
    "cuda": "import torch; torch.cuda.init(); "
            "torch.empty(1, device='cuda'); torch.cuda.synchronize()",
    "cpu": "import torch",
}


class ProfileError(ValueError):
    """A profile artifact that must not be resolved from: wrong
    schema version, CRC mismatch, or a structurally broken file."""


# ---------------------------------------------------------------------
# measurement passes (each takes the injectable clock)


def _best_rate(clock, fn, units: float, repeats: int = _REPEATS
               ) -> float:
    """Best-of-``repeats`` rate in ``units``/second for ``fn()``."""
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = clock()
        fn()
        dt = clock() - t0
        best = min(best, max(dt, 1e-9))
    return units / best


def _measure_loopback(clock, *, elems: int, frames: int, pings: int):
    """Framed-TCP loopback: ``(bandwidth_bytes_s, rtt_s)`` through the
    cluster transport's real frame path (header JSON + CRC32)."""
    # lazy: cluster/ imports tune.defaults
    from tpu_distalg_torch.cluster import transport

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    deadline = 60.0

    def _echo():
        conn, _ = srv.accept()
        try:
            while True:
                kind, meta, arrays = transport.recv_frame(
                    conn, deadline=deadline)
                if kind == "bye":
                    return
                transport.send_frame(conn, "ok",
                                     meta={"n": meta.get("n", 0)},
                                     deadline=deadline)
        except (OSError, transport.TransportError):
            return
        finally:
            conn.close()

    th = threading.Thread(target=_echo, daemon=True)
    th.start()
    sock = transport.connect("127.0.0.1", port)
    try:
        payload = np.zeros((elems,), np.float32)
        payload_bytes = payload.nbytes
        # warm the path (connection + first-frame allocations)
        transport.send_frame(sock, "blk", meta={"n": 0},
                             arrays={"x": payload}, deadline=deadline)
        transport.recv_frame(sock, deadline=deadline)
        t0 = clock()
        for i in range(frames):
            transport.send_frame(sock, "blk", meta={"n": i},
                                 arrays={"x": payload},
                                 deadline=deadline)
            transport.recv_frame(sock, deadline=deadline)
        dt = max(clock() - t0, 1e-9)
        bandwidth = frames * payload_bytes / dt
        # RTT: minimal frames, the best of the pings (the floor is the
        # schedulable latency; outliers are scheduler noise)
        best = float("inf")
        for i in range(pings):
            t0 = clock()
            transport.send_frame(sock, "png", meta={"n": i},
                                 deadline=deadline)
            transport.recv_frame(sock, deadline=deadline)
            best = min(best, clock() - t0)
        transport.send_frame(sock, "bye", deadline=deadline)
    finally:
        sock.close()
        srv.close()
    th.join(timeout=5.0)
    return float(bandwidth), float(max(best, 1e-9))


def _measure_memcpy(clock, *, elems: int) -> float:
    """Host memcpy bandwidth (bytes/s)."""
    src = np.ones((elems,), np.float32)
    dst = np.empty_like(src)
    return _best_rate(clock, lambda: np.copyto(dst, src), src.nbytes)


def _measure_matmul(clock, rng, *, n: int) -> float:
    """The host's float32 numpy matmul FLOP/s (2·n³ per product)."""
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    return _best_rate(clock, lambda: a @ b, 2.0 * n * n * n)


def _measure_codecs(clock, rng, *, elems: int) -> dict:
    """Per-host-codec encode/decode throughput, f32 elems/second.

    ``dense`` is the raw serialize path (``tobytes``/``frombuffer``
    copy); ``int8``/``topk`` are the seeded host codecs the cluster wire
    frames."""
    vec = rng.standard_normal((elems,), dtype=np.float32)
    out: dict = {}
    buf = vec.tobytes()
    out["dense"] = {
        "encode_elems_s": _best_rate(clock, vec.tobytes, elems),
        "decode_elems_s": _best_rate(
            clock,
            lambda: np.frombuffer(buf, np.float32).copy(), elems),
    }
    for sched in pcomms.HOST_SCHEDULES:
        if sched == "dense":
            continue
        spec = pcomms.CommSpec.parse(sched)
        codec = pcomms.make_host_codec(spec)
        arrays, _ = codec.encode(vec, None, 0, 0, 0)
        out[sched] = {
            "encode_elems_s": _best_rate(
                clock, lambda c=codec: c.encode(vec, None, 0, 0, 0),
                elems),
            "decode_elems_s": _best_rate(
                clock,
                lambda c=codec, a=arrays: c.decode(a, elems), elems),
        }
    return out


def _host_ram_bytes() -> int | None:
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
        return int(pages) * int(page)
    except (ValueError, OSError, AttributeError):
        return None


def _measure_backend_init(clock, *, device: str = "cuda",
                          timeout: float = 120.0) -> float | None:
    """Wall time of a cold child that imports torch and initialises
    ``device`` (on ``cuda``: ``torch.cuda.init()`` and one allocation;
    on ``cpu``: the import alone). None when the child fails."""
    kind = str(device).split(":")[0]
    if kind not in _INIT_CHILD:
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         f"'cpu'")
    t0 = clock()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _INIT_CHILD[kind]],
            timeout=timeout, capture_output=True)
    except (subprocess.TimeoutExpired, OSError):
        return None
    if proc.returncode != 0:
        return None
    return float(max(clock() - t0, 1e-9))


def measure_collective(mesh, *, elems: int = 1 << 20,
                       repeats: int = _REPEATS, clock=None
                       ) -> dict | None:
    """Bandwidth and dispatch RTT of the port's psum
    (``collectives.tree_allreduce_sum``) of an ``(n, elems)`` float32 over
    the mesh's ``n`` data shards, with the JAX package's ring formula.
    None when the mesh has one data shard: there is no cross-shard wire
    to measure, and the resolver must know that rather than
    extrapolate."""
    import torch

    from tpu_distalg_torch.parallel.collectives import tree_allreduce_sum

    clock = clock or time.perf_counter
    n = int(mesh.n_data)
    if n < 2:
        return None
    dev = mesh.device

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _timed(x) -> float:
        rows = [(x[s],) for s in mesh.local_data]
        tree_allreduce_sum(rows, mesh)      # warm outside the timer
        _sync()
        best = float("inf")
        for _ in range(max(1, repeats)):
            t0 = clock()
            tree_allreduce_sum(rows, mesh)
            _sync()
            best = min(best, max(clock() - t0, 1e-9))
        return best

    ring = 2.0 * (n - 1) / n
    best = _timed(torch.ones((n, elems), dtype=torch.float32, device=dev))
    bandwidth = 4.0 * elems * ring / best
    rtt = _timed(torch.ones((n, 8), dtype=torch.float32, device=dev))
    return {"bandwidth_bytes_s": float(bandwidth),
            "rtt_s": float(rtt), "n_shards": n}


# ---------------------------------------------------------------------
# the pass


def measure_rig(*, seed: int = 0, quick: bool = False, clock=None,
                include_backend_init: bool = True,
                collective: dict | None = None,
                device: str = "cuda") -> dict:
    """Run the seeded profiling pass; the measurements dict of a
    profile. ``clock`` is injectable for the determinism tests (default
    ``time.perf_counter``). ``collective`` is a pre-measured
    :func:`measure_collective` result (None = no mesh measured);
    ``device`` is what the backend-init child initialises."""
    clock = clock or time.perf_counter
    rng = np.random.default_rng(seed)
    div = _QUICK_DIV if quick else 1
    wire_bw, wire_rtt = _measure_loopback(
        clock, elems=max(1 << 14, _WIRE_ELEMS // div),
        frames=max(2, _WIRE_FRAMES // (2 if quick else 1)),
        pings=max(8, _RTT_PINGS // div))
    measurements = {
        "loopback": {"bandwidth_bytes_s": wire_bw, "rtt_s": wire_rtt},
        "memcpy_bytes_s": _measure_memcpy(
            clock, elems=max(1 << 18, _MEMCPY_ELEMS // div)),
        "matmul_flops_s": _measure_matmul(
            clock, rng, n=max(128, _MATMUL_N // (2 if quick else 1))),
        "codecs": _measure_codecs(
            clock, rng, elems=max(1 << 14, _CODEC_ELEMS // div)),
        "host_ram_bytes": _host_ram_bytes(),
        "collective": collective,
        "backend_init_s": (_measure_backend_init(clock, device=device)
                           if include_backend_init else None),
        "quick": bool(quick),
    }
    return measurements


# ---------------------------------------------------------------------
# the artifact


def _canonical_bytes(profile: dict) -> bytes:
    """The CRC input: canonical JSON of everything except the CRC
    field itself."""
    body = {k: v for k, v in sorted(profile.items()) if k != "crc32"}
    return json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def profile_crc(profile: dict) -> int:
    return zlib.crc32(_canonical_bytes(profile)) & 0xFFFFFFFF


def build_profile(measurements: dict, *, created_unix: float,
                  seed: int, rig: str | None = None,
                  backend: str = "cpu") -> dict:
    """Assemble the versioned, rig-tagged artifact around a measurements
    dict. ``created_unix`` is handed in by the caller; ``backend`` is
    ``cuda`` or ``cpu``."""
    rig = rig or socket.gethostname()
    profile = {
        "schema_version": SCHEMA_VERSION,
        "profile_id": f"{rig}-{backend}-{int(created_unix)}",
        "rig": rig,
        "backend": backend,
        "created_unix": float(created_unix),
        "seed": int(seed),
        "measurements": measurements,
    }
    profile["crc32"] = profile_crc(profile)
    return profile


def default_profile_dir() -> str:
    return os.environ.get(PROFILE_DIR_ENV) \
        or os.path.join(os.getcwd(), ".tda_profiles")


def profile_path(profile: dict, directory: str | None = None) -> str:
    directory = directory or default_profile_dir()
    return os.path.join(
        directory, f"{PROFILE_PREFIX}{profile['profile_id']}.json")


def save_profile(profile: dict, directory: str | None = None) -> str:
    """Atomic publish (tmp + rename) through the ``ckpt:write`` fault
    seam: a chaos schedule can corrupt or fail the profile write, and
    the CRC in :func:`load_profile` is what catches the torn bytes."""
    from tpu_distalg_torch import faults

    path = profile_path(profile, directory)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    payload = (json.dumps(profile, indent=2, sort_keys=True)
               + "\n").encode("utf-8")
    payload = faults.inject("ckpt:write", payload=payload)
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)
    return path


def load_profile(path: str) -> dict:
    """Load and verify: schema version and CRC both reject rather than
    resolve geometry from a stale or bit-rotted artifact."""
    try:
        with open(path, encoding="utf-8") as f:
            profile = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ProfileError(f"unreadable profile {path}: {e}") from e
    if not isinstance(profile, dict):
        raise ProfileError(f"profile {path} is not a JSON object")
    version = profile.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ProfileError(
            f"profile {path} has schema_version={version!r}, this "
            f"build understands {SCHEMA_VERSION} — re-run `tda tune`")
    crc = profile.get("crc32")
    want = profile_crc(profile)
    if crc != want:
        raise ProfileError(
            f"profile {path} fails CRC (stored {crc!r}, computed "
            f"{want}) — corrupt artifact, re-run `tda tune`")
    return profile


def newest_profile(directory: str | None = None,
                   rig: str | None = None):
    """``(profile, path)`` of the newest valid profile (by
    ``created_unix``), optionally of one rig tag; ``(None, None)`` when
    nothing valid exists. Invalid artifacts are skipped, not fatal:
    ``--tune auto`` then keeps the defaults and says why."""
    directory = directory or default_profile_dir()
    if not os.path.isdir(directory):
        return None, None
    best, best_path = None, None
    for name in sorted(os.listdir(directory)):
        if not (name.startswith(PROFILE_PREFIX)
                and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        try:
            profile = load_profile(path)
        except ProfileError:
            continue
        if rig is not None and profile.get("rig") != rig:
            continue
        if best is None or profile["created_unix"] \
                > best["created_unix"]:
            best, best_path = profile, path
    return best, best_path
