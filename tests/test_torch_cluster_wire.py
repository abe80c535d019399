"""The cluster runtime's foundations (``tpu_distalg_torch/cluster/``
transport, WAL, parameter server and schedule compilers,
``tune/defaults.py`` and ``parallel/partition.py``'s row ownership)
against the JAX package's on the same inputs, on the CPU.

Standard: bytes. A frame and a WAL segment are compared byte for byte
(never by parsing them back), PS splits, joins and merges bitwise, the
schedule compilers' arrays exactly, refusals by exception class and
message. Frames cross between the packages over a socket pair in both
directions. Every case is a few frames or a few records: the property
is the bytes, not the size.
"""

from __future__ import annotations

import os
import socket
import time

import numpy as np
import pytest

from tpu_distalg import faults as jfaults
from tpu_distalg import tune as jtune
from tpu_distalg.cluster import coordinator as jcoord
from tpu_distalg.cluster import ps as jps
from tpu_distalg.cluster import rowstore as jrowstore
from tpu_distalg.cluster import transport as jtransport
from tpu_distalg.cluster import wal as jwal
from tpu_distalg.cluster import worker as jworker
from tpu_distalg.faults import registry as jregistry
from tpu_distalg.parallel import partition as jpartition
from tpu_distalg.telemetry import events as jevents
from tpu_distalg_torch import faults, tune
from tpu_distalg_torch.cluster import coordinator, ps, rowstore, transport
from tpu_distalg_torch.cluster import wal, worker
from tpu_distalg_torch.faults import registry
from tpu_distalg_torch.parallel import partition
from tpu_distalg_torch.telemetry import events
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

#: every dtype kind the wire admits (``SAFE_DTYPE_KINDS`` = b, i, u, f,
#: c), in both byte orders where there is one
DTYPES = ["?", "i1", "i2", "<i4", ">i4", "<i8", "u1", "<u2", "<u4",
          "<u8", "<f2", "<f4", ">f4", "<f8", "<c8", "<c16"]
#: (kind, meta, arrays) cases beyond the dtype grid
FRAMES = {
    "empty": ("poll", None, None),
    "meta": ("join", {"slot": 2, "inc": 7, "resume": True,
                      "rejoin": False, "admit_at": None,
                      "stats": {"gated_ms": 0.125, "ages": [0, 1, 2],
                                "name": "wörker ✓"}}, None),
    "push": ("push", {"slot": 1, "inc": 3, "window": 5, "base": 4,
                      "have": 4},
             {"w": np.linspace(-1, 1, 31, dtype=np.float32)}),
    "several": ("commit", {"window": 0, "contribs": [], "skipped": [1]},
                {"0/w": np.arange(6, dtype=np.float32).reshape(2, 3),
                 "2/w.q": np.array([-127, 0, 127], np.int8),
                 "2/w.scale": np.float32(0.5),
                 "idx": np.array([], np.int64)}),
    "fortran": ("center", {"version": 3},
                {"w": np.asfortranarray(
                    np.arange(12, dtype=np.float64).reshape(3, 4))}),
}


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.configure(False)
    jfaults.configure(False)
    events.configure(False)
    jevents.configure(False)


def _rng_array(dt: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dt = np.dtype(dt)
    if dt.kind == "b":
        return rng.integers(0, 2, (3, 5)).astype(dt)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, (3, 5),
                            dtype=dt.newbyteorder("="), endpoint=True
                            ).astype(dt)
    if dt.kind == "c":
        return (rng.normal(size=(3, 5))
                + 1j * rng.normal(size=(3, 5))).astype(dt)
    return rng.normal(size=(3, 5)).astype(dt)


def _both_equal(kind, meta, arrays) -> bytes:
    got = transport.encode_frame(kind, meta, arrays)
    try:
        want = jtransport.encode_frame(kind, meta, arrays)
    except TypeError as e:
        # the JAX package cannot frame a zero-size array of rank > 1
        # (its memoryview cast raises); such an array adds a header
        # entry and no body bytes, so the bodies are equal
        assert "memoryview" in str(e)
        psize = transport._PREFIX.size
        _, hlen, blen, _ = transport._PREFIX.unpack(got[:psize])
        want = jtransport.encode_frame(
            kind, meta, {k: v for k, v in arrays.items() if np.size(v)})
        _, jhlen, jblen, _ = jtransport._PREFIX.unpack(want[:psize])
        assert got[psize + hlen:] == want[psize + jhlen:]
        assert blen == jblen
    else:
        assert got == want
    assert b"".join(bytes(p) for p in transport.encode_frame_parts(
        kind, meta, arrays)) == got
    return got


# ------------------------------------------------------------- frames

@pytest.mark.parametrize("dt", DTYPES)
def test_frame_bytes_equal_jax_for_every_wire_dtype(dt):
    """One frame a dtype (a 2-D array, a 0-d one and an empty one): the
    port's bytes are JAX's (with the empty array's spec, which JAX
    cannot frame), and each side parses the other's back to the same
    dtype, shape and values."""
    arrays = {"a": _rng_array(dt, 1), "s": _rng_array(dt, 2)[0, 0],
              "e": np.zeros((0, 4), dt)}
    buf = _both_equal("push", {"dtype": dt}, arrays)
    psize = transport._PREFIX.size
    _, hlen, _, _ = transport._PREFIX.unpack(buf[:psize])
    header, body = buf[psize:psize + hlen], buf[psize + hlen:]
    for parse in (transport.parse_payload, jtransport.parse_payload):
        kind, meta, out = parse(header, body)
        assert (kind, meta) == ("push", {"dtype": dt})
        for name, want in arrays.items():
            assert out[name].dtype == want.dtype
            # a 0-d array crosses as shape (1,) (ascontiguousarray)
            assert out[name].shape == np.ascontiguousarray(want).shape
            assert out[name].tobytes() == np.ascontiguousarray(
                want).tobytes()


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_frame_bytes_equal_jax_over_kinds_and_metas(case):
    _both_equal(*FRAMES[case])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_frames_cross_between_the_packages(direction):
    """A frame sent by one package's ``send_frame`` is received by the
    other's ``recv_frame``, and both count it in ``wire_stats``."""
    a, b = socket.socketpair()
    send, recv = ((transport, jtransport) if direction == "port_to_jax"
                  else (jtransport, transport))
    send.wire_stats_reset()
    kind, meta, arrays = FRAMES["several"]
    arrays = {k: v for k, v in arrays.items() if np.size(v)}
    try:
        send.send_frame(a, kind, meta, arrays)
        got_kind, got_meta, got = recv.recv_frame(b, deadline=5.0)
    finally:
        a.close(), b.close()
    assert (got_kind, got_meta) == (kind, meta)
    for name, want in arrays.items():
        assert got[name].tobytes() == np.asarray(want).tobytes()
    n = len(transport.encode_frame(kind, meta, arrays))
    assert send.wire_stats() == {kind: {"frames": 1, "bytes": n}}


# ---------------------------------------------------------- refusals

def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the comparison is the point
        return type(e).__name__, str(e)
    raise AssertionError("no exception")


def _forge_length(mod):
    buf = bytearray(mod.encode_frame("x", {}))
    magic, hlen, _, crc = mod._PREFIX.unpack(bytes(buf[:mod._PREFIX.size]))
    buf[:mod._PREFIX.size] = mod._PREFIX.pack(magic, hlen, 1 << 40, crc)
    return bytes(buf)


def _flip_body(mod):
    buf = bytearray(mod.encode_frame("x", {"v": 1}, {"w": np.ones(4)}))
    buf[-2] ^= 0xFF
    return bytes(buf)


#: refusal -> the bytes written to the peer before the receive (None =
#: nothing, the deadline case), and whether the writer then closes
REFUSALS = {
    "truncated": (lambda m: m.encode_frame(
        "x", {"n": 1}, {"w": np.ones(8)})[:-5], True),
    "oversized": (_forge_length, False),
    "bad_crc": (_flip_body, False),
    "bad_magic": (lambda m: b"HTTP/1.1 200 OK\r\n" + b"\x00" * 16, False),
    "deadline": (lambda m: None, False),
    "deadline_mid_frame": (lambda m: m.encode_frame(
        "x", {}, {"w": np.ones(4)})[:6], False),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_receive_refusals_equal_jax(case):
    """Truncated, oversized (refused before the allocation), bad CRC,
    bad magic and deadline (empty and mid-frame): the same class and
    message in both packages."""
    make, close = REFUSALS[case]
    out = []
    for mod in (transport, jtransport):
        a, b = socket.socketpair()
        data = make(mod)
        if data is not None:
            a.sendall(data)
        if close:
            a.close()
        t0 = time.monotonic()
        cls, msg = _raised(lambda: mod.recv_frame(b, deadline=0.2))
        assert time.monotonic() - t0 < 5.0
        a.close(), b.close()
        out.append((cls, msg))
    assert out[0] == out[1]
    want = {"truncated": "TransportClosed", "oversized": "FrameTooLarge",
            "bad_crc": "TransportError", "bad_magic": "TransportError",
            "deadline": "TransportTimeout",
            "deadline_mid_frame": "TransportTimeout"}[case]
    assert out[0][0] == want


@pytest.mark.parametrize("where", ["encode", "parse"])
def test_object_dtype_refused_both_ends(where):
    """No pickle: an object array is refused when a frame is made and
    when a header naming it is parsed."""
    obj = np.array([{}, []], dtype=object)
    if where == "encode":
        got = [_raised(lambda m=m: m.encode_frame("x", {}, {"o": obj}))
               for m in (transport, jtransport)]
    else:
        header = b'{"k":"x","meta":{},"arrays":[{"n":"o","d":"|O","s":[2]}]}'
        got = [_raised(lambda m=m: m.parse_payload(header, b"\0" * 16))
               for m in (transport, jtransport)]
    assert got[0] == got[1] and "pickle" in got[0][1]


def test_rpc_fault_seam_equals_jax():
    """``cluster:rpc``: an injected oserror surfaces as TransportClosed
    on the invocation the plan names, in both packages."""
    out = []
    for mod, flt in ((transport, faults), (jtransport, jfaults)):
        reg = flt.configure("seed=1;cluster:rpc@1=oserror")
        a, b = socket.socketpair()
        try:
            mod.send_frame(a, "x", {})                       # hit 0
            err = _raised(lambda: mod.recv_frame(b, deadline=5.0))  # 1
            mod.send_frame(a, "y", {})                       # hit 2
            kind = mod.recv_frame(b, deadline=5.0)[0]        # 3 ("x")
            out.append((err, kind, list(reg.fired)))
        finally:
            flt.configure(False)
            a.close(), b.close()
    assert out[0] == out[1]
    assert out[0][0][0] == "TransportClosed" and out[0][1] == "x"


# -------------------------------------------------------------- WAL

def _wal_sequence(mod, d, plan=None, flt=None):
    """One run of appends: a segment, admissions, a skip, two commits
    with delta bytes, a rotation, a hold, a bye and done."""
    rng = np.random.default_rng(3)
    reg = flt.configure(plan) if plan else None
    try:
        w = mod.WriteAheadLog(d)
        w.open_segment(0, {"version": 0, "gen": 0, "events": [],
                           "slots": {"0": {"status": "free"}}})
        for slot in range(3):
            w.append("admit", {"slot": slot, "admit": 0,
                               "incarnation": slot + 1, "gen": slot + 1})
        w.append("skip", {"slot": 1, "inc": 2, "window": 0})
        for win in range(2):
            deltas = {s: {"w": rng.normal(size=31).astype(np.float32)}
                      for s in (0, 2)}
            w.append("commit", {
                "window": win,
                "contribs": [{"slot": s, "base": win, "age": 0,
                              "digest": mod.delta_digest(d_)}
                             for s, d_ in deltas.items()],
                "skipped": [1] if win == 0 else [], "version": win + 1},
                {f"{s}/{k}": v for s, d_ in deltas.items()
                 for k, v in d_.items()})
        w.rotate(2, {"version": 2, "gen": 3}, keep_base=2)
        w.append("hold", {"window": 5, "n_active": 3})
        w.append("bye", {"slot": 0, "stats": {"pushes": 2}})
        w.append("done", {"version": 2})
        w.close()
    finally:
        if reg is not None:
            flt.configure(False)
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


def test_wal_segment_bytes_equal_jax(tmp_path):
    got = _wal_sequence(wal, str(tmp_path / "p"))
    want = _wal_sequence(jwal, str(tmp_path / "j"))
    assert list(got) == ["wal_000000000002.log"]
    assert got == want
    assert wal.delta_digest({"w": np.arange(5, dtype=np.float32)}) == \
        jwal.delta_digest({"w": np.arange(5, dtype=np.float32)})


def _records_equal(a, b):
    assert [(k, m) for k, m, _ in a] == [(k, m) for k, m, _ in b]
    for (_, _, x), (_, _, y) in zip(a, b):
        assert sorted(x) == sorted(y)
        for name in x:
            assert x[name].tobytes() == y[name].tobytes()


def _emits(monkeypatch, mod_events, sink):
    def emit(ev, **fields):
        fields.pop("path", None)
        sink.append((ev, fields))
    monkeypatch.setattr(mod_events, "emit", emit)


def _short_segment(mod, d):
    w = mod.WriteAheadLog(d)
    w.open_segment(0, {"version": 0})
    w.append("admit", {"slot": 0, "admit": 0, "incarnation": 1, "gen": 1})
    w.append("skip", {"slot": 0, "inc": 1, "window": 3})
    w.close()
    return mod._segment_path(d, 0)


def _torn(mod, d, how):
    path = _short_segment(mod, d)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if how == "truncate":
            f.truncate(size - 7)
        else:
            f.seek(size - 3)
            b = f.read(1)
            f.seek(size - 3)
            f.write(bytes([b[0] ^ 0xFF]))
    first = mod.read_segment(path)
    return first, mod.read_segment(path), open(path, "rb").read()


def _injected(mod, d, flt):
    flt.configure("seed=5;cluster:wal@2=corrupt")
    try:
        path = _short_segment(mod, d)
    finally:
        flt.configure(False)
    return mod.read_segment(path), open(path, "rb").read()


def _failed_append(mod, d, monkeypatch):
    w = mod.WriteAheadLog(d)
    w.open_segment(0, {"version": 0})
    real_fsync, calls = os.fsync, {"n": 0}

    def flaky_fsync(fd):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient disk fault after the write")
        return real_fsync(fd)

    with monkeypatch.context() as mp:
        mp.setattr(mod.os, "fsync", flaky_fsync)
        err = _raised(lambda: w.append("skip", {"slot": 0, "inc": 1,
                                                "window": 2}))
        w.append("skip", {"slot": 0, "inc": 1, "window": 2})
    w.close()
    path = mod._segment_path(d, 0)
    return err, mod.read_segment(path), open(path, "rb").read()


def _headerless(mod, d):
    w = mod.WriteAheadLog(d)
    w.open_segment(0, {"version": 0})
    w.close()
    with open(mod._segment_path(d, 0), "r+b") as f:
        f.truncate(5)
    w2 = mod.WriteAheadLog(d)
    w2.open_segment(0, {"version": 0, "gen": 0})
    w2.append("admit", {"slot": 0, "admit": 0, "incarnation": 1, "gen": 1})
    w2.close()
    return mod.WriteAheadLog.replay(d, 0), open(
        mod._segment_path(d, 0), "rb").read()


def _headerless_newer(mod, d):
    w = mod.WriteAheadLog(d)
    w.open_segment(0, {"version": 0})
    w.append("admit", {"slot": 0, "admit": 0, "incarnation": 1, "gen": 1})
    w.rotate(3, {"version": 3}, keep_base=0)
    w.close()
    with open(mod._segment_path(d, 3), "r+b") as f:
        f.truncate(4)
    return mod.WriteAheadLog.replay(d, 3)


def _rotation(mod, d):
    w = mod.WriteAheadLog(d)
    w.open_segment(0, {"version": 0})
    w.rotate(3, {"version": 3}, keep_base=3)
    first = mod.segment_bases(d)
    w.rotate(6, {"version": 6}, keep_base=3)
    w.close()
    return (first, mod.segment_bases(d), mod.WriteAheadLog.replay(d, 6),
            mod.WriteAheadLog.replay(d, 3))


WAL_CASES = ("torn_truncate", "torn_flip", "injected_corrupt",
             "failed_append", "headerless", "headerless_newer", "rotation")


@pytest.mark.parametrize("case", WAL_CASES)
def test_wal_repairs_equal_jax(case, tmp_path, monkeypatch):
    """The torn tail (cut and bit-flipped), the ``cluster:wal`` corrupt
    seam, the rewound failed append, the rewritten headerless segment,
    the headerless newer segment that must not shadow an older one,
    and rotation: the same records, torn counts, file bytes and events
    (``wal_quarantine``) in both packages."""
    got_ev, want_ev = [], []
    _emits(monkeypatch, events, got_ev)
    _emits(monkeypatch, jevents, want_ev)
    out = {}
    for tag, mod, flt in (("p", wal, faults), ("j", jwal, jfaults)):
        d = str(tmp_path / tag)
        if case.startswith("torn_"):
            out[tag] = _torn(mod, d, case[5:])
        elif case == "injected_corrupt":
            out[tag] = _injected(mod, d, flt)
        elif case == "failed_append":
            out[tag] = _failed_append(mod, d, monkeypatch)
        elif case == "headerless":
            out[tag] = _headerless(mod, d)
        elif case == "headerless_newer":
            out[tag] = _headerless_newer(mod, d)
        else:
            out[tag] = _rotation(mod, d)
    got, want = out["p"], out["j"]

    def flat(x):
        # records compared by bytes; everything else as it is
        if isinstance(x, list) and x and isinstance(x[0], tuple) \
                and len(x[0]) == 3 and isinstance(x[0][2], dict):
            return [(k, m, {n: a.tobytes() for n, a in arrs.items()})
                    for k, m, arrs in x]
        if isinstance(x, tuple):
            return tuple(flat(v) for v in x)
        return x

    assert flat(got) == flat(want)
    assert got_ev == want_ev
    if case.startswith("torn_") or case == "injected_corrupt":
        assert "wal_quarantine" in [ev for ev, _ in got_ev]


# --------------------------------------------------------- PS tier

PS_CENTERS = {
    "lr_w": ({"w": np.arange(31, dtype=np.float32)}, 3),
    "row_sharded": ({"res": np.arange(20, dtype=np.float32).reshape(10, 2)},
                    3),
    "uneven_many": ({"res": np.linspace(-3, 3, 7 * 3, dtype=np.float32
                                        ).reshape(7, 3),
                     "w": np.ones(5, np.float32)}, 4),
}


@pytest.mark.parametrize("case", sorted(PS_CENTERS))
def test_ps_split_join_equal_jax(case):
    center, n = PS_CENTERS[case]
    got = ps.split_center(center, "lr", n)
    want = jps.split_center(center, "lr", n)
    assert [sorted(s) for s in got] == [sorted(s) for s in want]
    for g, w in zip(got, want):
        for k in g:
            assert g[k].tobytes() == w[k].tobytes()
    j = ps.join_center(got)
    jj = jps.join_center(want)
    assert sorted(j) == sorted(jj) == sorted(center)
    for k in j:
        assert j[k].tobytes() == jj[k].tobytes() == center[k].tobytes()


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_ps_merge_history_and_delta_since_bitwise(n_shards):
    """Staleness-weighted merges with ages 0..3, an empty commit, the
    version history and ``delta_since``: bitwise JAX's."""
    rng = np.random.default_rng(n_shards)
    center = {"w": rng.normal(size=31).astype(np.float32)}
    mine = ps.ParameterServer(center, n_shards=n_shards, decay=0.5,
                              history_depth=4)
    theirs = jps.ParameterServer(center, n_shards=n_shards, decay=0.5,
                                 history_depth=4)
    for srv in (mine, theirs):
        srv.record_history(0)
    for win in range(6):
        contribs = [(s, max(0, win - s),
                     {"w": rng.normal(size=31).astype(np.float32)})
                    for s in range(3) if (win + s) % 4]
        if win == 3:
            contribs = []
        assert mine.merge(win, contribs) == theirs.merge(win, contribs)
        assert mine.snapshot()["w"].tobytes() == \
            theirs.snapshot()["w"].tobytes()
        assert mine.version == theirs.version
    assert sorted(mine.history) == sorted(theirs.history)
    for have in (3, 4, 5):
        a, b = mine.delta_since(have, 6), theirs.delta_since(have, 6)
        assert a["w"].tobytes() == b["w"].tobytes()
    assert mine.delta_since(0, 6) is None and theirs.delta_since(0, 6) \
        is None
    assert ps.ParameterServer.weight(0.5, 3) == \
        jps.ParameterServer.weight(0.5, 3)


def test_ps_rowstore_mode_refuses_naming_a12_5():
    """The rowstore mode runs: a push carrying ``w.rows`` moves only
    those rows, merged as the JAX package's rowstore PS merges them;
    an unknown mode is refused."""
    center = {"w": np.arange(6, dtype=np.float32)}
    mine = ps.ParameterServer(center, mode="rowstore")
    theirs = jps.ParameterServer(center, mode="rowstore")
    push = [(0, 0, {"w": np.ones(2, np.float32),
                    "w.rows": np.array([1, 4], np.int64)})]
    assert mine.merge(0, push) == theirs.merge(0, push)
    got = mine.snapshot()["w"]
    assert got.tobytes() == theirs.snapshot()["w"].tobytes()
    assert np.array_equal(got, [0, 2, 2, 3, 5, 5])
    assert coordinator.ClusterConfig(ps_mode="rowstore").ps_mode == \
        "rowstore"
    with pytest.raises(ValueError, match="unknown ps mode"):
        ps.ParameterServer({"w": np.zeros(3, np.float32)}, mode="x")


# ------------------------------------------------------ schedules

SCHEDULE_PLANS = (
    "seed=7;cluster:worker@10=kill;cluster:worker@22=straggle:40",
    "seed=3;cluster:worker@p0.2=straggle:30;cluster:worker@p0.05=kill",
    "seed=11;cluster:coordinator@12=kill;cluster:ps@3=hang:0.2",
    "seed=5;cluster:coordinator@p0.3=hang;cluster:ps@p0.2=kill;"
    "ckpt:write@0=oserror",
    "seed=2;cluster:worker@*=straggle",
    "seed=4;ckpt:write@1=corrupt",
)


@pytest.mark.parametrize("spec", SCHEDULE_PLANS)
def test_schedule_compilers_and_strip_kills_equal_jax(spec):
    """``compile_worker_schedule``, ``compile_coordinator_schedule``,
    ``rowstore.compile_point_schedule`` and ``strip_kills``: the same
    arrays and spellings from the same plan."""
    plan, jplan = registry.FaultPlan.parse(spec), jregistry.FaultPlan.parse(
        spec)
    for n_windows, n_slots in ((8, 3), (24, 3), (5, 1)):
        a = worker.compile_worker_schedule(n_windows, n_slots, plan=plan)
        b = jworker.compile_worker_schedule(n_windows, n_slots, plan=jplan)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        a = coordinator.compile_coordinator_schedule(n_windows, plan=plan)
        b = jcoord.compile_coordinator_schedule(n_windows, plan=jplan)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        for point in ("cluster:ps", "cluster:worker"):
            a = rowstore.compile_point_schedule(point, n_windows, n_slots,
                                                plan=plan)
            b = jrowstore.compile_point_schedule(point, n_windows, n_slots,
                                                 plan=jplan)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for points in (("cluster:worker",), ("cluster:coordinator",
                                         "cluster:ps")):
        assert worker.strip_kills(spec, points) == \
            jworker.strip_kills(spec, points)
    assert worker.KILL == jworker.KILL
    assert rowstore.KILL_CELL == jrowstore.KILL_CELL == \
        coordinator.COORD_KILL


def test_live_registry_records_compiled_fires_once_like_jax():
    """With the plan live, a compiler mirrors its fires into the live
    ledger once, however often it recompiles (a restart)."""
    spec = "seed=7;cluster:worker@10=kill;cluster:coordinator@2=hang:0.1"
    out = []
    for flt, wmod, cmod in ((faults, worker, coordinator),
                            (jfaults, jworker, jcoord)):
        reg = flt.configure(spec)
        try:
            for _ in range(2):
                wmod.compile_worker_schedule(8, 3)
                cmod.compile_coordinator_schedule(8)
            out.append(list(reg.fired))
        finally:
            flt.configure(False)
    assert out[0] == out[1] == [("cluster:worker", 10, "kill"),
                                ("cluster:coordinator", 2, "hang")]


# ------------------------------------------- defaults and partition

def test_tune_defaults_equal_jax():
    names = sorted(n for n in dir(jtune.defaults) if n.isupper())
    assert names == sorted(n for n in dir(tune.defaults) if n.isupper())
    for n in names:
        assert getattr(tune.defaults, n) == getattr(jtune.defaults, n), n


@pytest.mark.parametrize("n_rows,n_shards", [(0, 1), (1, 3), (10, 3),
                                             (31, 2), (1000, 7)])
def test_row_bounds_and_row_block_stats_equal_jax(n_rows, n_shards):
    a, b = partition.row_bounds(n_rows, n_shards), jpartition.row_bounds(
        n_rows, n_shards)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    for block_rows in (1, 64, 4096):
        for row_bytes in (4, 504):
            assert partition.row_block_stats(
                n_rows, block_rows, n_shards=n_shards,
                row_bytes=row_bytes) == jpartition.row_block_stats(
                n_rows, block_rows, n_shards=n_shards, row_bytes=row_bytes)
    with pytest.raises(partition.PartitionRuleError, match="n_shards"):
        partition.row_bounds(4, 0)


@pytest.mark.parametrize("table", ["lr", "als_train", "kmeans"])
def test_row_ownership_map_equal_jax(table):
    """``RowOwnershipMap`` over each table's leaves: the same sharded
    flags, bounds, owners, per-row owners, splits and joins."""
    shapes = {"lr": {"w": (31,), "res": (10, 2)},
              "als_train": {"U": (13, 4), "V": (9, 4)},
              "kmeans": {"centers": (5, 3)}}[table]
    tree = {k: np.arange(np.prod(s), dtype=np.float32).reshape(s)
            for k, s in shapes.items()}
    for n in (1, 2, 3):
        m = partition.RowOwnershipMap(shapes, table, n)
        jm = jpartition.RowOwnershipMap(shapes, table, n)
        for name in shapes:
            o, jo = m[name], jm[name]
            assert (o.sharded, o.shape, o.owner) == (jo.sharded, jo.shape,
                                                     jo.owner)
            assert np.array_equal(o.bounds, jo.bounds) if o.sharded \
                else jo.bounds is None
            assert [o.range_of(i) for i in range(n)] == \
                [jo.range_of(i) for i in range(n)]
            rows = np.arange(shapes[name][0])
            assert np.array_equal(o.owner_of(rows), jo.owner_of(rows))
        sp, jsp = m.split(tree), jm.split(tree)
        assert [{k: v.tobytes() for k, v in s.items()} for s in sp] == \
            [{k: v.tobytes() for k, v in s.items()} for s in jsp]
        assert {k: v.tobytes() for k, v in m.join(sp).items()} == \
            {k: v.tobytes() for k, v in jm.join(jsp).items()}
    with pytest.raises(partition.PartitionRuleError, match="not in"):
        partition.RowOwnershipMap(shapes, table, 2)["nope"]
