"""The port's autotuner (``tpu_distalg_torch/tune/``) against the JAX
package's (``tpu_distalg/tune/``), on the CPU.

Profiles: the port writes the JAX package's artifact byte for byte (the
same measurements under a pinned clock give the same bytes in both
packages, and a profile written by either loads in the other); schema
drift and bit rot are rejected. Resolutions: on the JAX package's own
crafted profiles (``tests/test_tune.py``) the two resolvers give equal
``Resolution``s, every knob's value, source and WHY, and the same
predicted sync seconds. The command line: ``tda tune`` and ``--tune`` on
``--device cpu``; a tuned cluster replays bitwise.

Sizes: ``measure_rig(quick=True)`` (its smallest working sets); the
SSGD runs are breast cancer at 5 steps and the cluster 2 slots × 4
windows on 512 rows, the smallest that still merge.
"""

from __future__ import annotations

import copy
import json
import os
import socket

import numpy as np
import pytest

from tpu_distalg import tune as jtune
from tpu_distalg_torch import cli
from tpu_distalg_torch import tune as ttune
from tpu_distalg_torch.utils.device import share_host_threads

share_host_threads(os.environ.get("PYTEST_XDIST_WORKER_COUNT"))


class FakeClock:
    """A duration clock that advances a fixed step a read, so measured
    rates depend only on the (seeded, constant-sized) call counts."""

    def __init__(self, step=1e-3):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _crafted(*, loopback_bw=300e6, loopback_rtt=50e-6, memcpy=1e9,
             ram=1 << 34, collective=None, codec_rate=1e12,
             backend_init_s=None, created=1000.0, mod=ttune):
    """JAX ``tests/test_tune.py:36``'s hand-built profile."""
    codecs = {s: {"encode_elems_s": codec_rate,
                  "decode_elems_s": codec_rate}
              for s in ("dense", "int8", "topk")}
    meas = {
        "loopback": {"bandwidth_bytes_s": loopback_bw,
                     "rtt_s": loopback_rtt},
        "memcpy_bytes_s": memcpy,
        "matmul_flops_s": 1e11,
        "codecs": codecs,
        "host_ram_bytes": ram,
        "collective": collective,
        "backend_init_s": backend_init_s,
        "quick": True,
    }
    return mod.build_profile(meas, created_unix=created, seed=0,
                             rig="crafted-rig", backend="cpu")


# ------------------------------------------------------- the artifact

def test_profiles_are_the_jax_packages_bytes(tmp_path):
    """The same measurements build the same dict and CRC in both
    packages, save to the same bytes, and each package loads the
    other's file."""
    mine, theirs = _crafted(mod=ttune), _crafted(mod=jtune)
    assert mine == theirs and mine["crc32"] == ttune.profile_crc(theirs)
    pa = ttune.save_profile(mine, str(tmp_path / "port"))
    pb = jtune.save_profile(theirs, str(tmp_path / "jax"))
    assert os.path.basename(pa) == os.path.basename(pb)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    assert jtune.load_profile(pa) == mine
    assert ttune.load_profile(pb) == theirs


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_schema_drift_and_bit_rot_are_rejected(tmp_path, writer):
    mod = ttune if writer == "port" else jtune
    prof = _crafted(mod=mod)
    bad = dict(prof, schema_version=ttune.SCHEMA_VERSION + 1)
    bad["crc32"] = mod.profile_crc(bad)    # an honest CRC, a wrong schema
    p = tmp_path / "RIGPROFILE_x.json"
    p.write_text(json.dumps(bad))
    with pytest.raises(ttune.ProfileError, match="schema_version"):
        ttune.load_profile(str(p))
    path = mod.save_profile(prof, str(tmp_path))
    rotted = open(path).read().replace('"rig": "crafted-rig"',
                                       '"rig": "crafted-rig2"')
    open(path, "w").write(rotted)
    with pytest.raises(ttune.ProfileError, match="CRC"):
        ttune.load_profile(path)


def test_newest_profile_picks_the_newest_of_the_rig(tmp_path):
    old, new = _crafted(created=1000.0), _crafted(created=2000.0)
    ttune.save_profile(old, str(tmp_path))
    jtune.save_profile(new, str(tmp_path))
    (tmp_path / "RIGPROFILE_junk.json").write_text("{not json")
    got, path = ttune.newest_profile(str(tmp_path), rig="crafted-rig")
    assert got == new and path.endswith(
        f"RIGPROFILE_{new['profile_id']}.json")
    assert ttune.newest_profile(str(tmp_path), rig="other") == (None, None)
    assert ttune.newest_profile(str(tmp_path / "none")) == (None, None)


def test_measure_rig_under_a_pinned_clock_is_jaxs_bytes():
    """Two passes under a pinned clock give byte-identical profiles, and
    the JAX package's pass under the same clock gives the same bytes:
    the working sets, the call counts and the field set are JAX's."""
    def profile(mod):
        m = mod.measure_rig(seed=0, quick=True, clock=FakeClock(),
                            include_backend_init=False)
        return mod.build_profile(m, created_unix=5.0, seed=0, rig="r",
                                 backend="cpu")

    p1, p2, pj = profile(ttune), profile(ttune), profile(jtune)
    assert json.dumps(p1, sort_keys=True) == json.dumps(p2, sort_keys=True)
    assert json.dumps(p1, sort_keys=True) == json.dumps(pj, sort_keys=True)
    assert set(p1["measurements"]) == {
        "loopback", "memcpy_bytes_s", "matmul_flops_s", "codecs",
        "host_ram_bytes", "collective", "backend_init_s", "quick"}


def test_backend_init_and_collective_passes_on_the_cpu():
    """The cold child that imports torch is timed on ``cpu``; the psum
    over 4 emulated shards is measured, and one shard has no wire."""
    from tpu_distalg_torch.parallel import get_mesh
    from tpu_distalg_torch.tune import profile as tprofile

    assert tprofile._measure_backend_init(FakeClock(), device="cpu") \
        == pytest.approx(1e-3)
    with pytest.raises(ValueError, match="unsupported device"):
        tprofile._measure_backend_init(FakeClock(), device="tpu")
    assert ttune.measure_collective(get_mesh(data=1, device="cpu")) is None
    got = ttune.measure_collective(get_mesh(data=4, device="cpu"),
                                   elems=1 << 12, clock=FakeClock())
    assert got["n_shards"] == 4
    # one clock step for the best of the repeats: the JAX formula
    assert got["bandwidth_bytes_s"] == pytest.approx(
        4.0 * (1 << 12) * 1.5 / 1e-3)
    assert got["rtt_s"] == pytest.approx(1e-3)


# --------------------------------------------------------- the resolver

#: (profile overrides, workload, explicit): JAX ``tests/test_tune.py``'s
#: cases — slow wire / fast codec, fast wire / slow codec, device
#: transport without and with a collective, every knob's closed form,
#: pull-refresh for compressed pulls, explicit flags, the bucket folded
#: into the comm string, a row count, no RAM, a huge model
CASES = [
    (dict(loopback_bw=1e6, loopback_rtt=1e-4, codec_rate=1e12),
     dict(d=1 << 20, n_workers=4, transport="host"), None),
    (dict(loopback_bw=1e12, loopback_rtt=1e-7, codec_rate=1e5),
     dict(d=1 << 20, n_workers=4, transport="host"), None),
    (dict(collective=None),
     dict(d=1 << 20, transport="device", n_shards=4), None),
    (dict(loopback_bw=1e8, loopback_rtt=1e-4, memcpy=1e9),
     dict(d=1 << 20, n_rows=0, n_workers=4, transport="host"), None),
    (dict(collective={"bandwidth_bytes_s": 1e10, "rtt_s": 2e-5,
                      "n_shards": 4}),
     dict(d=1 << 20, transport="device", n_shards=4), None),
    (dict(loopback_bw=1e6, loopback_rtt=1e-4),
     dict(d=1 << 20, n_workers=4, transport="host"), None),
    (dict(loopback_bw=1e6, loopback_rtt=1e-4),
     dict(d=1 << 20, n_workers=4, transport="host"), {"comm": "dense"}),
    (dict(loopback_bw=1e6, loopback_rtt=1e-4),
     dict(d=1 << 20, n_workers=4, transport="host"),
     {"comm": "int8:3:4096", "ps_shards": 5}),
    (dict(loopback_bw=1e8, loopback_rtt=1e-4),
     dict(d=1 << 20, n_workers=4, transport="host"), {"comm": "int8"}),
    (dict(memcpy=4e9),
     dict(d=31, n_rows=569, family="data", transport="device",
          n_shards=2), None),
    (dict(ram=None), dict(d=1 << 28, n_workers=4, transport="host"), None),
    (dict(ram=1 << 30), dict(d=1 << 26, n_workers=4, transport="host"),
     None),
]


def _choices(res) -> list:
    return [(k, c.knob, c.value, c.source, c.why)
            for k, c in res.choices.items()]


@pytest.mark.parametrize("over,wl,explicit", CASES)
def test_resolution_equals_jaxs(over, wl, explicit):
    """Every knob's value, source and WHY, the predicted seconds of each
    candidate, the counts and the comm string are JAX's."""
    mine = ttune.resolve(_crafted(**over, mod=ttune), ttune.Workload(**wl),
                         explicit=explicit)
    theirs = jtune.resolve(_crafted(**over, mod=jtune),
                           jtune.Workload(**wl), explicit=explicit)
    assert _choices(mine) == _choices(theirs)
    assert mine.predicted == theirs.predicted
    assert (mine.profile_id, mine.rig) == (theirs.profile_id, theirs.rig)
    assert mine.counts() == theirs.counts()
    assert mine.comm_string() == theirs.comm_string()
    assert mine.predicted_sync_ms() == theirs.predicted_sync_ms()
    assert tuple(mine.choices) == ttune.KNOBS == jtune.KNOBS


def test_each_knob_pinned_to_its_closed_form():
    """JAX ``test_each_knob_pinned_to_closed_form``'s optima, and the
    honesty rule's WHY on a device transport with no collective."""
    res = ttune.resolve(
        _crafted(loopback_bw=1e8, loopback_rtt=1e-4, memcpy=1e9),
        ttune.Workload(d=1 << 20, n_rows=0, n_workers=4, transport="host"))
    assert (res.value("bucket_elems"), res.value("ps_shards"),
            res.value("ps_mode"), res.value("block_rows"),
            res.value("block_edges"), res.value("mesh_shape")) == (
        8192, 8, "replicated", 256, 1 << 18, None)
    assert res.source("mesh_shape") == "default"
    dev = ttune.resolve(_crafted(), ttune.Workload(
        d=1 << 20, transport="device", n_shards=4))
    assert dev.value("comm") == "dense" and dev.source("comm") == "resolved"
    assert "no measured device interconnect" in dev.choices["comm"].why
    big = ttune.resolve(_crafted(ram=1 << 30), ttune.Workload(
        d=1 << 26, n_workers=4, transport="host"))
    assert big.value("ps_mode") == "rowstore"


def test_emit_resolution_matches_jaxs_events(tmp_path):
    """The ``tune.*`` counters and gauges and one ``tune_knob`` event a
    knob, as the JAX package emits them."""
    from tpu_distalg.telemetry import events as jevents
    from tpu_distalg_torch.telemetry import events as tevents

    got = {}
    for name, mod, ev in (("port", ttune, tevents),
                          ("jax", jtune, jevents)):
        d = tmp_path / name
        ev.configure(str(d))
        try:
            mod.emit_resolution(mod.resolve(
                _crafted(loopback_bw=1e6, loopback_rtt=1e-4, mod=mod),
                mod.Workload(d=1 << 20, n_workers=4, transport="host"),
                explicit={"ps_shards": 3}))
        finally:
            ev.configure(False)
        rows = []
        for f in sorted(os.listdir(d)):
            rows += [json.loads(x) for x in open(d / f) if x.strip()]
        got[name] = [{k: v for k, v in r.items() if k in (
            "ev", "name", "value", "rig", "knob", "source", "why",
            "counters")}
                     for r in rows if r.get("ev") in (
                         "tune_knob", "gauge", "counters")]
    assert got["port"] == got["jax"] and got["port"]


# ------------------------------------------------------ the command line

def test_tda_tune_writes_a_profile_jax_loads(tmp_path, capsys):
    rc = cli.main(["--device", "cpu", "tune", "--quick",
                   "--no-backend-init", "--out-dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "tune: rig=" in out and "backend=cpu" in out
    prof, path = ttune.newest_profile(str(tmp_path),
                                      rig=socket.gethostname())
    assert prof["backend"] == "cpu"
    assert jtune.load_profile(path) == prof
    m = prof["measurements"]
    assert m["loopback"]["bandwidth_bytes_s"] > 0 and \
        m["loopback"]["rtt_s"] > 0
    assert m["memcpy_bytes_s"] > 0 and m["matmul_flops_s"] > 0
    assert set(m["codecs"]) == {"dense", "int8", "topk"}
    assert m["backend_init_s"] is None and m["collective"] is None


def test_tda_tune_on_a_missing_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["tune", "--quick", "--out-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def _final_w(out: str) -> list:
    line = [x for x in out.splitlines() if x.startswith("Final w: ")][-1]
    return json.loads(line[len("Final w: "):])


def test_ssgd_tune_equals_its_knobs_spelled_out(tmp_path, capsys):
    """``ssgd --tune PROFILE`` on a profile with a 4-shard collective
    resolves ``--mesh-shape 4x1`` and ``--comm dense``; its weights are
    bitwise a run with those knobs on the command line, and the WHYs
    are printed."""
    prof = _crafted(collective={"bandwidth_bytes_s": 1e10, "rtt_s": 2e-5,
                                "n_shards": 4})
    path = ttune.save_profile(prof, str(tmp_path))
    base = ["--device", "cpu", "ssgd", "--n-iterations", "5"]
    assert cli.main(base + ["--tune", path]) == 0
    out = capsys.readouterr()
    assert "tune[mesh_shape]: 4x1 (resolved)" in out.err
    assert "tune[comm]: dense (resolved)" in out.err
    assert cli.main(base + ["--mesh-shape", "4x1", "--comm", "dense"]) == 0
    spelled = capsys.readouterr().out
    assert _final_w(out.out) == _final_w(spelled)
    # a spelled-out flag wins over the resolved value
    assert cli.main(base + ["--tune", path, "--mesh-shape", "2x1"]) == 0
    assert "tune[mesh_shape]: 2x1 (explicit)" in capsys.readouterr().err


def test_tune_auto_without_a_profile_keeps_the_defaults(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(ttune.profile.PROFILE_DIR_ENV, str(tmp_path))
    assert cli.main(["--device", "cpu", "ssgd", "--n-iterations", "3",
                     "--tune", "auto"]) == 0
    assert "table defaults stand" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="--tune: unreadable"):
        cli.main(["--device", "cpu", "ssgd", "--tune",
                  str(tmp_path / "missing.json")])


def test_tune_auto_logs_whys_and_report_renders_them(
        tmp_path, monkeypatch, capsys):
    """JAX ``test_tune_auto_ssgd_e2e``: ``--tune auto`` resolves from the
    newest profile of this rig, and ``tda report`` renders the tune
    line from the ``tune.*`` counters."""
    from tpu_distalg_torch.telemetry import events

    pdir = tmp_path / "profiles"
    ttune.save_profile(ttune.build_profile(
        _crafted()["measurements"], created_unix=1.0, seed=0,
        backend="cpu"), str(pdir))
    monkeypatch.setenv(ttune.profile.PROFILE_DIR_ENV, str(pdir))
    tdir = tmp_path / "tel"
    assert cli.main(["--device", "cpu", "ssgd", "--n-slices", "2",
                     "--n-iterations", "3", "--tune", "auto",
                     "--telemetry-dir", str(tdir)]) == 0
    assert "tune[comm]:" in capsys.readouterr().err
    events.configure(False)
    assert cli.main(["report", str(tdir)]) == 0
    out = capsys.readouterr().out
    assert "tune: profile" in out and "resolved" in out


def test_cluster_tune_auto_keeps_a_spelled_flag(tmp_path, monkeypatch,
                                                capsys):
    """JAX ``test_tune_auto_cluster_explicit_flag_wins``: a spelled
    ``--comm`` survives ``--tune auto`` and the run completes."""
    pdir = tmp_path / "profiles"
    ttune.save_profile(ttune.build_profile(
        _crafted()["measurements"], created_unix=1.0, seed=0,
        backend="cpu"), str(pdir))
    monkeypatch.setenv(ttune.profile.PROFILE_DIR_ENV, str(pdir))
    rc = cli.main(["--device", "cpu", "cluster", "--role", "local",
                   "--workers", "1", "--spawn", "thread", "--n-windows",
                   "4", "--n-rows", "512", "--comm", "int8", "--tune",
                   "auto"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "tune[comm]: int8 (explicit)" in err
    assert "tune[ps_shards]:" in err


def test_tuned_cluster_run_is_bitwise_deterministic():
    """Tuning changes geometry, never determinism: the same resolved
    geometry run twice gives a bitwise-equal center."""
    from tpu_distalg_torch import cluster as clus

    prof = _crafted()
    task = clus.TrainTask(n_rows=512, test_rows=256)
    res = ttune.resolve(prof, ttune.Workload(
        d=task.n_features + 1, n_rows=task.n_rows, n_workers=2,
        transport="host"))
    kw = {}
    if res.source("comm") == "resolved":
        kw["comm"] = res.comm_string()
    for knob in ("ps_shards", "ps_mode", "pull_refresh_windows"):
        if res.source(knob) == "resolved":
            kw[knob] = res.value(knob)
    assert kw
    cfg = clus.ClusterConfig(
        n_slots=2, n_windows=4, staleness=2, heartbeat_timeout=10.0,
        train=task, tune_profile=prof["profile_id"], **kw)
    a = clus.run_local_cluster(copy.deepcopy(cfg), spawn="thread",
                               timeout=60.0, device="cpu")
    b = clus.run_local_cluster(copy.deepcopy(cfg), spawn="thread",
                               timeout=60.0, device="cpu")
    assert a["version"] == b["version"] == 4
    assert np.asarray(a["center"]["w"]).tobytes() == \
        np.asarray(b["center"]["w"]).tobytes()
