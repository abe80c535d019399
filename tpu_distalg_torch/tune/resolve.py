"""The planning half of the autotuner: cost model and geometry resolver
(port of ``tpu_distalg/tune/resolve.py``, choice for choice).

With the platform measured (:mod:`.profile`), the layout and schedule
are planned from a cost model: the closed-form per-sync accounting
(``comms.schedule_stats``) priced against one rig's measured numbers:
per-sync seconds = ``bytes_wire / wire_bandwidth + rounds · rtt +
codec_elems / codec_throughput``.

The resolver answers one question per knob — comm schedule, bucket
elems, mesh shape, ps-shards/ps-mode, block-rows/block-edges,
pull-refresh cadence — and records WHY for each, so a ``tda report``
reader can audit the choice against the profile it came from. Three
sources, strict precedence:

* ``explicit`` — the user spelled the flag; the resolver never
  overrides it (recorded, not recomputed);
* ``resolved`` — chosen from profile measurements (possibly the default
  VALUE, for a measured reason);
* ``default`` — no profile signal bears on the knob; the
  ``tune/defaults.py`` table value stands.

On one host with no measured device collective the "wire" is shared
memory: compressed device schedules have nothing to compress away, so
the resolver keeps ``dense``. Tuning changes geometry, never
determinism: nothing here touches seeds or reduction order.

Plain Python and numpy, as the JAX package's is: the cluster
coordinator resolves geometry without a device.
"""

from __future__ import annotations

import dataclasses
import math

from tpu_distalg_torch.parallel import comms as pcomms
from tpu_distalg_torch.parallel.partition import row_block_stats
from tpu_distalg_torch.tune import defaults as tdefaults

#: resolver knob order (stable for telemetry and report rendering)
KNOBS = ("comm", "bucket_elems", "mesh_shape", "ps_shards",
         "ps_mode", "block_rows", "block_edges",
         "pull_refresh_windows")

#: candidate schedules per transport: the cluster's host wire frames
#: only the host codecs; a measured device interconnect admits the
#: full device schedule set
HOST_CANDIDATES = ("dense", "int8", "topk")
DEVICE_CANDIDATES = ("dense", "bf16", "int8", "topk")

#: per-bucket latency amortization: bucket transfer time should dwarf
#: its round latency by this factor before latency stops mattering
_BUCKET_LATENCY_FACTOR = 4.0

#: out-of-core block transfer target (seconds) — blocks sized so each
#:  gather costs ~this much wire time (small enough to overlap, big
#:  enough to amortize per-block overhead)
_BLOCK_TARGET_SECONDS = 2e-3

#: dense pull-refresh amortization target: refresh bytes per window
#: stay under this fraction of the compressed per-window pull bytes
_REFRESH_OVERHEAD = 0.25


@dataclasses.dataclass
class Workload:
    """What the resolver needs to know about the run being planned."""

    d: int                                   # model/gradient elems
    n_rows: int = 0                          # dataset rows (0 = n/a)
    n_workers: int = tdefaults.CLUSTER_SLOTS
    family: str = "data"                     # BLOCK_ROWS family key
    transport: str = "device"                # "device" | "host"
    n_shards: int | None = None              # device data-axis size

    @property
    def model_bytes(self) -> int:
        return 4 * max(1, self.d)

    @property
    def sync_shards(self) -> int:
        """Participants in one sync round: mesh shards on the device
        transport, cluster workers on the host wire."""
        if self.transport == "host":
            return max(1, self.n_workers)
        return max(1, self.n_shards or 1)


@dataclasses.dataclass
class Choice:
    knob: str
    value: object
    source: str       # "explicit" | "resolved" | "default"
    why: str


@dataclasses.dataclass
class Resolution:
    """Every knob's choice plus the cost-model evidence."""

    profile_id: str
    rig: str
    choices: dict
    predicted: dict           # schedule -> predicted per-sync seconds

    def value(self, knob: str):
        return self.choices[knob].value

    def source(self, knob: str) -> str:
        return self.choices[knob].source

    def counts(self) -> dict:
        out = {"resolved": 0, "explicit": 0, "defaulted": 0}
        for c in self.choices.values():
            out["defaulted" if c.source == "default"
                else c.source] += 1
        return out

    def comm_string(self) -> str:
        """The chosen schedule in CLI spelling, with the resolved
        bucket-elems folded into the spec where the grammar allows."""
        sched = str(self.value("comm"))
        if ":" in sched or "@" in sched:
            return sched          # explicit spec string: verbatim
        bucket = self.value("bucket_elems")
        if sched == "int8" and bucket:
            return f"int8:0:{int(bucket)}"
        if sched == "bucketed" and bucket:
            return f"bucketed:{int(bucket)}"
        return sched

    def predicted_sync_ms(self) -> float | None:
        sched = str(self.value("comm")).partition(":")[0] \
            .partition("@")[0]
        t = self.predicted.get(sched)
        return None if t is None else 1e3 * t


# ---------------------------------------------------------------------
# the cost model


def _wire(profile: dict, transport: str):
    """``(bandwidth_bytes_s, rtt_s)`` of the transport's measured
    wire, or ``(None, None)`` when the profile carries no measurement
    for it (device transport with no measured collective)."""
    m = profile.get("measurements", {})
    if transport == "host":
        lb = m.get("loopback") or {}
        return lb.get("bandwidth_bytes_s"), lb.get("rtt_s")
    coll = m.get("collective")
    if coll:
        return coll.get("bandwidth_bytes_s"), coll.get("rtt_s")
    return None, None


def _codec_seconds(profile: dict, schedule: str, elems: int,
                   transport: str) -> float:
    """Host encode+decode seconds for one sync's payload. Device
    schedules quantize on-device inside the collective — their codec
    cost is already inside the measured collective bandwidth — so
    only the host wire pays the host codec rates."""
    if transport != "host" or schedule == "dense":
        return 0.0
    codecs = profile.get("measurements", {}).get("codecs", {})
    rates = codecs.get(schedule)
    if not rates:
        return 0.0
    enc = rates.get("encode_elems_s") or 0.0
    dec = rates.get("decode_elems_s") or 0.0
    t = 0.0
    if enc > 0:
        t += elems / enc
    if dec > 0:
        t += elems / dec
    return t


def schedule_seconds(profile: dict, workload: Workload,
                     schedule: str, *,
                     bucket_elems: int | None = None,
                     topk_fraction: float | None = None
                     ) -> float | None:
    """Predicted per-sync seconds of one schedule on this rig, or
    None when the transport has no measured wire to price against."""
    bw, rtt = _wire(profile, workload.transport)
    if not bw or bw <= 0:
        return None
    rtt = rtt or 0.0
    stats = pcomms.schedule_stats(
        schedule, n_shards=workload.sync_shards,
        compressible_elems=max(1, workload.d),
        bucket_elems=bucket_elems or tdefaults.BUCKET_ELEMS,
        topk_fraction=topk_fraction or tdefaults.TOPK_FRACTION)
    return stats["bytes_wire"] / bw + stats["rounds"] * rtt \
        + _codec_seconds(profile, schedule, workload.d,
                         workload.transport)


def _pow2_clamp(x: float, lo: int, hi: int) -> int:
    """The power of two nearest ``x`` (log-space), clamped."""
    x = max(float(lo), min(float(hi), max(1.0, x)))
    return int(2 ** round(math.log2(x)))


# ---------------------------------------------------------------------
# per-knob choosers (each returns a Choice)


def _choose_comm(profile: dict, workload: Workload) -> tuple:
    """``(Choice, predicted)`` — predicted maps candidate schedule ->
    per-sync seconds (None entries where unmeasurable)."""
    bw, rtt = _wire(profile, workload.transport)
    candidates = HOST_CANDIDATES if workload.transport == "host" \
        else DEVICE_CANDIDATES
    predicted = {s: schedule_seconds(profile, workload, s)
                 for s in candidates}
    if workload.transport == "device" and (not bw or bw <= 0):
        return Choice(
            "comm", "dense", "resolved",
            "no measured device interconnect in the profile: a "
            "single-host mesh moves bytes over shared memory, so "
            "compressed schedules have no wire to compress and "
            "their quantize work is pure overhead"), predicted
    if workload.sync_shards < 2:
        return Choice(
            "comm", "dense", "resolved",
            "one sync participant: nothing crosses a wire"), predicted
    priced = {s: t for s, t in predicted.items() if t is not None}
    if not priced:
        return Choice(
            "comm", str(tdefaults.DEFAULT_GEOMETRY["comm"]),
            "default", "profile prices no candidate schedule on "
            "this transport"), predicted
    best = min(sorted(priced), key=lambda s: priced[s])
    t_dense = priced.get("dense")
    why = (f"cheapest predicted sync on the measured wire "
           f"({bw / 1e6:.0f} MB/s, rtt {1e6 * (rtt or 0):.0f} us): "
           + ", ".join(f"{s}={1e3 * priced[s]:.3f}ms"
                       for s in sorted(priced)))
    if best != "dense" and t_dense is not None:
        why += f"; {t_dense / priced[best]:.1f}x over dense"
    return Choice("comm", best, "resolved", why), predicted


def _choose_bucket_elems(profile: dict, workload: Workload) -> Choice:
    bw, rtt = _wire(profile, workload.transport)
    if not bw or not rtt or bw <= 0 or rtt <= 0:
        return Choice(
            "bucket_elems", tdefaults.BUCKET_ELEMS, "default",
            "no measured wire bandwidth/RTT to amortize against")
    bucket_bytes = _BUCKET_LATENCY_FACTOR * bw * rtt
    elems = _pow2_clamp(bucket_bytes / 4.0, 1 << 12, 1 << 22)
    return Choice(
        "bucket_elems", elems, "resolved",
        f"bucket transfer amortizes {_BUCKET_LATENCY_FACTOR:.0f}x "
        f"the {1e6 * rtt:.0f}us round latency at "
        f"{bw / 1e6:.0f} MB/s -> {elems} f32 elems "
        f"(pow2-clamped)")


def _choose_mesh_shape(profile: dict, workload: Workload) -> Choice:
    coll = profile.get("measurements", {}).get("collective")
    if coll and coll.get("n_shards", 0) >= 2:
        n = int(coll["n_shards"])
        return Choice(
            "mesh_shape", f"{n}x1", "resolved",
            f"measured collective spans {n} devices: all on the "
            f"data axis (no measured model-axis benefit on this "
            f"profile)")
    return Choice(
        "mesh_shape", tdefaults.DEFAULT_GEOMETRY["mesh_shape"],
        "default",
        "no measured device mesh in the profile: pure data-parallel "
        "default stands")


def _choose_ps_shards(profile: dict, workload: Workload) -> Choice:
    bw, rtt = _wire(profile, "host")
    if not bw or not rtt or bw <= 0 or rtt <= 0:
        return Choice("ps_shards", tdefaults.PS_SHARDS, "default",
                      "no measured host wire to size the PS tier "
                      "against")
    # t(s) = model_bytes/(s*bw) + s*rtt is minimized at
    # s* = sqrt(model_bytes/(bw*rtt)): more shards split the push
    # bytes but each adds a round trip
    ideal = math.sqrt(workload.model_bytes / (bw * rtt))
    shards = max(1, min(8, int(round(ideal))))
    return Choice(
        "ps_shards", shards, "resolved",
        f"sqrt(model_bytes/(bw*rtt)) = sqrt({workload.model_bytes}"
        f"/({bw:.3g}*{rtt:.3g})) = {ideal:.1f} balances per-shard "
        f"bytes against per-shard round trips; clamped to [1, 8]")


def _choose_ps_mode(profile: dict, workload: Workload,
                    ps_shards: int) -> Choice:
    ram = profile.get("measurements", {}).get("host_ram_bytes")
    if not ram:
        return Choice("ps_mode", "replicated", "default",
                      "no measured host RAM to bound replication "
                      "against")
    replicated_bytes = workload.model_bytes * max(1, ps_shards)
    if replicated_bytes > ram / 16:
        return Choice(
            "ps_mode", "rowstore", "resolved",
            f"replicating {workload.model_bytes} model bytes across "
            f"{ps_shards} shards costs {replicated_bytes} bytes > "
            f"1/16 of the {ram} measured host RAM: row-partitioned "
            f"state instead")
    return Choice(
        "ps_mode", "replicated", "resolved",
        f"replicated state ({replicated_bytes} bytes across "
        f"{ps_shards} shards) fits well under 1/16 of the {ram} "
        f"measured host RAM; replication keeps pulls local")


def _choose_block_rows(profile: dict, workload: Workload) -> Choice:
    default = tdefaults.BLOCK_ROWS.get(
        workload.family, tdefaults.BLOCK_ROWS["data"])
    bw = profile.get("measurements", {}).get("memcpy_bytes_s")
    if not bw or bw <= 0 or workload.d < 1:
        return Choice("block_rows", default, "default",
                      "no measured host copy bandwidth to size "
                      "blocks against")
    row_bytes = 4 * max(1, workload.d)
    hi = 8192
    if workload.n_rows:
        # never a block bigger than one shard's rows: the pad waste
        # would dominate the transfer the block exists to amortize
        per_shard = -(-workload.n_rows // workload.sync_shards)
        hi = max(256, min(hi, 2 ** math.ceil(math.log2(per_shard))))
    rows = _pow2_clamp(_BLOCK_TARGET_SECONDS * bw / row_bytes,
                       256, hi)
    why = (f"{1e3 * _BLOCK_TARGET_SECONDS:.0f}ms block gathers at "
           f"the measured {bw / 1e9:.1f} GB/s copy bandwidth / "
           f"{row_bytes} B rows -> {rows} rows (pow2-clamped)")
    st = row_block_stats(workload.n_rows or rows, rows,
                         n_shards=workload.sync_shards,
                         row_bytes=row_bytes)
    why += (f"; {st['n_blocks']} blocks, pad waste "
            f"{100.0 * st['waste_fraction']:.1f}%")
    return Choice("block_rows", rows, "resolved", why)


def _choose_block_edges(profile: dict, workload: Workload) -> Choice:
    bw = profile.get("measurements", {}).get("memcpy_bytes_s")
    if not bw or bw <= 0:
        return Choice("block_edges", tdefaults.BLOCK_EDGES, "default",
                      "no measured host copy bandwidth to size edge "
                      "blocks against")
    # 8 B/edge (src, dst int32 pair) at the same block time target
    edges = _pow2_clamp(_BLOCK_TARGET_SECONDS * bw / 8.0,
                        1 << 14, 1 << 21)
    return Choice(
        "block_edges", edges, "resolved",
        f"{1e3 * _BLOCK_TARGET_SECONDS:.0f}ms edge-block streams at "
        f"{bw / 1e9:.1f} GB/s / 8 B edges -> {edges} edges "
        f"(pow2-clamped)")


def _choose_pull_refresh(profile: dict, workload: Workload,
                         comm: str) -> Choice:
    sched = str(comm).partition(":")[0].partition("@")[0]
    if sched == "dense":
        return Choice(
            "pull_refresh_windows", tdefaults.PULL_REFRESH_WINDOWS,
            "default",
            "dense pulls carry full state every window: refresh "
            "cadence has no delta noise to bound")
    # compressed pulls ship ~1 B/elem (the int8 pull codec); a dense
    # version-pinned refresh ships 4 B/elem. Amortize the refresh to
    # <= _REFRESH_OVERHEAD of the compressed per-window bytes.
    compressed_window_bytes = float(max(1, workload.d))
    refresh_bytes = 4.0 * max(1, workload.d)
    windows = int(math.ceil(
        refresh_bytes / (_REFRESH_OVERHEAD * compressed_window_bytes)))
    windows = max(4, min(64, windows))
    return Choice(
        "pull_refresh_windows", windows, "resolved",
        f"dense refresh ({int(refresh_bytes)} B) amortized to "
        f"<= {int(100 * _REFRESH_OVERHEAD)}% of the compressed "
        f"per-window pull ({int(compressed_window_bytes)} B) -> "
        f"every {windows} windows (clamped to [4, 64])")


# ---------------------------------------------------------------------
# the resolver


def resolve(profile: dict, workload: Workload, *,
            explicit: dict | None = None) -> Resolution:
    """Choose every knob. ``explicit`` maps knob name -> the value the
    user spelled on the CLI; explicit flags always win and are
    recorded as such, never recomputed."""
    explicit = dict(explicit or {})
    choices: dict = {}

    def _take(knob: str, chooser, *args):
        if knob in explicit:
            choices[knob] = Choice(
                knob, explicit[knob], "explicit",
                "explicit flag wins: the resolver never overrides "
                "a spelled-out choice")
            return
        choices[knob] = chooser(profile, workload, *args)

    if "comm" in explicit:
        choices["comm"] = Choice(
            "comm", explicit["comm"], "explicit",
            "explicit flag wins: the resolver never overrides a "
            "spelled-out choice")
        _, predicted = _choose_comm(profile, workload)
    else:
        choices["comm"], predicted = _choose_comm(profile, workload)
    _take("bucket_elems", _choose_bucket_elems)
    _take("mesh_shape", _choose_mesh_shape)
    _take("ps_shards", _choose_ps_shards)
    _take("ps_mode", _choose_ps_mode,
          int(choices["ps_shards"].value or tdefaults.PS_SHARDS))
    _take("block_rows", _choose_block_rows)
    _take("block_edges", _choose_block_edges)
    _take("pull_refresh_windows", _choose_pull_refresh,
          choices["comm"].value)
    return Resolution(
        profile_id=str(profile.get("profile_id", "?")),
        rig=str(profile.get("rig", "?")),
        choices=choices, predicted=predicted)


def emit_resolution(resolution: Resolution) -> None:
    """Log the resolution as ``tune.*`` telemetry: one counter per
    source class, the profile-id gauge, the predicted-step gauge, and
    one ``tune_knob`` event per knob carrying the WHY."""
    from tpu_distalg_torch.telemetry import events as tevents

    counts = resolution.counts()
    if counts["resolved"]:
        tevents.counter("tune.knobs_resolved", counts["resolved"])
    if counts["explicit"]:
        tevents.counter("tune.knobs_explicit", counts["explicit"])
    if counts["defaulted"]:
        tevents.counter("tune.knobs_defaulted", counts["defaulted"])
    tevents.gauge("tune.profile", resolution.profile_id,
                  rig=resolution.rig)
    pred = resolution.predicted_sync_ms()
    if pred is not None:
        tevents.gauge("tune.predicted_step_ms", pred)
    for knob in KNOBS:
        c = resolution.choices[knob]
        tevents.emit("tune_knob", knob=c.knob, value=c.value,
                     source=c.source, why=c.why)
