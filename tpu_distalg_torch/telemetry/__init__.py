"""Runtime telemetry and supervision (port of the JAX package's
``telemetry/``): structured JSONL events (:mod:`events`), a liveness
heartbeat with stall detection (:mod:`heartbeat`), supervised execution
and backend init (:mod:`supervisor`), and log summaries
(:mod:`report`, ``tda report <dir>``). Imports torch only where a
function needs it, so the CLI configures telemetry before the card is
touched."""

from tpu_distalg_torch.telemetry import events, heartbeat, report, supervisor
from tpu_distalg_torch.telemetry.events import (
    configure,
    counter,
    emit,
    enabled,
    gauge,
    get_sink,
    last_mark,
    mark,
    recorded,
    recording,
    span,
)
from tpu_distalg_torch.telemetry.heartbeat import Heartbeat, start_heartbeat
from tpu_distalg_torch.telemetry.supervisor import (
    BackendUnavailableError,
    init_backend,
    supervised,
)

__all__ = [
    "BackendUnavailableError", "Heartbeat", "configure", "counter", "emit",
    "enabled", "events", "gauge", "get_sink", "heartbeat", "init_backend",
    "last_mark", "mark", "recorded", "recording", "report", "span",
    "start_heartbeat", "supervised", "supervisor",
]
