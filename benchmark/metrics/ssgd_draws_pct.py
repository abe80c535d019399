"""Share of the traced slice the card spent in SSGD's block draws: the
device seconds of the program's ``ssgd.draws`` spans (each timed on the
card at its edges: its kernels and the idle it left between them) over
the slice. None where the program records no such span."""

from tpu_distalg_torch.telemetry import events

SPAN = "ssgd.draws"


def read(ctx):
    tr, recorded = ctx["trace"], getattr(events, "recorded", None)
    if tr is None or recorded is None:
        return None
    secs = [s.device_s for s in recorded(SPAN)]
    if not secs or None in secs:
        return None
    return 100.0 * sum(secs) / tr.window_s
