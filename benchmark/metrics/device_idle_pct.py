"""Share of the traced slice in which no device operation ran: one minus
the union of the device's busy intervals over the slice."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
