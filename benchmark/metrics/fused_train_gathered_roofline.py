"""B2's share of its roofline: the least time for the steps it ran in
the traced slice (counts/lr.py) over its device time in the trace,
summed over its two bodies by kernel name."""

from counts import lr

KERNELS = ("train_ring_kernel", "train_wide_kernel")


def read(ctx):
    b = lr.window_bound_s(ctx)
    if ctx["trace"] is None or b is None:
        return None
    t = ctx["trace"].device_time(*KERNELS)
    return 100.0 * b / t if t > 0 else None
