"""Host waits on the card per SSGD call: the host events of the traced
slice that block until the device is done (the synchronize calls and
the synchronous copy) that lie inside one of the program's ``ssgd.call``
spans, over the number of those spans. None without device operations
or without the spans."""

CALL = "ssgd.call"
WAITS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device_ops:
        return None
    calls = [(a, b) for a, b, n in tr.host if n == CALL]
    if not calls:
        return None
    waits = [a for a, _, n in tr.host if n in WAITS]
    inside = sum(1 for t in waits if any(a <= t <= b for a, b in calls))
    return inside / len(calls)
