"""Rows whose gradient entered an update, over every step of every
replica in the window, per second of the window (host clock; the window
ends in a synchronize)."""


def read(ctx):
    w = ctx["window"]
    if ctx["trace"] is not None or not w["rows"]:
        return None
    return w["rows"] / w["seconds"]
