"""The whole step's share of the card's peak: the least time the card
could take for the traced slice's steps (counts/lr.py, from the
configuration's logical shapes) over the slice's wall time."""

from counts import lr


def read(ctx):
    b = lr.window_bound_s(ctx)
    if ctx["trace"] is None or b is None:
        return None
    return 100.0 * b / ctx["window"]["seconds"]
