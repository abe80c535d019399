"""Device operations (kernels, copies, fills) in the traced slice per
round of the local-update trainer."""


def read(ctx):
    tr, w = ctx["trace"], ctx["window"]
    if tr is None or not w["rounds"] or not tr.device_ops:
        return None
    return len(tr.device_ops) / w["rounds"]
