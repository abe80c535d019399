"""Seconds of the benchmark's ``prepare`` span around the program's
packing call (``prepare_fused``: ``pack_augmented`` and the copy to the
card)."""


def read(ctx):
    return ctx["spans"].get("prepare")
