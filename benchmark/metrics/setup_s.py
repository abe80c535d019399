"""Seconds from the start of the process's harness to the window:
imports, data, packing, the kernels' build or load, the first steps."""


def read(ctx):
    return ctx["setup_s"]
