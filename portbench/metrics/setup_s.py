"""Seconds from the process's start to the end of warm-up: imports, the
program's construction and weights, the traffic, and the warm-up calls
(with the kernels' build in a checkout's first run)."""


def read(ctx):
    return ctx.setup_s
