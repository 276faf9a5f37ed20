"""The device's idle share of the traced window, in %: 100 (1 - busy /
window), busy the union of every kernel's and copy's span (CUPTI)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
