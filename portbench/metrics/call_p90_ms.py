"""The 90th percentile of the host-clock time of every call of the window,
issue to answer on the host, in ms (Python's ``statistics.quantiles``)."""

from portbench.yardstick import quantile


def read(ctx):
    if not ctx.calls:
        return None
    return 1e3 * quantile([t1 - t0 for t0, t1, *_ in ctx.calls], 9, 10)
