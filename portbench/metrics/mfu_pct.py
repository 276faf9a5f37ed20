"""The whole call's share of the card's peak, in %: the operations of the
calls in the traced window (``counts/<config>.py:step_flops``, from each
call's rows) over the window's seconds, against the peak of the precision
the configuration states for the entry (``yardstick.py``)."""

from portbench.yardstick import PEAK_FLOPS, precision


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    flops = [ctx.counts.step_flops(ctx.cfg, ctx.path, lengths) for *_, lengths in ctx.calls]
    if None in flops:
        return None
    return 100.0 * sum(flops) / ctx.trace.window_s / PEAK_FLOPS[precision(ctx)]
