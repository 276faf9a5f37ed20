"""Audio seconds of waveform returned by every call of the window over the
window's wall time (host clock), in decode cells."""


def read(ctx):
    if ctx.path != "decode" or not ctx.calls:
        return None
    return sum(c[2] for c in ctx.calls) / ctx.window_s
