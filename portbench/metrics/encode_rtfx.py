"""Audio seconds of every call completed in the window over the window's
wall time (host clock), in encode cells."""


def read(ctx):
    if ctx.path != "encode" or not ctx.calls:
        return None
    return sum(c[2] for c in ctx.calls) / ctx.window_s
