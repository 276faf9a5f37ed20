"""Device ms a call in memory copies and sets (CUPTI's Memcpy and Memset
events): the host-device copies of the encoders' and decoders' inputs and
answers, and the copies inside the device."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.calls:
        return None
    return 1e3 * ctx.trace.copy_s() / ctx.trace.calls
