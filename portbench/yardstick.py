"""The yardstick every share is read against: the card's published peaks,
chosen by the precision a configuration states, never by how the program
computes.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W limit. A float32 configuration is held to the TF32 tensor-core rate,
the highest rate the card offers on f32 inputs, so no implementation of an
f32 configuration (IEEE FMAs, one TF32 pass, 3xTF32) can read above 100 %;
a bfloat16 configuration to the bf16 rate. Bytes are held to HBM3's rate.
"""

import statistics

#: peak FLOP/s by the precision a configuration states
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
#: HBM3 bytes/s
PEAK_BYTES = 3.35e12


def min_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations at
    the precision's peak and the bytes at the memory rate."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)


def quantile(values, q: int, n: int):
    """The q-th of the n-quantiles of ``values`` as Python's
    ``statistics.quantiles(values, n=n)`` gives them (the exclusive method);
    the single value where there is one."""
    values = list(values)
    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=n)[q - 1]


def precision(ctx) -> str:
    """The precision the configuration states for the cell's entry."""
    return ctx.cfg.get(f"dtype_{ctx.path}", ctx.cfg["dtype"])


def kernel_roofline_pct(ctx, counts_fn: str, kernel: str, counter: str):
    """A kernel's share of its roofline in a traced run, in %: the least
    time for the work of the window's calls (``ctx.counts.<counts_fn>``,
    from each call's rows -> operations, bytes), at the peak of the
    precision the configuration states for the entry, over the kernel's
    device time in the window. None where the trace, the count or the
    kernel's launches (the program's counter ``counter``) are missing: a
    reader that finds nothing returns nothing."""
    count = getattr(ctx.counts, counts_fn, None)
    if ctx.trace is None or count is None or not ctx.calls or not ctx.launches.get(counter):
        return None
    work = [count(ctx.cfg, ctx.path, lengths) for *_, lengths in ctx.calls]
    if None in work:
        return None
    least = sum(min_seconds(f, b, precision(ctx)) for f, b in work)
    seconds = ctx.trace.kernel_s(lambda name: name == kernel)
    return None if seconds <= 0 else 100.0 * least / seconds
