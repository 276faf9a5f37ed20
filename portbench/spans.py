"""The program's own trace spans (``audiotoken.*``, opened by the port's
``runtime/profiling.py:span`` while a profiler records) against the
device's idle time in a traced window.

Every idle interval of the window (no kernel or copy on the card) is split
exactly among the innermost program spans that cover its parts, on the
thread that drives the window; the part that no program span covers is
the benchmark's own loop (``None``). ``LAUNCH`` spans queue device work:
idle under them is the host not staying ahead of the card. Idle under any
other program span is host work that the card waits for.

Reads only what the harness hands a reader: the window thread's host
ranges (``trace.host``), the device events (``trace.device``), the
window's ends (``t0``, ``t1``) and its calls.
"""

from collections import defaultdict
from types import SimpleNamespace

PREFIX = "audiotoken."
#: the program spans inside which the host queues device work
LAUNCH = frozenset({
    "audiotoken.encode.forward", "audiotoken.decode.forward",
    "audiotoken.decode.ar.prefill", "audiotoken.decode.ar.step", "audiotoken.decode.fine",
})


def idle_intervals(trace):
    """[(start, end)] in ns, in order: the window's stretches with no
    device event."""
    gaps, end = [], trace.t0
    for a, b in sorted((a, b) for _, a, b in trace.device):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if trace.t1 > end:
        gaps.append((end, trace.t1))
    return gaps


def _pieces(trace, spans):
    """The window cut at every span's ends -> [(start, end, name)], each
    piece named after the innermost span that holds it (None where none
    does), in order and covering the window."""
    marks = []
    for i, (a, b, _) in enumerate(spans):
        marks.append((a, 1, -b, i))  # an enclosing span opens before what it holds
        marks.append((b, 0, 0, i))
    marks.sort()
    pieces, active, at = [], [], trace.t0
    for t, opens, _, i in marks:
        if t > at:
            pieces.append((at, t, spans[active[-1]][2] if active else None))
            at = t
        if opens:
            active.append(i)
        else:
            active.remove(i)
    if trace.t1 > at:
        pieces.append((at, trace.t1, None))
    return pieces


def program_spans(trace):
    """None where the window holds no program span, or where a program
    span's name reached the device events (the GPU side of a user
    annotation the trace did not drop, which would count as busy time),
    else a namespace of ``idle`` ({innermost span name, or None: idle
    seconds}, summing to the window's idle time). Kept on the trace, so
    each reader reads it once."""
    cached = getattr(trace, "_program_spans", False)
    if cached is not False:
        return cached
    t0, t1 = trace.t0, trace.t1
    spans = [(max(a, t0), min(b, t1), n) for a, b, n in trace.host
             if n.startswith(PREFIX) and b > t0 and a < t1]
    out = None
    if spans and not any(n.startswith(PREFIX) for n, _, _ in trace.device):
        idle, pieces, j = defaultdict(int), _pieces(trace, spans), 0
        for g0, g1 in idle_intervals(trace):
            while pieces[j][1] <= g0:
                j += 1
            k = j
            while k < len(pieces) and pieces[k][0] < g1:
                s, e, n = pieces[k]
                idle[n] += min(e, g1) - max(s, g0)
                k += 1
        out = SimpleNamespace(idle={n: t / 1e9 for n, t in idle.items()})
    trace._program_spans = out
    return out


def gap_ms(ctx, launch: bool):
    """Device idle ms a call under the innermost program spans of the
    cell's entry (``audiotoken.<path>`` and the spans it holds) that queue
    device work (``launch``) or that do not; None without a trace or
    without program spans."""
    if ctx.trace is None or not ctx.trace.calls:
        return None
    spans = program_spans(ctx.trace)
    if spans is None:
        return None
    root = PREFIX + ctx.path
    s = sum(t for n, t in spans.idle.items()
            if n is not None and (n == root or n.startswith(root + ".")) and (n in LAUNCH) == launch)
    return 1e3 * s / ctx.trace.calls
