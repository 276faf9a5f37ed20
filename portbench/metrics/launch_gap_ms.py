"""Device idle ms a call while the innermost program span queues device
work (``encode.forward``; ``decode.forward``, ``decode.ar.prefill``,
``decode.ar.step``, ``decode.fine``): the host not staying ahead of the
card (``portbench/spans.py``)."""

from portbench.spans import gap_ms


def read(ctx):
    return gap_ms(ctx, launch=True)
