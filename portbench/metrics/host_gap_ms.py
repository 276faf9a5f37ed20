"""Device idle ms a call while the host is inside the entry's program span
(``audiotoken.encode`` or ``audiotoken.decode``) but not inside a span that
queues device work: the prepare, upload and download steps, the AR
readbacks, the hand-offs between stages and the glue between them
(``portbench/spans.py``)."""

from portbench.spans import gap_ms


def read(ctx):
    return gap_ms(ctx, launch=False)
