"""Kernel K2's share of its roofline, in %: the least time the card could
take for the LSTM recurrences of a call (``counts/<config>.py:lstm``, at
the configuration's peak) over K2's device time a call
(``lstm_persistent_kernel``). Read only where the program's counter shows
K2 ran (``lstm_layer.launches``)."""

from portbench.yardstick import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, "lstm", "lstm_persistent_kernel", "lstm_layer.launches")
