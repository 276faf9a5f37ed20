"""The window attention kernel's share of its roofline, in %: the least
time the card could take for a call's windowed attention
(``counts/<config>.py:window_attention``, at the configuration's peak) over
the device time of ``flash_attention_window_kernel`` (``csrc/flash_
attention.cu``). Read only where the program's counter shows that kernel
ran (``flash_attention_window.launches``)."""

from portbench.yardstick import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, "window_attention", "flash_attention_window_kernel",
                               "flash_attention_window.launches")
