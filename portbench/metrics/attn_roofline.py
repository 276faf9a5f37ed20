"""Kernel K4's share of its roofline at ``highest``, in %: the least time
the card could take for a call's attention (``counts/<config>.py:
attention``, at the configuration's peak) over the device time a call of
the 3xTF32 kernel of ``csrc/flash_attention.cu``
(``flash_attention_relkey_kernel``). Read only where the program's counter
shows that kernel ran (``flash_attention_relkey.launches``)."""

from portbench.yardstick import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, "attention", "flash_attention_relkey_kernel",
                               "flash_attention_relkey.launches")
