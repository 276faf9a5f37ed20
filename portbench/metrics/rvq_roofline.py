"""Kernel K3's share of its roofline, in %: the least time the card could
take for a call's residual VQ (``counts/<config>.py:rvq``, at the
configuration's peak) over K3's device time (``rvq_encode_kernel``,
``csrc/rvq.cu``). Read only where the program's counter shows K3 ran
(``rvq_encode.launches``)."""

from portbench.yardstick import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, "rvq", "rvq_encode_kernel", "rvq_encode.launches")
