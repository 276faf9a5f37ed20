"""TF32 rounding as the port's split-precision kernels do it (K1, K3, K4),
for the tests that emulate those kernels on the CPU."""

import numpy as np


def tf32(x):
    """x (f32) rounded to TF32, 10 mantissa bits, to nearest with ties away
    from zero: what cvt.rna.tf32.f32 gives, and the kernels' integer form of
    it (csrc/rvq.cu, csrc/seanet_front.cu)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
