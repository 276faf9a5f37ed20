"""Device ops: EnCodec-padded convolution, the padding bias, the
nearest-centroid lookup, and the hand-written kernels (K1 ``seanet_front``,
K2 ``lstm``, K3 ``rvq``, K4 ``flash_attention``), each beside its plain
PyTorch version."""
