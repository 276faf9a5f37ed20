"""Device ops: EnCodec-padded convolution and the hand-written kernels
(K1 ``seanet_front``, K2 ``lstm``, K3 ``rvq``), each beside its plain
PyTorch version."""
