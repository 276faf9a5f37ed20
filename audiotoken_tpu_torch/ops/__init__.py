"""Device ops: EnCodec-padded convolution, plain attention and the padding
bias, the nearest-centroid lookup, and the hand-written kernels (K1
``seanet_front``, K2 ``lstm``, K3 ``rvq``, K4 and K5 ``flash_attention``,
K6 ``decode_attention``, K7 ``decode_step``, K8 ``attn_ablation``, and
``elu_pad`` and the 3xTF32 GEMM ``linear``, which replace no TPU kernel),
each beside its plain PyTorch version."""
