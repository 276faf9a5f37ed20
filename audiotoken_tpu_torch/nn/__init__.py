"""Models as PyTorch modules: the SEANet encoder and the residual VQ."""
