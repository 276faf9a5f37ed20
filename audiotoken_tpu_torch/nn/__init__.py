"""Models as PyTorch modules: the SEANet encoder, the residual VQ, the
fbank front-end and the w2v-BERT conformer."""
