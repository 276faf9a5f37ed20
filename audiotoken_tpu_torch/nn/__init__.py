"""Models as PyTorch modules: SEANet, the residual VQ, the fbank
front-end, the w2v-BERT conformer, HuBERT, the GPT and Bark-fine."""
