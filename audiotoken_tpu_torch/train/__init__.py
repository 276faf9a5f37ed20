"""Training tools: the semantic quantizers' online training
(``vq_train``, ``cluster_diagnostics``) and the semantic -> acoustic GPT's
trainer (``gpt_train``), counterparts of ``audiotoken_tpu/train``."""
