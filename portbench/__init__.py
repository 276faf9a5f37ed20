"""The benchmark of the PyTorch and CUDA port, ``audiotoken_tpu_torch``
(``run.py``; the layout is set out in ``harness.py``)."""
