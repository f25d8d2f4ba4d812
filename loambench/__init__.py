"""loambench: the benchmark of the PyTorch and CUDA port (``loam_tpu_torch``)."""
