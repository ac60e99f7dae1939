"""The benchmark of the PyTorch and CUDA port of DiffSim (``diffsim_tpu_torch``)."""
