"""kernels of the PyTorch port (mirrors ``repro.kernels``)."""
