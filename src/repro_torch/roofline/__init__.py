"""roofline of the PyTorch port (mirrors ``repro.roofline``)."""
