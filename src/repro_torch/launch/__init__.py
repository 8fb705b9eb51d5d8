"""launch of the PyTorch port (mirrors ``repro.launch``)."""
