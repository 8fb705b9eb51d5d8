"""models of the PyTorch port (mirrors ``repro.models``)."""
