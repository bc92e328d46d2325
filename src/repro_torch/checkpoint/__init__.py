"""Failure handling of the PyTorch port (straggler detection)."""
