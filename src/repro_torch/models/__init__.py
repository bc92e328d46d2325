"""Model substrate of the PyTorch port (dense family so far)."""
