"""Optimizers of the PyTorch port (fp32 state over fp32 master weights)."""
