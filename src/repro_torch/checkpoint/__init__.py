"""Checkpointing, elastic restore and failure handling of the PyTorch
port: atomic async checkpoints, restore at another data-parallel degree,
straggler detection and the supervised recovery loop."""
