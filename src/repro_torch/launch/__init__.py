"""Command-line launchers of the PyTorch port: thin adapters over
``repro_torch.api`` (``python -m repro_torch.launch.train`` /
``python -m repro_torch.launch.serve``)."""
