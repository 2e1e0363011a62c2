"""Command-line entry points of the PyTorch port (`python -m
repro_torch.launch.simulate`, `python -m repro_torch.launch.train`)."""
