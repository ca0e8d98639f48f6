"""Entry points a user runs: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``."""
