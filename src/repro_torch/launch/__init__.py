"""Entry points a user runs: ``python -m repro_torch.launch.serve``."""
