"""Launch entry points of the port: ``python -m
repro_torch.launch.multihost`` trains one job over N processes."""
