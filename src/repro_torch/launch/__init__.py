"""Launch entry points of the port: ``python -m
repro_torch.launch.multihost`` trains one job over N processes; ``python
-m repro_torch.launch.dryrun`` (with ``sweep_opt`` and ``report``) runs
the LM's per-rank program on the production meshes without a card."""
