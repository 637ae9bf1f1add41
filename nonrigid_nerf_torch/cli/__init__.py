"""Command-line entry points of the port (`python3 -m
nonrigid_nerf_torch.cli.train --config <file>`)."""
