"""Command-line entry points of the port (``python -m
nmma_tpu_torch.cli.lightcurve_analysis config.yaml``)."""
