"""Command-line entry points of the port, run as `python -m svgf_tpu_torch.scripts.<name>`."""
