"""Command-line entry points of the port (``python -m academicodec_tpu_torch.cli.<name>``)."""
