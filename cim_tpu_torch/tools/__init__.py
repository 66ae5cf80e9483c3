"""Command-line entry points of the port (``python -m cim_tpu_torch.tools.<name>``)."""
