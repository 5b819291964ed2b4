"""Command-line entry points of the port (``python -m
mgnet_tpu_torch.tools.<name>``)."""
