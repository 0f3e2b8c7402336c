"""Command-line instruments of the port (``python -m
spearmint_tpu_torch.tools.<name>``)."""
