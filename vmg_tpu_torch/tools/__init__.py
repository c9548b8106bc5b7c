"""Command-line tools of the port (``python -m vmg_tpu_torch.tools.<name>``)."""
