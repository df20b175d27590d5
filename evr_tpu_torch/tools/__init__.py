"""Command-line tools of the port (``python -m evr_tpu_torch.tools.<name>``)."""
