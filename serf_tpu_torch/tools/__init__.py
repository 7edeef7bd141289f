"""The port's command lines (``python -m serf_tpu_torch.tools.<name>``)."""
