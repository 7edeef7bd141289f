"""The port's examples (``python -m serf_tpu_torch.examples.<name>``)."""
