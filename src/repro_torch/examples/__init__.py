"""Runnable end-to-end examples of the port (``python -m repro_torch.examples.<name>``)."""
