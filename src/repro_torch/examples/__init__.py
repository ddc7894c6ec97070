"""Runnable examples (``python -m repro_torch.examples.<name>``)."""
