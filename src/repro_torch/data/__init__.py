"""repro_torch.data — deterministic synthetic data."""
