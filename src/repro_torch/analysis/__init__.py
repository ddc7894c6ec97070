"""repro_torch.analysis — the shared-memory footprint formula."""
