"""repro_torch.models — the paper CNNs as convolution scenes."""
