"""repro_torch.core — the convolution scene and the multi-grained selector."""
