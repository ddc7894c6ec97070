"""repro_torch.configs — the LM architecture configs (pure data, copied
from ``repro.configs``)."""
