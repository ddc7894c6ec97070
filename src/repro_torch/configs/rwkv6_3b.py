"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
    n_heads=0, n_kv_heads=0, d_head=64, d_ff=8960, vocab=65536,
    norm="ln", mlp="swiglu", pos="rope",
)
