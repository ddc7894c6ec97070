"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2 [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_head=128, d_ff=32768, vocab=131072,
    norm="rms", mlp="gelu", pos="rope", rope_theta=10000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
)
