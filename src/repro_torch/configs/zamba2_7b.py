"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks
[arXiv:2411.15242; unverified]."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_head=112, d_ff=14336, vocab=32000,
    norm="rms", mlp="swiglu", pos="rope", rope_theta=10000.0,
    ssm=SSMConfig(state=64, head_dim=64, n_groups=1, conv_kernel=4,
                  # NOTE (§Perf zamba2 iter, refuted): chunk 128 + bf16 SSD
                  # intermediates left the memory term unchanged (12.9s) and
                  # nudged collectives up — the cell is bound by projection /
                  # shared-attention activation traffic, not SSD internals.
                  expand=2, chunk=256),
    attn_every=6,
)
