"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, d_head=128, d_ff=53248, vocab=128256,
    norm="rms", mlp="swiglu", pos="rope", rope_theta=500000.0,
    # NOTE (§Perf iter 5, refuted): remat_policy="dots_with_no_batch_dims_
    # saveable" removes the recompute pass (collective 137->130s, useful
    # ratio 0.77->0.95) but the saved MLP hiddens cost 65 GB/chip temp —
    # over the 16 GB budget.  Full recompute stays.
)
