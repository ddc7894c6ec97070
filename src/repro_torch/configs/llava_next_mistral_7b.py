"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].
Modality frontend (anyres vision tower) is a STUB: input_specs() provides
precomputed patch embeddings (see DESIGN.md §Arch-applicability)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_head=128, d_ff=14336, vocab=32000,
    norm="rms", mlp="swiglu", pos="rope", rope_theta=1000000.0,
    embed_inputs=False,
)
