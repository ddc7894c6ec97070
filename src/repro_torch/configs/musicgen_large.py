"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32, full MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].
EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings (4 codebooks summed)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_head=64, d_ff=8192, vocab=2048,
    norm="ln", mlp="gelu", pos="sin", embed_inputs=False,
)
