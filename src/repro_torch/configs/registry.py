"""Registry: --arch <id> -> ArchConfig, plus reduced smoke variants (port
of ``repro.configs.registry``; the same ids, aliases and reductions)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig

ARCH_IDS = (
    "llama3_405b", "qwen3_14b", "qwen1p5_110b", "qwen2p5_3b", "zamba2_7b",
    "llava_next_mistral_7b", "musicgen_large", "arctic_480b", "grok1_314b",
    "rwkv6_3b",
)

# canonical ids as assigned (dashes/dots) -> module names
ALIASES = {
    "llama3-405b": "llama3_405b",
    "qwen3-14b": "qwen3_14b",
    "qwen1.5-110b": "qwen1p5_110b",
    "qwen2.5-3b": "qwen2p5_3b",
    "zamba2-7b": "zamba2_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "musicgen-large": "musicgen_large",
    "arctic-480b": "arctic_480b",
    "grok-1-314b": "grok1_314b",
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(arch: str) -> ArchConfig:
    name = ALIASES.get(arch, arch)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced(cfg: ArchConfig, *, layers: int = 2) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke", n_layers=layers,
        d_model=128,
        n_heads=0 if cfg.attention_free else 4,
        n_kv_heads=0 if cfg.attention_free else max(1, min(cfg.n_kv_heads, 2)),
        d_head=32, d_ff=256, vocab=512, dtype="float32",
        remat_policy="none",
    )
    if cfg.moe is not None:
        n_e = min(cfg.moe.n_experts, 8)
        # drop-free capacity at any token count -> deterministic smoke tests
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=n_e, d_ff_expert=64,
            capacity_factor=n_e / cfg.moe.top_k,
            dense_residual_ff=64 if cfg.moe.dense_residual_ff else None)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state=16, head_dim=32,
                                        chunk=16)
    if cfg.family == "hybrid":
        kw["n_layers"] = 5        # 2 groups of 2 + 1 tail layer
        kw["attn_every"] = 2
    if cfg.family == "ssm":
        kw["d_model"] = 128       # 2 rwkv heads of 64
        kw["d_head"] = 64
    return dataclasses.replace(cfg, **kw)
