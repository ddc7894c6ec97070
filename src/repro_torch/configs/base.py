"""Architecture config schema (port of ``repro.configs.base``).

Pure data: the dataclasses and ``SHAPES`` are copies of the reference's.
``input_specs`` (JAX ``ShapeDtypeStruct`` stand-ins for the dry-run) waits
for the port of ``launch/``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual_ff: Optional[int] = None  # arctic: parallel dense MLP


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 64          # N (ssm state per head)
    head_dim: int = 64       # P
    n_groups: int = 1        # B/C groups (GQA-like)
    conv_kernel: int = 4
    expand: int = 2
    chunk: int = 256         # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int             # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    norm: str = "rms"        # rms | ln
    mlp: str = "swiglu"      # swiglu | gelu
    pos: str = "rope"        # rope | sin
    rope_theta: float = 500000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    embed_inputs: bool = True       # False: vlm/audio stub provides embeddings
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0      # zamba2: shared attention block cadence (0 = off)
    dtype: str = "bfloat16"
    # activation-checkpoint policy name used by the train step
    remat_policy: str = "nothing_saveable"
    # flash-attention block sizes (0 = unchunked; roofline probes use 0 so
    # cost_analysis sees the loop-free body)
    q_chunk: int = 512
    kv_chunk: int = 1024
    # python-loop over layers instead of lax.scan (roofline probes only:
    # cost_analysis counts while-loop bodies once, unrolled probes count true)
    unroll_layers: bool = False

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def sub_quadratic(self) -> bool:
        """May run long_500k: state-recurrent archs (ssm/hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        n = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":               # rwkv6-style
            att = d * d * 4 + d * d            # r,k,v,g,o (v=d), w lora small
            ffn = d * self.d_ff * 2
            per_layer = att + ffn
        elif self.family == "hybrid":          # mamba2 layers
            di = self.ssm.expand * d
            per_layer = d * (2 * di + 2 * self.ssm.n_groups * self.ssm.state) \
                + d * (di // self.ssm.head_dim) + di * d
            # shared attention block participates once per cadence
        else:
            qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
            o = self.n_heads * self.d_head * d
            att = qkv + o
            if self.moe is not None:
                ff = self.moe.n_experts * d * self.moe.d_ff_expert * 3
                if self.moe.dense_residual_ff:
                    ff += d * self.moe.dense_residual_ff * 3
                ff += d * self.moe.n_experts  # router
            else:
                mult = 3 if self.mlp == "swiglu" else 2
                ff = d * self.d_ff * mult
            per_layer = att + ff
        return n + L * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full_ff = self.moe.n_experts * d * self.moe.d_ff_expert * 3
        act_ff = self.moe.top_k * d * self.moe.d_ff_expert * 3
        return self.param_count() - L * (full_ff - act_ff)


# ---------------------------------------------------------------------------
# Input shapes (assigned): train_4k / prefill_32k / decode_32k / long_500k
# ---------------------------------------------------------------------------
SHAPES: Dict[str, Dict] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

