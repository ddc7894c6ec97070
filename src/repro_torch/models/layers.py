"""Shared model layers: norms, RoPE, MLPs, GQA attention (prefill path
through the flash-attention kernel, decode path over a KV cache).

Port of ``repro.models.layers``: pure functions over parameter mappings (a
dict or an ``nn.ParameterDict``), the same names, layouts and rounding
points.  Differences from the reference:

  * ``flash_attention`` keeps the reference's signature and its chunk
    divisibility check, but computes through ``FlashAttention``
    (``kernels.flash_attention``): forward the CUDA kernel on a card
    tensor, its plain version on a CPU one — one function on both
    devices, with the softmax weights kept in f32 (the reference's chunked
    JAX version rounds them to V's dtype, ``layers.py:219``); backward
    ``flash_attention_bwd`` (the backward kernels on a card tensor, their
    plain version on a CPU one) from the forward's log-sum-exp;
  * ``attention_decode`` writes the new K and V into the cache in place
    (the reference returns updated copies) and returns the same tensors;
  * ``trunc_normal`` draws from a ``torch.Generator``: seeded weights
    differ from JAX's, so tests carry weights across with ``convert.py``.

Matmuls over bf16 operands return bf16 (f32 accumulation inside), as the
reference's bf16-in/bf16-out einsums do; where the reference asks for an
f32 result (``preferred_element_type``), the operands go up to f32 first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.parallel import ctx

Params = Mapping[str, torch.Tensor]
F32 = torch.float32
_SQRT2 = math.sqrt(2.0)


def trunc_normal(gen: torch.Generator, shape, std: float, dtype,
                 device=None) -> torch.Tensor:
    """A normal draw truncated to +-2 sigma, times ``std``, in ``dtype``:
    uniform in the normal CDF between -2 and 2, mapped back through
    ``erfinv`` (f32, on ``device``, from ``gen``).  On the meta device
    (``gen`` None) an empty tensor of the shape: nothing is drawn."""
    if gen is None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    lo = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
    hi = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))
    u = torch.rand(shape, generator=gen, dtype=F32, device=device)
    u = lo + (hi - lo) * u
    z = torch.erfinv(2.0 * u - 1.0) * _SQRT2
    return (z.clamp_(-2.0, 2.0) * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(d: int, norm: str, dtype, device=None) -> Dict[str, torch.Tensor]:
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if norm == "ln":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, norm: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if norm == "rms":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(xf.var(-1, unbiased=False) + eps)[..., None]
    out = xf * p["scale"].float()
    if norm == "ln":
        out = out + p["bias"].float()
    return out.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS over head_dim with a learned per-dim scale (qwen3)."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------
def rope_tables(positions: torch.Tensor, d_head: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin (..., d_head/2) fp32."""
    half = d_head // 2
    idx = torch.arange(half, dtype=F32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B?, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    # insert the head dim; positions were (S,) or (B, S)
    cos, sin = cos[..., None, :], sin[..., None, :]
    if cos.dim() < x.dim():            # (S, 1, D/2) -> (1, S, 1, D/2)
        cos, sin = cos[None], sin[None]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sin_embedding(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    half = d_model // 2
    idx = torch.arange(half, dtype=F32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * idx / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d: int, f: int, kind: str, dtype,
             n_layers: int = 1, device=None) -> Dict[str, torch.Tensor]:
    std_in, std_out = d ** -0.5, (f ** -0.5) / math.sqrt(2 * n_layers)
    p = {"w_up": trunc_normal(gen, (d, f), std_in, dtype, device),
         "w_down": trunc_normal(gen, (f, d), std_out, dtype, device)}
    if kind == "swiglu":
        p["w_gate"] = trunc_normal(gen, (d, f), std_in, dtype, device)
    return p


def apply_mlp(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    # IO-dtype matmuls (f32 accumulation inside), as the reference's
    up = ctx.constrain(x @ p["w_up"], "hidden")
    if kind == "swiglu":
        gate = ctx.constrain(x @ p["w_gate"], "hidden")
        h = (F.silu(gate.float()) * up.float()).to(x.dtype)
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return (h @ p["w_down"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    use_rope: bool = True


def init_attention(gen: torch.Generator, spec: AttnSpec, dtype,
                   n_layers: int = 1, device=None) -> Dict[str, torch.Tensor]:
    d, dh = spec.d_model, spec.d_head
    std_in = d ** -0.5
    std_out = (spec.n_heads * dh) ** -0.5 / math.sqrt(2 * n_layers)
    p = {
        "wq": trunc_normal(gen, (d, spec.n_heads * dh), std_in, dtype, device),
        "wk": trunc_normal(gen, (d, spec.n_kv_heads * dh), std_in, dtype,
                           device),
        "wv": trunc_normal(gen, (d, spec.n_kv_heads * dh), std_in, dtype,
                           device),
        "wo": trunc_normal(gen, (spec.n_heads * dh, d), std_out, dtype,
                           device),
    }
    if spec.qkv_bias:
        for name, n in (("bq", spec.n_heads), ("bk", spec.n_kv_heads),
                        ("bv", spec.n_kv_heads)):
            p[name] = torch.zeros(n * dh, dtype=dtype, device=device)
    if spec.qk_norm:
        p["q_norm"] = torch.ones(dh, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(dh, dtype=dtype, device=device)
    return p


def _project_qkv(p: Params, x: torch.Tensor, spec: AttnSpec,
                 positions: torch.Tensor):
    # projection outputs stay in the IO dtype, as the reference's
    b, s, _ = x.shape
    dh = spec.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = ctx.constrain(q.to(x.dtype).reshape(b, s, spec.n_heads, dh),
                      "heads")
    k = ctx.constrain(k.to(x.dtype).reshape(b, s, spec.n_kv_heads, dh),
                      "heads")
    v = ctx.constrain(v.to(x.dtype).reshape(b, s, spec.n_kv_heads, dh),
                      "heads")
    if spec.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    if spec.use_rope:
        cos, sin = rope_tables(positions, dh, spec.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention through ``FlashAttention``: the flash
    kernels forward and backward.

    Keeps the reference's chunk contract: ``S`` must be a multiple of
    ``min(q_chunk, S)`` and ``T`` of ``min(kv_chunk, T)`` (0 = unchunked),
    else ``ValueError`` — the kernels tile and mask on their own.
    q: (B, S, Hq, D); k, v: (B, T, Hkv, D) -> (B, S, Hq, D)
    """
    return FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, Hq, D) against cache (B, T, Hkv, D); positions >= length
    masked.  length: (B,) valid cache length per sample (the new token's
    position + 1)."""
    b, _, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          k_cache.float()) * (d ** -0.5)
    mask = torch.arange(t, device=q.device)[None, :] < length[:, None]
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def attention_train(p: Params, x: torch.Tensor, spec: AttnSpec,
                    q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, spec, positions)
    out = flash_attention(q, k, v, causal=True, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    out = out.reshape(b, s, spec.n_heads * spec.d_head)
    return (out @ p["wo"]).to(x.dtype)


def attention_prefill(p: Params, x: torch.Tensor, spec: AttnSpec,
                      q_chunk: int = 512, kv_chunk: int = 1024
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Like attention_train but also returns the KV cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, spec, positions)
    out = flash_attention(q, k, v, causal=True, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    out = out.reshape(b, s, spec.n_heads * spec.d_head)
    y = (out @ p["wo"]).to(x.dtype)
    return y, {"k": k, "v": v}


def attention_decode(p: Params, x: torch.Tensor, spec: AttnSpec,
                     cache: Dict[str, torch.Tensor], position: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d); cache k/v: (B, T, Hkv, D), written in place at
    ``position`` (B,) and returned."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, spec, position[:, None])
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, position] = k[:, 0]
    cache["v"][bidx, position] = v[:, 0]
    out = decode_attention(q, cache["k"], cache["v"], position + 1)
    out = out.reshape(b, 1, spec.n_heads * spec.d_head)
    y = (out @ p["wo"]).to(x.dtype)
    return y, cache
