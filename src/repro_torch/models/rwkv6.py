"""RWKV6 "Finch" block (arXiv:2404.05892): data-dependent per-channel decay.

Port of ``repro.models.rwkv6``.  Per head (head size N), state S in
R^{NxN} (key-dim x value-dim):

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with w_t = exp(-exp(w0 + lora_w(x))) in (0,1), data-dependent.  The
reference has no kernel here: it computes in plain JAX, so the port
computes in PyTorch ops.  ``rwkv6_timemix_scan`` walks time in a Python
loop (the reference's ``lax.scan``); ``rwkv6_timemix_chunked`` is the
GLA-style chunked matmul form, with the reference's safety rule: every
exponent is a backward decay segment (<= 0), the intra-chunk decay masks
its exponent to -inf before ``exp`` (so neither the forward nor its
gradient meets inf or nan) and nothing is ever ``exp(+cum)``.

Everything inside computes in f32 (the reference's ``.astype(F32)`` on
inputs and weights: each call casts the projection weights up), outputs
return in the input's dtype, and the per-head group norm keeps the
reference's epsilon 64e-5.  Weights are drawn from a ``torch.Generator``;
tests carry the reference's across with ``convert.py``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import trunc_normal

F32 = torch.float32
Params = Mapping[str, torch.Tensor]
LORA_R = 32
HEAD_SIZE = 64
CHUNK = 16


def init_rwkv6_layer(gen: torch.Generator, d: int, d_ff: int, dtype,
                     n_layers: int = 1, device=None
                     ) -> Dict[str, torch.Tensor]:
    h = d // HEAD_SIZE
    std = d ** -0.5
    std_o = std / math.sqrt(2 * n_layers)

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    def tn(shape, s):
        return trunc_normal(gen, shape, s, dtype, device)

    return {
        # token-shift mix vectors (r, k, v, w, g) + base
        "mu_base": full((d,), 0.5),
        "mu": full((5, d), 0.5),
        "lora_A": tn((d, 5 * LORA_R), std),
        "lora_B": tn((5, LORA_R, d), LORA_R ** -0.5),
        "w0": full((d,), 0.0, F32),
        "w_lora_A": tn((d, 64), std),
        "w_lora_B": tn((64, d), 64 ** -0.5),
        "u": full((h, HEAD_SIZE), 0.0, F32),
        "wr": tn((d, d), std),
        "wk": tn((d, d), std),
        "wv": tn((d, d), std),
        "wg": tn((d, d), std),
        "wo": tn((d, d), std_o),
        "ln_x_scale": full((d,), 1.0),
        # channel mix
        "cm_mu_k": full((d,), 0.5),
        "cm_mu_r": full((d,), 0.5),
        "cm_wk": tn((d, d_ff), std),
        "cm_wv": tn((d_ff, d), (d_ff ** -0.5) / math.sqrt(2 * n_layers)),
        "cm_wr": tn((d, d), std),
    }


def _token_shift(x: torch.Tensor, x_prev_tail: torch.Tensor) -> torch.Tensor:
    """x: (B, L, D) -> x_{t-1} with x_prev_tail (B, 1, D) as x_{-1}."""
    return torch.cat([x_prev_tail, x[:, :-1]], 1)


def _ddlerp(p: Params, x: torch.Tensor, xs: torch.Tensor
            ) -> List[torch.Tensor]:
    """Data-dependent lerp -> the 5 mixed inputs (r, k, v, w, g)."""
    dx = xs - x
    base = x + dx * p["mu_base"].float()
    lora = torch.tanh(base @ p["lora_A"].float())
    lora = lora.reshape(*lora.shape[:-1], 5, LORA_R)
    adj = torch.einsum("blsr,srd->bsld", lora, p["lora_B"].float())
    mixed = x[:, None] + dx[:, None] * (p["mu"].float()[None, :, None, :]
                                        + adj)          # (B, 5, L, D)
    return [mixed[:, i] for i in range(5)]


def _project_rkvwg(p: Params, x: torch.Tensor, xs: torch.Tensor):
    xr, xk, xv, xw, xg = _ddlerp(p, x.float(), xs.float())
    r = xr @ p["wr"].float()
    k = xk @ p["wk"].float()
    v = xv @ p["wv"].float()
    g = xg @ p["wg"].float()
    logw = -torch.exp(p["w0"][None, None] + torch.tanh(
        xw @ p["w_lora_A"].float()) @ p["w_lora_B"].float())
    w = torch.exp(logw)                                 # in (0, 1)
    return r, k, v, g, w, logw


def _head_split(t: torch.Tensor) -> torch.Tensor:
    b, l, d = t.shape
    return t.reshape(b, l, d // HEAD_SIZE, HEAD_SIZE)


def rwkv6_timemix_scan(p: Params, x: torch.Tensor, x_prev_tail: torch.Tensor,
                       s0: torch.Tensor, partial: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline: a loop over time.  x: (B, L, D); s0: (B, H, N, N) f32,
    H the heads of ``p`` (every head, or a TP shard's own: ``wr``/``wk``/
    ``wv``/``wg``/``w0``/``w_lora_B`` cut to their columns, ``u``,
    ``ln_x_scale`` and ``wo`` to their rows).  Returns (out (B, L, D) in
    x's dtype, or the f32 product with ``partial`` (``_finish_timemix``),
    final state f32)."""
    xs = _token_shift(x.float(), x_prev_tail.float())
    r, k, v, g, w, _ = _project_rkvwg(p, x, xs)
    r, k, v, w = map(_head_split, (r, k, v, w))
    u = p["u"][None, :, :, None]
    s, ys = s0, []
    for t in range(x.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # (B, H, N, N)
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], s + u * kv))
        s = w[:, t, :, :, None] * s + kv
    y = torch.stack(ys, 1)                                  # (B, L, H, N)
    return _finish_timemix(p, x, y, g, partial), s


def rwkv6_timemix_chunked(p: Params, x: torch.Tensor,
                          x_prev_tail: torch.Tensor, s0: torch.Tensor,
                          chunk: int = CHUNK, partial: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GLA-style chunked matmul form; L must be a multiple of
    ``chunk``; the heads and ``partial`` as ``rwkv6_timemix_scan``'s.
    Every exponent is a backward decay segment (<= 0); the intra-chunk
    pairwise decay uses the segment directly (never the exp(+cum)
    factoring, which overflows), masked to -inf above the strict
    diagonal before ``exp``."""
    b, l, _ = x.shape
    if l % chunk != 0:
        raise ValueError(f"L {l} not divisible by chunk {chunk}")
    xs = _token_shift(x.float(), x_prev_tail.float())
    r, k, v, g, w, logw = _project_rkvwg(p, x, xs)
    nc, h = l // chunk, r.shape[-1] // HEAD_SIZE
    u = p["u"]

    def chunked(t):
        return t.reshape(b, nc, chunk, h, HEAD_SIZE)

    rc, kc, vc, lw = map(chunked, (r, k, v, logw))
    cum = torch.cumsum(lw, 2)                      # decay through step i
    cum_excl = cum - lw                            # decay before step i
    r_dec = rc * torch.exp(cum_excl)               # <= |rc|: safe
    k_dec = kc * torch.exp(cum[:, :, -1:] - cum)   # decay i+1..end: safe

    # intra-chunk scores: sum_n r_i k_j exp(cum_excl_i - cum_j), strict j < i
    seg = cum_excl[:, :, :, None] - cum[:, :, None, :]     # (b,nc,i,j,h,n)
    idx = torch.arange(chunk, device=x.device)
    mask = (idx[:, None] > idx[None, :])[None, None, :, :, None, None]
    dec = torch.exp(torch.where(mask, seg, -math.inf))
    scores = torch.einsum("bcihn,bcjhn,bcijhn->bchij", rc, kc, dec)
    y_intra = torch.einsum("bchij,bcjhn->bcihn", scores, vc)
    # u bonus (diagonal, current token)
    bonus = torch.einsum("bncho,ho,bncho->bnch", rc, u, kc)
    y_intra = y_intra + bonus[..., None] * vc

    # chunk states and the inter-chunk recurrence
    states = torch.einsum("bncho,bnchv->bnhov", k_dec, vc)  # (B,nc,H,N,N)
    chunk_decay = torch.exp(cum[:, :, -1])                  # (B, nc, H, N)
    s_run, s_prev = s0, []
    for n in range(nc):
        s_prev.append(s_run)                                # state before n
        s_run = chunk_decay[:, n, ..., None] * s_run + states[:, n]
    y_inter = torch.einsum("bncho,bnhov->bnchv", r_dec,
                           torch.stack(s_prev, 1))
    y = (y_intra + y_inter).reshape(b, l, h, HEAD_SIZE)
    return _finish_timemix(p, x, y, g, partial), s_run


def _finish_timemix(p: Params, x: torch.Tensor, y: torch.Tensor,
                    g: torch.Tensor, partial: bool = False) -> torch.Tensor:
    """Per-head group norm (epsilon 64e-5), silu(g) gate, output
    projection, rounded to x's dtype (with ``partial`` left in f32: a TP
    shard's row-parallel part, which the ring sums before rounding)."""
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, unbiased=False)
    y = (y - mu) * torch.rsqrt(var + 64e-5)[..., None]
    b, l = x.shape[0], x.shape[1]
    y = y.reshape(b, l, -1) * p["ln_x_scale"].float()
    y = y * F.silu(g)
    out = y @ p["wo"].float()
    return out if partial else out.to(x.dtype)


def rwkv6_channelmix(p: Params, x: torch.Tensor, x_prev_tail: torch.Tensor
                     ) -> torch.Tensor:
    xf = x.float()
    xs = _token_shift(xf, x_prev_tail.float())
    xk = xf + (xs - xf) * p["cm_mu_k"].float()
    xr = xf + (xs - xf) * p["cm_mu_r"].float()
    k = torch.square(torch.relu(xk @ p["cm_wk"].float()))
    v = k @ p["cm_wv"].float()
    r = torch.sigmoid(xr @ p["cm_wr"].float())
    return (r * v).to(x.dtype)


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------
def rwkv6_init_state(bsz: int, d: int, dtype, device=None
                     ) -> Dict[str, torch.Tensor]:
    """Serving state: previous normed inputs for both token shifts + S."""
    h = d // HEAD_SIZE
    return {
        "tm_x": torch.zeros(bsz, 1, d, dtype=dtype, device=device),
        "cm_x": torch.zeros(bsz, 1, d, dtype=dtype, device=device),
        "s": torch.zeros(bsz, h, HEAD_SIZE, HEAD_SIZE, dtype=F32,
                         device=device),
    }
