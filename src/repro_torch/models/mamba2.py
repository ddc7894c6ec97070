"""Mamba2 (SSD) block — chunked matmul formulation (arXiv:2405.21060 §6).

Port of ``repro.models.mamba2``.  The chunked form turns the
selective-scan recurrence into matmuls: intra-chunk "attention-like" scores
plus an inter-chunk state recurrence over L/chunk steps (a Python loop
here, a ``lax.scan`` in the reference).  The depthwise causal conv inside
the block goes through ``kernels.ops.causal_conv1d_op``: the CUDA kernel on
a card tensor, its plain version on a CPU one.  The reference's
``use_pallas`` flag goes — the tensor's device decides, as ``plan/build.py``
does.

Rounding points follow the reference: the big SSD operands stay in the IO
dtype, decays and cumulative sums in f32, and every einsum the reference
asks for in f32 (``preferred_element_type``) takes f32 operands here.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ops import causal_conv1d_op
from repro_torch.models.layers import trunc_normal

F32 = torch.float32
Params = Mapping[str, torch.Tensor]


def init_mamba2(gen: torch.Generator, d_model: int, cfg: SSMConfig, dtype,
                n_layers: int = 1, device=None) -> Dict[str, torch.Tensor]:
    di = cfg.expand * d_model
    nh = di // cfg.head_dim
    conv_dim = di + 2 * cfg.n_groups * cfg.state
    std = d_model ** -0.5
    proj_out = 2 * di + 2 * cfg.n_groups * cfg.state + nh
    u = torch.rand(nh, generator=gen, dtype=F32, device=device)
    dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u)
    return {
        "in_proj": trunc_normal(gen, (d_model, proj_out), std, dtype, device),
        "conv_w": trunc_normal(gen, (cfg.conv_kernel, conv_dim), 0.2, dtype,
                               device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=F32,
                                          device=device)),
        "D": torch.ones(nh, dtype=F32, device=device),
        "dt_bias": torch.log(torch.expm1(dt)),     # softplus^-1(dt)
        "norm_scale": torch.ones(di, dtype=dtype, device=device),
        "out_proj": trunc_normal(gen, (di, d_model),
                                 (di ** -0.5) / math.sqrt(2 * n_layers), dtype,
                                 device),
    }


def _segsum_decay(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log-decays -> (..., Q, Q) lower-tri exp(segment sums).

    out[i, j] = exp(sum_{t=j+1..i} a_t) for i >= j, else 0.

    The exponent is masked before ``exp``: above the diagonal ``seg`` is a
    sum of -a > 0, which overflows to inf once a chunk's decay passes ~88
    (zamba2-7b's chunk of 256), and ``where`` after ``exp`` would then
    give the backward inf * 0 = nan.  The reference (``repro.models.
    mamba2._segsum_decay``) masks after ``exp`` and has that nan; the
    values are the same.
    """
    q = a.shape[-1]
    cum = torch.cumsum(a, -1)
    seg = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(q, q, dtype=torch.bool, device=a.device).tril()
    return torch.exp(seg.masked_fill(~mask, float("-inf")))


def _heads(t: torch.Tensor, hg: int, axis: int) -> torch.Tensor:
    """Group axis ``axis`` of ``t`` widened to heads: each of the G groups
    repeated ``hg`` times (a broadcast view when G == 1)."""
    if t.shape[axis] == 1:
        shape = list(t.shape)
        shape[axis] = hg
        return t.expand(shape)
    return t.repeat_interleave(hg, dim=axis)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_head: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.
    x: (B, L, H, P); dt: (B, L, H) fp32 (post-softplus); a_head: (H,)
    negative; b, c: (B, L, G, S) with H % G == 0.
    Returns (y (B, L, H, P) f32, final state (B, H, S, P) f32).
    """
    bs, l, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    if l % chunk != 0:
        raise ValueError(f"L {l} not divisible by chunk {chunk}")
    nc = l // chunk
    hg = h // g

    io_dt = x.dtype
    xdt = (x.float() * dt[..., None]).to(io_dt)             # discretized input
    la = dt * a_head[None, None, :]                         # (B, L, H) log decay
    xdt = xdt.reshape(bs, nc, chunk, h, p)
    la = la.reshape(bs, nc, chunk, h)
    bb = b.to(io_dt).reshape(bs, nc, chunk, g, s)
    cc = c.to(io_dt).reshape(bs, nc, chunk, g, s)

    cum = torch.cumsum(la, 2)                               # (B, nc, Q, H)
    lmat = _segsum_decay(la.movedim(-1, 2))                 # (B, nc, H, Q, Q)

    # intra-chunk: scores[i,j] = (C_i . B_j) * decay(i,j)
    cb = torch.einsum("bnigs,bnjgs->bngij", cc.float(), bb.float())
    scores = (_heads(cb, hg, 2) * lmat).to(io_dt)           # (B, nc, H, Q, Q)
    y_intra = torch.einsum("bnhij,bnjhp->bnihp", scores.float(), xdt.float())

    # chunk states: S_n = sum_j B_j decay(last, j) xdt_j -> (B, nc, H, S, P)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)       # (B, nc, Q, H)
    bgh = _heads(bb, hg, 3).float()                         # (B, nc, Q, H, S)
    states = torch.einsum("bnjhs,bnjhp->bnhsp", bgh,
                          decay_states[..., None] * xdt.float())

    # inter-chunk recurrence over nc
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B, nc, H)
    s_run = torch.zeros(bs, h, s, p, dtype=F32, device=x.device)
    s_prev = []
    for n in range(nc):
        s_prev.append(s_run)                                # state before chunk
        s_run = s_run * chunk_decay[:, n, :, None, None] + states[:, n]
    s_prev = torch.stack(s_prev, 1)                         # (B, nc, H, S, P)

    cgh = _heads(cc, hg, 3).float()
    y_inter = torch.einsum("bnihs,bnhsp->bnihp", cgh, s_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bs, l, h, p)
    return y, s_run


def mamba2_block(p: Params, x: torch.Tensor, cfg: SSMConfig, *,
                 return_state: bool = False):
    """x: (B, L, d_model) -> (B, L, d_model) [, serving state]."""
    bsz, l, d_model = x.shape
    di = cfg.expand * d_model
    nh = di // cfg.head_dim
    g, s = cfg.n_groups, cfg.state

    zxbcdt = (x @ p["in_proj"]).to(x.dtype)
    z = zxbcdt[..., :di]
    conv_in = zxbcdt[..., di:2 * di + 2 * g * s].contiguous()   # [x | B C]
    dt_raw = zxbcdt[..., 2 * di + 2 * g * s:]
    conv_out = causal_conv1d_op(conv_in, p["conv_w"])
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xc, bmat, cmat = torch.split(conv_out, [di, g * s, g * s], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])            # (B, L, H)
    a_head = -torch.exp(p["A_log"])
    xh = xc.reshape(bsz, l, nh, cfg.head_dim)
    y, s_fin = ssd_chunked(xh, dt, a_head, bmat.reshape(bsz, l, g, s),
                           cmat.reshape(bsz, l, g, s),
                           chunk=min(cfg.chunk, l))
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, l, di)
    # gated RMSNorm (Mamba2's NormGated)
    y = y * F.silu(z.float())
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-5)
    y = (y * p["norm_scale"].float()).to(x.dtype)
    out = (y @ p["out_proj"]).to(x.dtype)
    if not return_state:
        return out
    kc = p["conv_w"].shape[0]
    pad = conv_in.new_zeros(bsz, max(0, kc - 1 - l), conv_in.shape[-1])
    conv_state = torch.cat([pad, conv_in[:, max(0, l - (kc - 1)):]], 1)
    return out, {"conv": conv_state, "ssm": s_fin}


# ---------------------------------------------------------------------------
# Decode path: O(1) state per token
# ---------------------------------------------------------------------------
def mamba2_init_state(bsz: int, d_model: int, cfg: SSMConfig, dtype,
                      device=None) -> Dict[str, torch.Tensor]:
    di = cfg.expand * d_model
    nh = di // cfg.head_dim
    conv_dim = di + 2 * cfg.n_groups * cfg.state
    return {
        "conv": torch.zeros(bsz, cfg.conv_kernel - 1, conv_dim, dtype=dtype,
                            device=device),
        "ssm": torch.zeros(bsz, nh, cfg.state, cfg.head_dim, dtype=F32,
                           device=device),
    }


def mamba2_step(p: Params, x: torch.Tensor, state: Mapping[str, torch.Tensor],
                cfg: SSMConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d_model); O(1) per-token state update.  Returns the output
    and the new state (the given state is left as it was)."""
    bsz, _, d_model = x.shape
    di = cfg.expand * d_model
    nh = di // cfg.head_dim
    g, s = cfg.n_groups, cfg.state

    # f32 accumulation, one rounding to the IO dtype (the reference's
    # preferred_element_type=F32 then astype)
    zxbcdt = (x @ p["in_proj"]).to(x.dtype)
    z = zxbcdt[:, 0, :di]
    conv_in = zxbcdt[:, 0, di:2 * di + 2 * g * s]             # (B, conv_dim)
    dt_raw = zxbcdt[:, 0, 2 * di + 2 * g * s:]
    window = torch.cat([state["conv"], conv_in[:, None]], 1)  # (B, K, conv)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
    conv_out = F.silu(conv_out).to(x.dtype)
    xc, bvec, cvec = torch.split(conv_out, [di, g * s, g * s], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])            # (B, H)
    a = torch.exp(dt * (-torch.exp(p["A_log"]))[None, :])     # (B, H)
    xh = xc.reshape(bsz, nh, cfg.head_dim).float()
    bh = bvec.reshape(bsz, g, 1, s).float().expand(bsz, g, nh // g, s) \
        .reshape(bsz, nh, s)
    ch = cvec.reshape(bsz, g, 1, s).float().expand(bsz, g, nh // g, s) \
        .reshape(bsz, nh, s)
    ssm = state["ssm"] * a[..., None, None] + \
        (bh * dt[..., None])[..., :, None] * xh[..., None, :]
    y = torch.einsum("bhs,bhsp->bhp", ch, ssm) + p["D"][None, :, None] * xh
    y = y.reshape(bsz, di)
    y = y * F.silu(z.float())
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-5)
    y = (y * p["norm_scale"].float()).to(x.dtype)
    out = (y @ p["out_proj"]).to(x.dtype)[:, None]
    return out, {"conv": window[:, 1:].to(state["conv"].dtype), "ssm": ssm}
