"""Model assembly — the hybrid family (zamba2).

Port of ``repro.models.transformer`` for ``family == "hybrid"``: groups of
``attn_every`` Mamba2 layers, each group followed by one SHARED
attention+MLP block (one set of weights, applied once per group), then
``n_layers % attn_every`` tail Mamba2 layers.  Written as ``nn.Module``s
(``Mamba2Layer``, ``AttnBlock``, ``HybridLM``) with a Python loop over
layers where the reference stacks parameters and runs ``lax.scan``.  The
reference's entry points are methods of ``HybridLM``:

  ``forward``      <- ``transformer.forward``      (logits f32, moe aux 0)
  ``prefill``      <- ``transformer.prefill``      (logits, serving cache)
  ``init_cache``   <- ``transformer.init_cache``
  ``decode_step``  <- ``transformer.decode_step``  (updates the cache in place)

and ``init_params`` builds a seeded model (a ``torch.Generator`` on the
target device).  The other families (dense, moe, ssm, vlm, audio) raise
``NotImplementedError``: they are ROADMAP §1 items 2 and 3.

The serving cache has the reference's layout, batch at the same axis of
every leaf:

  ``mamba``       {"conv": (G, A, B, K-1, C), "ssm": (G, A, B, H, S, P)}
  ``kv``          {"k": (G, B, T, Hkv, D), "v": ...}  — one KV cache per
                  application of the shared block
  ``mamba_tail``  {"conv": (tail, B, K-1, C), "ssm": (tail, B, H, S, P)}

``decode_step`` writes into that cache in place (the reference returns an
updated copy), which is what lets ``serve.engine`` decode one slot over a
view of its rows.  Every module's parameters are frozen
(``requires_grad=False``): this slice serves; training is a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceSpec, resolve_device, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2

F32 = torch.float32
Tree = Dict[str, Any]
BATCH_AXIS = {"mamba": 2, "kv": 1, "mamba_tail": 1}   # of each cache leaf


def attn_spec(cfg: ArchConfig) -> L.AttnSpec:
    return L.AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                      qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
                      rope_theta=cfg.rope_theta, use_rope=(cfg.pos == "rope"))


def require_hybrid(cfg: ArchConfig) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            f"serves the hybrid family (zamba2). The other LM families are "
            f"ROADMAP §1 items 2 and 3.")


def layer_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(groups of ``attn_every`` Mamba2 layers, tail layers)."""
    return divmod(cfg.n_layers, cfg.attn_every)


def _frozen(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class Mamba2Layer(nn.Module):
    """RMSNorm -> Mamba2 block, with the residual (``_apply_mamba_layer``)."""

    def __init__(self, cfg: ArchConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        self.norm = _frozen(tree["norm"])
        self.mamba = _frozen(tree["mamba"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = L.apply_norm(self.norm, x, self.cfg.norm)
        return x + M2.mamba2_block(self.mamba, h, self.cfg.ssm)

    def prefill(self, x: torch.Tensor):
        h = L.apply_norm(self.norm, x, self.cfg.norm)
        y, st = M2.mamba2_block(self.mamba, h, self.cfg.ssm, return_state=True)
        return x + y, st

    def step(self, x: torch.Tensor, conv: torch.Tensor,
             ssm: torch.Tensor) -> torch.Tensor:
        """One decode token; ``conv``/``ssm`` are this layer's state rows,
        overwritten with the new state."""
        h = L.apply_norm(self.norm, x, self.cfg.norm)
        y, st = M2.mamba2_step(self.mamba, h, {"conv": conv, "ssm": ssm},
                               self.cfg.ssm)
        conv.copy_(st["conv"])
        ssm.copy_(st["ssm"])
        return x + y


class AttnBlock(nn.Module):
    """The shared block: norm -> GQA attention -> norm -> MLP, residuals
    (``_apply_attn_block`` without MoE)."""

    def __init__(self, cfg: ArchConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        self.spec = attn_spec(cfg)
        self.attn_norm = _frozen(tree["attn_norm"])
        self.attn = _frozen(tree["attn"])
        self.mlp_norm = _frozen(tree["mlp_norm"])
        self.mlp = _frozen(tree["mlp"])

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = L.apply_norm(self.mlp_norm, x, self.cfg.norm)
        return x + L.apply_mlp(self.mlp, h, self.cfg.mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = L.apply_norm(self.attn_norm, x, self.cfg.norm)
        x = x + L.attention_train(self.attn, h, self.spec,
                                  q_chunk=self.cfg.q_chunk,
                                  kv_chunk=self.cfg.kv_chunk)
        return self._mlp(x)

    def prefill(self, x: torch.Tensor):
        h = L.apply_norm(self.attn_norm, x, self.cfg.norm)
        y, kv = L.attention_prefill(self.attn, h, self.spec,
                                    q_chunk=self.cfg.q_chunk,
                                    kv_chunk=self.cfg.kv_chunk)
        return self._mlp(x + y), kv

    def step(self, x: torch.Tensor, kv: Dict[str, torch.Tensor],
             position: torch.Tensor) -> torch.Tensor:
        h = L.apply_norm(self.attn_norm, x, self.cfg.norm)
        y, _ = L.attention_decode(self.attn, h, self.spec, kv, position)
        return self._mlp(x + y)


class HybridLM(nn.Module):
    """zamba2-style LM over a parameter tree in the port's layout:

    ``{"embed", "lm_head", "final_norm": {...},
       "layers": [[layer] * attn_every] * n_groups, "tail_layers": [...],
       "shared_attn": {...}}`` with ``layer = {"norm": {...}, "mamba": {...}}``
    (the reference's tree with its stacked leading axes unstacked).
    """

    def __init__(self, cfg: ArchConfig, tree: Tree):
        super().__init__()
        require_hybrid(cfg)
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        if cfg.embed_inputs:
            self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(tree["lm_head"], requires_grad=False)
        self.final_norm = _frozen(tree["final_norm"])
        self.groups = nn.ModuleList(
            nn.ModuleList(Mamba2Layer(cfg, lt) for lt in group)
            for group in tree["layers"])
        self.tail = nn.ModuleList(Mamba2Layer(cfg, lt)
                                  for lt in tree.get("tail_layers", []))
        self.shared = AttnBlock(cfg, tree["shared_attn"])

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    # -- embedding / head --------------------------------------------------
    def embed_inputs(self, tokens=None, embeds=None) -> torch.Tensor:
        """Token embeddings (or given ``embeds`` when the config embeds
        no tokens); the hybrid family's positions are RoPE, inside the
        attention."""
        if self.cfg.embed_inputs:
            return self.embed[tokens]
        return embeds.to(self.dtype)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and head; logits in f32 (the reference's
        preferred_element_type=F32: operands go up to f32)."""
        x = L.apply_norm(self.final_norm, x, self.cfg.norm)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x.float() @ head.float()

    # -- entry points ------------------------------------------------------
    def forward(self, tokens=None, embeds=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits fp32 (B,S,V), total moe aux loss = 0)."""
        x = self.embed_inputs(tokens, embeds)
        for group in self.groups:
            for layer in group:
                x = layer(x)
            x = self.shared(x)
        for layer in self.tail:
            x = layer(x)
        return self.unembed(x), torch.zeros((), dtype=F32, device=x.device)

    def prefill(self, tokens=None, embeds=None
                ) -> Tuple[torch.Tensor, Tree]:
        """Full-sequence pass that also emits the serving cache.

        Returns (logits (B,S,V), cache) with cache capacity == prompt
        length; ``serve.engine`` copies it into a slot of its own cache."""
        x = self.embed_inputs(tokens, embeds)
        mstates: List[List[dict]] = []
        kvs: List[dict] = []
        for group in self.groups:
            row = []
            for layer in group:
                x, st = layer.prefill(x)
                row.append(st)
            x, kv = self.shared.prefill(x)
            mstates.append(row)
            kvs.append(kv)
        cache: Tree = {
            "mamba": {key: torch.stack([torch.stack([st[key] for st in row])
                                        for row in mstates])
                      for key in ("conv", "ssm")},
            "kv": {key: torch.stack([kv[key] for kv in kvs])
                   for key in ("k", "v")}}
        if len(self.tail):
            tstates = []
            for layer in self.tail:
                x, st = layer.prefill(x)
                tstates.append(st)
            cache["mamba_tail"] = {key: torch.stack([st[key] for st in tstates])
                                   for key in ("conv", "ssm")}
        return self.unembed(x), cache

    def init_cache(self, bsz: int, max_len: int) -> Tree:
        """A zeroed serving cache for ``bsz`` sequences of up to
        ``max_len`` tokens, on the model's device."""
        cfg, dev = self.cfg, self.device
        n_groups, tail = layer_counts(cfg)
        kv_shape = (n_groups, bsz, max_len, cfg.n_kv_heads, cfg.d_head)
        st = M2.mamba2_init_state(bsz, cfg.d_model, cfg.ssm, self.dtype, dev)
        cache: Tree = {
            "mamba": {k: t.new_zeros((n_groups, cfg.attn_every) + t.shape)
                      for k, t in st.items()},
            "kv": {k: torch.zeros(kv_shape, dtype=self.dtype, device=dev)
                   for k in ("k", "v")}}
        if tail:
            cache["mamba_tail"] = {k: t.new_zeros((tail,) + t.shape)
                                   for k, t in st.items()}
        return cache

    def decode_step(self, cache: Tree, position: torch.Tensor, *,
                    tokens=None, embeds=None) -> Tuple[torch.Tensor, Tree]:
        """One-token decode.  tokens: (B, 1); position: (B,) write index.
        Returns (logits (B, 1, V), cache) — the cache updated in place."""
        x = self.embed_inputs(tokens, embeds)
        mamba, kv = cache["mamba"], cache["kv"]
        for gi, group in enumerate(self.groups):
            for li, layer in enumerate(group):
                x = layer.step(x, mamba["conv"][gi, li], mamba["ssm"][gi, li])
            x = self.shared.step(x, {"k": kv["k"][gi], "v": kv["v"][gi]},
                                 position)
        for ti, layer in enumerate(self.tail):
            x = layer.step(x, cache["mamba_tail"]["conv"][ti],
                           cache["mamba_tail"]["ssm"][ti])
        return self.unembed(x), cache


def init_tree(cfg: ArchConfig, gen: torch.Generator, device) -> Tree:
    """A seeded parameter tree in the port's layout (see ``HybridLM``),
    drawn in the reference's init distributions."""
    require_hybrid(cfg)
    dtype = torch_dtype(cfg.dtype)
    n_groups, tail = layer_counts(cfg)

    def mamba_layer():
        return {"norm": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
                "mamba": M2.init_mamba2(gen, cfg.d_model, cfg.ssm, dtype,
                                        cfg.n_layers, device)}

    tree: Tree = {}
    if cfg.embed_inputs:
        tree["embed"] = L.trunc_normal(gen, (cfg.vocab, cfg.d_model),
                                       cfg.d_model ** -0.5, dtype, device)
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.trunc_normal(gen, (cfg.d_model, cfg.vocab),
                                         cfg.d_model ** -0.5, dtype, device)
    tree["final_norm"] = L.init_norm(cfg.d_model, cfg.norm, dtype, device)
    tree["layers"] = [[mamba_layer() for _ in range(cfg.attn_every)]
                      for _ in range(n_groups)]
    tree["tail_layers"] = [mamba_layer() for _ in range(tail)]
    tree["shared_attn"] = {
        "attn_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
        "attn": L.init_attention(gen, attn_spec(cfg), dtype, cfg.n_layers,
                                 device),
        "mlp_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                          cfg.n_layers, device)}
    return tree


def init_params(cfg: ArchConfig, seed: int = 0,
                device: DeviceSpec = None) -> HybridLM:
    """A seeded ``HybridLM`` (``transformer.init_params``), drawn on
    ``device`` (default the card) from a ``torch.Generator`` seeded with
    ``seed``.  The weights differ from JAX's for the same seed."""
    require_hybrid(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return HybridLM(cfg, init_tree(cfg, gen, dev))


def prefill_accepts(cfg: ArchConfig, n: int) -> bool:
    """Whether ``prefill`` takes a sequence of ``n`` tokens: the SSD needs
    ``n % chunk == 0`` once ``n > chunk`` (``ssd_chunked``), and attention
    the same of its q and kv chunks (``layers.flash_attention``)."""
    def fits(c: int) -> bool:
        return not c or n % min(c, n) == 0
    return n > 0 and fits(cfg.ssm.chunk) and fits(cfg.q_chunk) \
        and fits(cfg.kv_chunk)


def prefill_len(cfg: ArchConfig, n: int) -> int:
    """The longest prefix of ``n`` tokens that ``prefill`` accepts (0 when
    none does); the rest is decoded token by token."""
    return next((m for m in range(n, 0, -1) if prefill_accepts(cfg, m)), 0)
