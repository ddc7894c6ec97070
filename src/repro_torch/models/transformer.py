"""Model assembly for every ported architecture family.

Port of ``repro.models.transformer``, written as ``nn.Module``s with a
Python loop over layers where the reference stacks parameters and runs
``lax.scan``:

  dense / moe / vlm / audio  ``AttnLM``: ``[norm -> GQA attn -> norm ->
                             MLP|MoE] x L`` (``AttnBlock``; MoE from
                             ``models/moe.py``, arctic's dense residual
                             MLP beside it)
  hybrid (zamba2)            ``HybridLM``: groups of ``attn_every`` Mamba2
                             layers, each group followed by one SHARED
                             attention+MLP block (one set of weights), then
                             ``n_layers % attn_every`` tail Mamba2 layers
  ssm (rwkv6)                not ported yet: ``NotImplementedError``
                             naming ROADMAP §1 item 3

vlm and audio take ``embeds`` in place of tokens (``embed_inputs=False``;
their frontends are stubs in the reference too), and ``pos == "sin"``
adds sinusoidal positions at the embedding.  The reference's entry points
are methods of both models:

  ``forward``      <- ``transformer.forward``      (logits f32, moe aux)
  ``prefill``      <- ``transformer.prefill``      (logits, serving cache)
  ``init_cache``   <- ``transformer.init_cache``
  ``decode_step``  <- ``transformer.decode_step``  (updates the cache in place)

and ``init_params`` builds a seeded model of the config's family (a
``torch.Generator`` on the target device).  ``AttnLM.forward`` and
``prefill`` take ``capacity_factor`` (default the MoE config's, as
``moe_ffn`` has); ``decode_step`` runs the MoE drop-free (``E / k``), as
the reference's decode does (``transformer.py:393-395``).

The serving caches have the reference's layout, batch at the same axis of
every leaf:

  ``kv``          {"k": (L, B, T, Hkv, D), "v": ...} for ``AttnLM``, one
                  per layer; (G, B, T, Hkv, D) for ``HybridLM``, one per
                  application of the shared block
  ``mamba``       {"conv": (G, A, B, K-1, C), "ssm": (G, A, B, H, S, P)}
  ``mamba_tail``  {"conv": (tail, B, K-1, C), "ssm": (tail, B, H, S, P)}

``decode_step`` writes into that cache in place (the reference returns an
updated copy), which is what lets ``serve.engine`` decode one slot over a
view of its rows.  The head computes in f32 as the reference's
``preferred_element_type=F32`` does (``unembed``): operands go up to f32,
a copy of the head per call.  That copy is kept, because it changes no
bit of the logits and is a small share of a decode step (qwen2.5-3b at 2
slots on an H100: 0.94 ms of device time in a 66 ms step, PERF.md §5).
Every module's
parameters are frozen (``requires_grad=False``): these slices serve;
training the LMs is ROADMAP §1 item 4.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceSpec, resolve_device, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE

F32 = torch.float32
Tree = Dict[str, Any]
BATCH_AXIS = {"mamba": 2, "kv": 1, "mamba_tail": 1}   # of each cache leaf
FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


def attn_spec(cfg: ArchConfig) -> L.AttnSpec:
    return L.AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                      qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
                      rope_theta=cfg.rope_theta, use_rope=(cfg.pos == "rope"))


def require_ported(cfg: ArchConfig) -> None:
    """Raises ``NotImplementedError`` for the one family not ported yet,
    ``ssm`` (rwkv6)."""
    if cfg.family == "ssm":
        raise NotImplementedError(
            f"{cfg.name}: family 'ssm' (rwkv6) is not ported yet; it is "
            f"ROADMAP §1 item 3.")
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


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
    """norm -> GQA attention -> norm -> FFN, with residuals
    (``_apply_attn_block``).  The FFN is the MLP, or the MoE FFN
    (``models/moe.py``) plus, for arctic, a dense residual MLP beside it.
    ``forward`` returns ``(x, moe aux loss)``, the loss None without MoE
    (the hybrid's shared block is one with an MLP)."""

    def __init__(self, cfg: ArchConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        self.spec = attn_spec(cfg)
        self.attn_norm = _frozen(tree["attn_norm"])
        self.attn = _frozen(tree["attn"])
        self.mlp_norm = _frozen(tree["mlp_norm"])
        if cfg.moe is not None:
            self.moe = _frozen(tree["moe"])
            if cfg.moe.dense_residual_ff:
                self.dense_mlp = _frozen(tree["dense_mlp"])
        else:
            self.mlp = _frozen(tree["mlp"])

    def _ffn(self, x: torch.Tensor, capacity_factor: Optional[float]
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``x + FFN(norm(x))`` and the MoE load-balance loss (None without
        MoE); ``capacity_factor`` None is the config's."""
        cfg = self.cfg
        h = L.apply_norm(self.mlp_norm, x, cfg.norm)
        if cfg.moe is None:
            return x + L.apply_mlp(self.mlp, h, cfg.mlp), None
        b, s, d = h.shape
        y, stats = MOE.moe_ffn(self.moe, h.reshape(b * s, d), cfg.moe,
                               capacity_factor=capacity_factor)
        y = y.reshape(b, s, d)
        if cfg.moe.dense_residual_ff:
            y = y + L.apply_mlp(self.dense_mlp, h, cfg.mlp)
        return x + y, stats["lb_loss"]

    def forward(self, x: torch.Tensor, capacity_factor: Optional[float] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = L.apply_norm(self.attn_norm, x, self.cfg.norm)
        x = x + L.attention_train(self.attn, h, self.spec,
                                  q_chunk=self.cfg.q_chunk,
                                  kv_chunk=self.cfg.kv_chunk)
        return self._ffn(x, capacity_factor)

    def prefill(self, x: torch.Tensor,
                capacity_factor: Optional[float] = None):
        h = L.apply_norm(self.attn_norm, x, self.cfg.norm)
        y, kv = L.attention_prefill(self.attn, h, self.spec,
                                    q_chunk=self.cfg.q_chunk,
                                    kv_chunk=self.cfg.kv_chunk)
        return self._ffn(x + y, capacity_factor)[0], kv

    def step(self, x: torch.Tensor, kv: Dict[str, torch.Tensor],
             position: torch.Tensor) -> torch.Tensor:
        """One decode token; the MoE FFN runs drop-free (capacity factor
        ``E / k``), as the reference's decode does."""
        h = L.apply_norm(self.attn_norm, x, self.cfg.norm)
        y, _ = L.attention_decode(self.attn, h, self.spec, kv, position)
        cf = None if self.cfg.moe is None else \
            MOE.drop_free_factor(self.cfg.moe)
        return self._ffn(x + y, cf)[0]


class _LM(nn.Module):
    """What every LM shares: the token embedding (or given embeddings),
    sinusoidal positions, the final norm and the f32 head."""

    def __init__(self, cfg: ArchConfig, tree: Tree):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        if cfg.embed_inputs:
            self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(tree["lm_head"], requires_grad=False)
        self.final_norm = _frozen(tree["final_norm"])

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    def embed_inputs(self, tokens=None, embeds=None,
                     position: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings, or the given ``embeds`` where the config
        embeds no tokens; for ``pos == "sin"`` plus the sinusoidal
        embedding of ``arange(S)``, or of ``position`` (B,) on a decode
        step (``transformer.py:180-189, 376-381``)."""
        cfg = self.cfg
        x = self.embed[tokens] if cfg.embed_inputs else embeds.to(self.dtype)
        if cfg.pos == "sin":
            pos = torch.arange(x.shape[1], device=x.device) \
                if position is None else position[:, None]
            x = x + L.sin_embedding(pos, cfg.d_model).to(x.dtype)
        return x

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and head; logits in f32 (the reference's
        preferred_element_type=F32: operands go up to f32)."""
        x = L.apply_norm(self.final_norm, x, self.cfg.norm)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x.float() @ head.float()


class AttnLM(_LM):
    """The attention-block families (dense, moe, vlm, audio):
    ``[norm -> GQA attn -> norm -> MLP|MoE] x L`` over a tree in the port's
    layout ``{"embed", "lm_head", "final_norm": {...}, "layers": [block] *
    n_layers}`` (the reference's tree, its stacked layer axis unstacked).
    The serving cache is ``{"kv": {"k": (L, B, T, Hkv, D), "v": ...}}``.
    ``capacity_factor`` on ``forward``/``prefill`` overrides the MoE
    config's (``serve.engine`` passes the drop-free ``E / k``)."""

    def __init__(self, cfg: ArchConfig, tree: Tree):
        super().__init__(cfg, tree)
        self.layers = nn.ModuleList(AttnBlock(cfg, lt)
                                    for lt in tree["layers"])

    def forward(self, tokens=None, embeds=None,
                capacity_factor: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits fp32 (B,S,V), total moe aux loss)."""
        x = self.embed_inputs(tokens, embeds)
        aux = torch.zeros((), dtype=F32, device=x.device)
        for layer in self.layers:
            x, a = layer(x, capacity_factor)
            if a is not None:
                aux = aux + a
        return self.unembed(x), aux

    def prefill(self, tokens=None, embeds=None,
                capacity_factor: Optional[float] = None
                ) -> Tuple[torch.Tensor, Tree]:
        """Full-sequence pass that also emits the serving cache: (logits
        (B,S,V), cache) with cache capacity == prompt length."""
        x = self.embed_inputs(tokens, embeds)
        kvs = []
        for layer in self.layers:
            x, kv = layer.prefill(x, capacity_factor)
            kvs.append(kv)
        cache = {"kv": {key: torch.stack([kv[key] for kv in kvs])
                        for key in ("k", "v")}}
        return self.unembed(x), cache

    def init_cache(self, bsz: int, max_len: int) -> Tree:
        """A zeroed serving cache for ``bsz`` sequences of up to
        ``max_len`` tokens, on the model's device."""
        cfg = self.cfg
        shape = (cfg.n_layers, bsz, max_len, cfg.n_kv_heads, cfg.d_head)
        return {"kv": {k: torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)
                       for k in ("k", "v")}}

    def decode_step(self, cache: Tree, position: torch.Tensor, *,
                    tokens=None, embeds=None) -> Tuple[torch.Tensor, Tree]:
        """One-token decode.  tokens (or embeds): (B, 1); position: (B,)
        write index.  Returns (logits (B, 1, V), cache) — the cache
        updated in place."""
        x = self.embed_inputs(tokens, embeds, position)
        kv = cache["kv"]
        for li, layer in enumerate(self.layers):
            x = layer.step(x, {"k": kv["k"][li], "v": kv["v"][li]}, position)
        return self.unembed(x), cache


class HybridLM(_LM):
    """zamba2-style LM over a parameter tree in the port's layout:

    ``{"embed", "lm_head", "final_norm": {...},
       "layers": [[layer] * attn_every] * n_groups, "tail_layers": [...],
       "shared_attn": {...}}`` with ``layer = {"norm": {...}, "mamba": {...}}``
    (the reference's tree with its stacked leading axes unstacked).
    """

    def __init__(self, cfg: ArchConfig, tree: Tree):
        super().__init__(cfg, tree)
        self.groups = nn.ModuleList(
            nn.ModuleList(Mamba2Layer(cfg, lt) for lt in group)
            for group in tree["layers"])
        self.tail = nn.ModuleList(Mamba2Layer(cfg, lt)
                                  for lt in tree.get("tail_layers", []))
        self.shared = AttnBlock(cfg, tree["shared_attn"])

    # -- entry points ------------------------------------------------------
    def forward(self, tokens=None, embeds=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits fp32 (B,S,V), total moe aux loss = 0)."""
        x = self.embed_inputs(tokens, embeds)
        for group in self.groups:
            for layer in group:
                x = layer(x)
            x, _ = self.shared(x)
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
        x = self.embed_inputs(tokens, embeds, position)
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


LM = Union[AttnLM, HybridLM]


def _attn_block_tree(cfg: ArchConfig, gen: torch.Generator, dtype,
                     device) -> Tree:
    """One attention block's tree (``_init_attn_block``)."""
    d = cfg.d_model
    tree = {"attn_norm": L.init_norm(d, cfg.norm, dtype, device),
            "attn": L.init_attention(gen, attn_spec(cfg), dtype, cfg.n_layers,
                                     device),
            "mlp_norm": L.init_norm(d, cfg.norm, dtype, device)}
    if cfg.moe is not None:
        tree["moe"] = MOE.init_moe(gen, d, cfg.moe, dtype, cfg.n_layers,
                                   device)
        if cfg.moe.dense_residual_ff:
            tree["dense_mlp"] = L.init_mlp(gen, d, cfg.moe.dense_residual_ff,
                                           cfg.mlp, dtype, cfg.n_layers,
                                           device)
    else:
        tree["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.mlp, dtype,
                                 cfg.n_layers, device)
    return tree


def init_tree(cfg: ArchConfig, gen: torch.Generator, device) -> Tree:
    """A seeded parameter tree in the port's layout (see ``AttnLM`` and
    ``HybridLM``), drawn in the reference's init distributions."""
    require_ported(cfg)
    dtype = torch_dtype(cfg.dtype)
    tree: Tree = {}
    if cfg.embed_inputs:
        tree["embed"] = L.trunc_normal(gen, (cfg.vocab, cfg.d_model),
                                       cfg.d_model ** -0.5, dtype, device)
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.trunc_normal(gen, (cfg.d_model, cfg.vocab),
                                         cfg.d_model ** -0.5, dtype, device)
    tree["final_norm"] = L.init_norm(cfg.d_model, cfg.norm, dtype, device)
    if cfg.family != "hybrid":
        tree["layers"] = [_attn_block_tree(cfg, gen, dtype, device)
                          for _ in range(cfg.n_layers)]
        return tree

    def mamba_layer():
        return {"norm": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
                "mamba": M2.init_mamba2(gen, cfg.d_model, cfg.ssm, dtype,
                                        cfg.n_layers, device)}

    n_groups, tail = layer_counts(cfg)
    tree["layers"] = [[mamba_layer() for _ in range(cfg.attn_every)]
                      for _ in range(n_groups)]
    tree["tail_layers"] = [mamba_layer() for _ in range(tail)]
    tree["shared_attn"] = _attn_block_tree(cfg, gen, dtype, device)
    return tree


def build(cfg: ArchConfig, tree: Tree) -> LM:
    """The family's model over a tree in the port's layout."""
    return (HybridLM if cfg.family == "hybrid" else AttnLM)(cfg, tree)


def init_params(cfg: ArchConfig, seed: int = 0,
                device: DeviceSpec = None) -> LM:
    """A seeded ``AttnLM`` or ``HybridLM`` (``transformer.init_params``),
    drawn on ``device`` (default the card) from a ``torch.Generator``
    seeded with ``seed``.  The weights differ from JAX's for the same
    seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return build(cfg, init_tree(cfg, gen, dev))


def prefill_accepts(cfg: ArchConfig, n: int) -> bool:
    """Whether ``prefill`` takes a sequence of ``n`` tokens: attention
    needs ``n`` a multiple of ``min(c, n)`` for its q and kv chunks ``c``
    (``layers.flash_attention``), and with an SSM (hybrid) the SSD the same
    of its chunk (``ssd_chunked``)."""
    def fits(c: int) -> bool:
        return not c or n % min(c, n) == 0
    return n > 0 and fits(cfg.q_chunk) and fits(cfg.kv_chunk) and \
        (cfg.ssm is None or fits(cfg.ssm.chunk))


def prefill_len(cfg: ArchConfig, n: int) -> int:
    """The longest prefix of ``n`` tokens that ``prefill`` accepts (0 when
    none does); the rest is decoded token by token."""
    return next((m for m in range(n, 0, -1) if prefill_accepts(cfg, m)), 0)

