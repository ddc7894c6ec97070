"""Model assembly for every architecture family.

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
  ssm (rwkv6)                ``RwkvLM``: ``[norm -> time-mix -> norm ->
                             channel-mix] x L`` (``models/rwkv6.py``); the
                             time-mix is chunked when the length is a
                             multiple of 64, a scan otherwise

vlm and audio take ``embeds`` in place of tokens (``embed_inputs=False``;
their frontends are stubs in the reference too), and ``pos == "sin"``
adds sinusoidal positions at the embedding.  The reference's entry points
are methods of every model:

  ``forward``      <- ``transformer.forward``      (logits f32, moe aux)
  ``prefill``      <- ``transformer.prefill``      (logits, serving cache)
  ``init_cache``   <- ``transformer.init_cache``
  ``decode_step``  <- ``transformer.decode_step``  (updates the cache in place)

and ``lm_loss`` (``transformer.lm_loss``) is a function of a model and a
batch.  ``init_params`` builds a seeded model of the config's family (a
``torch.Generator`` on the target device).  ``AttnLM.forward`` and
``prefill`` take ``capacity_factor`` (default the MoE config's, as
``moe_ffn`` has); ``decode_step`` runs the MoE drop-free (``E / k``), as
the reference's decode does (``transformer.py:393-395``).

The serving caches have the reference's layout, batch at the same axis of
every leaf (``BATCH_AXIS``):

  ``kv``          {"k": (L, B, T, Hkv, D), "v": ...} for ``AttnLM``, one
                  per layer; (G, B, T, Hkv, D) for ``HybridLM``, one per
                  application of the shared block
  ``mamba``       {"conv": (G, A, B, K-1, C), "ssm": (G, A, B, H, S, P)}
  ``mamba_tail``  {"conv": (tail, B, K-1, C), "ssm": (tail, B, H, S, P)}
  ``rwkv``        {"tm_x": (L, B, 1, d), "cm_x": (L, B, 1, d),
                   "s": (L, B, H, 64, 64) f32}

``decode_step`` writes into that cache in place (the reference returns an
updated copy), which is what lets ``serve.engine`` decode one slot over a
view of its rows.  The head computes in f32 as the reference's
``preferred_element_type=F32`` does (``unembed``): operands go up to f32,
a copy of the head per call.  That copy is kept, because it changes no
bit of the logits and is a small share of a decode step (qwen2.5-3b at 2
slots on an H100: 0.94 ms of device time in a 66 ms step, PERF.md §5).

Parameters are frozen (``requires_grad=False``) unless the model is built
with ``trainable=True``, as ``train/step.py`` does.  Where the config's
``remat_policy`` is ``"nothing_saveable"`` (every full-width config) and
gradients are being recorded, each scanned body of the reference (a
layer; for the hybrid a group and each tail layer) runs under
``torch.utils.checkpoint`` and is recomputed in the backward, as the
reference's ``_remat`` does.  The model calls ``parallel.ctx.constrain``
where the reference does (the identity without installed hooks).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, \
    Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceSpec, resolve_device, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.parallel import ctx

F32 = torch.float32
Tree = Dict[str, Any]
BATCH_AXIS = {"mamba": 2, "kv": 1, "mamba_tail": 1, "rwkv": 1}  # per leaf
FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")
AUX_LOSS_WEIGHT = 0.01
RWKV_CHUNKED = 64         # lengths the chunked time-mix runs (else a scan)


def attn_spec(cfg: ArchConfig) -> L.AttnSpec:
    return L.AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                      qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
                      rope_theta=cfg.rope_theta, use_rope=(cfg.pos == "rope"))


def _remat(fn: Callable, cfg: ArchConfig) -> Callable:
    """``fn`` under activation checkpointing when gradients are being
    recorded and the config asks for it (the reference's ``_remat``):
    ``"nothing_saveable"`` saves only the body's inputs and recomputes the
    rest in the backward; ``"none"`` saves everything."""
    if cfg.remat_policy == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat_policy != "nothing_saveable":
        raise ValueError(f"{cfg.name}: remat_policy {cfg.remat_policy!r} "
                         f"has no counterpart; use 'none' or "
                         f"'nothing_saveable'")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


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
        # F.embedding's backward sums repeated tokens in a fixed order (the
        # CPU's backward of ``embed[tokens]`` does not: a restarted run
        # would not reproduce its gradients bit for bit)
        x = F.embedding(tokens, self.embed) if cfg.embed_inputs \
            else embeds.to(self.dtype)
        if cfg.pos == "sin":
            pos = torch.arange(x.shape[1], device=x.device) \
                if position is None else position[:, None]
            x = x + L.sin_embedding(pos, cfg.d_model).to(x.dtype)
        return ctx.constrain(x, "residual")

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and head; logits in f32 (the reference's
        preferred_element_type=F32: operands go up to f32)."""
        x = L.apply_norm(self.final_norm, x, self.cfg.norm)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return ctx.constrain(x.float() @ head.float(), "logits")


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
            x, a = _remat(layer, self.cfg)(ctx.constrain(x, "residual"),
                                           capacity_factor)
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
            x = _remat(self._group, self.cfg)(ctx.constrain(x, "residual"),
                                              group)
        for layer in self.tail:
            x = _remat(layer, self.cfg)(x)
        return self.unembed(x), torch.zeros((), dtype=F32, device=x.device)

    def _group(self, x: torch.Tensor, group: nn.ModuleList) -> torch.Tensor:
        """One group: its Mamba2 layers, then the shared block."""
        for layer in group:
            x = layer(x)
        return self.shared(x)[0]

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


class RwkvLayer(nn.Module):
    """norm -> time-mix -> norm -> channel-mix, with residuals
    (``_apply_rwkv_layer``); ``mix`` holds both mixes' parameters."""

    def __init__(self, cfg: ArchConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _frozen(tree["ln1"])
        self.ln2 = _frozen(tree["ln2"])
        self.mix = _frozen(tree["mix"])

    def prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
        """The layer over a whole sequence from a zero state (chunked when
        its length is a multiple of 64), and the serving state after it:
        the last normed inputs of both token shifts and S."""
        b, l, d = x.shape
        tail = x.new_zeros(b, 1, d)
        s0 = torch.zeros(b, d // R6.HEAD_SIZE, R6.HEAD_SIZE, R6.HEAD_SIZE,
                         dtype=F32, device=x.device)
        h = L.apply_norm(self.ln1, x, self.cfg.norm)
        timemix = R6.rwkv6_timemix_chunked if l % RWKV_CHUNKED == 0 \
            else R6.rwkv6_timemix_scan
        y, s_fin = timemix(self.mix, h, tail, s0)
        x = x + y
        h2 = L.apply_norm(self.ln2, x, self.cfg.norm)
        x = x + R6.rwkv6_channelmix(self.mix, h2, tail)
        return x, {"tm_x": h[:, -1:], "cm_x": h2[:, -1:], "s": s_fin}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prefill(x)[0]

    def step(self, x: torch.Tensor, tm_x: torch.Tensor, cm_x: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
        """One decode token (a one-step scan); ``tm_x``/``cm_x``/``s`` are
        this layer's state rows, overwritten with the new state."""
        h = L.apply_norm(self.ln1, x, self.cfg.norm)
        y, s_new = R6.rwkv6_timemix_scan(self.mix, h, tm_x, s)
        x = x + y
        h2 = L.apply_norm(self.ln2, x, self.cfg.norm)
        x = x + R6.rwkv6_channelmix(self.mix, h2, cm_x)
        tm_x.copy_(h)
        cm_x.copy_(h2)
        s.copy_(s_new)
        return x


class RwkvLM(_LM):
    """The ssm family (rwkv6): ``[norm -> time-mix -> norm -> channel-mix]
    x L`` over a tree in the port's layout ``{"embed", "lm_head",
    "final_norm": {...}, "layers": [{"ln1", "ln2", "mix"}] * n_layers}``.
    The serving cache is ``{"rwkv": {"tm_x": (L, B, 1, d), "cm_x": (L, B,
    1, d), "s": (L, B, H, 64, 64) f32}}``; no sequence axis, so
    ``max_len`` bounds nothing but the engine's positions."""

    def __init__(self, cfg: ArchConfig, tree: Tree):
        super().__init__(cfg, tree)
        self.layers = nn.ModuleList(RwkvLayer(cfg, lt)
                                    for lt in tree["layers"])

    def forward(self, tokens=None, embeds=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits fp32 (B,S,V), total moe aux loss = 0)."""
        x = self.embed_inputs(tokens, embeds)
        for layer in self.layers:
            x = _remat(layer, self.cfg)(ctx.constrain(x, "residual"))
        return self.unembed(x), torch.zeros((), dtype=F32, device=x.device)

    def prefill(self, tokens=None, embeds=None
                ) -> Tuple[torch.Tensor, Tree]:
        """Full-sequence pass that also emits the serving state: (logits
        (B,S,V), cache)."""
        x = self.embed_inputs(tokens, embeds)
        states = []
        for layer in self.layers:
            x, st = layer.prefill(x)
            states.append(st)
        cache = {"rwkv": {key: torch.stack([st[key] for st in states])
                          for key in ("tm_x", "cm_x", "s")}}
        return self.unembed(x), cache

    def init_cache(self, bsz: int, max_len: int) -> Tree:
        """A zeroed serving state for ``bsz`` sequences, on the model's
        device (``max_len`` is unused: the state has no sequence axis)."""
        st = R6.rwkv6_init_state(bsz, self.cfg.d_model, self.dtype,
                                 self.device)
        return {"rwkv": {k: t.new_zeros((self.cfg.n_layers,) + t.shape)
                         for k, t in st.items()}}

    def decode_step(self, cache: Tree, position: torch.Tensor, *,
                    tokens=None, embeds=None) -> Tuple[torch.Tensor, Tree]:
        """One-token decode.  tokens: (B, 1); position: (B,) (used only by
        sinusoidal positions).  Returns (logits (B, 1, V), cache) — the
        cache updated in place."""
        x = self.embed_inputs(tokens, embeds, position)
        st = cache["rwkv"]
        for li, layer in enumerate(self.layers):
            x = layer.step(x, st["tm_x"][li], st["cm_x"][li], st["s"][li])
        return self.unembed(x), cache


LM = Union[AttnLM, HybridLM, RwkvLM]


def lm_loss(model: LM, batch: Mapping[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL of ``batch`` (``{"tokens"|"embeds", "labels"}``)
    plus ``AUX_LOSS_WEIGHT`` times the MoE load-balance loss summed over
    layers (``transformer.lm_loss``).  Returns (total, {"ce_loss",
    "moe_aux"})."""
    logits, aux = model(tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"))
    logp = torch.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, -1, batch["labels"][..., None].long())[..., 0]
    loss = nll.mean()
    return loss + AUX_LOSS_WEIGHT * aux, {"ce_loss": loss, "moe_aux": aux}


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
    """A seeded parameter tree in the port's layout (see ``AttnLM``,
    ``HybridLM`` and ``RwkvLM``), drawn in the reference's init
    distributions."""
    check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    tree: Tree = {}
    if cfg.embed_inputs:
        tree["embed"] = L.trunc_normal(gen, (cfg.vocab, cfg.d_model),
                                       cfg.d_model ** -0.5, dtype, device)
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.trunc_normal(gen, (cfg.d_model, cfg.vocab),
                                         cfg.d_model ** -0.5, dtype, device)
    tree["final_norm"] = L.init_norm(cfg.d_model, cfg.norm, dtype, device)
    if cfg.family == "ssm":
        tree["layers"] = [
            {"ln1": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
             "ln2": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
             "mix": R6.init_rwkv6_layer(gen, cfg.d_model, cfg.d_ff, dtype,
                                        cfg.n_layers, device)}
            for _ in range(cfg.n_layers)]
        return tree
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


def check_family(cfg: ArchConfig) -> None:
    """Raises ``ValueError`` for a family the port does not know."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def build(cfg: ArchConfig, tree: Tree, trainable: bool = False) -> LM:
    """The family's model over a tree in the port's layout, its parameters
    frozen unless ``trainable``."""
    check_family(cfg)
    cls = {"hybrid": HybridLM, "ssm": RwkvLM}.get(cfg.family, AttnLM)
    return cls(cfg, tree).requires_grad_(trainable)


def init_params(cfg: ArchConfig, seed: int = 0, device: DeviceSpec = None,
                trainable: bool = False) -> LM:
    """A seeded ``AttnLM``, ``HybridLM`` or ``RwkvLM``
    (``transformer.init_params``), drawn on ``device`` (default the card)
    from a ``torch.Generator`` seeded with ``seed``, its parameters frozen
    unless ``trainable``.  The weights differ from JAX's for the same
    seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return build(cfg, init_tree(cfg, gen, dev), trainable)


def prefill_accepts(cfg: ArchConfig, n: int) -> bool:
    """Whether ``prefill`` takes a sequence of ``n`` tokens: attention
    needs ``n`` a multiple of ``min(c, n)`` for its q and kv chunks ``c``
    (``layers.flash_attention``), and with an SSM (hybrid) the SSD the same
    of its chunk (``ssd_chunked``); rwkv6 takes any ``n`` (a scan where the
    chunked time-mix does not fit)."""
    def fits(c: int) -> bool:
        return not c or n % min(c, n) == 0
    if cfg.family == "ssm":
        return n > 0
    return n > 0 and fits(cfg.q_chunk) and fits(cfg.kv_chunk) and \
        (cfg.ssm is None or fits(cfg.ssm.chunk))


def prefill_len(cfg: ArchConfig, n: int) -> int:
    """The prefix of ``n`` tokens that ``serve.engine`` prefills (0 when
    none); the rest is decoded token by token.  For attention and the
    hybrid, the longest prefix ``prefill`` accepts; for rwkv6, which
    accepts any length, the longest multiple of 64, which runs the chunked
    time-mix (a scan prefill walks every token of every layer in a Python
    loop, as decoding does)."""
    if cfg.family == "ssm":
        return n - n % RWKV_CHUNKED
    return next((m for m in range(n, 0, -1) if prefill_accepts(cfg, m)), 0)
