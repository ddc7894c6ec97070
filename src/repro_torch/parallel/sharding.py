"""Sharding rules as data (port of ``repro.parallel.sharding``).

The reference maps every parameter, batch and cache leaf to a
``PartitionSpec`` over a ("data", "model") mesh: FSDP over the data axes
and Megatron TP over "model", with its multi-grained choices (expert- vs
tensor-parallel MoE, head- vs sequence-sharded KV cache, batch- vs
sequence-sharded long decode).  Here a spec is a plain tuple with one
entry per dimension: ``None`` (replicated), an axis name, or a tuple of
axis names (``P`` spells it as ``PartitionSpec`` does).  The functions return the reference's specs for the same
leaves and mesh, so the rules can be held to it now and applied when the
port shards over ``torch.distributed`` (ROADMAP §1 item 6); at one device
every spec is inert.

Parameter trees are nested dicts or the model's flat
``named_parameters()`` names (``"layers.0.attn.wq"``): each key is split
at dots, and the rule is looked up by the last name, as the reference's
by the last key of the path.  The port keeps layers unstacked, so its
leaves lack the reference's leading layer axes and their specs lack the
leading ``None``s.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.configs.base import SHAPES, ArchConfig

Spec = Tuple[Any, ...]

# Logical param rules: leaf name -> spec for the BASE (unstacked) shape using
# logical axes: "tp" -> 'model', "fsdp" -> the data axes, None -> replicated.
_BASE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("tp", "fsdp"), "lm_head": ("fsdp", "tp"),
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    "q_norm": (None,), "k_norm": (None,),
    "w_up": ("fsdp", "tp"), "w_gate": ("fsdp", "tp"), "w_down": ("tp", "fsdp"),
    "router": ("fsdp", None),
    "in_proj": ("fsdp", "tp"), "out_proj": ("tp", "fsdp"),
    # mamba2's depthwise conv weight is stored (width, channels): "tp" on
    # the channel dim is an out-channel partition
    "conv_w": (None, "tp"),
    "A_log": (None,), "D": (None,), "dt_bias": (None,),
    "norm_scale": ("fsdp",),
    "wr": ("fsdp", "tp"), "wg": ("fsdp", "tp"),
    "cm_wk": ("fsdp", "tp"), "cm_wv": ("tp", "fsdp"), "cm_wr": ("fsdp", "tp"),
    "lora_A": ("fsdp", None), "lora_B": (None, None, "fsdp"),
    "w_lora_A": ("fsdp", None), "w_lora_B": (None, "fsdp"),
    "mu": (None, None), "mu_base": (None,), "w0": (None,), "u": (None, None),
    "ln_x_scale": (None,), "cm_mu_k": (None,), "cm_mu_r": (None,),
    "scale": ("fsdp",), "bias": ("fsdp",),
}
_MOE_EP_RULES = {  # experts >= model axis: expert parallelism
    "w_up": ("tp", None, "fsdp"), "w_gate": ("tp", None, "fsdp"),
    "w_down": ("tp", "fsdp", None),
}
_MOE_TP_RULES = {  # experts < model axis: TP inside each expert
    "w_up": (None, "fsdp", "tp"), "w_gate": (None, "fsdp", "tp"),
    "w_down": (None, "tp", "fsdp"),
}


def P(*axes) -> Spec:
    """A spec as JAX's ``PartitionSpec`` spells it: one entry per dim, a
    one-axis tuple written as the axis name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in axes)


def model_axis_size(mesh) -> int:
    return mesh.shape["model"]


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def dp_size(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in dp_axes(mesh)]))


def _axes_size(mesh, ax) -> int:
    axes = ax if isinstance(ax, tuple) else (ax,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _logical_to_mesh(axis: Optional[str], mesh, tp: bool = True):
    """fsdp spans every DP axis; ``tp=False`` (the small-scene grain) makes
    'model' a data axis too and shards nothing over it as TP."""
    if axis == "tp":
        return "model" if tp else None
    if axis == "fsdp":
        dp = dp_axes(mesh) + (() if tp else ("model",))
        return dp if len(dp) > 1 else dp[0]
    return None


def _map_tree(tree: Mapping, fn) -> Dict[str, Any]:
    """``tree``'s structure with each leaf replaced by ``fn(names, leaf)``."""
    def rec(node, names):
        return {key: rec(sub, names + tuple(str(key).split(".")))
                if isinstance(sub, Mapping) else
                fn(names + tuple(str(key).split(".")), sub)
                for key, sub in node.items()}
    return rec(tree, ())


def param_pspecs(cfg: ArchConfig, params: Mapping, mesh,
                 tp: bool = True) -> Dict[str, Any]:
    """A spec tree mirroring ``params`` (tensors or anything with a
    ``shape``)."""
    msize = model_axis_size(mesh)
    moe_ep = cfg.moe is not None and cfg.moe.n_experts >= msize

    def spec_for(names, leaf) -> Spec:
        name = names[-1]
        rules = _BASE_RULES
        if "moe" in names and name in ("w_up", "w_gate", "w_down"):
            rules = _MOE_EP_RULES if moe_ep else _MOE_TP_RULES
        base = rules.get(name)
        if base is None:
            return ()
        shape = tuple(leaf.shape)
        extra = len(shape) - len(base)
        if extra < 0:
            raise ValueError(f"param {'/'.join(names)} shape {shape} has "
                             f"fewer dims than its sharding rule {base}")
        full = (None,) * extra + tuple(_logical_to_mesh(a, mesh, tp)
                                       for a in base)
        # no sharding on a dim the mesh cannot divide (e.g. rwkv 'u' heads)
        return P(*(a if a is None or shape[i] % _axes_size(mesh, a) == 0
                   else None for i, a in enumerate(full)))

    return _map_tree(params, spec_for)


def batch_pspecs(cfg: ArchConfig, shape_name: str, mesh,
                 tp: bool = True) -> Dict[str, Spec]:
    """Input specs for one (arch x shape) cell."""
    spec = SHAPES[shape_name]
    b = spec["global_batch"]
    dp = dp_axes(mesh) + (() if tp else ("model",))
    sz = int(np.prod([mesh.shape[a] for a in dp]))
    bs = dp if b % sz == 0 else None
    out: Dict[str, Spec] = {}
    inputs = "tokens" if cfg.embed_inputs else "embeds"
    out[inputs] = P(bs, None) if cfg.embed_inputs else P(bs, None, None)
    if spec["kind"] == "train":
        out["labels"] = P(bs, None)
    elif spec["kind"] == "decode":
        out["position"] = P(bs)
    return out


def cache_pspecs(cfg: ArchConfig, shape_name: str, mesh) -> Dict[str, Any]:
    """Multi-grained KV/state cache specs for decode cells."""
    b = SHAPES[shape_name]["global_batch"]
    dp = dp_axes(mesh)
    bs = dp if b % dp_size(mesh) == 0 else None
    msize = model_axis_size(mesh)
    if cfg.family == "ssm":
        return {"rwkv": {"tm_x": P(None, bs, None, None),
                         "cm_x": P(None, bs, None, None),
                         "s": P(None, bs, "model", None, None)}}
    if cfg.family not in ("dense", "moe", "vlm", "audio", "hybrid"):
        raise ValueError(cfg.family)
    if cfg.n_kv_heads >= msize and cfg.n_kv_heads % msize == 0:
        # head-sharded; with an unshardable batch the seq dim takes 'data'
        kv = P(None, bs, None if bs else "data", "model", None)
    else:                                         # sequence-sharded
        kv = P(None, bs, "model" if bs else ("data", "model"), None, None)
    out: Dict[str, Any] = {"kv": {"k": kv, "v": kv}}
    if cfg.family == "hybrid":
        out["mamba"] = {"conv": P(None, None, bs, None, "model"),
                        "ssm": P(None, None, bs, "model", None, None)}
        if cfg.n_layers % cfg.attn_every:
            out["mamba_tail"] = {"conv": P(None, bs, None, "model"),
                                 "ssm": P(None, bs, "model", None, None)}
    return out


def sanitize_pspecs(spec_tree: Mapping, shape_tree: Mapping, mesh
                    ) -> Dict[str, Any]:
    """Drop spec axes that do not divide the corresponding dim."""
    def fix(spec: Spec, leaf) -> Spec:
        dims = tuple(leaf.shape)
        full = tuple(spec) + (None,) * (len(dims) - len(spec))
        return P(*(None if ax is None or dims[i] % _axes_size(mesh, ax)
                   else ax for i, ax in enumerate(full)))

    return {k: sanitize_pspecs(s, shape_tree[k], mesh)
            if isinstance(s, Mapping) else fix(s, shape_tree[k])
            for k, s in spec_tree.items()}
