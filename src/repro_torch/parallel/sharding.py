"""Sharding rules as data (port of ``repro.parallel.sharding``).

The reference maps every parameter, batch and cache leaf to a
``PartitionSpec`` over a ("data", "model") mesh: FSDP over the data axes
and Megatron TP over "model", with its multi-grained choices (expert- vs
tensor-parallel MoE, head- vs sequence-sharded KV cache, batch- vs
sequence-sharded long decode).  Here a spec is a plain tuple with one
entry per dimension: ``None`` (replicated), an axis name, or a tuple of
axis names (``P`` spells it as ``PartitionSpec`` does).  The functions
return the reference's specs for the same leaves and mesh; at one device
every spec is inert.

The specs are realised on a ring of ``torch.device``s that one process
drives (``launch.mesh.Mesh``; ``parallel/ring.py`` runs the LM path on
it).  A mesh position is a flat index into ``mesh.devices`` (row-major
over ``mesh.axis_names``); a dim sharded over axes ``(a, b)`` is split
into ``|a| * |b|`` equal blocks, block ``i_a * |b| + i_b`` at the
position with coordinates ``(i_a, i_b)``, as ``NamedSharding`` splits
it.  ``shard_tree`` lays a tree of global leaves out as one tree of local
slices per position, each slice in its own storage on its position's
device (a ring may repeat a device, and an in-place update of a shared
storage would run once per position); ``gather_tree`` concatenates them
back.  The ring's collectives (``all_gather``, ``reduce_scatter``,
``all_reduce``) sum in a fixed member order with f32 accumulation and
count the bytes of their results, one count per receiving member, in the
``repro.mesh.<kind>_bytes`` counters of ``obs.metrics.default_metrics``
(the reference's dry run counts the same: each collective's result
bytes per chip).

Parameter trees are nested dicts or the model's flat
``named_parameters()`` names (``"layers.0.attn.wq"``): each key is split
at dots, and the rule is looked up by the last name, as the reference's
by the last key of the path.  The port keeps layers unstacked, so its
leaves lack the reference's leading layer axes and their specs lack the
leading ``None``s.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.obs.metrics import default_metrics

Spec = Tuple[Any, ...]
RWKV_HEAD_SIZE = 64         # models/rwkv6.HEAD_SIZE

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
    return cache_pspecs_for_batch(cfg, SHAPES[shape_name]["global_batch"],
                                  mesh)


def cache_pspecs_for_batch(cfg: ArchConfig, b: int, mesh) -> Dict[str, Any]:
    """``cache_pspecs`` for a cache of ``b`` sequences."""
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


def cache_shapes(cfg: ArchConfig, b: int, max_len: int) -> Dict[str, Any]:
    """The global shapes of a serving cache of ``b`` sequences of up to
    ``max_len`` tokens, in the tree of ``cache_pspecs`` (the one-device
    ``init_cache`` of ``models/transformer.py``): ``kv`` (L, or the
    hybrid's groups G, B, T, Hkv, D); the hybrid's ``mamba`` (G, A, B,
    K-1, C) conv and (G, A, B, H, S, P) ssm and its ``mamba_tail``;
    rwkv6's ``rwkv`` (L, B, 1, d) token shifts and (L, B, H, 64, 64)
    state.  A ring holds the recurrent leaves by head, not by these specs'
    storage blocks (``parallel/ring.py``, ``MeshCache``)."""
    if cfg.family == "ssm":
        h = cfg.d_model // RWKV_HEAD_SIZE
        x = (cfg.n_layers, b, 1, cfg.d_model)
        return {"rwkv": {"tm_x": x, "cm_x": x,
                         "s": (cfg.n_layers, b, h, RWKV_HEAD_SIZE,
                               RWKV_HEAD_SIZE)}}
    n_att = cfg.n_layers
    if cfg.family == "hybrid":
        n_att, tail = divmod(cfg.n_layers, cfg.attn_every)
    kv = (n_att, b, max_len, cfg.n_kv_heads, cfg.d_head)
    out: Dict[str, Any] = {"kv": {"k": kv, "v": kv}}
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        di = ssm.expand * cfg.d_model
        nh = di // ssm.head_dim
        conv = (b, ssm.conv_kernel - 1, di + 2 * ssm.n_groups * ssm.state)
        state = (b, nh, ssm.state, ssm.head_dim)
        out["mamba"] = {"conv": (n_att, cfg.attn_every) + conv,
                        "ssm": (n_att, cfg.attn_every) + state}
        if tail:
            out["mamba_tail"] = {"conv": (tail,) + conv,
                                 "ssm": (tail,) + state}
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


# ---------------------------------------------------------------------------
# Realising specs on a ring
# ---------------------------------------------------------------------------
COLLECTIVE_KINDS = ("all_gather", "reduce_scatter", "all_reduce")
F32 = torch.float32


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``()`` for a replicated dim)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def coords(mesh, pos: int) -> Dict[str, int]:
    """Axis name -> index of flat mesh position ``pos``."""
    idx = np.unravel_index(pos, mesh.devices.shape)
    return dict(zip(mesh.axis_names, (int(i) for i in idx)))


def position(mesh, crd: Mapping[str, int]) -> int:
    """The flat position of ``crd`` (every axis named)."""
    return int(np.ravel_multi_index(tuple(crd[a] for a in mesh.axis_names),
                                    mesh.devices.shape))


def device_of(mesh, pos: int) -> torch.device:
    return mesh.devices.reshape(-1)[pos]


def _block(axes: Tuple[str, ...], crd: Mapping[str, int], mesh
           ) -> Tuple[int, int]:
    """(block index, block count) of a dim split over ``axes`` at
    ``crd``: row-major over ``axes``."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + crd[a]
        n *= mesh.shape[a]
    return idx, n


def _full(spec, ndim: int) -> Tuple[Any, ...]:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def check_divides(name: str, spec, shape, mesh) -> None:
    """Raises ``ValueError`` naming the leaf and the axes where a spec
    entry does not divide its dim: a ring never replicates in its
    place."""
    for i, entry in enumerate(_full(spec, len(shape))):
        axes = spec_axes(entry)
        n = _axes_size(mesh, axes) if axes else 1
        if shape[i] % n:
            raise ValueError(f"{name}: dim {i} of {tuple(shape)} does not "
                             f"divide over mesh axes {axes} ({n})")


def local_slices(spec, shape, mesh, pos: int) -> Tuple[slice, ...]:
    """The slice of a global leaf of ``shape`` that position ``pos``
    holds under ``spec``."""
    crd = coords(mesh, pos)
    out = []
    for i, entry in enumerate(_full(spec, len(shape))):
        axes = spec_axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        idx, n = _block(axes, crd, mesh)
        size = shape[i] // n
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def local_shape(spec, shape, mesh) -> Tuple[int, ...]:
    return tuple(d // (_axes_size(mesh, spec_axes(e)) if spec_axes(e) else 1)
                 for d, e in zip(shape, _full(spec, len(shape))))


def _own_copy(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """``t`` copied into a new contiguous storage on ``device``."""
    out = torch.empty(t.shape, dtype=dtype or t.dtype, device=device)
    with torch.no_grad():
        return out.copy_(t)


def shard_leaf(leaf: torch.Tensor, spec, mesh,
               positions: Optional[Sequence[int]] = None, name: str = "leaf"
               ) -> List[torch.Tensor]:
    """``leaf``'s local slice at each of ``positions`` (default every
    position), each in its own storage on its position's device."""
    check_divides(name, spec, leaf.shape, mesh)
    positions = range(mesh.size) if positions is None else positions
    return [_own_copy(leaf[local_slices(spec, leaf.shape, mesh, p)],
                      device_of(mesh, p)) for p in positions]


def _flat_items(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree: Mapping, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def shard_tree(tree: Mapping, specs: Mapping, mesh,
               positions: Optional[Sequence[int]] = None) -> List[Dict]:
    """One tree of local slices per mesh position (default every
    position, in mesh order), each mirroring ``tree`` (nested dicts or a
    flat ``{name: tensor}``) and laid out by the spec tree ``specs``."""
    positions = list(range(mesh.size) if positions is None else positions)
    out: List[Dict] = [{} for _ in positions]
    for path, leaf in _flat_items(tree):
        parts = shard_leaf(leaf, _get(specs, path), mesh, positions,
                           "/".join(map(str, path)))
        for tr, part in zip(out, parts):
            _set(tr, path, part)
    return out


def gather_leaf(parts: Mapping[int, torch.Tensor], spec, shape, mesh,
                device, receiver: int = 0,
                axes: Optional[Sequence[str]] = None,
                stride: Optional[Sequence[int]] = None,
                count: bool = True) -> torch.Tensor:
    """The leaf assembled on ``device`` from ``parts`` (position -> local
    slice) over the mesh ``axes`` of ``spec`` (default all): the dims
    split over other axes stay split as at ``receiver``, whose coordinates
    pick the parts on every axis not gathered.  ``stride`` lays the result
    out as given (default contiguous).  Where only the receiver's part is
    held (a representative trace on ``meta``), the result is an empty
    tensor of the gathered shape.  Counted as one all-gather received by
    one member when it gathers over more than one position."""
    full = _full(spec, len(shape))
    axes = set(mesh.axis_names if axes is None else axes)
    crd0 = coords(mesh, receiver)
    gather_dims = []
    out_shape = list(local_shape(spec, shape, mesh))
    for i, entry in enumerate(full):
        ax = spec_axes(entry)
        if ax and set(ax) <= axes:
            gather_dims.append((i, ax))
            out_shape[i] = shape[i]
        elif set(ax) & axes:
            raise ValueError(f"spec entry {entry} mixes gathered and kept "
                             f"axes {sorted(axes)}")
    first = next(iter(parts.values()))
    dtype = first.dtype
    if stride is None:
        out = torch.empty(out_shape, dtype=dtype, device=device)
    else:
        out = torch.empty_strided(out_shape, tuple(stride), dtype=dtype,
                                  device=device)
    n_parts = int(np.prod([_axes_size(mesh, ax) for _, ax in gather_dims]))
    combos = itertools.product(*[
        itertools.product(*[range(mesh.shape[a]) for a in ax])
        for _, ax in gather_dims])
    if len(parts) == 1 and n_parts > 1:
        combos = ()                 # a representative trace: shapes only
        if out.device.type != "meta":
            raise KeyError(f"a gather over {n_parts} positions holds one")
    with torch.no_grad():
        for combo in combos:
            crd = dict(crd0)
            region = [slice(None)] * len(shape)
            for (i, ax), idx in zip(gather_dims, combo):
                crd.update(zip(ax, idx))
                b, n = _block(ax, crd, mesh)
                size = shape[i] // n
                region[i] = slice(b * size, (b + 1) * size)
            p = position(mesh, crd)
            if p not in parts:
                if out.device.type != "meta":
                    raise KeyError(f"position {p} holds no part")
                continue
            out[tuple(region)].copy_(parts[p])
    if count and n_parts > 1:
        record("all_gather", out.numel() * out.element_size())
    return out


def gather_tree(shards: Sequence[Mapping], specs: Mapping, mesh,
                device=None) -> Dict:
    """The global tree of ``shard_tree``'s output (one tree per position,
    in mesh order), each leaf on ``device`` (default position 0's)."""
    device = device_of(mesh, 0) if device is None else device
    out: Dict = {}
    for path, _ in _flat_items(shards[0]):
        parts = {p: _get(tr, path) for p, tr in enumerate(shards)}
        spec = _get(specs, path)
        first = parts[0]
        shape = tuple(d * (_axes_size(mesh, spec_axes(e)) if spec_axes(e)
                           else 1)
                      for d, e in zip(first.shape, _full(spec, first.dim())))
        _set(out, path, gather_leaf(parts, spec, shape, mesh, device,
                                    count=False))
    return out


# -- collectives --------------------------------------------------------------
def record(kind: str, nbytes: int) -> None:
    """Count one collective of ``kind`` whose results total ``nbytes``
    over the members that received them."""
    m = default_metrics()
    m.counter(f"repro.mesh.{kind}").inc()
    m.counter(f"repro.mesh.{kind}_bytes").inc(nbytes)


def collective_bytes() -> Dict[str, int]:
    """The ``repro.mesh.<kind>_bytes`` counters now (callers take
    differences around a step)."""
    m = default_metrics()
    return {k: int(m.value(f"repro.mesh.{k}_bytes")) for k in
            COLLECTIVE_KINDS}


def collective_calls() -> Dict[str, int]:
    """The ``repro.mesh.<kind>`` call counters now."""
    m = default_metrics()
    return {k: int(m.value(f"repro.mesh.{k}")) for k in COLLECTIVE_KINDS}


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def _ordered_sum(parts: Sequence[torch.Tensor], device, dtype
                 ) -> torch.Tensor:
    """``sum(parts)`` on ``device`` in list order, accumulated in f32 and
    rounded once to ``dtype``."""
    acc = _own_copy(parts[0], device, F32)
    for t in parts[1:]:
        acc.add_(t.to(device=device, dtype=F32))
    return acc.to(dtype)


def _fabricate(x: torch.Tensor, shape) -> torch.Tensor:
    """A representative trace's stand-in for the parts no member held:
    an empty result of the collective's shape (``meta`` only)."""
    if x.device.type != "meta":
        raise ValueError("a collective over fewer members than its group "
                         "runs only on meta (a representative trace)")
    return x.new_empty(shape)


def _split(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, n, *xs):
        ctx.dim, ctx.n = dim, n
        ctx.devices = [x.device for x in xs]
        shape = list(xs[0].shape)
        shape[dim] *= n
        if len(xs) < n:
            outs = [_fabricate(x, shape) for x in xs]
        else:
            outs = [torch.cat([x.to(d) for x in xs], dim)
                    for d in ctx.devices]
        record("all_gather", _nbytes(shape, xs[0].dtype) * len(xs))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + _reduce_scatter(gs, ctx.dim, ctx.n,
                                              ctx.devices)


def _reduce_scatter(xs, dim: int, n: int, devices) -> tuple:
    shape = list(xs[0].shape)
    shape[dim] //= n
    if len(xs) < n:
        outs = tuple(_fabricate(x, shape) for x in xs)
    else:
        outs = tuple(_ordered_sum([_split(x, dim, n, j) for x in xs], d,
                                  xs[0].dtype)
                     for j, d in enumerate(devices))
    record("reduce_scatter", _nbytes(shape, xs[0].dtype) * len(xs))
    return outs


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, n, *xs):
        ctx.dim, ctx.n = dim, n
        return _reduce_scatter(xs, dim, n, [x.device for x in xs])

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + _AllGather.apply(ctx.dim, ctx.n, *gs)


def _all_reduce(xs, n: int) -> tuple:
    if len(xs) < n:
        outs = tuple(_fabricate(x, x.shape) for x in xs)
    else:
        outs = tuple(_ordered_sum(xs, x.device, x.dtype) for x in xs)
    record("all_reduce", _nbytes(xs[0].shape, xs[0].dtype) * len(xs))
    return outs


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, *xs):
        ctx.n = n
        return _all_reduce(xs, n)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + _AllReduce.apply(ctx.n, *gs)


def all_gather(xs: Sequence[torch.Tensor], dim: int, n: int
               ) -> List[torch.Tensor]:
    """Each member's ``xs[i]`` concatenated along ``dim`` in member order,
    one copy per member on its device; the backward is ``reduce_scatter``.
    ``xs`` holds the group's ``n`` members, or one (a representative
    trace on ``meta``)."""
    return list(_AllGather.apply(dim, n, *xs))


def reduce_scatter(xs: Sequence[torch.Tensor], dim: int, n: int
                   ) -> List[torch.Tensor]:
    """Member ``j`` gets block ``j`` along ``dim`` of the members' sum,
    summed in member order in f32; the backward is ``all_gather``."""
    return list(_ReduceScatter.apply(dim, n, *xs))


def all_reduce(xs: Sequence[torch.Tensor], n: int) -> List[torch.Tensor]:
    """The members' sum in member order (f32 accumulation), one copy per
    member; the backward is ``all_reduce`` of the gradients."""
    return list(_AllReduce.apply(n, *xs))


def all_reduce_max(xs: Sequence[torch.Tensor], n: int
                   ) -> List[torch.Tensor]:
    """The members' elementwise maximum, one copy per member (no
    gradient: a softmax's shift)."""
    xs = [x.detach() for x in xs]
    if len(xs) < n:
        outs = [_fabricate(x, x.shape) for x in xs]
    else:
        m = xs[0].clone()
        for x in xs[1:]:
            m = torch.maximum(m, x.to(m.device))
        outs = [_own_copy(m, x.device) for x in xs]
    record("all_reduce", _nbytes(xs[0].shape, xs[0].dtype) * len(xs))
    return outs
