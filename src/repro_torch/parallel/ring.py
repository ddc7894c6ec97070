"""The LM path on a ("data", "model") or ("pod", "data", "model") mesh,
driven by one process over a ring of ``torch.device``s.

The reference runs its LM path as one program under ``NamedSharding``:
GSPMD partitions each step by the specs of ``parallel/sharding.py`` and
inserts the collectives.  There is no such compiler here, so this module
writes the partitioned program out, over the port's own layer functions
(``models/layers.py``, ``models/moe.py``) on local parameters.  One
process holds every shard: the ring may repeat a device (``(cuda:0,) *
4`` runs four shards' real kernels on one card, ``("cpu",) * 4`` runs in
the tests) and runs unchanged on distinct cards.  The collectives are
those of ``parallel/sharding.py``: fixed member order, f32 accumulation,
each one counted in ``repro.mesh.*``.

Parameters are stored by ``sharding.param_pspecs`` (``MeshParams``: one
dict of local slices per mesh position), the AdamW moments mirror them
(``MeshTrainState``), and every step updates each position's slices in
place.  Two grains, as ``train.step.default_plan`` picks them:

  DP grain (``tp=False``, every family)  "model" joins the data axes.
      Every leaf's ``fsdp`` dim is split over all positions (FSDP).  Each
      position runs the model's own ``forward`` and the step's loss on
      its batch slice; each layer's leaves are gathered as the layer is
      entered (again in its checkpointed recomputation) and released as
      it is left, the leaves outside the layers once per position and
      turn.  The gradients reach the stored slices as an ordered sum
      over the turns.  Without MoE a position runs its rows ``[r * b /
      n, (r + 1) * b / n)`` as consecutive microbatches, position-major:
      the order of the one-device step's microbatch accumulator over the
      same rows, so a ring's step equals the one-device step with ``n``
      times the microbatches bit for bit (the reference's layout below
      would gather the leaves outside the layers once per microbatch
      instead).  Where the global batch does not divide over the data
      members (256 rows on a 512-chip mesh), the reference's
      ``batch_pspecs`` replicates it: every member then runs every row,
      and the mean of their equal gradients is one member's.
  TP + SP grain (``tp=True``; every family)  Megatron tensor
      parallelism over "model": each model shard holds ``n_heads / m`` q
      heads (where that does not divide, the first ``n_heads % m`` shards
      one more, the q/o projections gathered whole over "model" and the
      shard's columns taken from them: the reference's ``heads`` hook
      leaves H unsharded there), the k/v heads of those (``n_kv_heads /
      m`` each when that divides, else the k/v projection gathered whole
      and the heads its q heads read taken from it, one per q head where
      they straddle k/v groups), ``d_ff / m`` of the FFN and ``V / m``
      of the vocabulary (the embedding looked up per vocabulary range,
      the logits vocab-sharded under a max-then-ordered-sum cross
      entropy).  vlm and audio start the residual from their ``embeds``
      slice instead of a lookup.  The row-parallel products (``out @
      wo``, ``h @ w_down``) are partial sums over the model shards,
      summed in shard order before the residual add.  MoE layers take
      the reference's two grains (``sharding._MOE_EP_RULES`` /
      ``_MOE_TP_RULES``): with ``n_experts >= m`` shard j holds experts
      ``[j E / m, (j + 1) E / m)`` and runs them on the row's tokens it
      routes there (every shard has them: the residual is gathered over
      "model" before the FFN; the router is replicated), below that each
      shard holds ``d_ff_expert / m`` of every expert; either way the
      shards' f32 partial outputs (plus arctic's column/row-parallel dense
      MLP) are summed in shard order.  Tokens stay on their data row, as
      the reference's GSPMD keeps them (``moe.py:73-77``): no all-to-all.
      The hybrid's Mamba2 layers (zamba2-7b) split by head: shard j holds
      heads ``[j nh / m, (j + 1) nh / m)`` (they must divide), the z, x
      and dt columns of them and every B/C column of ``in_proj`` and the
      x and B/C channels of ``conv_w`` (both gathered whole over "model"
      and cut: their storage blocks are not heads), its rows of
      ``out_proj``; the gated RMSNorm's mean of squares over every head
      is an all-reduce of the shards' f32 sums in shard order, and the
      out_proj partials are summed in f32 and rounded once.  Its shared
      attention block runs as the attention families' blocks do, once
      per group.  rwkv6 splits its time mix by head (``d_model / 64``;
      where they do not divide, the first ``h % m`` shards one more, the
      head-split projections gathered whole and cut), each shard
      computing the token-shift ddlerp whole; the channel mix is
      column-parallel over d_ff into a row-parallel ``cm_wv``, and
      ``cm_wr``'s sigmoid is gathered over "model".  With
      ``seq_shard_activations`` the residual is held sequence-sharded
      over "model" between the sub-blocks (all-gather before attention,
      FFN, Mamba2 and either mix, reduce-scatter after).  The FSDP dim of
      each leaf is gathered over the data axes inside the layer that
      uses it, so activation checkpointing (``_remat``) gathers it again
      for the backward and nothing holds it between layers; its gradient
      is handed, per data row, to the step's ordered accumulator.

MoE routing set.  The reference's microbatch ``i`` is rows ``[i * b /
n_mb, (i + 1) * b / n_mb)`` of the global batch, run as one program over
the data axes, so ``moe_ffn``'s capacity, each (token, slot)'s position
in its expert and the load-balance loss's ``me``/``ce`` are the whole
microbatch's.  For the moe family both grains therefore give data member
``r`` (a position in the DP grain, a data row in TP) block ``i * n + r``
of ``n * n_mb`` and run the microbatch's members as one routing set
(``_RoutingSet``, installed through ``ctx.moe_routing_set``): a
(token, slot)'s position is its local cumulative count plus the
per-expert counts of the members before it, exchanged in member order
(one all-gather of ``n * E`` counts per MoE layer and position, counted).
The loss's gradient at a member needs the set's ``ce``, which depends on
members that run after it, so each microbatch runs twice: a forward pass
without gradients, member after member, that fixes every member's pick
and counts (it holds one member's activations at a time and, per layer
and member, ``T * k`` expert indices), then the pass with gradients,
which replays those picks (the gates recomputed from its own logits)
with the set's totals.  That costs one more forward per microbatch and
no more activation memory; a single data member needs neither.

Serving (``prefill``, ``decode``; the TP grain) lays the KV cache out by
``sharding.cache_pspecs``: head-sharded where the k/v heads divide over
"model" (attention stays local), else sequence-sharded (each shard holds
``T / m`` positions of every k/v head, and decode attention merges the
shards' partial softmaxes in shard order; a shard holding no valid
position yet weighs 0).  A batch that does not divide over the data rows
(``long_500k``'s 1) runs whole on every row, and the k/v's sequence is
split over "data" too (over ("data", "model") in the sequence grain);
the partial softmaxes then merge over the data rows, data-major, and
every row computes the same recurrent step.  The recurrent states are
held by head, not by the specs' storage blocks (``MeshCache``).  MoE
layers serve drop-free (capacity factor ``E / k``, as ``serve.engine``
does), so no row's routing depends on another's.

A ring may hold one representative position (``positions=(0,)``): the
dry run (``launch/dryrun.py``) traces one position of a 256- or 512-chip
mesh on ``meta``, its collectives counted and not executed.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, \
    Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.models import transformer as T
from repro_torch.parallel import ctx
from repro_torch.parallel import sharding as SH
from repro_torch.train import optimizer as opt

F32 = torch.float32
Tensor = torch.Tensor
# leaves a TP shard must hold split over "model" (the dims are heads, the
# FFN hidden, the experts, the vocabulary, Mamba2's out_proj rows or the
# rwkv6 channel mix); q/o and k/v, and rwkv6's time-mix heads, may be
# gathered whole instead, where their heads do not divide
_TP_SPLIT = ("wq", "bq", "wo", "w_up", "w_gate", "w_down", "embed",
             "lm_head", "out_proj", "cm_wk", "cm_wv", "cm_wr")
_Q = ("wq", "bq", "wo")
_KV = ("wk", "wv", "bk", "bv")
# Mamba2 leaves whose storage blocks over "model" are not a shard's heads
# ([z | x | B C | dt] columns, [x | B C] channels): gathered whole
_MAMBA_WHOLE = ("in_proj", "conv_w")
# rwkv6's time-mix leaves: the head-split projections, then the rest
_RWKV_HEADS = ("wr", "wk", "wv", "wg", "wo")
_RWKV_TM = _RWKV_HEADS + ("mu_base", "mu", "lora_A", "lora_B", "w0",
                          "w_lora_A", "w_lora_B", "u", "ln_x_scale")


# ---------------------------------------------------------------------------
# Sharded parameters and state
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class MeshParams:
    """An LM's parameters laid out on ``mesh``: ``shards[i]`` is
    ``{name: local slice}`` of mesh position ``positions[i]`` (every
    position, or one representative), names as ``named_parameters()``
    gives them."""

    cfg: ArchConfig
    mesh: Any
    tp: bool
    specs: Dict[str, tuple]
    shapes: Dict[str, Tuple[int, ...]]
    shards: List[Dict[str, Tensor]]
    positions: Tuple[int, ...]

    @property
    def names(self) -> List[str]:
        return list(self.shapes)

    @property
    def representative(self) -> bool:
        return len(self.positions) < self.mesh.size

    def children(self, prefix: str) -> List[str]:
        """The names of the leaves directly under ``prefix``."""
        if not hasattr(self, "_children"):
            kids: Dict[str, List[str]] = {}
            for n in self.shapes:
                kids.setdefault(n.rpartition(".")[0], []).append(n)
            self._children = kids
        return self._children.get(prefix, [])

    def parts(self, name: str) -> Dict[int, Tensor]:
        return {p: sh[name] for p, sh in zip(self.positions, self.shards)}

    def gather(self, name: str, device, receiver: int = 0,
               axes: Optional[Sequence[str]] = None, stride=None,
               count: bool = True) -> Tensor:
        return SH.gather_leaf(self.parts(name), self.specs[name],
                              self.shapes[name], self.mesh, device,
                              receiver, axes, stride, count)


class MeshTrainState(NamedTuple):
    """A train state on a ring: the parameters' slices and, per held
    position, AdamW moments mirroring them (``state_pspecs``) and its own
    step count."""

    params: MeshParams
    opt: List[opt.OptState]

    def global_state(self, device="cpu"):
        """The state as ``train.step.TrainState`` of global leaves, each
        gathered on ``device`` only when read (``checkpoint.save`` calls
        it): the same leaves, paths and files whatever mesh holds it."""
        from repro_torch.train.step import TrainState
        p = self.params

        def lazy(get):
            return {n: _Lazy(functools.partial(get, n), p.shapes[n])
                    for n in p.names}

        def moment(which, n):
            parts = {pos: getattr(o, which)[n]
                     for pos, o in zip(p.positions, self.opt)}
            return SH.gather_leaf(parts, p.specs[n], p.shapes[n], p.mesh,
                                  device, count=False)

        return TrainState(
            lazy(lambda n: p.gather(n, device, count=False)),
            opt.OptState(lazy(functools.partial(moment, "m")),
                         lazy(functools.partial(moment, "v")),
                         self.opt[0].step))


class _Lazy:
    """A global leaf gathered when called (``checkpoint.save``)."""

    def __init__(self, fn: Callable[[], Tensor], shape):
        self.fn, self.shape = fn, tuple(shape)

    def __call__(self) -> Tensor:
        return self.fn()


def param_specs(cfg: ArchConfig, shapes: Mapping[str, Tuple[int, ...]],
                mesh, tp: bool) -> Dict[str, tuple]:
    """``sharding.param_pspecs`` of flat parameter names, checked: every
    split divides its dim (``param_pspecs`` drops what does not; here the
    drop must not hide a TP split the grain needs)."""
    leaves = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    specs = SH.param_pspecs(cfg, leaves, mesh, tp)
    flat = {n: specs[n] for n in shapes}
    if tp and mesh.shape["model"] > 1:
        whole = _Q if cfg.n_heads % mesh.shape["model"] else ()
        for n, spec in flat.items():
            leaf = n.rsplit(".", 1)[-1]
            if leaf in _TP_SPLIT and leaf not in whole and "model" not in [
                    a for e in spec for a in SH.spec_axes(e)]:
                raise ValueError(
                    f"{n}: shape {tuple(shapes[n])} does not divide over "
                    f"mesh axis 'model' ({mesh.shape['model']}), which "
                    f"the TP grain splits it over")
    return flat


def shard_params(model: T.LM, mesh, tp: bool,
                 positions: Optional[Sequence[int]] = None) -> MeshParams:
    """``model``'s parameters laid out on ``mesh`` by ``param_pspecs``
    (the positions default to all; the model is left as it is)."""
    cfg = model.cfg
    if tp and mesh.shape["model"] > 1:
        check_tp(cfg, mesh)
    named = dict(model.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in named.items()}
    specs = param_specs(cfg, shapes, mesh, tp)
    positions = tuple(range(mesh.size) if positions is None else positions)
    with torch.no_grad():
        shards = SH.shard_tree({n: p.detach() for n, p in named.items()},
                               specs, mesh, positions)
    return MeshParams(cfg, mesh, tp, specs, shapes, shards, positions)


def init_state(model: T.LM, mesh, tp: bool,
               moments_dtype: str = "float32",
               positions: Optional[Sequence[int]] = None) -> MeshTrainState:
    """A ``MeshTrainState`` of ``model``'s parameters (``shard_params``)
    and zeroed moments."""
    params = shard_params(model, mesh, tp, positions)
    return MeshTrainState(params, [opt.init_opt_state(sh, moments_dtype)
                                   for sh in params.shards])


def mamba_heads(cfg: ArchConfig) -> int:
    """A hybrid config's Mamba2 heads: expand * d_model / head_dim."""
    return cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim


def rwkv_heads(cfg: ArchConfig) -> int:
    """An ssm config's rwkv6 time-mix heads: d_model / ``HEAD_SIZE``."""
    return cfg.d_model // R6.HEAD_SIZE


def _split_range(n: int, m: int, j: int) -> Tuple[int, int]:
    """The items [a, b) of shard j when ``n`` split over ``m`` shards:
    ``n / m`` each where that divides, else one more on each of the first
    ``n % m``."""
    base, extra = divmod(n, m)
    a = j * base + min(j, extra)
    return a, a + base + (j < extra)


def check_tp(cfg: ArchConfig, mesh) -> None:
    """Raises ``ValueError`` where the TP grain cannot run ``cfg`` on
    ``mesh``: heads that leave a model shard without one (q heads, the
    hybrid's Mamba2 heads, which must also divide, and rwkv6's time-mix
    heads), each with its own message (``param_specs`` raises for a
    split dim that does not divide)."""
    m = mesh.shape["model"]
    if cfg.family == "ssm":
        h = rwkv_heads(cfg)
        if h < m:
            raise ValueError(f"{cfg.name}: layers.*.mix.wr: {h} rwkv6 heads "
                             f"(d_model / {R6.HEAD_SIZE}) leave shards of "
                             f"mesh axis 'model' ({m}) without one")
        return
    if cfg.family == "hybrid":
        nh = mamba_heads(cfg)
        if nh < m:
            raise ValueError(f"{cfg.name}: *.mamba.in_proj: {nh} Mamba2 "
                             f"heads (expand * d_model / head_dim) leave "
                             f"shards of mesh axis 'model' ({m}) without one")
        if nh % m:
            raise ValueError(f"{cfg.name}: *.mamba.in_proj: {nh} Mamba2 "
                             f"heads do not divide over mesh axis 'model' "
                             f"({m}): out_proj's rows and the SSM state "
                             f"split by head")
    if cfg.n_heads < m:
        raise ValueError(f"{cfg.name}: layers.*.attn.wq: {cfg.n_heads} "
                         f"heads leave shards of mesh axis 'model' ({m}) "
                         f"without one")


# ---------------------------------------------------------------------------
# Data layout
# ---------------------------------------------------------------------------
def _dp_axes(mesh, tp: bool) -> Tuple[str, ...]:
    return SH.dp_axes(mesh) + (() if tp else ("model",))


def n_data(mesh, tp: bool) -> int:
    """The data positions of ``mesh`` in a grain: every position in the DP
    grain, one per data row in the TP grain."""
    if tp and mesh.shape["model"] == 1:
        tp = False
    return mesh.size // (mesh.shape["model"] if tp else 1)


def _rows(batch: Mapping[str, Tensor], mesh, tp: bool, d: int
          ) -> Dict[str, Tensor]:
    """Data position ``d``'s slice of a global batch (every leaf's
    leading dim split over the data positions, in mesh order)."""
    n = n_data(mesh, tp)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"{k}: batch {v.shape[0]} does not divide over "
                             f"mesh axes {_dp_axes(mesh, tp)} ({n})")
        size = v.shape[0] // n
        out[k] = v[d * size:(d + 1) * size]
    return out


def _divides(batch: Mapping[str, Tensor], mesh, tp: bool) -> bool:
    """Whether every leaf's batch divides over the data members: where it
    does not, the reference's ``batch_pspecs`` replicates the batch, and
    every member runs every row."""
    n = n_data(mesh, tp)
    return all(v.shape[0] % n == 0 for v in batch.values())


def _microbatches(batch: Mapping[str, Tensor], n_mb: int
                  ) -> List[Dict[str, Tensor]]:
    for k, v in batch.items():
        if v.shape[0] % n_mb or not v.shape[0]:
            raise ValueError(f"{k}: a data position's batch of "
                             f"{v.shape[0]} does not split into {n_mb} "
                             f"microbatches")
    return [{k: v.reshape(n_mb, v.shape[0] // n_mb, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n_mb)]


def _routed_rows(batch: Mapping[str, Tensor], mesh, tp: bool, n_mb: int,
                 i: int, d: int) -> Dict[str, Tensor]:
    """Data member ``d``'s share of the reference's microbatch ``i``: rows
    ``[i * b / n_mb, (i + 1) * b / n_mb)`` of the global batch, split over
    the data members in mesh order (block ``i * n + d`` of ``n * n_mb``)."""
    n = n_data(mesh, tp)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % (n * n_mb) or not v.shape[0]:
            raise ValueError(f"{k}: batch {v.shape[0]} does not split into "
                             f"{n_mb} microbatches over mesh axes "
                             f"{_dp_axes(mesh, tp)} ({n})")
        size = v.shape[0] // (n * n_mb)
        out[k] = v[(i * n + d) * size:(i * n + d + 1) * size]
    return out


class _RoutingSet:
    """One microbatch's MoE routing set over its ``n`` data members (see
    the module docstring), installed with ``ctx.moe_routing_set``; MoE
    layer ``li`` reaches it through ``handle(li)`` (``models.moe.route``).
    ``member`` is the member now running.  While ``recording`` (the pass
    without gradients, members in order) each (layer, member) picks its
    experts once and keeps the pick and its per-expert counts; every call
    then counts the exchange, one all-gather of the members' counts
    received by the calling position.  Afterwards each call replays the
    pick, its gates taken from the caller's own logits, with the set's
    totals.  In a representative trace only the held members' counts
    exist: the offsets and totals are theirs (shapes only, on ``meta``)."""

    COUNT_DTYPE = torch.int64

    def __init__(self, cfg: ArchConfig, n_tokens: int, n_members: int):
        self.moe = cfg.moe
        self.n_tokens = n_tokens
        self.n_members = n_members
        self.member = 0
        self.recording = True
        self.picks: Dict[Tuple[int, int], Tensor] = {}
        self.counts: Dict[Tuple[int, int], Tensor] = {}

    def handle(self, layer: int) -> "_RouteHandle":
        return _RouteHandle(self, layer)

    def route(self, layer: int, logits: Tensor):
        e, k = self.moe.n_experts, self.moe.top_k
        key = (layer, self.member)
        dev = logits.device
        if key not in self.picks:
            if not self.recording:
                raise KeyError(f"MoE layer {layer} of member {self.member} "
                               f"was not routed in the pass without "
                               f"gradients")
            gates, idx = MOE.route_topk(logits, k)
            flat = idx.reshape(-1)
            self.picks[key] = idx
            self.counts[key] = torch.zeros(
                e, dtype=self.COUNT_DTYPE, device=dev).index_add_(
                    0, flat, torch.ones_like(flat))
        else:
            idx = self.picks[key].to(dev)
            gates = MOE.gates_at(logits, idx)
        if self.recording:
            SH.record("all_gather", self.n_members * e *
                      torch.empty((), dtype=self.COUNT_DTYPE).element_size())
        held = [(r, c) for (li, r), c in sorted(self.counts.items())
                if li == layer]
        offset = torch.zeros(e, dtype=self.COUNT_DTYPE, device=dev)
        total = torch.zeros(e, dtype=self.COUNT_DTYPE, device=dev)
        for r, c in held:
            c = c.to(dev)
            if r < self.member:
                offset = offset + c
            total = total + c
        return gates, idx, offset, total


class _RouteHandle:
    """What ``models.moe.route`` calls: one MoE layer's view of a
    ``_RoutingSet``."""

    def __init__(self, routing: _RoutingSet, layer: int):
        self.routing, self.layer = routing, layer
        self.n_tokens = routing.n_tokens

    def route(self, logits: Tensor):
        return self.routing.route(self.layer, logits)


def _to(batch: Mapping[str, Tensor], device) -> Dict[str, Tensor]:
    return {k: v.to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Gradient accumulation: the ordered sum into the stored slices
# ---------------------------------------------------------------------------
class _Accumulator:
    """Per held position, one accumulator per leaf of its slice, summed
    in the order contributions arrive (the caller's fixed order), the
    first contribution copied: the one-device step's microbatch
    accumulator, element for element."""

    def __init__(self, params: MeshParams, dtype: Optional[torch.dtype]):
        self.p = params
        self.dtype = dtype                 # None: the gradients' own
        self.acc: List[Dict[str, Tensor]] = [{} for _ in params.positions]
        self.strides: Dict[str, tuple] = {}

    def add(self, name: str, grad: Tensor, spec=None,
            model_index: Optional[int] = None) -> None:
        """Add the gradient of ``name`` over the region ``grad`` covers:
        the global leaf (``spec`` None: the leaf's own), or one TP shard's
        model split of it (``spec`` the leaf's spec with the model axis
        removed), which only the positions of ``model_index`` hold."""
        p = self.p
        self.strides.setdefault(name, grad.stride() if spec is None
                                else None)
        spec = p.specs[name] if spec is None else spec
        m = p.mesh.shape["model"]
        for i, pos in enumerate(p.positions):
            if model_index is not None and pos % m != model_index:
                continue
            part = grad[SH.local_slices(spec, grad.shape, p.mesh, pos)]
            dev = SH.device_of(p.mesh, pos)
            acc = self.acc[i]
            if name in acc:
                acc[name].add_(part.to(dev).to(acc[name].dtype))
            else:
                acc[name] = SH._own_copy(part, dev, self.dtype or part.dtype)

    def finish(self, n_total: int, n_rounds: int) -> List[Dict[str, Tensor]]:
        """Divide by the number of microbatches summed and count one
        gradient reduction per microbatch round: a reduce-scatter into
        each sharded leaf's slices, an all-reduce for a replicated one."""
        p = self.p
        for acc in self.acc:
            if n_total > 1:
                for g in acc.values():
                    g.div_(n_total)
        for name in p.names:
            g = self.acc[0][name]
            kind = "reduce_scatter" if any(SH.spec_axes(e) for e in
                                           p.specs[name]) else "all_reduce"
            SH.record(kind, n_rounds * len(p.positions)
                      * g.numel() * g.element_size())
        return self.acc

    def global_norm(self, device) -> Tensor:
        """The accumulated gradients' global norm, as
        ``optimizer.global_norm`` computes it on the whole leaves: each
        leaf gathered on ``device`` in the layout the one-device gradient
        has, one at a time, in sorted order (a sum of squares per shard
        would differ from it in the last bits)."""
        p = self.p
        terms = []
        for name in sorted(p.names):
            parts = {pos: acc[name] for pos, acc in zip(p.positions,
                                                        self.acc)}
            full = SH.gather_leaf(parts, p.specs[name], p.shapes[name],
                                  p.mesh, device,
                                  stride=self.strides.get(name),
                                  count=not p.representative)
            terms.append(torch.sum(torch.square(full.to(F32))))
            del full
        return torch.sqrt(torch.sum(torch.stack(terms)))

    def sharded_norm(self) -> List[Tensor]:
        """The global norm as the TP grain takes it, one copy per held
        position: each position's sum of squares of the slices it is the
        first to hold (a replicated slice counts once), then an all-reduce
        of those scalars in mesh order.  Within rounding of
        ``global_norm``, and it moves one scalar per position."""
        p = self.p
        owners: Dict[tuple, int] = {}
        terms = []
        for i, pos in enumerate(p.positions):
            dev = SH.device_of(p.mesh, pos)
            t = torch.zeros((), dtype=F32, device=dev)
            for name in sorted(p.names):
                key = (name,) + tuple((sl.start, sl.stop) for sl in
                                      SH.local_slices(p.specs[name],
                                                      p.shapes[name],
                                                      p.mesh, pos))
                if owners.setdefault(key, pos) == pos:
                    t = t + torch.sum(torch.square(
                        self.acc[i][name].to(F32)))
            terms.append(t)
        return [torch.sqrt(x) for x in SH.all_reduce(terms, p.mesh.size)]


def replica_mismatches(state: MeshTrainState) -> List[str]:
    """The leaves (parameters and moments) whose copies differ between
    positions that hold the same slice: a replicated leaf's copies must
    stay bitwise equal after every step.  Empty when they all agree."""
    p = state.params
    trees = [("params", p.shards)] + [
        (which, [getattr(o, which) for o in state.opt]) for which in "mv"]
    bad = []
    for which, per_pos in trees:
        for n in p.names:
            first: Dict[tuple, Tensor] = {}
            for pos, tree in zip(p.positions, per_pos):
                key = tuple((sl.start, sl.stop) for sl in SH.local_slices(
                    p.specs[n], p.shapes[n], p.mesh, pos))
                if key not in first:
                    first[key] = tree[n]
                elif not torch.equal(first[key], tree[n].to(
                        first[key].device)):
                    bad.append(f"{which}:{n}")
                    break
    return bad


def gather_grads(params: MeshParams, grads: Sequence[Mapping[str, Tensor]],
                 device="cpu") -> Dict[str, Tensor]:
    """The global gradients of a ``skip_update`` step's per-position
    ``grads`` (one dict of slices per held position), on ``device``."""
    return {n: SH.gather_leaf({pos: g[n] for pos, g in
                               zip(params.positions, grads)},
                              params.specs[n], params.shapes[n],
                              params.mesh, device, count=False)
            for n in params.names}


def norm_gather_bytes(params: MeshParams, dtype: torch.dtype) -> int:
    """The all-gather bytes of ``_Accumulator.global_norm`` (the DP
    grain's) on a full ring (every leaf split over more than one
    position, once): what a representative trace leaves out of its
    count."""
    size = torch.empty((), dtype=dtype).element_size()
    mesh = params.mesh
    return sum(int(np.prod(params.shapes[n])) * size for n in params.names
               if np.prod([mesh.shape[a] for e in params.specs[n]
                           for a in SH.spec_axes(e)]) > 1)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
def build_train_step(cfg: ArchConfig, mesh, opt_cfg: opt.AdamWConfig, plan
                     ) -> Tuple[Callable, Dict[str, Callable]]:
    """``(train_step, hooks)`` on ``mesh``: ``train_step(state, batch) ->
    (state, metrics)`` over a ``MeshTrainState`` (``init_state``) and a
    global batch, the metrics those of ``train.step.build_train_step``
    (0-d tensors on position 0's device).  ``plan.n_microbatches`` is
    per data position."""
    hooks = ctx.residual_hooks(mesh, SH.dp_axes(mesh),
                               plan.seq_shard_activations, plan.tp)
    if plan.tp and mesh.shape["model"] > 1:
        check_tp(cfg, mesh)
    acc_dtype = torch.bfloat16 if plan.grad_compression == "bf16" else F32
    skeleton = T.init_params(cfg, device="meta", trainable=True) \
        if not plan.tp or mesh.shape["model"] == 1 else None

    def train_step(state: MeshTrainState, batch):
        from repro_torch.train.step import to_device
        p = state.params
        if p.cfg.name != cfg.name or p.mesh.shape != mesh.shape or \
                p.tp != plan.tp:
            raise ValueError("the state was laid out for another config, "
                             "mesh or grain")
        dev0 = SH.device_of(mesh, p.positions[0])
        batch = to_device(batch, dev0)
        n_mb = plan.n_microbatches
        tp = plan.tp and mesh.shape["model"] > 1
        data = [pos // mesh.shape["model"] for pos in p.positions] if tp \
            else list(p.positions)
        data = sorted(set(data))
        n_total = n_data(mesh, tp) * n_mb
        dtype = acc_dtype if n_total > 1 else None
        accum = _Accumulator(p, dtype)
        losses, stats = [], []

        def turn(d, mb, grad=True):
            if tp:
                return _tp_train_turn(p, hooks, d, mb, accum, grad)
            return list(_dp_train_turns(p, skeleton, d, [mb], accum,
                                        grad))[0]

        def keep(loss, st):
            losses.append(loss.to(dev0))
            stats.append({k: v.to(dev0) for k, v in st.items()})

        split = _divides(batch, mesh, tp)
        if cfg.moe is None:
            for d in data:
                rows = _rows(batch, mesh, tp, d) if split else batch
                mbs = _microbatches(rows, n_mb)
                if tp:
                    for mb in mbs:
                        keep(*turn(d, mb))
                else:
                    for loss, st in _dp_train_turns(p, skeleton, d, mbs,
                                                    accum):
                        keep(loss, st)
        else:
            n = n_data(mesh, tp)
            whole = None if split else _microbatches(batch, n_mb)
            for i in range(n_mb):
                mbs = {d: _routed_rows(batch, mesh, tp, n_mb, i, d)
                       if split else whole[i] for d in data}
                rs = None
                if n > 1 and split:
                    first = next(iter(mbs[data[0]].values()))
                    rs = _RoutingSet(cfg, n * first.shape[0]
                                     * first.shape[1], n)
                    with ctx.moe_routing_set(rs):
                        for d in data:
                            rs.member = d
                            turn(d, mbs[d], grad=False)
                    rs.recording = False
                with ctx.moe_routing_set(rs):
                    for d in data:
                        if rs is not None:
                            rs.member = d
                        keep(*turn(d, mbs[d]))
        grads = accum.finish(n_total, n_mb)
        if n_total > 1:
            l_acc = 0.0
            for loss in losses:
                l_acc = l_acc + loss
            loss = l_acc / n_total
            stats = {k: torch.stack([s[k] for s in stats]).mean()
                     for k in stats[0]}
        else:
            loss, stats = losses[0], stats[0]
        if plan.skip_update:
            return state, {"loss": loss, "grads": grads}
        # DP grain: the one-device norm's own order over whole leaves,
        # for the bitwise claim; TP grain: per-shard sums and a scalar
        # all-reduce, within rounding of it
        gnorms = accum.sharded_norm() if tp else \
            [accum.global_norm(dev0)] * len(p.positions)
        metrics = {}
        for pos, sh, g, o, gn in zip(p.positions, p.shards, grads, state.opt,
                                     gnorms):
            dev = SH.device_of(mesh, pos)
            m = opt.adamw_update_(opt_cfg, sh, g, o, gn.to(dev))
            metrics = metrics or m
        return state, dict(metrics, loss=loss, **stats)

    return train_step, hooks


def _load(model: nn.Module, tensors: Mapping[str, Tensor]) -> None:
    """Make ``tensors`` the parameters of ``model`` (a skeleton on
    ``meta``): each one an ``nn.Parameter`` over the tensor's storage."""
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(t, requires_grad=True))


def _layer_modules(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    """The model's layers, FSDP's unit of gathering: each module held in
    an ``nn.ModuleList`` that is not itself one (``layers.i``,
    ``groups.i.j``, ``tail.i``).  What lies outside them (the embedding,
    the head, the final norm, the hybrid's shared block, used once per
    group) is gathered once per data position."""
    return [(n, mod) for n, mod in model.named_modules()
            if n and not isinstance(mod, nn.ModuleList)
            and isinstance(model.get_submodule(n.rpartition(".")[0]),
                           nn.ModuleList)]


def _set_param(model: nn.Module, name: str, t: Tensor) -> None:
    """Put ``t`` (a tensor in a graph, not a leaf) where the model reads
    parameter ``name``."""
    owner, _, leaf = name.rpartition(".")
    model.get_submodule(owner)._parameters[leaf] = t


def _fsdp_hooks(p: MeshParams, model: nn.Module, d: int, sink: Callable,
                anchor: Tensor) -> Tuple[List[str], List[Any]]:
    """Hooks that gather each layer's leaves on data position ``d`` as the
    layer is entered (through ``_Fetch``, its gradients to ``sink``) and
    put the model's own ``meta`` leaves back as it is left (a new stand-in
    would be an allocation to a trace on ``meta``).  A checkpointed layer's
    recomputation enters it again, so its leaves are gathered again for
    the backward and held by no one between layers.  Returns (the names
    of the leaves so gathered, the hook handles)."""
    dev = SH.device_of(p.mesh, d)
    layered, handles = [], []
    for prefix, mod in _layer_modules(model):
        own = {f"{prefix}.{n}": t for n, t in mod.named_parameters()}
        layered += list(own)

        def enter(_mod, _args, own=own):
            for n in own:
                _set_param(model, n, _Fetch.apply(
                    functools.partial(p.gather, n, dev, receiver=d), n,
                    sink, anchor))

        def leave(_mod, _args, _out, own=own):
            for n, t in own.items():
                _set_param(model, n, t)

        handles += [mod.register_forward_pre_hook(enter),
                    mod.register_forward_hook(leave)]
    return layered, handles


def _dp_train_turns(p: MeshParams, skeleton: T.LM, d: int,
                    mbs: List[Dict[str, Tensor]], accum: _Accumulator,
                    grad: bool = True):
    """DP grain, data position ``d`` (a mesh position): FSDP over the
    model's own ``forward``.  The leaves outside the layers are gathered
    there once; each layer's are gathered as the layer runs and released
    after (``_fsdp_hooks``).  Per microbatch its loss and gradients; a
    layer's gradients go into the accumulator (its slices) as the
    backward leaves the layer, the others' after it; yields (loss,
    stats).  A gradient reaches a leaf here as autograd would sum it into
    the one-device step's parameter, and each leaf gets one per
    microbatch, so the values are the same bit for bit.  ``grad`` False:
    the forward alone (a routing set's first pass), yielding None."""
    from repro_torch.train.step import loss_fn
    dev = SH.device_of(p.mesh, d)
    anchor = torch.zeros((), device=dev, requires_grad=True)
    layered, handles = _fsdp_hooks(p, skeleton, d, accum.add, anchor)
    top = [n for n in p.names if n not in set(layered)]
    own = {n: skeleton.get_parameter(n) for n in top}
    _load(skeleton, {n: p.gather(n, dev, receiver=d) for n in top})
    leaves = [skeleton.get_parameter(n) for n in top]
    try:
        for mb in mbs:
            if not grad:
                with torch.no_grad():
                    loss_fn(skeleton, _to(mb, dev))
                yield None
                continue
            # a recomputation runs to its layer's end, where the layer's
            # gathered leaves are released
            with torch.enable_grad(), set_checkpoint_early_stop(False):
                loss, stats = loss_fn(skeleton, _to(mb, dev))
                grads = torch.autograd.grad(loss, leaves + [anchor])
            for n, g in zip(top, grads):
                accum.add(n, g)
            del grads
            yield loss.detach(), {k: v.detach() for k, v in stats.items()}
    finally:
        for h in handles:
            h.remove()
        for n, t in own.items():
            _set_param(skeleton, n, t)


# ---------------------------------------------------------------------------
# The TP + SP grain
# ---------------------------------------------------------------------------
class _Fetch(torch.autograd.Function):
    """A use of a leaf: its stored slices gathered (over the data axes,
    and over "model" where a TP shard needs the leaf whole); the backward
    hands the gradient to ``sink(key, grad)`` instead of the slices, so
    the step sums the positions in a fixed order."""

    @staticmethod
    def forward(ctx_, fetch, key, sink, anchor):
        ctx_.key, ctx_.sink, ctx_.anchor_device = key, sink, anchor.device
        return fetch()

    @staticmethod
    def backward(ctx_, grad):
        ctx_.sink(ctx_.key, grad)
        return None, None, None, torch.zeros((), device=ctx_.anchor_device)


def _collect(store: Dict) -> Callable[[Any, Tensor], None]:
    """A ``_Fetch`` sink that keeps each key's gradients in a list."""
    return lambda key, grad: store.setdefault(key, []).append(grad)


@dataclasses.dataclass
class _Shards:
    """What one data row's TP shards read: the parameters (through
    ``_Fetch`` while training), the members run, the layout rules."""

    p: MeshParams
    row: int
    members: List[int]                   # model shard indices run
    rules: Dict[str, Callable]
    sink: Optional[Callable] = None      # training: of (name, j), grad
    anchor: Optional[Tensor] = None

    @property
    def m(self) -> int:
        return self.p.mesh.shape["model"]

    def pos(self, j: int) -> int:
        return self.row * self.m + j

    def dev(self, j: int) -> torch.device:
        return SH.device_of(self.p.mesh, self.pos(j))

    def whole_over_model(self, name: str) -> bool:
        """Whether a shard needs the leaf whole over "model": q/o where
        the q heads do not divide over it, k/v where the k/v heads do
        not, Mamba2's in_proj and conv_w always, rwkv6's head-split
        projections where its heads do not divide."""
        leaf = name.rsplit(".", 1)[-1]
        cfg = self.p.cfg
        if cfg.family == "hybrid" and leaf in _MAMBA_WHOLE:
            return True
        if cfg.family == "ssm":
            return leaf in _RWKV_HEADS and rwkv_heads(cfg) % self.m != 0
        if leaf in _KV:
            return cfg.n_kv_heads % self.m != 0
        return leaf in _Q and cfg.n_heads % self.m != 0

    def param(self, name: str, j: int) -> Tensor:
        axes = self.p.mesh.axis_names if self.whole_over_model(name) \
            else SH.dp_axes(self.p.mesh)

        def fetch():
            return self.p.gather(name, self.dev(j), receiver=self.pos(j),
                                 axes=axes)
        if self.sink is None:
            return fetch()
        return _Fetch.apply(fetch, (name, j), self.sink, self.anchor)

    def tree(self, prefix: str, j: int) -> Dict[str, Tensor]:
        return {n.rsplit(".", 1)[1]: self.param(n, j)
                for n in self.p.children(prefix)}

    def q_heads(self, j: int) -> Tuple[int, int]:
        """The q heads [h0, h1) of shard j: ``n_heads / m`` each where that
        divides, else one more on each of the first ``n_heads % m``."""
        return _split_range(self.p.cfg.n_heads, self.m, j)

    def mamba(self, pre: str, j: int) -> Dict[str, Tensor]:
        """Shard j's Mamba2 parameters (``pre`` a layer's ``.mamba``) in
        the one-device layout over its heads [h0, h1): in_proj's z, x and
        dt columns of them and every B/C column ([z_j | x_j | B C |
        dt_j], n_groups B/C groups read by every head), conv_w's x
        channels of them and the B/C channels, their ``A_log``, ``D``,
        ``dt_bias`` and ``norm_scale`` entries, and its rows of out_proj
        (stored so).  in_proj and conv_w are gathered whole over "model":
        their storage blocks are not heads."""
        cfg = self.p.cfg
        ssm = cfg.ssm
        di = ssm.expand * cfg.d_model
        bc = 2 * ssm.n_groups * ssm.state
        h0, h1 = _split_range(mamba_heads(cfg), self.m, j)
        x0, x1 = h0 * ssm.head_dim, h1 * ssm.head_dim
        w = self.param(pre + ".in_proj", j)
        cw = self.param(pre + ".conv_w", j)
        dt0 = 2 * di + bc
        return {
            "in_proj": torch.cat([w[:, x0:x1], w[:, di + x0:di + x1],
                                  w[:, 2 * di:dt0],
                                  w[:, dt0 + h0:dt0 + h1]], 1),
            "conv_w": torch.cat([cw[:, x0:x1], cw[:, di:]], 1),
            "A_log": self.param(pre + ".A_log", j)[h0:h1],
            "D": self.param(pre + ".D", j)[h0:h1],
            "dt_bias": self.param(pre + ".dt_bias", j)[h0:h1],
            "norm_scale": self.param(pre + ".norm_scale", j)[x0:x1],
            "out_proj": self.param(pre + ".out_proj", j)}

    def rwkv(self, pre: str, j: int) -> Dict[str, Tensor]:
        """Shard j's rwkv6 time-mix parameters (``pre`` a layer's
        ``.mix``) over its heads [h0, h1) (uneven where they do not
        divide, the head-split projections then gathered whole and cut):
        the columns of wr/wk/wv/wg, w0 and w_lora_B, the rows of wo, u and
        ln_x_scale; the token-shift leaves (mu, the LoRAs) whole, so every
        shard computes the ddlerp whole."""
        h0, h1 = _split_range(rwkv_heads(self.p.cfg), self.m, j)
        c0, c1 = h0 * R6.HEAD_SIZE, h1 * R6.HEAD_SIZE
        t = {n: self.param(f"{pre}.{n}", j) for n in _RWKV_TM}
        if self.whole_over_model(pre + ".wr"):
            for n in ("wr", "wk", "wv", "wg"):
                t[n] = t[n][:, c0:c1]
            t["wo"] = t["wo"][c0:c1]
        t["u"] = t["u"][h0:h1]
        t["w0"] = t["w0"][c0:c1]
        t["ln_x_scale"] = t["ln_x_scale"][c0:c1]
        t["w_lora_B"] = t["w_lora_B"][:, c0:c1]
        return t

    def kv_heads(self, j: int) -> Tuple[int, int]:
        """The k/v heads [k0, k1) shard j's q heads read."""
        cfg = self.p.cfg
        if cfg.n_kv_heads % self.m == 0:
            kl = cfg.n_kv_heads // self.m
            return j * kl, (j + 1) * kl
        h0, h1 = self.q_heads(j)
        g = cfg.n_heads // cfg.n_kv_heads
        return h0 // g, (h1 - 1) // g + 1

    def kv_take(self, j: int) -> Optional[List[int]]:
        """None where shard j's q heads group evenly onto its k/v heads
        [k0, k1) (grouped-query attention runs on them as they are), else
        the k/v head (from k0) each q head reads: they straddle k/v
        groups, and the shard runs one k/v head per q head."""
        cfg = self.p.cfg
        h0, h1 = self.q_heads(j)
        k0, k1 = self.kv_heads(j)
        g = cfg.n_heads // cfg.n_kv_heads
        take = [h // g - k0 for h in range(h0, h1)]
        hl, kl = h1 - h0, k1 - k0
        if hl % kl == 0 and take == [i // (hl // kl) for i in range(hl)]:
            return None
        return take

    def attn(self, prefix: str, j: int, all_kv: bool = False,
             all_q: bool = False) -> Tuple[Dict[str, Tensor], L.AttnSpec]:
        """Shard j's attention parameters and their ``AttnSpec``: its q
        heads (every q head with ``all_q``, from q/o gathered whole), the
        k/v heads they read (every k/v head with ``all_kv``, for a
        sequence-sharded cache), its rows of ``wo``."""
        cfg = self.p.cfg
        dh = cfg.d_head
        p = self.tree(prefix, j)
        h0, h1 = (0, cfg.n_heads) if all_q else self.q_heads(j)
        if self.whole_over_model(prefix + ".wq"):
            for n in ("wq", "bq"):
                if n in p:
                    p[n] = p[n][..., h0 * dh:h1 * dh]
            p["wo"] = p["wo"][h0 * dh:h1 * dh]
        k0, k1 = (0, cfg.n_kv_heads) if all_kv else self.kv_heads(j)
        if self.whole_over_model(prefix + ".wk"):
            for n in _KV:
                if n in p:
                    p[n] = p[n][..., k0 * dh:k1 * dh]
        n_kv = k1 - k0
        take = None if all_kv or all_q else self.kv_take(j)
        if take is not None:
            cols = (torch.tensor(take, device=p["wk"].device)[:, None] * dh
                    + torch.arange(dh, device=p["wk"].device)).reshape(-1)
            for n in _KV:
                if n in p:
                    p[n] = p[n].index_select(-1, cols)
            n_kv = len(take)
        spec = dataclasses.replace(T.attn_spec(cfg), n_heads=h1 - h0,
                                   n_kv_heads=n_kv)
        return p, spec

    def local_kv(self, j: int, k: Tensor, v: Tensor
                 ) -> Tuple[Tensor, Tensor]:
        """Of (B, S, Hkv, D) k/v over every k/v head, the heads shard j's
        q heads read (as ``attn`` lays them out)."""
        k0, k1 = self.kv_heads(j)
        k, v = k[:, :, k0:k1], v[:, :, k0:k1]
        take = self.kv_take(j)
        if take is not None:
            idx = torch.tensor(take, device=k.device)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        return k, v

    def seq_sharded(self, b: int, s: int) -> bool:
        lay = self.rules["residual"]((b, s, self.p.cfg.d_model))
        return lay is not None and lay[1] == "model"


def _combine(sh: _Shards, parts: List[Tensor], sp: bool) -> List[Tensor]:
    """The row-parallel partials summed over the model shards in shard
    order: reduce-scattered over the sequence under SP, else all-reduced.
    A bf16 partial (``out @ wo``, ``h @ w_down``) was rounded to bf16
    before this sum, so the TP grain's bf16 results differ from one
    device's in those roundings."""
    if sp:
        return SH.reduce_scatter(parts, 1, sh.m)
    return SH.all_reduce(parts, sh.m)


def _gather_seq(sh: _Shards, xs: List[Tensor], sp: bool) -> List[Tensor]:
    return SH.all_gather(xs, 1, sh.m) if sp else xs


def _embed(sh: _Shards, tokens: Tensor, sp: bool) -> List[Tensor]:
    """Vocab-parallel embedding: each shard looks its vocabulary range up
    (zeros elsewhere); the sum over shards is exact."""
    cfg = sh.p.cfg
    vl = cfg.vocab // sh.m
    out = []
    for j in sh.members:
        table = sh.param("embed", j)
        tok = tokens.to(sh.dev(j))
        inside = (tok >= j * vl) & (tok < (j + 1) * vl)
        e = F.embedding((tok - j * vl).clamp(0, vl - 1), table)
        out.append(torch.where(inside[..., None], e, e.new_zeros(())))
    return _combine(sh, out, sp)


def _inputs(sh: _Shards, rows: Mapping[str, Tensor], sp: bool,
            position: Optional[List[Tensor]] = None) -> List[Tensor]:
    """The residual stream's start on each shard (``_LM.embed_inputs``):
    the vocab-parallel embedding of ``rows["tokens"]``, or the
    ``rows["embeds"]`` slice in the model dtype (vlm, audio), its
    sequence block under SP; for ``pos == "sin"`` plus the sinusoidal
    embedding of its positions (of ``position``, per shard, decoding)."""
    cfg = sh.p.cfg
    if cfg.embed_inputs:
        xs = _embed(sh, rows["tokens"], sp)
    else:
        emb = rows["embeds"]
        xs = [SH._split(emb, 1, sh.m, j) if sp else emb
              for j in sh.members]
        xs = [x.to(sh.dev(j), torch_dtype(cfg.dtype))
              for j, x in zip(sh.members, xs)]
    if cfg.pos != "sin":
        return xs
    out = []
    for i, (j, x) in enumerate(zip(sh.members, xs)):
        if position is not None:
            pos = position[i][:, None]
        else:
            s = x.shape[1]
            pos = torch.arange(s, device=x.device) + (j * s if sp else 0)
        out.append(x + L.sin_embedding(pos, cfg.d_model).to(x.dtype))
    return out


def _head(sh: _Shards, xs: List[Tensor], sp: bool) -> List[Tensor]:
    """Final norm and the vocab-sharded f32 logits of each shard."""
    cfg = sh.p.cfg
    h = [L.apply_norm(sh.tree("final_norm", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    h = _gather_seq(sh, h, sp)
    out = []
    for j, hj in zip(sh.members, h):
        head = sh.param("embed", j).T if cfg.tie_embeddings \
            else sh.param("lm_head", j)
        out.append(hj.float() @ head.float())
    return out


def _cross_entropy(sh: _Shards, logits: List[Tensor], labels: Tensor
                   ) -> Tensor:
    """``train.step.cross_entropy`` over vocab-sharded logits: the
    log-sum-exp as the shards' maximum, then the ordered sum of their
    exponentials; the picked logit as the ordered sum of masked sums."""
    vl = sh.p.cfg.vocab // sh.m
    mx = SH.all_reduce_max([lg.max(-1).values for lg in logits], sh.m)
    se = SH.all_reduce([torch.exp(lg - m[..., None]).sum(-1)
                        for lg, m in zip(logits, mx)], sh.m)
    picked = []
    for j, lg in zip(sh.members, logits):
        iota = torch.arange(vl, device=lg.device) + j * vl
        lab = labels.to(lg.device)
        picked.append(torch.where(iota == lab[..., None].long(), lg,
                                  0.0).sum(-1))
    picked = SH.all_reduce(picked, sh.m)
    lse = mx[0] + torch.log(se[0])
    return (lse - picked[0]).mean()


def _tp_block(sh: _Shards, pre: str, li: int, sp: bool, *xs: Tensor
              ) -> Tuple[Tensor, ...]:
    """The attention block ``pre`` (``layers.{li}``, or the hybrid's
    ``shared``) over the row's model shards (training): the new residual
    per shard, then, with MoE, the layer's load-balance loss."""
    cfg = sh.p.cfg
    h = [L.apply_norm(sh.tree(pre + ".attn_norm", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    h = _gather_seq(sh, h, sp)
    y = []
    for j, hj in zip(sh.members, h):
        p, spec = sh.attn(pre + ".attn", j)
        y.append(L.attention_train(p, hj, spec, q_chunk=cfg.q_chunk,
                                   kv_chunk=cfg.kv_chunk))
    xs = [x + yj for x, yj in zip(xs, _combine(sh, y, sp))]
    xs, aux = _tp_ffn(sh, pre, li, sp, xs)
    return tuple(xs) + (() if aux is None else (aux,))


def _tp_ffn(sh: _Shards, pre: str, li: int, sp: bool, xs: List[Tensor],
            capacity_factor: Optional[float] = None
            ) -> Tuple[List[Tensor], Optional[Tensor]]:
    """norm -> FFN -> residual of block ``pre`` (layer ``li``) over the
    row's model shards: the column/row-parallel MLP, or the MoE FFN
    (``_tp_moe``) with arctic's dense MLP beside it.  Returns (the
    residual per shard, the MoE load-balance loss or None)."""
    cfg = sh.p.cfg
    h = [L.apply_norm(sh.tree(pre + ".mlp_norm", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    h = _gather_seq(sh, h, sp)
    if cfg.moe is None:
        z = [L.apply_mlp(sh.tree(pre + ".mlp", j), hj, cfg.mlp)
             for j, hj in zip(sh.members, h)]
        return [x + zj for x, zj in zip(xs, _combine(sh, z, sp))], None
    z, aux = _tp_moe(sh, pre, li, h, capacity_factor)
    if cfg.moe.dense_residual_ff:
        z = [zj + L.apply_mlp(sh.tree(pre + ".dense_mlp", j), hj,
                              cfg.mlp).float()
             for j, zj, hj in zip(sh.members, z, h)]
    return [x + yj.to(x.dtype) for x, yj in zip(xs, _combine(sh, z, sp))], \
        aux


def _tp_moe(sh: _Shards, pre: str, li: int, h: List[Tensor],
            capacity_factor: Optional[float]
            ) -> Tuple[List[Tensor], Tensor]:
    """MoE layer ``li`` on the row's model shards, each holding the row's
    tokens ``h`` (B, S, d): every shard routes them (the router is
    replicated; under a routing set with the set's offsets), then runs
    its experts (expert parallelism, ``n_experts >= m``) or its
    ``d_ff_expert / m`` of every expert (TP inside the experts) on the
    tokens kept there.  Returns (each shard's f32 partial output, to be
    summed over the shards; the load-balance loss, the first shard's)."""
    cfg = sh.p.cfg
    moe = cfg.moe
    pre = pre + ".moe"
    routing = ctx.moe_routing(li)
    ep = moe.n_experts >= sh.m
    el = moe.n_experts // sh.m if ep else moe.n_experts
    out, aux = [], None
    for j, hj in zip(sh.members, h):
        b, s, d = hj.shape
        x = hj.reshape(b * s, d)
        r = MOE.route(x, sh.param(pre + ".router", j), moe, capacity_factor,
                      routing)
        e0 = j * el if ep else 0
        buf = MOE.dispatch(x, r, e0, e0 + el)
        ob = MOE.experts(buf, sh.param(pre + ".w_gate", j),
                         sh.param(pre + ".w_up", j),
                         sh.param(pre + ".w_down", j))
        out.append(MOE.combine(ob, r, e0, e0 + el).reshape(b, s, d))
        if aux is None:
            aux = MOE.lb_loss(r)
    return out, aux


def _mean_square(sh: _Shards, ys: List[Tensor], width: int
                 ) -> List[Tensor]:
    """Mamba2's gated-norm mean of squares over every head: each shard's
    f32 sum of squares over its heads' channels, all-reduced in shard
    order, over ``width`` (the whole inner width).  Each shard's own
    mean would normalise by its heads alone."""
    sums = SH.all_reduce([(y * y).sum(-1, keepdim=True) for y in ys], sh.m)
    return [t / width for t in sums]


def _mamba_layer(sh: _Shards, pre: str, sp: bool, xs: List[Tensor],
                 state: Optional[tuple] = None) -> List[Tensor]:
    """norm -> Mamba2 -> residual of layer ``pre`` over the row's model
    shards, each running its heads (``_Shards.mamba``; ``causal_conv1d``
    on its [x_j | B C] channels) over the whole sequence (gathered under
    SP): the gated norm's mean of squares over every head
    (``_mean_square``), out_proj row-parallel, its f32 partials summed in
    shard order (reduce-scattered under SP) and rounded once.  ``state``
    (prefill): (cache, conv key, ssm key, index) to write each shard's
    serving state into."""
    cfg = sh.p.cfg
    h = [L.apply_norm(sh.tree(pre + ".norm", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    h = _gather_seq(sh, h, sp)
    ps, ys = [], []
    for j, hj in zip(sh.members, h):
        p = sh.mamba(pre + ".mamba", j)
        y, conv_in, s_fin = M2.mamba2_mix(p, hj, cfg.ssm)
        if state is not None:
            cache, kc, ks, idx = state
            slot = _cache_slot(cache, sh.pos(j))
            slot[kc][idx] = M2.conv_state(conv_in, p["conv_w"].shape[0])
            slot[ks][idx] = s_fin
        ps.append(p)
        ys.append(y)
    ms = _mean_square(sh, ys, cfg.ssm.expand * cfg.d_model)
    parts = [M2.gated_norm_out(p, y, m, hj.dtype, partial=True)
             for p, y, m, hj in zip(ps, ys, ms, h)]
    return [x + y.to(x.dtype) for x, y in zip(xs, _combine(sh, parts, sp))]


def _tp_mamba(sh: _Shards, pre: str, sp: bool, *xs: Tensor
              ) -> Tuple[Tensor, ...]:
    return tuple(_mamba_layer(sh, pre, sp, list(xs)))


def _rwkv_layer(sh: _Shards, pre: str, sp: bool, xs: List[Tensor],
                state: Optional[tuple] = None) -> List[Tensor]:
    """One rwkv6 layer ``pre`` over the row's model shards: the time mix
    on each shard's heads (``_Shards.rwkv``: the ddlerp whole, the
    per-head group norm on its own heads) over the whole sequence
    (gathered under SP), wo row-parallel with f32 partials summed in
    shard order and rounded once; then the channel mix
    (``_rwkv_channel_mix``).  ``state`` (prefill): (cache, layer) to write
    each shard's serving state into."""
    cfg = sh.p.cfg
    h = [L.apply_norm(sh.tree(pre + ".ln1", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    h = _gather_seq(sh, h, sp)
    parts = []
    for j, hj in zip(sh.members, h):
        p = sh.rwkv(pre + ".mix", j)
        b, l, d = hj.shape
        s0 = torch.zeros(b, p["u"].shape[0], R6.HEAD_SIZE, R6.HEAD_SIZE,
                         dtype=F32, device=hj.device)
        timemix = R6.rwkv6_timemix_chunked if l % T.RWKV_CHUNKED == 0 \
            else R6.rwkv6_timemix_scan
        y, s_fin = timemix(p, hj, hj.new_zeros(b, 1, d), s0, partial=True)
        parts.append(y)
        if state is not None:
            slot = _cache_slot(state[0], sh.pos(j))
            slot["s"][state[1]] = s_fin
            slot["tm_x"][state[1]] = hj[:, -1:]
    xs = [x + y.to(x.dtype) for x, y in zip(xs, _combine(sh, parts, sp))]
    h = [L.apply_norm(sh.tree(pre + ".ln2", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    h = _gather_seq(sh, h, sp)
    if state is not None:
        for j, hj in zip(sh.members, h):
            _cache_slot(state[0], sh.pos(j))["cm_x"][state[1]] = hj[:, -1:]
    tails = [hj.new_zeros(hj.shape[0], 1, hj.shape[2]) for hj in h]
    return _rwkv_channel_mix(sh, pre + ".mix", sp, xs, h, tails)


def _tp_rwkv(sh: _Shards, pre: str, sp: bool, *xs: Tensor
             ) -> Tuple[Tensor, ...]:
    return tuple(_rwkv_layer(sh, pre, sp, list(xs)))


def _rwkv_channel_mix(sh: _Shards, pre: str, sp: bool, xs: List[Tensor],
                      h: List[Tensor], tails: List[Tensor]) -> List[Tensor]:
    """rwkv6's channel mix (``models.rwkv6.rwkv6_channelmix``) of the
    normed ``h`` (token shift from ``tails``) plus the residual ``xs``
    over the row's model shards: cm_wk column-parallel over d_ff, cm_wv
    row-parallel (f32 partials summed in shard order, reduce-scattered
    over the sequence under SP), cm_wr column-parallel over d_model, its
    sigmoid all-gathered over "model" (each shard then takes its
    sequence block under SP)."""
    parts, rs = [], []
    for j, hj, tail in zip(sh.members, h, tails):
        w = {n: sh.param(f"{pre}.{n}", j).float()
             for n in ("cm_mu_k", "cm_mu_r", "cm_wk", "cm_wv", "cm_wr")}
        xf = hj.float()
        shifted = R6._token_shift(xf, tail.float())
        xk = xf + (shifted - xf) * w["cm_mu_k"]
        xr = xf + (shifted - xf) * w["cm_mu_r"]
        parts.append(torch.square(torch.relu(xk @ w["cm_wk"])) @ w["cm_wv"])
        rs.append(torch.sigmoid(xr @ w["cm_wr"]))
    v = _combine(sh, parts, sp)
    r = SH.all_gather(rs, 2, sh.m)
    out = []
    for j, x, rj, vj in zip(sh.members, xs, r, v):
        if sp:
            rj = SH._split(rj, 1, sh.m, j)
        out.append(x + (rj * vj).to(x.dtype))
    return out


def _units(cfg: ArchConfig) -> List[Tuple[str, str, Any]]:
    """The model's layers in order, each (kind, module prefix, cache
    index): ("attn", "layers.{i}", i) for the attention-block families;
    the hybrid's groups, each its Mamba2 layers ("mamba", "groups.{g}.{a}",
    (conv key, ssm key, (g, a))) then ("attn", "shared", g), the shared
    block's k/v cache indexed by the group, then its tail layers;
    ("rwkv", "layers.{i}", i) for the ssm family."""
    if cfg.family == "ssm":
        return [("rwkv", f"layers.{i}", i) for i in range(cfg.n_layers)]
    if cfg.family != "hybrid":
        return [("attn", f"layers.{i}", i) for i in range(cfg.n_layers)]
    n_groups, tail = T.layer_counts(cfg)
    out: List[Tuple[str, str, Any]] = []
    for g in range(n_groups):
        out += [("mamba", f"groups.{g}.{a}", ("conv", "ssm", (g, a)))
                for a in range(cfg.attn_every)]
        out.append(("attn", "shared", g))
    return out + [("mamba", f"tail.{t}", ("tail_conv", "tail_ssm", (t,)))
                  for t in range(tail)]


def _members(p: MeshParams, row: int) -> List[int]:
    m = p.mesh.shape["model"]
    return [pos - row * m for pos in p.positions if pos // m == row]


def _tp_train_turn(p: MeshParams, hooks, row: int, mb: Dict[str, Tensor],
                   accum: _Accumulator, grad: bool = True):
    """TP grain: one microbatch of data row ``row`` over its model
    shards; its gradients added to the accumulator in shard order.
    Returns (loss, {"ce_loss", "moe_aux"}); ``grad`` False: the layers'
    forward alone (a routing set's first pass), returning None."""
    cfg = p.cfg
    sink: Dict = {}
    members = _members(p, row)
    dev0 = SH.device_of(p.mesh, row * p.mesh.shape["model"] + members[0])
    anchor = torch.zeros((), device=dev0, requires_grad=True)
    sh = _Shards(p, row, members, hooks.rules,
                 _collect(sink) if grad else None, anchor)
    labels = mb["labels"]
    b, s = labels.shape
    sp = sh.seq_sharded(b, s)
    aux = torch.zeros((), dtype=F32, device=dev0)
    # a checkpointed layer's recomputation runs to its end: stopping
    # early (at the last saved tensor) would recompute the final
    # products of every shard but the last, which no chip of a
    # multi-chip ring does, and a representative trace would not count
    with torch.set_grad_enabled(grad), set_checkpoint_early_stop(False):
        xs = _inputs(sh, mb, sp)
        for kind, pre, ci in _units(cfg):
            body = {"attn": functools.partial(_tp_block, sh, pre, ci, sp),
                    "mamba": functools.partial(_tp_mamba, sh, pre, sp),
                    "rwkv": functools.partial(_tp_rwkv, sh, pre, sp)}[kind]
            out = T._remat(body, cfg)(*xs)
            xs = list(out[:len(xs)])
            if cfg.moe is not None:
                aux = aux + out[-1].to(dev0)
        if not grad:        # the routing is fixed: the head is not needed
            return None
        ce = _cross_entropy(sh, _head(sh, xs, sp), labels)
        loss = ce + T.AUX_LOSS_WEIGHT * aux
        torch.autograd.grad(loss, [anchor])
    _sink_into(sh, sink, accum)
    return loss.detach(), {"ce_loss": ce.detach(), "moe_aux": aux.detach()}


def _sink_into(sh: _Shards, sink: Dict, accum: _Accumulator) -> None:
    """Add one turn's gradients to the accumulator: a leaf the shards
    hold split over "model" by shard (its region), a leaf they hold whole
    as the sum over the shards in shard order (f32)."""
    p = sh.p
    for name in p.names:
        got = {j: functools.reduce(torch.add, sink[(name, j)])
               for j in sh.members if (name, j) in sink}
        if not got:
            continue
        spec = p.specs[name]
        model_split = any("model" in SH.spec_axes(e) for e in spec) and \
            not sh.whole_over_model(name)
        if model_split:
            local = tuple(None if "model" in SH.spec_axes(e) else e
                          for e in spec)
            for j, g in got.items():
                accum.add(name, g, local, j)
        else:
            dev = sh.dev(sh.members[0])
            accum.add(name, SH._ordered_sum([got[j] for j in sorted(got)],
                                            dev, F32))


# ---------------------------------------------------------------------------
# Serving (the TP grain)
# ---------------------------------------------------------------------------
# a serving cache's leaves on the ring: key -> (path in the one-device
# cache tree, batch axis, how "model" splits it: "spec" by the k/v spec,
# "conv" into each shard's [x_j | B C] channels, "heads" into each shard's
# heads, None not at all)
_CACHE_LEAVES = {
    "k": (("kv", "k"), 1, "spec"), "v": (("kv", "v"), 1, "spec"),
    "conv": (("mamba", "conv"), 2, "conv"),
    "ssm": (("mamba", "ssm"), 2, "heads"),
    "tail_conv": (("mamba_tail", "conv"), 1, "conv"),
    "tail_ssm": (("mamba_tail", "ssm"), 1, "heads"),
    "tm_x": (("rwkv", "tm_x"), 1, None), "cm_x": (("rwkv", "cm_x"), 1, None),
    "s": (("rwkv", "s"), 1, "heads"),
}


@dataclasses.dataclass(eq=False)
class MeshCache:
    """A serving cache laid out on the ring: ``shards[i]`` is position
    ``positions[i]``'s ``{key: local leaf}`` (``_CACHE_LEAVES``: ``k``/
    ``v`` (L, B_local, T_local, H_local, D), L the layers or the hybrid's
    groups; the hybrid's ``conv``/``ssm`` and ``tail_conv``/``tail_ssm``;
    rwkv6's ``tm_x``/``cm_x``/``s``).  ``grain`` is the k/v's, "heads" or
    "sequence" (None without attention); ``spec`` and ``shape`` the k/v
    leaves' spec and global shape.  ``split``: the batch is split over the
    data rows; else every row holds all of it and the k/v's sequence is
    split over "data" too (``long_500k``).  A Mamba2 shard holds its
    heads' SSM state and the conv state of its [x_j | B C] channels (the
    B/C channels on every shard, as its step reads them); rwkv6's shard
    its heads' state and the token-shift rows whole."""

    grain: Optional[str]
    spec: tuple
    shape: Tuple[int, ...]
    shards: List[Dict[str, Tensor]]
    positions: Tuple[int, ...]
    cfg: ArchConfig
    mesh: Any
    split: bool

    @property
    def seq_axes(self) -> Tuple[str, ...]:
        """The mesh axes the k/v's sequence is split over."""
        return SH.spec_axes(self.spec[2]) if self.spec else ()

    def seq_block(self, pos: int) -> int:
        """The k/v sequence block position ``pos`` holds."""
        return SH._block(self.seq_axes, SH.coords(self.mesh, pos),
                         self.mesh)[0]

    def merge_group(self, pos: int) -> tuple:
        """What the positions whose decode-attention partials merge with
        ``pos``'s share: their coordinates off the sequence's axes."""
        crd = SH.coords(self.mesh, pos)
        return tuple(crd[a] for a in self.mesh.axis_names
                     if a not in self.seq_axes)


def cache_grain(cfg: ArchConfig, mesh) -> Optional[str]:
    """The reference's multi-grained cache choice (``cache_pspecs``):
    head-sharded where the k/v heads divide over "model", else
    sequence-sharded; None without attention."""
    if cfg.attention_free:
        return None
    m = mesh.shape["model"]
    return "heads" if cfg.n_kv_heads >= m and cfg.n_kv_heads % m == 0 \
        else "sequence"


def _batch_split(mesh, bsz: int) -> bool:
    """Whether a serving batch splits over the data rows (the reference's
    ``bs``); else every row serves all of it."""
    return bsz % n_data(mesh, True) == 0


def _cache_leaves(cfg: ArchConfig, bsz: int, max_len: int
                  ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """key -> (global shape, dtype) of the family's serving cache
    (``sharding.cache_shapes``, as ``init_cache`` lays it out on one
    device)."""
    dtype = torch_dtype(cfg.dtype)
    keys = {path: key for key, (path, _, _) in _CACHE_LEAVES.items()}
    return {keys[path]: (shape, F32 if path[1] in ("ssm", "s") else dtype)
            for path, shape in SH._flat_items(SH.cache_shapes(cfg, bsz,
                                                              max_len))}


def _cut(cache: MeshCache, key: str, t: Tensor, pos: int) -> Tensor:
    """Position ``pos``'s part of the global cache leaf ``t`` (a view, or
    a new tensor for the conv state's channels)."""
    _, bax, kind = _CACHE_LEAVES[key]
    mesh, cfg = cache.mesh, cache.cfg
    if kind == "spec":
        return t[SH.local_slices(cache.spec, t.shape, mesh, pos)]
    m = mesh.shape["model"]
    row, j = divmod(pos, m)
    if cache.split:
        bl = t.shape[bax] // (mesh.size // m)
        t = t.narrow(bax, row * bl, bl)
    if kind == "conv":
        ssm = cfg.ssm
        h0, h1 = _split_range(mamba_heads(cfg), m, j)
        di = ssm.expand * cfg.d_model
        return torch.cat([t[..., h0 * ssm.head_dim:h1 * ssm.head_dim],
                          t[..., di:]], -1)
    if kind == "heads":
        h0, h1 = _split_range(t.shape[bax + 1], m, j)
        return t.narrow(bax + 1, h0, h1 - h0)
    return t


def _new_cache(p: MeshParams, bsz: int, max_len: int,
               fill: Callable[[MeshCache, str, Tensor, int], Tensor]
               ) -> MeshCache:
    """A ``MeshCache`` for ``bsz`` sequences of up to ``max_len`` tokens,
    its leaves ``fill(cache, key, meta stand-in of the local leaf,
    position)``."""
    cfg, mesh = p.cfg, p.mesh
    grain = cache_grain(cfg, mesh)
    leaves = _cache_leaves(cfg, bsz, max_len)
    spec, shape = (), ()
    if grain is not None:
        spec = SH.cache_pspecs_for_batch(cfg, bsz, mesh)["kv"]["k"]
        shape = leaves["k"][0]
        SH.check_divides("kv/k", spec, shape, mesh)
    cache = MeshCache(grain, spec, shape, [], p.positions, cfg, mesh,
                      _batch_split(mesh, bsz))
    for pos in p.positions:
        cache.shards.append({
            key: fill(cache, key, _cut(cache, key, torch.empty(
                s, dtype=dt, device="meta"), pos), pos)
            for key, (s, dt) in leaves.items()})
    return cache


def init_cache(p: MeshParams, bsz: int, max_len: int) -> MeshCache:
    """A zeroed ``MeshCache`` for ``bsz`` sequences of up to ``max_len``
    tokens: the k/v laid out by ``sharding.cache_pspecs``, the recurrent
    states as ``MeshCache`` holds them."""
    return _new_cache(p, bsz, max_len, lambda cache, key, t, pos:
                      torch.zeros(t.shape, dtype=t.dtype,
                                  device=SH.device_of(p.mesh, pos)))


def shard_cache(p: MeshParams, tree: Mapping[str, Any]) -> MeshCache:
    """A one-device serving cache (the tree of ``p``'s model's
    ``init_cache``) laid out on the ring: ``gather_cache``'s inverse."""
    flat = dict(SH._flat_items(tree))
    if ("kv", "k") in flat:
        bsz, max_len = flat[("kv", "k")].shape[1:3]
    else:
        bsz, max_len = flat[("rwkv", "s")].shape[1], 1

    def fill(cache, key, t, pos):
        leaf = flat[_CACHE_LEAVES[key][0]]
        return SH._own_copy(_cut(cache, key, leaf, pos),
                            SH.device_of(p.mesh, pos))
    return _new_cache(p, bsz, max_len, fill)


def gather_cache(cache: MeshCache, mesh, device) -> Dict[str, Any]:
    """The one-device cache tree of a ``MeshCache`` (every position
    held) on ``device``, exactly as the family's ``init_cache`` lays it
    out: ``{"kv"}``, the hybrid's ``{"kv", "mamba"[, "mamba_tail"]}``,
    rwkv6's ``{"rwkv"}``."""
    held = dict(zip(cache.positions, cache.shards))
    m = mesh.shape["model"]
    rows = range(mesh.size // m) if cache.split else (0,)
    out: Dict[str, Any] = {}
    for key in cache.shards[0]:
        path, bax, kind = _CACHE_LEAVES[key]
        if kind == "spec":
            leaf = SH.gather_leaf({pos: sh[key] for pos, sh in held.items()},
                                  cache.spec, cache.shape, mesh, device,
                                  count=False)
        else:
            per_row = []
            for row in rows:
                parts = [held[row * m + j][key].to(device) for j in range(m)]
                if kind == "conv":
                    bc = 2 * cache.cfg.ssm.n_groups * cache.cfg.ssm.state
                    parts = [q[..., :q.shape[-1] - bc] for q in parts] + \
                        [parts[0][..., -bc:]]
                    per_row.append(torch.cat(parts, -1))
                elif kind == "heads":
                    per_row.append(torch.cat(parts, bax + 1))
                else:
                    per_row.append(parts[0])
            leaf = torch.cat(per_row, bax)
        SH._set(out, path, leaf)
    return out


def _serve_shards(p: MeshParams, row: int) -> _Shards:
    if not p.tp:
        raise ValueError("serving on a ring runs the TP grain (shard the "
                         "model with tp=True)")
    check_tp(p.cfg, p.mesh)
    rules = ctx.layout_rules(p.mesh, SH.dp_axes(p.mesh), True, True)
    return _Shards(p, row, _members(p, row), rules)


def _rows_of(p: MeshParams) -> List[int]:
    m = p.mesh.shape["model"]
    return sorted({pos // m for pos in p.positions})


def _logits_out(p: MeshParams, parts: Dict[int, Tensor], bsz: int,
                split: bool) -> Tensor:
    """The global (B, V) logits from each position's (B_local, V / m): of
    the first row where every row serves the whole batch."""
    spec = (SH.dp_axes(p.mesh) if split else None, "model")
    return SH.gather_leaf(parts, spec, (bsz, p.cfg.vocab), p.mesh,
                          SH.device_of(p.mesh, p.positions[0]),
                          receiver=p.positions[0])


@torch.no_grad()
def prefill(p: MeshParams, batch: Mapping[str, Tensor],
            max_len: Optional[int] = None) -> Tuple[Tensor, MeshCache]:
    """The prompt ``batch["tokens"]`` (B, S), or ``batch["embeds"]`` (B,
    S, d) for vlm and audio, through the ring: (the last position's
    global f32 logits (B, V), the ``MeshCache`` of capacity ``max_len``
    (default S) holding its K and V and the recurrent states).  A batch
    that does not divide over the data rows runs whole on every row."""
    cfg = p.cfg
    inputs = _serve_inputs(cfg, batch)
    bsz, s = next(iter(inputs.values())).shape[:2]
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{max_len}")
    cache = init_cache(p, bsz, max_len)
    logits = {}
    for row in _rows_of(p):
        sh = _serve_shards(p, row)
        rows = _rows(inputs, p.mesh, True, row) if cache.split else inputs
        sp = sh.seq_sharded(next(iter(rows.values())).shape[0], s)
        xs = _inputs(sh, rows, sp)
        for kind, pre, ci in _units(cfg):
            if kind == "attn":
                xs = _prefill_block(sh, pre, ci, sp, xs, cache)
            elif kind == "mamba":
                xs = _mamba_layer(sh, pre, sp, xs, (cache,) + ci)
            else:
                xs = _rwkv_layer(sh, pre, sp, xs, (cache, ci))
        for j, lg in zip(sh.members, _head(sh, xs, sp)):
            logits[sh.pos(j)] = lg[:, -1]
    return _logits_out(p, logits, bsz, cache.split), cache


def _serve_inputs(cfg: ArchConfig, batch: Mapping[str, Any]
                  ) -> Dict[str, Tensor]:
    """The model input of a serving batch: ``{"tokens"}`` (int64) or
    ``{"embeds"}``."""
    if cfg.embed_inputs:
        return {"tokens": torch.as_tensor(batch["tokens"]).long()}
    return {"embeds": torch.as_tensor(batch["embeds"])}


def _serve_cf(cfg: ArchConfig) -> Optional[float]:
    """MoE layers serve drop-free (``E / k``), as ``serve.engine`` does."""
    return None if cfg.moe is None else MOE.drop_free_factor(cfg.moe)


def _cache_slot(cache: MeshCache, pos: int) -> Dict[str, Tensor]:
    return cache.shards[cache.positions.index(pos)]


def _prefill_block(sh: _Shards, pre: str, ci: int, sp: bool,
                   xs: List[Tensor], cache: MeshCache) -> List[Tensor]:
    """The attention block ``pre`` over a prompt, its K/V written into
    entry ``ci`` of the k/v cache: each position its sequence block of its
    k/v heads (of every k/v head in the sequence grain)."""
    cfg = sh.p.cfg
    h = [L.apply_norm(sh.tree(pre + ".attn_norm", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    h = _gather_seq(sh, h, sp)
    y = []
    seq = cache.grain == "sequence"
    for j, hj in zip(sh.members, h):
        b, s, _ = hj.shape
        p, spec = sh.attn(pre + ".attn", j, all_kv=seq)
        q, k, v = L._project_qkv(p, hj, spec, torch.arange(s,
                                                          device=hj.device))
        slot = _cache_slot(cache, sh.pos(j))
        tl = slot["k"].shape[2]
        lo = cache.seq_block(sh.pos(j)) * tl
        hi = min(lo + tl, s)
        if hi > lo:
            slot["k"][ci, :, :hi - lo] = k[:, lo:hi]
            slot["v"][ci, :, :hi - lo] = v[:, lo:hi]
        if seq:
            k, v = sh.local_kv(j, k, v)
        out = L.flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)
        out = out.reshape(b, s, spec.n_heads * spec.d_head)
        y.append((out @ p["wo"]).to(hj.dtype))
    xs = [x + yj for x, yj in zip(xs, _combine(sh, y, sp))]
    return _tp_ffn(sh, pre, ci, sp, xs, _serve_cf(cfg))[0]


@torch.no_grad()
def decode(p: MeshParams, cache: MeshCache, batch: Mapping[str, Tensor],
           per_row: bool = False) -> Tuple[Any, MeshCache]:
    """One token per sequence (``batch["tokens"]`` (B, 1), or
    ``batch["embeds"]`` (B, 1, d), at ``batch["position"]`` (B,)) through
    the ring: (global f32 logits (B, V), the cache, written in place).
    The rows run layer by layer together: where the batch is replicated,
    their attention partials merge over "data".  ``per_row``: every data
    row's logits instead, a list (gathered without counting: a check
    that the replicated rows agree, not a step's traffic)."""
    cfg = p.cfg
    inputs = _serve_inputs(cfg, batch)
    inputs["position"] = torch.as_tensor(batch["position"])
    bsz = inputs["position"].shape[0]
    shs = [_serve_shards(p, row) for row in _rows_of(p)]
    xs, pos = [], []
    for sh in shs:
        rows = _rows(inputs, p.mesh, True, sh.row) if cache.split \
            else inputs
        pos.append([rows["position"].long().to(sh.dev(j))
                    for j in sh.members])
        xs.append(_inputs(sh, rows, False, pos[-1]))
    for kind, pre, ci in _units(cfg):
        if kind == "attn":
            xs = _decode_layer(shs, pre, ci, xs, pos, cache)
        elif kind == "mamba":
            xs = [_mamba_decode(sh, pre, ci, x, cache)
                  for sh, x in zip(shs, xs)]
        else:
            xs = [_rwkv_decode(sh, pre, ci, x, cache)
                  for sh, x in zip(shs, xs)]
    logits = {}
    for sh, x in zip(shs, xs):
        for j, lg in zip(sh.members, _head(sh, x, False)):
            logits[sh.pos(j)] = lg[:, -1]
    if per_row:
        return [SH.gather_leaf(
            {sh.pos(j): logits[sh.pos(j)] for j in sh.members},
            (None, "model"), (logits[sh.pos(sh.members[0])].shape[0],
                              cfg.vocab), p.mesh, sh.dev(sh.members[0]),
            receiver=sh.pos(sh.members[0]), count=False)
            for sh in shs], cache
    return _logits_out(p, logits, bsz, cache.split), cache


def _mamba_decode(sh: _Shards, pre: str, ci: tuple, xs: List[Tensor],
                  cache: MeshCache) -> List[Tensor]:
    """One token through Mamba2 layer ``pre`` over the row's model
    shards, each stepping its heads' state in place (cache leaves
    ``ci[:2]`` at ``ci[2]``); the gated norm and out_proj as
    ``_mamba_layer``'s."""
    cfg = sh.p.cfg
    kc, ks, idx = ci
    h = [L.apply_norm(sh.tree(pre + ".norm", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    ps, ys = [], []
    for j, hj in zip(sh.members, h):
        slot = _cache_slot(cache, sh.pos(j))
        conv, ssm = slot[kc][idx], slot[ks][idx]
        p = sh.mamba(pre + ".mamba", j)
        y, new = M2.mamba2_mix_step(p, hj, {"conv": conv, "ssm": ssm},
                                    cfg.ssm)
        conv.copy_(new["conv"])
        ssm.copy_(new["ssm"])
        ps.append(p)
        ys.append(y)
    ms = _mean_square(sh, ys, cfg.ssm.expand * cfg.d_model)
    parts = [M2.gated_norm_out(p, y, m, hj.dtype, partial=True)[:, None]
             for p, y, m, hj in zip(ps, ys, ms, h)]
    return [x + y.to(x.dtype) for x, y in zip(xs, _combine(sh, parts,
                                                            False))]


def _rwkv_decode(sh: _Shards, pre: str, li: int, xs: List[Tensor],
                 cache: MeshCache) -> List[Tensor]:
    """One token through rwkv6 layer ``pre`` over the row's model shards
    (the time mix a one-step scan of each shard's heads), its state
    (entry ``li``) written in place after the layer."""
    cfg = sh.p.cfg
    slots = [_cache_slot(cache, sh.pos(j)) for j in sh.members]
    h = [L.apply_norm(sh.tree(pre + ".ln1", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    parts, news = [], []
    for j, hj, slot in zip(sh.members, h, slots):
        y, s_new = R6.rwkv6_timemix_scan(sh.rwkv(pre + ".mix", j), hj,
                                         slot["tm_x"][li], slot["s"][li],
                                         partial=True)
        parts.append(y)
        news.append(s_new)
    xs = [x + y.to(x.dtype) for x, y in zip(xs, _combine(sh, parts, False))]
    h2 = [L.apply_norm(sh.tree(pre + ".ln2", j), x, cfg.norm)
          for j, x in zip(sh.members, xs)]
    xs = _rwkv_channel_mix(sh, pre + ".mix", False, xs, h2,
                           [slot["cm_x"][li] for slot in slots])
    for slot, hj, h2j, s_new in zip(slots, h, h2, news):
        slot["tm_x"][li].copy_(hj)
        slot["cm_x"][li].copy_(h2j)
        slot["s"][li].copy_(s_new)
    return xs


def _decode_layer(shs: List[_Shards], pre: str, ci: int,
                  xs: List[List[Tensor]], pos: List[List[Tensor]],
                  cache: MeshCache) -> List[List[Tensor]]:
    """One token through attention block ``pre`` (k/v cache entry
    ``ci``) on every data row: local attention where the cache's
    sequence is whole on a position, else ``_decode_attn_merge``."""
    cfg = shs[0].p.cfg
    hs = [[L.apply_norm(sh.tree(pre + ".attn_norm", j), x, cfg.norm)
           for j, x in zip(sh.members, xr)] for sh, xr in zip(shs, xs)]
    if cache.seq_axes:
        ys = _decode_attn_merge(shs, pre + ".attn", ci, hs, pos, cache)
    else:
        ys = []
        for sh, hr, pr in zip(shs, hs, pos):
            yr = []
            for j, hj, pj in zip(sh.members, hr, pr):
                p, spec = sh.attn(pre + ".attn", j)
                slot = _cache_slot(cache, sh.pos(j))
                yj, _ = L.attention_decode(p, hj, spec,
                                           {"k": slot["k"][ci],
                                            "v": slot["v"][ci]}, pj)
                yr.append(yj)
            ys.append(yr)
    out = []
    for sh, xr, yr in zip(shs, xs, ys):
        xr = [x + yj for x, yj in zip(xr, _combine(sh, yr, False))]
        out.append(_tp_ffn(sh, pre, ci, False, xr, _serve_cf(cfg))[0])
    return out


def _decode_attn_merge(shs: List[_Shards], pre: str, ci: int,
                       hs: List[List[Tensor]], pos: List[List[Tensor]],
                       cache: MeshCache) -> List[List[Tensor]]:
    """Decode attention over a cache whose sequence is split: over
    "model" in the sequence grain, and also over "data" where the batch
    is replicated (the heads grain's sequence over "data", the sequence
    grain's over ("data", "model")).  Each position writes the new K/V
    where it holds the token's position, scores its q heads against its
    positions, and the partial softmaxes (max, sum of exponentials,
    weighted values) of the positions holding the same heads merge in
    the order of their sequence blocks: data-major, then model.  A
    position whose positions all lie past the token's has max -inf and
    weight 0.  In the sequence grain every position needs every q head:
    its own, all-gathered over "model", or, where the q heads do not
    divide (q/o gathered whole), all of them projected there."""
    cfg = shs[0].p.cfg
    dh = cfg.d_head
    heads = cache.grain == "heads"
    partial, finish = {}, {}
    for sh, hr, pr in zip(shs, hs, pos):
        every_q = not heads and cfg.n_heads % sh.m == 0
        qs, held = [], []
        for j, hj, pj in zip(sh.members, hr, pr):
            at = sh.pos(j)
            p, spec = sh.attn(pre, j, all_kv=not heads,
                              all_q=not heads and not every_q)
            q, k, v = L._project_qkv(p, hj, spec, pj[:, None])
            h0, h1 = sh.q_heads(j)
            wo = p["wo"] if heads or every_q else p["wo"][h0 * dh:h1 * dh]
            slot = _cache_slot(cache, at)
            kc, vc = slot["k"][ci], slot["v"][ci]
            tl = kc.shape[1]
            start = cache.seq_block(at) * tl
            local = pj - start
            mine = ((local >= 0) & (local < tl))[:, None, None]
            idx = local.clamp(0, tl - 1)
            bidx = torch.arange(hj.shape[0], device=hj.device)
            # every row written, with its old value where the position is
            # not held here (no data-dependent shapes: meta traces it)
            kc[bidx, idx] = torch.where(mine, k[:, 0], kc[bidx, idx])
            vc[bidx, idx] = torch.where(mine, v[:, 0], vc[bidx, idx])
            qs.append(q)
            held.append((at, kc, vc, start + torch.arange(tl,
                                                          device=hj.device)))
            finish[at] = (None if heads else (h0, h1), wo, hj)
        q_all = SH.all_gather(qs, 2, sh.m) if every_q else qs  # (b, 1, H, D)
        for (at, kc, vc, tpos), qa, pj in zip(held, q_all, pr):
            b, hkv = qa.shape[0], kc.shape[2]
            qg = qa.reshape(b, hkv, qa.shape[2] // hkv, dh).float()
            scores = torch.einsum("bhgd,bkhd->bhgk", qg, kc.float()) \
                * (dh ** -0.5)
            valid = tpos[None, :] <= pj[:, None]
            scores = torch.where(valid[:, None, None, :], scores,
                                 float("-inf"))
            mx = scores.max(-1).values
            safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
            w = torch.exp(scores - safe[..., None])
            partial[at] = (mx[None], w.sum(-1)[None],
                           torch.einsum("bhgk,bkhd->bhgd", w,
                                        vc.float())[None])
    groups: Dict[tuple, List[int]] = {}
    for at in partial:
        groups.setdefault(cache.merge_group(at), []).append(at)
    n = int(np.prod([cache.mesh.shape[a] for a in cache.seq_axes]))
    ys = {}
    for members in groups.values():
        members.sort(key=cache.seq_block)
        ms, ls, os_ = (SH.all_gather([partial[a][i] for a in members], 0, n)
                       for i in range(3))
        for at, mj, lj, oj in zip(members, ms, ls, os_):
            big = mj.max(0).values
            num = torch.zeros_like(oj[0])
            den = torch.zeros_like(lj[0])
            for c in range(mj.shape[0]):
                wc = torch.exp(mj[c] - big)
                num = num + wc[..., None] * oj[c]
                den = den + wc * lj[c]
            cut, wo, hj = finish[at]
            b = hj.shape[0]
            out = (num / den[..., None]).reshape(b, -1, dh)
            if cut is not None:
                out = out[:, cut[0]:cut[1]]
            out = out.reshape(b, 1, -1)
            ys[at] = (out.to(hj.dtype) @ wo).to(hj.dtype)
    return [[ys[sh.pos(j)] for j in sh.members] for sh in shs]


# ---------------------------------------------------------------------------
# Restore onto another mesh
# ---------------------------------------------------------------------------
class _Slot:
    """A leaf of the state being restored: which tree, which name."""

    def __init__(self, kind: str, name: str, shape):
        self.kind, self.name, self.shape = kind, name, tuple(shape)


def restore_state(ckpt_dir: str, step: int, like: MeshTrainState, new_mesh,
                  new_specs=None) -> MeshTrainState:
    """Checkpoint ``step`` (global leaves, written from any mesh) laid out
    on ``new_mesh``: by ``new_specs`` (flat ``{name: spec}``, or the
    state spec tree of ``train.step.state_pspecs``, whose ``params`` it
    takes), default the parameter specs of ``like``'s config and grain on
    ``new_mesh``.  Leaves are read and laid out one at a time; dtypes are
    ``like``'s."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.step import TrainState
    p0 = like.params
    if new_specs is None:
        specs = param_specs(p0.cfg, p0.shapes, new_mesh, p0.tp)
    else:
        specs = dict(getattr(new_specs, "params", new_specs))
    positions = tuple(range(new_mesh.size))
    names = p0.names
    slots = {kind: {n: _Slot(kind, n, p0.shapes[n]) for n in names}
             for kind in ("params", "m", "v")}
    tree = TrainState(slots["params"], opt.OptState(slots["m"], slots["v"],
                                                    like.opt[0].step))
    dtypes = {"params": p0.shards[0], "m": like.opt[0].m, "v": like.opt[0].v}
    out = {kind: [{} for _ in positions] for kind in slots}
    steps = None
    leaves, _ = ckpt.read_leaves(ckpt_dir, step, tree)
    for _, leaf, arr in leaves:
        t = torch.from_numpy(np.array(arr))
        if not isinstance(leaf, _Slot):            # the step count
            steps = [SH._own_copy(t, SH.device_of(new_mesh, pos),
                                  leaf.dtype) for pos in positions]
            continue
        t = t.to(dtypes[leaf.kind][leaf.name].dtype)
        parts = SH.shard_leaf(t, specs[leaf.name], new_mesh, positions,
                              leaf.name)
        for tr, part in zip(out[leaf.kind], parts):
            tr[leaf.name] = part
    params = MeshParams(p0.cfg, new_mesh, p0.tp, specs, dict(p0.shapes),
                        out["params"], positions)
    return MeshTrainState(params, [opt.OptState(m, v, s) for m, v, s in
                                   zip(out["m"], out["v"], steps)])
