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
  TP + SP grain (``tp=True``; dense, moe, vlm, audio)  Megatron tensor
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
      With ``seq_shard_activations`` the residual is held
      sequence-sharded over "model" between the sub-blocks (all-gather
      before attention and FFN, reduce-scatter after).  The FSDP dim of
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
position yet weighs 0).  MoE layers serve drop-free (capacity factor
``E / k``, as ``serve.engine`` does), so no row's routing depends on
another's.

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
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.parallel import ctx
from repro_torch.parallel import sharding as SH
from repro_torch.train import optimizer as opt

F32 = torch.float32
Tensor = torch.Tensor
TP_FAMILIES = ("dense", "moe", "vlm", "audio")
# leaves a TP shard must hold split over "model" (the dims are heads, the
# FFN hidden, the experts or the vocabulary); q/o and k/v may be gathered
# whole instead, where their heads do not divide
_TP_SPLIT = ("wq", "bq", "wo", "w_up", "w_gate", "w_down", "embed",
             "lm_head")
_Q = ("wq", "bq", "wo")
_KV = ("wk", "wv", "bk", "bv")


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


def check_tp(cfg: ArchConfig, mesh) -> None:
    """Raises ``ValueError`` where the TP grain cannot run ``cfg`` on
    ``mesh``: a family without it, or fewer q heads than model shards
    (``param_specs`` raises for a split dim that does not divide)."""
    m = mesh.shape["model"]
    if cfg.family not in TP_FAMILIES:
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family has no TP grain on a "
            f"ring (the Mamba2 and rwkv6 TP grains are queued, ROADMAP §1 "
            f"item 6); train it with tp=False")
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
        not."""
        leaf = name.rsplit(".", 1)[-1]
        cfg = self.p.cfg
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
        base, extra = divmod(self.p.cfg.n_heads, self.m)
        h0 = j * base + min(j, extra)
        return h0, h0 + base + (j < extra)

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


def _tp_block(sh: _Shards, li: int, sp: bool, *xs: Tensor
              ) -> Tuple[Tensor, ...]:
    """One attention block over the row's model shards (training): the
    new residual per shard, then, with MoE, the layer's load-balance
    loss."""
    cfg = sh.p.cfg
    pre = f"layers.{li}"
    h = [L.apply_norm(sh.tree(pre + ".attn_norm", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    h = _gather_seq(sh, h, sp)
    y = []
    for j, hj in zip(sh.members, h):
        p, spec = sh.attn(pre + ".attn", j)
        y.append(L.attention_train(p, hj, spec, q_chunk=cfg.q_chunk,
                                   kv_chunk=cfg.kv_chunk))
    xs = [x + yj for x, yj in zip(xs, _combine(sh, y, sp))]
    xs, aux = _tp_ffn(sh, li, sp, xs)
    return tuple(xs) + (() if aux is None else (aux,))


def _tp_ffn(sh: _Shards, li: int, sp: bool, xs: List[Tensor],
            capacity_factor: Optional[float] = None
            ) -> Tuple[List[Tensor], Optional[Tensor]]:
    """norm -> FFN -> residual over the row's model shards: the
    column/row-parallel MLP, or the MoE FFN (``_tp_moe``) with arctic's
    dense MLP beside it.  Returns (the residual per shard, the MoE
    load-balance loss or None)."""
    cfg = sh.p.cfg
    pre = f"layers.{li}"
    h = [L.apply_norm(sh.tree(pre + ".mlp_norm", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    h = _gather_seq(sh, h, sp)
    if cfg.moe is None:
        z = [L.apply_mlp(sh.tree(pre + ".mlp", j), hj, cfg.mlp)
             for j, hj in zip(sh.members, h)]
        return [x + zj for x, zj in zip(xs, _combine(sh, z, sp))], None
    z, aux = _tp_moe(sh, li, h, capacity_factor)
    if cfg.moe.dense_residual_ff:
        z = [zj + L.apply_mlp(sh.tree(pre + ".dense_mlp", j), hj,
                              cfg.mlp).float()
             for j, zj, hj in zip(sh.members, z, h)]
    return [x + yj.to(x.dtype) for x, yj in zip(xs, _combine(sh, z, sp))], \
        aux


def _tp_moe(sh: _Shards, li: int, h: List[Tensor],
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
    pre = f"layers.{li}.moe"
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
        for li in range(cfg.n_layers):
            out = T._remat(functools.partial(_tp_block, sh, li, sp),
                           cfg)(*xs)
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
@dataclasses.dataclass(eq=False)
class MeshCache:
    """A KV cache laid out on the ring: ``shards[i]`` is ``{"k", "v"}`` of
    position ``positions[i]``, each ``(L, B_local, T_local, H_local,
    D)``; ``grain`` "heads" or "sequence"; ``spec`` the leaves' spec."""

    grain: str
    spec: tuple
    shape: Tuple[int, ...]              # the global (L, B, T, Hkv, D)
    shards: List[Dict[str, Tensor]]
    positions: Tuple[int, ...]


def cache_grain(cfg: ArchConfig, mesh) -> str:
    """The reference's multi-grained cache choice (``cache_pspecs``):
    head-sharded where the k/v heads divide over "model", else
    sequence-sharded."""
    m = mesh.shape["model"]
    return "heads" if cfg.n_kv_heads >= m and cfg.n_kv_heads % m == 0 \
        else "sequence"


def init_cache(p: MeshParams, bsz: int, max_len: int) -> MeshCache:
    """A zeroed ``MeshCache`` for ``bsz`` sequences of up to ``max_len``
    tokens, laid out by ``sharding.cache_pspecs``."""
    cfg, mesh = p.cfg, p.mesh
    spec = SH.cache_pspecs_for_batch(cfg, bsz, mesh)["kv"]["k"]
    shape = (cfg.n_layers, bsz, max_len, cfg.n_kv_heads, cfg.d_head)
    SH.check_divides("kv/k", spec, shape, mesh)
    local = SH.local_shape(spec, shape, mesh)
    dtype = torch_dtype(cfg.dtype)
    shards = [{k: torch.zeros(local, dtype=dtype,
                              device=SH.device_of(mesh, pos))
               for k in ("k", "v")} for pos in p.positions]
    return MeshCache(cache_grain(cfg, mesh), spec, shape, shards,
                     p.positions)


def gather_cache(cache: MeshCache, mesh, device) -> Dict[str, Tensor]:
    """The global ``{"k", "v"}`` of a ``MeshCache`` on ``device``."""
    return {k: SH.gather_leaf({pos: sh[k] for pos, sh in
                               zip(cache.positions, cache.shards)},
                              cache.spec, cache.shape, mesh, device,
                              count=False) for k in ("k", "v")}


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


def _logits_out(p: MeshParams, parts: Dict[int, Tensor], bsz: int
                ) -> Tensor:
    """The global (B, V) logits from each position's (B_local, V / m)."""
    spec = (SH.dp_axes(p.mesh), "model")
    return SH.gather_leaf(parts, spec, (bsz, p.cfg.vocab), p.mesh,
                          SH.device_of(p.mesh, p.positions[0]),
                          receiver=p.positions[0])


@torch.no_grad()
def prefill(p: MeshParams, batch: Mapping[str, Tensor],
            max_len: Optional[int] = None) -> Tuple[Tensor, MeshCache]:
    """The prompt ``batch["tokens"]`` (B, S), or ``batch["embeds"]`` (B,
    S, d) for vlm and audio, through the ring: (the last position's
    global f32 logits (B, V), the ``MeshCache`` of capacity ``max_len``
    (default S) holding its K and V)."""
    cfg = p.cfg
    inputs = _serve_inputs(cfg, batch)
    bsz, s = next(iter(inputs.values())).shape[:2]
    cache = init_cache(p, bsz, max_len or s)
    logits = {}
    for row in _rows_of(p):
        sh = _serve_shards(p, row)
        rows = _rows(inputs, p.mesh, True, row)
        sp = sh.seq_sharded(bsz // n_data(p.mesh, True), s)
        xs = _inputs(sh, rows, sp)
        for li in range(cfg.n_layers):
            xs = _prefill_block(sh, li, sp, xs, cache)
        for j, lg in zip(sh.members, _head(sh, xs, sp)):
            logits[sh.pos(j)] = lg[:, -1]
    return _logits_out(p, logits, bsz), cache


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


def _prefill_block(sh: _Shards, li: int, sp: bool, xs: List[Tensor],
                   cache: MeshCache) -> List[Tensor]:
    cfg = sh.p.cfg
    pre = f"layers.{li}"
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
        if seq:
            tl = slot["k"].shape[2]
            lo, hi = j * tl, min((j + 1) * tl, s)
            if hi > lo:
                slot["k"][li, :, :hi - lo] = k[:, lo:hi]
                slot["v"][li, :, :hi - lo] = v[:, lo:hi]
            k, v = sh.local_kv(j, k, v)
        else:
            slot["k"][li, :, :s] = k
            slot["v"][li, :, :s] = v
        out = L.flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)
        out = out.reshape(b, s, spec.n_heads * spec.d_head)
        y.append((out @ p["wo"]).to(hj.dtype))
    xs = [x + yj for x, yj in zip(xs, _combine(sh, y, sp))]
    return _tp_ffn(sh, li, sp, xs, _serve_cf(cfg))[0]


@torch.no_grad()
def decode(p: MeshParams, cache: MeshCache, batch: Mapping[str, Tensor]
           ) -> Tuple[Tensor, MeshCache]:
    """One token per sequence (``batch["tokens"]`` (B, 1), or
    ``batch["embeds"]`` (B, 1, d), at ``batch["position"]`` (B,)) through
    the ring: (global f32 logits (B, V), the cache, written in place)."""
    cfg = p.cfg
    inputs = _serve_inputs(cfg, batch)
    inputs["position"] = torch.as_tensor(batch["position"])
    bsz = inputs["position"].shape[0]
    logits = {}
    for row in _rows_of(p):
        sh = _serve_shards(p, row)
        rows = _rows(inputs, p.mesh, True, row)
        pos = [rows["position"].long().to(sh.dev(j)) for j in sh.members]
        xs = _inputs(sh, rows, False, pos)
        for li in range(cfg.n_layers):
            xs = _decode_block(sh, li, xs, pos, cache)
        for j, lg in zip(sh.members, _head(sh, xs, False)):
            logits[sh.pos(j)] = lg[:, -1]
    return _logits_out(p, logits, bsz), cache


def _decode_block(sh: _Shards, li: int, xs: List[Tensor],
                  pos: List[Tensor], cache: MeshCache) -> List[Tensor]:
    cfg = sh.p.cfg
    pre = f"layers.{li}"
    h = [L.apply_norm(sh.tree(pre + ".attn_norm", j), x, cfg.norm)
         for j, x in zip(sh.members, xs)]
    if cache.grain == "heads":
        y = []
        for j, hj, pj in zip(sh.members, h, pos):
            p, spec = sh.attn(pre + ".attn", j)
            slot = _cache_slot(cache, sh.pos(j))
            yj, _ = L.attention_decode(p, hj, spec, {"k": slot["k"][li],
                                                     "v": slot["v"][li]}, pj)
            y.append(yj)
    else:
        y = _decode_attn_seq(sh, li, h, pos, cache)
    xs = [x + yj for x, yj in zip(xs, _combine(sh, y, False))]
    return _tp_ffn(sh, li, False, xs, _serve_cf(cfg))[0]


def _decode_attn_seq(sh: _Shards, li: int, h: List[Tensor],
                     pos: List[Tensor], cache: MeshCache) -> List[Tensor]:
    """Decode attention over a sequence-sharded cache: each shard writes
    the new K/V where it holds the position, scores every q head against
    its positions, and the shards' partial softmaxes (max, sum of
    exponentials, weighted values) merge in shard order.  A shard whose
    positions all lie past the token's has max -inf and weight 0.  Every
    shard needs every q head: its own, all-gathered, or, where the q heads
    do not divide (q/o gathered whole), all of them projected there."""
    cfg = sh.p.cfg
    pre = f"layers.{li}.attn"
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = hq // hkv
    even = hq % sh.m == 0
    qs, parts, wos = [], [], []
    for j, hj, pj in zip(sh.members, h, pos):
        p, spec = sh.attn(pre, j, all_kv=True, all_q=not even)
        q, k, v = L._project_qkv(p, hj, spec, pj[:, None])
        h0, h1 = sh.q_heads(j)
        wos.append(p["wo"] if even else p["wo"][h0 * dh:h1 * dh])
        slot = _cache_slot(cache, sh.pos(j))
        kc, vc = slot["k"][li], slot["v"][li]
        tl = kc.shape[1]
        local = pj - j * tl
        mine = ((local >= 0) & (local < tl))[:, None, None]
        idx = local.clamp(0, tl - 1)
        bidx = torch.arange(hj.shape[0], device=hj.device)
        # every row written, with its old value where the shard does not
        # hold the position (no data-dependent shapes: meta traces it)
        kc[bidx, idx] = torch.where(mine, k[:, 0], kc[bidx, idx])
        vc[bidx, idx] = torch.where(mine, v[:, 0], vc[bidx, idx])
        qs.append(q)
        parts.append((kc, vc, j * tl + torch.arange(tl, device=hj.device)))
    q_all = SH.all_gather(qs, 2, sh.m) if even else qs  # (b, 1, Hq, D)
    ms, ls, os_ = [], [], []
    for (kc, vc, tpos), qa, pj in zip(parts, q_all, pos):
        b = qa.shape[0]
        qg = qa.reshape(b, hkv, g, dh).float()
        scores = torch.einsum("bhgd,bkhd->bhgk", qg, kc.float()) \
            * (dh ** -0.5)
        valid = tpos[None, :] <= pj[:, None]
        scores = torch.where(valid[:, None, None, :], scores,
                             float("-inf"))
        mx = scores.max(-1).values
        safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
        w = torch.exp(scores - safe[..., None])
        ms.append(mx[None])
        ls.append(w.sum(-1)[None])
        os_.append(torch.einsum("bhgk,bkhd->bhgd", w, vc.float())[None])
    ms = SH.all_gather(ms, 0, sh.m)
    ls = SH.all_gather(ls, 0, sh.m)
    os_ = SH.all_gather(os_, 0, sh.m)
    y = []
    for j, mj, lj, oj, hj, wo in zip(sh.members, ms, ls, os_, h, wos):
        big = mj.max(0).values
        num = torch.zeros_like(oj[0])
        den = torch.zeros_like(lj[0])
        for c in range(mj.shape[0]):
            wc = torch.exp(mj[c] - big)
            num = num + wc[..., None] * oj[c]
            den = den + wc * lj[c]
        out = (num / den[..., None]).reshape(hj.shape[0], hq, dh)
        h0, h1 = sh.q_heads(j)
        out = out[:, h0:h1].reshape(hj.shape[0], 1, (h1 - h0) * dh)
        y.append((out.to(hj.dtype) @ wo).to(hj.dtype))
    return y


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
