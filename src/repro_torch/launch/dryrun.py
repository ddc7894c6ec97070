"""Dry run of one (arch x shape) cell on one device: memory, FLOPs, bytes.

    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k \\
        [--batch 2 --seq 4096 --microbatches 2] [--multi-pod] \\
        [--out result.json]
    python -m repro_torch.launch.dryrun --grid [--jobs 4] [--out grid.jsonl]

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell under its production mesh and reads XLA's ``memory_analysis()`` and
``cost_analysis()``.  Eager PyTorch has no compiler to ask, so the port
runs the step itself on the ``meta`` device (shapes, no data) under
``CostCounter``, a ``TorchDispatchMode`` that sees every ATen op the step
executes (the backward's, and the checkpointed layers' recomputation,
included) and records:

  FLOPs      of the products, by dtype (``torch.utils.flop_counter``'s
             formulas); elementwise work is not counted as FLOPs and shows
             in the bytes;
  bytes      read and written per op: each tensor argument read once (its
             own elements, not its storage's), each output written once;
             an op whose outputs share an input's storage without writing
             it (a view: ``view``, ``t``, ``expand``, ``as_strided``, ...)
             moves nothing, a factory that only allocates (``empty``)
             moves nothing, an op that overwrites its destination
             (``copy_``, ``fill_``, ``zero_``) does not read it, and a
             gather (``embedding``, ``index_select``, ``gather``,
             ``index``) reads its table only where it gathers;
  live bytes the storages alive over the step: the arguments' (the state,
             the batch, the cache) from the start, each new storage from
             the op that allocates it until Python releases it; the
             peak is the most at once.

The LM kernels are not ATen ops: on ``meta`` their wrappers return an
empty output and report their closed-form FLOPs and bytes
(``kernels/meta.py``), which the counter adds; that includes
``FlashAttention``'s backward (``flash_attention_bwd``), once per layer
and microbatch.  The counter leaves out what a trace cannot see: the caching
allocator's rounding, kernels' workspaces, and anything computed on the
host.  On one device there are no collectives.

On a mesh (``--multi-pod``: the reference's (2, 16, 16) production mesh;
``run_config(mesh=...)``: any) the step is the ring's
(``parallel/ring.py``) over ``meta`` devices.  Tracing every position of
a 512-chip mesh would take hours, so the cell traces one representative
position (mesh position 0: its slices of the state, its data row, its
model shard), whose collectives are counted (``repro.mesh.*``) and not
executed; its counts are one chip's, with ``"source": "model"`` on the
result.  The ring's positions are symmetric, so the model of the whole
ring is the chip's counts times the chips, plus what only one position
does (the DP grain's gradient norm gather, ``ring.norm_gather_bytes``;
a serving step's f32 logits, gathered on position 0):
``collectives["ring_bytes"]``, which a full trace of a small ring's
``repro.mesh.*`` counters must equal (``tests/test_torch_mesh_lm.py``).
A mesh train cell traces the plan's microbatches with the update (no
probe): its FLOPs are the traced step's plus the analytic AdamW of the
chip's slices.

A cell's result keeps the reference's keys (``memory`` argument, output,
temp and peak bytes; ``cost`` flops and bytes_accessed; ``collectives``;
``params``; ``active_params``) and adds ``params_counted`` (the meta
model's parameters, which ``ArchConfig.param_count()`` may not match: it
leaves out the hybrid's shared attention block), ``flops_by_dtype`` and
``fits`` (peak within the card's memory, the datasheet's 80 GB without a
card).  A train cell follows the reference's probe: one microbatch of
``default_plan``'s with the update skipped, its cost times the number of
microbatches plus the analytic AdamW (``roofline.OPT_*``); its memory
from a second trace, the step itself with its update at
``min(n_microbatches, 2)`` microbatches (later microbatches repeat the
second's live set).  ``long_500k`` is skipped for full-attention archs.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import multiprocessing
import os
import sys
import time
import weakref
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ALIASES, get_config

aten = torch.ops.aten

# H100 SXM datasheet: HBM3 capacity of one card (no card to read it from)
H100_MEMORY_BYTES = 80 * 1024 ** 3

_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided}
_OVERWRITE = {aten.copy_, aten.fill_, aten.zero_}
_GATHER = {aten.embedding, aten.index_select, aten.gather, aten.index}
_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.float64: "f64"}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs (by dtype), the bytes and the live storages of
    every ATen op run while it is active (see the module docstring), and
    the LM kernels' closed-form costs (``kernel``, called by
    ``kernels.meta``).  ``add_arguments`` registers storages that exist
    before the step."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, int] = collections.defaultdict(int)
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self.by_op: Dict[str, List[int]] = collections.defaultdict(
            lambda: [0, 0, 0])               # name -> [calls, flops, bytes]
        self._live: Dict[int, int] = {}
        self._arguments: set = set()

    # -- storages ----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        n = self._live.pop(key, 0)
        self.live_bytes -= n

    def add_arguments(self, *trees: Any) -> int:
        """Register every tensor storage of ``trees`` as a live argument;
        returns the bytes newly registered."""
        before = self.live_bytes
        for t in _tensors(trees):
            key = _key(t)
            if key not in self._live:
                self._arguments.add(key)
                self._track(t)
        added = self.live_bytes - before
        self.argument_bytes += added
        return added

    def output_bytes(self, outputs: Any) -> int:
        """Bytes of the distinct live storages of ``outputs`` that are
        not arguments."""
        seen = {}
        for t in _tensors(outputs):
            key = _key(t)
            if key not in self._arguments and key in self._live:
                seen[key] = self._live[key]
        return sum(seen.values())

    # -- costs ---------------------------------------------------------
    def kernel(self, name: str, flops: int, dtype: torch.dtype,
               nbytes: int) -> None:
        """One LM kernel's closed-form work (``kernels.meta``)."""
        self.flops[_DTYPE.get(dtype, str(dtype))] += flops
        self.bytes_accessed += nbytes
        rec = self.by_op[f"kernel:{name}"]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {_key(t) for t in ins}
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        written = [t for t in outs if writes or _key(t) not in in_keys]
        nbytes = 0
        if written and packet not in _NO_TRAFFIC:
            nbytes = sum(_nbytes(t) for t in written)
            if packet in _GATHER:        # the table, where gathered
                nbytes += sum(_nbytes(t) for t in ins[1:]) + nbytes
            elif packet in _OVERWRITE:   # the destination is not read
                nbytes += sum(_nbytes(t) for t in ins[1:])
            else:
                nbytes += sum(_nbytes(t) for t in ins)
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            dt = ins[0].dtype if ins else torch.float32
            self.flops[_DTYPE.get(dt, str(dt))] += flops
        self.bytes_accessed += nbytes
        rec = self.by_op[str(packet).split(".", 1)[-1]]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class Trace:
    """What one traced step shows (see ``CostCounter``)."""

    flops_by_dtype: Dict[str, int]
    bytes_accessed: int
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    params_counted: int
    by_op: Dict[str, List[int]]

    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    @property
    def temp_bytes(self) -> int:
        return max(0, self.peak_bytes - self.argument_bytes
                   - self.output_bytes)


def run_traced(fn, arguments: Any, params_counted: int) -> Trace:
    """Run ``fn()`` under a ``CostCounter`` (and ``kernels.meta``'s
    recording) with ``arguments`` registered live; returns its ``Trace``."""
    from repro_torch.kernels import meta
    counter = CostCounter()
    counter.add_arguments(arguments)
    with meta.recording(counter), counter:
        out = fn()
    return Trace(dict(counter.flops), counter.bytes_accessed,
                 counter.argument_bytes, counter.output_bytes(out),
                 counter.peak_bytes, params_counted,
                 {k: list(v) for k, v in counter.by_op.items()})


def collective_bytes_per_chip(hlo: str = "") -> dict:
    """The reference's collective summary, at one device: every count and
    byte total is zero (there is no HLO and no second device)."""
    del hlo
    return {"counts": {c: 0 for c in _COLLECTIVES},
            "bytes": {c: 0 for c in _COLLECTIVES}, "total_bytes": 0}


def card_memory_bytes() -> int:
    """The card's memory, or the H100 datasheet's 80 GB without one."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return H100_MEMORY_BYTES


def skip_reason(cfg, shape: str) -> Optional[str]:
    """Why a cell is skipped (the reference's rule), or None."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch; long_500k requires "
                "sub-quadratic attention")
    return None


def _train_traces(cfg, shape: str, mesh, batch_override, seq_override,
                  n_microbatches):
    """(probe, memory trace, n_mb, microbatch) of a train cell."""
    from repro_torch.train import step as S
    plan = S.default_plan(cfg, shape, mesh)
    n_mb = n_microbatches or plan.n_microbatches
    b = batch_override or SHAPES[shape]["global_batch"]
    mb = max(b // n_mb, 1)
    probe = S.trace_train_step(
        cfg, shape, mesh, dataclasses.replace(plan, n_microbatches=1,
                                              skip_update=True),
        batch_override=mb, seq_override=seq_override)
    n_mem = min(n_mb, 2)
    mem = S.trace_train_step(
        cfg, shape, mesh, dataclasses.replace(plan, n_microbatches=n_mem),
        batch_override=n_mem * mb, seq_override=seq_override)
    return probe, mem, n_mb, mb


def run_cell(arch: str, shape: str, multi_pod: bool = False, *,
             batch_override: Optional[int] = None,
             seq_override: Optional[int] = None,
             n_microbatches: Optional[int] = None) -> dict:
    """The dry run of one cell (see the module docstring).
    ``batch_override``/``seq_override`` substitute the shape's global
    batch and sequence length, ``n_microbatches`` the plan's (a train cell
    cut to what one card runs).  ``multi_pod`` traces one chip of the
    (2, 16, 16) production mesh on ``meta`` (see the module docstring)."""
    mesh = None
    if multi_pod:
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=True, device="meta")
    return dict(run_config(get_config(arch), shape,
                           batch_override=batch_override,
                           seq_override=seq_override,
                           n_microbatches=n_microbatches, mesh=mesh),
                arch=arch)


def run_config(cfg, shape: str, *, batch_override: Optional[int] = None,
               seq_override: Optional[int] = None,
               n_microbatches: Optional[int] = None, mesh=None,
               representative: bool = True, tp: Optional[bool] = None
               ) -> dict:
    """``run_cell`` for a config (a reduced one, in tests), on one
    ``meta`` device or on ``mesh`` (of ``meta`` devices), there one
    representative position unless ``representative`` is False (every
    position traced: the check of the model).  ``tp`` sets a mesh train
    cell's grain (default ``default_plan``'s: the TP + SP grain from
    d_model 4096)."""
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import step as S
    why = skip_reason(cfg, shape)
    multi_pod = mesh is not None and "pod" in mesh.axis_names
    if why:
        return {"arch": cfg.name, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    if mesh is not None and mesh.size > 1:
        return _mesh_cell(cfg, shape, mesh, batch_override, seq_override,
                          n_microbatches, representative, tp)
    mesh = make_host_mesh("meta")
    kind = SHAPES[shape]["kind"]
    t0 = time.perf_counter()
    if kind == "train":
        probe, mem, n_mb, mb = _train_traces(cfg, shape, mesh,
                                             batch_override, seq_override,
                                             n_microbatches)
        flops = {k: v * n_mb for k, v in probe.flops_by_dtype.items()}
        flops["f32"] = flops.get("f32", 0) + \
            roofline.OPT_FLOPS_PER_PARAM * cfg.param_count()
        byts = probe.bytes_accessed * n_mb + \
            roofline.OPT_BYTES_PER_PARAM * cfg.param_count()
        extra = {"n_microbatches": n_mb, "microbatch": mb}
    else:
        mem = S.trace_serve_step(cfg, shape, mesh,
                                 batch_override=batch_override,
                                 seq_override=seq_override)
        flops, byts, extra = dict(mem.flops_by_dtype), mem.bytes_accessed, {}
    capacity = card_memory_bytes()
    return {
        "arch": cfg.name, "shape": shape, "multi_pod": False,
        "status": "ok", "n_chips": 1,
        "trace_s": round(time.perf_counter() - t0, 1),
        "batch": batch_override or SHAPES[shape]["global_batch"],
        "seq_len": seq_override or SHAPES[shape]["seq_len"], **extra,
        "memory": {"argument_bytes": mem.argument_bytes,
                   "output_bytes": mem.output_bytes,
                   "temp_bytes": mem.temp_bytes,
                   "peak_bytes": mem.peak_bytes},
        "cost": {"flops": float(sum(flops.values())),
                 "bytes_accessed": float(byts)},
        "flops_by_dtype": {k: float(v) for k, v in flops.items()},
        "collectives": collective_bytes_per_chip(),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "params_counted": mem.params_counted,
        "fits": mem.peak_bytes <= capacity,
        "capacity_bytes": capacity,
    }


_KIND_NAMES = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
               "all_reduce": "all-reduce"}


def _mesh_cell(cfg, shape: str, mesh, batch_override, seq_override,
               n_microbatches, representative: bool,
               tp: Optional[bool] = None) -> dict:
    """A cell on a ring of ``meta`` devices (see the module docstring):
    one chip's trace and counts, and the model of the whole ring."""
    from repro_torch.launch import roofline
    from repro_torch.parallel import sharding
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S
    kind = SHAPES[shape]["kind"]
    positions = (0,) if representative else None
    n_chips = mesh.size
    base = {"arch": cfg.name, "shape": shape,
            "multi_pod": "pod" in mesh.axis_names, "n_chips": n_chips,
            "mesh": mesh.shape, "source": "model"}
    plan = S.default_plan(cfg, shape, mesh)
    if n_microbatches:
        plan = dataclasses.replace(plan, n_microbatches=n_microbatches)
    if tp is not None:
        plan = dataclasses.replace(plan, tp=tp)
    before = sharding.collective_bytes()
    calls0 = sharding.collective_calls()
    t0 = time.perf_counter()
    extra: Dict[str, Any] = {}
    if kind == "train":
        moments = "bfloat16" if cfg.param_count() >= 30e9 else "float32"
        opt_cfg = O.AdamWConfig(moments_dtype=moments)
        mem = S.trace_train_step(cfg, shape, mesh, plan, batch_override,
                                 seq_override=seq_override, opt_cfg=opt_cfg,
                                 positions=positions)
        local = _local_params(cfg, mesh, plan.tp)
        flops = dict(mem.flops_by_dtype)
        flops["f32"] = flops.get("f32", 0) + \
            roofline.OPT_FLOPS_PER_PARAM * local
        extra = {"n_microbatches": plan.n_microbatches, "tp": plan.tp,
                 "seq_shard_activations": plan.seq_shard_activations}
    else:
        mem = S.trace_serve_step(cfg, shape, mesh,
                                 batch_override=batch_override,
                                 seq_override=seq_override,
                                 positions=positions)
        flops = dict(mem.flops_by_dtype)
    after = sharding.collective_bytes()
    counted = {k: after[k] - before[k] for k in after}
    calls = {_KIND_NAMES[k]: v - calls0[k]
             for k, v in sharding.collective_calls().items()}
    if representative:
        ring_bytes = {k: v * n_chips for k, v in counted.items()}
        if kind == "train" and not plan.skip_update and \
                not (plan.tp and mesh.shape["model"] > 1):
            ring_bytes["all_gather"] += _norm_bytes(cfg, mesh, plan)
        if kind != "train":     # the logits, gathered on position 0 alone
            ring_bytes["all_gather"] -= (n_chips - 1) * _logits_bytes(
                cfg, mesh, batch_override or SHAPES[shape]["global_batch"])
    else:
        ring_bytes = dict(counted)
    chip = {k: v // n_chips for k, v in ring_bytes.items()} \
        if not representative else counted
    capacity = card_memory_bytes()
    return dict(
        base, status="ok", trace_s=round(time.perf_counter() - t0, 1),
        batch=batch_override or SHAPES[shape]["global_batch"],
        seq_len=seq_override or SHAPES[shape]["seq_len"], **extra,
        memory={"argument_bytes": mem.argument_bytes,
                "output_bytes": mem.output_bytes,
                "temp_bytes": mem.temp_bytes,
                "peak_bytes": mem.peak_bytes},
        cost={"flops": float(sum(flops.values())),
              "bytes_accessed": float(mem.bytes_accessed)},
        flops_by_dtype={k: float(v) for k, v in flops.items()},
        flops_traced=float(mem.flops),
        collectives={"counts": calls,
                     "bytes": {_KIND_NAMES[k]: v for k, v in chip.items()},
                     "total_bytes": int(sum(chip.values())),
                     "ring_bytes": {_KIND_NAMES[k]: v
                                    for k, v in ring_bytes.items()}},
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        params_counted=mem.params_counted,
        fits=mem.peak_bytes <= capacity, capacity_bytes=capacity)


def _logits_bytes(cfg, mesh, b: int) -> int:
    """The all-gather bytes of a serving step's f32 logits (``ring.
    _logits_out``): over every position where the batch splits over the
    data rows, else over the first row's model shards (none with one)."""
    from repro_torch.parallel import ring
    spans = mesh.size if ring._batch_split(mesh, b) else mesh.shape["model"]
    return b * cfg.vocab * 4 if spans > 1 else 0


def _local_params(cfg, mesh, tp: bool) -> int:
    """The parameters one chip holds (position 0's slices)."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import ring, sharding
    model = T.init_params(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = ring.param_specs(cfg, shapes, mesh, tp)
    return sum(int(torch.Size(sharding.local_shape(specs[n], s, mesh))
                   .numel()) for n, s in shapes.items())


def _norm_bytes(cfg, mesh, plan) -> int:
    """``ring.norm_gather_bytes`` of ``cfg`` laid out on ``mesh`` (the DP
    grain)."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import ring
    model = T.init_params(cfg, device="meta")
    p = ring.shard_params(model, mesh, plan.tp, positions=(0,))
    if mesh.size * plan.n_microbatches == 1:     # the gradients as they come
        dtype = model.dtype
    else:
        dtype = torch.bfloat16 if plan.grad_compression == "bf16" \
            else torch.float32
    return ring.norm_gather_bytes(p, dtype)


def grid_cells() -> List[tuple]:
    """Every (arch, shape) of the full-size grid, in a fixed order."""
    return [(a, s) for a in sorted(ALIASES) for s in SHAPES]


def _cell_line(cell: tuple, capacity: int) -> dict:
    arch, shape = cell
    r = run_cell(arch, shape)
    if r["status"] != "ok":
        return r
    line = {k: r[k] for k in ("arch", "shape", "status", "memory", "cost",
                              "params", "params_counted", "trace_s")}
    line["fits"] = r["memory"]["peak_bytes"] <= capacity
    return line


def _trace_only() -> None:
    """A grid worker's initializer: it traces on ``meta`` and opens no
    card."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _longest_first(cell: tuple) -> tuple:
    """Submission order of a grid: train cells first (three microbatch
    traces each), the recurrent families first among them (their scans
    trace longest: rwkv6-3b's train cell is the grid's longest on the
    H100's host, PERF.md §6), then deeper models first."""
    arch, shape = cell
    cfg = get_config(arch)
    return (SHAPES[shape]["kind"] != "train",
            cfg.family not in ("ssm", "hybrid"), -cfg.n_layers)


def run_grid(cells: Optional[Sequence[tuple]] = None, jobs: int = 1
             ) -> Iterable[dict]:
    """``run_cell`` over ``cells`` (default the full grid) in ``jobs``
    worker processes that see no card, the longest submitted first;
    yields each cell's summary line in the order of ``cells``, ``fits``
    against this process's card (``card_memory_bytes``)."""
    cells = list(cells or grid_cells())
    capacity = card_memory_bytes()
    if jobs <= 1:
        yield from (_cell_line(cell, capacity) for cell in cells)
        return
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(jobs, mp_context=spawn,
                             initializer=_trace_only) as pool:
        futures = {cell: pool.submit(_cell_line, cell, capacity)
                   for cell in sorted(cells, key=_longest_first)}
        for cell in cells:
            yield futures[cell].result()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ALIASES))
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--grid", action="store_true",
                    help="every (arch x shape) cell, one JSON line each")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="cut the shape's sequence length")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="a train cell's microbatches (default the plan's)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.grid:
        lines = []
        for line in run_grid(jobs=args.jobs):
            print(json.dumps(line), flush=True)
            lines.append(line)
        if args.out:
            with open(args.out, "w") as f:
                f.writelines(json.dumps(x) + "\n" for x in lines)
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --grid")
    result = run_cell(args.arch, args.shape, args.multi_pod,
                      batch_override=args.batch, seq_override=args.seq,
                      n_microbatches=args.microbatches)
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return 0 if result["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
