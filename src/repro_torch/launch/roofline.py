"""Roofline per (arch x shape) cell on one H100.

    python -m repro_torch.launch.roofline --arch qwen2.5-3b --shape train_4k \\
        [--batch 2 --seq 4096 --microbatches 2] [--out result.json]

Port of ``repro.launch.roofline``.  The reference probes XLA programs at
one and two layers and extrapolates, because ``cost_analysis()`` counts a
scanned layer once.  Eager PyTorch runs every layer, so the port's counts
(``launch.dryrun``: the step run on the ``meta`` device under a
dispatch-mode counter) cover the full depth directly; cost affine in depth
is a property its tests check, not the method.  A train cell is the
reference's probe: one microbatch with the update skipped, times the
number of microbatches, plus the analytic AdamW (``OPT_FLOPS_PER_PARAM``,
``OPT_BYTES_PER_PARAM``, the reference's constants).

Terms, on one H100 SXM (datasheet constants, dense, at the 700 W limit):

  compute     the FLOPs of each dtype over that dtype's peak, summed:
              bf16 989 TFLOP/s (tensor cores), f32 67 TFLOP/s (CUDA
              cores: ``torch.matmul`` keeps TF32 off in the port; the f32
              flash kernel runs three TF32 terms on the tensor cores at
              f32 accuracy, priced here as f32 all the same).  The
              reference's single TPU peak would price the f32 products
              (the LM head, rwkv6's time-mix) 15x too cheap here;
  memory      bytes over the HBM3 rate, 3.35 TB/s;
  collective  collective bytes over NVLink, 450 GB/s a direction: zero
              while the port drives one device.

``bound_s`` is the largest term: no step of the port's code on this
card can take less.  It grows with the port's own traffic (every eager
op's bytes count), so it is a diagnostic of where the port's time can
go, read per op in ``dryrun``'s ``by_op``; ``measured_fraction``, the
bound over a measured time, checks the count (above 1 means the count
is wrong).  ``roofline_fraction`` keeps the reference's meaning: the
model FLOPs' time at the bf16 peak over the bound.

A step's share of the card, the cells' MFU-like metric, is measured
against the work the model itself needs, from its config alone
(``model_terms``, ``model_bound_s``): ``model_fraction`` is that bound
over the measured time, and a change that only moves the port's own
traffic leaves its numerator alone.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.configs.registry import ALIASES, get_config

# H100 SXM datasheet (NVIDIA), dense rates at the 700 W limit.
PEAK_FLOPS_BF16 = 989e12       # H100 SXM datasheet: bf16 tensor cores
PEAK_FLOPS_F32 = 67e12         # H100 SXM datasheet: f32 CUDA cores (no TF32)
HBM_BW = 3.35e12               # H100 SXM datasheet: HBM3 bytes/s
LINK_BW = 450e9                # H100 SXM datasheet: NVLink bytes/s a direction
PEAK_FLOPS = {"bf16": PEAK_FLOPS_BF16, "f16": PEAK_FLOPS_BF16,
              "f32": PEAK_FLOPS_F32, "f64": PEAK_FLOPS_F32}
OPT_FLOPS_PER_PARAM = 15.0
OPT_BYTES_PER_PARAM = 20.0
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
_KV_CACHE_FAMILIES = ("dense", "moe", "vlm", "audio")


def model_flops(cfg: ArchConfig, shape: str, *,
                batch_override: Optional[int] = None,
                seq_override: Optional[int] = None) -> float:
    """6ND for a train cell, 2ND for a serve cell (N active parameters, D
    tokens: one per sequence in decode); the overrides cut the cell's
    batch and sequence length as ``dryrun.run_cell`` does."""
    spec = SHAPES[shape]
    kind = spec["kind"]
    batch = batch_override or spec["global_batch"]
    seq = seq_override or spec["seq_len"]
    tokens = batch * (seq if kind != "decode" else 1)
    n = cfg.active_param_count()
    return (6.0 if kind == "train" else 2.0) * n * tokens


def model_terms(cfg: ArchConfig, shape: str, *,
                batch_override: Optional[int] = None,
                seq_override: Optional[int] = None) -> Dict[str, float]:
    """The least compute and memory seconds on one H100 of the work the
    model itself needs, from its config:

      compute  ``model_flops``, the LM head's share (d_model x vocab per
               token, 6 or 2 FLOPs each; both packages compute the head
               in f32) at the f32 peak, the rest at the bf16 peak;
      memory   the bytes a step cannot avoid: a train step's AdamW update
               (``OPT_BYTES_PER_PARAM`` per parameter); a serve step's
               active weights read once in the config's dtype and, for
               the attention families, the KV cache written once
               (prefill) or read once (decode).  The recurrent states
               and the hybrid's shared-block cache are left out, so the
               bound stays a lower one."""
    spec = SHAPES[shape]
    kind = spec["kind"]
    batch = batch_override or spec["global_batch"]
    seq = seq_override or spec["seq_len"]
    tokens = batch * (seq if kind != "decode" else 1)
    flops = model_flops(cfg, shape, batch_override=batch_override,
                        seq_override=seq_override)
    head = (6.0 if kind == "train" else 2.0) * cfg.d_model * cfg.vocab \
        * tokens
    compute = head / PEAK_FLOPS_F32 + (flops - head) / PEAK_FLOPS_BF16
    if kind == "train":
        nbytes = OPT_BYTES_PER_PARAM * cfg.param_count()
    else:
        itemsize = _ITEMSIZE[cfg.dtype]
        nbytes = cfg.active_param_count() * itemsize
        if cfg.family in _KV_CACHE_FAMILIES:
            nbytes += 2 * cfg.n_layers * batch * seq * cfg.n_kv_heads \
                * cfg.d_head * itemsize
    return {"compute": compute, "memory": nbytes / HBM_BW}


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """The FLOPs of each dtype over its peak, summed (an unknown dtype at
    the f32 rate)."""
    return sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS_F32)
               for dt, f in flops_by_dtype.items())


def terms(cell: dict) -> Dict[str, float]:
    """The compute, memory and collective seconds of a dry-run cell."""
    return {"compute": compute_seconds(cell["flops_by_dtype"]),
            "memory": cell["cost"]["bytes_accessed"] / HBM_BW,
            "collective": cell["collectives"]["total_bytes"] / LINK_BW}


def run_cell(arch: str, shape: str, *, batch_override: Optional[int] = None,
             seq_override: Optional[int] = None,
             n_microbatches: Optional[int] = None) -> dict:
    """The roofline of one cell (see the module docstring), with
    ``dryrun.run_cell``'s overrides."""
    return dict(run_config(get_config(arch), shape,
                           batch_override=batch_override,
                           seq_override=seq_override,
                           n_microbatches=n_microbatches), arch=arch)


def run_config(cfg: ArchConfig, shape: str, *,
               batch_override: Optional[int] = None,
               seq_override: Optional[int] = None,
               n_microbatches: Optional[int] = None, mesh=None) -> dict:
    """``run_cell`` for a config (a reduced one, in tests), on ``mesh``
    (of ``meta`` devices) when given: the per-chip terms of the dry run's
    model, and the model's own terms per chip (over ``n_chips``)."""
    from repro_torch.launch import dryrun
    cell = dryrun.run_config(cfg, shape, batch_override=batch_override,
                             seq_override=seq_override,
                             n_microbatches=n_microbatches, mesh=mesh)
    if cell["status"] != "ok":
        return {"arch": cfg.name, "shape": shape, "status": cell["status"],
                "reason": cell["reason"]}
    n_chips = cell["n_chips"]
    t = terms(cell)
    dominant = max((t["compute"], "compute"), (t["memory"], "memory"),
                   (t["collective"], "collective"))[1]
    bound_s = max(t.values())
    mf = model_flops(cfg, shape, batch_override=batch_override,
                     seq_override=seq_override)
    flops = cell["cost"]["flops"]
    hlo_global = flops * n_chips
    mt = {k: v / n_chips for k, v in
          model_terms(cfg, shape, batch_override=batch_override,
                      seq_override=seq_override).items()}
    return {
        "arch": cfg.name, "shape": shape, "status": "ok", "n_chips": n_chips,
        "n_microbatches": cell.get("n_microbatches", 1),
        "batch": cell["batch"], "seq_len": cell["seq_len"],
        "per_chip": {"flops": flops, "bytes": cell["cost"]["bytes_accessed"],
                     "collective_bytes": cell["collectives"]["total_bytes"]},
        "flops_by_dtype": cell["flops_by_dtype"],
        "terms_s": t, "dominant": dominant, "bound_s": bound_s,
        "model_flops_global": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": mf / hlo_global if hlo_global else None,
        "roofline_fraction": (mf / n_chips / PEAK_FLOPS_BF16) / bound_s
        if bound_s > 0 else None,
        "model_terms_s": mt, "model_bound_s": max(mt.values()),
        "memory": cell["memory"], "fits": cell["fits"],
        "params_counted": cell["params_counted"],
        "coll_counts_probe2": cell["collectives"]["counts"],
        "probe_s": cell["trace_s"],
    }


def measured_fraction(result: dict, measured_s: float) -> float:
    """The traced bound over a step's measured time: a check of the count
    (a step cannot beat the port's own traffic)."""
    return result["bound_s"] / measured_s


def model_fraction(result: dict, measured_s: float) -> float:
    """The share of the card a step measured at ``measured_s`` reaches:
    the model's own bound (``model_terms``) over its time."""
    return result["model_bound_s"] / measured_s


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ALIASES))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="cut the shape's sequence length")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="a train cell's microbatches (default the plan's)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    result = run_cell(args.arch, args.shape, batch_override=args.batch,
                      seq_override=args.seq, n_microbatches=args.microbatches)
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
