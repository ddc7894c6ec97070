"""Markdown tables of the dry-run and roofline results.

Port of ``scripts/make_experiments.py``, over what the port's
``launch/dryrun.py`` and ``launch/roofline.py`` write:

    python -m repro_torch.launch.dryrun --arch A --shape S \\
        --out results/dryrun_A_S_sp.json            # ... --multi-pod: _mp
    python -m repro_torch.launch.roofline --arch A --shape S \\
        --out results/roofline_A_S.json
    python -m repro_torch.launch.dryrun --grid --out grid.jsonl
    python -m repro_torch.launch.make_experiments [--results results] \\
        [--grid grid.jsonl] > EXPERIMENTS_tables.md

``--results DIR`` holds files under the reference's names, each one
``--out`` result: ``dryrun_<arch>_<shape>_{sp,mp}.json`` (one device, and
one chip of the (2, 16, 16) mesh) and ``roofline_<arch>_<shape>.json``.
``--grid FILE`` (``dryrun --grid``'s JSON lines) replaces the
single-device dry-run files.  The table functions take the cells
themselves, so a caller that holds them renders them directly.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.launch import roofline as R

Cell = Dict
SINGLE_HEADER = "## Dry-run (one H100, the single-device cells: n_chips 1)"
MULTI_POD_HEADER = ("## Dry-run (multi-pod (2, 16, 16) mesh = 512 chips, "
                    "modeled from one representative chip traced)")
ROOFLINE_HEADER = (f"## Roofline (one H100 SXM, per chip; datasheet values: "
                   f"{R.PEAK_FLOPS_BF16 / 1e12:.0f} TF/s bf16, "
                   f"{R.PEAK_FLOPS_F32 / 1e12:.0f} TF/s f32, "
                   f"{R.HBM_BW / 1e9:.0f} GB/s HBM3, "
                   f"{R.LINK_BW / 1e9:.0f} GB/s/link NVLink)")
# what would move a cell's dominant term, by shape and term
NOTES = {
    "train_4k": {
        "collective": "fewer FSDP re-gathers: larger microbatches or "
                      "2-pass remat (memory-bound tradeoff)",
        "memory": "fuse elementwise chains / bf16 intermediates to cut HBM "
                  "passes",
        "compute": "near roofline for this mesh; more chips",
    },
    "prefill_32k": {
        "collective": "ring-attention style KV pass instead of SP "
                      "all-gathers",
        "memory": "larger attention chunks (more shared-memory reuse per "
                  "HBM read)",
        "compute": "causal-block skipping to halve masked-out FLOPs",
    },
    "decode_32k": {
        "memory": "weight streaming floor: batch more tokens per weight "
                  "read (speculative/multi-token)",
        "collective": "head-local decode layout",
        "compute": "-",
    },
    "long_500k": {
        "memory": "state-streaming floor (recurrent archs)",
        "collective": "-", "compute": "-",
    },
}


def load(results: str, pattern: str) -> List[Cell]:
    """The cells of the files under ``results`` matching ``pattern``."""
    out = []
    for f in sorted(glob.glob(os.path.join(results, pattern))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def load_grid(path: str) -> List[Cell]:
    """The cells of a ``dryrun --grid`` JSON-lines file."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _by_cell(cells: Iterable[Cell]) -> List[Tuple[Tuple[str, str], Cell]]:
    """One cell per (arch, shape), the last given winning, sorted."""
    return sorted({(d["arch"], d["shape"]): d for d in cells}.items())


def fmt_bytes(b: Optional[float]) -> str:
    if b is None:
        return "-"
    return f"{b / 2**30:.1f}"


def _num(v: Optional[float], spec: str) -> str:
    return "-" if v is None else format(v, spec)


def _fits(d: Cell) -> str:
    return {True: "yes", False: "no"}.get(d.get("fits"), "-")


def _source(d: Cell) -> str:
    """``model``: one representative chip of a mesh traced; ``traced``:
    the whole step on one device."""
    return d.get("source", "traced")


def dryrun_table(cells: Iterable[Cell]) -> str:
    """The dry-run table of ``dryrun`` results or ``--grid`` lines."""
    lines = ["| arch | shape | status | source | trace_s | fits | "
             "peak GB/chip | state GB/chip | temp GB/chip | GFLOP/chip | "
             "coll GB/chip |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), d in _by_cell(cells):
        if d["status"] != "ok":
            lines.append(f"| {arch} | {shape} | {d['status']}: "
                         f"{d.get('reason', '-')} | | | | | | | | |")
            continue
        m, c = d["memory"], d["cost"]
        coll = d.get("collectives", {}).get("total_bytes")
        lines.append(
            f"| {arch} | {shape} | {d['status']} | {_source(d)} | "
            f"{d['trace_s']} | {_fits(d)} | {fmt_bytes(m['peak_bytes'])} | "
            f"{fmt_bytes(m['argument_bytes'])} | "
            f"{fmt_bytes(m['temp_bytes'])} | "
            f"{(c['flops'] or 0) / 1e9:.0f} | "
            f"{_num(None if coll is None else coll / 2**30, '.2f')} |")
    return "\n".join(lines)


def roofline_table(cells: Iterable[Cell]) -> str:
    """The roofline table of ``roofline`` results."""
    lines = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
             "| model/traced flops | roofline frac | fits | peak GB/chip "
             "| what would move the dominant term |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), d in _by_cell(cells):
        if d["status"] != "ok":
            lines.append(f"| {arch} | {shape} | — | — | — | {d['status']} "
                         f"| — | — | — | — | {d.get('reason', '-')} |")
            continue
        t = d["terms_s"]
        note = NOTES.get(shape, {}).get(d["dominant"], "-")
        peak = d.get("memory", {}).get("peak_bytes")
        lines.append(
            f"| {arch} | {shape} | {max(t['compute'], 0):.4g} | "
            f"{max(t['memory'], 0):.4g} | {max(t['collective'], 0):.4g} | "
            f"{d['dominant']} | {_num(d['useful_ratio'], '.2f')} | "
            f"{_num(d['roofline_fraction'], '.3f')} | {_fits(d)} | "
            f"{fmt_bytes(peak)} | {note} |")
    return "\n".join(lines)


def render(single: Iterable[Cell], multi_pod: Iterable[Cell],
           rooflines: Iterable[Cell]) -> str:
    """The three tables under their headers, as one markdown document; a
    table with no cells is left out, header and all, so no header names
    cells that were not traced."""
    sections = [(SINGLE_HEADER, dryrun_table, list(single)),
                (MULTI_POD_HEADER, dryrun_table, list(multi_pod)),
                (ROOFLINE_HEADER, roofline_table, list(rooflines))]
    return "\n\n".join(f"{header}\n\n{table(cells)}"
                        for header, table, cells in sections if cells)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.make_experiments",
        description=__doc__.splitlines()[0])
    ap.add_argument("--results", default="results",
                    help="directory of dryrun_*_{sp,mp}.json and "
                         "roofline_*.json")
    ap.add_argument("--grid", default=None,
                    help="dryrun --grid JSON lines: the single-device table")
    args = ap.parse_args(argv)
    single = (load_grid(args.grid) if args.grid
              else load(args.results, "dryrun_*_sp.json"))
    print(render(single, load(args.results, "dryrun_*_mp.json"),
                 load(args.results, "roofline_*.json")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
