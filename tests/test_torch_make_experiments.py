"""``repro_torch.launch.make_experiments`` (port of
``scripts/make_experiments.py``) over the port's dry-run and roofline
results, written under the reference's file names: a cut cell
(qwen2.5-3b ``decode_32k`` at batch 2, seq 640), a ``long_500k`` skip and
one chip of the (2, 16, 16) mesh.  Every cell has one row, a skip's row
carries its reason, the headers name the H100 constants of
``launch/roofline.py`` and no TPU figure, and ``--grid`` renders
``dryrun --grid``'s JSON lines."""
import json

import pytest

from repro_torch.launch import dryrun
from repro_torch.launch import make_experiments as E
from repro_torch.launch import roofline as R

ARCH = "qwen2.5-3b"
CUT = {"batch_override": 2, "seq_override": 640}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The three cells' results as ``--out`` files in one directory."""
    out = tmp_path_factory.mktemp("results")
    cells = {
        f"dryrun_{ARCH}_decode_32k_sp.json": dryrun.run_cell(
            ARCH, "decode_32k", **CUT),
        f"dryrun_{ARCH}_long_500k_sp.json": dryrun.run_cell(
            ARCH, "long_500k"),
        f"dryrun_{ARCH}_decode_32k_mp.json": dryrun.run_cell(
            ARCH, "decode_32k", True),
        f"roofline_{ARCH}_decode_32k.json": R.run_cell(
            ARCH, "decode_32k", **CUT),
        f"roofline_{ARCH}_long_500k.json": R.run_cell(ARCH, "long_500k"),
    }
    for name, cell in cells.items():
        (out / name).write_text(json.dumps(cell, indent=2))
    return out, cells


def _rows(table: str):
    return [line for line in table.splitlines()
            if line.startswith(f"| {ARCH} |")]


def test_every_cell_has_one_row(results, capsys):
    out, cells = results
    assert E.main(["--results", str(out)]) == 0
    text = capsys.readouterr().out
    sections = text.split("## ")[1:]
    assert [s.splitlines()[0] for s in sections] == [
        E.SINGLE_HEADER[3:], E.MULTI_POD_HEADER[3:], E.ROOFLINE_HEADER[3:]]
    single, multi, roof = (_rows(s) for s in sections)
    assert [r.split(" | ")[1] for r in single] == ["decode_32k",
                                                  "long_500k"]
    assert len(multi) == 1 and " | model | " in multi[0]
    assert " | traced | " in single[0] and " | yes | " in single[0]
    assert [r.split(" | ")[1] for r in roof] == ["decode_32k", "long_500k"]
    reason = cells[f"dryrun_{ARCH}_long_500k_sp.json"]["reason"]
    assert reason in single[1] and reason in roof[1]
    trace_s = cells[f"dryrun_{ARCH}_decode_32k_sp.json"]["trace_s"]
    assert f" | {trace_s} | " in single[0]


def test_headers_name_the_h100_and_no_tpu(results, capsys):
    out, _ = results
    E.main(["--results", str(out)])
    text = capsys.readouterr().out
    for figure in ("989 TF/s bf16", "67 TF/s f32", "3350 GB/s HBM3",
                   "450 GB/s/link"):
        assert figure in E.ROOFLINE_HEADER and figure in text
    assert f"{R.HBM_BW / 1e9:.0f} GB/s" in text
    for tpu in ("v5e", "VMEM", "256 chips", "DESIGN.md", "197 TF/s",
                "819 GB/s"):
        assert tpu not in text


def test_grid_lines_render(results, tmp_path, monkeypatch, capsys):
    """``dryrun --grid``'s summary lines (``run_grid`` over the cells
    traced above) as the single-device table."""
    _, cells = results
    traced = {(ARCH, "decode_32k"): cells[f"dryrun_{ARCH}_decode_32k_sp.json"],
              (ARCH, "long_500k"): cells[f"dryrun_{ARCH}_long_500k_sp.json"]}
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda arch, shape: traced[(arch, shape)])
    lines = list(dryrun.run_grid(cells=sorted(traced)))
    grid = tmp_path / "grid.jsonl"
    grid.write_text("".join(json.dumps(x) + "\n" for x in lines))
    assert E.main(["--grid", str(grid), "--results",
                   str(tmp_path / "none")]) == 0
    single = _rows(capsys.readouterr().out.split("## ")[1])
    assert [r.split(" | ")[1] for r in single] == ["decode_32k",
                                                  "long_500k"]
    assert " | - |" in single[0], "a grid line has no collectives"
    assert traced[(ARCH, "long_500k")]["reason"] in single[1]


def test_render_leaves_out_a_table_with_no_cells(results):
    """No header stands over an empty table: a run with no multi-pod cells
    prints no multi-pod header."""
    _, cells = results
    single = [c for n, c in cells.items() if n.endswith("_sp.json")]
    roof = [c for n, c in cells.items() if n.startswith("roofline_")]
    text = E.render(single, [], roof)
    assert E.MULTI_POD_HEADER not in text and "512 chips" not in text
    assert [s.splitlines()[0] for s in text.split("## ")[1:]] == [
        E.SINGLE_HEADER[3:], E.ROOFLINE_HEADER[3:]]
    assert E.render([], [], []) == ""


def test_tables_take_the_cells_themselves(results):
    _, cells = results
    roof = [c for n, c in cells.items() if n.startswith("roofline_")]
    table = E.roofline_table(roof)
    ok = cells[f"roofline_{ARCH}_decode_32k.json"]
    row = _rows(table)[0]
    assert f" | {ok['dominant']} | " in row
    assert E.NOTES["decode_32k"][ok["dominant"]] in row
    assert len(table.splitlines()) == 2 + len(roof)
