"""The port's LM examples (``repro_torch.examples.{serve_lm,train_lm}``,
ports of ``examples/serve_lm.py`` and ``examples/train_lm.py``) on the
CPU at a tiny size: the engine answers every request, greedy ones the
same on a second run; training checkpoints, and a run resumed from a
checkpoint gives the uninterrupted run's losses bit for bit."""
import math
import os
import shutil

from repro_torch.examples import serve_lm, train_lm

TINY = ["--device", "cpu", "--d-model", "64", "--layers", "2", "--batch",
        "2", "--seq", "32", "--steps", "6", "--ckpt-every", "3"]


def test_serve_lm_answers_every_request():
    argv = ["--device", "cpu", "--requests", "4", "--slots", "2",
            "--max-new", "5"]
    reqs = serve_lm.main(argv)
    assert [r.rid for r in reqs] == [0, 1, 2, 3]
    assert all(r.done and len(r.out) == 5 for r in reqs)
    assert all(0 <= t < 512 for r in reqs for t in r.out)
    again = serve_lm.main(argv)
    # greedy requests (even rids) repeat exactly
    assert [r.out for r in again[::2]] == [r.out for r in reqs[::2]]


def test_train_lm_resume_is_bitwise(tmp_path):
    full_dir, cut_dir = tmp_path / "full", tmp_path / "cut"
    full = train_lm.main(TINY + ["--ckpt-dir", str(full_dir)])
    assert len(full) == 6 and all(math.isfinite(x) for x in full)
    assert sorted(os.listdir(full_dir)) == ["step_00000003", "step_00000006"]
    # an interruption after step 3: only its checkpoint survives
    shutil.copytree(full_dir / "step_00000003", cut_dir / "step_00000003")
    resumed = train_lm.main(TINY + ["--ckpt-dir", str(cut_dir), "--resume"])
    assert resumed == full[3:]


def test_train_lm_fresh_run_ignores_old_checkpoints(tmp_path):
    a = train_lm.main(TINY + ["--ckpt-dir", str(tmp_path), "--steps", "2"])
    b = train_lm.main(TINY + ["--ckpt-dir", str(tmp_path), "--steps", "2"])
    assert a == b
