"""The port's examples (``repro_torch.examples.*``, each a port of the
file of the same name under ``examples/``) on the CPU at a tiny size: the
engine answers every request, greedy ones the same on a second run;
training checkpoints, and a run resumed from a checkpoint gives the
uninterrupted run's losses bit for bit; the sharded conv demo holds every
partition to the one-device plan on a ring of CPU devices.  The conv
examples: quickstart's plan against the reference's oracle, serve_conv's
reload with no miss, mg3m_cnn's training loop against the same loop over
the reference's model and optimizer, serve_cnn's three phases; without a
card each example raises unless given ``--device cpu``."""
import math
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scene import ConvScene as JConvScene
from repro.kernels import ref as jref
from repro.models import cnn as JM
from repro.train import optimizer as jopt
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.examples import (mg3m_cnn, quickstart, serve_cnn,
                                  serve_conv, serve_lm, shard_conv, train_lm)
from repro_torch.models.cnn import small_cnn_plans
from repro_torch.plan import make_plan
from repro_torch.train import optimizer as O

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


def test_shard_conv_on_a_cpu_ring():
    got = shard_conv.main(["--device", "cpu"])
    assert got["parity"] == {"batch:8": "bitwise", "oc:8": "bitwise",
                             "h:4": "bitwise", "ic:4": "tolerance"}
    assert len(got["training_tags"]) == 3
    assert [tuple(o.shape) for o in got["outs"]] == [
        (14, 14, 32, b) for b in (3, 5, 8)]
    assert all(torch.isfinite(o).all() for o in got["outs"])
    assert got["stats"]["plan_misses"] == 0


CONV_EXAMPLES = {"quickstart": quickstart, "serve_conv": serve_conv,
                 "mg3m_cnn": mg3m_cnn, "serve_cnn": serve_cnn}


@pytest.mark.parametrize("name", sorted(CONV_EXAMPLES))
def test_conv_example_needs_a_card_or_the_cpu(name, monkeypatch):
    """Without a card an example raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CONV_EXAMPLES[name].main([])


def test_quickstart_runs_on_the_cpu():
    got = quickstart.main(["--device", "cpu"])
    assert got["err"] < 1e-3 and got["one_shot_err"] == 0.0
    assert tuple(got["out"].shape) == quickstart.SCENE.out_shape()


def test_quickstart_plan_matches_the_reference_oracle():
    """The quickstart scene's plan, on numpy operands, against
    ``repro.kernels.ref.conv_ref`` (tests/test_kernels.py's tolerance)."""
    sc = quickstart.SCENE
    rng = np.random.default_rng(0)
    inp = rng.standard_normal(sc.in_shape()).astype(np.float32)
    flt = rng.standard_normal(sc.flt_shape()).astype(np.float32)
    got = make_plan(sc, device="cpu").execute(torch.from_numpy(inp),
                                              torch.from_numpy(flt))
    jsc = JConvScene(B=sc.B, IC=sc.IC, OC=sc.OC, inH=sc.inH, inW=sc.inW,
                     fltH=sc.fltH, fltW=sc.fltW, padH=sc.padH, padW=sc.padW)
    want = np.asarray(jref.conv_ref(jnp.asarray(inp), jnp.asarray(flt), jsc))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_serve_conv_reloads_with_no_miss(tmp_path):
    path = tmp_path / "plans" / "mg3m_plans.json"
    got = serve_conv.main(["--device", "cpu", "--plans", str(path),
                           "--requests", "3"])
    assert got["path"] == str(path) and path.is_file()
    assert got["loaded"] == len(serve_conv.LAYERS)
    assert got["second"]["stats"]["misses"] == 0
    assert got["second"]["stats"]["builds"] == 0
    assert got["first"]["stats"]["misses"] == len(serve_conv.LAYERS)
    first, second = got["first"]["outs"], got["second"]["outs"]
    assert len(first) == len(second) == 4
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_serve_conv_default_artifact_follows_tmpdir(tmp_path, monkeypatch):
    """Without ``--plans`` the artifact lies in the temporary directory
    (``$TMPDIR``), not at a fixed path two checkouts would share."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert serve_conv.parse_args([]).plans == str(tmp_path /
                                                  "mg3m_plans.json")


def _reference_loop(np_params, xs, ys, cfg, steps, batch):
    """mg3m_cnn's loop over the reference's model and optimizer: the
    losses and the final parameters (numpy)."""
    def loss_fn(p, x, y):
        lp = jax.nn.log_softmax(JM.small_cnn_forward(p, x))
        return -jnp.take_along_axis(lp, y[:, None], 1).mean()

    params = jax.tree.map(jnp.asarray, np_params)
    state = jopt.init_opt_state(params)
    n, losses = xs.shape[0], []
    for i in range(steps):
        lo = (i * batch) % (n - batch)
        loss, g = jax.value_and_grad(loss_fn)(
            params, jnp.asarray(xs[lo:lo + batch]),
            jnp.asarray(ys[lo:lo + batch]))
        params, state, _ = jopt.adamw_update(cfg, params, g, state)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def test_mg3m_cnn_loop_matches_the_reference_loop():
    """Three steps from the reference's parameters on the same numpy
    batches (res 8, batch 8): the port's planned loop against the
    reference's ``small_cnn_forward`` + ``adamw_update``, losses within
    1e-4 relative, and the parameters after the three steps within 1e-4
    relative of their largest entry (Adam's first steps move by about
    lr * sign(g), so the losses alone would pass a gradient of the wrong
    magnitude)."""
    steps, batch, res = 3, 8, 8
    np_params = jax.tree.map(np.asarray,
                             JM.init_small_cnn(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((32, res, res, 3)).astype(np.float32)
    ys = rng.integers(0, 10, 32).astype(np.int32)
    jcfg = jopt.AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=2,
                            total_steps=steps)
    want, want_params = _reference_loop(np_params, xs, ys, jcfg, steps,
                                        batch)

    params = cnn_params_from_numpy(np_params, device="cpu")
    plans = small_cnn_plans(params, batch, res, device="cpu")
    assert not plans.reference_ops
    cfg = O.AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=2,
                        total_steps=steps)
    got_params, _, got = mg3m_cnn.train_steps(
        params, O.init_opt_state(params), torch.from_numpy(xs),
        torch.from_numpy(ys).long(), plans, cfg, steps=steps, batch=batch)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert set(got_params) == set(want_params)
    for k, w in want_params.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got_params[k].numpy(), w, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_mg3m_cnn_reaches_its_accuracy_on_the_cpu():
    got = mg3m_cnn.main(["--device", "cpu", "--steps", "30", "--batch",
                         "16", "--res", "8"])
    assert got["acc"] > 0.2 and len(got["losses"]) == 30
    assert got["losses"][-1] < got["losses"][0]
    assert {n for n, _ in got["plans"].items()} == {"c1", "c2", "c3"}


SERVE_CNN_CPU = ["--device", "cpu", "--max-hw", "8", "--max-ch", "8",
                 "--bursts", "2"]


def test_serve_cnn_sheds_only_under_overload_and_keeps_parity(tmp_path):
    artifact = str(tmp_path / "serve_plans.json")
    got = serve_cnn.main(SERVE_CNN_CPU + ["--artifact", artifact])
    bursts, over, recovered = got["stats"]
    assert bursts["shed"] == 0 and got["shed"] > 0
    assert over["shed"] == got["shed"] == recovered["shed"]
    assert got["accepted"] > 0
    assert recovered["plan_builds"] == recovered["plan_misses"] == 0
    assert bursts["deadline_requests"] > 0 and got["built"] > 0
    # a restarted server prewarms from the artifact: nothing to build
    again = serve_cnn.main(SERVE_CNN_CPU + ["--artifact", artifact])
    assert again["built"] == 0
    assert again["stats"][2]["plan_builds"] == 0
