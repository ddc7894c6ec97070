"""The port's dry run and roofline (``repro_torch.launch.{dryrun,roofline}``,
``train.step.trace_*``, ``configs.base.input_specs``) on the CPU, on the
``meta`` device: inputs and closed forms held to the reference's, the
counter's byte and memory rules, counted FLOPs against a closed form,
cost affine in depth, argument bytes against a real state, the
reference's skips, and one full-width cell per family.

The reference's launch modules set ``XLA_FLAGS`` at import, so its
``model_flops`` and constants are read from its source with ``ast`` here,
never imported."""
import ast
import dataclasses
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry

from repro_torch.configs.base import SHAPES, input_specs
from repro_torch.configs.registry import ALIASES, get_config, reduced
from repro_torch.kernels import meta
from repro_torch.kernels.causal_conv1d import causal_conv1d
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_host_mesh, make_mesh_for, \
    make_production_mesh
from repro_torch.models.transformer import init_params, layer_counts
from repro_torch.train import step as S

ROOT = Path(__file__).resolve().parent.parent
ARCHS = sorted(ALIASES)
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
MESH = make_host_mesh("meta")


def _reference_roofline():
    """The reference's ``model_flops`` and module constants, from its
    source (importing it would set ``XLA_FLAGS`` in this process)."""
    tree = ast.parse((ROOT / "src/repro/launch/roofline.py").read_text())
    ns = {"SHAPES": ref_base.SHAPES, "ArchConfig": ref_base.ArchConfig}
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "model_flops":
            exec(compile(ast.Module([node], []), "roofline.py", "exec"), ns)
        elif isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Constant):
            consts[node.targets[0].id] = node.value.value
    return ns["model_flops"], consts


REF_MODEL_FLOPS, REF_CONSTS = _reference_roofline()


# --------------------------------------------------------------------------
# inputs and closed forms: the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    ref = ref_base.input_specs(ref_registry.get_config(arch), shape)
    got = input_specs(get_config(arch), shape)
    assert sorted(got) == sorted(ref)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[k].shape)
        assert str(t.dtype).split(".")[-1] == jnp.dtype(ref[k].dtype).name


def test_input_specs_overrides():
    cfg = get_config("qwen2.5-3b")
    got = input_specs(cfg, "train_4k", 2, seq_override=128)
    assert got["tokens"].shape == (2, 128) == got["labels"].shape
    assert input_specs(cfg, "decode_32k", 3)["position"].shape == (3,)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_is_the_reference(arch, shape):
    assert roofline.model_flops(get_config(arch), shape) == \
        REF_MODEL_FLOPS(ref_registry.get_config(arch), shape)


def test_optimizer_constants_are_the_reference():
    assert roofline.OPT_FLOPS_PER_PARAM == REF_CONSTS["OPT_FLOPS_PER_PARAM"]
    assert roofline.OPT_BYTES_PER_PARAM == REF_CONSTS["OPT_BYTES_PER_PARAM"]


def test_h100_constants():
    assert roofline.PEAK_FLOPS_BF16 == 989e12
    assert roofline.PEAK_FLOPS_F32 == 67e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    # the f32 products are priced at the CUDA cores' rate
    assert roofline.compute_seconds({"f32": 67e12, "bf16": 989e12}) == 2.0


@pytest.mark.parametrize("shape,batch,seq", [("train_4k", 2, 4096),
                                             ("prefill_32k", 2, 2048),
                                             ("decode_32k", 2, 640)])
def test_model_terms_are_the_configs_own_work(shape, batch, seq):
    """The model's bound comes from its config alone: its FLOPs with the
    f32 head at the f32 peak, and the bytes it cannot avoid."""
    cfg = get_config("qwen2.5-3b")
    kind = SHAPES[shape]["kind"]
    tokens = batch * (1 if kind == "decode" else seq)
    head = (6 if kind == "train" else 2) * cfg.d_model * cfg.vocab * tokens
    mf = roofline.model_flops(cfg, shape, batch_override=batch,
                              seq_override=seq)
    kv = 2 * cfg.n_layers * batch * seq * cfg.n_kv_heads * cfg.d_head * 2
    nbytes = 20 * cfg.param_count() if kind == "train" else \
        2 * cfg.active_param_count() + kv
    t = roofline.model_terms(cfg, shape, batch_override=batch,
                             seq_override=seq)
    assert t["compute"] == pytest.approx(head / 67e12 + (mf - head) / 989e12,
                                         rel=1e-12)
    assert t["memory"] == pytest.approx(nbytes / 3.35e12, rel=1e-12)


# --------------------------------------------------------------------------
# the counter's rules, op by op
# --------------------------------------------------------------------------
def _count(fn, *args):
    counter = dryrun.CostCounter()
    counter.add_arguments(args)
    with meta.recording(counter), counter:
        out = fn(*args)
    return counter, out


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_views_move_nothing():
    c, _ = _count(lambda x: x.reshape(-1).view(8, 8)[:4].t()[None]
                  .expand(2, 8, 4), _m(8, 8))
    assert c.bytes_accessed == 0 and c.peak_bytes == 256
    # a reshape that must copy (a transposed input) is traffic
    c, _ = _count(lambda x: x.t().reshape(-1), _m(8, 8))
    assert c.bytes_accessed == 2 * 256


def test_matmul_reads_its_inputs_and_writes_its_output():
    c, _ = _count(lambda a, b: a @ b, _m(4, 8), _m(8, 16, dtype=torch.float32))
    assert c.flops == {"f32": 2 * 4 * 8 * 16}
    assert c.bytes_accessed == 4 * (4 * 8 + 8 * 16 + 4 * 16)
    c, _ = _count(lambda a, b: a @ b, _m(4, 8, dtype=torch.bfloat16),
                  _m(8, 16, dtype=torch.bfloat16))
    assert c.flops == {"bf16": 2 * 4 * 8 * 16}


def test_gather_reads_only_what_it_gathers():
    table, idx = _m(1000, 64), torch.empty(2, 3, dtype=torch.long,
                                           device="meta")
    c, out = _count(lambda t, i: torch.nn.functional.embedding(i, t),
                    table, idx)
    assert c.bytes_accessed == 2 * out.numel() * 4 + idx.numel() * 8


def test_copy_does_not_read_its_destination():
    c, _ = _count(lambda d, s: d.copy_(s), _m(16), _m(16))
    assert c.bytes_accessed == 2 * 64


def test_live_bytes_and_peak():
    def fn(x):
        y = x * 2          # +64
        z = y + 1          # +64
        del y              # -64
        return z * 3       # +64
    c, out = _count(fn, _m(16))
    assert c.argument_bytes == 64
    assert c.peak_bytes == 64 * 3
    assert c.output_bytes(out) == 64


def test_meta_kernels_report_their_closed_forms():
    q, k = _m(8, 128, 64, dtype=torch.bfloat16), _m(2, 128, 64,
                                                     dtype=torch.bfloat16)
    c, out = _count(lambda q, k, v: flash_attention_fwd(q, k, v), q, k, k)
    assert out.shape == q.shape and out.device.type == "meta"
    assert c.flops["bf16"] == meta.flash_flops(8, 128, 128, 64, True) == \
        4 * 8 * 128 * 128 * 64 // 2
    assert c.by_op["kernel:flash_attention_fwd"][2] == \
        2 * (2 * q.numel() + 2 * k.numel())
    x, w = _m(2, 32, 16), _m(4, 16)
    c, y = _count(causal_conv1d, x, w)
    assert y.shape == x.shape
    assert c.flops["f32"] == 2 * 4 * 2 * 32 * 16
    assert c.bytes_accessed == 4 * (2 * x.numel() + w.numel())


# --------------------------------------------------------------------------
# whole steps
# --------------------------------------------------------------------------
def _dense(layers=2):
    return dataclasses.replace(reduced(get_config("qwen3-14b")),
                               n_layers=layers)


def test_prefill_flops_equal_the_closed_form():
    cfg = _dense()
    b, s = 2, 64
    tr = S.trace_serve_step(cfg, "prefill_32k", MESH, batch_override=b,
                            seq_override=s)
    t, d, dh = b * s, cfg.d_model, cfg.d_head
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    layer = (2 * t * d * dh * (2 * h + 2 * hkv)       # q, k, v, o
             + 3 * 2 * t * d * cfg.d_ff                # swiglu
             + 4 * b * h * s * s * dh // 2)           # causal flash
    assert tr.flops_by_dtype == {"f32": cfg.n_layers * layer
                                 + 2 * t * d * cfg.vocab}


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-3b"])
def test_cost_is_affine_in_depth(arch):
    base = reduced(get_config(arch))

    def cost(layers):
        tr = S.trace_train_step(dataclasses.replace(base, n_layers=layers),
                                "train_4k", MESH, S.StepPlan(),
                                batch_override=2, seq_override=64)
        return np.array([tr.flops, tr.bytes_accessed], dtype=np.int64)

    c1, c2, c4 = cost(1), cost(2), cost(4)
    np.testing.assert_array_equal(c4, c1 + (c2 - c1) * 3)


# (arch, seq, q_chunk, kv_chunk): at 512 the dense step's peak fell inside
# the recomputing backward's chunks before the backward kernels
@pytest.mark.parametrize("arch,seq,q_chunk,kv_chunk",
                         [("qwen2.5-3b", 512, 256, 512),
                          ("zamba2-7b", 64, 16, 32)])
def test_train_trace_records_the_backward_kernels(arch, seq, q_chunk,
                                                  kv_chunk):
    """``FlashAttention``'s backward is ``flash_attention_bwd`` on meta: a
    train step's trace records it once per attention block and microbatch
    at ``meta.flash_bwd_flops`` and its closed-form bytes, and neither the
    counts nor the predicted peak depend on the reference's chunks any more
    (only the recomputed chunked attention read them)."""
    n_mb = 2
    cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=3,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)

    def trace(c):
        return S.trace_train_step(c, "train_4k", MESH,
                                  S.StepPlan(n_microbatches=n_mb),
                                  batch_override=2, seq_override=seq)

    tr = trace(cfg)
    blocks = cfg.n_layers if cfg.family != "hybrid" else \
        layer_counts(cfg)[0]
    calls = blocks * n_mb
    bh, bhkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head  # a batch of 1
    elt = 4                                                 # f32
    nbytes = elt * (4 * bh * seq * d + 4 * bhkv * seq * d) + 4 * bh * seq
    assert tr.by_op["kernel:flash_attention_bwd"] == [
        calls, calls * meta.flash_bwd_flops(bh, seq, seq, d, True),
        calls * nbytes]
    assert tr.by_op["kernel:flash_attention_fwd"][0] == calls
    assert tr.peak_bytes > tr.argument_bytes
    assert trace(dataclasses.replace(cfg, q_chunk=0, kv_chunk=0)) == tr


def test_argument_bytes_are_the_real_state():
    cfg = _dense()
    tr = S.trace_train_step(cfg, "train_4k", MESH, S.StepPlan(),
                            batch_override=2, seq_override=32)
    model = init_params(cfg, device="cpu", trainable=True)
    state = S.init_train_state(model)
    real = sum(t.numel() * t.element_size() for t in
               [*state.params.values(), *state.opt.m.values(),
                *state.opt.v.values(), state.opt.step])
    batch = input_specs(cfg, "train_4k", 2, seq_override=32, device="cpu")
    real += sum(t.numel() * t.element_size() for t in batch.values())
    assert tr.argument_bytes == real
    assert tr.params_counted == sum(p.numel() for p in model.parameters())
    assert tr.peak_bytes > tr.argument_bytes


def test_train_cell_is_the_probe_times_microbatches_plus_adamw():
    cfg = _dense()
    cell = dryrun.run_config(cfg, "train_4k", batch_override=4,
                             seq_override=32, n_microbatches=2)
    probe = S.trace_train_step(cfg, "train_4k", MESH,
                               S.StepPlan(n_microbatches=1, tp=False,
                                          skip_update=True),
                               batch_override=2, seq_override=32)
    p = cfg.param_count()
    assert cell["cost"]["flops"] == \
        2 * probe.flops + roofline.OPT_FLOPS_PER_PARAM * p
    assert cell["cost"]["bytes_accessed"] == \
        2 * probe.bytes_accessed + roofline.OPT_BYTES_PER_PARAM * p
    assert cell["memory"]["peak_bytes"] > probe.peak_bytes
    r = roofline.run_config(cfg, "train_4k", batch_override=4,
                            seq_override=32, n_microbatches=2)
    assert 0 < r["roofline_fraction"] <= 1.05
    assert r["bound_s"] == max(r["terms_s"].values())
    assert roofline.measured_fraction(r, 2 * r["bound_s"]) == 0.5
    assert r["model_bound_s"] == max(r["model_terms_s"].values())
    assert roofline.model_fraction(r, 2 * r["model_bound_s"]) == 0.5


def test_roofline_on_a_mesh_is_per_chip():
    """``roofline.run_config(mesh=)`` passes the mesh to the dry run: the
    terms are one chip's, the model's own terms the config's over the
    chips."""
    cfg = _dense()
    mesh = make_mesh_for(2, 2, devices=("meta",) * 4)
    kw = dict(batch_override=4, seq_override=32, n_microbatches=1)
    cell = dryrun.run_config(cfg, "train_4k", mesh=mesh, **kw)
    r = roofline.run_config(cfg, "train_4k", mesh=mesh, **kw)
    assert (r["status"], r["n_chips"]) == ("ok", 4)
    assert r["per_chip"]["flops"] == cell["cost"]["flops"]
    assert r["terms_s"] == roofline.terms(cell)
    assert r["terms_s"]["collective"] > 0
    whole = roofline.model_terms(cfg, "train_4k", batch_override=4,
                                 seq_override=32)
    assert r["model_terms_s"] == {k: v / 4 for k, v in whole.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_long_500k_skipped_as_the_reference(arch):
    cfg = get_config(arch)
    want = not ref_registry.get_config(arch).sub_quadratic
    assert (dryrun.skip_reason(cfg, "long_500k") is not None) == want
    if want:
        assert dryrun.run_cell(arch, "long_500k")["status"] == "skipped"
        assert roofline.run_cell(arch, "long_500k")["status"] == "skipped"


def test_multi_pod_raises(tmp_path):
    """--multi-pod traces one chip of the (2, 16, 16) mesh on meta; what
    still raises is a production mesh over a pool too small for it."""
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                        "--multi-pod", "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    assert (r["status"], r["source"], r["n_chips"], r["multi_pod"]) == \
        ("ok", "model", 512, True)
    ring = r["collectives"]["ring_bytes"]
    # the chip's counts times the chips, less the f32 logits (128 x V)
    # that only position 0 receives
    logits = 128 * get_config("qwen2.5-3b").vocab * 4
    assert ring["all-gather"] == \
        512 * r["collectives"]["bytes"]["all-gather"] - 511 * logits
    with pytest.raises(ValueError, match="512 devices"):
        make_production_mesh(multi_pod=True, device="cpu")


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_multi_pod_recurrent_serving_cells(arch, shape):
    """zamba2-7b's and rwkv6-3b's serving cells on the (2, 16, 16) mesh:
    one chip traced in the TP grain.  ``long_500k`` replicates its batch
    of 1 and splits zamba2's k/v sequence over "data" (32 k/v heads over
    "model"); rwkv6-3b's 40 heads go 3, 3, ..., 2 over 16 shards, their
    projections gathered whole."""
    r = dryrun.run_cell(arch, shape, True)
    assert (r["status"], r["source"], r["n_chips"]) == ("ok", "model", 512)
    assert r["fits"] and r["collectives"]["ring_bytes"]["all-gather"] > 0
    assert r["collectives"]["ring_bytes"]["all-reduce"] > 0


def test_multi_pod_train_cell_is_modelled():
    """llama3-405b train_4k on the (2, 16, 16) mesh: one chip traced (the
    TP + SP grain, 8 q heads per shard reading one gathered k/v head)."""
    r = dryrun.run_cell("llama3-405b", "train_4k", True)
    assert (r["status"], r["source"], r["n_chips"], r["tp"]) == \
        ("ok", "model", 512, True)
    assert r["cost"]["flops"] > 0 and r["memory"]["peak_bytes"] > 0
    coll = r["collectives"]
    assert coll["bytes"]["reduce-scatter"] > 0
    assert coll["ring_bytes"]["reduce-scatter"] == \
        512 * coll["bytes"]["reduce-scatter"]


# one arch per family, at full width
FAMILY_ARCHS = {"dense": "qwen2.5-3b", "moe": "grok-1-314b",
                "vlm": "llava-next-mistral-7b", "audio": "musicgen-large",
                "hybrid": "zamba2-7b", "ssm": "rwkv6-3b"}


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_full_width_cell_per_family(family):
    arch = FAMILY_ARCHS[family]
    cfg = get_config(arch)
    assert cfg.family == family
    r = roofline.run_cell(arch, "decode_32k")
    assert r["status"] == "ok" and r["probe_s"] < 30
    mem = r["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    # decode reads every weight: the memory term at least the weights'
    assert r["per_chip"]["bytes"] >= r["params_counted"] * 2
    assert 0 < r["roofline_fraction"] <= 1.05
    # the model's own work is a part of what the port's step does
    assert 0 < r["model_bound_s"] <= r["bound_s"]
    if family in ("dense", "moe"):
        # elsewhere param_count() is the reference's approximation: no
        # token table for vlm/audio inputs is counted, rwkv6's and the
        # hybrid's formulas leave parts out (the shared block)
        assert math.isclose(r["params_counted"], cfg.param_count(),
                            rel_tol=0.01)


@pytest.mark.parametrize("arch", ["grok-1-314b", "llava-next-mistral-7b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_reduced_moe_and_vlm_cells_on_a_meta_mesh(arch, shape):
    """A reduced moe and vlm cell on a (2, 2) ring of ``meta`` devices:
    one representative position traced (the DP grain's routing set for
    the moe train cell, the TP grain's serving for the others)."""
    cfg = reduced(get_config(arch))
    mesh = make_mesh_for(2, 2, devices=("meta",) * 4)
    r = dryrun.run_config(cfg, shape, mesh=mesh, batch_override=4,
                          seq_override=64, n_microbatches=1)
    assert (r["status"], r["source"], r["n_chips"]) == ("ok", "model", 4)
    assert r["fits"] and r["cost"]["flops"] > 0
    assert 0 < r["memory"]["argument_bytes"] <= r["memory"]["peak_bytes"]
    assert sum(r["collectives"]["ring_bytes"].values()) > 0


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_hybrid_and_ssm_serving_on_a_mesh_is_unsupported(arch):
    """Once refused, now served: reduced zamba2-7b's and rwkv6-3b's
    ``decode_32k`` and ``long_500k`` cells return "ok" on a (2, 2) ring
    of ``meta`` devices, and the model of each (one representative
    position) equals the ``repro.mesh.*`` bytes of a decode step on a
    CPU ring (``long_500k``'s batch of 1 replicated on both data rows,
    the k/v's sequence over "data")."""
    from repro_torch.parallel import ring
    from repro_torch.parallel import sharding as SH
    cfg = reduced(get_config(arch))
    meta_mesh = make_mesh_for(2, 2, devices=("meta",) * 4)
    cpu = make_mesh_for(2, 2, devices=("cpu",) * 4)
    mp = ring.shard_params(init_params(cfg, device="cpu"), cpu, tp=True)
    for cell, b in (("decode_32k", 2), ("long_500k", 1)):
        r = dryrun.run_config(cfg, cell, mesh=meta_mesh, batch_override=b,
                              seq_override=64)
        assert (r["status"], r["source"]) == ("ok", "model"), r
        cache = ring.init_cache(mp, b, 64)
        assert cache.split == (b == 2)
        before = SH.collective_bytes()
        S.build_decode_step(cpu)(mp, cache, {
            "tokens": torch.zeros((b, 1), dtype=torch.long),
            "position": torch.full((b,), 3)})
        got = {k: v - before[k] for k, v in SH.collective_bytes().items()}
        want = {k.replace("-", "_"): v
                for k, v in r["collectives"]["ring_bytes"].items()}
        assert want == got, cell
