"""Serving on a ring of CPU devices (``parallel/ring.py``, the dense
family's TP grain) against the one-device port and the JAX reference.

``build_prefill_step``/``build_decode_step`` on a (1, 2) ring (reduced
qwen2.5-3b's 2 k/v heads divide: the head-sharded cache) and a (1, 4) ring
(they do not: the sequence-sharded cache), f32, the reference's weights
carried across with ``convert.lm_params_from_numpy``: a prefill and four
greedy decode steps, each step's logits within 1e-4 of max |logit| of the
one-device port's and of the reference's forward over the same tokens
(its greedy forward chain), the gathered cache equal to the one-device
cache within the same bound.  One case decodes from a cache whose
positions are shorter than one shard's share, so three of the four
sequence shards hold no valid position (their softmax weight must be 0,
not nan).  reduced qwen3-14b runs on a (2, 2) ring, its batch split over
the data rows.

The moe, vlm and audio families serve the same way (reduced grok-1-314b,
arctic-480b, llava-next-mistral-7b and musicgen-large; grok also with
``n_experts`` replaced by 2, which puts TP inside the experts on the
(1, 4) ring): a prefill and four decode steps in both cache grains, the
embeds families fed seeded embeddings, each step's logits within 1e-4 of
max |logit| of the one-device port's; MoE layers run drop-free on both.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as JT

from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.mesh import make_host_mesh, make_mesh_for
from repro_torch.models import transformer as T
from repro_torch.parallel import ring
from repro_torch.parallel import sharding as SH
from repro_torch.train import step as S

TOL = 1e-4
STEPS = 4


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = jreg.reduced(jreg.get_config(arch))
    cfg = treg.reduced(treg.get_config(arch))
    params = JT.init_params(jcfg, jax.random.PRNGKey(1))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    fwd = jax.jit(lambda t: JT.forward(params, jcfg, tokens=t)[0][:, -1])
    return cfg, model, fwd


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("arch,shape,prompt,max_len", [
    ("qwen2.5-3b", (1, 2), 16, 32), ("qwen2.5-3b", (1, 4), 16, 32),
    ("qwen2.5-3b", (1, 4), 5, 64), ("qwen3-14b", (2, 2), 16, 32)])
def test_ring_serving_matches_one_device_and_reference(arch, shape, prompt,
                                                       max_len):
    cfg, model, fwd = _pair(arch)
    mesh = make_mesh_for(*shape, devices=("cpu",) * (shape[0] * shape[1]))
    mp = ring.shard_params(model, mesh, tp=True)
    grain = ring.cache_grain(cfg, mesh)
    assert grain == ("sequence" if shape == (1, 4) else "heads")
    tokens = np.random.default_rng(prompt).integers(0, cfg.vocab,
                                                   (2, prompt))
    host = make_host_mesh("cpu")
    pf1, dc1 = S.build_prefill_step(host), S.build_decode_step(host)
    pfr, dcr = S.build_prefill_step(mesh), S.build_decode_step(mesh)
    l1, c1 = pf1(model, {"tokens": torch.as_tensor(tokens)}, max_len=max_len)
    lr, cr = pfr(mp, {"tokens": tokens}, max_len=max_len)
    assert cr.grain == grain and lr.shape == (2, cfg.vocab)
    if grain == "sequence":
        t_local = cr.shards[0]["k"].shape[2]
        assert t_local == max_len // 4
        assert (prompt < t_local) == (max_len == 64)
    seq = tokens
    for t in range(STEPS + 1):
        _close(lr, l1, f"step {t} vs one device")
        _close(lr, fwd(seq), f"step {t} vs the reference")
        assert torch.isfinite(lr).all()
        if t == STEPS:
            break
        nxt = l1.argmax(-1)[:, None]
        pos = torch.full((2,), prompt + t)
        l1, c1 = dc1(model, c1, {"tokens": nxt, "position": pos})
        lr, cr = dcr(mp, cr, {"tokens": nxt.numpy(), "position": pos})
        seq = np.concatenate([seq, nxt.numpy()], 1)
    kv = ring.gather_cache(cr, mesh, "cpu")["kv"]
    for k in ("k", "v"):
        _close(kv[k], c1["kv"][k], f"cache {k}")


def test_cache_layout_follows_cache_pspecs():
    cfg = treg.reduced(treg.get_config("qwen2.5-3b"))
    for shape, want in (((1, 2), (None, "data", None, "model", None)),
                        ((1, 4), (None, "data", "model", None, None))):
        mesh = make_mesh_for(*shape, devices=("cpu",) * shape[1])
        spec = SH.cache_pspecs_for_batch(cfg, 2, mesh)["kv"]["k"]
        assert spec == want
        mp = ring.shard_params(T.init_params(cfg, device="cpu"), mesh, True)
        cache = ring.init_cache(mp, 2, 32)
        local = cache.shards[0]["k"].shape
        assert local == SH.local_shape(spec, cache.shape, mesh)


@pytest.mark.parametrize("arch,moe_over", [
    ("grok-1-314b", None), ("grok-1-314b", {"n_experts": 2}),
    ("arctic-480b", None), ("llava-next-mistral-7b", None),
    ("musicgen-large", None)])
@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_attention_families_serve_in_both_cache_grains(arch, moe_over,
                                                       shape):
    jcfg = jreg.reduced(jreg.get_config(arch))
    cfg = treg.reduced(treg.get_config(arch))
    if moe_over:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_over))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    params = JT.init_params(jcfg, jax.random.PRNGKey(2))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    mesh = make_mesh_for(*shape, devices=("cpu",) * (shape[0] * shape[1]))
    mp = ring.shard_params(model, mesh, tp=True)
    grain = ring.cache_grain(cfg, mesh)
    assert grain == ("sequence" if shape == (1, 4) else "heads")
    rng = np.random.default_rng(7)
    prompt, bsz = 16, 2

    def inputs(n):
        if cfg.embed_inputs:
            t = rng.integers(0, cfg.vocab, (bsz, n))
            return {"tokens": torch.as_tensor(t)}
        e = rng.standard_normal((bsz, n, cfg.d_model)).astype(np.float32)
        return {"embeds": torch.as_tensor(e)}

    host = make_host_mesh("cpu")
    pf1, dc1 = S.build_prefill_step(host), S.build_decode_step(host)
    pfr, dcr = S.build_prefill_step(mesh), S.build_decode_step(mesh)
    batch = inputs(prompt)
    l1, c1 = pf1(model, batch, max_len=32)
    lr, cr = pfr(mp, batch, max_len=32)
    assert cr.grain == grain and lr.shape == (bsz, cfg.vocab)
    for t in range(STEPS + 1):
        _close(lr, l1, f"step {t} vs one device")
        if t == STEPS:
            break
        nxt = {"tokens": l1.argmax(-1)[:, None]} if cfg.embed_inputs \
            else inputs(1)
        pos = torch.full((bsz,), prompt + t)
        l1, c1 = dc1(model, c1, dict(nxt, position=pos))
        lr, cr = dcr(mp, cr, dict(nxt, position=pos))
    kv = ring.gather_cache(cr, mesh, "cpu")["kv"]
    for k in ("k", "v"):
        _close(kv[k], c1["kv"][k], f"cache {k}")
