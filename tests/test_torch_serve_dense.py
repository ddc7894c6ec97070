"""The port's ``ServeEngine`` on the attention-block families (reduced
qwen3-14b and grok-1-314b, f32, CPU) against the JAX reference.

The reference's weights are carried into the port with
``convert.lm_params_from_numpy``.  On a dense model the reference's engine
keeps its own isolation contract (its decode-step fill rewrites another
slot's next cache row with the same values the next step writes), so the
port's greedy tokens are held to the reference engine's at 2 slots, with a
request joining mid-stream and a reused slot.  tests/test_serve.py's three
tests are ported onto the port's engine.  On MoE the engine must prefill
drop-free: with the capacity factor set to 1.25, its tokens must still be
``forward``'s drop-free argmax chain.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, reduced as jreduced
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine


def _pair(arch, capacity_factor=None):
    jcfg, cfg = jreduced(jget(arch)), reduced(get_config(arch))
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def dense():
    return _pair("qwen3-14b")


@pytest.fixture(scope="module")
def moe():
    return _pair("grok-1-314b", capacity_factor=1.25)


def _prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


def _schedule(make_engine, make_request, plan):
    """Two slots: r0 decodes two steps alone, then r1..r3 join (r1 beside
    r0, r2 and r3 reusing freed slots).  Returns the requests."""
    eng = make_engine()
    reqs = [make_request(i, _prompt(i, n), m)
            for i, (n, m) in enumerate(plan)]
    eng.submit(reqs[0])
    eng.step()
    eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    eng.run()
    return reqs


def test_engine_matches_reference_engine_with_joins_and_reuse(dense):
    """Prompts of 5, 17, 1 and 33 tokens: the port's tokens equal the
    reference engine's, request by request."""
    jcfg, params, cfg, model = dense
    plan = [(5, 6), (17, 4), (1, 5), (33, 3)]
    jreqs = _schedule(
        lambda: JServeEngine(jcfg, params, slots=2, max_len=64),
        lambda i, p, m: JRequest(rid=i, prompt=p, max_new=m), plan)
    reqs = _schedule(
        lambda: ServeEngine(cfg, model, slots=2, max_len=64, device="cpu"),
        lambda i, p, m: Request(rid=i, prompt=p, max_new=m), plan)
    for r, jr in zip(reqs, jreqs):
        assert r.done and jr.done and len(r.out) == r.max_new
        assert r.out == jr.out, r.rid


# --------------------------------------------------------------------------
# tests/test_serve.py, on the port
# --------------------------------------------------------------------------
def _engine(dense, slots=2, max_len=64):
    _, _, cfg, model = dense
    return ServeEngine(cfg, model, slots=slots, max_len=max_len,
                       device="cpu")


def test_engine_completes_all_requests(dense):
    cfg = dense[2]
    eng = _engine(dense)
    for rid in range(5):
        prompt = list(range(1 + rid, 6 + rid))
        eng.submit(Request(rid=rid, prompt=prompt, max_new=4))
    reqs = list(eng.queue)
    eng.run()
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 4 for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)


def test_greedy_decode_matches_direct_forward(dense):
    """Engine greedy output == argmax over the port's full-forward logits
    chain."""
    model = dense[3]
    eng = _engine(dense, slots=1)
    prompt = [3, 14, 15, 9, 2]
    req = Request(rid=0, prompt=prompt, max_new=3, temperature=0.0)
    eng.submit(req)
    eng.run()
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(3):
            logits, _ = model(tokens=torch.as_tensor([toks]))
            toks.append(int(torch.argmax(logits[0, -1])))
    assert req.out == toks[len(prompt):]


def test_continuous_batching_isolated_slots(dense):
    """A request joining mid-stream must not change another's output."""
    p1 = [5, 6, 7, 8]
    eng_solo = _engine(dense)
    r_solo = Request(rid=0, prompt=p1, max_new=6, temperature=0.0)
    eng_solo.submit(r_solo)
    eng_solo.run()

    eng_mixed = _engine(dense)
    r_a = Request(rid=0, prompt=p1, max_new=6, temperature=0.0)
    eng_mixed.submit(r_a)
    eng_mixed.step()                      # a starts decoding
    r_b = Request(rid=1, prompt=[9, 10, 11], max_new=4, temperature=0.0)
    eng_mixed.submit(r_b)                 # b joins mid-stream
    eng_mixed.run()

    assert r_a.out == r_solo.out
    assert r_b.done and len(r_b.out) == 4


# --------------------------------------------------------------------------
# MoE: drop-free prefill
# --------------------------------------------------------------------------
def _drop_free_chain(model, cfg, prompt, n):
    cf = cfg.moe.n_experts / cfg.moe.top_k
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits, _ = model(tokens=torch.as_tensor([toks]),
                              capacity_factor=cf)
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def test_moe_engine_is_drop_free_at_capacity_1_25(moe):
    """At capacity factor 1.25 the prefill of a 24-token prompt drops
    tokens; the engine's tokens are nonetheless ``forward``'s drop-free
    argmax chain, alone and beside a joining request."""
    _, _, cfg, model = moe
    assert cfg.moe.capacity_factor == 1.25
    p0, p1 = _prompt(20, 25), _prompt(21, 9)
    body = torch.as_tensor([p0[:-1]])
    with torch.no_grad():
        dropped, _ = model.prefill(tokens=body)
        free, _ = model.prefill(tokens=body,
                                capacity_factor=cfg.moe.n_experts
                                / cfg.moe.top_k)
    assert float((dropped - free).abs().max()) > 1e-3

    eng = ServeEngine(cfg, model, slots=2, max_len=48, device="cpu")
    r0 = Request(rid=0, prompt=p0, max_new=5)
    r1 = Request(rid=1, prompt=p1, max_new=4)
    eng.submit(r0)
    eng.step()
    eng.submit(r1)                        # joins mid-stream
    eng.run()
    assert r0.out == _drop_free_chain(model, cfg, p0, 5)
    assert r1.out == _drop_free_chain(model, cfg, p1, 4)


def test_engine_rejects_embedding_models():
    """vlm/audio configs embed no tokens; the engine drives token models,
    as the reference's does."""
    cfg = reduced(get_config("musicgen-large"))
    model = T.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="token models"):
        ServeEngine(cfg, model, slots=1, max_len=8, device="cpu")
