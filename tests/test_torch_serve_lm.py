"""The port's LM ServeEngine on the hybrid model (reduced zamba2-7b, f32,
CPU) against the JAX reference.

The reference's weights are carried into the port with
``convert.lm_params_from_numpy``.  The oracle for greedy serving is the
reference's own (tests/test_serve.py:177): the argmax chain of
``transformer.forward`` over the growing sequence.  Forward is causal, so
the chain runs at one padded length (one compile) and reads the logits at
the last real position; its config raises the SSD chunk to 64 so that
every length is one chunk — the same function, which otherwise accepts
lengths over 16 only in multiples of 16.

The reference's engine advances every slot's Mamba state while it
prefills a new request, so on the hybrid model a request joining
mid-stream changes its neighbour's tokens; the port prefills at batch 1
into the slot alone.  Here the port is held to the contract the
reference states (tests/test_serve.py:192) and compared with the
reference's engine only where that one is right: one request in a fresh
one-slot engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, reduced as jreduced
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine

PAD_LEN = 48


@pytest.fixture(scope="module")
def served():
    jcfg = jreduced(jget("zamba2-7b"))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("zamba2-7b"))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    ocfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm,
                                                             chunk=64))
    fwd = jax.jit(lambda p, t: JT.forward(p, ocfg, tokens=t)[0])

    def chain(prompt, n):
        toks = list(prompt)
        for _ in range(n):
            padded = np.zeros((1, PAD_LEN), np.int32)
            padded[0, :len(toks)] = toks
            logits = fwd(params, jnp.asarray(padded))
            toks.append(int(jnp.argmax(logits[0, len(toks) - 1])))
        return toks[len(prompt):]

    return jcfg, params, cfg, model, chain


def _engine(served, slots, max_len=64, seed=0):
    _, _, cfg, model, _ = served
    return ServeEngine(cfg, model, slots=slots, max_len=max_len, seed=seed,
                       device="cpu")


def _prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


def test_engine_matches_forward_chain_with_joins_and_reuse(served):
    """Two slots, four requests: one joins mid-stream, two reuse a freed
    slot; prompts of 1, 5, 17 (> chunk 16, not a multiple: prefill 16 then
    decode) and 33 tokens."""
    chain = served[4]
    eng = _engine(served, slots=2)
    reqs = [Request(rid=i, prompt=_prompt(i, n), max_new=m)
            for i, (n, m) in enumerate([(5, 6), (17, 4), (1, 5), (33, 3)])]
    eng.submit(reqs[0])
    eng.step()                                  # r0 decoding alone
    eng.step()
    for r in reqs[1:]:
        eng.submit(r)                           # r1 joins mid-stream
    eng.run()
    for r in reqs:
        assert r.done and len(r.out) == r.max_new
        assert r.out == chain(r.prompt, r.max_new), r.rid


def test_engine_matches_reference_engine_one_slot(served):
    """One request in a fresh one-slot engine, where the reference's
    decode-step prefill is right."""
    jcfg, params, _, _, _ = served
    prompt = [3, 14, 15, 9, 2, 6]
    jeng = JServeEngine(jcfg, params, slots=1, max_len=32)
    jreq = JRequest(rid=0, prompt=prompt, max_new=5)
    jeng.submit(jreq)
    jeng.run()
    eng = _engine(served, slots=1, max_len=32)
    req = Request(rid=0, prompt=prompt, max_new=5)
    eng.submit(req)
    eng.run()
    assert req.out == jreq.out


def test_solo_and_mixed_outputs_are_equal(served):
    """A request joining mid-stream must not change another's output
    (the reference's contract, tests/test_serve.py:192, on the hybrid
    model)."""
    p1 = [5, 6, 7, 8]
    solo = _engine(served, slots=2)
    r_solo = Request(rid=0, prompt=p1, max_new=6)
    solo.submit(r_solo)
    solo.run()

    mixed = _engine(served, slots=2)
    r_a = Request(rid=0, prompt=p1, max_new=6)
    mixed.submit(r_a)
    mixed.step()                                 # a starts decoding
    r_b = Request(rid=1, prompt=[9, 10, 11] * 7, max_new=4)
    mixed.submit(r_b)                            # b joins mid-stream
    mixed.run()
    assert r_a.out == r_solo.out
    assert r_b.done and len(r_b.out) == 4


def test_long_prompt_not_a_chunk_multiple_is_served(served):
    """40 tokens with chunk 16: prefill 32 tokens, decode 7, then serve."""
    chain = served[4]
    eng = _engine(served, slots=1)
    prompt = _prompt(40, 40)
    req = Request(rid=0, prompt=prompt, max_new=3)
    eng.submit(req)
    eng.run()
    assert req.out == chain(prompt, 3)


def test_max_len_stops_a_request(served):
    eng = _engine(served, slots=2, max_len=12)
    req = Request(rid=0, prompt=_prompt(1, 10), max_new=8)
    other = Request(rid=1, prompt=_prompt(2, 3), max_new=6)
    eng.submit(req)
    eng.submit(other)
    eng.run()
    assert req.done and len(req.out) == 3       # positions 9, 10, 11
    assert other.done and len(other.out) == 6


def test_sampling_is_seeded(served):
    outs = []
    for _ in range(2):
        eng = _engine(served, slots=2, seed=7)
        reqs = [Request(rid=i, prompt=_prompt(i, 4), max_new=5,
                        temperature=0.8) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < 512 for out in outs[0] for t in out)


def test_engine_rejects_bad_requests_and_devices(served):
    _, _, cfg, model, _ = served
    eng = _engine(served, slots=1, max_len=8)
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=[], max_new=1))
    with pytest.raises(ValueError):
        eng.submit(Request(rid=1, prompt=list(range(9)), max_new=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(cfg, model, slots=1, max_len=8)   # device=None: card
    with pytest.raises(ValueError, match="token models"):
        ServeEngine(reduced(get_config("musicgen-large")), model, slots=1,
                    max_len=8, device="cpu")
