"""The port's ServeEngine on rwkv6 (reduced rwkv6-3b, f32, CPU) against
the JAX reference.

The reference's weights are carried into the port with
``convert.lm_params_from_numpy``.  The oracle for greedy serving is the
reference's own (tests/test_serve.py:177): the argmax chain of
``transformer.forward`` over the growing sequence, run at one padded
length of 128 (forward is causal, so padding at the end changes no
earlier position; 128 runs the chunked time-mix).

rwkv6's state is per slot, as the hybrid's Mamba state is, so the port's
engine fills a slot the same way: zero its rows, prefill the longest
multiple of 64 of ``prompt[:-1]`` through the chunked form at batch 1,
decode the rest over that slot's rows.  The reference's engine fills
through full-batch decode steps, which advance every slot's state; it is
compared here only where that is right: one request in a fresh one-slot
engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_config as jget, reduced as jreduced
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine

PAD_LEN = 128


@pytest.fixture(scope="module")
def served():
    jcfg = jreduced(jget("rwkv6-3b"))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("rwkv6-3b"))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    fwd = jax.jit(lambda p, t: JT.forward(p, jcfg, tokens=t)[0])

    def chain(prompt, n):
        toks = list(prompt)
        for _ in range(n):
            padded = np.zeros((1, PAD_LEN), np.int32)
            padded[0, :len(toks)] = toks
            logits = fwd(params, jnp.asarray(padded))
            toks.append(int(jnp.argmax(logits[0, len(toks) - 1])))
        return toks[len(prompt):]

    return jcfg, params, cfg, model, chain


def _engine(served, slots, max_len=PAD_LEN, seed=0):
    _, _, cfg, model, _ = served
    return ServeEngine(cfg, model, slots=slots, max_len=max_len, seed=seed,
                       device="cpu")


def _prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


@pytest.mark.parametrize("lens", [[(5, 6), (70, 4), (1, 5), (66, 3)],
                                  [(65, 3), (2, 4), (127, 1), (9, 3)]])
def test_engine_matches_forward_chain_with_joins_and_slot_reuse(served,
                                                                lens):
    """Two slots, four requests of (prompt, new) ``lens``: one joins
    mid-stream, two reuse a freed slot.  Of ``prompt[:-1]`` the longest
    multiple of 64 is prefilled and the rest decoded: 70 tokens prefill 64
    and decode 5, 65 prefill 64 and decode none, 127 prefill 64 and decode
    62, the short ones decode all."""
    chain = served[4]
    eng = _engine(served, slots=2)
    reqs = [Request(rid=i, prompt=_prompt(i, n), max_new=m)
            for i, (n, m) in enumerate(lens)]
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
    (the reference's contract, tests/test_serve.py:192)."""
    p1 = [5, 6, 7, 8]
    solo = _engine(served, slots=2)
    r_solo = Request(rid=0, prompt=p1, max_new=6)
    solo.submit(r_solo)
    solo.run()

    mixed = _engine(served, slots=2)
    r_a = Request(rid=0, prompt=p1, max_new=6)
    mixed.submit(r_a)
    mixed.step()                                 # a starts decoding
    r_b = Request(rid=1, prompt=[9, 10, 11] * 22, max_new=4)
    mixed.submit(r_b)                            # b joins: 65 prefilled
    mixed.run()
    assert r_a.out == r_solo.out
    assert r_b.done and len(r_b.out) == 4


def test_reused_slot_starts_from_a_zero_state(served):
    """A slot freed by one request serves the next as a fresh engine
    would."""
    first = Request(rid=0, prompt=_prompt(3, 9), max_new=3)
    second = Request(rid=1, prompt=_prompt(4, 7), max_new=4)
    eng = _engine(served, slots=1)
    eng.submit(first)
    eng.submit(second)
    eng.run()
    fresh = _engine(served, slots=1)
    again = Request(rid=1, prompt=second.prompt, max_new=4)
    fresh.submit(again)
    fresh.run()
    assert second.out == again.out
