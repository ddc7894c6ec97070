"""The f32 flash backward's three-term TF32 arithmetic and its split walk on
the CPU.

On the card the f32 backward kernels (``flash_bwd_dq_kernel``,
``flash_bwd_dkdv_kernel`` and the second pass ``flash_bwd_dkdv_sum_kernel``)
run every product on the tensor cores in three TF32 terms, and cut the
dK/dV kernel's walk into segments whose f32 sums the second pass adds in
order.  ``flash_attention_bwd_3xtf32_plain`` spells out the arithmetic; here
it is held to ``jax.vjp`` of the reference's chunked attention at the
reference's f32 tolerance (1e-4, tests/test_kernels.py:41) and to
``flash_attention_bwd_plain`` within 1e-5 of max |g|, and one TF32 term is
shown to miss the f32 tolerance of 2e-4.  ``dkdv_split`` (the rule the
kernel and the wrapper's workspace share) must read no batch and cover each
key block's walk once, and the source must run the arithmetic it claims.
The kernels themselves run only on the card, where ``chip_smoke.py`` holds
them to both plain versions.
"""
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

import repro_torch.kernels.flash_attention as FA
from repro_torch.kernels import meta
from repro_torch.kernels.flash_attention import (
    BWD_F32_BLOCK, BWD_F32_BQ, DKDV_SEG_MIN, DKDV_SEG_TARGET,
    SUPPORTED_HEAD_DIMS, dkdv_partials, dkdv_split, flash_attention_bwd,
    flash_attention_bwd_3xtf32_plain, flash_attention_bwd_plain,
    flash_attention_plain)

TOL = 1e-4
SRC = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
       / "csrc" / "flash_attention.cu").read_text()
GROUPS = (1, 2, 8)
# (B, S, T, Hq, Hkv, D): chip_smoke.FLASH_BWD_SHAPES (D = 112 with a ragged
# S, a group of 8, D = 16, D = 128 with T != S), then train_lm's at S = 64
SHAPES = [(2, 255, 255, 8, 4, 112), (1, 128, 128, 8, 1, 64),
          (2, 96, 96, 2, 2, 16), (1, 200, 130, 4, 2, 128),
          (2, 64, 64, 4, 2, 64)]
# (BH, BHkv, S, D), causal: where one TF32 term shows its error
ONE_TERM_SHAPES = [(4, 2, 128, 64), (8, 4, 255, 112), (4, 1, 256, 128)]


def _operands(b, s, hq, hkv, d, seed, t=None):
    """q, k, v, dout in the model's (B, S, H, D) layout, f32, from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d),
                          (b, s, hq, d))]


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B*H, S, D)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _model_layout(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B*H, S, D) -> (B, S, H, D)."""
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


def _kernel_args(q, k, v, dout, causal):
    """The kernel-layout operands with the forward's output and
    log-sum-exp (``flash_attention_plain``)."""
    qf, kf, vf, df = (_kernel_layout(torch.from_numpy(x))
                      for x in (q, k, v, dout))
    out, lse = flash_attention_plain(qf, kf, vf, causal=causal,
                                     return_lse=True)
    return qf, kf, vf, out, lse, df


def _rel(got, want) -> float:
    """The largest error of max |g| over (dq, dk, dv)."""
    return max(((g.double() - w.double()).abs().max()
                / w.double().abs().max()).item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
def test_3xtf32_backward_matches_the_reference_vjp(d, g, causal):
    """Against ``jax.vjp`` of the reference's chunked attention, chunked (q
    16, kv 16) and unchunked."""
    hkv = 1 if g == 8 else 2
    b, s = 2, 32
    q, k, v, dout = _operands(b, s, g * hkv, hkv, d,
                              1000 + 100 * d + 10 * g + causal)
    grads = flash_attention_bwd_3xtf32_plain(*_kernel_args(q, k, v, dout,
                                                           causal),
                                             causal=causal)
    got = [_model_layout(x, b) for x in grads]
    for qc, kc in ((16, 16), (0, 0)):
        def ref_vjp(a, b_, c, ct):
            return jax.vjp(lambda a, b_, c: JL.flash_attention(
                a, b_, c, causal=causal, q_chunk=qc, kv_chunk=kc),
                a, b_, c)[1](ct)

        want = jax.jit(ref_vjp)(q, k, v, jnp.asarray(dout))
        for name, gt, j in zip("qkv", got, want):
            np.testing.assert_allclose(gt.numpy(), np.asarray(j), rtol=TOL,
                                       atol=TOL, err_msg=f"d{name} q_chunk "
                                       f"{qc} kv_chunk {kc}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_backward_within_1e_5_of_the_plain_backward(shape, causal):
    b, s, t, hq, hkv, d = shape
    args = _kernel_args(*_operands(b, s, hq, hkv, d, sum(shape) + causal,
                                   t=t), causal)
    got = flash_attention_bwd_3xtf32_plain(*args, causal=causal)
    want = flash_attention_bwd_plain(*args, causal=causal)
    assert [x.dtype for x in got] == [torch.float32] * 3
    assert [x.shape for x in got] == [x.shape for x in want]
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape", ONE_TERM_SHAPES)
def test_one_tf32_term_misses_the_f32_tolerance(shape):
    """Of max |g| from ``flash_attention_bwd_plain``: one TF32 term misses
    2e-4, three terms stay within 1e-5."""
    bh, bhkv, s, d = shape
    rng = np.random.default_rng(bh + s + d)
    q, dout = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((bhkv, s, d)).astype(
        np.float32)) for _ in range(2))
    out, lse = flash_attention_plain(q, k, v, causal=True, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=True)
    one = _rel(flash_attention_bwd_3xtf32_plain(q, k, v, out, lse, dout,
                                                causal=True, terms=1), want)
    three = _rel(flash_attention_bwd_3xtf32_plain(q, k, v, out, lse, dout,
                                                  causal=True), want)
    assert one > 2e-4, one
    assert three <= 1e-5, three


def test_bad_term_count_raises():
    q = torch.zeros(2, 8, 16)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="terms"):
        flash_attention_bwd_3xtf32_plain(q, q, q, q, lse, q, terms=2)


# (S, T, D, group, causal): the check shapes, train_lm's and the training
# path's, and ragged or short ones
SPLITS = [(255, 255, 112, 2, True), (128, 128, 64, 8, False),
          (96, 96, 16, 1, True), (200, 130, 128, 2, True),
          (130, 200, 128, 2, True), (256, 256, 64, 2, True),
          (4096, 4096, 128, 8, True), (4096, 4096, 128, 8, False),
          (4096, 4096, 112, 1, True), (33, 7, 32, 4, False)]


def _walk(s, t, d, group, causal):
    """Each key block's walk as the kernel steps it: [(q head, first query
    of the stage)] in step order."""
    keys = BWD_F32_BLOCK[d]
    walks = []
    for j in range(-(-t // keys)):
        q_begin = j * keys if causal else 0
        stages = list(range(q_begin, s, BWD_F32_BQ))
        walks.append([(h, q0) for h in range(group) for q0 in stages])
    return walks


@pytest.mark.parametrize("split", SPLITS)
def test_dkdv_split_covers_every_query_stage_once(split):
    """Segment i of key block j walks steps [i L, (i + 1) L): together the
    segments take every (q head, query stage) that the key block sees,
    each once; under ``causal`` no stage ends before the key block starts;
    and no segment is longer than L or empty unless its walk is."""
    s, t, d, group, causal = split
    stages, counts = dkdv_split(s, t, d, group, causal)
    keys = BWD_F32_BLOCK[d]
    assert stages >= DKDV_SEG_MIN
    walks = _walk(s, t, d, group, causal)
    assert len(counts) == len(walks)
    for j, (walk, n) in enumerate(zip(walks, counts)):
        segs = [walk[i * stages:(i + 1) * stages] for i in range(n)]
        taken = [step for seg in segs for step in seg]
        assert taken == walk
        assert len(set(taken)) == len(taken)
        assert all(0 < len(seg) <= stages for seg in segs) or not walk
        want = {(h, q0) for h in range(group)
                for q0 in range(0, s, BWD_F32_BQ)
                if not causal or q0 + BWD_F32_BQ > j * keys}
        assert set(taken) == want
    # the heaviest key block's walk lands in about DKDV_SEG_TARGET segments
    if stages > DKDV_SEG_MIN:
        assert max(counts) <= DKDV_SEG_TARGET


@pytest.mark.parametrize("split", SPLITS)
def test_dkdv_split_reads_no_batch(split):
    """The rule takes the shapes of one sequence alone, and the wrapper's
    workspace and the traced partials grow with the kv heads, one equal
    share each, whatever the batch."""
    assert list(inspect.signature(dkdv_split).parameters) == \
        ["s", "t", "d", "group", "causal"]
    s, t, d, group, causal = split
    per_head = dkdv_partials(s, t, d, group, causal)
    _, counts = dkdv_split(s, t, d, group, causal)
    assert per_head == (0 if max(counts) == 1 else
                        sum(counts) * 2 * BWD_F32_BLOCK[d] * d)
    one = FA._partial_slots(torch.empty(group, s, d, device="meta"),
                            torch.empty(1, t, d, device="meta"), causal)
    for bhkv in (2, 3, 16):
        q = torch.empty(bhkv * group, s, d, device="meta")
        k = torch.empty(bhkv, t, d, device="meta")
        assert dkdv_split(s, t, d, group, causal)[1] == counts
        slots = FA._partial_slots(q, k, causal)
        assert slots == (bhkv * one[0], bhkv * one[1], one[2])


@pytest.mark.parametrize("split", [(255, 255, 112, 2, True),
                                   (200, 130, 128, 2, True),
                                   (96, 96, 16, 1, False)])
def test_segments_summed_in_order_give_the_gradients(split):
    """dK and dV summed segment by segment over the walk's (q head, query
    stage) pieces, the segments then added in order as the second pass
    does, agree with ``flash_attention_bwd_plain`` within 1e-5 of max
    |g|: the walk's indexing takes every query once."""
    s, t, d, group, causal = split
    bhkv = 2
    rng = np.random.default_rng(s + t + d)
    q, dout = (torch.from_numpy(rng.standard_normal(
        (bhkv * group, s, d)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((bhkv, t, d)).astype(
        np.float32)) for _ in range(2))
    out, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    _, want_k, want_v = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                  causal=causal)
    stages, counts = dkdv_split(s, t, d, group, causal)
    keys = BWD_F32_BLOCK[d]
    scale = d ** -0.5
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    walks = _walk(s, t, d, group, causal)
    for hk in range(bhkv):
        for j, (walk, n) in enumerate(zip(walks, counts)):
            rows = slice(j * keys, min(t, (j + 1) * keys))
            kp = torch.arange(j * keys, min(t, (j + 1) * keys))
            sk, sv = [], []
            for i in range(n):
                pk = torch.zeros(kp.numel(), d)
                pv = torch.zeros(kp.numel(), d)
                for h, q0 in walk[i * stages:(i + 1) * stages]:
                    bh = hk * group + h
                    qs = slice(q0, min(s, q0 + BWD_F32_BQ))
                    qp = torch.arange(qs.start, qs.stop)
                    x = k[hk, rows] @ q[bh, qs].T * scale
                    if causal:
                        x = torch.where(kp[:, None] <= qp[None, :], x,
                                        FA.NEG_INF)
                    p = torch.exp(x - lse[bh, qs][None, :])
                    delta = (dout[bh, qs] * out[bh, qs]).sum(-1)
                    ds = p * (v[hk, rows] @ dout[bh, qs].T - delta[None, :])
                    pv += p @ dout[bh, qs]
                    pk += ds @ q[bh, qs]
                sk.append(pk)
                sv.append(pv)
            acc_k, acc_v = sk[0], sv[0]
            for a, b in zip(sk[1:], sv[1:]):
                acc_k, acc_v = acc_k + a, acc_v + b
            dk[hk, rows] = acc_k * scale
            dv[hk, rows] = acc_v
    assert _rel((dk, dv), (want_k, want_v)) <= 1e-5


def test_cpu_backward_is_the_plain_version():
    """On a CPU tensor ``flash_attention_bwd`` is the plain version, f32
    included, and counts no launch."""
    args = _kernel_args(*_operands(1, 48, 4, 2, 32, 9), True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(*args, causal=True)
    want = flash_attention_bwd_plain(*args, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_attention_bwd.launches == before


class _Recorder:
    def __init__(self):
        self.calls = []

    def kernel(self, name, flops, dtype, nbytes):
        self.calls.append((name, flops, dtype, nbytes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_lists_the_partials_apart(dtype):
    """On ``meta`` the backward reports its split's partials as
    ``flash_attention_bwd_partials``: the slots of the key blocks walked
    by more than one segment, written and read once, and their adds; f32
    by ``dkdv_split``, bf16 by ``dkdv_split_bf16``."""
    bh, bhkv, s, d = 16, 2, 4096, 128
    q, out, dout = (torch.empty(bh, s, d, dtype=dtype, device="meta")
                    for _ in range(3))
    k, v = (torch.empty(bhkv, s, d, dtype=dtype, device="meta")
            for _ in range(2))
    lse = torch.empty(bh, s, device="meta")
    rec = _Recorder()
    with meta.recording(rec):
        flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    names = [c[0] for c in rec.calls]
    assert names == ["flash_attention_bwd", "flash_attention_bwd_partials"]
    rule, block = ((dkdv_split, BWD_F32_BLOCK) if dtype == torch.float32
                   else (FA.dkdv_split_bf16, FA.BWD_BF16_BLOCK))
    _, counts = rule(s, s, d, bh // bhkv, True)
    split = [c for c in counts if c > 1]
    n = 2 * block[d] * d
    assert rec.calls[1] == ("flash_attention_bwd_partials",
                            bhkv * (sum(split) - len(split)) * n,
                            torch.float32, 2 * 4 * bhkv * sum(split) * n)


def _bwd_source() -> str:
    start = SRC.index("namespace bwd {")
    return SRC[start:SRC.index("}  // namespace bwd", start)]


def _body(src: str, name: str) -> str:
    """A kernel's or function's text from its name to the next one."""
    start = src.index(name + "(")
    nxt = re.search(r"\ntemplate <|\ncudaError_t ", src[start:])
    return src[start:start + nxt.start()] if nxt else src[start:]


def test_f32_backward_kernels_run_three_tf32_terms():
    """Both f32 backward kernels take every product through ``abt`` (S,
    dP, by ``abt_step``) and ``xb`` (dQ, dV, dK), which issue mma.sync tf32
    in three terms on operands split by the forward's ``split``; the
    split, the mma and the cp.async stage are the forward's, not copies;
    no atomics."""
    body = _bwd_source()
    for helper in ("abt_step", "xb"):
        fn = _body(body, f"__device__ __forceinline__ void {helper}")
        assert len(re.findall(r"mma1688\(", fn)) == 3, helper
        assert "split(" in fn
    assert len(re.findall(r"abt_step<", _body(
        body, "__device__ __forceinline__ void abt"))) == 2
    dq = _body(body, "flash_bwd_dq_kernel")
    dkdv = _body(body, "flash_bwd_dkdv_kernel")
    assert len(re.findall(r"\babt<", dq)) == 2 and \
        len(re.findall(r"\bxb<", dq)) == 1
    assert len(re.findall(r"\babt<", dkdv)) == 2 and \
        len(re.findall(r"\bxb<", dkdv)) == 2
    for kernel in (dq, dkdv):
        assert "stage<D" in kernel and "cp_async_wait()" in kernel
    assert "using f32::mma1688;" in body and "using f32::split;" in body
    assert SRC.count("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32") \
        == 1
    assert SRC.count('asm("cvt.rna.tf32.f32') == 1
    assert not re.search(r"atomicAdd|\bred\.|\batom\.", SRC)


def test_the_split_constants_match_the_source():
    """The Python rule repeats the kernel's: its stage, segment constants
    and per-D blocks (``launch<D, W>``, 16 rows for each pair of warps)."""
    body = _bwd_source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             body).group(1))

    assert const("BQ") == BWD_F32_BQ
    assert const("SEG_TARGET") == DKDV_SEG_TARGET
    assert const("SEG_MIN") == DKDV_SEG_MIN
    cases = re.findall(r"case (\d+): return launch<(\d+), (\d+)>", body)
    assert tuple(int(c[0]) for c in cases) == SUPPORTED_HEAD_DIMS
    for d, d_again, w in cases:
        assert d == d_again
        assert BWD_F32_BLOCK[int(d)] == 16 * int(w)
