"""The bf16 flash backward's rounding and its split walk on the CPU.

On the card the bf16 backward kernels (``flash_bwd_dq_bf16_kernel``,
``flash_bwd_dkdv_bf16_kernel`` and the second pass
``flash_bwd_dkdv_sum_bf16_kernel``) run every product on wgmma, round P and
dS to bf16 before the products that take them, and cut the dK/dV kernel's
walk into segments whose f32 sums the second pass adds in order and rounds
once.  ``flash_attention_bwd_bf16_plain`` spells out that rounding; here it
is held to ``jax.vjp`` of the reference's chunked attention and to
``flash_attention_bwd_plain`` (f32 throughout).  ``dkdv_split_bf16`` (the
rule the kernel and the wrapper's workspace share) must read no batch,
cover each key block's walk once and size the partials as the C entry
wants, and the source must run the products it claims.  The kernels
themselves run only on the card, where ``chip_smoke.py`` holds them to
both plain versions.
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
from repro_torch.kernels.flash_attention import (
    BWD_BF16_BLOCK, BWD_BF16_BQ, DKDV_BF16_SEG_MIN, DKDV_BF16_SEG_TARGET,
    SUPPORTED_HEAD_DIMS, dkdv_partials_bf16, dkdv_split_bf16,
    flash_attention_bwd, flash_attention_bwd_bf16_plain,
    flash_attention_bwd_plain, flash_attention_plain)

SRC = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
       / "csrc" / "flash_attention.cu").read_text()
GROUPS = (1, 2, 8)
# Of max |g| against f32 gradients.  Rounding P and dS to bf16 perturbs
# each term of a gradient's sum by at most u = 2^-8 and, with independent
# roundings, the sum by about u / sqrt(n) over n terms: at the reference
# vjp's shapes here the emulation sits 1.6e-3 to 3.1e-3 of max |g| from
# flash_attention_bwd_plain; the bf16 tolerance of the port's checks (2e-2)
# holds it, as it holds the kernels (chip_smoke.LM_TOL).  Unrounded
# products read within 1e-4 (tests/test_torch_flash_bwd.py), so the gap is
# the rounding's.
BF16_TOL = 2e-2
# (S, T, D, group, causal): the check shapes, the training path's and
# zamba2-7b's, and ragged or short ones
SPLITS = [(255, 255, 112, 2, True), (128, 128, 64, 8, False),
          (96, 96, 16, 1, True), (200, 130, 128, 2, True),
          (130, 200, 128, 2, True), (1152, 1152, 128, 4, True),
          (4096, 4096, 128, 8, True), (4096, 4096, 128, 8, False),
          (4096, 4096, 112, 1, True), (8192, 8192, 64, 16, True),
          (33, 7, 32, 4, False)]
# split walks small enough for the CPU: a group of 4 at S = 1152 (key block
# 0 in two segments, chip_smoke.flash_bwd_batch_check's), 8 at S = 640, and
# 16 unmasked at S = 300
SPLIT_WALKS = [(1152, 1152, 128, 4, True), (640, 640, 112, 8, True),
               (300, 300, 16, 16, False)]


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


def _kernel_args(q, k, v, dout, causal, dtype=torch.float32):
    """The kernel-layout operands in ``dtype`` with the forward's output
    and log-sum-exp (``flash_attention_plain``)."""
    qf, kf, vf, df = (_kernel_layout(torch.from_numpy(x)).to(dtype)
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
def test_bf16_plain_matches_the_reference_vjp(d, g, causal):
    """Against ``jax.vjp`` of the reference's chunked attention (f32),
    chunked (q 16, kv 16) and unchunked, within ``BF16_TOL`` of max |g|:
    the only gap is P's and dS's rounding."""
    hkv = 1 if g == 8 else 2
    b, s = 2, 32
    q, k, v, dout = _operands(b, s, g * hkv, hkv, d,
                              2000 + 100 * d + 10 * g + causal)
    grads = flash_attention_bwd_bf16_plain(*_kernel_args(q, k, v, dout,
                                                         causal),
                                           causal=causal)
    assert [x.dtype for x in grads] == [torch.float32] * 3
    got = [_model_layout(x, b) for x in grads]
    for qc, kc in ((16, 16), (0, 0)):
        def ref_vjp(a, b_, c, ct):
            return jax.vjp(lambda a, b_, c: JL.flash_attention(
                a, b_, c, causal=causal, q_chunk=qc, kv_chunk=kc),
                a, b_, c)[1](ct)

        want = jax.jit(ref_vjp)(q, k, v, jnp.asarray(dout))
        rel = _rel(got, [torch.from_numpy(np.array(j)) for j in want])
        assert rel <= BF16_TOL, f"q_chunk {qc} kv_chunk {kc}: {rel}"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 255, 255, 8, 4, 112),
                                   (1, 128, 128, 8, 1, 64),
                                   (2, 96, 96, 2, 2, 16),
                                   (1, 200, 130, 4, 2, 128)])
def test_bf16_plain_within_2e_2_of_the_plain_version(shape, causal):
    """On bf16 operands (``chip_smoke.FLASH_BWD_SHAPES``) the emulation's
    bf16 gradients stay within ``BF16_TOL`` of max |g| of
    ``flash_attention_bwd_plain``'s, and its roundings show: it is not
    the plain version."""
    b, s, t, hq, hkv, d = shape
    args = _kernel_args(*_operands(b, s, hq, hkv, d, sum(shape) + causal,
                                   t=t), causal, torch.bfloat16)
    got = flash_attention_bwd_bf16_plain(*args, causal=causal)
    want = flash_attention_bwd_plain(*args, causal=causal)
    assert [x.dtype for x in got] == [torch.bfloat16] * 3
    assert [x.shape for x in got] == [x.shape for x in want]
    assert _rel(got, want) <= BF16_TOL
    assert not all(torch.equal(a, w) for a, w in zip(got, want))


def test_bf16_plain_rounds_p_and_ds_once():
    """Rounding P and dS (and nothing else) before the products: the
    emulation on f32 operands equals the plain version's arithmetic with
    P and dS rounded to bf16 by hand."""
    q, k, v, dout = (torch.from_numpy(x) for x in
                     _operands(1, 40, 4, 2, 32, 77)[:4])
    qf, kf, vf, df = map(_kernel_layout, (q, k, v, dout))
    out, lse = flash_attention_plain(qf, kf, vf, causal=True,
                                     return_lse=True)
    got = flash_attention_bwd_bf16_plain(qf, kf, vf, out, lse, df,
                                         causal=True)
    g, s, d = 2, 40, 32
    scores = FA._scores(qf, kf, True)
    p = torch.exp(scores - lse.reshape(2, g, s, 1))
    do = df.reshape(2, g, s, d)
    delta = (do * out.reshape(2, g, s, d)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("hgsd,htd->hgst", do, vf) - delta)
    pr, dsr = p.bfloat16().float(), ds.bfloat16().float()
    want = (torch.einsum("hgst,htd->hgsd", dsr, kf).reshape(4, s, d)
            * d ** -0.5,
            torch.einsum("hgst,hgsd->htd", dsr, qf.reshape(2, g, s, d))
            * d ** -0.5,
            torch.einsum("hgst,hgsd->htd", pr, do))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)


def _walk(s, t, d, group, causal):
    """Each key block's walk as the bf16 kernel steps it: [(q head, first
    query of the stage)] in step order."""
    keys = BWD_BF16_BLOCK[d]
    walks = []
    for j in range(-(-t // keys)):
        q_begin = j * keys if causal else 0
        stages = list(range(q_begin, s, BWD_BF16_BQ))
        walks.append([(h, q0) for h in range(group) for q0 in stages])
    return walks


@pytest.mark.parametrize("split", SPLITS)
def test_bf16_split_covers_every_query_stage_once(split):
    """Segment i of key block j walks steps [i L, (i + 1) L): together the
    segments take every (q head, query stage) that the key block sees,
    each once; under ``causal`` no stage ends before the key block starts;
    no segment is longer than L or empty unless its walk is."""
    s, t, d, group, causal = split
    stages, counts = dkdv_split_bf16(s, t, d, group, causal)
    keys = BWD_BF16_BLOCK[d]
    assert stages >= DKDV_BF16_SEG_MIN
    walks = _walk(s, t, d, group, causal)
    assert len(counts) == len(walks)
    for j, (walk, n) in enumerate(zip(walks, counts)):
        segs = [walk[i * stages:(i + 1) * stages] for i in range(n)]
        taken = [step for seg in segs for step in seg]
        assert taken == walk
        assert len(set(taken)) == len(taken)
        assert all(0 < len(seg) <= stages for seg in segs) or not walk
        want = {(h, q0) for h in range(group)
                for q0 in range(0, s, BWD_BF16_BQ)
                if not causal or q0 + BWD_BF16_BQ > j * keys}
        assert set(taken) == want
    if stages > DKDV_BF16_SEG_MIN:
        assert max(counts) <= DKDV_BF16_SEG_TARGET


@pytest.mark.parametrize("split", SPLITS)
def test_bf16_split_reads_no_batch(split):
    """The rule takes the shapes of one sequence alone, and the wrapper's
    workspace and the traced partials grow with the kv heads, one equal
    share each, whatever the batch."""
    assert list(inspect.signature(dkdv_split_bf16).parameters) == \
        ["s", "t", "d", "group", "causal"]
    s, t, d, group, causal = split
    _, counts = dkdv_split_bf16(s, t, d, group, causal)
    one = FA._partial_slots(
        torch.empty(group, s, d, dtype=torch.bfloat16, device="meta"),
        torch.empty(1, t, d, dtype=torch.bfloat16, device="meta"), causal)
    for bhkv in (2, 3, 16):
        q = torch.empty(bhkv * group, s, d, dtype=torch.bfloat16,
                        device="meta")
        k = torch.empty(bhkv, t, d, dtype=torch.bfloat16, device="meta")
        assert dkdv_split_bf16(s, t, d, group, causal)[1] == counts
        assert FA._partial_slots(q, k, causal) == \
            (bhkv * one[0], bhkv * one[1], one[2])


def _c_need(s, t, d, group, causal):
    """The C entry's partials size for one kv head, spelled as
    ``tc::bwd_launch`` computes it: ``bwd_seg_stages``' L,
    ``bwd_split_slots``' slots over the ``bwd_segments`` of every key
    block of 64 NK keys (NK from ``bwd_dispatch``), and ``need``."""
    body = _tc_bwd_source()
    const = {n: int(re.search(rf"constexpr int {n} = (\d+);", SRC).group(1))
             for n in ("BQ", "BWD_SEG_TARGET", "BWD_SEG_MIN")}
    nk = int(re.search(rf"case {d}: return bwd_launch<{d}, \d+, (\d+)>",
                       body).group(1))
    assert "const long long need = split ? BHkv * slots * 2 * CK::ROWS * D " \
        ": 0;" in body
    bq, bkv = const["BQ"], 64 * nk
    n_q0 = -(-s // bq)
    L = max(const["BWD_SEG_MIN"], -(-group * n_q0 // const["BWD_SEG_TARGET"]))
    segs = []
    for j in range(-(-t // bkv)):
        q_begin = j * bkv if causal else 0
        walk = group * -(-(s - q_begin) // bq) if q_begin < s else 0
        segs.append(max(1, -(-walk // L)))
    return (sum(segs) * 2 * bkv * d) if max(segs) > 1 else 0


@pytest.mark.parametrize("split", SPLITS)
def test_bf16_partials_are_sized_as_the_c_entry_wants(split):
    """``dkdv_partials_bf16`` (what the wrapper allocates a kv head) equals
    the size ``tc::bwd_launch`` demands, or the launch refuses."""
    assert dkdv_partials_bf16(*split) == _c_need(*split)


@pytest.mark.parametrize("split", SPLIT_WALKS)
def test_bf16_segments_summed_in_order_give_the_gradients(split):
    """dK and dV summed segment by segment over the bf16 walk's (q head,
    query stage) pieces, the segments then added in order as the second
    pass does, agree with ``flash_attention_bwd_plain`` within 1e-5 of max
    |g|: the walk's indexing takes every query once."""
    s, t, d, group, causal = split
    bhkv = 2
    rng = np.random.default_rng(s + t + d + 1)
    q, dout = (torch.from_numpy(rng.standard_normal(
        (bhkv * group, s, d)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((bhkv, t, d)).astype(
        np.float32)) for _ in range(2))
    out, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    _, want_k, want_v = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                  causal=causal)
    stages, counts = dkdv_split_bf16(s, t, d, group, causal)
    assert max(counts) > 1
    keys = BWD_BF16_BLOCK[d]
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
                    qs = slice(q0, min(s, q0 + BWD_BF16_BQ))
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


def test_cpu_bf16_backward_is_the_plain_version():
    """On a CPU tensor ``flash_attention_bwd`` in bf16 is the plain
    version (not the emulation) and counts no launch."""
    args = _kernel_args(*_operands(1, 48, 4, 2, 32, 9), True,
                        torch.bfloat16)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(*args, causal=True)
    want = flash_attention_bwd_plain(*args, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_attention_bwd.launches == before


def _tc_bwd_source() -> str:
    start = SRC.index("// Backward, bf16: tensor cores (wgmma")
    return SRC[start:SRC.index("}  // namespace tc", start)]


def _body(src: str, name: str) -> str:
    """A kernel's or function's text from its name to the next one."""
    start = src.index(name + "(")
    nxt = re.search(r"\ntemplate <|\ncudaError_t |\n// ", src[start:])
    return src[start:start + nxt.start()] if nxt else src[start:]


def test_bf16_backward_kernels_run_on_wgmma():
    """The dQ kernel takes S and dP through ``issue_abt`` (wgmma with A and
    B from shared memory) and dQ through ``issue_xb`` (wgmma with A in
    registers); the dK/dV kernel likewise Sᵀ, dPᵀ and dV, dK; the
    walked tiles are staged by cp.async; nothing is left on mma.sync and
    nothing adds atomically."""
    body = _tc_bwd_source()
    abt = _body(body, "__device__ __forceinline__ void issue_abt")
    xb = _body(body, "__device__ __forceinline__ void issue_xb")
    assert "wgmma_ss(" in abt and "wgmma<1>(" in xb
    dq = _body(body, "flash_bwd_dq_bf16_kernel")
    dkdv = _body(body, "flash_bwd_dkdv_bf16_kernel")
    assert len(re.findall(r"\bissue_abt<", dq)) == 2 and \
        len(re.findall(r"\bissue_xb<", dq)) == 1
    assert len(re.findall(r"\bissue_abt<", dkdv)) == 2 and \
        len(re.findall(r"\bissue_xb<", dkdv)) == 2
    for kernel in (dq, dkdv):
        assert "stage_tile<D" in kernel and "cp_async_wait_all()" in kernel
    assert "mma.sync" not in body and "mma16816" not in SRC
    assert not re.search(r"atomicAdd|\bred\.|\batom\.", SRC)
    # the names the f32 backward's HMMA check counts stay the f32 kernels'
    assert "flash_bwd_dq_kernel" not in body
    assert "flash_bwd_dkdv_kernel" not in body


def test_the_bf16_split_constants_match_the_source():
    """The Python rule repeats the kernel's: its query stage, segment
    constants and per-D blocks (``bwd_launch<D, NQ, NK>``, 64 keys for
    each dK/dV warpgroup)."""
    body = _tc_bwd_source()

    def const(name, src=body):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert const("BQ", SRC) == BWD_BF16_BQ
    assert const("BWD_SEG_TARGET") == DKDV_BF16_SEG_TARGET
    assert const("BWD_SEG_MIN") == DKDV_BF16_SEG_MIN
    cases = re.findall(r"case (\d+): return bwd_launch<(\d+), (\d+), (\d+)>",
                       body)
    assert tuple(int(c[0]) for c in cases) == SUPPORTED_HEAD_DIMS
    for d, d_again, nq, nk in cases:
        assert d == d_again and int(nq) in (1, 2)
        assert BWD_BF16_BLOCK[int(d)] == 64 * int(nk)
