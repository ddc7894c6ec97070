"""The causal_conv1d backward on the CPU: ``causal_conv1d_bwd_plain`` (the
backward kernels' function in their order, the CPU's backward and the
card's yardstick) against the reference.

The reference has no backward kernel: its Mamba2 calls the plain
``causal_conv1d_ref`` on its model path and XLA differentiates it, so the
plain backward is held to ``jax.vjp`` of that function at the reference's
f32 tolerance (1e-4, ``tests/test_kernels.py:41``), and to the torch-ops
formula the port ran before the kernels (within 1e-5: the two sum in other
orders).  A scalar emulation pins the order the kernels sum in (dx's taps
from ``w[K-1]*dy[m]`` on; dw per segment of ``BWD_SEGMENT`` positions, then
segment by segment), bit for bit.  ``CausalConv1d`` must reach
``causal_conv1d_bwd``; on meta a zamba2-7b train step's trace must record
the backward once per Mamba2 layer and microbatch at its closed form and
load no kernel library.  The two copies of the segment-sum pass in
``csrc/`` must stay equal.  The kernels themselves run only on the card,
where ``chip_smoke.py`` holds them bitwise to the plain version.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

import repro_torch.kernels.causal_conv1d as CC
from repro_torch.configs.registry import get_config, reduced
from repro_torch.kernels import cuda_build, meta
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mg3m_conv as MG
from repro_torch.kernels.causal_conv1d import (BWD_SEGMENT, CausalConv1d,
                                               bwd_segments,
                                               causal_conv1d_bwd,
                                               causal_conv1d_bwd_plain)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import step as S

TOL = 1e-4
CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
CONV_SRC = (CSRC / "causal_conv1d.cu").read_text()
MG3M_SRC = (CSRC / "mg3m_conv.cu").read_text()
# (B, L, D, K): every K, B > 1, a ragged L, L < K, L = 1, L a multiple of
# the segment, and L over several segments with a ragged last one
SHAPES = [(2, 32, 16, 4), (1, 7, 5, 3), (3, 20, 8, 2), (2, 3, 6, 4),
          (1, 1, 4, 2), (2, 17, 3, 1), (2, 2 * BWD_SEGMENT, 6, 4),
          (3, 2 * BWD_SEGMENT + 45, 5, 3), (1, 4 * BWD_SEGMENT + 1, 4, 4)]


def _operands(b, length, d, kw, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, length, d)).astype(np.float32),
            rng.standard_normal((kw, d)).astype(np.float32),
            rng.standard_normal((b, length, d)).astype(np.float32))


def _torch_ops_grads(x, w, dy):
    """The backward the port ran before the kernels (torch ops, f32): per
    tap a sliced multiply-add into dx and a product summed into dw."""
    kw, length = w.shape[0], x.shape[1]
    dx = torch.zeros_like(x)
    dw = torch.zeros_like(w)
    for k in range(kw):
        s = kw - 1 - k
        if s >= length:
            continue
        dx[:, :length - s] += w[k] * dy[:, s:]
        dw[k] = (x[:, :length - s] * dy[:, s:]).sum((0, 1))
    return dx, dw


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_the_reference_vjp(shape):
    x, w, dy = _operands(*shape, seed=sum(shape))
    dx, dw = causal_conv1d_bwd_plain(*map(torch.from_numpy, (x, w, dy)))
    _, vjp = jax.vjp(jref.causal_conv1d_ref, x, w)
    jdx, jdw = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_the_torch_ops_formula(shape):
    x, w, dy = map(torch.from_numpy, _operands(*shape, seed=7 * sum(shape)))
    for got, want in zip(causal_conv1d_bwd_plain(x, w, dy),
                         _torch_ops_grads(x, w, dy)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, BWD_SEGMENT + 39, 3, 4),
                                   (1, 5, 2, 3), (3, 9, 2, 1)])
def test_plain_backward_sums_in_the_kernels_order(shape):
    """A scalar emulation in float32, one rounding per product and per
    sum: dx[m] = w[K-1] dy[m] + w[K-2] dy[m+1] + ...; dw per segment from
    +0, position by position, then the segments added from the first, in
    (b, segment) order.  The plain version must equal it bit for bit."""
    b, length, d, kw = shape
    x, w, dy = _operands(*shape, seed=3)
    f = np.float32
    dx = np.zeros_like(x)
    for bi in range(b):
        for m in range(length):
            for c in range(d):
                a = f(w[kw - 1, c] * dy[bi, m, c])
                for s in range(1, kw):
                    yv = dy[bi, m + s, c] if m + s < length else f(0)
                    a = f(a + f(w[kw - 1 - s, c] * yv))
                dx[bi, m, c] = a
    parts = []
    for bi in range(b):
        for l0 in range(0, length, BWD_SEGMENT):
            part = np.zeros((kw, d), np.float32)
            for m in range(l0, min(l0 + BWD_SEGMENT, length)):
                for k in range(kw):
                    s = kw - 1 - k
                    xv = x[bi, m - s] if m >= s else np.zeros(d, np.float32)
                    part[k] = (part[k] + (xv * dy[bi, m])).astype(np.float32)
            parts.append(part)
    assert len(parts) == bwd_segments(b, length)
    dw = parts[0].copy()
    for part in parts[1:]:
        dw = (dw + part).astype(np.float32)
    got = causal_conv1d_bwd_plain(*map(torch.from_numpy, (x, w, dy)))
    assert np.array_equal(got[0].numpy(), dx)
    assert np.array_equal(got[1].numpy(), dw)


def test_a_sequence_has_the_same_dx_alone_and_in_a_batch():
    x, w, dy = map(torch.from_numpy, _operands(3, 2 * BWD_SEGMENT + 5, 4, 4,
                                               seed=11))
    dx, _ = causal_conv1d_bwd(x, w, dy)
    alone, _ = causal_conv1d_bwd(x[1:2], w, dy[1:2])
    assert torch.equal(dx[1:2], alone)


@pytest.mark.parametrize("shape", [(2, 300, 16, 4), (1, 64, 7, 3)])
def test_bf16_operands_within_2e_2_of_the_f32_function(shape):
    x, w, dy = map(torch.from_numpy, _operands(*shape, seed=5))
    want = causal_conv1d_bwd_plain(x, w, dy)
    got = causal_conv1d_bwd(*(t.bfloat16() for t in (x, w, dy)))
    for g, r in zip(got, want):
        assert g.dtype == torch.bfloat16
        rel = ((g.float() - r).abs().max() / r.abs().max()).item()
        assert rel <= 2e-2


def test_causal_conv1d_goes_through_causal_conv1d_bwd(monkeypatch):
    """On a CPU tensor ``CausalConv1d``'s backward is the plain version,
    counted in ``backward_calls``; no kernel launch is counted."""
    x, w, dy = map(torch.from_numpy, _operands(2, 40, 6, 4, seed=1))
    seen = []

    def spy(*args):
        seen.append(tuple(a.shape for a in args))
        return causal_conv1d_bwd_plain(*args)

    monkeypatch.setattr(CC, "causal_conv1d_bwd_plain", spy)
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    calls, launches = CausalConv1d.backward_calls, causal_conv1d_bwd.launches
    y = CausalConv1d.apply(tx, tw)
    gx, gw = torch.autograd.grad(y, (tx, tw), dy.transpose(0, 1)
                                 .contiguous().transpose(0, 1))
    assert seen == [(x.shape, w.shape, dy.shape)]
    assert CausalConv1d.backward_calls == calls + 1
    assert causal_conv1d_bwd.launches == launches
    want = causal_conv1d_bwd_plain(x, w, dy)
    assert torch.equal(gx, want[0]) and torch.equal(gw, want[1])


def test_bad_operands_raise():
    x, w = torch.zeros(1, 8, 4), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="dy"):
        causal_conv1d_bwd(x, w, torch.zeros(1, 8, 5))
    with pytest.raises(ValueError, match="filter width"):
        causal_conv1d_bwd(x, torch.zeros(5, 4), x)
    with pytest.raises(ValueError, match="operands must be on one CUDA"):
        CC._launch_bwd(x, w, x)


def test_meta_records_the_closed_form():
    b, length, d, kw = 2, 3 * BWD_SEGMENT + 1, 24, 4
    x = torch.empty(b, length, d, device="meta", dtype=torch.bfloat16)
    w = torch.empty(kw, d, device="meta", dtype=torch.bfloat16)
    seen = []

    class Rec:
        def kernel(self, name, flops, dtype, nbytes):
            seen.append((name, flops, dtype, nbytes))

    with meta.recording(Rec()):
        dx, dw = causal_conv1d_bwd(x, w, torch.empty_like(x))
    assert (dx.shape, dx.dtype, dw.shape) == (x.shape, x.dtype, w.shape)
    segs = bwd_segments(b, length)
    assert segs == b * 4
    assert seen == [
        ("causal_conv1d_bwd", 4 * kw * b * length * d, torch.bfloat16,
         2 * (3 * b * length * d + 2 * kw * d)),
        ("causal_conv1d_bwd_partials", (segs - 1) * kw * d, torch.float32,
         2 * 4 * segs * kw * d)]


def test_train_trace_records_the_backward_once_per_mamba_layer(monkeypatch):
    """A reduced zamba2-7b train step traced on meta records
    ``causal_conv1d_bwd`` once per Mamba2 layer and microbatch (the
    checkpointed group's recomputation runs the forward again, not the
    backward) at ``meta``'s closed form, and loads no kernel library."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel library was loaded on meta")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "load_all", refuse)
    for lib in (FA.library, CC.library, MG.library):
        lib.cache_clear()
    n_mb, seq = 2, 48
    cfg = dataclasses.replace(reduced(get_config("zamba2-7b")), n_layers=3)
    tr = S.trace_train_step(cfg, "train_4k", make_host_mesh("meta"),
                            S.StepPlan(n_microbatches=n_mb),
                            batch_override=2, seq_override=seq)
    calls = cfg.n_layers * n_mb
    conv_dim = cfg.ssm.expand * cfg.d_model \
        + 2 * cfg.ssm.n_groups * cfg.ssm.state
    kw, elt = cfg.ssm.conv_kernel, 4                   # a batch of 1, f32
    segs = bwd_segments(1, seq)
    assert tr.by_op["kernel:causal_conv1d_bwd"] == [
        calls, calls * 4 * kw * seq * conv_dim,
        calls * elt * (3 * seq * conv_dim + 2 * kw * conv_dim)]
    assert tr.by_op["kernel:causal_conv1d_bwd_partials"] == [
        calls, calls * (segs - 1) * kw * conv_dim,
        calls * 2 * 4 * segs * kw * conv_dim]
    for lib in (FA.library, CC.library, MG.library):
        assert lib.cache_info().currsize == 0


def _segsum_block(src: str) -> str:
    block = re.search(r"// ---- segsum: begin.*?// ---- segsum: end ----",
                      src, flags=re.S)
    assert block is not None
    return re.sub(r"\b(mg3m|causal_conv1d)_segsum_kernel\b", "KERNEL",
                  block.group(0))


def test_the_segment_sum_copies_are_equal():
    """The second pass is one design in two sources: ``mg3m_segsum_kernel``
    and ``causal_conv1d_segsum_kernel`` differ only by name."""
    assert _segsum_block(CONV_SRC) == _segsum_block(MG3M_SRC)
    assert "segsum_launch(dtype" in MG3M_SRC


def test_the_source_matches_the_wrapper():
    """The segment length is one constant on both sides; the backward uses
    no atomics (its order is fixed)."""
    seg = re.search(r"constexpr int BWD_SEGMENT = (\d+);", CONV_SRC)
    assert seg is not None and int(seg.group(1)) == BWD_SEGMENT
    assert not re.search(r"atomicAdd|\bred\.|\batom\.", CONV_SRC)
    assert "__fmul_rn" in CONV_SRC and "__fadd_rn" in CONV_SRC
