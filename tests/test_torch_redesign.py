"""The redesigned kernels' geometry and rounding, checked on the CPU.

TB18 (``csrc/mg3m_conv.cu`` ``mg3m_tb18_kernel``) takes its compiled tile,
grid and shared-memory footprint from Python (the selector's choice,
``analysis/footprint``, ``kernels/mg3m_conv.launch_grid``), so the CPU can
check them: the footprint against a count of the kernel's layout, the grid
covering every (OC, column) of the output exactly once, the batch-1 trunk
layers spreading over at least 100 blocks, and the chosen tile reaching
the launch unchanged.  The bf16 flash kernel rounds P to
bf16 before the product with V; ``flash_attention_bf16p_plain`` spells
that rounding out and is held within the kernel's own tolerance (2e-2) of
``flash_attention_plain``, the function both flash kernels compute, and
against the JAX reference's Pallas kernel (interpret mode).  The CUDA
kernels themselves run only on the card (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bshd as jflash

from repro_torch.analysis import footprint as FP
from repro_torch.core import mapping as tmapping
from repro_torch.core.scene import ConvScene, ceil_div
from repro_torch.kernels import mg3m_conv as K
from repro_torch.kernels.flash_attention import (flash_attention_bf16p_plain,
                                                 flash_attention_plain)
from repro_torch.models.cnn import cnn_chain_scenes
from repro_torch.plan import ConvOp, make_plan

TRUNK = cnn_chain_scenes("resnet")
# tests/test_kernels.py's sweep: (B, IC, OC, inHW, flt, pad, std)
KERNEL_SCENES = [(8, 16, 24, 10, 3, 1, 1), (4, 8, 8, 7, 1, 0, 1),
                 (16, 32, 48, 12, 5, 2, 2), (3, 5, 7, 9, 3, 0, 2),
                 (1, 1, 1, 4, 3, 1, 1), (2, 64, 16, 8, 3, 1, 1),
                 (128, 16, 8, 6, 2, 0, 2)]
# tests/test_dilated.py's "stride2" and "asym_stride"
STRIDED = [(2, 8, 4, 10, 10, 3, 1, 2, 2), (3, 5, 7, 11, 9, 3, 0, 3, 2)]
# tests/test_flash_kernel.py:27-32 (B, S, T, Hq, Hkv, D), then D = 112
FLASH_SHAPES = [(2, 64, 64, 4, 4, 32), (2, 64, 64, 8, 2, 32),
                (1, 128, 128, 4, 1, 64), (2, 96, 96, 2, 2, 16)]
D112 = (1, 200, 200, 4, 2, 112)


def _with(sc: ConvScene, **kw) -> ConvScene:
    return ConvScene(**{**sc.__dict__, **kw})


def _tb18_spec(scene: ConvScene, op=ConvOp.FPROP) -> K.LaunchSpec:
    """The launch spec a forced TB18 plan hands its wrapper."""
    plan = make_plan(scene, op, policy="TB18", device="cpu")
    a = torch.zeros(scene.out_shape() if op is ConvOp.DGRAD
                    else scene.in_shape())
    b = torch.zeros(scene.out_shape() if op is ConvOp.WGRAD
                    else scene.flt_shape())
    _, inp, flt, blocks = plan.kernel_call(a, b)
    return K.launch_spec(plan.exec_scene, "TB18", in_shape=inp.shape,
                         flt_shape=flt.shape,
                         smem_budget=tmapping.SMEM_BUDGET, **blocks)


def _coverage(spec: K.LaunchSpec) -> np.ndarray:
    """How often the launch writes each (OC, column) of the output: a
    walk of the kernel's blocks, strips and tiles."""
    gx, gy, bc, _ = K.launch_grid(spec)
    m = spec.out_shape[2]
    cols = spec.out_shape[0] * spec.out_shape[1] * spec.out_shape[3]
    hits = np.zeros((m, cols), np.int32)
    for x in range(gx):
        for ct in range(x, ceil_div(cols, bc), gx):
            for y in range(gy):
                hits[y * spec.bm:(y + 1) * spec.bm, ct * bc:(ct + 1) * bc] += 1
    return hits


def _tb18_scenes():
    out = []
    for name, sc in TRUNK.items():
        for b in (1, 2, 4, 8):
            out.append((f"{name}/B{b}", sc.with_batch(b), ConvOp.FPROP))
    for spec in KERNEL_SCENES:
        b, ic, oc, hw, f, pad, std = spec
        out.append((f"kernel{spec}", ConvScene(
            B=b, IC=ic, OC=oc, inH=hw, inW=hw, fltH=f, fltW=f, padH=pad,
            padW=pad, stdH=std, stdW=std), ConvOp.FPROP))
    for spec in STRIDED:
        b, ic, oc, h, w, f, pad, sh, sw = spec
        sc = ConvScene(B=b, IC=ic, OC=oc, inH=h, inW=w, fltH=f, fltW=f,
                       padH=pad, padW=pad, stdH=sh, stdW=sw)
        out.append((f"dgrad{spec}", sc, ConvOp.DGRAD))
        out.append((f"wgrad{spec}", sc, ConvOp.WGRAD))
    return out


TB18_SCENES = _tb18_scenes()


# -- TB18: footprint --------------------------------------------------------
# (layer, dtype, tile) -> the kernel's layout counted by hand: the OC slice
# [taps, K rounded to 8, compiled BM] in the IO type, two IN tiles of BC
# columns x (32 k + 16 bytes), and a [taps, BC] int32 offset table.
HAND = {
    ("resnet/L2", "float32", (32, 64, 4, 2)): 9 * 64 * 32 * 4
    + 2 * 64 * 144 + 9 * 64 * 4,
    ("resnet/L5", "float32", (16, 128, 4, 2)): 9 * 128 * 16 * 4
    + 2 * 128 * 144 + 9 * 128 * 4,
    ("resnet/L7", "float32", (16, 128, 4, 2)): 9 * 256 * 16 * 4
    + 2 * 128 * 144 + 9 * 128 * 4,
    ("resnet/L9", "float32", (8, 128, 4, 2)): 9 * 512 * 8 * 4
    + 2 * 128 * 144 + 9 * 128 * 4,
    ("resnet/L9", "bfloat16", (16, 64, 4, 2)): 9 * 512 * 16 * 2
    + 2 * 64 * 80 + 9 * 64 * 4,
    ("resnet/L7", "bfloat16", (32, 64, 8, 4)): 9 * 256 * 32 * 2
    + 2 * 64 * 80 + 9 * 64 * 4,
}


@pytest.mark.parametrize("key", sorted(HAND))
def test_tb18_footprint_is_the_kernels_layout(key):
    name, dtype, tile = key
    sc = _with(TRUNK[name].with_batch(1), dtype=dtype)
    assert FP.tb18_smem(sc, tile) == HAND[key]
    assert FP.vmem_bytes(sc, "TB18", tile[0], 1, sc.K, tile) == HAND[key]
    assert HAND[key] <= tmapping.SMEM_BUDGET


def test_tb18_footprint_pads_k_and_the_slice():
    """K = 5 is padded to 8 rows per tap, a 7-wide slice to 8 columns."""
    sc = ConvScene(B=3, IC=5, OC=7, inH=9, inW=9, fltH=3, fltW=3)
    tile = make_plan(sc, policy="TB18", device="cpu").choice.tile
    bc = tile[1]
    assert tile in FP.tiles("TB18", 7) and tile[0] == 8
    want = -(-(9 * 8 * 8 * 4) // 16) * 16 + 2 * bc * 144 + 9 * bc * 4
    assert FP.tb18_smem(sc, tile) == want
    assert FP.vmem_bytes(sc, "TB18", 7, 3, 5, tile) == want
    with pytest.raises(ValueError, match="compiled tile"):
        FP.vmem_bytes(sc, "TB18", 7, 3, 5)


def test_tb18_shapes_are_the_compiled_set():
    for tile in FP.TB18_SHAPES:
        bm, bc, tm, tc = tile
        threads = FP.tile_threads(tile)
        assert bm in FP.KERNEL_BM and (tm, tc) in ((8, 4), (4, 2))
        assert bm % tm == 0 and bc % tc == 0
        assert 32 <= threads <= 256 and threads % 32 == 0
    # every compiled m-tile can run TB18
    assert all(FP.tiles("TB18", bm) for bm in FP.KERNEL_BM)
    # TB11/TB88 run their own compiled tiles (tests/test_torch_redesign_grains)
    assert FP.TB18_SHAPES is FP.SHAPES["TB18"]


# -- TB18: launch geometry ----------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TB18_SCENES, ids=[c[0] for c in TB18_SCENES])
def test_tb18_grid_covers_every_output_once(case, dtype):
    _, sc, op = case
    spec = _tb18_spec(_with(sc, dtype=dtype), op)
    gx, gy, bc, threads = K.launch_grid(spec)
    assert spec.tile in FP.TB18_SHAPES
    assert spec.tile in FP.tiles("TB18", spec.bm)
    assert bc == spec.bc and threads == FP.tile_threads(spec.tile)
    assert gy * spec.bm == spec.out_shape[2]
    assert (_coverage(spec) == 1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["resnet/L7", "resnet/L9"])
def test_tb18_fills_the_card_at_batch_1(name, dtype):
    """At batch 1 the small-spatial layers launch at least 100 blocks
    (the datasheet's 132 SMs), and every block is resident at once."""
    spec = _tb18_spec(_with(TRUNK[name].with_batch(1), dtype=dtype))
    gx, gy, bc, threads = K.launch_grid(spec)
    assert gx * gy >= 100
    per_sm = tmapping.blocks_per_sm(spec.smem, threads)
    assert gx * gy <= tmapping.H100_SMS * per_sm
    cols = spec.out_shape[0] * spec.out_shape[1] * spec.out_shape[3]
    waste = ceil_div(cols, bc) * bc / cols - 1
    assert waste < 0.35   # a fixed 512-column tile left 62 % masked at L9


@pytest.mark.parametrize("name", ["resnet/L2", "resnet/L7", "resnet/L9"])
def test_selector_prices_tb18_at_its_own_tile(name):
    """The tile is a dimension of the selector's search: every compiled
    tile of each slice width is a candidate, priced at its own columns."""
    sc = TRUNK[name].with_batch(1)
    cands = tmapping.candidate_blocks(sc, "TB18")
    for bm, _, _, _ in cands:
        assert {c[3] for c in cands if c[0] == bm} == set(FP.tiles("TB18", bm))
    for bm, _, _, tile in cands:
        bc = tile[1]
        n_ct, n_m = tmapping._units(sc, "TB18", bm, tile)
        assert n_ct == ceil_div(sc.num_spatial_tasks * sc.N, bc)
        assert n_m == ceil_div(sc.M, bm)
        assert tmapping.grid_steps(sc, "TB18", bm, sc.K, tile) == (
            n_ct * n_m * 9 * ceil_div(sc.K, FP.TB18_KC))


# The fastest compiled tile of each slice width in PERF.md's forced-tile
# chip times (f32, chip_smoke.py's tile sweep): the selector's model must
# rank it first.
FASTEST = [("resnet/L7", 1, (16, 128, 4, 2)), ("resnet/L9", 1, (8, 128, 4, 2)),
           ("resnet/L7", 2, (16, 128, 4, 2)), ("resnet/L9", 2, (8, 128, 4, 2))]


@pytest.mark.parametrize("name,batch,tile", FASTEST)
def test_selector_ranks_tiles_as_the_card_did(name, batch, tile):
    sc = TRUNK[name].with_batch(batch)
    scores = {t: tmapping._score(sc, "TB18", tile[0], batch, sc.K, tile=t)
              for t in FP.tiles("TB18", tile[0])}
    best = min((c.predicted_s, t) for t, c in scores.items() if c)[1]
    assert best == tile


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(TRUNK))
def test_plan_launches_the_tile_it_chose(name, dtype):
    """The tile is chosen once, stored in the plan's choice, and the
    launch spec, its footprint and the plan registry's serialized form
    all carry that same tile."""
    from repro_torch.tune.cache import choice_from_dict, choice_to_dict
    sc = _with(TRUNK[name].with_batch(1), dtype=dtype)
    plan = make_plan(sc, policy="TB18", device="cpu")
    spec = _tb18_spec(sc)
    assert plan.choice.tile in FP.tiles("TB18", plan.choice.bm)
    assert spec.tile == plan.choice.tile
    assert spec.smem == plan.choice.vmem_bytes
    assert choice_from_dict(choice_to_dict(plan.choice)) == plan.choice


# -- flash attention: the bf16 kernel's rounding of P -------------------------
def _qkv(shape, seed):
    b, s, t, hq, hkv, d = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh).astype(np.float32)
                 for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))


def _heads(x):
    """(B, S, H, D) -> (B*H, S, D)."""
    b, s, h, d = x.shape
    return torch.from_numpy(x).transpose(1, 2).reshape(b * h, s, d)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES + [D112])
def test_bf16_p_rounding_within_tolerance(shape, causal):
    q, k, v = (_heads(a).bfloat16().contiguous()
               for a in _qkv(shape, sum(shape)))
    got = flash_attention_bf16p_plain(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape", [FLASH_SHAPES[1], D112])
def test_bf16_p_rounding_against_pallas_kernel(shape):
    """Against the reference's Pallas kernel (f32, interpret mode) on the
    bf16-rounded operands: the extra rounding of P stays within 2e-2."""
    qn, kn, vn = (a.astype(jnp.bfloat16).astype(np.float32)
                  for a in _qkv(shape, 3))
    b, s, hq, d = qn.shape
    blk = 40 if s % 40 == 0 else 32
    want = np.asarray(jflash(jnp.asarray(qn), jnp.asarray(kn),
                             jnp.asarray(vn), causal=True, block_q=blk,
                             block_k=blk, interpret=True))
    got = flash_attention_bf16p_plain(_heads(qn).contiguous(),
                                      _heads(kn).contiguous(),
                                      _heads(vn).contiguous(), causal=True)
    got = got.reshape(b, hq, s, d).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
