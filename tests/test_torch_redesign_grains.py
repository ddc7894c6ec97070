"""TB11's and TB88's redesigned geometry, checked on the CPU.

Both kernels (``csrc/mg3m_conv.cu`` ``gemm_body``) walk the flattened
reduction ``r = tap * K + k`` in chunks of ``footprint.GEMM_KC``, on a
compiled tile ``(BM, BC, TM, TC)`` the selector chose and stored in
``ScheduleChoice.tile``.  Checked here: the shared-memory footprint against
a count of the kernel's layout, the launch grid covering every (OC,
column) of the output exactly once, a plain emulation of the chunk walk
(its per-chunk (tap, k) table, its row/column offset tables and its
zero-filled tail) reproducing ``conv_plain`` bitwise and the reference's
Pallas kernels in interpret mode within f32 ``1e-4``, the tile reaching
the launch and the plan cache unchanged, and the compiled tile lists in
Python mirroring the C ones.  The CUDA kernels themselves run only on the
card (``chip_smoke.py``).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.plan as jplan
from repro.core.scene import ConvScene as JScene

from repro_torch.analysis import footprint as FP
from repro_torch.core import mapping as tmapping
from repro_torch.core.scene import ConvScene, ceil_div
from repro_torch.kernels import mg3m_conv as K
from repro_torch.models.cnn import cnn_chain_scenes
from repro_torch.plan import ConvOp, make_plan
from repro_torch.tune.cache import choice_from_dict, choice_to_dict
from repro_torch.tune.space import block_candidates

CU = (Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
      / "mg3m_conv.cu")
TRUNK = cnn_chain_scenes("resnet")
GEMM = ("TB11", "TB88")
# tests/test_kernels.py's sweep: (B, IC, OC, inHW, flt, pad, std)
KERNEL_SCENES = [(8, 16, 24, 10, 3, 1, 1), (4, 8, 8, 7, 1, 0, 1),
                 (16, 32, 48, 12, 5, 2, 2), (3, 5, 7, 9, 3, 0, 2),
                 (1, 1, 1, 4, 3, 1, 1), (2, 64, 16, 8, 3, 1, 1),
                 (128, 16, 8, 6, 2, 0, 2)]
# tests/test_dilated.py's "stride2" and "asym_stride"
STRIDED = [(2, 8, 4, 10, 10, 3, 1, 2, 2), (3, 5, 7, 11, 9, 3, 0, 3, 2)]
TOL = dict(rtol=1e-4, atol=1e-4)


def _with(sc: ConvScene, **kw) -> ConvScene:
    return ConvScene(**{**sc.__dict__, **kw})


def _kw(b, ic, oc, hw, f, pad, std):
    return dict(B=b, IC=ic, OC=oc, inH=hw, inW=hw, fltH=f, fltW=f,
                padH=pad, padW=pad, stdH=std, stdW=std)


def _scenes():
    out = []
    for name, sc in TRUNK.items():
        for b in (1, 2, 4, 8):
            out.append((f"{name}/B{b}", sc.with_batch(b), ConvOp.FPROP))
    for spec in KERNEL_SCENES:
        out.append((f"kernel{spec}", ConvScene(**_kw(*spec)), ConvOp.FPROP))
    for spec in STRIDED:
        b, ic, oc, h, w, f, pad, sh, sw = spec
        sc = ConvScene(B=b, IC=ic, OC=oc, inH=h, inW=w, fltH=f, fltW=f,
                       padH=pad, padW=pad, stdH=sh, stdW=sw)
        out.append((f"dgrad{spec}", sc, ConvOp.DGRAD))
        out.append((f"wgrad{spec}", sc, ConvOp.WGRAD))
    return out


SCENES = _scenes()


def _spec(plan) -> K.LaunchSpec:
    """The launch spec a plan hands its grain's wrapper."""
    sc, op = plan.scene, plan.op
    a = torch.zeros(sc.out_shape() if op is ConvOp.DGRAD else sc.in_shape())
    b = torch.zeros(sc.out_shape() if op is ConvOp.WGRAD else sc.flt_shape())
    _, inp, flt, blocks = plan.kernel_call(a, b)
    return K.launch_spec(plan.exec_scene, plan.schedule, in_shape=inp.shape,
                         flt_shape=flt.shape,
                         smem_budget=tmapping.SMEM_BUDGET, **blocks)


def _coverage(spec: K.LaunchSpec) -> np.ndarray:
    """How often the launch writes each (OC, column) of the output: a walk
    of the kernel's blocks and, for TB11, of each block's work items."""
    gx, gy, bc, _ = K.launch_grid(spec)
    m = spec.out_shape[2]
    cols = spec.out_shape[0] * spec.out_shape[1] * spec.out_shape[3]
    n_ct = ceil_div(cols, bc)
    hits = np.zeros((m, n_ct * bc), np.int32)
    if spec.schedule == "TB88":
        assert gx == n_ct
        for x in range(gx):
            for y in range(gy):
                hits[y * spec.bm:(y + 1) * spec.bm, x * bc:(x + 1) * bc] += 1
    else:
        tbm = spec.tile[0]
        n_m = ceil_div(m, tbm)
        for x in range(gx):
            for w in range(x, n_ct * n_m, gx):
                ct, mt = divmod(w, n_m)
                hits[mt * tbm:(mt + 1) * tbm, ct * bc:(ct + 1) * bc] += 1
    return hits[:, :cols]


# -- footprint ----------------------------------------------------------------
# (layer, dtype, grain, tile) -> the kernel's layout counted by hand: the
# filter (TB88: two [32, BM] tiles; TB11: [32 * chunks, OC rounded up to BM])
# in the IO type, two IN tiles of BC columns x (32 + 16 bytes), two rows of
# 32 int4 reduction entries, and int32 [fh + fw, BC] offset tables.
HAND = {
    ("resnet/L2", "float32", "TB88", (64, 64, 8, 4)):
        2 * 32 * 64 * 4 + 2 * 64 * 144 + 2 * 32 * 16 + 4 * 6 * 64,
    ("resnet/L9", "float32", "TB88", (64, 64, 8, 4)):
        2 * 32 * 64 * 4 + 2 * 64 * 144 + 2 * 32 * 16 + 4 * 6 * 64,
    ("resnet/L5", "bfloat16", "TB88", (64, 64, 8, 4)):
        2 * 32 * 64 * 2 + 2 * 64 * 80 + 2 * 32 * 16 + 4 * 6 * 64,
    ("resnet/L1", "float32", "TB88", (64, 64, 8, 4)):
        2 * 32 * 64 * 4 + 2 * 64 * 144 + 2 * 32 * 16 + 4 * 2 * 64,
    # L0: 7 * 7 * 3 = 147 reduction values, 5 chunks of 32
    ("resnet/L0", "float32", "TB11", (64, 64, 8, 4)):
        160 * 64 * 4 + 2 * 64 * 144 + 2 * 32 * 16 + 4 * 14 * 64,
    ("resnet/L0", "bfloat16", "TB11", (64, 64, 8, 4)):
        160 * 64 * 2 + 2 * 64 * 80 + 2 * 32 * 16 + 4 * 14 * 64,
    ("resnet/L0", "float32", "TB88", (64, 64, 8, 4)):
        2 * 32 * 64 * 4 + 2 * 64 * 144 + 2 * 32 * 16 + 4 * 14 * 64,
    # L1: 64 reduction values, OC 64
    ("resnet/L1", "float32", "TB11", (64, 64, 8, 4)):
        64 * 64 * 4 + 2 * 64 * 144 + 2 * 32 * 16 + 4 * 2 * 64,
}


@pytest.mark.parametrize("key", sorted(HAND), ids=str)
def test_gemm_footprint_is_the_kernels_layout(key):
    name, dtype, grain, tile = key
    sc = _with(TRUNK[name].with_batch(2), dtype=dtype)
    bm = min(tile[0], sc.M)
    assert FP.gemm_smem(sc, tile, grain == "TB11") == HAND[key]
    assert FP.vmem_bytes(sc, grain, bm, 2, 8, tile) == HAND[key]
    assert HAND[key] <= tmapping.SMEM_BUDGET


def test_tb11_footprint_pads_the_filter():
    """K = 5 over 3 x 3 taps is 45 reduction values, two chunks of 32 rows;
    OC 7 is padded to the tile's 64 rows; the pads count."""
    sc = ConvScene(**_kw(3, 5, 7, 9, 3, 0, 2))
    tile = (64, 64, 4, 4)
    assert tile in FP.TB11_SHAPES
    want = 64 * 64 * 4 + 2 * 64 * 144 + 2 * 32 * 16 + 4 * 6 * 64
    assert FP.gemm_smem(sc, tile, True) == want
    assert FP.vmem_bytes(sc, "TB11", 7, 3, 5, tile) == want


@pytest.mark.parametrize("grain", GEMM)
def test_gemm_footprint_needs_a_compiled_tile(grain):
    sc = ConvScene(**_kw(3, 5, 7, 9, 3, 0, 2))
    with pytest.raises(ValueError, match="compiled tile"):
        FP.vmem_bytes(sc, grain, 7, 3, 5)
    with pytest.raises(ValueError, match="compiled tile"):
        FP.vmem_bytes(sc, grain, 7, 3, 5, (64, 64, 2, 2))


def test_tb11_still_fails_where_the_filter_does_not_fit():
    """f32 TB11 on trunk L9 (a 9.4 MB filter) is over every tile's budget."""
    sc = TRUNK["resnet/L9"]
    for tile in FP.TB11_SHAPES:
        assert FP.vmem_bytes(sc, "TB11", sc.M, 1, sc.K,
                             tile) > tmapping.SMEM_BUDGET
    assert not [c for c in tmapping.candidate_blocks(sc, "TB11")
                if tmapping._score(sc, "TB11", *c[:3], tile=c[3])]


@pytest.mark.parametrize("grain", GEMM)
def test_gemm_shapes_are_the_compiled_set(grain):
    for tile in FP.SHAPES[grain]:
        bm, bc, tm, tc = tile
        threads = FP.tile_threads(tile)
        assert (tm, tc) in ((8, 8), (8, 4), (4, 4))
        assert bm % (2 * tm) == 0 and bc % tc == 0 and bc % 32 == 0
        # the kernel fills two chunks' reduction rows with one thread each
        assert 2 * FP.GEMM_KC <= threads <= 256 and threads % 32 == 0
    # every TB88 m-tile of the search runs on some compiled tile
    for bm in range(1, 129):
        assert FP.tiles("TB88", bm)
        assert all(t[0] >= bm for t in FP.tiles("TB88", bm))


# -- the C lists --------------------------------------------------------------
@pytest.mark.parametrize("grain", ["TB11", "TB18", "TB88"])
def test_compiled_tiles_mirror_the_c_lists(grain):
    """``footprint.<grain>_SHAPES`` and the ``<grain>_SHAPE(...)`` list in
    csrc/mg3m_conv.cu name the same tiles."""
    src = CU.read_text()
    found = re.findall(rf"\b{grain}_SHAPE\((\d+),\s*(\d+),\s*(\d+),\s*(\d+)\)",
                       src)
    c_list = [tuple(int(v) for v in t) for t in found]
    assert len(c_list) == len(set(c_list))
    assert set(c_list) == set(FP.SHAPES[grain])
    assert len(FP.SHAPES[grain]) == len(set(FP.SHAPES[grain]))


def test_footprint_mirrors_the_c_chunk_and_geom():
    src = CU.read_text()
    assert re.search(rf"constexpr int G_KC = {FP.GEMM_KC};", src)
    assert re.search(rf"constexpr int T18_KC = {FP.TB18_KC};", src)
    struct = src[src.index("struct Geom {"):src.index("};", src.index(
        "struct Geom {"))]
    names = re.findall(r"\b(\w+)\s*[,;]", re.sub(r"//[^\n]*", "", struct))
    names = [n for n in names if n != "int"]
    assert names == [f for f, _ in K._Geom._fields_]


# -- launch geometry ----------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grain", GEMM)
@pytest.mark.parametrize("case", SCENES, ids=[c[0] for c in SCENES])
def test_gemm_grid_covers_every_output_once(case, grain, dtype):
    _, sc, op = case
    try:
        plan = make_plan(_with(sc, dtype=dtype), op, policy=grain,
                         device="cpu")
    except ValueError:
        assert grain == "TB11"   # the whole filter does not fit
        return
    spec = _spec(plan)
    gx, gy, bc, threads = K.launch_grid(spec)
    assert spec.tile == plan.choice.tile and spec.tile in FP.SHAPES[grain]
    assert bc == spec.tile[1] and threads == FP.tile_threads(spec.tile)
    if grain == "TB88":
        assert spec.bm <= spec.tile[0]
        assert gy * spec.bm == spec.out_shape[2]
    else:
        assert gy == 1 and gx <= tmapping.H100_SMS * tmapping.blocks_per_sm(
            spec.smem, threads)
    assert (_coverage(spec) == 1).all()


# -- the flattened reduction --------------------------------------------------
def _in_coord(o, tap, stride, fdil, pad, dil, extent):
    """The kernels' index map (csrc ``in_coord``) over an array of output
    coordinates: the input coordinate, or -1 where the tap is masked."""
    q = o * stride + tap * fdil - pad
    ok = q >= 0
    if dil != 1:
        ok &= q % dil == 0
        q = np.where(ok, q // dil, -1)
    return np.where(ok & (q < extent), q, -1)


def emulate_gemm(inp: torch.Tensor, flt: torch.Tensor, sc: ConvScene,
                 kc: int = FP.GEMM_KC) -> torch.Tensor:
    """The TB11/TB88 kernels' walk in plain PyTorch, all columns at once:
    per column a tap-row and a tap-column offset table (-1 where masked);
    per chunk of ``kc`` reduction values a table of (i, j, k) for each r,
    past R = fh * fw * K a zero-filled row of both operands; one product
    and one add per r, chunks and r ascending.  Operands as launched."""
    pad_h, pad_w, dil_h, dil_w = K._index_params(sc)
    hl, wl, k, n = inp.shape
    fh, fw, _, m = flt.shape
    cols = sc.outH * sc.outW * n
    c = np.arange(cols)
    p, nn = c // n, c % n
    oh, ow = p // sc.outW, p % sc.outW
    rowtab = np.stack([
        np.where(ih >= 0, ih * wl * k * n, -1) for ih in (
            _in_coord(oh, i, sc.stdH, sc.fdilH, pad_h, dil_h, hl)
            for i in range(fh))])
    coltab = np.stack([
        np.where(iw >= 0, iw * k * n + nn, -1) for iw in (
            _in_coord(ow, j, sc.stdW, sc.fdilW, pad_w, dil_w, wl)
            for j in range(fw))])
    r_all = fh * fw * k
    x = inp.reshape(-1).float()
    f = flt.reshape(r_all, m).float()
    acc = torch.zeros(m, cols)
    for q in range(ceil_div(r_all, kc)):
        rtab = []
        for rr in range(kc):
            r = q * kc + rr
            if r < r_all:
                t, kk = divmod(r, k)
                rtab.append((t // fw, t % fw, kk * n))
            else:
                rtab.append(None)
        for rr, entry in enumerate(rtab):
            if entry is None:            # the zero-filled tail
                a, b = torch.zeros(m), torch.zeros(cols)
            else:
                i, j, koff = entry
                ok = (rowtab[i] >= 0) & (coltab[j] >= 0)
                off = np.where(ok, rowtab[i] + coltab[j] + koff, 0)
                b = torch.where(torch.from_numpy(ok), x[off], 0.0)
                a = f[q * kc + rr]
            acc += a[:, None] * b[None, :]
    out = acc.reshape(m, sc.outH, sc.outW, n).permute(1, 2, 0, 3)
    return out.to(inp.dtype).contiguous()


EMU_SCENES = {
    # K = 3: a chunk crosses ten taps (the stem's shape, cut down)
    "k3": dict(B=2, IC=3, OC=8, inH=11, inW=11, fltH=7, fltW=7, padH=3,
               padW=3, stdH=2, stdW=2),
    # K = 5, R = 45: two chunks, the second 13 values long
    "k5": _kw(3, 5, 7, 9, 3, 0, 2),
    # K = 40 is no multiple of the chunk: chunks straddle taps
    "k40": _kw(2, 40, 16, 6, 3, 1, 1),
    "k1_b1": _kw(1, 1, 1, 4, 3, 1, 1),
    "atrous": dict(B=2, IC=3, OC=5, inH=9, inW=8, fltH=3, fltW=3, padH=2,
                   padW=2, fdilH=2, fdilW=2),
}


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _launched(plan, a, b):
    _, inp, flt, _ = plan.kernel_call(torch.from_numpy(a), torch.from_numpy(b))
    return inp, flt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grain", GEMM)
@pytest.mark.parametrize("name", sorted(EMU_SCENES))
def test_chunk_walk_reproduces_conv_plain_bitwise(name, grain, dtype):
    sc = ConvScene(**EMU_SCENES[name], dtype=dtype)
    plan = make_plan(sc, policy=grain, device="cpu")
    inp, flt = _launched(plan, _np(sc.in_shape(), 1), _np(sc.flt_shape(), 2))
    inp, flt = inp.to(getattr(torch, dtype)), flt.to(getattr(torch, dtype))
    got = emulate_gemm(inp, flt, plan.exec_scene)
    assert torch.equal(got, K.conv_plain(inp, flt, plan.exec_scene))


@pytest.mark.parametrize("kc", [1, 3, 7, 32, 64])
def test_chunk_width_does_not_change_the_sums(kc):
    """The order is r ascending whatever the chunk: every chunk width gives
    the same bits (the kernel's bitwise grain independence)."""
    sc = ConvScene(**EMU_SCENES["k40"])
    plan = make_plan(sc, policy="TB88", device="cpu")
    inp, flt = _launched(plan, _np(sc.in_shape(), 3), _np(sc.flt_shape(), 4))
    assert torch.equal(emulate_gemm(inp, flt, plan.exec_scene, kc),
                       emulate_gemm(inp, flt, plan.exec_scene))


@pytest.mark.parametrize("op", [ConvOp.DGRAD, ConvOp.WGRAD])
@pytest.mark.parametrize("spec", STRIDED, ids=str)
def test_chunk_walk_on_dilated_routes(spec, op):
    """DGRAD launches the lhs-dilated route (compact input, masked hole
    taps), WGRAD the rhs-dilated one with many taps."""
    b, ic, oc, h, w, f, pad, sh, sw = spec
    sc = ConvScene(B=b, IC=ic, OC=oc, inH=h, inW=w, fltH=f, fltW=f, padH=pad,
                   padW=pad, stdH=sh, stdW=sw)
    plan = make_plan(sc, op, policy="TB88", device="cpu")
    x, flt, cot = (_np(sc.in_shape(), 5), _np(sc.flt_shape(), 6),
                   _np(sc.out_shape(), 7))
    inp, f_l = _launched(plan, *((cot, flt) if op is ConvOp.DGRAD
                                 else (x, cot)))
    assert torch.equal(emulate_gemm(inp, f_l, plan.exec_scene),
                       K.conv_plain(inp, f_l, plan.exec_scene))


@pytest.mark.parametrize("grain", GEMM)
@pytest.mark.parametrize("name", ["k3", "k5", "k40"])
def test_chunk_walk_matches_the_pallas_kernels(name, grain):
    """Against the reference's ``conv_tb11`` / ``conv_tb88`` (interpret
    mode) through its own forced plan: f32 within 1e-4."""
    kw = EMU_SCENES[name]
    sc = ConvScene(**kw)
    a, b = _np(sc.in_shape(), 8), _np(sc.flt_shape(), 9)
    want = jplan.make_plan(JScene(**kw), "fprop", policy=grain,
                           interpret=True).execute(jnp.asarray(a),
                                                   jnp.asarray(b))
    plan = make_plan(sc, policy=grain, device="cpu")
    inp, flt = _launched(plan, a, b)
    got = emulate_gemm(inp, flt, plan.exec_scene)[:, :, :sc.OC, :sc.B]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the selector's tile ------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grain", GEMM)
@pytest.mark.parametrize("name", list(TRUNK))
def test_plan_launches_the_gemm_tile_it_chose(name, grain, dtype):
    """The tile is chosen once, stored in the plan's choice, and the launch
    spec, its footprint and the plan cache's serialized form carry it."""
    sc = _with(TRUNK[name].with_batch(8), dtype=dtype)
    try:
        plan = make_plan(sc, policy=grain, device="cpu")
    except ValueError:
        assert grain == "TB11"
        return
    spec = _spec(plan)
    assert plan.choice.tile in FP.tiles(grain, plan.choice.bm)
    assert spec.tile == plan.choice.tile
    assert spec.smem == plan.choice.vmem_bytes
    assert choice_from_dict(choice_to_dict(plan.choice)) == plan.choice


@pytest.mark.parametrize("name", list(TRUNK))
def test_tb88_candidates_differ_in_bm_not_bk(name):
    """The kernel's chunk does not depend on ``bk``: one ``bk`` per m-tile,
    the one that pads K least, so the selector prices no variants the
    kernel cannot tell apart."""
    sc = TRUNK[name].with_batch(4)
    cands = block_candidates(sc, "TB88")
    assert len({bm for bm, _, _ in cands}) == len(cands)
    (bk,) = {bk for _, _, bk in cands}
    assert sc.K % bk == 0
    for bm, _, _ in cands:
        assert bm <= sc.M and FP.tiles("TB88", bm)


@pytest.mark.parametrize("name", ["resnet/L0", "resnet/L2", "resnet/L9"])
def test_selector_prices_gemm_grains_at_their_own_tile(name):
    """Every compiled tile of each m-tile is a candidate; its units and
    chunk steps follow the tile and the flattened reduction."""
    sc = TRUNK[name].with_batch(8)
    for grain in GEMM:
        cands = tmapping.candidate_blocks(sc, grain)
        assert cands
        for bm, _, bk, tile in cands:
            assert tile in FP.tiles(grain, bm)
            n_ct, n_m = tmapping._units(sc, grain, bm, tile)
            assert n_ct == ceil_div(sc.num_spatial_tasks * sc.N, tile[1])
            assert n_m == ceil_div(sc.M, tile[0] if grain == "TB11" else bm)
            red = sc.fltH * sc.fltW * ceil_div(sc.K, bk) * bk
            assert tmapping.grid_steps(sc, grain, bm, bk, tile) == (
                n_ct * n_m * ceil_div(red, FP.GEMM_KC))
