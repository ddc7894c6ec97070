"""Scene arithmetic parity between the JAX reference (``repro``) and the
PyTorch port (``repro_torch``): every ``ConvScene`` property, the key
strings, the backward-scene derivations and ``derive_exec_spec`` must be
*exactly* equal — the port may choose a different grain, never different
scene arithmetic."""
import dataclasses

import pytest

import repro.plan.build as jbuild
from repro.core import mapping as jmapping
from repro.core import scene as jscene
from repro.models import cnn as jcnn

import repro_torch.plan.build as tbuild
from repro_torch.core import mapping as tmapping
from repro_torch.core import scene as tscene
from repro_torch.models import cnn as tcnn

# tests/test_dilated.py's strided scenes: (B, IC, OC, inH, inW, flt, pad,
# stdH, stdW)
STRIDED = {
    "stride2":          (2, 8, 4, 10, 10, 3, 1, 2, 2),
    "stride2_exact":    (2, 4, 6, 9, 9, 3, 1, 2, 2),
    "stride3":          (2, 4, 5, 11, 11, 3, 1, 3, 3),
    "asym_stride":      (3, 5, 7, 11, 9, 3, 0, 3, 2),
    "even_filter":      (2, 4, 4, 8, 8, 2, 0, 2, 2),
    "pointwise_stride": (2, 4, 4, 7, 7, 1, 0, 2, 2),
}
EXTRA = {   # dilation axes set directly, plus a bf16 and a blocked-dgrad one
    "atrous": dict(B=2, IC=3, OC=5, inH=9, inW=8, fltH=3, fltW=3, padH=2,
                   padW=2, fdilH=2, fdilW=2),
    "lhs_dil": dict(B=1, IC=4, OC=2, inH=5, inW=6, fltH=3, fltW=2, padH=2,
                    padW=1, dilH=2, dilW=3, apadH=1, apadW=0),
    "bf16": dict(B=4, IC=8, OC=8, inH=6, inW=6, fltH=3, fltW=3, padH=1,
                 padW=1, dtype="bfloat16"),
    "big_pad": dict(B=1, IC=2, OC=2, inH=6, inW=6, fltH=3, fltW=3, padH=3,
                    padW=3),
}
_PROPS = ("dilated_inH", "dilated_inW", "dilated_fltH", "dilated_fltW",
          "outH", "outW", "is_dilated", "M", "N", "K", "num_spatial_tasks",
          "taps_h", "taps_w", "reduction_len", "macs", "flops",
          "arithmetic_intensity")
_METHODS = ("dilation_suffix", "family_key", "bytes_in", "bytes_out",
            "in_shape", "flt_shape", "out_shape", "padded_in_shape",
            "describe")


def _fields(sc):
    return dataclasses.asdict(sc)


def _all_scene_kwargs():
    out = {}
    for net, layers in jcnn.cnn_scenes().items():
        for i, sc in enumerate(layers):
            out[f"{net}/L{i}"] = _fields(sc)
    for name, (b, ic, oc, h, w, f, pad, sh, sw) in STRIDED.items():
        out[name] = dict(B=b, IC=ic, OC=oc, inH=h, inW=w, fltH=f, fltW=f,
                         padH=pad, padW=pad, stdH=sh, stdW=sw)
    out.update(EXTRA)
    return out


SCENES = _all_scene_kwargs()


def _pair(name):
    kw = SCENES[name]
    return jscene.ConvScene(**kw), tscene.ConvScene(**kw)


def _assert_same_scene(js, ts):
    assert _fields(js) == _fields(ts)
    for p in _PROPS:
        assert getattr(js, p) == getattr(ts, p), p
    for m in _METHODS:
        assert getattr(js, m)() == getattr(ts, m)(), m


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_properties_equal(name):
    js, ts = _pair(name)
    _assert_same_scene(js, ts)
    _assert_same_scene(js.with_batch(3), ts.with_batch(3))
    assert ts.with_batch(ts.B) is ts


@pytest.mark.parametrize("name", sorted(SCENES))
def test_backward_scenes_equal(name):
    js, ts = _pair(name)
    assert jbuild._stride_remainders(js) == tbuild._stride_remainders(ts)
    assert jbuild._dgrad_blocker(js) == tbuild._dgrad_blocker(ts)
    assert jbuild._wgrad_blocker(js) == tbuild._wgrad_blocker(ts)
    for fn in ("grad_input_scene", "grad_filter_scene"):
        try:
            want = getattr(jbuild, fn)(js)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                getattr(tbuild, fn)(ts)
            assert str(got.value) == str(e)
            continue
        _assert_same_scene(want, getattr(tbuild, fn)(ts))


def _choices(ts):
    yield "TB11", ts.M, ts.N, ts.K
    for bm in (1, 8, 24, 64):
        yield "TB18", bm, ts.N, ts.K
    for bm, bn, bk in ((16, 1, 8), (64, 4, 32), (128, 256, 3)):
        yield "TB88", bm, bn, bk


@pytest.mark.parametrize("name", sorted(SCENES))
def test_derive_exec_spec_equal(name):
    """One ``ScheduleChoice`` derives field-for-field equal specs in both
    packages, for the forward scene and for its backward scenes."""
    js, ts = _pair(name)
    pairs = [(js, ts, None)]
    if jbuild._dgrad_blocker(js) is None:
        pairs.append((jbuild.grad_input_scene(js),
                      tbuild.grad_input_scene(ts), None))
    if jbuild._wgrad_blocker(js) is None:
        pairs.append((jbuild.grad_filter_scene(js),
                      tbuild.grad_filter_scene(ts), (ts.fltH, ts.fltW)))
    for jsc, tsc, out_hw in pairs:
        for sched, bm, bn, bk in _choices(tsc):
            jc = jmapping.ScheduleChoice(sched, bm, bn, bk, 1.0, 0.5, 0.5, 0)
            tc = tmapping.ScheduleChoice(sched, bm, bn, bk, 1.0, 0.5, 0.5, 0)
            assert (dataclasses.asdict(jbuild.derive_exec_spec(jsc, jc,
                                                               out_hw))
                    == dataclasses.asdict(tbuild.derive_exec_spec(tsc, tc,
                                                                  out_hw)))


@pytest.mark.parametrize("a,b", [(0, 1), (1, 1), (7, 3), (9, 3), (128, 8),
                                 (5, 128)])
def test_int_helpers_equal(a, b):
    assert tscene.ceil_div(a, b) == jscene.ceil_div(a, b)
    assert tscene.round_up(a, b) == jscene.round_up(a, b)
    assert tscene.pow2_floor(a) == jscene.pow2_floor(a)


def test_scene_validation_matches():
    for bad in (dict(B=0), dict(stdH=0), dict(padW=-1), dict(fdilW=0),
                dict(apadH=-1), dict(inH=2, fltH=5), dict(dtype="int4x")):
        kw = dict(B=1, IC=1, OC=1, inH=4, inW=4, fltH=3, fltW=3)
        kw.update(bad)
        with pytest.raises(ValueError):
            jscene.ConvScene(**kw)
        with pytest.raises(ValueError):
            tscene.ConvScene(**kw)


@pytest.mark.parametrize("alias", ["float32", "f4", "bfloat16", "float16",
                                   "float64"])
def test_dtype_aliases_key_like_the_reference(alias):
    kw = dict(B=1, IC=2, OC=2, inH=4, inW=4, fltH=3, fltW=3, dtype=alias)
    assert (tscene.ConvScene(**kw).family_key()
            == jscene.ConvScene(**kw).family_key())
    assert (tscene.ConvScene(**kw).bytes_in()
            == jscene.ConvScene(**kw).bytes_in())


@pytest.mark.parametrize("kw", [dict(), dict(max_hw=8, max_ch=8),
                                dict(max_hw=16, layers_per_net=3),
                                dict(batch=4, max_ch=32)])
def test_cnn_scene_lists_equal(kw):
    """The port's scene lists, capped layer lists and chained trunks are
    the reference's, scene for scene."""
    list_kw = {k: v for k, v in kw.items() if k != "batch"}
    b = kw.get("batch", 1)
    assert ({n: [_fields(s) for s in v]
             for n, v in tcnn.cnn_scenes(b).items()}
            == {n: [_fields(s) for s in v]
                for n, v in jcnn.cnn_scenes(b).items()})
    assert ({n: _fields(s) for n, s in
             tcnn.cnn_layer_scenes(batch=b, **list_kw).items()}
            == {n: _fields(s) for n, s in
                jcnn.cnn_layer_scenes(batch=b, **list_kw).items()})
    for net in tcnn.cnn_scenes():
        assert ({n: _fields(s) for n, s in
                 tcnn.cnn_chain_scenes(net, b, **list_kw).items()}
                == {n: _fields(s) for n, s in
                    jcnn.cnn_chain_scenes(net, b, **list_kw).items()})


def test_validate_scene_chain_rejects_like_the_reference():
    good = tcnn.cnn_chain_scenes("resnet", max_hw=8, max_ch=8,
                                 layers_per_net=3)
    tcnn.validate_scene_chain(good)
    (na, a), (nb, b) = list(good.items())[:2]
    broken = {na: a, nb: dataclasses.replace(b, IC=b.IC + 1)}
    with pytest.raises(ValueError, match="chain breaks"):
        tcnn.validate_scene_chain(broken)
    with pytest.raises(ValueError):
        tcnn.validate_scene_chain({})


def test_full_resnet_trunk_geometry():
    """The trunk the chip smoke serves: 224x224x3 in, 14x14x512 out, ~4.8
    GFLOP per image."""
    chain = tcnn.cnn_chain_scenes("resnet")
    first, last = chain["resnet/L0"], chain["resnet/L9"]
    assert first.in_shape() == (224, 224, 3, 1)
    assert last.out_shape() == (14, 14, 512, 1)
    assert 4.7e9 < sum(s.flops for s in chain.values()) < 4.8e9
