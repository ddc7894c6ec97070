"""Convolution *scene* descriptor — the unit the multi-grained selector
reasons about (port of ``repro.core.scene``).

The paper (MG3MConv, §4.1) decomposes a convolution into ``outH*outW*fltH*fltW``
small matrix multiplications (``MM_unit``) with dims

    M = OC   (output channels)
    N = B    (batch)
    K = IC   (input channels)

over data layouts IN[inH, inW, IC, B], FLT[fltH, fltW, IC, OC],
OUT[outH, outW, OC, B].  A ``ConvScene`` captures everything the mapping
selector (core/mapping.py) needs to choose a grid schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# The weight gradient's split reduction.  A wgrad exec scene
# (plan/build.grad_filter_scene) contracts the forward's output pixels and
# batch, up to 100 352 reduction values onto a few hundred output columns:
# a handful of blocks, each walking all of it.  Its plans cut the
# reduction into segments of whole taps, each walked by blocks of its own
# into an f32 partial, and a second kernel (mg3m_segsum) adds the
# partials in segment order.  A segment holds WGRAD_SEGMENT_R reduction
# values rounded down to whole taps (at least one tap), a length chosen
# by timing the ResNet trunk's wgrad scenes at several on the card
# (``chip_tile_sweep.py --segments``, PERF.md §6).  The split depends on
# the exec scene's reduction (taps and K) alone, so the plain version,
# every grain, tuned and analytic plans, and every partition that keeps
# the reduction sum in one order.
WGRAD_SEGMENT_R = 1024


@dataclasses.dataclass(frozen=True)
class ConvScene:
    """Static description of one convolution problem (paper Table 1 symbols).

    Beyond the paper's forward dims, a scene carries the two dilation axes
    that make the *backward* convolutions of strided forwards expressible as
    MG3M scenes (cuDNN treats the whole family as one gemm-mapped primitive):

      ``dilH``/``dilW``   input (lhs) dilation — the input is read as if
                          zero-interleaved with ``dil - 1`` zeros between
                          elements (transposed convolution / dgrad of a
                          strided forward);
      ``fdilH``/``fdilW`` filter (rhs) dilation — taps are ``fdil`` apart
                          (atrous convolution / wgrad of a strided forward);
      ``apadH``/``apadW`` extra zero padding on the *high* spatial side only
                          (the adjoint of a forward with stride remainder
                          needs asymmetric padding).
    """

    B: int
    IC: int
    OC: int
    inH: int
    inW: int
    fltH: int
    fltW: int
    padH: int = 0
    padW: int = 0
    stdH: int = 1
    stdW: int = 1
    dtype: str = "float32"
    dilH: int = 1
    dilW: int = 1
    fdilH: int = 1
    fdilW: int = 1
    apadH: int = 0
    apadW: int = 0

    def __post_init__(self):
        if min(self.B, self.IC, self.OC, self.inH, self.inW, self.fltH, self.fltW) <= 0:
            raise ValueError(f"all scene dims must be positive: {self}")
        if self.stdH <= 0 or self.stdW <= 0:
            raise ValueError("stride must be positive")
        if self.padH < 0 or self.padW < 0:
            raise ValueError("padding must be non-negative")
        if min(self.dilH, self.dilW, self.fdilH, self.fdilW) <= 0:
            raise ValueError("dilation must be positive")
        if self.apadH < 0 or self.apadW < 0:
            raise ValueError("extra high-side padding must be non-negative")
        dtype_name(self.dtype)   # raises ValueError on an unknown dtype
        if self.outH <= 0 or self.outW <= 0:
            raise ValueError(f"empty output for scene {self}")

    # -- derived spatial dims ------------------------------------------------
    @property
    def dilated_inH(self) -> int:
        """Input H extent after lhs dilation (zeros interleaved)."""
        return (self.inH - 1) * self.dilH + 1

    @property
    def dilated_inW(self) -> int:
        return (self.inW - 1) * self.dilW + 1

    @property
    def dilated_fltH(self) -> int:
        """Filter H footprint after rhs dilation (taps ``fdilH`` apart)."""
        return (self.fltH - 1) * self.fdilH + 1

    @property
    def dilated_fltW(self) -> int:
        return (self.fltW - 1) * self.fdilW + 1

    @property
    def outH(self) -> int:
        return ((self.dilated_inH + 2 * self.padH + self.apadH
                 - self.dilated_fltH) // self.stdH + 1)

    @property
    def outW(self) -> int:
        return ((self.dilated_inW + 2 * self.padW + self.apadW
                 - self.dilated_fltW) // self.stdW + 1)

    @property
    def is_dilated(self) -> bool:
        """True when any dilation axis is active (the kernels then read the
        compact input through hole-skipping index maps)."""
        return (self.dilH, self.dilW, self.fdilH, self.fdilW) != (1, 1, 1, 1)

    def dilation_suffix(self) -> str:
        """Canonical ``|dil=..|fdil=..|apad=..`` key fragment shared by the
        tune-cache and plan-registry signatures — empty when every dilation
        axis is at its default, so pre-dilation keys stay byte-identical.
        One definition: a future scene axis added here reaches both key
        formats at once instead of silently colliding in one of them."""
        if not (self.is_dilated or self.apadH or self.apadW):
            return ""
        return (f"|dil={self.dilH},{self.dilW}"
                f"|fdil={self.fdilH},{self.fdilW}"
                f"|apad={self.apadH},{self.apadW}")

    @property
    def seg_taps(self) -> int:
        """Taps per segment of the reduction its plans split, 0 where they
        do not split it: only a ``WgradScene`` splits."""
        return 0

    # -- batch-family identity (serving coalesces along B) ---------------------
    def with_batch(self, b: int) -> "ConvScene":
        """The same scene rebatched to ``B = b`` — the serving layer's
        rebucketing primitive.  Batch is the MM_unit N dim: every other
        axis (spatial, channels, stride, padding, dilation, dtype) is
        untouched, so two requests whose scenes differ only here can share
        one batched ``ConvPlan.execute``."""
        return self if b == self.B else dataclasses.replace(self, B=b)

    def family_key(self) -> str:
        """B-agnostic scene identity: everything that changes the executable
        *except* the batch size.  Two scenes with equal family keys are the
        same convolution at different batch sizes (``with_batch`` maps
        between them), which is exactly the coalescing unit of the serving
        layer's bucket ladder.  Dtype-alias-stable via numpy dtype names;
        the dilation axes ride the shared ``dilation_suffix`` fragment."""
        dt = dtype_name(self.dtype)
        return (f"ic={self.IC}|oc={self.OC}|in={self.inH}x{self.inW}"
                f"|flt={self.fltH}x{self.fltW}|pad={self.padH},{self.padW}"
                f"|std={self.stdH},{self.stdW}|dt={dt}"
                f"{self.dilation_suffix()}")

    # -- MM_unit dims (paper §4.1.1) ------------------------------------------
    @property
    def M(self) -> int:  # noqa: N802  (paper symbol)
        return self.OC

    @property
    def N(self) -> int:  # noqa: N802
        return self.B

    @property
    def K(self) -> int:  # noqa: N802
        return self.IC

    @property
    def num_spatial_tasks(self) -> int:
        """Independent MM_unit accumulation chains (= output pixels)."""
        return self.outH * self.outW

    @property
    def taps_h(self) -> int:
        """Filter taps per output pixel along H that touch a *real* input
        element.  Under lhs dilation only every ``dilH``-th tap lands on a
        stored element (the rest read interleaved zeros), so the useful
        reduction depth shrinks by ~``dilH`` (exact when ``dilH == 1``)."""
        return ceil_div(self.fltH, self.dilH)

    @property
    def taps_w(self) -> int:
        return ceil_div(self.fltW, self.dilW)

    @property
    def reduction_len(self) -> int:
        """Useful accumulation depth of one output pixel: IC * real taps."""
        return self.IC * self.taps_h * self.taps_w

    # -- cost terms ------------------------------------------------------------
    @property
    def macs(self) -> int:
        """Useful multiply-accumulates of the whole convolution (dilation
        holes contribute nothing and are not counted)."""
        return self.B * self.OC * self.outH * self.outW * self.reduction_len

    @property
    def flops(self) -> int:
        return 2 * self.macs

    def bytes_in(self) -> int:
        itemsize = dtype_itemsize(self.dtype)
        return itemsize * (
            self.inH * self.inW * self.IC * self.B
            + self.fltH * self.fltW * self.IC * self.OC
        )

    def bytes_out(self) -> int:
        itemsize = dtype_itemsize(self.dtype)
        return itemsize * self.outH * self.outW * self.OC * self.B

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(1, self.bytes_in() + self.bytes_out())

    # -- shapes in the paper's layouts ------------------------------------------
    def in_shape(self) -> Tuple[int, int, int, int]:
        return (self.inH, self.inW, self.IC, self.B)

    def flt_shape(self) -> Tuple[int, int, int, int]:
        return (self.fltH, self.fltW, self.IC, self.OC)

    def out_shape(self) -> Tuple[int, int, int, int]:
        return (self.outH, self.outW, self.OC, self.B)

    def padded_in_shape(self) -> Tuple[int, int, int, int]:
        """Shape of the dense spatially pre-padded input (the non-lhs-dilated
        kernel route; lhs-dilated scenes keep the compact input instead)."""
        return (self.inH + 2 * self.padH + self.apadH,
                self.inW + 2 * self.padW + self.apadW, self.IC, self.B)

    def describe(self) -> str:
        extra = ""
        if self.is_dilated or self.apadH or self.apadW:
            extra = (f" dil={self.dilH},{self.dilW}"
                     f" fdil={self.fdilH},{self.fdilW}"
                     f" apad={self.apadH},{self.apadW}")
        return (
            f"scene(B={self.B} IC={self.IC} OC={self.OC} "
            f"in={self.inH}x{self.inW} flt={self.fltH}x{self.fltW} "
            f"pad={self.padH},{self.padW} std={self.stdH},{self.stdW}{extra} "
            f"MM_unit M={self.M} N={self.N} K={self.K} "
            f"tasks={self.num_spatial_tasks} AI={self.arithmetic_intensity:.1f})"
        )


@dataclasses.dataclass(frozen=True)
class WgradScene(ConvScene):
    """A weight gradient's exec scene whose reduction its plans split
    (``plan.build.grad_filter_scene`` makes one where ``seg_taps`` > 0).
    The fields are ``ConvScene``'s: the type is the mark, so a partition
    (``dataclasses.replace``) keeps it, and every layer (the selector, the
    tuner and its cache, the shard selector, the plans) reads the split
    from the scene."""

    @property
    def seg_taps(self) -> int:
        """``WGRAD_SEGMENT_R`` reduction values rounded down to whole taps
        (at least one), or 0 where one segment holds every tap."""
        per = max(1, WGRAD_SEGMENT_R // self.K)
        return per if self.fltH * self.fltW > per else 0


# The scene's dtype vocabulary: every spelling a caller may pass -> the
# canonical numpy name ``family_key`` prints, and that name -> item size.
# It replaces the reference's ``jnp.dtype`` lookups, so the two packages'
# key strings agree letter for letter without this package importing JAX.
_DTYPE_ALIASES = {
    "float32": "float32", "f4": "float32", "single": "float32",
    "float64": "float64", "f8": "float64", "double": "float64",
    "float": "float64",
    "float16": "float16", "f2": "float16", "half": "float16",
    "bfloat16": "bfloat16",
}
# numpy's byte-order spellings of the same (little-endian or native)
_DTYPE_ALIASES.update({f"{o}f{n}": _DTYPE_ALIASES[f"f{n}"]
                       for o in "<=" for n in (2, 4, 8)})
_ITEMSIZE = {"float32": 4, "float64": 8, "float16": 2, "bfloat16": 2}


def dtype_name(dtype) -> str:
    """Canonical numpy-style name of a scene dtype (``"float32"`` ...).
    Accepts the string spellings above and ``torch.dtype`` objects;
    raises ``ValueError`` on anything else."""
    key = str(dtype).removeprefix("torch.")
    name = _DTYPE_ALIASES.get(key)
    if name is None:
        raise ValueError(f"scene dtype {dtype!r} is not a valid dtype: "
                         f"use one of {sorted(_DTYPE_ALIASES)}")
    return name


def dtype_itemsize(dtype) -> int:
    return _ITEMSIZE[dtype_name(dtype)]


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def pow2_floor(x: int) -> int:
    return 1 if x <= 1 else 2 ** int(math.floor(math.log2(x)))
