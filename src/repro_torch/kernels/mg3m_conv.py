"""MG3M conv kernels for Hopper — wrappers, launch geometry, plain versions.

Port of ``repro.kernels.mg3m_conv``.  The three grains are CUDA kernels in
``csrc/mg3m_conv.cu`` (built by ``kernels.cuda_build`` at first use):

  ``conv_tb11``  replaces ``conv_tb11`` (mg3m_conv.py:288): whole filter
                 resident in shared memory, persistent blocks over (column
                 tile, m-tile) work items.
  ``conv_tb18``  replaces ``conv_tb18`` (:320): an OC slice ``bm`` wide
                 resident per block, blocks over (slice, column strip).
  ``conv_tb88``  replaces ``conv_tb88`` (:352): tiled GEMM, blocks over
                 (column tile, m-tile ``bm``), filter and input streamed
                 per chunk of the flattened reduction (tap, k).

Each runs on the compiled tile ``(BM, BC, TM, TC)`` the selector chose
(``BM x BC`` outputs per block, ``TM x TC`` per thread;
``footprint.TB11_SHAPES`` / ``TB18_SHAPES`` / ``TB88_SHAPES``).

A wgrad exec scene's long reduction is split (``seg_taps``, from
``core.scene.WgradScene.seg_taps``): TB11 and TB88 then walk each segment
of whole taps in blocks of their own, writing f32 partials into a
workspace ``[S, outH, outW, M, N]``, and ``segment_sum``
(``mg3m_segsum_kernel``, which replaces no TPU kernel: the Pallas grid
walks its reduction in order on one core) adds them in segment order
and casts.  TB18 takes no split.

A column is one (output pixel, batch) pair, so at batch 1 a block still
has a full tile of work.  Each wrapper checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, raises
if the launch failed, and counts its launches in ``<wrapper>.launches``.
On a CPU tensor a wrapper runs ``conv_plain`` instead; a CUDA tensor
launches the kernel or raises — there is no fallback.

Input layout, as in the reference, depends on the scene's lhs dilation:

  dilH == dilW == 1   the spatially pre-padded input ``[inHp, inWp, K, N]``;
  dilH or dilW > 1    the compact input ``[inH, inW, K, N]``.  The
                      reference appends an all-zero sentinel row/column
                      that hole and out-of-range taps read; here those taps
                      are masked loads of zero, so no sentinel is appended.

Filter ``[fltH, fltW, K, M]``, output ``[outH, outW, M, N]``; M=OC, N=B,
K=IC; f32 accumulation, cast to the IO dtype on store.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch.analysis.footprint import (KERNEL_BM, segment_taps,
                                            tile_threads, vmem_bytes)
from repro_torch.core.mapping import (blocks_per_sm, device_limits,
                                      smem_budget)
from repro_torch.core.scene import ConvScene, ceil_div
from repro_torch.kernels import cuda_build

Shape4 = Tuple[int, int, int, int]
SOURCE = "mg3m_conv.cu"


def is_dense(scene: ConvScene) -> bool:
    """True on the dense route (no lhs dilation: pre-padded input)."""
    return scene.dilH == 1 and scene.dilW == 1


def launched_in_hw(scene: ConvScene) -> Tuple[int, int]:
    """Spatial extent of the input as the kernels take it: pre-padded on
    the dense route, compact (no sentinel) on the lhs-dilated one."""
    if is_dense(scene):
        return (scene.inH + 2 * scene.padH + scene.apadH,
                scene.inW + 2 * scene.padW + scene.apadW)
    return scene.inH, scene.inW


def _index_params(scene: ConvScene) -> Tuple[int, int, int, int]:
    """(padH, padW, dilH, dilW) the index map translates through: zero
    padding and unit dilation on the dense route (already applied)."""
    if is_dense(scene):
        return 0, 0, 1, 1
    return scene.padH, scene.padW, scene.dilH, scene.dilW


# --------------------------------------------------------------------------
# launch geometry
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """Checked launch geometry of one schedule over one scene (the port's
    ``KernelGridSpec``): operand shapes exactly as launched, the blocking,
    the compiled tile ``(BM, BC, TM, TC)`` and the block's shared-memory
    footprint on it."""

    schedule: str
    scene: ConvScene
    in_shape: Shape4
    flt_shape: Shape4
    out_shape: Shape4
    bm: int
    bn: int
    bk: int
    smem: int
    tile: Tuple[int, ...] = ()
    seg_taps: int = 0      # taps per reduction segment, 0 = not split

    @property
    def bc(self) -> int:
        """Columns of a block tile."""
        return self.tile[1]

    @property
    def segments(self) -> int:
        """Reduction segments S, each walked by blocks of its own."""
        return len(segment_taps(self.scene.fltH * self.scene.fltW,
                                self.seg_taps))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def launch_spec(scene: ConvScene, schedule: str, *, in_shape: Shape4,
                flt_shape: Shape4, bm: int = 0, bn: int = 0, bk: int = 0,
                tile: Tuple[int, ...] = (), smem_budget: int = 0,
                seg_taps: int = 0) -> LaunchSpec:
    """Validate a launch of ``schedule`` over ``scene`` with operands of
    the given shapes: the input K must match the filter's, the spatial
    extents must be what the route expects, the blocking must divide the
    launched dims, ``tile`` must be a compiled tile of the grain for
    ``bm``, a split reduction (every ``seg_taps`` taps; kept only where
    it makes two segments or more) must not be TB18's, and — when
    ``smem_budget`` > 0 — the block's shared-memory footprint must fit
    it.  Raises ``ValueError``."""
    in_shape, flt_shape = tuple(in_shape), tuple(flt_shape)
    _require(len(in_shape) == 4 and len(flt_shape) == 4,
             f"operands must be 4-D, got {in_shape} and {flt_shape}")
    fh, fw, k, m = flt_shape
    n = in_shape[3]
    _require(in_shape[2] == k,
             f"input K dim {in_shape[2]} != filter K dim {k} for "
             f"{scene.describe()}")
    _require((fh, fw) == (scene.fltH, scene.fltW),
             f"filter taps {fh}x{fw} != scene {scene.fltH}x{scene.fltW}")
    _require(tuple(in_shape[:2]) == launched_in_hw(scene),
             f"input spatial extent {in_shape[:2]} != "
             f"{launched_in_hw(scene)} expected for {scene.describe()}")
    if schedule == "TB11":
        bm, bn, bk = m, n, k
    elif schedule == "TB18":
        _require(0 < bm <= KERNEL_BM[-1] and m % bm == 0,
                 f"TB18 OC slice bm={bm} must divide the launched OC dim "
                 f"{m} and be at most {KERNEL_BM[-1]} for "
                 f"{scene.describe()}")
        bn, bk = n, k
    elif schedule == "TB88":
        _require(0 < bm <= KERNEL_BM[-1] and 0 < bn and 0 < bk
                 and m % bm == 0 and n % bn == 0 and k % bk == 0,
                 f"TB88 blocking ({bm}/{bn}/{bk}) must divide the launched "
                 f"(M={m}, N={n}, K={k}) dims, with bm <= "
                 f"{KERNEL_BM[-1]}, for {scene.describe()}")
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    _require(seg_taps >= 0, f"seg_taps must be >= 0, got {seg_taps}")
    if len(segment_taps(fh * fw, seg_taps)) == 1:
        seg_taps = 0
    _require(not seg_taps or schedule != "TB18",
             f"TB18 takes no split reduction (seg_taps={seg_taps}) for "
             f"{scene.describe()}")
    tile = tuple(tile)
    smem = vmem_bytes(scene, schedule, bm, bn, bk, tile, seg_taps)
    if smem_budget > 0:
        _require(smem <= smem_budget,
                 f"{schedule} blocking ({bm}, {bn}, {bk}) needs {smem} B of "
                 f"shared memory (budget {smem_budget} B) for "
                 f"{scene.describe()}")
    return LaunchSpec(schedule, scene, in_shape, flt_shape,
                      (scene.outH, scene.outW, m, n), bm, bn, bk, smem, tile,
                      seg_taps)


# --------------------------------------------------------------------------
# plain PyTorch version (all three grains compute this function)
# --------------------------------------------------------------------------
def _tap_coords(n_out: int, taps: int, stride: int, fdil: int, pad: int,
                dil: int, extent: int, device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """The index map along one axis: (input index, valid) per (output
    coordinate, tap); invalid entries hold index 0."""
    o = torch.arange(n_out, device=device)[:, None]
    t = torch.arange(taps, device=device)[None, :]
    q = o * stride + t * fdil - pad
    ok = (q >= 0) & (q % dil == 0) & (q < extent * dil)
    return torch.where(ok, q // dil, 0), ok


def segment_sum_plain(parts, dtype: torch.dtype) -> torch.Tensor:
    """``segment_sum``'s plain version: ``parts[0] + parts[1] + ... +
    parts[S - 1]``, one f32 add each in that order, cast to ``dtype``."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out.to(dtype)


def conv_plain(inp: torch.Tensor, flt: torch.Tensor, scene: ConvScene,
               seg_taps: int = 0) -> torch.Tensor:
    """The kernels' function in plain PyTorch: for each filter tap, gather
    the input window through the same index map (masked taps read zero)
    and accumulate ``FLT[tap]^T . IN[window]`` in f32; cast on return.
    Operands as launched (see the module docstring).

    The contraction is spelled out as one multiply and one add per (tap,
    k), in the kernels' order (tap-major, then k ascending), instead of a
    matrix product whose summation order would depend on the batch width:
    so, like the kernels, each output column is bitwise independent of
    the batch it is served in.  A reduction split every ``seg_taps`` taps
    is summed as the split kernels sum it: each segment from zero in that
    order, then the segments' partials in segment order
    (``segment_sum_plain``)."""
    pad_h, pad_w, dil_h, dil_w = _index_params(scene)
    hl, wl = inp.shape[0], inp.shape[1]
    fh, fw, _, m = flt.shape
    dev = inp.device
    ih, ok_h = _tap_coords(scene.outH, fh, scene.stdH, scene.fdilH, pad_h,
                           dil_h, hl, dev)
    iw, ok_w = _tap_coords(scene.outW, fw, scene.stdW, scene.fdilW, pad_w,
                           dil_w, wl, dev)
    x = inp.float()
    f = flt.float().reshape(fh * fw, flt.shape[2], m)
    segs = segment_taps(fh * fw, seg_taps)
    # the segments side by side: step t adds tap s * len + t of every
    # segment s still that long, each in its own accumulator
    acc = torch.zeros(len(segs), scene.outH, scene.outW, m, inp.shape[3],
                      dtype=torch.float32, device=dev)
    first = torch.arange(len(segs), device=dev) * segs[0]
    for t in range(segs[0]):
        n = len(segs) if t < segs[-1] else len(segs) - 1
        tap = first[:n] + t
        i, j = tap // fw, tap % fw
        hh, ww = ih[:, i].T[:, :, None], iw[:, j].T[:, None, :]
        win = x[hh, ww]                              # [n, outH, outW, K, N]
        mask = (ok_h[:, i].T[:, :, None]
                & ok_w[:, j].T[:, None, :]).to(torch.float32)
        win = win * mask[..., None, None]
        for k in range(f.shape[1]):
            acc[:n] += f[tap, k][:, None, None, :, None] \
                * win[:, :, :, k, None, :]
    return segment_sum_plain(acc, inp.dtype)


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------
class _Geom(ctypes.Structure):
    """Mirror of ``struct Geom`` in csrc/mg3m_conv.cu."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "Hl", "Wl", "K", "N", "M", "outH", "outW", "fh", "fw", "stdH",
        "stdW", "fdilH", "fdilW", "padH", "padW", "dilH", "dilW", "bm", "bk",
        "grid", "bc", "tm", "tc", "tbm", "nseg", "seg_taps")]


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (builds on
    first call; see ``kernels.cuda_build``)."""
    lib = cuda_build.load(SOURCE)
    for name in ("mg3m_tb11", "mg3m_tb18", "mg3m_tb88"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(_Geom), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mg3m_segsum.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_void_p]
    lib.mg3m_segsum.restype = ctypes.c_int
    lib.mg3m_error_string.argtypes = [ctypes.c_int]
    lib.mg3m_error_string.restype = ctypes.c_char_p
    lib.mg3m_in_coord_table.argtypes = [ctypes.POINTER(_Geom), ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p]
    lib.mg3m_in_coord_table.restype = ctypes.c_int
    lib.mg3m_tile_attributes.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.mg3m_tile_attributes.restype = ctypes.c_int
    return lib


# --------------------------------------------------------------------------
# hooks for the verifier: the device's own index map and compiled tiles
# --------------------------------------------------------------------------
GRAIN_CODE = {"TB11": 0, "TB18": 1, "TB88": 2}
TILE_ATTRIBUTES = ("registers", "max_threads", "max_dynamic_smem",
                   "blocks_per_sm", "local_bytes")


def in_coord_table(geom: _Geom, axis: str, device=None) -> torch.Tensor:
    """The device's ``in_coord`` (``csrc/mg3m_conv.cu``) evaluated for
    every (output coordinate, tap) of one axis (``"h"`` or ``"w"``) of
    ``geom``, on ``device`` (default the current card): an int32
    ``[out, taps]`` CPU tensor, -1 where the tap is masked."""
    n_out, taps = ((geom.outH, geom.fh) if axis == "h"
                   else (geom.outW, geom.fw))
    dev = torch.device("cuda" if device is None else device)
    out = torch.empty((n_out, taps), dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mg3m_in_coord_table(ctypes.byref(geom),
                                     0 if axis == "h" else 1,
                                     out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mg3m_in_coord_table failed: "
                           f"{lib.mg3m_error_string(rc).decode()} ({rc})")
    return out.cpu()


def tile_attributes(schedule: str, tile: Tuple[int, ...], dtype: str,
                    smem: int) -> Dict[str, int]:
    """What the card reports for one compiled tile instance: registers
    per thread, the most threads a block may have, the most dynamic
    shared memory it may opt into, the blocks an SM holds at ``smem``
    bytes of dynamic shared memory (``cudaOccupancyMaxActiveBlocks
    PerMultiprocessor``) and its local (spill) bytes per thread."""
    tile_c = (ctypes.c_int * 4)(*tile)
    out = (ctypes.c_int * len(TILE_ATTRIBUTES))()
    lib = library()
    rc = lib.mg3m_tile_attributes(GRAIN_CODE[schedule], tile_c,
                                  0 if dtype == "float32" else 1, smem, out)
    if rc != 0:
        raise RuntimeError(f"mg3m_tile_attributes({schedule}, {tile}, "
                           f"{dtype}) failed: "
                           f"{lib.mg3m_error_string(rc).decode()} ({rc})")
    return dict(zip(TILE_ATTRIBUTES, out))


def launch_grid(spec: LaunchSpec, device=None) -> Tuple[int, int, int, int]:
    """``(grid x, grid y, column tile, threads)`` of a launch on ``device``
    (the datasheet's card when None or a CPU), all read from the spec's
    tile.  TB88: a block per (column tile, m-tile), and a grid z of
    ``spec.segments`` (one per reduction segment).  TB11/TB18
    (persistent): grid x blocks walk their work ``x, x + grid x, ...``:
    as few items per block as the card's resident slots allow at the
    footprint's occupancy, spread over as few blocks as that takes.  A
    TB18 item is a column tile, with one grid row per OC slice; a TB11
    item is a (segment, column tile, m-tile) triple, item ``w`` being
    segment ``w // (n_ct * n_m)`` and, of ``v = w % (n_ct * n_m)``,
    column tile ``v // n_m``, m-tile ``v % n_m`` of the tile's BM."""
    cols = spec.out_shape[0] * spec.out_shape[1] * spec.out_shape[3]
    m = spec.out_shape[2]
    bc, threads = spec.bc, tile_threads(spec.tile)
    n_ct = ceil_div(cols, bc)
    if spec.schedule == "TB88":
        return n_ct, m // spec.bm, bc, threads
    _, smem_sm, sms = device_limits(device)
    slots = sms * max(1, blocks_per_sm(spec.smem, threads, smem_sm))
    if spec.schedule == "TB11":
        items, rows = n_ct * ceil_div(m, spec.tile[0]) * spec.segments, 1
    else:
        items, rows = n_ct, m // spec.bm
    per_block = ceil_div(items, max(1, slots // rows))
    return ceil_div(items, per_block), rows, bc, threads


def launch_geom(spec: LaunchSpec, device=None) -> _Geom:
    """The ``Geom`` a launch of ``spec`` on ``device`` passes the kernel
    (``csrc/mg3m_conv.cu``): the launched extents, the index map's
    stride, dilation and padding (zero padding and unit lhs dilation on
    the dense route, where the input arrives pre-padded), the blocking,
    the persistent grid of ``launch_grid``, the compiled tile and the
    reduction's segments (count, taps each)."""
    sc = spec.scene
    pad_h, pad_w, dil_h, dil_w = _index_params(sc)
    hl, wl, k, n = spec.in_shape
    return _Geom(hl, wl, k, n, spec.flt_shape[3], sc.outH, sc.outW,
                 sc.fltH, sc.fltW, sc.stdH, sc.stdW, sc.fdilH, sc.fdilW,
                 pad_h, pad_w, dil_h, dil_w, spec.bm, spec.bk,
                 launch_grid(spec, device)[0], *spec.tile[1:],
                 spec.tile[0], spec.segments, spec.seg_taps)


def geom_fields(geom: _Geom) -> Dict[str, int]:
    """A ``Geom``'s fields by name."""
    return {name: getattr(geom, name) for name, _ in _Geom._fields_}


# Split reductions' f32 partials, one buffer per (device, stream, shape),
# kept for the life of the process (``release_workspaces`` frees some): a
# plan's execute allocates none, a CUDA graph that captured a launch keeps
# a buffer that stays valid, and two streams never share partials.
_WORKSPACES: Dict[Tuple, torch.Tensor] = {}


def workspace(device: torch.device, shape: Tuple[int, ...]) -> torch.Tensor:
    """The f32 partials buffer of ``shape`` on ``device`` for its current
    stream (made once, on that stream)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream,
           tuple(shape))
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = torch.empty(shape, dtype=torch.float32,
                                            device=device)
    return ws


def workspace_keys() -> Tuple[Tuple, ...]:
    """The (device, stream, shape) keys of the buffers held now."""
    return tuple(_WORKSPACES)


def release_workspaces(keep: Tuple[Tuple, ...] = ()) -> None:
    """Free every partials buffer whose key is not in ``keep`` (tuning
    drops its candidates' so; a plan whose launch a CUDA graph captured
    needs its buffer kept)."""
    for key in [k for k in _WORKSPACES if k not in keep]:
        del _WORKSPACES[key]


def segment_sum(parts: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The second pass of a split reduction: ``parts`` ``[S, ...]`` f32
    added in the order ``s = 0, 1, ..., S - 1`` (one f32 add each, no
    atomics: the order never depends on which block finishes first),
    cast to ``dtype`` (float32 or bfloat16).  A CPU tensor runs
    ``segment_sum_plain``; a CUDA tensor launches ``mg3m_segsum_kernel``
    (``csrc/mg3m_conv.cu``; bound by bytes: every partial read once) or
    raises."""
    _require(parts.dtype == torch.float32 and parts.dim() >= 2
             and parts.is_contiguous(),
             f"segment_sum: partials must be contiguous f32 [S, ...], got "
             f"{parts.dtype} {tuple(parts.shape)}")
    _require(dtype in _DTYPE_CODE,
             f"segment_sum: output must be float32 or bfloat16, not {dtype}")
    if parts.device.type == "cpu":
        return segment_sum_plain(parts, dtype)
    _require(parts.is_cuda, f"segment_sum: partials on {parts.device}")
    out = torch.empty(parts.shape[1:], dtype=dtype, device=parts.device)
    lib = library()
    with torch.cuda.device(parts.device):
        stream = torch.cuda.current_stream(parts.device).cuda_stream
        rc = lib.mg3m_segsum(_DTYPE_CODE[dtype], parts.data_ptr(),
                             out.data_ptr(), parts.shape[0], out.numel(),
                             stream)
    if rc != 0:
        raise RuntimeError(f"mg3m_segsum launch failed for partials "
                           f"{tuple(parts.shape)}: "
                           f"{lib.mg3m_error_string(rc).decode()} ({rc})")
    segment_sum.launches += 1
    return out


def _launch(fn_name: str, spec: LaunchSpec, inp: torch.Tensor,
            flt: torch.Tensor) -> torch.Tensor:
    _require(inp.is_cuda and flt.device == inp.device,
             f"{fn_name}: operands must be on one CUDA device, got "
             f"{inp.device} and {flt.device}")
    _require(inp.dtype == flt.dtype and inp.dtype in _DTYPE_CODE,
             f"{fn_name}: operands must both be float32 or bfloat16, got "
             f"{inp.dtype} and {flt.dtype}")
    _require(inp.is_contiguous() and flt.is_contiguous(),
             f"{fn_name}: operands must be contiguous")
    sc = spec.scene
    geom = launch_geom(spec, inp.device)
    if spec.segments > 1:
        out = None
        ws = workspace(inp.device, (spec.segments,) + spec.out_shape)
    else:
        out = torch.empty(spec.out_shape, dtype=inp.dtype,
                          device=inp.device)
        ws = None
    lib = library()
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        rc = getattr(lib, fn_name)(
            _DTYPE_CODE[inp.dtype], inp.data_ptr(), flt.data_ptr(),
            None if out is None else out.data_ptr(),
            None if ws is None else ws.data_ptr(), ctypes.byref(geom),
            stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed for {sc.describe()}: "
                           f"{lib.mg3m_error_string(rc).decode()} ({rc})")
    return out, ws


def _finish(out, ws, dtype: torch.dtype) -> torch.Tensor:
    """A launch's output: as stored, or its partials' ``segment_sum``."""
    return out if ws is None else segment_sum(ws, dtype)


def conv_tb11(inp: torch.Tensor, flt: torch.Tensor, scene: ConvScene, *,
              tile: Tuple[int, ...], seg_taps: int = 0) -> torch.Tensor:
    """TB11 over launched operands (see module doc) on compiled ``tile``,
    the reduction split every ``seg_taps`` taps (0: not split); returns
    ``[outH, outW, M, N]``."""
    spec = launch_spec(scene, "TB11", in_shape=inp.shape,
                       flt_shape=flt.shape, tile=tile,
                       smem_budget=smem_budget(inp.device),
                       seg_taps=seg_taps)
    if inp.device.type == "cpu":
        return conv_plain(inp, flt, scene, spec.seg_taps)
    out, ws = _launch("mg3m_tb11", spec, inp, flt)
    conv_tb11.launches += 1
    return _finish(out, ws, inp.dtype)


def conv_tb18(inp: torch.Tensor, flt: torch.Tensor, scene: ConvScene, *,
              bm: int, tile: Tuple[int, ...]) -> torch.Tensor:
    spec = launch_spec(scene, "TB18", in_shape=inp.shape,
                       flt_shape=flt.shape, bm=bm, tile=tile,
                       smem_budget=smem_budget(inp.device))
    if inp.device.type == "cpu":
        return conv_plain(inp, flt, scene)
    out, _ = _launch("mg3m_tb18", spec, inp, flt)
    conv_tb18.launches += 1
    return out


def conv_tb88(inp: torch.Tensor, flt: torch.Tensor, scene: ConvScene, *,
              bm: int, bn: int, bk: int, tile: Tuple[int, ...],
              seg_taps: int = 0) -> torch.Tensor:
    spec = launch_spec(scene, "TB88", in_shape=inp.shape,
                       flt_shape=flt.shape, bm=bm, bn=bn, bk=bk, tile=tile,
                       smem_budget=smem_budget(inp.device),
                       seg_taps=seg_taps)
    if inp.device.type == "cpu":
        return conv_plain(inp, flt, scene, spec.seg_taps)
    out, ws = _launch("mg3m_tb88", spec, inp, flt)
    conv_tb88.launches += 1
    return _finish(out, ws, inp.dtype)


conv_tb11.launches = 0
conv_tb18.launches = 0
conv_tb88.launches = 0
segment_sum.launches = 0
WRAPPERS = {"TB11": conv_tb11, "TB18": conv_tb18, "TB88": conv_tb88}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per grain since the last ``reset_launch_counts``
    (``segment_sum.launches`` counts the second pass)."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    segment_sum.launches = 0
