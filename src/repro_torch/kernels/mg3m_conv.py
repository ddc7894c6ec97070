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

from repro_torch.analysis.footprint import (KERNEL_BM, tile_threads,
                                            vmem_bytes)
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

    @property
    def bc(self) -> int:
        """Columns of a block tile."""
        return self.tile[1]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def launch_spec(scene: ConvScene, schedule: str, *, in_shape: Shape4,
                flt_shape: Shape4, bm: int = 0, bn: int = 0, bk: int = 0,
                tile: Tuple[int, ...] = (),
                smem_budget: int = 0) -> LaunchSpec:
    """Validate a launch of ``schedule`` over ``scene`` with operands of
    the given shapes: the input K must match the filter's, the spatial
    extents must be what the route expects, the blocking must divide the
    launched dims, ``tile`` must be a compiled tile of the grain for
    ``bm``, and — when ``smem_budget`` > 0 — the block's shared-memory
    footprint must fit it.  Raises ``ValueError``."""
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
    tile = tuple(tile)
    smem = vmem_bytes(scene, schedule, bm, bn, bk, tile)
    if smem_budget > 0:
        _require(smem <= smem_budget,
                 f"{schedule} blocking ({bm}, {bn}, {bk}) needs {smem} B of "
                 f"shared memory (budget {smem_budget} B) for "
                 f"{scene.describe()}")
    return LaunchSpec(schedule, scene, in_shape, flt_shape,
                      (scene.outH, scene.outW, m, n), bm, bn, bk, smem, tile)


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


def conv_plain(inp: torch.Tensor, flt: torch.Tensor,
               scene: ConvScene) -> torch.Tensor:
    """The kernels' function in plain PyTorch: for each filter tap, gather
    the input window through the same index map (masked taps read zero)
    and accumulate ``FLT[tap]^T . IN[window]`` in f32; cast on return.
    Operands as launched (see the module docstring).

    The contraction is spelled out as one multiply and one add per (tap,
    k), in the kernels' order (tap-major, then k ascending), instead of a
    matrix product whose summation order would depend on the batch width:
    so, like the kernels, each output column is bitwise independent of
    the batch it is served in."""
    pad_h, pad_w, dil_h, dil_w = _index_params(scene)
    hl, wl = inp.shape[0], inp.shape[1]
    fh, fw, _, m = flt.shape
    dev = inp.device
    ih, ok_h = _tap_coords(scene.outH, fh, scene.stdH, scene.fdilH, pad_h,
                           dil_h, hl, dev)
    iw, ok_w = _tap_coords(scene.outW, fw, scene.stdW, scene.fdilW, pad_w,
                           dil_w, wl, dev)
    x = inp.float()
    f = flt.float()
    acc = torch.zeros(scene.outH, scene.outW, m, inp.shape[3],
                      dtype=torch.float32, device=dev)
    for i in range(fh):
        rows = x[ih[:, i]]                                # [outH, Wl, K, N]
        for j in range(fw):
            win = rows[:, iw[:, j]]                       # [outH, outW, K, N]
            mask = (ok_h[:, i, None] & ok_w[None, :, j]).to(torch.float32)
            win = win * mask[:, :, None, None]
            for k in range(f.shape[2]):
                acc += f[i, j, k][None, None, :, None] * win[:, :, k, None, :]
    return acc.to(inp.dtype)


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------
class _Geom(ctypes.Structure):
    """Mirror of ``struct Geom`` in csrc/mg3m_conv.cu."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "Hl", "Wl", "K", "N", "M", "outH", "outW", "fh", "fw", "stdH",
        "stdW", "fdilH", "fdilW", "padH", "padW", "dilH", "dilW", "bm", "bk",
        "grid", "bc", "tm", "tc", "tbm")]


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (builds on
    first call; see ``kernels.cuda_build``)."""
    lib = cuda_build.load(SOURCE)
    for name in ("mg3m_tb11", "mg3m_tb18", "mg3m_tb88"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.POINTER(_Geom),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
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
    tile.  TB88: a block per (column tile, m-tile).  TB11/TB18
    (persistent): grid x blocks walk their work ``x, x + grid x, ...``:
    as few items per block as the card's resident slots allow at the
    footprint's occupancy, spread over as few blocks as that takes.  A
    TB18 item is a column tile, with one grid row per OC slice; a TB11
    item is a (column tile, m-tile) pair, item ``w`` being column tile
    ``w // n_m``, m-tile ``w % n_m`` of the tile's BM."""
    cols = spec.out_shape[0] * spec.out_shape[1] * spec.out_shape[3]
    m = spec.out_shape[2]
    bc, threads = spec.bc, tile_threads(spec.tile)
    n_ct = ceil_div(cols, bc)
    if spec.schedule == "TB88":
        return n_ct, m // spec.bm, bc, threads
    _, smem_sm, sms = device_limits(device)
    slots = sms * max(1, blocks_per_sm(spec.smem, threads, smem_sm))
    if spec.schedule == "TB11":
        items, rows = n_ct * ceil_div(m, spec.tile[0]), 1
    else:
        items, rows = n_ct, m // spec.bm
    per_block = ceil_div(items, max(1, slots // rows))
    return ceil_div(items, per_block), rows, bc, threads


def launch_geom(spec: LaunchSpec, device=None) -> _Geom:
    """The ``Geom`` a launch of ``spec`` on ``device`` passes the kernel
    (``csrc/mg3m_conv.cu``): the launched extents, the index map's
    stride, dilation and padding (zero padding and unit lhs dilation on
    the dense route, where the input arrives pre-padded), the blocking,
    the persistent grid of ``launch_grid`` and the compiled tile."""
    sc = spec.scene
    pad_h, pad_w, dil_h, dil_w = _index_params(sc)
    hl, wl, k, n = spec.in_shape
    return _Geom(hl, wl, k, n, spec.flt_shape[3], sc.outH, sc.outW,
                 sc.fltH, sc.fltW, sc.stdH, sc.stdW, sc.fdilH, sc.fdilW,
                 pad_h, pad_w, dil_h, dil_w, spec.bm, spec.bk,
                 launch_grid(spec, device)[0], *spec.tile[1:],
                 spec.tile[0])


def geom_fields(geom: _Geom) -> Dict[str, int]:
    """A ``Geom``'s fields by name."""
    return {name: getattr(geom, name) for name, _ in _Geom._fields_}


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
    out = torch.empty(spec.out_shape, dtype=inp.dtype, device=inp.device)
    lib = library()
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        rc = getattr(lib, fn_name)(_DTYPE_CODE[inp.dtype], inp.data_ptr(),
                                   flt.data_ptr(), out.data_ptr(),
                                   ctypes.byref(geom), stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed for {sc.describe()}: "
                           f"{lib.mg3m_error_string(rc).decode()} ({rc})")
    return out


def conv_tb11(inp: torch.Tensor, flt: torch.Tensor, scene: ConvScene, *,
              tile: Tuple[int, ...]) -> torch.Tensor:
    """TB11 over launched operands (see module doc) on compiled ``tile``;
    returns ``[outH, outW, M, N]``."""
    spec = launch_spec(scene, "TB11", in_shape=inp.shape,
                       flt_shape=flt.shape, tile=tile,
                       smem_budget=smem_budget(inp.device))
    if inp.device.type == "cpu":
        return conv_plain(inp, flt, scene)
    out = _launch("mg3m_tb11", spec, inp, flt)
    conv_tb11.launches += 1
    return out


def conv_tb18(inp: torch.Tensor, flt: torch.Tensor, scene: ConvScene, *,
              bm: int, tile: Tuple[int, ...]) -> torch.Tensor:
    spec = launch_spec(scene, "TB18", in_shape=inp.shape,
                       flt_shape=flt.shape, bm=bm, tile=tile,
                       smem_budget=smem_budget(inp.device))
    if inp.device.type == "cpu":
        return conv_plain(inp, flt, scene)
    out = _launch("mg3m_tb18", spec, inp, flt)
    conv_tb18.launches += 1
    return out


def conv_tb88(inp: torch.Tensor, flt: torch.Tensor, scene: ConvScene, *,
              bm: int, bn: int, bk: int,
              tile: Tuple[int, ...]) -> torch.Tensor:
    spec = launch_spec(scene, "TB88", in_shape=inp.shape,
                       flt_shape=flt.shape, bm=bm, bn=bn, bk=bk, tile=tile,
                       smem_budget=smem_budget(inp.device))
    if inp.device.type == "cpu":
        return conv_plain(inp, flt, scene)
    out = _launch("mg3m_tb88", spec, inp, flt)
    conv_tb88.launches += 1
    return out


conv_tb11.launches = 0
conv_tb18.launches = 0
conv_tb88.launches = 0
WRAPPERS = {"TB11": conv_tb11, "TB18": conv_tb18, "TB88": conv_tb88}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per grain since the last ``reset_launch_counts``."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
