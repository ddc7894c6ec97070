"""Device meshes (port of ``repro.launch.mesh``).

A ``Mesh`` is a descriptor with the reference's interface (``shape`` by
axis name, ``axis_names``, ``devices`` in mesh order, ``size``), so the
sharding rules of ``parallel/sharding.py`` read it as they read a JAX
mesh, and ``data_devices`` gives the device ring of the conv sharding
layer (``repro_torch.shard``: ``ConvServer(mesh=)``, sharded training
triples), which one process drives.  A mesh is laid out over a device
pool: every visible CUDA device by default, one given ``device``, or an
explicit ``devices`` sequence, which may repeat a device (a ring of
``(cuda:0,) * 4`` runs four shards on one card).  Meshes of several
processes for the LM path (``make_production_mesh``) wait for ROADMAP
§1 item 6.  Functions, not module constants: building a mesh resolves a
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over an array of ``torch.device``s (``devices.shape`` is
    the axes' extents, in ``axis_names`` order)."""

    axis_names: Tuple[str, ...]
    devices: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _pool(device: DeviceSpec, devices: Optional[Sequence]
          ) -> Tuple[torch.device, ...]:
    """The devices a mesh is laid out over: ``devices`` as given, else
    ``device`` alone, else every visible CUDA device (raising without a
    card)."""
    if devices is not None:
        if device is not None:
            raise ValueError("pass device or devices, not both")
        pool = tuple(resolve_device(d) for d in devices)
        if not pool:
            raise ValueError("empty device pool")
        return pool
    if device is not None:
        return (resolve_device(device),)
    resolve_device(None)
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def make_mesh_for(n_data: int, n_model: int, device: DeviceSpec = None, *,
                  devices: Optional[Sequence] = None) -> Mesh:
    """("data", "model") mesh over this process's device pool (see
    ``_pool``), the requested extents clamped as the reference clamps
    them (``n_model`` first, then ``n_data`` to what divides the rest):
    one device gives 1x1 whatever is asked, and
    ``make_mesh_for(4, 1, devices=(cuda:0,) * 4)`` a 4x1 ring on one
    card.  The mesh takes the pool's first ``n_data * n_model`` devices in
    row-major order."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh extents must be >= 1, got "
                         f"({n_data}, {n_model})")
    pool = _pool(device, devices)
    avail = len(pool)
    n_model = min(n_model, avail)
    while avail % n_model:
        n_model -= 1
    n_data = min(n_data, avail // n_model)
    while (avail // n_model) % n_data:
        n_data -= 1
    grid = np.empty((n_data, n_model), dtype=object)
    for i, d in enumerate(pool[:n_data * n_model]):
        grid[i // n_model, i % n_model] = d
    return Mesh(("data", "model"), grid)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's (16, 16) or (2, 16, 16) mesh of the LM path: meshes
    of several processes wait for ``torch.distributed`` (ROADMAP §1
    item 6)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    raise NotImplementedError(
        f"a production mesh of {shape} devices waits for torch.distributed "
        f"(ROADMAP §1 item 6); the LM path runs one process on one "
        f"device")


def make_host_mesh(device: DeviceSpec = None) -> Mesh:
    """1x1 mesh on one device (default the card)."""
    return make_mesh_for(1, 1, device)


def data_axes(mesh: Mesh) -> tuple:
    """All data-parallel axes of a mesh ('pod' is an outer DP axis)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def data_devices(mesh: Mesh) -> tuple:
    """The device ring of one model-parallel slice: the devices a
    data-partitioned shard ring (``repro_torch.shard``) runs across, in
    data-axis order."""
    n_model = 1
    for a in mesh.axis_names:
        if a not in ("pod", "data"):
            n_model *= mesh.shape[a]
    flat = mesh.devices.reshape(-1, n_model)
    return tuple(flat[:, 0])
