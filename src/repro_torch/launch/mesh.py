"""Device meshes (port of ``repro.launch.mesh``).

The port runs one process on one device until ``torch.distributed``
lands (ROADMAP §1 item 6).  A ``Mesh`` is a descriptor with the
reference's interface (``shape`` by axis name, ``axis_names``,
``devices`` in mesh order, ``size``), so the sharding rules of
``parallel/sharding.py`` read it as they read a JAX mesh.  Functions, not
module constants: building a mesh resolves a device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

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


def make_mesh_for(n_data: int, n_model: int, device: DeviceSpec = None
                  ) -> Mesh:
    """("data", "model") mesh sized for this process's devices, the
    requested extents clamped as the reference clamps them (``n_model``
    first, then ``n_data`` to what divides the rest): one device gives
    1x1 whatever is asked.  ``device`` defaults to the card."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh extents must be >= 1, got "
                         f"({n_data}, {n_model})")
    avail = 1           # one device per process until torch.distributed
    n_model = min(n_model, avail)
    while avail % n_model:
        n_model -= 1
    n_data = min(n_data, avail // n_model)
    while (avail // n_model) % n_data:
        n_data -= 1
    devices = np.empty((n_data, n_model), dtype=object)
    devices[0, 0] = resolve_device(device)
    return Mesh(("data", "model"), devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's (16, 16) or (2, 16, 16) mesh: several devices, which
    wait for ``torch.distributed`` (ROADMAP §1 item 6)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    raise NotImplementedError(
        f"a production mesh of {shape} devices waits for torch.distributed "
        f"(ROADMAP §1 item 6); this port drives one device")


def make_host_mesh(device: DeviceSpec = None) -> Mesh:
    """1x1 mesh on one device (default the card)."""
    return make_mesh_for(1, 1, device)


def data_axes(mesh: Mesh) -> tuple:
    """All data-parallel axes of a mesh ('pod' is an outer DP axis)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def data_devices(mesh: Mesh) -> tuple:
    """The devices of one model-parallel slice, in data-axis order."""
    n_model = 1
    for a in mesh.axis_names:
        if a not in ("pod", "data"):
            n_model *= mesh.shape[a]
    flat = mesh.devices.reshape(-1, n_model)
    return tuple(flat[:, 0])
