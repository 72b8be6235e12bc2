"""Named device grids (the port of ``repro.launch.mesh``).

A ``Mesh`` is axis names, a shape and the devices it lays over them, row
major. ``make_host_mesh`` lays one over the devices the caller names (the
card's devices by default, never the CPU on its own);
``make_production_mesh`` is the reference's production shape with no
devices, which the sharding rules and the dry run read (they read only
``axis_names`` and ``shape``). ``models.placement`` places tensors over a
mesh's devices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} vs {self.sizes}")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shape: (data 16, model 16), or (pod 2,
    data 16, model 16); no devices."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model: Optional[int] = None, data: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (every CUDA device by default;
    refused without one: name ``["cpu"]`` to run on the CPU). ``model``
    defaults to the largest of 8, 4, 2 that divides the device count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=['cpu'] to lay the mesh over the "
                               "CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if model is None:
        model = next((m for m in (8, 4, 2) if n % m == 0 and n >= m), 1)
    data = data or (n // model)
    return Mesh(("data", "model"), (data, model), devices)


def batch_axes(mesh: Mesh) -> tuple:
    """Mesh axes that carry pure data parallelism."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_axes(mesh: Mesh) -> tuple:
    """The data-parallel axes the mesh has, of ("pod", "data")."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
