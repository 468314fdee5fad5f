"""The client mesh.  Port of ``repro/launch/mesh.py``'s client part
(``make_client_mesh``, ``mesh_chips``).

A :class:`Mesh` is the port's counterpart of ``jax.sharding.Mesh``: a
tuple of devices along one named axis.  The federation runtime cuts
the vectorized backend's stacked client axis along its ``clients`` axis
(``sharding/specs.client_chunks``, ``fed/programs.RoundExecutor``).
Built by functions, never at import, so importing this module touches no
device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """``devices`` along one named axis (the client runtime's meshes are
    1-D)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str] = ("clients",)

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(
            torch.device(d) for d in self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.axis_names) != 1 or not self.devices:
            raise ValueError(f"a mesh is one axis over at least one "
                             f"device, got axes {self.axis_names} over "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}


def make_client_mesh(max_devices: int = 0,
                     device_type: str = "cuda") -> Mesh:
    """1-D mesh with the single axis ``clients`` over this host's CUDA
    devices (``device_type="cpu"``, or no CUDA device: the one CPU).
    ``max_devices`` > 0 caps the mesh size."""
    n = torch.cuda.device_count() if device_type == "cuda" else 0
    if max_devices > 0:
        n = min(n, int(max_devices))
    devs = [torch.device("cuda", i) for i in range(n)] \
        or [torch.device("cpu")]
    return Mesh(tuple(devs), ("clients",))


def mesh_chips(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())
