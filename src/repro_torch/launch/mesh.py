"""Meshes: named axes over devices.  Port of ``repro/launch/mesh.py``
(``make_production_mesh``, ``make_host_mesh``, ``make_client_mesh``,
``mesh_chips``).

A :class:`Mesh` is the port's counterpart of ``jax.sharding.Mesh``: named
axes of given sizes over a row-major tuple of devices.  A mesh with no
devices is *abstract*, as ``jax.sharding.AbstractMesh`` is: names and
sizes only.  The production meshes are abstract (no process here holds
256 devices); the dry run (``launch/dryrun.py``) lays the step's trees
out on them by their specs and counts what each rank holds and sends.
The federation runtime cuts the vectorized backend's stacked client axis
along the 1-D ``clients`` mesh (``sharding/specs.client_chunks``,
``fed/programs.RoundExecutor``).  Built by functions, never at import, so
importing this module touches no device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """``axis_names`` of ``axis_sizes`` over ``devices`` (row-major).
    Without ``axis_sizes`` the mesh is one axis over all of ``devices``;
    with them and no devices it is abstract."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("clients",)
    axis_sizes: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        names = tuple(self.axis_names)
        if self.axis_sizes is None:
            if len(names) != 1 or not devs:
                raise ValueError(f"a mesh without axis sizes is one axis "
                                 f"over at least one device, got axes "
                                 f"{names} over {len(devs)} devices")
            sizes = (len(devs),)
        else:
            sizes = tuple(int(s) for s in self.axis_sizes)
            if (len(sizes) != len(names) or len(set(names)) != len(names)
                    or min(sizes, default=0) < 1):
                raise ValueError(f"axes {names} of sizes {sizes}")
            if devs and len(devs) != math.prod(sizes):
                raise ValueError(f"{len(devs)} devices for a mesh of "
                                 f"{sizes}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) = 256 chips, axes (data, model).  Multi-pod:
    (2, 16, 16) = 512 chips, axes (pod, data, model).  Abstract."""
    if multi_pod:
        return Mesh((), ("pod", "data", "model"), (2, 16, 16))
    return Mesh((), ("data", "model"), (16, 16))


def make_host_mesh(model_parallel: int = 1,
                   device_type: str = "cuda") -> Mesh:
    """(data, model) over this host's CUDA devices (``device_type="cpu"``:
    the one CPU; asking for CUDA where there is none raises),
    ``model_parallel`` of them along ``model`` when it divides their
    count, else 1."""
    if device_type == "cuda":
        resolve_device("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(device_type)]
    mp = model_parallel if len(devs) % model_parallel == 0 else 1
    return Mesh(tuple(devs), ("data", "model"), (len(devs) // mp, mp))


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
