"""Device and client models (paper §3.2).

Each FL *client* owns a pool of SL *devices*. A device is characterised by
  Time_Factor     seconds to train one unit of model compute (lower = faster)
  Client_Capacity memory slots: how many model portions it can hold

``efficiency`` (paper §4, Sort_By_Time selection) combines both:
    efficiency = capacity / time_factor
i.e. trainable portions per unit time — a device with plenty of memory but a
slow processor (the paper's "old device without AVX/GPU") scores low.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass(frozen=True)
class Device:
    device_id: str
    time_factor: float          # sec per compute unit (paper: Time_Factor)
    capacity: int               # portions it can store (paper: Client_Capacity)

    @property
    def efficiency(self) -> float:
        return self.capacity / max(self.time_factor, 1e-9)


@dataclass
class Client:
    client_id: str
    devices: List[Device]
    num_examples: int = 6144    # paper: 24 batches x 256 per epoch

    def total_capacity(self) -> int:
        return sum(d.capacity for d in self.devices)


# ---------------------------------------------------------------------------
# heterogeneity presets
# ---------------------------------------------------------------------------

def paper_pool(num_clients: int = 5, devices_per_client: int = 4,
               seed: int = 0) -> List[Client]:
    """The paper's simulated environment: 5 clients x 4 devices with mixed
    speeds/memories, *including* slow-but-roomy old devices (the case that
    makes ``random_multi`` the worst strategy in Fig 2).
    """
    rng = np.random.default_rng(seed)
    # archetypes: (time_factor, capacity)
    archetypes = [
        (0.4, 2),    # modern phone: fast, modest memory
        (1.0, 2),    # mid-range
        (2.5, 4),    # old desktop: slow (no AVX/GPU) but lots of memory
        (0.6, 1),    # fast wearable: tiny memory
    ]
    clients = []
    for c in range(num_clients):
        devs = []
        order = rng.permutation(len(archetypes))
        for i in range(devices_per_client):
            tf, cap = archetypes[order[i % len(archetypes)]]
            jitter = float(rng.uniform(0.8, 1.25))
            devs.append(Device(f"c{c}_d{i}", tf * jitter, cap))
        clients.append(Client(f"c{c}", devs))
    return clients


def uniform_pool(num_clients: int, devices_per_client: int,
                 time_factor: float = 1.0, capacity: int = 2) -> List[Client]:
    """Homogeneous pool (TPU-pod analogue: every chip identical)."""
    return [
        Client(f"c{c}", [Device(f"c{c}_d{i}", time_factor, capacity)
                         for i in range(devices_per_client)])
        for c in range(num_clients)
    ]


def make_pool(preset: str, num_clients: int, devices_per_client: int,
              seed: int = 0) -> List[Client]:
    if preset == "paper":
        return paper_pool(num_clients, devices_per_client, seed)
    if preset == "uniform":
        return uniform_pool(num_clients, devices_per_client)
    raise ValueError(f"unknown heterogeneity preset {preset!r}")
