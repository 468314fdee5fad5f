"""Device-selection strategies (paper §4).

Four strategies, the cross product of
  {random, sort_by_time(efficiency)} x {single portion, multiple portions}:

  random_single   pick a device at random, give it ONE portion (one layer
                  unit), pick again (with replacement of remaining-capacity
                  devices) until the model is covered.
  random_multi    pick a device at random, fill it with as many consecutive
                  portions as its capacity allows, continue.
  sorted_single   sort devices by efficiency (desc); round-robin one portion
                  at a time over that order.
  sorted_multi    sort devices by efficiency (desc); fill each device to
                  capacity before moving to the next.  (paper's winner)

Drop rules (paper §4): a device that cannot take any portion is removed from
the pool; a client whose devices cannot cover the whole model is removed
from the FL round (InfeasibleSplit).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.config.base import SELECTION_STRATEGIES as STRATEGIES
from repro_torch.core.devices import Client, Device
from repro_torch.core.split import InfeasibleSplit, Portion, SplitPlan


def _check_feasible(client: Client, n_units: int) -> None:
    if client.total_capacity() < n_units:
        raise InfeasibleSplit(
            f"client {client.client_id}: capacity {client.total_capacity()} "
            f"< {n_units} layer units — dropped from FL round (paper §4)")


def _plan_from_order(client: Client, layers: Sequence[Tuple[str, float]],
                     device_order: List[Device], multi: bool) -> SplitPlan:
    """Walk layers in model order, assigning to devices in `device_order`.

    multi=True fills a device to capacity before advancing; multi=False
    takes one unit per visit (the order list may repeat devices).
    """
    plan = SplitPlan(client_id=client.client_id)
    remaining = {d.device_id: d.capacity for d in client.devices}
    li = 0
    for dev in device_order:
        if li >= len(layers):
            break
        cap = remaining.get(dev.device_id, 0)
        if cap <= 0:
            continue            # paper: device with no room is skipped/removed
        take = min(cap, len(layers) - li) if multi else 1
        names = tuple(n for n, _ in layers[li:li + take])
        cost = float(sum(c for _, c in layers[li:li + take]))
        plan.portions.append(Portion(dev.device_id, names, cost))
        remaining[dev.device_id] = cap - take
        li += take
    if li < len(layers):
        raise InfeasibleSplit(
            f"client {client.client_id}: ran out of devices at layer {li}")
    return plan


def make_plan(client: Client, layers: Sequence[Tuple[str, float]],
              strategy: str, seed: int = 0) -> SplitPlan:
    """layers: ordered (name, cost) units. Returns a validated SplitPlan."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    _check_feasible(client, len(layers))
    rng = np.random.default_rng(seed)
    if strategy.startswith("random"):
        # random order with enough repeats that capacity can be consumed
        idx = list(range(len(client.devices)))
        order: List[Device] = []
        while len(order) < len(layers) * 2 + len(idx):
            rng.shuffle(idx)
            order.extend(client.devices[i] for i in idx)
    else:
        by_eff = sorted(client.devices, key=lambda d: -d.efficiency)
        if strategy == "sorted_single":
            # round-robin in efficiency order until capacity exhausted
            order = []
            for _ in range(max(d.capacity for d in by_eff)):
                order.extend(by_eff)
        else:
            order = by_eff
    multi = strategy.endswith("multi")
    plan = _plan_from_order(client, layers, order, multi)
    plan.validate([n for n, _ in layers])
    return plan


def plan_all_clients(clients: List[Client],
                     layers: Sequence[Tuple[str, float]], strategy: str,
                     seed: int = 0) -> Dict[str, SplitPlan]:
    """Plan every client; infeasible clients are dropped (paper §4)."""
    plans: Dict[str, SplitPlan] = {}
    for i, c in enumerate(clients):
        try:
            plans[c.client_id] = make_plan(c, layers, strategy, seed + i)
        except InfeasibleSplit:
            continue
    return plans
