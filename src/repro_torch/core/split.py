"""Model splitting (paper §3.2/§4): split plans.  Port of the planning
part of ``repro/core/split.py``.

A :class:`SplitPlan` records which device trains which contiguous layer
range of the discriminator.  In this slice the plan prices the round
(``core/simulate.plan_epoch_time``) while training runs the monolithic D;
the executed split (``SplitExecution``) waits for ROADMAP Queue A item 5.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class Portion:
    """A contiguous run of layers assigned to one device."""
    device_id: str
    layer_names: Tuple[str, ...]
    cost: float                 # sum of layer costs (compute units)


@dataclass
class SplitPlan:
    client_id: str
    portions: List[Portion] = field(default_factory=list)

    @property
    def num_boundaries(self) -> int:
        """Device-to-device hand-offs along the chain (LAN hops, fwd)."""
        n = 0
        for a, b in zip(self.portions, self.portions[1:]):
            if a.device_id != b.device_id:
                n += 1
        return n

    def layers_in_order(self) -> List[str]:
        return [n for p in self.portions for n in p.layer_names]

    def device_loads(self) -> Dict[str, float]:
        loads: Dict[str, float] = {}
        for p in self.portions:
            loads[p.device_id] = loads.get(p.device_id, 0.0) + p.cost
        return loads

    def validate(self, layer_names: Sequence[str]) -> None:
        got = self.layers_in_order()
        if got != list(layer_names):
            raise ValueError(
                f"split plan does not cover the model in order:\n"
                f"  expected {list(layer_names)}\n  got      {got}")


class InfeasibleSplit(Exception):
    """Client lacks capacity to host the model (paper: client is dropped)."""


def plan_segments(plan: SplitPlan) -> List[Tuple[str, Tuple[str, ...]]]:
    """Merge consecutive same-device portions into *device segments*.

    A segment is the unit of staged execution: activations only cross the
    LAN between segments, so ``len(segments) - 1 == plan.num_boundaries``.
    """
    segs: List[Tuple[str, Tuple[str, ...]]] = []
    for p in plan.portions:
        if segs and segs[-1][0] == p.device_id:
            segs[-1] = (p.device_id, segs[-1][1] + p.layer_names)
        else:
            segs.append((p.device_id, p.layer_names))
    return segs
