"""Discrete-event primitives for the federation engine.

The engine advances a *virtual* clock: client compute times come from the
paper's analytic model (``core/simulate.plan_epoch_time``), WAN transfer
times from ``fed/transport.LinkModel``.  Events are totally ordered by
(time, seq) — seq breaks ties deterministically in insertion order, so runs
are reproducible regardless of float coincidences.

Event kinds:
  FINISH  client finished local compute (+ encode); uplink starts
  ARRIVE  the client's update landed at the server; aggregation may fire

Availability traces model client churn (devices going offline between
rounds, SplitFed's straggler reality): a trace answers "is this client up
for round r?".
"""
from __future__ import annotations

import heapq
import zlib
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional

import numpy as np

FINISH = "finish"
ARRIVE = "arrive"


@dataclass(order=True)
class Event:
    time: float
    seq: int
    kind: str = field(compare=False)
    client_id: str = field(compare=False)
    payload: Any = field(compare=False, default=None)


class EventQueue:
    """Min-heap of events with a deterministic tie-break sequence."""

    def __init__(self) -> None:
        self._heap: List[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, client_id: str,
             payload: Any = None) -> Event:
        ev = Event(float(time), self._seq, kind, client_id, payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        while self._heap:
            yield heapq.heappop(self._heap)


# ---------------------------------------------------------------------------
# availability traces
# ---------------------------------------------------------------------------

class AvailabilityTrace:
    def available(self, client_id: str, round_idx: int) -> bool:
        raise NotImplementedError


class AlwaysAvailable(AvailabilityTrace):
    def available(self, client_id: str, round_idx: int) -> bool:
        return True


class BernoulliAvailability(AvailabilityTrace):
    """Each (client, round) is up independently with probability ``prob``.

    Deterministic in (seed, client_id, round): the draw is keyed by a hash
    of both, not by call order — the engine may probe clients in any order.
    """

    def __init__(self, prob: float, seed: int = 0):
        self.prob = float(prob)
        self.seed = int(seed)

    def available(self, client_id: str, round_idx: int) -> bool:
        if self.prob >= 1.0:
            return True
        # crc32, not hash(): str hashing is salted per process and would
        # break run-to-run reproducibility of the trace
        key = zlib.crc32(f"{self.seed}/{client_id}/{round_idx}".encode())
        return float(np.random.default_rng(key).uniform()) < self.prob


def make_availability(prob: float, seed: int = 0) -> AvailabilityTrace:
    return AlwaysAvailable() if prob >= 1.0 else \
        BernoulliAvailability(prob, seed)
