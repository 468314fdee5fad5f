"""1F1B overlap schedules for pipelined split execution.  Port of
``repro/core/pipeline.py``: pure Python, the same floating-point
operations in the same order, so every schedule equals the reference's.

``core.split.SplitExecution`` runs the per-segment chain strictly in
sequence: every device waits for the previous hop, so a three-device
split leaves two devices idle at any instant.  Splitting the batch into
``K`` micro-batches lets segment ``s`` of micro-batch ``m`` run
concurrently with segment ``s+1`` of micro-batch ``m-1`` — the classic
1F1B pipeline shape.  This module builds the *explicit* overlap
schedule for that execution, so the virtual-clock model
(``core.simulate.plan_epoch_time``) and the trace timeline
(``SplitExecution.round_timeline``) price the same overlapped round
instead of the strictly additive per-hop sum.

Model
-----
* Each merged plan segment is one pipeline *stage* pinned to a device.
  A device is occupied only while computing; compute time for a
  micro-batch is the full-batch segment time divided by ``K``.
* A boundary hop is latency on the dependency edge between stages: it
  delays the consumer but does not occupy either device (full-duplex
  LAN links, one per boundary).  A micro-batch hop pays the full
  per-message latency but only ``1/K`` of the serialization bytes.
* Dependencies: ``F(m, s)`` needs ``F(m, s-1)`` plus the forward hop;
  ``B(m, S-1)`` needs ``F(m, S-1)``; ``B(m, s)`` needs ``B(m, s+1)``
  plus the backward hop.  Scheduling is event-driven greedy list
  scheduling with backward-first tie-breaking (1F1B drain order).

For ``K == 1`` the schedule degenerates to the sequential chain and the
makespan reproduces the additive per-batch time *exactly* (same
floating-point accumulation order).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "PipelineTask",
    "OverlapSchedule",
    "overlap_schedule",
    "schedule_for",
    "effective_microbatches",
]


def effective_microbatches(batch_size: int, requested: int) -> int:
    """Largest ``K <= requested`` that divides ``batch_size`` evenly.

    Pipelined execution requires equal micro-batches (so per-tail mean
    losses average back to the full-batch loss); a request that does
    not divide the batch is clamped to the nearest divisor rather than
    rejected.  ``batch_size <= 1`` (e.g. DP-SGD per-example steps)
    always yields 1.
    """
    k = max(1, int(requested))
    b = int(batch_size)
    if b <= 1:
        return 1
    k = min(k, b)
    while b % k:
        k -= 1
    return k


@dataclass(frozen=True)
class PipelineTask:
    """One scheduled unit: a segment compute or a boundary hop."""

    kind: str          # "fwd" | "bwd" | "hop_fwd" | "hop_bwd"
    microbatch: int
    index: int         # segment index for compute, boundary index for hops
    device: str        # owning device (hop: the sending device)
    t0: float
    t1: float

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


@dataclass(frozen=True)
class OverlapSchedule:
    """Explicit 1F1B schedule over ``num_microbatches`` micro-batches.

    ``seg_fwd_s`` / ``seg_bwd_s`` are *full-batch* per-segment compute
    seconds; ``hop_fwd_s`` / ``hop_bwd_s`` are per-*micro-batch* hop
    seconds; ``hop_fwd_full_s`` / ``hop_bwd_full_s`` price the same
    hops for a single full-batch message (the ``K = 1`` baseline used
    by :attr:`sequential_s`).
    """

    num_microbatches: int
    devices: Tuple[str, ...]
    tasks: Tuple[PipelineTask, ...]
    seg_fwd_s: Tuple[float, ...]
    seg_bwd_s: Tuple[float, ...]
    hop_fwd_s: Tuple[float, ...]
    hop_bwd_s: Tuple[float, ...]
    hop_fwd_full_s: Tuple[float, ...]
    hop_bwd_full_s: Tuple[float, ...]

    @property
    def num_segments(self) -> int:
        return len(self.devices)

    @property
    def makespan(self) -> float:
        """Per-batch wall time of the overlapped execution."""
        return max((t.t1 for t in self.tasks), default=0.0)

    @property
    def sequential_s(self) -> float:
        """Per-batch time of the legacy strictly-additive execution
        (one full-batch message per hop, no overlap), accumulated in
        the same order as ``SplitExecution.round_timeline``."""
        t = 0.0
        s = self.num_segments
        for si in range(s):
            t += self.seg_fwd_s[si]
            if si < s - 1:
                t += self.hop_fwd_full_s[si]
        for si in range(s - 1, -1, -1):
            t += self.seg_bwd_s[si]
            if si > 0:
                t += self.hop_bwd_full_s[si - 1]
        return t

    @property
    def speedup(self) -> float:
        """Analytic sequential / pipelined per-batch ratio (>= 1 when
        pipelining helps; 1.0 for a degenerate single-task schedule)."""
        mk = self.makespan
        return self.sequential_s / mk if mk > 0.0 else 1.0

    def device_busy_s(self) -> Dict[str, float]:
        """Total scheduled *compute* seconds per device (hops excluded)."""
        busy: Dict[str, float] = {}
        for t in self.tasks:
            if t.kind in ("fwd", "bwd"):
                busy[t.device] = busy.get(t.device, 0.0) + t.duration
        return busy

    def segment_work_s(self) -> List[float]:
        """Total scheduled compute seconds per segment — conserved work:
        equals ``seg_fwd_s[i] + seg_bwd_s[i]`` up to micro-batch split
        rounding regardless of ``K``."""
        work = [0.0] * self.num_segments
        for t in self.tasks:
            if t.kind in ("fwd", "bwd"):
                work[t.index] += t.duration
        return work


def overlap_schedule(
    seg_fwd_s: Sequence[float],
    seg_bwd_s: Sequence[float],
    *,
    num_microbatches: int,
    hop_fwd_s: Sequence[float],
    hop_bwd_s: Sequence[float],
    hop_fwd_full_s: Optional[Sequence[float]] = None,
    hop_bwd_full_s: Optional[Sequence[float]] = None,
    devices: Optional[Sequence[str]] = None,
) -> OverlapSchedule:
    """Build the 1F1B schedule for per-segment full-batch compute times
    and per-micro-batch hop times.

    ``hop_*_full_s`` defaults to ``hop_*_s`` (appropriate when hops are
    pure latency with no serialization term).
    """
    s = len(seg_fwd_s)
    if len(seg_bwd_s) != s:
        raise ValueError("seg_fwd_s and seg_bwd_s length mismatch")
    if len(hop_fwd_s) != max(0, s - 1) or len(hop_bwd_s) != max(0, s - 1):
        raise ValueError("expected one hop time per internal boundary")
    k = max(1, int(num_microbatches))
    devs = tuple(devices) if devices is not None \
        else tuple(f"d{i}" for i in range(s))
    if len(devs) != s:
        raise ValueError("devices length mismatch")
    hop_fwd_full = tuple(hop_fwd_full_s) if hop_fwd_full_s is not None \
        else tuple(hop_fwd_s)
    hop_bwd_full = tuple(hop_bwd_full_s) if hop_bwd_full_s is not None \
        else tuple(hop_bwd_s)

    # Per-micro-batch compute durations.  For K == 1 use the segment
    # time verbatim (no divide) so the degenerate schedule is bit-equal
    # to the additive model.
    if k == 1:
        mb_fwd = list(seg_fwd_s)
        mb_bwd = list(seg_bwd_s)
    else:
        mb_fwd = [t / k for t in seg_fwd_s]
        mb_bwd = [t / k for t in seg_bwd_s]

    finish: Dict[Tuple[str, int, int], float] = {}
    dev_free = [0.0] * s
    tasks: List[PipelineTask] = []

    def ready(kind: str, m: int, si: int) -> Optional[float]:
        """Dependency-ready time, or None if a dependency is unscheduled.
        Hop latency rides on the edge (max, not +=, against dev_free)."""
        if kind == "fwd":
            if si == 0:
                return 0.0
            prev = finish.get(("fwd", m, si - 1))
            return None if prev is None else prev + hop_fwd_s[si - 1]
        if si == s - 1:
            prev = finish.get(("fwd", m, si))
            return None if prev is None else prev
        prev = finish.get(("bwd", m, si + 1))
        return None if prev is None else prev + hop_bwd_s[si]

    pending = [("fwd", m, si) for m in range(k) for si in range(s)]
    pending += [("bwd", m, si) for m in range(k) for si in range(s)]
    while pending:
        best = None
        best_key = None
        for item in pending:
            kind, m, si = item
            r = ready(kind, m, si)
            if r is None:
                continue
            est = max(r, dev_free[si])
            # Earliest start wins; ties drain backward work first
            # (1F1B), then lower micro-batch, then lower segment.
            key = (est, 0 if kind == "bwd" else 1, m, si)
            if best_key is None or key < best_key:
                best, best_key = item, key
        assert best is not None, "dependency cycle in pipeline schedule"
        kind, m, si = best
        est = best_key[0]
        dur = mb_fwd[si] if kind == "fwd" else mb_bwd[si]
        t1 = est + dur
        finish[(kind, m, si)] = t1
        dev_free[si] = t1
        tasks.append(PipelineTask(kind, m, si, devs[si], est, t1))
        pending.remove(best)

    # Hop tasks (for timelines): each rides the producing task's finish.
    for m in range(k):
        for b in range(s - 1):
            f = finish[("fwd", m, b)]
            tasks.append(PipelineTask("hop_fwd", m, b, devs[b],
                                      f, f + hop_fwd_s[b]))
            g = finish[("bwd", m, b + 1)]
            tasks.append(PipelineTask("hop_bwd", m, b, devs[b + 1],
                                      g, g + hop_bwd_s[b]))

    return OverlapSchedule(
        num_microbatches=k,
        devices=devs,
        tasks=tuple(tasks),
        seg_fwd_s=tuple(seg_fwd_s),
        seg_bwd_s=tuple(seg_bwd_s),
        hop_fwd_s=tuple(hop_fwd_s),
        hop_bwd_s=tuple(hop_bwd_s),
        hop_fwd_full_s=hop_fwd_full,
        hop_bwd_full_s=hop_bwd_full,
    )


def schedule_for(
    seg_costs: Sequence[float],
    seg_devices: Sequence[str],
    time_factors: Dict[str, float],
    *,
    num_microbatches: int,
    compute_unit_s: float = 0.010,
    bwd_fwd_ratio: float = 2.0,
    lan_latency_s: float = 0.050,
    hop_bytes: Optional[Sequence[int]] = None,
    lan_bandwidth_bps: float = 100e6,
) -> OverlapSchedule:
    """Price a merged split plan into an :class:`OverlapSchedule`.

    ``seg_costs`` / ``seg_devices`` come from the merged plan segments
    (`core.split.plan_segments`); ``hop_bytes`` is the flat
    ``[b0.fwd, b0.bwd, b1.fwd, ...]`` full-batch wire-bytes list (same
    layout as ``plan_epoch_time``'s ``boundary_bytes``), ``None``
    meaning latency-only hops.
    """
    s = len(seg_costs)
    if len(seg_devices) != s:
        raise ValueError("seg_costs and seg_devices length mismatch")
    k = max(1, int(num_microbatches))
    tf = {d: float(f) for d, f in time_factors.items()}
    seg_fwd = [float(c) * compute_unit_s * tf.get(d, 1.0)
               for c, d in zip(seg_costs, seg_devices)]
    seg_bwd = [t * bwd_fwd_ratio for t in seg_fwd]

    def hop(ev: int, frac: float) -> float:
        if hop_bytes is None:
            return lan_latency_s
        return lan_latency_s + 8.0 * int(hop_bytes[ev]) * frac \
            / lan_bandwidth_bps

    nb = max(0, s - 1)
    hop_fwd = [hop(2 * b, 1.0 / k) for b in range(nb)]
    hop_bwd = [hop(2 * b + 1, 1.0 / k) for b in range(nb)]
    hop_fwd_full = [hop(2 * b, 1.0) for b in range(nb)]
    hop_bwd_full = [hop(2 * b + 1, 1.0) for b in range(nb)]
    return overlap_schedule(
        seg_fwd, seg_bwd,
        num_microbatches=k,
        hop_fwd_s=hop_fwd, hop_bwd_s=hop_bwd,
        hop_fwd_full_s=hop_fwd_full, hop_bwd_full_s=hop_bwd_full,
        devices=seg_devices,
    )
