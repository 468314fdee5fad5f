"""Analytic time model for FSL-GAN epochs (paper Fig 2).  Port of
``repro/core/simulate.py``: the sequential chain, the pipelined (1F1B)
schedule's makespan, the per-strategy epoch report and the Fig. 2 sweep,
each equal to the reference's result.

The paper measures, per splitting strategy, the per-epoch wall time of the
*slowest* client (the system bottleneck), with
  - per-device compute time = (portion compute units) x Time_Factor,
  - 50 ms per LAN hop between devices of one client,
  - 24 batches per client per epoch, communication counted per batch,
  - forward + backward both traverse the chain (2x hops), backward ~2x
    forward compute (standard 1:2 fwd:bwd FLOP ratio).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.devices import Client
from repro_torch.core.selection import plan_all_clients
from repro_torch.core.split import SplitPlan

BWD_FWD_RATIO = 2.0


@dataclass
class TimeReport:
    per_client: Dict[str, float]          # epoch seconds per client
    slowest_client: str
    slowest_time: float
    mean_time: float


def plan_epoch_time(plan: SplitPlan, client: Client,
                    batches_per_epoch: int = 24,
                    lan_latency_s: float = 0.050,
                    compute_unit_s: float = 0.010,
                    boundary_bytes: Optional[Sequence[int]] = None,
                    lan_bandwidth_bps: float = 100e6,
                    pipeline_microbatches: int = 1) -> float:
    """Seconds for one epoch of discriminator training under this plan.

    Sequential (``pipeline_microbatches = 1``): the SL chain is additive
    per batch — every device computes its portion (fwd then bwd),
    activations and gradients hop the LAN at each boundary, nothing
    overlaps.  Pipelined (``K > 1``): the per-batch time is the makespan
    of the 1F1B :class:`core.pipeline.OverlapSchedule` — device segments
    overlap across micro-batches, hops carry ``1/K`` of the payload each,
    and the additive model is the schedule's own ``K = 1`` case.

    LAN pricing has two modes:

      * **measured** — ``boundary_bytes`` lists the bytes of every hop event
        one batch ships (see ``core/split.SplitExecution.step_wire_bytes``);
        each hop costs ``lan_latency_s + 8 * bytes / lan_bandwidth_bps``;
      * **analytic** — ``boundary_bytes=None`` keeps the paper's model: a
        fixed ``lan_latency_s`` per hop, 2 hops per boundary.
    """
    tf = {d.device_id: d.time_factor for d in client.devices}
    if pipeline_microbatches > 1 and plan.num_boundaries > 0:
        from repro_torch.core.pipeline import schedule_for
        segs: List[Tuple[str, float]] = []
        for p in plan.portions:
            if segs and segs[-1][0] == p.device_id:
                segs[-1] = (p.device_id, segs[-1][1] + p.cost)
            else:
                segs.append((p.device_id, p.cost))
        sched = schedule_for(
            [c for _, c in segs], [d for d, _ in segs], tf,
            num_microbatches=pipeline_microbatches,
            compute_unit_s=compute_unit_s, bwd_fwd_ratio=BWD_FWD_RATIO,
            lan_latency_s=lan_latency_s, hop_bytes=boundary_bytes,
            lan_bandwidth_bps=lan_bandwidth_bps)
        return sched.makespan * batches_per_epoch
    compute = sum(p.cost * compute_unit_s * tf[p.device_id] * (1 + BWD_FWD_RATIO)
                  for p in plan.portions)
    if boundary_bytes is None:
        lan = plan.num_boundaries * 2 * lan_latency_s
    else:
        bw = max(float(lan_bandwidth_bps), 1.0)
        lan = sum(lan_latency_s + 8.0 * int(b) / bw for b in boundary_bytes)
    per_batch = compute + lan
    return per_batch * batches_per_epoch


def epoch_time_report(clients: List[Client],
                      layers: Sequence[Tuple[str, float]], strategy: str,
                      seed: int = 0, batches_per_epoch: int = 24,
                      lan_latency_s: float = 0.050,
                      compute_unit_s: float = 0.010) -> TimeReport:
    """Every feasible client's epoch time under ``strategy``'s plans, and
    the slowest one (the round's bottleneck)."""
    plans = plan_all_clients(clients, layers, strategy, seed)
    if not plans:
        raise ValueError("no feasible client")
    by_id = {c.client_id: c for c in clients}
    times = {cid: plan_epoch_time(p, by_id[cid], batches_per_epoch,
                                  lan_latency_s, compute_unit_s)
             for cid, p in plans.items()}
    slowest = max(times, key=times.get)
    return TimeReport(per_client=times, slowest_client=slowest,
                      slowest_time=times[slowest],
                      mean_time=float(np.mean(list(times.values()))))


def strategy_sweep(clients: List[Client],
                   layers: Sequence[Tuple[str, float]],
                   seeds: Sequence[int] = range(10),
                   **kw) -> Dict[str, Tuple[float, float]]:
    """Fig 2: mean +/- std of slowest-client epoch time per strategy."""
    from repro_torch.core.selection import STRATEGIES
    out = {}
    for s in STRATEGIES:
        vals = [epoch_time_report(clients, layers, s, seed=sd, **kw)
                .slowest_time for sd in seeds]
        out[s] = (float(np.mean(vals)), float(np.std(vals)))
    return out
