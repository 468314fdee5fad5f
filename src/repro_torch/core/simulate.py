"""Analytic time model for FSL-GAN epochs (paper Fig 2).  Port of
``plan_epoch_time`` from ``repro/core/simulate.py`` for the sequential
(K = 1) chain, with the paper's hop constant or measured boundary bytes;
the pipelined (1F1B) schedule waits for ROADMAP Queue A item 12.

The paper measures, per splitting strategy, the per-epoch wall time of the
*slowest* client (the system bottleneck), with
  - per-device compute time = (portion compute units) x Time_Factor,
  - 50 ms per LAN hop between devices of one client,
  - 24 batches per client per epoch, communication counted per batch,
  - forward + backward both traverse the chain (2x hops), backward ~2x
    forward compute (standard 1:2 fwd:bwd FLOP ratio).
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.devices import Client
from repro_torch.core.split import SplitPlan

BWD_FWD_RATIO = 2.0


def plan_epoch_time(plan: SplitPlan, client: Client,
                    batches_per_epoch: int = 24,
                    lan_latency_s: float = 0.050,
                    compute_unit_s: float = 0.010,
                    boundary_bytes: Optional[Sequence[int]] = None,
                    lan_bandwidth_bps: float = 100e6) -> float:
    """Seconds for one epoch of discriminator training under this plan.

    The SL chain is additive per batch — every device computes its portion
    (fwd then bwd), activations and gradients hop the LAN at each
    boundary, nothing overlaps.  LAN pricing has two modes:

      * **measured** — ``boundary_bytes`` lists the bytes of every hop event
        one batch ships (see ``core/split.SplitExecution.step_wire_bytes``);
        each hop costs ``lan_latency_s + 8 * bytes / lan_bandwidth_bps``;
      * **analytic** — ``boundary_bytes=None`` keeps the paper's model: a
        fixed ``lan_latency_s`` per hop, 2 hops per boundary.
    """
    tf = {d.device_id: d.time_factor for d in client.devices}
    compute = sum(p.cost * compute_unit_s * tf[p.device_id] * (1 + BWD_FWD_RATIO)
                  for p in plan.portions)
    if boundary_bytes is None:
        lan = plan.num_boundaries * 2 * lan_latency_s
    else:
        bw = max(float(lan_bandwidth_bps), 1.0)
        lan = sum(lan_latency_s + 8.0 * int(b) / bw for b in boundary_bytes)
    per_batch = compute + lan
    return per_batch * batches_per_epoch
