"""Analytic time model for FSL-GAN epochs (paper Fig 2).  Port of
``plan_epoch_time`` from ``repro/core/simulate.py`` for a plan that prices
an unsplit round; pricing from measured boundary bytes and the pipelined
(1F1B) schedule wait for the executed split, ROADMAP Queue A item 5.

The paper measures, per splitting strategy, the per-epoch wall time of the
*slowest* client (the system bottleneck), with
  - per-device compute time = (portion compute units) x Time_Factor,
  - 50 ms per LAN hop between devices of one client,
  - 24 batches per client per epoch, communication counted per batch,
  - forward + backward both traverse the chain (2x hops), backward ~2x
    forward compute (standard 1:2 fwd:bwd FLOP ratio).
"""
from __future__ import annotations

from repro_torch.core.devices import Client
from repro_torch.core.split import SplitPlan

BWD_FWD_RATIO = 2.0


def plan_epoch_time(plan: SplitPlan, client: Client,
                    batches_per_epoch: int = 24,
                    lan_latency_s: float = 0.050,
                    compute_unit_s: float = 0.010) -> float:
    """Seconds for one epoch of discriminator training under this plan.

    The SL chain is additive per batch — every device computes its portion
    (fwd then bwd) and each boundary costs two LAN hops (forward +
    backward traversal) of ``lan_latency_s`` each; nothing overlaps.
    """
    tf = {d.device_id: d.time_factor for d in client.devices}
    compute = sum(p.cost * compute_unit_s * tf[p.device_id] * (1 + BWD_FWD_RATIO)
                  for p in plan.portions)
    lan = plan.num_boundaries * 2 * lan_latency_s
    per_batch = compute + lan
    return per_batch * batches_per_epoch
