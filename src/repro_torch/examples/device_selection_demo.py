"""Device-selection walkthrough (paper §4): inspect the plans each strategy
produces for one heterogeneous client, then price them with the analytic
hop model.  Twin of ``examples/device_selection_demo.py``.

This is the PLAN-ONLY view: planning and pricing are host arithmetic, so
this example runs no tensor work and takes no device.  The per-device loads
printed below are exactly ``RoundFeedback.device_loads``, the field the
split controller watches to re-run this planning when the measured
imbalance drifts (``repro_torch.examples.adaptive_control_demo`` closes
that loop).  The plans land in ``device_selection.json`` under ``--out``.

Run: PYTHONPATH=src python -m repro_torch.examples.device_selection_demo
"""
import argparse
import json
import os
from typing import Dict, List, Optional

from repro_torch.config import DCGANConfig
from repro_torch.core.devices import Client, Device
from repro_torch.core.selection import STRATEGIES, make_plan
from repro_torch.core.simulate import plan_epoch_time
from repro_torch.models.dcgan import disc_layer_costs, disc_layer_names

OUT = os.path.join("experiments", "gan_torch")


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, object]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    c = DCGANConfig()
    costs = disc_layer_costs(c)
    total = sum(costs.values())
    layers = [(n, 4 * costs[n] / total) for n in disc_layer_names(c)]

    client = Client("demo", [
        Device("phone", time_factor=0.4, capacity=2),    # fast, small
        Device("tablet", time_factor=1.0, capacity=2),
        Device("old-pc", time_factor=2.5, capacity=4),   # slow, roomy
        Device("watch", time_factor=0.6, capacity=1),    # fast, tiny
    ])
    print("devices (efficiency = capacity/time_factor):")
    for d in client.devices:
        print(f"  {d.device_id:8s} tf={d.time_factor:.1f} cap={d.capacity} "
              f"eff={d.efficiency:.2f}")

    print(f"\nmodel: {[n for n, _ in layers]} "
          f"(costs {[round(v, 2) for _, v in layers]})")
    plans = {}
    for strat in STRATEGIES:
        plan = make_plan(client, layers, strat, seed=1)
        t = plan_epoch_time(plan, client, compute_unit_s=0.2)
        route = " -> ".join(f"{p.device_id}[{','.join(p.layer_names)}]"
                            for p in plan.portions)
        loads = plan.device_loads()
        imb = max(loads.values()) / (sum(loads.values()) / len(loads))
        plans[strat] = {"epoch_s": t, "hops": plan.num_boundaries,
                        "route": route, "device_loads": loads,
                        "imbalance": imb}
        print(f"\n{strat} (epoch {t:.1f}s, {plan.num_boundaries} LAN hops):")
        print(f"  {route}")
        print(f"  RoundFeedback.device_loads = "
              f"{ {k: round(v, 2) for k, v in loads.items()} } "
              f"(max/mean imbalance {imb:.2f} — the split controller "
              f"replans past control.imbalance_threshold)")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "device_selection.json"), "w") as f:
        json.dump(plans, f, indent=2)
    return plans


if __name__ == "__main__":
    main()
