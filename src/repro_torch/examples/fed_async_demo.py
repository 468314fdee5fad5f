"""Federation runtime demo: async vs sync scheduling, codecs, stragglers.
Twin of ``examples/fed_async_demo.py``.

Runs the same FSL-GAN workload (paper §3, smoke scale) under four runtime
configurations and prints, per epoch, the virtual round time (the paper's
Fig-2 wall-clock model extended with WAN transfers), uplink traffic, and
losses:

  sync            the paper's barrier FedAvg
  sync+deadline   barrier with straggler dropout at a deadline
  fedasync+int8   staleness-weighted async aggregation, int8 uplink codec
  fedbuff+topk    buffered async aggregation, top-k sparsified uplink

``--backend vectorized`` stacks each scenario's clients into one step a
batch instead of the per-client loop.  The totals of every scenario land
in ``fed_async.json`` under ``--out``.

Run: PYTHONPATH=src python -m repro_torch.examples.fed_async_demo
     [--epochs 4] [--backend loop] [--device cpu]
"""
import argparse
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs.registry import get_config
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.data import partition_dirichlet, synthetic_mnist

OUT = os.path.join("experiments", "gan_torch")

SCENARIOS = {
    "sync": {},
    "sync+deadline": {"fed.deadline_s": 2.4e4},
    "fedasync+int8": {"fed.mode": "fedasync", "fed.codec": "int8",
                      "fed.async_cycles": 2},
    "fedbuff+topk": {"fed.mode": "fedbuff", "fed.codec": "topk",
                     "fed.topk_frac": 0.05, "fed.buffer_size": 2,
                     "fed.async_cycles": 2},
}


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--batches-per-client", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--base-filters", type=int, default=8)
    ap.add_argument("--backend", choices=("loop", "vectorized"),
                    default="loop")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    imgs, labels = synthetic_mnist(1000, seed=0)
    parts = partition_dirichlet(imgs, labels, args.clients, alpha=0.5,
                                seed=0)
    totals = {}
    for name, over in SCENARIOS.items():
        cfg = get_config("dcgan-mnist").override({
            "shape.global_batch": args.batch_size,
            "fsl.num_clients": args.clients,
            "model.dcgan.base_filters": args.base_filters, **over})
        tr = FSLGANTrainer(cfg, parts, seed=0, device=args.device)
        print(f"\n=== {name} ===")
        for ep in range(args.epochs):
            m = tr.train_epoch(batches_per_client=args.batches_per_client,
                               backend=args.backend)
            print(f"  ep {ep}: d={m['d_loss']:.3f} g={m['g_loss']:.3f} "
                  f"round={m['round_time_s']:.0f}s "
                  f"clients={m['num_clients']:.0f} "
                  f"drop={m['stragglers']:.0f} "
                  f"stale={m['mean_staleness']:.2f} "
                  f"up={m['up_mbytes']:.3f}MB", flush=True)
        led = tr.engine.ledger
        totals[name] = {"up_mbytes": led.total_up / 1e6,
                        "down_mbytes": led.total_down / 1e6,
                        "clock_s": tr.engine.clock, "d_loss": m["d_loss"]}
        print(f"  totals: up={led.total_up / 1e6:.3f}MB "
              f"down={led.total_down / 1e6:.3f}MB "
              f"virtual clock={tr.engine.clock:.0f}s")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "fed_async.json"), "w") as f:
        json.dump(totals, f, indent=2)
    return totals


if __name__ == "__main__":
    main()
