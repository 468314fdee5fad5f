"""Quickstart: the three layers of the framework in well under a minute.
Twin of ``examples/quickstart.py``.

1. paper core — split a discriminator across heterogeneous devices and
                price the four selection strategies (Fig 2 machinery)
2. FSL-GAN    — two federated clients train a DCGAN for two rounds
3. substrate  — a reduced assigned architecture (olmoe-1b-7b) takes two
                LM train steps

The results land in ``quickstart.json`` under ``--out``.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import json
import os
from typing import Dict, List, Optional

import torch

from repro_torch.config import DCGANConfig, reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.core.devices import make_pool
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.core.simulate import strategy_sweep
from repro_torch.data import (partition_dirichlet, synthetic_lm_batch,
                              synthetic_mnist)
from repro_torch.device import resolve_device
from repro_torch.models.dcgan import disc_layer_costs, disc_layer_names
from repro_torch.models.transformer import lm_init
from repro_torch.optim import make_optimizer
from repro_torch.runtime import make_train_step

OUT = os.path.join("experiments", "gan_torch")


def demo_split_planning() -> Dict[str, List[float]]:
    print("=== 1. split planning & strategy pricing (paper Fig 2) ===")
    c = DCGANConfig()
    costs = disc_layer_costs(c)
    total = sum(costs.values())
    layers = [(n, 4 * costs[n] / total) for n in disc_layer_names(c)]
    pool = make_pool("paper", 5, 4, seed=0)
    res = strategy_sweep(pool, layers, seeds=range(3), compute_unit_s=0.2)
    for strat, (mean, std) in sorted(res.items(), key=lambda kv: kv[1][0]):
        print(f"  {strat:16s} slowest-client epoch: {mean:7.2f}s ± {std:.2f}")
    return {k: list(v) for k, v in res.items()}


def demo_fsl_gan(device=None, rounds: int = 2, batch_size: int = 16,
                 base_filters: int = 8) -> List[Dict[str, float]]:
    print(f"=== 2. FSL-GAN: 2 clients, {rounds} rounds ===")
    cfg = get_config("dcgan-mnist").override({
        "shape.global_batch": batch_size, "fsl.num_clients": 2,
        "model.dcgan.base_filters": base_filters})
    imgs, labels = synthetic_mnist(200, seed=0)
    parts = partition_dirichlet(imgs, labels, 2, alpha=0.5, seed=0)
    tr = FSLGANTrainer(cfg, parts, seed=0, device=device)
    hist = []
    for ep in range(rounds):
        m = tr.train_epoch(batches_per_client=2)
        hist.append(m)
        print(f"  round {ep}: d_loss={m['d_loss']:.3f} "
              f"g_loss={m['g_loss']:.3f}")
    print(f"  generated {tr.generate(2).shape} images on {tr.device}; plans: "
          f"{ {cid: len(p.portions) for cid, p in tr.plans.items()} } "
          f"portions")
    return hist


def demo_lm_substrate(device=None) -> List[Dict[str, float]]:
    print("=== 3. assigned-arch substrate: olmoe-1b-7b (reduced) ===")
    cfg = reduce_for_smoke(get_config("olmoe-1b-7b", "train_4k"),
                           seq_len=32, batch=4)
    m = cfg.model
    dev = resolve_device(device)
    params = lm_init(0, m, device=dev)
    opt = make_optimizer(cfg.optim)
    opt_state = opt.init(params)
    step = make_train_step(cfg)
    hist = []
    for i in range(2):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 synthetic_lm_batch(4, 32, m.vocab_size, seed=i).items()}
        params, opt_state, metrics = step(params, opt_state, batch, i)
        hist.append({k: float(metrics[k]) for k in ("loss", "aux_loss")})
        print(f"  step {i}: loss={hist[-1]['loss']:.3f} "
              f"(aux={hist[-1]['aux_loss']:.4f})")
    return hist


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--base-filters", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    result = {"strategy_sweep": demo_split_planning(),
              "fsl_gan": demo_fsl_gan(args.device, args.rounds,
                                      args.batch_size, args.base_filters),
              "lm_substrate": demo_lm_substrate(args.device)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "quickstart.json"), "w") as f:
        json.dump(result, f, indent=2)
    print("quickstart OK")
    return result


if __name__ == "__main__":
    main()
