"""FSL beyond GANs: the paper's federated-split scheme applied to an
assigned transformer architecture (twin of ``examples/federated_lm.py``).

Per-client model replicas train on non-IID token shards with FedAvg every
``--local-steps`` steps (the paper's cadence). The demo compares cadences
k=1 (classic data-parallel sync) vs k=4 (FedAvg proper) on loss — and
prints the parameter-sync traffic ratio, the paper's resource argument
made quantitative: parameter averaging every k steps moves 1/k as many
bytes as per-step gradient sync at equal steps.  The result lands in
``federated_lm.json`` under ``--out``.

Run: PYTHONPATH=src python -m repro_torch.examples.federated_lm \\
         [--arch rwkv6-1.6b] [--device cpu]
"""
import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.config import reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic_lm_batch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import lm_init
from repro_torch.optim import make_optimizer
from repro_torch.runtime import make_fsl_train_step
from repro_torch.tree import leaves, tree_map

OUT = os.path.join("experiments", "gan_torch")
CADENCES = (1, 4)


def run_cadence(cfg, n_clients: int, steps: int, seed: int = 0,
                device=None) -> List[float]:
    m = cfg.model
    dev = resolve_device(device)
    params = lm_init(seed, m, device=dev)
    opt = make_optimizer(cfg.optim)
    opt_state = opt.init(params)
    fstep = make_fsl_train_step(cfg, n_clients)
    cp = tree_map(lambda x: x[None].expand(n_clients, *x.shape), params)
    co = tree_map(lambda x: x[None].expand(n_clients, *x.shape), opt_state)
    b = cfg.shape.global_batch
    losses = []
    for i in range(steps):
        # non-IID: each client keeps its own seed stream
        bt = {k: torch.as_tensor(v, device=dev).reshape(n_clients, b, -1)
              for k, v in synthetic_lm_batch(b * n_clients, cfg.shape.seq_len,
                                             m.vocab_size,
                                             seed=1000 + i).items()}
        cp, co, met = fstep(cp, co, bt, i)
        losses.append(float(met["loss"]))
    return losses


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    base = reduce_for_smoke(get_config(args.arch, "train_4k"), seq_len=32,
                            batch=4)
    base = base.override({"optim.schedule": "constant",
                          "optim.warmup_steps": 0})
    n_params = sum(x.numel() for x in leaves(
        lm_init(0, base.model, device="cpu")))
    result = {}
    for k in CADENCES:
        cfg = base.override({"fsl.local_steps": k})
        t0 = time.time()
        losses = run_cadence(cfg, args.clients, args.steps,
                             device=args.device)
        # sync traffic: k=1 averages params every step, k=4 every 4th
        syncs = len([i for i in range(args.steps) if (i + 1) % k == 0])
        mb = syncs * n_params * 4 / 2 ** 20
        print(f"local_steps={k}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"| {syncs} FedAvg rounds = {mb:.0f} MiB param traffic "
              f"({time.time()-t0:.0f}s)")
        result[f"local_steps={k}"] = {"losses": losses, "fedavg_rounds":
                                      syncs, "param_mib": mb}
    print("cadence k divides parameter-sync traffic by k at equal steps — "
          "the paper's efficiency argument, quantified.")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "federated_lm.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
