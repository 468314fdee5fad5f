"""End-to-end example (the paper's experiment): FSL-GAN on (synthetic)
MNIST.  Twin of ``examples/fsl_gan_mnist.py``.

Trains the DCGAN with the full FSL pipeline — central generator, federated
split discriminators, device-selection planning, FedAvg each round — then
reports losses and the image-mean proxy, and writes ``generated.npy`` and
``history.json`` under ``--out``.

Run: PYTHONPATH=src python -m repro_torch.examples.fsl_gan_mnist
     [--epochs 12] [--device cpu]
"""
import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.data import partition_dirichlet, synthetic_mnist

OUT = os.path.join("experiments", "gan_torch")


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--batches-per-client", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--base-filters", type=int, default=16)
    ap.add_argument("--examples", type=int, default=4000)
    ap.add_argument("--selection", default="sorted_multi")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    cfg = get_config("dcgan-mnist").override({
        "shape.global_batch": args.batch_size,
        "fsl.num_clients": args.clients,
        "fsl.selection": args.selection,
        "model.dcgan.base_filters": args.base_filters})
    imgs, labels = synthetic_mnist(args.examples, seed=0)
    parts = partition_dirichlet(imgs, labels, args.clients, alpha=0.5,
                                seed=0)
    print(f"clients: { {k: len(v) for k, v in parts.items()} } examples")

    tr = FSLGANTrainer(cfg, parts, seed=0, device=args.device)
    for cid, plan in tr.plans.items():
        print(f"  {cid} plan: " + " | ".join(
            f"{p.device_id}:{','.join(p.layer_names)}" for p in plan.portions))

    t0 = time.time()
    hist = []
    steps = 0
    for ep in range(args.epochs):
        m = tr.train_epoch(batches_per_client=args.batches_per_client)
        steps += args.clients * args.batches_per_client
        hist.append(m)
        print(f"epoch {ep:3d}: d={m['d_loss']:.3f} g={m['g_loss']:.3f} "
              f"({steps} disc steps, {time.time() - t0:.0f}s)", flush=True)

    gen = tr.generate(64)
    mse = float(np.mean((gen.mean(0) - imgs.mean(0)) ** 2))
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "generated.npy"), gen)
    result = {"history": hist, "mean_image_mse": mse,
              "total_disc_steps": steps, "device": str(tr.device)}
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(f"done on {tr.device}: {steps} discriminator steps, mean-image "
          f"MSE {mse:.4f}, artifacts in {os.path.abspath(args.out)}")
    return result


if __name__ == "__main__":
    main()
