"""Privacy subsystem demo: attack -> metric -> DP defense, end to end.
Twin of ``examples/privacy_frontier_demo.py``.

Walks the honest-but-curious threat model against the paper's protocol on
the synthetic dataset:

  1. train a few FSL-GAN rounds (no privacy) and ATTACK the artifacts the
     runtime ships — gradient inversion of the uplinked D gradient,
     activation inversion at a split boundary, membership inference on the
     trained D;
  2. MEASURE the leakage — reconstruction PSNR/SSIM, distance correlation
     per split depth, attack AUC;
  3. DEFEND with DP-SGD (per-example clip + Gaussian noise through the
     dp_clip CUDA kernel on the card) and re-run the gradient inversion:
     PSNR drops while the RDP accountant prices the epsilon spent.

Writes ``privacy_frontier.json`` under ``--out``.

Run: PYTHONPATH=src python -m repro_torch.examples.privacy_frontier_demo
     [--epochs 2] [--device cpu]
"""
import argparse
import functools
import json
import os
from typing import Dict, List, Optional

import torch

from repro_torch import keys
from repro_torch.configs.registry import get_config
from repro_torch.core.gan import FSLGANTrainer, d_loss_fn
from repro_torch.data import partition_dirichlet, synthetic_mnist
from repro_torch.device import fp32_convolutions
from repro_torch.kernels.dp_clip.ops import dp_clip_noise_tree
from repro_torch.privacy import (ActivationInversionAttack, best_match_psnr,
                                 distance_correlation, invert_gradients,
                                 make_prefix_fn, membership_inference,
                                 plan_boundary_depths, psnr, ssim)
from repro_torch.tree import tree_map

OUT = os.path.join("experiments", "gan_torch")


def per_example_grads(loss_fn, params, real, fake):
    """The victim's per-example D gradient tree (every leaf (B, ...)):
    ``torch.func.grad`` of the loss on each singleton batch."""
    grad_one = torch.func.vmap(
        torch.func.grad(lambda p, r, f: loss_fn(p, r[None], f[None])),
        in_dims=(None, 0, 0))
    with fp32_convolutions(), torch.enable_grad():
        return grad_one(tree_map(torch.Tensor.detach, params), real, fake)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--batches-per-client", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--base-filters", type=int, default=8)
    ap.add_argument("--examples", type=int, default=600)
    ap.add_argument("--sigma", type=float, default=1.0,
                    help="DP noise multiplier for the defended run")
    ap.add_argument("--inversion-steps", type=int, default=200)
    ap.add_argument("--decoder-steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    base = {"shape.global_batch": args.batch_size,
            "fsl.num_clients": args.clients,
            "model.dcgan.base_filters": args.base_filters}
    imgs, labels = synthetic_mnist(args.examples, seed=0)
    parts = partition_dirichlet(imgs, labels, args.clients, alpha=0.5,
                                seed=0)

    # --- 1. undefended training ------------------------------------------
    print("=== training (no privacy) ===")
    tr = FSLGANTrainer(get_config("dcgan-mnist").override(base), parts,
                       seed=0, device=args.device)
    dev, c = tr.device, tr.c
    loss_fn = functools.partial(d_loss_fn, c=c)
    for ep in range(args.epochs):
        m = tr.train_epoch(batches_per_client=args.batches_per_client)
        print(f"  ep {ep}: d={m['d_loss']:.3f} g={m['g_loss']:.3f}")
    params = tr.state.d_params[tr.client_ids[0]]

    # --- 2a. gradient inversion of the uplinked D gradient ---------------
    print(f"\n=== attack 1: gradient inversion (server-side, on {dev}) ===")
    victim = torch.as_tensor(parts["c0"][:1], device=dev)
    fake = 0.3 * keys.normal(keys.root(keys.DEFAULT, 3), victim.shape, dev)
    with fp32_convolutions(), torch.enable_grad():
        g = torch.func.grad(loss_fn)(params, victim, fake)
    rec, hist = invert_gradients(loss_fn, params, g, fake, victim.shape,
                                 steps=args.inversion_steps,
                                 key=keys.root(keys.DEFAULT, 7))
    clean = {"psnr": best_match_psnr(rec, victim), "ssim": ssim(rec, victim),
             "match_loss": hist[-1]}
    print(f"  reconstruction: PSNR={clean['psnr']:.2f}dB "
          f"SSIM={clean['ssim']:.3f} match_loss={clean['match_loss']:.4f}")

    # --- 2b. activation inversion at the split boundaries ----------------
    print("\n=== attack 2: activation inversion (LAN observer) ===")
    plan = next(iter(tr.plans.values()))
    depths = plan_boundary_depths(plan) or [1]
    aux, _ = synthetic_mnist(256, seed=5)          # attacker's shadow data
    probe = torch.as_tensor(parts["c0"][:16], device=dev)
    by_depth = {}
    for depth in sorted(set(depths)):
        atk = ActivationInversionAttack(make_prefix_fn(params, c, depth),
                                        (28, 28, 1), seed=0, device=dev)
        atk.train(aux, steps=args.decoder_steps, batch=32)
        rec_a = atk.reconstruct(probe)
        by_depth[depth] = {"psnr": psnr(rec_a, probe),
                           "dcor": distance_correlation(probe,
                                                        atk.prefix(probe))}
        print(f"  boundary depth {depth}: "
              f"PSNR={by_depth[depth]['psnr']:.2f}dB "
              f"dCor={by_depth[depth]['dcor']:.3f}")

    # --- 2c. membership inference on the trained D -----------------------
    print("\n=== attack 3: membership inference ===")
    nonmember, _ = synthetic_mnist(64, seed=99)
    mi = membership_inference(params, c, parts["c0"][:64], nonmember)
    print(f"  AUC={mi['auc']:.3f} advantage={mi['advantage']:.3f}")

    # --- 3. DP-SGD defense + re-attack ------------------------------------
    print(f"\n=== defense: DP-SGD (sigma={args.sigma}) ===")
    tr_dp = FSLGANTrainer(get_config("dcgan-mnist").override({
        **base, "privacy.enabled": True,
        "privacy.noise_multiplier": args.sigma,
        "privacy.sample_rate": 0.1, "privacy.use_kernel": True}), parts,
        seed=0, device=args.device)
    for ep in range(args.epochs):
        m = tr_dp.train_epoch(batches_per_client=args.batches_per_client)
        print(f"  ep {ep}: d={m['d_loss']:.3f} g={m['g_loss']:.3f} "
              f"epsilon={m['dp_epsilon']:.2f}")
    dp_params = tr_dp.state.d_params[tr_dp.client_ids[0]]
    per_ex = per_example_grads(loss_fn, dp_params, victim, fake)
    # the dp_clip kernel on the card; a CPU tensor takes its plain version
    g_dp = dp_clip_noise_tree(per_ex, 1.0, args.sigma,
                              keys.root(keys.DEFAULT, 11), use_kernel=True)
    rec_dp, _ = invert_gradients(loss_fn, dp_params, g_dp, fake,
                                 victim.shape, steps=args.inversion_steps,
                                 key=keys.root(keys.DEFAULT, 7))
    eps = tr_dp.accountant.epsilon(1e-5)[0]
    defended = {"psnr": best_match_psnr(rec_dp, victim), "epsilon": eps}
    print(f"  re-attack under DP: PSNR={defended['psnr']:.2f}dB "
          f"(vs {clean['psnr']:.2f}dB undefended) at epsilon={eps:.2f}")

    res = {"device": str(dev), "gradient_inversion": clean,
           "activation_inversion": {str(k): v for k, v in by_depth.items()},
           "membership": mi, "defended": defended}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "privacy_frontier.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
