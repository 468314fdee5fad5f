"""Executed split training walkthrough: plan -> run the round THROUGH the
split -> measure what it cost and what it leaked.  Twin of
``examples/split_training_demo.py``.

Each client's discriminator trains device segment by device segment, every
boundary tensor (activation forward, activation-grad backward) crosses the
LAN through the configured boundary stage, and the round reports measured
per-device load + LAN bytes, rendered from the flight recorder's metrics
registry (the numbers ``metrics.jsonl`` carries); the run leaves a
Chrome-trace file with one span per boundary crossing (see
``trace_viewer_demo``).  A final readout attacks the tensors the round
actually shipped (post-stage), per boundary, for the identity, int8, dp and
fused int8+dp stages (the last through the boundary_fuse CUDA kernel on
the card).

Run: PYTHONPATH=src python -m repro_torch.examples.split_training_demo
     [--device cpu]
     -> writes <out>/obs_runs/split-demo-*/{metrics,feedback}.jsonl +
        trace.json and <out>/split_training.json
"""
import argparse
import json
import os
from typing import Dict, List, Optional

import torch

from repro_torch import keys
from repro_torch.configs.registry import get_config
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.core.split import partition_params
from repro_torch.data import partition_dirichlet, synthetic_mnist
from repro_torch.fed.transport import tree_bytes
from repro_torch.privacy import (ActivationInversionAttack, best_match_psnr,
                                 distance_correlation, make_shipped_prefix_fn)

OUT = os.path.join("experiments", "gan_torch")
CLIENTS = 2
STAGES = ("identity", "int8", "dp", "int8+dp")


def build_trainer(args, stage: str) -> FSLGANTrainer:
    cfg = get_config("dcgan-mnist").override({
        "shape.global_batch": args.batch_size,
        "fsl.num_clients": CLIENTS,
        "model.dcgan.base_filters": args.base_filters,
        "split.enabled": True,
        "split.boundary_stage": stage,
        "split.stage_clip": 5.0,
        "split.stage_sigma": 0.5,
        "split.use_kernel": True,
        "obs.enabled": True,
        "obs.out_dir": os.path.join(args.out, "obs_runs"),
        "obs.run_id": f"split-demo-{stage}",
    })
    imgs, labels = synthetic_mnist(60 * CLIENTS, seed=0)
    parts = partition_dirichlet(imgs, labels, CLIENTS, alpha=0.5, seed=0)
    return FSLGANTrainer(cfg, parts, seed=0, device=args.device)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=2,
                    help="batches per client in the round")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--base-filters", type=int, default=8)
    ap.add_argument("--decoder-steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    tr = build_trainer(args, "identity")

    print(f"== the plans the round will EXECUTE (on {tr.device}) ==")
    for cid, plan in tr.plans.items():
        route = " -> ".join(f"{p.device_id}[{','.join(p.layer_names)}]"
                            for p in plan.portions)
        ex = tr.split_execs[cid]
        print(f"  {cid}: {route}  ({ex.num_boundaries} LAN boundaries, "
              f"signature {ex.signature[0]})")

    print("\n== one federated round, trained through the split ==")
    tr.train_epoch(batches_per_client=args.batches)
    reg = tr.recorder.registry
    print(f"  d_loss {reg['gan.d_loss'].value:.4f}  "
          f"g_loss {reg['gan.g_loss'].value:.4f}")
    print(f"  round time      {reg['fed.round_time_s'].value:.1f}s "
          f"(virtual, priced from MEASURED boundary bytes)")
    print(f"  LAN boundary    {reg['wire.lan_bytes'].value / 1e6:.3f} MB "
          f"shipped this round")
    print(f"  WAN up/down     {reg['wire.up_bytes'].value / 1e6:.3f} / "
          f"{reg['wire.down_bytes'].value / 1e6:.3f} MB")
    print("  per-client wire (ledger observer -> registry):")
    for cid in sorted(tr._active_clients()):
        print(f"    {cid}: up {reg[f'wire.client.{cid}.up_bytes'].value:>9.0f} B"
              f"  lan {reg[f'wire.client.{cid}.lan_bytes'].value:>9.0f} B")

    print("\n== the RoundFeedback the round emitted "
          "(recorded to feedback.jsonl; what the split controller reads) ==")
    fb = tr.recorder.feedback[-1]
    print(f"  lan_bytes={fb.lan_bytes}  up_bytes={fb.up_bytes}  "
          f"round_time_s={fb.round_time_s:.1f}")
    print(f"  device_loads (imbalance drift -> replan): "
          f"{ {k: round(v) for k, v in fb.device_loads.items()} }")
    print(f"  client_finish_s (deadline controller): "
          f"{ {k: round(v, 1) for k, v in fb.client_finish_s.items()} }")
    print("  boundary_dcor fills in under control.mode='adaptive' "
          "(adaptive_control_demo)")
    tr.recorder.flush()
    print(f"  trace with per-boundary spans -> "
          f"{tr.recorder.path('trace.json')}")

    print("\n== per-device load (compute units / resident D params) ==")
    param_bytes: Dict[str, int] = {}
    for cid, plan in tr.plans.items():
        parts = partition_params(plan, tr.state.d_params[cid])
        for portion, sub in zip(plan.portions, parts):
            param_bytes[portion.device_id] = \
                param_bytes.get(portion.device_id, 0) + tree_bytes(sub)
    for dev, load in sorted(tr.device_load_report().items()):
        print(f"  {dev:8s} {load:12.0f} units  "
              f"{param_bytes.get(dev, 0) / 1e3:8.1f} kB params")

    print("\n== boundary leakage of the tensors the round ACTUALLY ships ==")
    aux, _ = synthetic_mnist(48, seed=5)
    victim, _ = synthetic_mnist(16, seed=9)
    aux = torch.as_tensor(aux, device=tr.device)
    victim = torch.as_tensor(victim, device=tr.device)
    leakage = []
    for stage in STAGES:
        t = tr if stage == "identity" else build_trainer(args, stage)
        if stage != "identity":
            t.train_epoch(batches_per_client=args.batches)
        cid = max(t._active_clients(),
                  key=lambda c: t.split_execs[c].num_boundaries)
        ex = t.split_execs[cid]
        d_params = t.state.d_params[cid]
        for b in range(ex.num_boundaries):
            prefix = make_shipped_prefix_fn(ex, d_params, b,
                                            key=keys.root(keys.DEFAULT, 13))
            atk = ActivationInversionAttack(prefix, (28, 28, 1), width=16,
                                            device=t.device)
            atk.train(aux, steps=args.decoder_steps, batch=16)
            psnr = best_match_psnr(atk.reconstruct(victim), victim)
            dcor = distance_correlation(victim, prefix(victim))
            wire = ex.stages[b].wire_bytes(ex.boundary_shapes(
                d_params, (t.batch_size,) + tuple(victim.shape[1:]))[b])
            leakage.append({"stage": stage, "boundary": b,
                            "depth": ex.boundaries[b].depth, "dcor": dcor,
                            "psnr": psnr, "wire_bytes": int(wire)})
            print(f"  stage={stage:8s} boundary {b} "
                  f"(depth {ex.boundaries[b].depth}): "
                  f"dCor={dcor:.3f}  inversion PSNR={psnr:5.2f} dB  "
                  f"wire={wire} B/pass")
    print("\nlossier/noisier stages ship fewer recoverable bits across the "
          "LAN — the trade the paper's privacy claim rests on, measured on "
          "the executed round.")
    res = {"device": str(tr.device), "lan_bytes": int(fb.lan_bytes),
           "up_bytes": int(fb.up_bytes), "leakage": leakage}
    with open(os.path.join(args.out, "split_training.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
