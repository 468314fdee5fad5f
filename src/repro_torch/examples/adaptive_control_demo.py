"""Closed-loop control walkthrough: measure -> decide -> retune, every
round, with the flight recorder keeping the books.  Twin of
``examples/adaptive_control_demo.py``.

Four controllers run together on one federated split-GAN run:

  codec    — probes the uplink-codec frontier cheapest-first and commits
             to the cheapest codec whose measured delta error fits the
             budget (watch the codec column change);
  sigma    — spends a total (epsilon, delta) DP budget over the horizon by
             inverting the RDP curve each round (epsilon climbs TO the
             budget, never past it);
  split    — replans device selection when measured load imbalance drifts
             and noises only the boundaries whose measured dCor says they
             leak;
  deadline — sets the sync straggler deadline at a quantile of the
             measured per-client finish-time distribution.

Every round's RoundFeedback and the knob decision it produced land in the
flight recorder (``repro_torch.obs``): the table below is rendered from
the recorder's typed metrics registry, and at the end the recorded
feedback JSONL is replayed OFFLINE through the same pure controllers,
reproducing the live knob sequence bit for bit.

Run: PYTHONPATH=src python -m repro_torch.examples.adaptive_control_demo
     [--device cpu]
     -> writes <out>/obs_runs/adaptive-demo/{feedback,knobs,metrics}.jsonl
        and trace.json
"""
import argparse
import os
from typing import List, Optional

from repro_torch.configs.registry import get_config
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.data import partition_dirichlet, synthetic_mnist
from repro_torch.obs import ReplayResult, load_run, replay_run

OUT = os.path.join("experiments", "gan_torch")
CLIENTS = 2
EPS_BUDGET = 4.0


def main(argv: Optional[List[str]] = None) -> ReplayResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--base-filters", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    cfg = get_config("dcgan-mnist").override({
        "shape.global_batch": args.batch_size,
        "fsl.num_clients": CLIENTS,
        "fsl.selection": "random_single",      # deliberately imbalanced
        "model.dcgan.base_filters": args.base_filters,
        "split.enabled": True,
        "split.stage_clip": 5.0,
        "split.stage_sigma": 0.5,
        "privacy.enabled": True,
        "privacy.mode": "uplink",
        "privacy.noise_multiplier": 1.0,
        "fed.client_local_steps": {"c1": 3},   # a built-in straggler
        "control.mode": "adaptive",
        "control.controllers": ["codec", "sigma", "split", "deadline"],
        "control.error_budget": 0.05,
        "control.epsilon_budget": EPS_BUDGET,
        "control.horizon_rounds": args.rounds,
        "control.imbalance_threshold": 1.2,
        "control.dcor_threshold": 0.3,
        "control.deadline_quantile": 0.5,
        "control.deadline_slack": 1.6,
        "control.probe_batch": 8,
        "obs.enabled": True,
        "obs.out_dir": os.path.join(args.out, "obs_runs"),
        "obs.run_id": "adaptive-demo",
    })
    imgs, labels = synthetic_mnist(60 * CLIENTS, seed=0)
    parts = partition_dirichlet(imgs, labels, CLIENTS, alpha=0.5, seed=0)
    tr = FSLGANTrainer(cfg, parts, seed=0, device=args.device)
    reg = tr.recorder.registry

    print(f"== {args.rounds} adaptive rounds on {tr.device}, recorded "
          f"(eps budget {EPS_BUDGET}, error budget 0.05) ==")
    print(f"{'r':>2} {'codec':>6} {'err':>7} {'up_kB':>7} {'sigma':>6} "
          f"{'eps':>6} {'deadline':>9} {'straggl':>7}")
    up_prev = 0
    for r in range(args.rounds):
        tr.train_epoch(batches_per_client=1)
        # every column reads the recorder's typed registry — the same
        # numbers metrics.jsonl persists for offline tooling
        fb, k = tr.feedback[-1], tr.knobs
        up = reg["wire.up_bytes"].value
        print(f"{r:>2} {k.codec:>6} {reg['codec.rel_error'].value:7.4f} "
              f"{(up - up_prev) / 1e3:7.1f} {fb.sigma:6.2f} "
              f"{reg['privacy.epsilon'].value:6.3f} {k.deadline_s:9.1f} "
              f"{reg['fed.straggler_drops'].value:7.0f}")
        up_prev = up
    if reg["privacy.epsilon"].value > EPS_BUDGET:
        raise RuntimeError("the sigma controller overspent the budget")
    tr.recorder.flush()

    print("\n== the registry after the run (metrics.jsonl, last line) ==")
    print(tr.recorder.render_summary())

    print("== offline replay of the recorded run ==")
    run_dir = tr.recorder.run_dir
    res = replay_run(run_dir)
    print(f"  {run_dir}: {load_run(run_dir).num_rounds} rounds of "
          f"RoundFeedback")
    print(f"  replayed through the pure controller fold: matches the live "
          f"decisions bit for bit = {res.matches}")
    for r, k in enumerate(res.decisions):
        stages = dict(sorted((k.stage_by_boundary or {}).items()))
        print(f"  r{r}: codec={k.codec:>5} sigma={k.sigma:.3f} "
              f"deadline={k.deadline_s:7.1f} stages={stages or '{}'}")
    if not res.matches:
        raise RuntimeError("replay diverged: " + "; ".join(res.diff()))

    print("\nfields -> controllers: codec/up_bytes/codec_error -> codec; "
          "sigma/dp_steps/dp_epsilon -> sigma; device_loads/boundary_dcor "
          "-> split; client_finish_s -> deadline.  Tune a controller by "
          "editing it and re-running replay_run() on this directory — no "
          "training required.")
    return res


if __name__ == "__main__":
    main()
