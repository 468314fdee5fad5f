"""Flight-recorder trace walkthrough: run a federated split round with
tracing on, export Chrome-trace JSON and read it back, with the
watchtower's health alerts and per-round state digests beside the spans.
Twin of ``examples/trace_viewer_demo.py``.

The engine emits nested spans on its discrete-event virtual clock for
round -> downlink -> client execution -> batch -> split segment ->
boundary crossing -> uplink -> aggregate.  The exporter writes the
standard Chrome trace format, so the output opens in ``chrome://tracing``
or ui.perfetto.dev: one server track plus one track per client, with
every LAN boundary crossing (activation fwd, activation-grad bwd) inside
each batch.

Run: PYTHONPATH=src python -m repro_torch.examples.trace_viewer_demo
     [--device cpu]
     -> writes <out>/obs_runs/trace-demo/trace.json
"""
import argparse
import json
import os
from collections import Counter
from typing import Dict, List, Optional

from repro_torch.configs.registry import get_config
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.data import partition_dirichlet, synthetic_mnist
from repro_torch.obs import validate_chrome_trace

OUT = os.path.join("experiments", "gan_torch")
CLIENTS = 2


def main(argv: Optional[List[str]] = None) -> Dict[str, int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--base-filters", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    cfg = get_config("dcgan-mnist").override({
        "shape.global_batch": args.batch_size,
        "fsl.num_clients": CLIENTS,
        "model.dcgan.base_filters": args.base_filters,
        "split.enabled": True,
        "fed.client_local_steps": {"c1": 2},   # a visible straggler tail
        "obs.enabled": True,
        "obs.out_dir": os.path.join(args.out, "obs_runs"),
        "obs.run_id": "trace-demo",
        # numeric-health monitors on every round, warn-only policy — a
        # healthy demo prints zero alerts
        "obs.health.enabled": True,
        "obs.health.policy": "warn",
    })
    imgs, labels = synthetic_mnist(60 * CLIENTS, seed=0)
    parts = partition_dirichlet(imgs, labels, CLIENTS, alpha=0.5, seed=0)
    tr = FSLGANTrainer(cfg, parts, seed=0, device=args.device)

    print(f"== {args.rounds} traced federated split rounds on {tr.device} ==")
    for _ in range(args.rounds):
        m = tr.train_epoch(batches_per_client=2)
        print(f"  d_loss {m['d_loss']:.4f}  round {m['round_time_s']:.1f}s "
              f"(virtual)")
    tr.recorder.flush()

    trace_path = tr.recorder.path("trace.json")
    with open(trace_path) as f:
        n = validate_chrome_trace(json.load(f))
    print(f"\n== {trace_path}: {n} events, schema-valid ==")
    cats = Counter(s.cat for s in tr.recorder.tracer.spans)
    for cat in ("round", "downlink", "client", "batch", "segment",
                "boundary", "uplink", "aggregate"):
        print(f"  {cat:>9}: {cats.get(cat, 0):>3} spans")

    print("\n== one batch, span by span (virtual clock) ==")
    tracer = tr.recorder.tracer
    batch = min(tracer.by_cat("batch"), key=lambda s: s.v_start)
    print(f"  {batch.name} on {batch.track}: "
          f"[{batch.v_start:.2f}, {batch.v_end:.2f}]s")
    for child in sorted(tracer.children(batch.span_id),
                        key=lambda s: s.v_start):
        tag = (f" ({child.args.get('direction')} b"
               f"{child.args.get('boundary')})"
               if child.cat == "boundary" else "")
        print(f"    {child.v_start:9.3f} -> {child.v_end:9.3f}  "
              f"{child.cat:>8}  {child.name}{tag}")

    print("\n== watchtower: health alerts + state digests ==")
    for a in tr.health_alerts:
        print(f"  round {a.round_index} [{a.severity:>5}] "
              f"{a.check}: {a.message}")
    if not tr.health_alerts:
        print("  no health alerts (all monitors quiet — see alerts.jsonl "
              "for the persisted record)")
    for d in tr.recorder.digests:
        print(f"  round {d.round_index} global digest {d.global_digest} "
              f"l2={d.global_sketch[0]:.4f}"
              f"{'  (ROLLED BACK)' if d.rolled_back else ''}")

    print(f"\nopen {trace_path} in chrome://tracing or ui.perfetto.dev — "
          "pid 1 is the virtual clock, one thread per client track.")
    return {"events": n, **cats}


if __name__ == "__main__":
    main()
