"""Training launcher (port of ``repro/launch/train.py``).

Two modes:
  * ``--smoke``  reduced config — runs real steps on synthetic data and
    prints losses (what CI exercises).
  * full config — the same loop at the architecture's full size.

FSL mode (``--fsl N``) trains N per-client replicas with FedAvg every
``fsl.local_steps`` steps — the paper's cadence applied to an LM.

Runs on the GPU unless given ``--device cpu``.  Training takes the plain
attention and WKV paths: the hand-written kernels are forward-only.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --smoke --steps 20 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import keys
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import RunConfig, reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic_lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch.distributed import (log_topology,
                                            maybe_initialize_distributed)
from repro_torch.models.frontends import audio_frame_embeddings
from repro_torch.models.transformer import lm_init
from repro_torch.optim import make_optimizer
from repro_torch.runtime import make_fsl_train_step, make_train_step
from repro_torch.runtime.serve import _dtype
from repro_torch.tree import tree_map


def _replicas(tree, n: int):
    """``tree`` with a leading client axis of ``n`` (views, no copies: the
    steps never write into their inputs)."""
    return tree_map(lambda x: x[None].expand(n, *x.shape), tree)


def train_loop(cfg: RunConfig, steps: int, fsl_clients: int = 0,
               ckpt_dir: str = "", log_every: int = 1, seed: int = 0,
               device=None,
               on_step: Optional[Callable[[int, Any, Dict[str, Any], float],
                                          None]] = None):
    """``steps`` train steps from ``lm_init(seed)`` on synthetic batches
    (step ``i`` draws ``synthetic_lm_batch(seed=seed + i)``; whisper's
    frame embeddings from the ``keys.LM_DATA`` key of ``(seed, i)``).
    With ``fsl_clients`` > 0, that many stacked replicas take the FSL step.
    Checkpoints the parameters every 50 steps under ``ckpt_dir``.
    ``on_step(i, params, metrics, seconds)``, a measurement hook the
    reference has no counterpart of, runs after each step with the step's
    wall time (batch included): ``chip_smoke.py`` reads each step's wall
    and parameters through it, since its check that the warm step moved
    the parameters needs them between steps.  Returns (params, losses)."""
    m = cfg.model
    dev = resolve_device(device)
    params = lm_init(seed, m, _dtype(cfg.parallel.param_dtype), dev)
    opt = make_optimizer(cfg.optim)
    opt_state = opt.init(params)
    b, seq = cfg.shape.global_batch, cfg.shape.seq_len
    if m.encdec.enabled:
        seq = min(seq, m.encdec.max_target_positions)

    fsl = fsl_clients > 0
    if fsl:
        step_fn = make_fsl_train_step(cfg, fsl_clients)
        params = _replicas(params, fsl_clients)
        opt_state = _replicas(opt_state, fsl_clients)
    else:
        step_fn = make_train_step(cfg)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    history: List[float] = []
    t0 = time.time()
    for i in range(steps):
        ts = time.perf_counter()
        batch = synthetic_lm_batch(b * max(1, fsl_clients), seq,
                                   m.vocab_size, seed=seed + i)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if m.encdec.enabled:
            gen = keys.generator(keys.fold_in(keys.root(keys.LM_DATA, seed),
                                              i), dev)
            batch["enc_embeds"] = audio_frame_embeddings(
                gen, batch["tokens"].shape[0], m,
                _dtype(cfg.parallel.compute_dtype))
        if fsl:
            batch = tree_map(
                lambda x: x.reshape(fsl_clients, b, *x.shape[1:]), batch)
        params, opt_state, metrics = step_fn(params, opt_state, batch, i)
        loss = float(metrics["loss"])          # waits for the step
        history.append(loss)
        if i % log_every == 0:
            print(f"step {i:5d} loss={loss:.4f} "
                  f"aux={float(metrics['aux_loss']):.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if on_step is not None:
            on_step(i, params, metrics, time.perf_counter() - ts)
        if mgr and (i + 1) % 50 == 0:
            mgr.save(i + 1, params)
    return params, history


def main(argv: Optional[Sequence[str]] = None):
    if maybe_initialize_distributed():
        log_topology()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--smoke-seq", type=int, default=64)
    ap.add_argument("--smoke-batch", type=int, default=4)
    ap.add_argument("--fsl", type=int, default=0,
                    help="train N federated client replicas (FSL mode)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, args.shape)
    if args.smoke:
        cfg = reduce_for_smoke(cfg, seq_len=args.smoke_seq,
                               batch=args.smoke_batch)
    _, history = train_loop(cfg, args.steps, args.fsl, args.ckpt,
                            device=args.device)
    print(f"final loss {history[-1]:.4f} (from {history[0]:.4f})")
    return history


if __name__ == "__main__":
    main()
