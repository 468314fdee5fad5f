"""Serving launcher: batched prefill + greedy decode with a simple request
queue (port of ``repro/launch/serve.py``).

Requests arrive with different prompt lengths, are left-padded with token
0 into one batch (no padding mask, as in the reference), prefilled in one
pass, then decoded token by token with greedy sampling.  Runs on the GPU
unless given ``device="cpu"``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --smoke --requests 4 --gen-tokens 16
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import RunConfig, reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.models.frontends import audio_frame_embeddings
from repro_torch.models.transformer import lm_init
from repro_torch.runtime import make_decode_step, make_prefill_step
from repro_torch.runtime.serve import _dtype


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (L,) int32
    generated: List[int] = None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_batch(cfg: RunConfig, requests: List[Request], gen_tokens: int,
                seed: int = 0, verbose: bool = True, *, device=None,
                params=None, enc_embeds: Optional[torch.Tensor] = None):
    """Serve ``requests`` as one batch: prefill, then ``gen_tokens`` greedy
    decode steps; each request's tokens land in ``generated``.  Parameters
    come from ``lm_init(seed)`` on ``device`` unless ``params`` (the same
    tree, already on the device) is given.  An encoder-decoder model's
    frame embeddings (B, S_enc, d) are drawn from a generator seeded with
    ``seed`` unless ``enc_embeds`` is given."""
    m = cfg.model
    dev = resolve_device(device)
    with torch.no_grad():
        if params is None:
            params = lm_init(seed, m, _dtype(cfg.parallel.param_dtype), dev)
        max_len = max(len(r.prompt) for r in requests)
        cache_len = max_len + gen_tokens
        prefill = make_prefill_step(
            cfg.override({"shape.seq_len": cache_len}))
        decode = make_decode_step(cfg)

        batch_tokens = np.zeros((len(requests), max_len), np.int32)
        for i, r in enumerate(requests):
            batch_tokens[i, max_len - len(r.prompt):] = r.prompt  # left-pad
        batch = {"tokens": torch.as_tensor(batch_tokens, device=dev)}
        if m.encdec.enabled:
            if enc_embeds is None:
                enc_embeds = audio_frame_embeddings(
                    torch.Generator(device=dev).manual_seed(int(seed)),
                    len(requests), m)
            batch["enc_embeds"] = enc_embeds.to(dev)

        t0 = time.time()
        logits, state, index = prefill(params, batch)
        next_tok = torch.argmax(logits, dim=-1)
        _sync(dev)
        prefill_s = time.time() - t0

        for r in requests:
            r.generated = []
        t0 = time.time()
        idx = int(index)
        for step in range(gen_tokens):
            for r, tok in zip(requests, next_tok.tolist()):
                r.generated.append(int(tok))
            logits, state = decode(params, next_tok, state, idx + step)
            next_tok = torch.argmax(logits, dim=-1)
        _sync(dev)
        decode_s = time.time() - t0
    if verbose:
        tps = gen_tokens * len(requests) / max(decode_s, 1e-9)
        print(f"prefill: {prefill_s:.2f}s for {len(requests)}x{max_len} tokens")
        print(f"decode:  {decode_s:.2f}s for {gen_tokens} steps "
              f"({tps:.1f} tok/s batch throughput)")
        for r in requests:
            print(f"  req {r.rid}: prompt[-5:]={r.prompt[-5:].tolist()} "
                  f"-> {r.generated[:10]}...")
    return requests


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, "decode_32k")
    if args.smoke:
        cfg = reduce_for_smoke(cfg, seq_len=64, batch=args.requests)
    rng = np.random.default_rng(0)
    reqs = [Request(i, synthetic_tokens(1, int(rng.integers(8, 33)),
                                        cfg.model.vocab_size, seed=i)[0])
            for i in range(args.requests)]
    serve_batch(cfg, reqs, args.gen_tokens, device=args.device)


if __name__ == "__main__":
    main()
