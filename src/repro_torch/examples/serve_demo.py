"""Batched serving demo: prefill a mixed-length request batch, then greedy
decode — the serving path at smoke scale.  Twin of
``examples/serve_demo.py``.

The generated tokens land in ``serve.json`` under ``--out``.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_demo
     [--arch rwkv6-1.6b] [--device cpu]
"""
import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

from repro_torch.config import reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic_tokens
from repro_torch.launch.serve import Request, serve_batch

OUT = os.path.join("experiments", "gan_torch")


def main(argv: Optional[List[str]] = None) -> Dict[int, List[int]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--gen-tokens", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    cfg = reduce_for_smoke(get_config(args.arch, "decode_32k"), seq_len=64,
                           batch=args.requests)
    rng = np.random.default_rng(0)
    reqs = [Request(i, synthetic_tokens(1, int(rng.integers(8, 33)),
                                        cfg.model.vocab_size, seed=i)[0])
            for i in range(args.requests)]
    serve_batch(cfg, reqs, args.gen_tokens, device=args.device)
    tokens = {r.rid: r.generated for r in reqs}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "serve.json"), "w") as f:
        json.dump({"arch": args.arch, "tokens": tokens}, f, indent=2)
    return tokens


if __name__ == "__main__":
    main()
