"""Input generator ``lm_tokens``: batches of token ids for a language
model's training step, from the run's seed and the traffic file alone."""
from __future__ import annotations

from typing import Any, Dict

import torch

from perfbench.common import subseed


def make(spec: Dict[str, Any], seed: int, vocab: int,
         device) -> torch.Tensor:
    """``distinct_batches`` batches of token ids, (n, batch, seq_len + 1),
    drawn uniformly from the vocabulary on the device in one call: inputs
    are ``[..., :-1]`` and labels ``[..., 1:]``.  Every row differs."""
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, 2))
    shape = (int(spec["distinct_batches"]), int(spec["batch"]),
             int(spec["seq_len"]) + 1)
    return torch.randint(0, int(vocab), shape, generator=g, device=device,
                         dtype=torch.int64)
