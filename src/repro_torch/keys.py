"""Noise keys: the port's form of the JAX package's ``jax.random`` key
chains.

``jax.random`` streams cannot be reproduced in PyTorch, so the port keeps
the reference's *contract* instead of its bits: which noise a draw gets is
a function of a path of integers only (a seed, then round, client,
execution, batch, boundary ... indices).  A key is that path, a tuple of
ints; :func:`fold_in` extends it like ``jax.random.fold_in``, and
:func:`generator` turns it into a ``torch.Generator`` on the device that
draws, seeded from ``np.random.SeedSequence`` over the path.  The path's
length is hashed with it, so ``(1, 2)`` and ``(1, 2, 0)`` name different
streams.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Key = Tuple[int, ...]

# first element of every root key: the noise source, so that two sources
# seeded alike never share a stream
DP_SGD, UPLINK, STAGE, DEFAULT, ROSTER, LM_DATA = 1, 2, 3, 4, 5, 6


def root(source: int, seed: int) -> Key:
    """The root key of one noise source at ``seed``."""
    return (int(source), int(seed))


def fold_in(key: Key, *data: int) -> Key:
    """``key`` extended by ``data`` (non-negative ints)."""
    return tuple(key) + tuple(int(d) for d in data)


def seed_of(key: Key) -> int:
    """A 64-bit seed that depends on every element of ``key``."""
    ss = np.random.SeedSequence([len(key), *(int(k) for k in key)])
    return int(ss.generate_state(1, np.uint64)[0])


def generator(key: Key, device: Union[str, torch.device]) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded from ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(key))
    return g


def normal(key: Key, shape: Sequence[int],
           device: Union[str, torch.device]) -> torch.Tensor:
    """Standard normal fp32 of ``shape``, drawn on ``device`` from ``key``."""
    return torch.randn(tuple(shape), generator=generator(key, device),
                       device=device, dtype=torch.float32)
