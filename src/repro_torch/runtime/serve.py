"""Serving-step builders: prefill and single-token decode (port of
``repro/runtime/serve.py``).

``decode`` is ONE new token against a populated cache of
``shape.seq_len`` positions.  PyTorch runs eagerly, so a step is the plain
function the reference hands to ``jax.jit``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config import RunConfig
from repro_torch.models.transformer import lm_decode_step, lm_prefill


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def cache_length(cfg: RunConfig) -> int:
    """Decode-cache length for the configured shape (window-aware archs clip
    inside block_state_init)."""
    return cfg.shape.seq_len


def make_prefill_step(cfg: RunConfig) -> Callable:
    m = cfg.model
    cd = _dtype(cfg.parallel.compute_dtype)
    cache_dt = _dtype(cfg.parallel.cache_dtype)
    clen = cache_length(cfg)

    def prefill(params, batch):
        return lm_prefill(params, batch, m, clen, cd, cache_dt,
                          remat=cfg.parallel.remat,
                          scan_layers=cfg.parallel.scan_layers)

    return prefill


def make_decode_step(cfg: RunConfig) -> Callable:
    m = cfg.model
    cd = _dtype(cfg.parallel.compute_dtype)

    def decode(params, token, state, index):
        return lm_decode_step(params, token, state, index, m, cd,
                              scan_layers=cfg.parallel.scan_layers)

    return decode
