"""Stub modality frontends (port of ``repro/models/frontends.py``).

[audio]  whisper's mel-spectrogram + 2xConv1d feature extractor is replaced
         by precomputed frame embeddings of shape (B, encoder_seq, d_model).
[vlm]    chameleon's VQ-VAE image tokenizer is replaced by synthetic VQ token
         ids interleaved with text ids in one sequence (early fusion means
         the transformer itself is modality-agnostic).

Both draw from an explicit ``torch.Generator`` (on the device the tensors
are made on), so a seed gives other numbers than the reference's
``jax.random`` keys; the shapes, ranges and layout are the reference's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ModelConfig


def audio_frame_embeddings(gen: torch.Generator, batch: int, m: ModelConfig,
                           dtype=torch.float32) -> torch.Tensor:
    """Stub for mel+conv frontend output: (B, S_enc, d)."""
    return (0.1 * torch.randn((batch, m.encdec.encoder_seq, m.d_model),
                              generator=gen, device=gen.device,
                              dtype=torch.float32)).to(dtype)


def vlm_interleave(gen: torch.Generator, batch: int, seq_len: int,
                   m: ModelConfig, image_span: int = 256,
                   text_vocab_frac: float = 0.75
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Early-fusion token stream: text ids + one VQ image span per sequence.

    Returns (tokens (B,S) int32, modality_mask (B,S) bool — True on image
    tokens).  VQ codes live in the top (1 - text_vocab_frac) of the vocab,
    mirroring chameleon's shared-codebook layout."""
    v = m.vocab_size
    text_hi = int(v * text_vocab_frac)
    dev = gen.device
    text = torch.randint(0, text_hi, (batch, seq_len), generator=gen,
                         device=dev)
    vq = torch.randint(text_hi, v, (batch, seq_len), generator=gen,
                       device=dev)
    span = min(image_span, seq_len // 2)
    start = torch.randint(0, max(seq_len - span, 1), (batch, 1),
                          generator=gen, device=dev)
    pos = torch.arange(seq_len, device=dev)[None, :]
    mask = (pos >= start) & (pos < start + span)
    return torch.where(mask, vq, text).to(torch.int32), mask
