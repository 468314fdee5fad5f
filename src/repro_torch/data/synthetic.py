"""Deterministic synthetic datasets (numpy copy of ``repro/data/synthetic.py``).

``synthetic_mnist`` draws class-conditional 28x28 digit-like blobs: each of
the 10 classes is a fixed mixture of 3 gaussian strokes, so (a) classes are
visually distinct, (b) a generator must actually learn per-class structure,
and (c) non-IID federated partitions (by label) are meaningful.  Given the
same seed it returns the same arrays as the JAX package's copy.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _class_prototype(label: int, size: int = 28) -> np.ndarray:
    rng = np.random.default_rng(1234 + label)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size), np.float32)
    for _ in range(3):
        cx, cy = rng.uniform(0.25, 0.75, 2)
        sx, sy = rng.uniform(0.05, 0.18, 2)
        rot = rng.uniform(0, np.pi)
        dx, dy = xx - cx, yy - cy
        rx = dx * np.cos(rot) + dy * np.sin(rot)
        ry = -dx * np.sin(rot) + dy * np.cos(rot)
        img += np.exp(-(rx ** 2 / (2 * sx ** 2) + ry ** 2 / (2 * sy ** 2)))
    return img / img.max()


_PROTOS: Dict[Tuple[int, int], np.ndarray] = {}


def synthetic_mnist(n: int, seed: int = 0, size: int = 28
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """-> images (N, size, size, 1) float32 in [-1, 1], labels (N,) int32."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    imgs = np.empty((n, size, size, 1), np.float32)
    for lbl in range(10):
        if (lbl, size) not in _PROTOS:
            _PROTOS[(lbl, size)] = _class_prototype(lbl, size)
        sel = labels == lbl
        k = int(sel.sum())
        if k == 0:
            continue
        base = _PROTOS[(lbl, size)][None]
        # per-sample jitter: shift + intensity + noise
        shift = rng.integers(-2, 3, (k, 2))
        amp = rng.uniform(0.8, 1.2, (k, 1, 1)).astype(np.float32)
        noise = rng.normal(0, 0.05, (k, size, size)).astype(np.float32)
        batch = np.repeat(base, k, 0)
        for i in range(k):
            batch[i] = np.roll(np.roll(batch[i], shift[i, 0], 0),
                               shift[i, 1], 1)
        batch = np.clip(batch * amp + noise, 0, 1)
        imgs[sel, :, :, 0] = batch * 2.0 - 1.0
    return imgs, labels


def synthetic_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int = 0
                     ) -> np.ndarray:
    """Markov-ish token streams so an LM has learnable structure."""
    rng = np.random.default_rng(seed)
    # block-structured transition: token t+1 ~ near t with high prob
    toks = np.empty((n_seqs, seq_len), np.int32)
    cur = rng.integers(0, vocab, n_seqs)
    for t in range(seq_len):
        toks[:, t] = cur
        jump = rng.random(n_seqs) < 0.1
        step = rng.integers(1, 17, n_seqs)
        cur = np.where(jump, rng.integers(0, vocab, n_seqs),
                       (cur + step) % vocab)
    return toks


def synthetic_lm_batch(batch: int, seq_len: int, vocab: int, seed: int = 0
                       ) -> Dict[str, np.ndarray]:
    toks = synthetic_tokens(batch, seq_len + 1, vocab, seed)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
