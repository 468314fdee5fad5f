"""Compressed-domain aggregation over encoded uplinks.  Port of
``repro/fed/aggregate.py`` (single device: the client mesh for the batched
reduce waits for ROADMAP Queue A item 7).

The decode-then-fedavg server reduce stages one decoded fp32 tree per
client before averaging: O(C) server memory and an extra full
materialization per uplink.  This module folds each uplink's WIRE payload
(``Codec.encode_tree`` output) straight into one fp32 accumulator through
the ``kernels/agg_fuse`` ops:

  * :class:`StreamingAggregator` — ``init / fold / finalize``: the engine
    folds each landed uplink as it arrives and holds one accumulator tree
    and a weight sum, whatever the cohort size.  ``fold`` also measures the
    codec's relative L2 error against the raw delta in the same sweep;
  * :func:`codec_rel_error` — that error alone, for executed-but-late
    stragglers whose update never folds;
  * :func:`decode_enc` / :func:`fused_decode_apply` — decode (and rebase)
    one encoded uplink, used by the async path at ARRIVE time so FINISH
    events queue wire payloads instead of decoded trees;
  * :func:`batched_reduce` — a whole round's wires reduced per leaf in one
    ``dequant_reduce`` call (dense codecs) or one decode of the stacked
    client axis (top-k, plain torch as the reference's is plain JAX).

A weighted mean of rebased updates equals the base plus the weighted mean
of the deltas exactly in real arithmetic but only to rounding in float, so
every stream-vs-decode comparison is at a tolerance, never bit for bit.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.fed.transport import apply_delta
from repro_torch.kernels.agg_fuse.ops import (dequant_acc_flat,
                                              dequant_reduce_flat,
                                              scatter_acc_leaves)
from repro_torch.tree import leaves, unflatten_like

__all__ = ["StreamingAggregator", "batched_reduce", "codec_rel_error",
           "decode_enc", "fused_decode_apply"]

EncTree = List[Tuple[Any, Any]]          # per-leaf (wire, meta), leaves order


def _norm(name: str) -> str:
    return "none" if name in ("none", "", "identity") else name


def decode_enc(codec_name: str, enc: EncTree, template):
    """Decode one encoded uplink back to a tree in ``template``'s structure
    — leaf for leaf what ``Codec.roundtrip`` decodes."""
    name = _norm(codec_name)
    out = []
    for (wire, meta), t in zip(enc, leaves(template)):
        if name == "none":
            out.append(wire)             # identity: the leaf itself
        elif name == "topk":
            vals, idx = wire
            dense = torch.zeros((t.numel(),), dtype=torch.float32,
                                device=vals.device)
            dense[idx.long()] = vals
            out.append(dense.reshape(t.shape))
        elif name == "int8":
            out.append((wire.to(torch.float32) * meta).reshape(t.shape))
        else:                            # fp16 (or any plain cast wire)
            out.append(wire.to(torch.float32).reshape(t.shape))
    return unflatten_like(template, out)


def fused_decode_apply(codec_name: str, base, enc: EncTree):
    """Decode an encoded DELTA uplink and rebase it onto ``base`` — what the
    async path applies per arrival."""
    return apply_delta(base, decode_enc(codec_name, enc, base))


def _leaf_error(name: str, wire, meta, d: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(squared error, squared norm) of one leaf's wire vs its raw delta
    ``d``, fp32 on the device.  Top-k never densifies: its error is the
    dropped mass plus the error on the support."""
    f = d.to(torch.float32).reshape(-1)
    ff = torch.sum(f * f)
    if name == "topk":
        vals, idx = wire
        dv = f[idx.long()]
        return ff - torch.sum(dv * dv) + torch.sum((vals - dv) ** 2), ff
    dec = wire.to(torch.float32).reshape(-1)
    if name == "int8":
        dec = dec * meta
    return torch.sum((dec - f) ** 2), ff


def _rel(num: torch.Tensor, den: torch.Tensor) -> float:
    """The relative error from fp32 sums (the one host read per call)."""
    return math.sqrt(max(float(num), 0.0)) / max(math.sqrt(float(den)),
                                                 1e-12)


def codec_rel_error(codec_name: str, enc: EncTree, delta) -> float:
    """Relative global-L2 error of the encoded uplink vs the raw delta — the
    decode-free form of ``transport.tree_rel_error``."""
    name = _norm(codec_name)
    if name == "none" or delta is None:
        return 0.0
    num = den = 0.0
    for (wire, meta), d in zip(enc, leaves(delta)):
        n, f = _leaf_error(name, wire, meta, d)
        num, den = num + n, den + f
    return _rel(num, den)


class StreamingAggregator:
    """Weighted mean over encoded uplinks in constant memory.

    ``init(template)`` allocates one zero fp32 accumulator per leaf;
    ``fold(enc, weight)`` adds ``weight * dequant(enc)`` through the
    agg_fuse ops (top-k wires scatter straight into the dense accumulators,
    every leaf in one ``scatter_acc_leaves`` call);
    ``finalize()`` divides by the folded weight sum and restores leaf
    shapes and dtypes.  The accumulator is the only decoded tree alive,
    however many uplinks fold.  ``use_kernel`` sends CUDA accumulators
    through the CUDA kernels.
    """

    def __init__(self, codec_name: str, *, use_kernel: bool = False):
        self.codec_name = _norm(codec_name)
        self.use_kernel = bool(use_kernel)
        self._acc: Optional[List[torch.Tensor]] = None
        self._template = None
        self.wsum = 0.0
        self.folds = 0

    def init(self, template) -> None:
        """``template``: any tree with the uplink's structure and leaf
        shapes (the global tree serves delta and param wires alike)."""
        self._template = template
        self._acc = [torch.zeros((l.numel(),), dtype=torch.float32,
                                 device=l.device) for l in leaves(template)]
        self.wsum = 0.0
        self.folds = 0

    def fold(self, enc: EncTree, weight: float,
             delta=None) -> Optional[float]:
        """Fold one encoded uplink with fedavg weight ``weight``.  Given the
        raw ``delta`` tree, the codec's relative L2 error is measured in the
        same per-leaf sweep and returned (one host read per fold)."""
        if self._acc is None:
            raise RuntimeError("fold() before init()")
        w = float(weight)
        name = self.codec_name
        want_err = delta is not None and name != "none"
        dleaves = leaves(delta) if want_err else [None] * len(enc)
        if name == "topk":                 # every leaf in one call
            self._acc = scatter_acc_leaves(
                self._acc, [wire[0] for wire, _ in enc],
                [wire[1] for wire, _ in enc], w, use_kernel=self.use_kernel)
        else:
            for i, (wire, meta) in enumerate(enc):
                scale = meta if name == "int8" else 1.0
                self._acc[i] = dequant_acc_flat(
                    self._acc[i], wire.reshape(-1), scale, w,
                    use_kernel=self.use_kernel)
        num = den = 0.0
        if want_err:
            for (wire, meta), d in zip(enc, dleaves):
                n, f = _leaf_error(name, wire, meta, d)
                num, den = num + n, den + f
        self.wsum += w
        self.folds += 1
        if delta is None:
            return None
        if name == "none":
            return 0.0
        return _rel(num, den)

    def finalize(self):
        """Weighted mean tree (template structure, shapes and dtypes), or
        None when nothing folded."""
        if self._acc is None or self.folds == 0 or self.wsum <= 0.0:
            return None
        inv = 1.0 / self.wsum
        out = [(a * inv).reshape(t.shape).to(t.dtype)
               for a, t in zip(self._acc, leaves(self._template))]
        return unflatten_like(self._template, out)


def _topk_batched_mean(vals: torch.Tensor, idx: torch.Tensor,
                       weights: torch.Tensor, n: int) -> torch.Tensor:
    """Decode of the stacked client axis, then the weighted mean — the
    top-k leaves' batched form."""
    w = (weights / torch.sum(weights)).to(torch.float32)
    dense = torch.zeros((vals.shape[0], n), dtype=torch.float32,
                        device=vals.device)
    dense.scatter_(1, idx.long(), vals.to(torch.float32))
    return torch.sum(dense * w[:, None], dim=0)


def batched_reduce(codec_name: str, encs: Sequence[EncTree],
                   weights: Sequence[float], template, *,
                   use_kernel: bool = False):
    """Weighted mean over a whole round's encoded uplinks, one call per
    leaf: dense wires stack at WIRE dtype into ``dequant_reduce_flat``;
    top-k wires decode the stacked client axis."""
    if not encs:
        raise ValueError("batched_reduce over no uplinks")
    name = _norm(codec_name)
    tleaves = leaves(template)
    dev = tleaves[0].device
    w = torch.tensor(list(weights), dtype=torch.float32, device=dev)
    ones = torch.ones((len(encs),), dtype=torch.float32, device=dev)
    out = []
    for i, t in enumerate(tleaves):
        if name == "topk":
            vals = torch.stack([e[i][0][0] for e in encs])
            idx = torch.stack([e[i][0][1] for e in encs])
            mean = _topk_batched_mean(vals, idx, w, t.numel())
        else:
            wires = torch.stack([e[i][0].reshape(-1) for e in encs])
            scales = (torch.stack([e[i][1].reshape(()) for e in encs])
                      if name == "int8" else ones)
            mean = dequant_reduce_flat(wires, scales, w,
                                       use_kernel=use_kernel)
        out.append(mean.reshape(t.shape).to(t.dtype))
    return unflatten_like(template, out)
