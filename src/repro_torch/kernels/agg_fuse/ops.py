"""Public agg_fuse ops on flat buffers (port of
``repro/kernels/agg_fuse/ops.py``): what ``fed/aggregate`` calls.

With ``use_kernel`` (``fed.kernel_aggregation``) a CUDA tensor goes through
the hand-written kernels, which launch or raise; a CPU tensor takes the
plain version (``ref.py``), as does a CUDA tensor when the caller did not
ask for the kernels.  The accumulating ops return the new accumulator: the
kernels update ``acc`` in place (the JAX ops donate it), the plain version
returns a new tensor, and the caller keeps whichever comes back.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.kernels.agg_fuse.kernel import (
    dequant_acc_kernel, dequant_acc_leaves_kernel, dequant_reduce_kernel,
    dequant_reduce_leaves_kernel, scatter_acc_kernel,
    scatter_acc_leaves_kernel)
from repro_torch.kernels.agg_fuse.ref import (dequant_acc_ref,
                                              dequant_reduce_ref,
                                              scatter_acc_ref)


def _use_kernel(x: torch.Tensor, use_kernel: bool, op: str) -> bool:
    if x.device.type == "cuda":
        return bool(use_kernel)
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no path for device {x.device}")


def dequant_reduce_flat(wires: torch.Tensor, scales: torch.Tensor,
                        weights: torch.Tensor, *,
                        use_kernel: bool = False) -> torch.Tensor:
    """Batch reduce: (C, N) wire rows + per-client (C,) scales and fedavg
    weights -> (N,) fp32 weighted MEAN of the dequantized rows (weights
    normalised here, as ``fedavg_flat`` does)."""
    w = (weights / torch.sum(weights)).to(torch.float32)
    coefs = torch.stack([w, scales.to(torch.float32)], dim=1)
    if _use_kernel(wires, use_kernel, "dequant_reduce_flat"):
        return dequant_reduce_kernel(wires, coefs)
    return dequant_reduce_ref(wires, coefs)


def dequant_reduce_leaves(wires_by_leaf: Sequence[Sequence[torch.Tensor]],
                          scales_by_leaf: Optional[Sequence[Sequence[
                              torch.Tensor]]],
                          weights: torch.Tensor, *,
                          use_kernel: bool = False) -> List[torch.Tensor]:
    """A whole round's batch reduce: ``wires_by_leaf[l][c]`` is client
    ``c``'s wire of leaf ``l`` (any shape), ``scales_by_leaf[l][c]`` its
    0-dim scale (None: every scale 1.0), ``weights`` the (C,) fedavg
    weights, normalised once here -> one flat fp32 weighted MEAN a leaf.
    On the kernel path one launch covers the round and each wire is read
    where it lies; the plain version is ``dequant_reduce_ref`` on each
    leaf's stack."""
    if not wires_by_leaf:
        return []
    w = (weights / torch.sum(weights)).to(torch.float32)
    if _use_kernel(wires_by_leaf[0][0], use_kernel, "dequant_reduce_leaves"):
        outs = [torch.empty((ws[0].numel(),), dtype=torch.float32,
                            device=w.device) for ws in wires_by_leaf]
        return dequant_reduce_leaves_kernel(outs, wires_by_leaf, w,
                                            scales_by_leaf)
    ones = torch.ones_like(w)
    out = []
    for leaf, ws in enumerate(wires_by_leaf):
        scales = ones if scales_by_leaf is None else torch.stack(
            [s.reshape(()) for s in scales_by_leaf[leaf]]).to(torch.float32)
        out.append(dequant_reduce_ref(torch.stack([x.reshape(-1) for x in ws]),
                                      torch.stack([w, scales], dim=1)))
    return out


def dequant_acc_flat(acc: torch.Tensor, wire: torch.Tensor, scale, weight,
                     *, use_kernel: bool = False) -> torch.Tensor:
    """Streaming fold: (N,) fp32 accumulator + one (N,) wire at its wire
    dtype -> ``acc + weight * scale * dequant(wire)``.  UNnormalised: the
    aggregator divides by the weight sum at finalize.  ``scale`` is an
    int8 wire's 0-dim scale tensor, or 1.0."""
    if _use_kernel(acc, use_kernel, "dequant_acc_flat"):
        if not isinstance(scale, torch.Tensor):
            if scale != 1.0:
                raise ValueError(f"a host scale must be 1.0, got {scale}")
            scale = None
        return dequant_acc_kernel(acc, wire, weight, scale)
    return dequant_acc_ref(acc, wire, weight, scale)


def dequant_acc_leaves(accs: Sequence[torch.Tensor],
                       wires: Sequence[torch.Tensor],
                       scales: Optional[Sequence[torch.Tensor]], weight, *,
                       use_kernel: bool = False) -> List[torch.Tensor]:
    """A whole dense streaming fold: leaf ``l``'s wire (any shape, N_l
    elements) times ``weight * scales[l]`` (an int8 wire's 0-dim scale;
    ``scales`` None: every scale 1.0) added into the flat fp32
    ``accs[l]``.  On the kernel path one launch covers every leaf; the
    plain version is ``dequant_acc_ref`` leaf by leaf.  Returns the new
    accumulators."""
    if len(accs) != len(wires) or (scales is not None
                                   and len(scales) != len(accs)):
        raise ValueError(f"{len(accs)} accumulators, {len(wires)} wires")
    if not accs:
        return []
    if _use_kernel(accs[0], use_kernel, "dequant_acc_leaves"):
        return dequant_acc_leaves_kernel(accs, wires, weight, scales)
    if scales is None:
        scales = [1.0] * len(accs)
    return [dequant_acc_ref(a, x.reshape(-1), weight, s)
            for a, x, s in zip(accs, wires, scales)]


def scatter_acc_flat(acc: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                     weight, *, use_kernel: bool = False) -> torch.Tensor:
    """Sparse streaming fold: weighted top-k ``(vals, idx)`` added into the
    (N,) fp32 accumulator without densifying the wire."""
    if _use_kernel(acc, use_kernel, "scatter_acc_flat"):
        return scatter_acc_kernel(acc, vals, idx, weight)
    return scatter_acc_ref(acc, vals, idx, weight)


def scatter_acc_leaves(accs: Sequence[torch.Tensor],
                       vals_list: Sequence[torch.Tensor],
                       idx_list: Sequence[torch.Tensor], weight, *,
                       use_kernel: bool = False) -> List[torch.Tensor]:
    """A whole sparse streaming fold: leaf ``l``'s weighted top-k
    ``(vals_list[l], idx_list[l])`` added into ``accs[l]``.  On the kernel
    path one launch covers every leaf; the plain version is
    ``scatter_acc_ref`` leaf by leaf.  Returns the new accumulators."""
    if not (len(accs) == len(vals_list) == len(idx_list)):
        raise ValueError(f"{len(accs)} accumulators, {len(vals_list)} value "
                         f"and {len(idx_list)} index wires")
    if not accs:
        return []
    if _use_kernel(accs[0], use_kernel, "scatter_acc_leaves"):
        return scatter_acc_leaves_kernel(accs, vals_list, idx_list, weight)
    return [scatter_acc_ref(a, v, i, weight)
            for a, v, i in zip(accs, vals_list, idx_list)]
