"""Public fedavg op: tree <-> flat glue around the fedavg kernel (port of
``repro/kernels/fedavg/ops.py``).

A CUDA tensor goes through the hand-written kernel, which launches or
raises; a CPU tensor takes the plain version (``ref.py``).  A round's
average is one :func:`fedavg_leaves` call: one launch on the card, each
client's leaves read where they lie.
"""
from __future__ import annotations

import functools
import operator
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels.fedavg.kernel import (fedavg_kernel,
                                               fedavg_leaves_kernel)
from repro_torch.kernels.fedavg.ref import fedavg_leaves_ref, fedavg_ref
from repro_torch.tree import leaves, unflatten_like

_dtype = operator.attrgetter("dtype")


@functools.lru_cache(maxsize=64)
def _normalised(weights: Tuple[float, ...], device: torch.device
                ) -> torch.Tensor:
    w = torch.tensor(weights, dtype=torch.float32, device=device)
    return w / torch.sum(w)


def normalised_weights(weights: Sequence[float], device) -> torch.Tensor:
    """``w / sum(w)``: the (C,) fp32 weights on ``device``, normalised there
    in fp32.  Made once for each list of weights and kept: a round's
    weights (the clients' example counts) repeat, and a copy from pageable
    host memory to the card waits for everything queued on the stream.
    Never written to."""
    return _normalised(tuple(weights), torch.device(device))


def fedavg_flat(stacked: torch.Tensor, weights: torch.Tensor
                ) -> torch.Tensor:
    """stacked: (C, N) fp32 -> (N,): the average weighted by ``weights``
    (normalised here)."""
    w = weights / torch.sum(weights)
    if stacked.device.type == "cuda":
        return fedavg_kernel(stacked, w)
    if stacked.device.type == "cpu":
        return fedavg_ref(stacked, w)
    raise ValueError(f"fedavg_flat: no path for device {stacked.device}")


def fedavg_leaves(params_by_client: Sequence[Sequence[torch.Tensor]],
                  weights: torch.Tensor, *, normalise: bool = True
                  ) -> List[torch.Tensor]:
    """A round's average: ``params_by_client[c][l]`` is client ``c``'s fp32
    leaf ``l`` (any shape); ``weights`` the (C,) fp32 weights on the same
    device, normalised here unless ``normalise`` is False -> one fp32
    tensor a leaf, shaped like client 0's.  On the card one launch covers
    the round (``fedavg_leaves_kernel``) into outputs laid out like client
    0's leaves."""
    w = weights / torch.sum(weights) if normalise else weights
    first = params_by_client[0]
    dev = first[0].device
    if dev.type == "cuda":
        return fedavg_leaves_kernel(list(map(torch.empty_like, first)),
                                    params_by_client, w)
    if dev.type == "cpu":
        return fedavg_leaves_ref(params_by_client, w)
    raise ValueError(f"fedavg_leaves: no path for device {dev}")


def fedavg_trees(trees: Sequence,
                 weights: Optional[Union[Sequence[float], torch.Tensor]]
                 = None):
    """FedAvg over a list of same-structure parameter trees (sorted-key
    leaf order): one :func:`fedavg_leaves` call.  ``weights``: numbers
    (normalised by :func:`normalised_weights`), or a (C,) fp32 tensor on
    the trees' device (normalised here); None weighs every tree alike."""
    if not trees:
        raise ValueError("fedavg of zero clients")
    flats = [leaves(t) for t in trees]
    if any(len(f) != len(flats[0]) for f in flats):
        raise ValueError("client trees differ in structure")
    if isinstance(weights, torch.Tensor):
        w = weights / torch.sum(weights)
    else:
        w = normalised_weights([1.0] * len(trees) if weights is None
                               else weights, flats[0][0].device)
    dtypes = list(map(_dtype, flats[0]))
    if set(dtypes) == {torch.float32}:
        return unflatten_like(trees[0], fedavg_leaves(flats, w,
                                                      normalise=False))
    outs = fedavg_leaves([[l.to(torch.float32) for l in f] for f in flats],
                         w, normalise=False)
    return unflatten_like(trees[0], [o.to(d) for o, d in zip(outs, dtypes)])
