"""Plain PyTorch version of the fedavg kernel (port of
``repro/kernels/fedavg/ref.py``): what the CPU takes, and what the CUDA
kernel is held against on the GPU."""
from typing import List, Sequence

import torch


def fedavg_ref(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked: (C, N); weights: (C,) summing to 1 -> (N,)."""
    return torch.sum(stacked.to(torch.float32) * weights[:, None], dim=0
                     ).to(stacked.dtype)


def fedavg_leaves_ref(params_by_client: Sequence[Sequence[torch.Tensor]],
                      weights: torch.Tensor) -> List[torch.Tensor]:
    """A round's reduce, leaf by leaf: ``params_by_client[c][l]`` is client
    ``c``'s leaf ``l``; ``weights``: (C,) summing to 1 -> one fp32 tensor a
    leaf, shaped like client 0's, :func:`fedavg_ref` over the leaf's
    stack."""
    return [fedavg_ref(torch.stack([p.reshape(-1).to(torch.float32)
                                    for p in ps]), weights).reshape(ps[0].shape)
            for ps in zip(*params_by_client)]
