"""Plain PyTorch version of the fedavg kernel (port of
``repro/kernels/fedavg/ref.py``): what the CPU takes, and what the CUDA
kernel is held against on the GPU."""
import torch


def fedavg_ref(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked: (C, N); weights: (C,) summing to 1 -> (N,)."""
    return torch.sum(stacked.to(torch.float32) * weights[:, None], dim=0
                     ).to(stacked.dtype)
