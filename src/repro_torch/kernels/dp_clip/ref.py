"""Plain PyTorch version of the dp_clip kernel (port of
``repro/kernels/dp_clip/ref.py``): what the CPU takes, and what the CUDA
kernel is held against on the GPU."""
import torch

NORM_EPS = 1e-12      # guard for all-zero examples, shared with the kernel


def dp_clip_noise_ref(stacked: torch.Tensor, clip, noise_scale,
                      noise: torch.Tensor) -> torch.Tensor:
    """stacked: (B, N); noise: (N,) -> (N,) f32.

    out = sum_b min(1, clip/||g_b||) g_b  +  noise_scale * noise
    """
    x = stacked.to(torch.float32)
    norms = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    scale = torch.clamp(clip / torch.clamp(norms, min=NORM_EPS), max=1.0)
    return (torch.sum(x * scale, dim=0)
            + float(noise_scale) * noise.to(torch.float32))
