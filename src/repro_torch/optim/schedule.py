"""Learning-rate schedules (port of ``repro/optim/schedule.py``).

``make_schedule`` returns ``step -> lr`` as a float32 0-d tensor on the
CPU, computed in float32 in the reference's order of operations (the
reference's ``jnp.float32`` arithmetic).  A 0-d CPU tensor combines with
tensors on any device, so the train step takes it as it is.
"""
from __future__ import annotations

import math

import torch

SCHEDULES = ("constant", "linear", "cosine")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device="cpu")


def make_schedule(name: str, base_lr: float, warmup_steps: int = 0,
                  total_steps: int = 1000, final_frac: float = 0.1):
    """Returns step -> lr (float32 0-d tensor). Supports constant/linear/
    cosine; any other name raises."""
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}")
    warm_div = _f32(max(warmup_steps, 1))
    span = _f32(max(total_steps - warmup_steps, 1))

    def progress(step):
        return torch.clamp((step - warmup_steps) / span, 0, 1)

    def sched(step):
        if isinstance(step, torch.Tensor):
            step = step.detach().to("cpu")
        step = _f32(step)
        warm = torch.clamp((step + 1) / warm_div, max=1.0)
        if name == "constant":
            decay = 1.0
        elif name == "linear":
            decay = 1.0 - (1.0 - final_frac) * progress(step)
        else:
            decay = final_frac + (1 - final_frac) * 0.5 * (
                1 + torch.cos(math.pi * progress(step)))
        return base_lr * warm * decay
    return sched
