"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427;
port of ``repro/models/rglru.py``).

Block: x -> [linear -> GeLU] gate branch, [linear -> causal conv1d(4) ->
RG-LRU] recurrent branch, merge by product, project back to d_model.

RG-LRU (per channel, fp32):
    r_t = sigmoid(a_x x_t + a_b)          recurrence gate
    i_t = sigmoid(i_x x_t + i_b)          input gate
    a_t = a_base ** (c * r_t)             with a_base = sigmoid(lambda), c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Gates are per-channel (diagonal), as in the reference.  The recurrence is
a ``lax.scan`` there, not a Pallas kernel; here it is a plain loop over
time that keeps the reference's order of operations (one multiply, then
one add, a step).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_normal, dense_apply, dense_init,
                                       dense_specs)
from repro_torch.sharding.specs import Lg

_C = 8.0  # Griffin's fixed temperature on the recurrence gate


def rglru_block_init(gen, d: int, cfg, dtype=torch.float32):
    """cfg: RGLRUConfig.  Returns the full recurrent block params."""
    lw = cfg.lru_width or d
    dev = gen.device
    # lambda init so a_base^c spans ~(0.9, 0.999) as in the paper
    lam = 0.9 + (0.999 - 0.9) * torch.rand((lw,), generator=gen, device=dev,
                                           dtype=torch.float32)
    lam = torch.log(lam ** (1.0 / _C) / (1 - lam ** (1.0 / _C)))

    def zeros():
        return torch.zeros((lw,), dtype=dtype, device=dev)

    return {
        "w_gate": dense_init(gen, d, lw, dtype),       # GeLU branch
        "w_rec": dense_init(gen, d, lw, dtype),        # recurrent branch
        "conv_w": _normal(gen, (cfg.conv_width, lw), cfg.conv_width ** -0.5,
                          dtype),
        "conv_b": zeros(),
        "lam": lam.to(dtype),
        "a_x": zeros(), "a_b": zeros(),
        "i_x": zeros(), "i_b": zeros(),
        "w_out": dense_init(gen, lw, d, dtype),
    }


def rglru_block_specs(cfg):
    return {
        "w_gate": dense_specs("embed", "mlp"),
        "w_rec": dense_specs("embed", "mlp"),
        "conv_w": Lg(None, "mlp"), "conv_b": Lg("mlp"),
        "lam": Lg("mlp"),
        "a_x": Lg("mlp"), "a_b": Lg("mlp"),
        "i_x": Lg("mlp"), "i_b": Lg("mlp"),
        "w_out": dense_specs("mlp", "embed"),
    }


def causal_conv1d(x, w, b, state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B,T,C); w: (W,C); state: (B,W-1,C)."""
    bsz, t, c = x.shape
    width = w.shape[0]
    if state is None:
        state = torch.zeros((bsz, width - 1, c), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = torch.zeros((bsz, t, c), dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + t, :].to(torch.float32) \
            * w[i].to(torch.float32)
    out = out + b.to(torch.float32)
    return out.to(x.dtype), xp[:, -(width - 1):, :]


def rglru_scan(x, r_gate, i_gate, a_base, h0: Optional[torch.Tensor] = None):
    """The LRU recurrence. x, r_gate, i_gate: (B,T,C) fp32; a_base: (C,).
    -> (h (B,T,C), h_T (B,C))."""
    b, _, c = x.shape
    log_a = _C * r_gate * F.logsigmoid(a_base)[None, None, :]  # <= 0
    a = torch.exp(log_a)
    gated = i_gate * x
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    u = beta * gated
    if h0 is None:
        h0 = torch.zeros((b, c), dtype=torch.float32, device=x.device)
    # time-major, so each step reads and writes contiguous rows
    a_t = a.transpose(0, 1).contiguous()
    u_t = u.transpose(0, 1).contiguous()
    # each step's state its own tensor, stacked once; the inputs unbound
    # once, so under autograd no step's backward scatters into a zero
    # tensor of the whole sequence (an unbind's backward stacks once)
    h = h0
    steps = []
    for a_i, u_i in zip(a_t.unbind(0), u_t.unbind(0)):
        h = a_i * h + u_i
        steps.append(h)
    return torch.stack(steps).transpose(0, 1), h


def rglru_block_apply(p, x, cfg, conv_state=None, h0=None,
                      compute_dtype=None):
    """x: (B,T,d) -> (y, (conv_state, h_state))."""
    f32 = torch.float32
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(dense_apply(p["w_gate"], x, compute_dtype).to(f32),
                  approximate="tanh")
    rec = dense_apply(p["w_rec"], x, compute_dtype)
    rec, conv_state = causal_conv1d(rec, p["conv_w"], p["conv_b"],
                                    conv_state)
    rec32 = rec.to(f32)
    r = torch.sigmoid(rec32 * p["a_x"].to(f32) + p["a_b"].to(f32))
    i = torch.sigmoid(rec32 * p["i_x"].to(f32) + p["i_b"].to(f32))
    h, h_t = rglru_scan(rec32, r, i, p["lam"].to(f32), h0)
    y = (h * gate).to(x.dtype)
    return dense_apply(p["w_out"], y, compute_dtype), (conv_state, h_t)
