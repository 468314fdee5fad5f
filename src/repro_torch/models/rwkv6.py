"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time-mix with
data-dependent decay, ddlerp token shift, and squared-ReLU channel mix
(port of ``repro/models/rwkv6.py``).

Per head (head_dim n):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: n x n, fp32)
    o_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})
with w_t = exp(-exp(decay_t)) computed per channel from the token via a
LoRA ("data-dependent decay").

:func:`wkv6_scan` is the plain loop over time; ``timemix_apply(...,
use_kernel=True)`` goes through the ``wkv6`` op instead (the hand-written
CUDA kernel for a CUDA tensor).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_apply, dense_init, dense_specs
from repro_torch.sharding.specs import Lg

MIX_NAMES = ("r", "k", "v", "w", "g")   # receptance, key, value, decay, gate


def _lora(gen, d: int, rank: int, out: int, dtype):
    a = torch.randn((d, rank), generator=gen, device=gen.device,
                    dtype=torch.float32) * d ** -0.5
    return {"a": a.to(dtype),
            "b": torch.zeros((rank, out), dtype=dtype, device=gen.device)}


def _lora_specs():
    return {"a": Lg("embed", None), "b": Lg(None, None)}


def _lora_apply(p, x, act=torch.tanh):
    h = act(x.to(torch.float32) @ p["a"].to(torch.float32))
    return h @ p["b"].to(torch.float32)


def timemix_init(gen, d: int, cfg, dtype=torch.float32):
    """cfg: RWKVConfig."""
    dev = gen.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "mu_x": zeros(d),                # base lerp for the shared ddlerp
        "mu": zeros(len(MIX_NAMES), d),
        "ts_lora": {n: _lora(gen, d, cfg.token_shift_lora, d, dtype)
                    for n in MIX_NAMES},
        "wr": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "wg": dense_init(gen, d, d, dtype),
        "wo": dense_init(gen, d, d, dtype),
        "decay_base": zeros(d),          # per-channel base decay
        "decay_lora": _lora(gen, d, cfg.decay_lora, d, dtype),
        "bonus_u": zeros(d),             # per-channel "first token" bonus
    }


def timemix_specs(cfg):
    return {
        "mu_x": Lg(None),
        "mu": Lg(None, None),
        "ts_lora": {n: _lora_specs() for n in MIX_NAMES},
        "wr": dense_specs("embed", "mlp"),
        "wk": dense_specs("embed", "mlp"),
        "wv": dense_specs("embed", "mlp"),
        "wg": dense_specs("embed", "mlp"),
        "wo": dense_specs("mlp", "embed"),
        "decay_base": Lg(None),
        "decay_lora": _lora_specs(),
        "bonus_u": Lg(None),
    }


def _shifted(x, x_prev_last):
    """x shifted one step along time, ``x_prev_last`` (B, d) or zeros in
    front, in the promoted type of the two, as ``jnp.concatenate``."""
    b, _, d = x.shape
    if x_prev_last is None:
        x_prev_last = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    dt = torch.promote_types(x.dtype, x_prev_last.dtype)
    return torch.cat([x_prev_last[:, None, :].to(dt), x[:, :-1, :].to(dt)],
                     dim=1)


def ddlerp(p, x, x_prev):
    """Data-dependent lerp (Finch token shift) -> dict of mixed inputs."""
    xx = (x_prev - x).to(torch.float32)
    x32 = x.to(torch.float32)
    base = x32 + xx * torch.sigmoid(p["mu_x"].to(torch.float32))
    out = {}
    for i, n in enumerate(MIX_NAMES):
        mix = p["mu"][i].to(torch.float32) + _lora_apply(p["ts_lora"][n],
                                                         base)
        out[n] = x32 + xx * torch.sigmoid(mix)
    return out


def wkv6_scan(r, k, v, w, u, head_dim: int,
              state0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence over time, a plain loop (the reference's
    chunked remat only changes what a backward pass keeps).

    r,k,v,w: (B, T, H, n); u: (H, n). Returns (out (B,T,H,n) fp32, final
    state (B,H,n,n)). State rows indexed by k-channel, cols by v-channel.
    """
    b, t, h, n = r.shape
    S = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if state0 is None else state0)
    # each input split into its time steps once: under autograd, indexing
    # a step would give every step's backward a zero tensor of the whole
    # sequence to scatter into (an unbind's backward stacks once)
    r, k, v, w = (a.to(torch.float32).unbind(1) for a in (r, k, v, w))
    uu = u[None, :, :, None]
    outs = []
    for i in range(t):
        kv = k[i][:, :, :, None] * v[i][:, :, None, :]       # (B,H,n,n)
        outs.append(torch.einsum("bhn,bhnm->bhm", r[i], S + uu * kv))
        S = w[i][:, :, :, None] * S + kv
    return torch.stack(outs, dim=1), S


def timemix_apply(p, x, cfg, x_prev_last=None, state0=None,
                  compute_dtype=None, use_kernel: bool = False):
    """x: (B, T, d). x_prev_last: (B, d) carry for decode/chunking.

    Returns (y, (last_x, state)) so decode can stream token by token.
    """
    b, t, d = x.shape
    n = cfg.head_dim
    h = d // n
    x_prev = _shifted(x, x_prev_last)
    m = ddlerp(p, x, x_prev)

    r = dense_apply(p["wr"], m["r"].to(x.dtype), compute_dtype)
    k = dense_apply(p["wk"], m["k"].to(x.dtype), compute_dtype)
    v = dense_apply(p["wv"], m["v"].to(x.dtype), compute_dtype)
    g = dense_apply(p["wg"], m["g"].to(x.dtype), compute_dtype)
    # data-dependent decay (fp32 for stability)
    dec = (p["decay_base"].to(torch.float32)
           + _lora_apply(p["decay_lora"], m["w"]))
    w = torch.exp(-torch.exp(dec))                 # (B,T,d) in (0,1)

    rs = r.reshape(b, t, h, n).to(torch.float32)
    ks = k.reshape(b, t, h, n).to(torch.float32)
    vs = v.reshape(b, t, h, n).to(torch.float32)
    ws = w.reshape(b, t, h, n)
    u = p["bonus_u"].to(torch.float32).reshape(h, n)

    if use_kernel:
        from repro_torch.kernels.wkv6.ops import wkv6 as wkv6_op
        out, state = wkv6_op(rs, ks, vs, ws, u, state0=state0)
    else:
        out, state = wkv6_scan(rs, ks, vs, ws, u, n, state0)
    # group-norm per head (RWKV normalizes heads); plain rms here per head
    out = out * torch.rsqrt(torch.mean(out * out, -1, keepdim=True) + 1e-5)
    out = out.reshape(b, t, d).to(x.dtype)
    y = dense_apply(p["wo"], out * F.silu(g.to(out.dtype)), compute_dtype)
    return y, (x[:, -1, :], state)


def channelmix_init(gen, d: int, d_ff: int, dtype=torch.float32):
    return {"mu_k": torch.zeros((d,), dtype=dtype, device=gen.device),
            "mu_r": torch.zeros((d,), dtype=dtype, device=gen.device),
            "wk": dense_init(gen, d, d_ff, dtype),
            "wv": dense_init(gen, d_ff, d, dtype),
            "wr": dense_init(gen, d, d, dtype)}


def channelmix_specs():
    return {"mu_k": Lg(None), "mu_r": Lg(None),
            "wk": dense_specs("embed", "mlp"),
            "wv": dense_specs("mlp", "embed"),
            "wr": dense_specs("embed", "embed")}


def channelmix_apply(p, x, x_prev_last=None, compute_dtype=None):
    x_prev = _shifted(x, x_prev_last)
    xx = (x_prev - x).to(torch.float32)
    x32 = x.to(torch.float32)
    xk = (x32 + xx * torch.sigmoid(p["mu_k"].to(torch.float32))).to(x.dtype)
    xr = (x32 + xx * torch.sigmoid(p["mu_r"].to(torch.float32))).to(x.dtype)
    kk = torch.square(torch.relu(dense_apply(p["wk"], xk, compute_dtype)))
    rr = torch.sigmoid(dense_apply(p["wr"], xr, compute_dtype)
                       .to(torch.float32)).to(x.dtype)
    return rr * dense_apply(p["wv"], kk, compute_dtype), x[:, -1, :]
