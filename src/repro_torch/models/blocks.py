"""Per-family transformer blocks: init/apply/decode dispatch (port of
``repro/models/blocks.py``).

A *block kind* is one residual block.  Ported:

  attn    GQA attention + dense MLP        (dense)
  rwkv    RWKV-6 time-mix + channel-mix    (ssm)

The kinds ``moe``, ``mla``, ``rglru``, ``enc`` and ``dec`` raise
``NotImplementedError``: they wait for ROADMAP Queue A item 16.

Layer stacks are organised in *periods* (the smallest repeating kind
tuple); the parameters of one period are stacked across periods, as in the
reference, and the stack runs as a Python loop over periods.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import AUDIO, HYBRID, SSM, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as RW
from repro_torch.models.layers import AttnDims

_WAITING = {"moe": "the MoE block (models/moe.py)",
            "mla": "the MLA block (models/mla.py)",
            "rglru": "the RG-LRU block (models/rglru.py)",
            "enc": "the whisper encoder",
            "dec": "the whisper decoder"}


def _unported(kind: str):
    if kind in _WAITING:
        return NotImplementedError(
            f"block kind {kind!r} ({_WAITING[kind]}) is not ported to "
            f"repro_torch yet (ROADMAP Queue A item 16)")
    return ValueError(kind)


# ---------------------------------------------------------------------------
# kinds & periods
# ---------------------------------------------------------------------------

def layer_kinds(m: ModelConfig) -> List[str]:
    force = getattr(m, "_force_kind", None)
    if force:                               # encoder stacks force 'enc'
        return [force] * m.num_layers
    if m.family == SSM:
        return ["rwkv"] * m.num_layers
    if m.family == HYBRID and m.rglru.enabled:
        pat = []
        while len(pat) < m.num_layers:
            pat.extend(m.rglru.pattern)
        return pat[: m.num_layers]
    if m.family == AUDIO:
        return ["dec"] * m.num_layers          # encoder handled separately
    if m.moe.enabled:
        return ["mla" if m.mla.enabled else "moe"] * m.num_layers
    return ["attn"] * m.num_layers


def period_of(m: ModelConfig) -> Tuple[str, ...]:
    if m.family == HYBRID and m.rglru.enabled:
        return tuple(m.rglru.pattern)
    kinds = layer_kinds(m)
    return (kinds[0],) if kinds else ()


def split_periods(m: ModelConfig) -> Tuple[int, List[str]]:
    """-> (num_full_periods, remainder_kinds)."""
    period = period_of(m)
    kinds = layer_kinds(m)
    n_full = len(kinds) // len(period)
    return n_full, kinds[n_full * len(period):]


# ---------------------------------------------------------------------------
# per-block init
# ---------------------------------------------------------------------------

def _norm_init(m: ModelConfig, dtype, device):
    return (L.layernorm_init(m.d_model, dtype, device) if m.family == AUDIO
            else L.rmsnorm_init(m.d_model, dtype, device))


def norm_apply(m: ModelConfig, p, x):
    return (L.layernorm_apply(p, x) if m.family == AUDIO
            else L.rmsnorm_apply(p, x, m.norm_eps))


def attn_dims(m: ModelConfig) -> AttnDims:
    return AttnDims(
        d_model=m.d_model, num_heads=m.num_heads,
        num_kv_heads=m.num_kv_heads, head_dim=m.head_dim,
        qk_norm=m.qk_norm, qkv_bias=m.qkv_bias or m.family == AUDIO,
        rope_theta=m.rope_theta,
        window=m.sliding_window if m.attention == "sliding" else 0)


def block_init(gen: torch.Generator, kind: str, m: ModelConfig, dtype
               ) -> Dict[str, Any]:
    """One block's parameters, drawn from ``gen`` on its device."""
    dev = gen.device
    if kind == "attn":
        return {"ln1": _norm_init(m, dtype, dev),
                "attn": L.gqa_init(gen, attn_dims(m), dtype),
                "ln2": _norm_init(m, dtype, dev),
                "mlp": L.mlp_init(gen, m.d_model, m.d_ff, m.act, dtype)}
    if kind == "rwkv":
        return {"ln1": _norm_init(m, dtype, dev),
                "time": RW.timemix_init(gen, m.d_model, m.rwkv, dtype),
                "ln2": _norm_init(m, dtype, dev),
                "chan": RW.channelmix_init(gen, m.d_model, m.d_ff, dtype)}
    raise _unported(kind)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def place_kv(k: torch.Tensor, cache_len: int, window: int, dtype
             ) -> torch.Tensor:
    """Lay a (B, S, H, hd) prefill K (or V) into a decode cache buffer.

    Full attention: pad/truncate to cache_len (positions 0..S-1).
    Sliding window: ring buffer of size min(cache_len, window); position p
    lands in slot p % ring so `gqa_decode` ring arithmetic lines up.
    """
    b, s, h, hd = k.shape
    if window:
        ring = min(cache_len, window)
        take = min(s, ring)
        tail = k[:, s - take:, :, :]
        slots = torch.arange(s - take, s, device=k.device) % ring
        buf = torch.zeros((b, ring, h, hd), dtype=dtype, device=k.device)
        buf[:, slots] = tail.to(dtype)
        return buf
    if s >= cache_len:
        return k[:, :cache_len].to(dtype)
    buf = torch.zeros((b, cache_len, h, hd), dtype=dtype, device=k.device)
    buf[:, :s] = k
    return buf


def block_apply(kind: str, p, x, m: ModelConfig, positions, cd,
                enc_out: Optional[torch.Tensor] = None,
                use_kernel: bool = False, cache_len: int = 0,
                cache_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """One residual block over a full sequence.

    Returns (x, aux_loss, cache) — cache is a decode-state dict (matching
    ``block_state_init`` structure) when ``cache_len > 0`` (prefill), else
    None.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache: Optional[Dict] = None
    if kind == "attn":
        dims = attn_dims(m)
        h = norm_apply(m, p["ln1"], x)
        a, (k, v) = L.gqa_apply(p["attn"], h, dims, positions, cd,
                                use_kernel=use_kernel)
        if cache_len:
            cache = {"k": place_kv(k, cache_len, dims.window, cache_dtype),
                     "v": place_kv(v, cache_len, dims.window, cache_dtype)}
        x = x + a
        h = norm_apply(m, p["ln2"], x)
        return x + L.mlp_apply(p["mlp"], h, m.act, cd), aux, cache
    if kind == "rwkv":
        h = norm_apply(m, p["ln1"], x)
        a, (xt, S) = RW.timemix_apply(p["time"], h, m.rwkv, compute_dtype=cd,
                                      use_kernel=use_kernel)
        x = x + a
        h2 = norm_apply(m, p["ln2"], x)
        y, xc = RW.channelmix_apply(p["chan"], h2, compute_dtype=cd)
        if cache_len:
            cache = {"x_time": xt.to(cache_dtype),
                     "x_chan": xc.to(cache_dtype), "S": S}
        return x + y, aux, cache
    raise _unported(kind)


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------

def block_state_init(kind: str, m: ModelConfig, batch: int, cache_len: int,
                     dtype, device=None) -> Dict[str, Any]:
    """Zero decode-state for one block. cache_len already window-clipped."""
    d = m.d_model
    if kind == "attn":
        c = min(cache_len, m.sliding_window) if m.attention == "sliding" \
            else cache_len
        shape = (batch, c, m.num_kv_heads, m.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "rwkv":
        h = d // m.rwkv.head_dim
        n = m.rwkv.head_dim
        return {"x_time": torch.zeros((batch, d), dtype=dtype, device=device),
                "x_chan": torch.zeros((batch, d), dtype=dtype, device=device),
                "S": torch.zeros((batch, h, n, n), dtype=torch.float32,
                                 device=device)}
    raise _unported(kind)


def block_decode(kind: str, p, x, state, index: int, m: ModelConfig, cd
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-token decode through one block. x: (B,1,d).  The attention
    cache is updated in place (see :func:`~repro_torch.models.layers.
    gqa_decode`)."""
    if kind == "attn":
        h = norm_apply(m, p["ln1"], x)
        a, (ck, cv) = L.gqa_decode(p["attn"], h, state["k"], state["v"],
                                   index, attn_dims(m), cd)
        x = x + a
        h = norm_apply(m, p["ln2"], x)
        return x + L.mlp_apply(p["mlp"], h, m.act, cd), {"k": ck, "v": cv}
    if kind == "rwkv":
        h = norm_apply(m, p["ln1"], x)
        a, (xt, S) = RW.timemix_apply(p["time"], h, m.rwkv,
                                      x_prev_last=state["x_time"],
                                      state0=state["S"], compute_dtype=cd)
        x = x + a
        h = norm_apply(m, p["ln2"], x)
        y, xc = RW.channelmix_apply(p["chan"], h, x_prev_last=state["x_chan"],
                                    compute_dtype=cd)
        return x + y, {"x_time": xt.to(state["x_time"].dtype),
                       "x_chan": xc.to(state["x_chan"].dtype), "S": S}
    raise _unported(kind)
