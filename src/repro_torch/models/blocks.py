"""Per-family transformer blocks: init/apply/decode dispatch (port of
``repro/models/blocks.py``).

A *block kind* is one residual block:

  attn    GQA attention + dense MLP        (dense / vlm / hybrid-attn)
  moe     GQA attention + MoE MLP          (olmoe)
  mla     MLA attention + MoE MLP          (deepseek-v2)
  rwkv    RWKV-6 time-mix + channel-mix    (ssm)
  rglru   RG-LRU recurrent block + MLP     (hybrid-recurrent)
  enc     bidirectional attention + MLP    (whisper encoder)
  dec     causal self-attn + cross-attn + MLP (whisper decoder)

``use_kernel`` sends the self-attention of ``attn`` and ``moe`` blocks
through the flash-attention op, as the reference sends it through its
Pallas kernel; every other attention (MLA, the whisper encoder and
decoder, and all of prefill and decode) takes the plain attention.

Layer stacks are organised in *periods* (the smallest repeating kind
tuple); the parameters of one period are stacked across periods, as in the
reference, and the stack runs as a Python loop over periods.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import AUDIO, HYBRID, SSM, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE_M
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.layers import AttnDims
from repro_torch.sharding.specs import Lg


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

def norm_init(m: ModelConfig, dtype, device):
    return (L.layernorm_init(m.d_model, dtype, device) if m.family == AUDIO
            else L.rmsnorm_init(m.d_model, dtype, device))


def norm_specs(m: ModelConfig):
    return (L.layernorm_specs() if m.family == AUDIO else L.rmsnorm_specs())


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
    dims = attn_dims(m)
    if kind in ("attn", "moe", "enc"):
        p = {"ln1": norm_init(m, dtype, dev),
             "attn": L.gqa_init(gen, dims, dtype),
             "ln2": norm_init(m, dtype, dev)}
        p["mlp"] = (MOE_M.moe_init(gen, m.d_model, m.moe, dtype)
                    if kind == "moe" else
                    L.mlp_init(gen, m.d_model, m.d_ff, m.act, dtype))
        return p
    if kind == "mla":
        return {"ln1": norm_init(m, dtype, dev),
                "attn": MLA.mla_init(gen, m.d_model, m.num_heads, m.head_dim,
                                     m.mla, dtype),
                "ln2": norm_init(m, dtype, dev),
                "mlp": MOE_M.moe_init(gen, m.d_model, m.moe, dtype)}
    if kind == "rwkv":
        return {"ln1": norm_init(m, dtype, dev),
                "time": RW.timemix_init(gen, m.d_model, m.rwkv, dtype),
                "ln2": norm_init(m, dtype, dev),
                "chan": RW.channelmix_init(gen, m.d_model, m.d_ff, dtype)}
    if kind == "rglru":
        return {"ln1": norm_init(m, dtype, dev),
                "rec": RG.rglru_block_init(gen, m.d_model, m.rglru, dtype),
                "ln2": norm_init(m, dtype, dev),
                "mlp": L.mlp_init(gen, m.d_model, m.d_ff, m.act, dtype)}
    if kind == "dec":
        return {"ln1": norm_init(m, dtype, dev),
                "attn": L.gqa_init(gen, dims, dtype),
                "lnx": norm_init(m, dtype, dev),
                "xattn": L.gqa_init(gen, dims, dtype),
                "ln2": norm_init(m, dtype, dev),
                "mlp": L.mlp_init(gen, m.d_model, m.d_ff, m.act, dtype)}
    raise ValueError(kind)


def block_specs(kind: str, m: ModelConfig) -> Dict[str, Any]:
    """The logical axes of :func:`block_init`'s tree, leaf for leaf."""
    dims = attn_dims(m)
    if kind in ("attn", "moe", "enc"):
        p = {"ln1": norm_specs(m), "attn": L.gqa_specs(dims),
             "ln2": norm_specs(m)}
        p["mlp"] = (MOE_M.moe_specs(m.moe) if kind == "moe"
                    else L.mlp_specs(m.act))
        return p
    if kind == "mla":
        return {"ln1": norm_specs(m), "attn": MLA.mla_specs(m.mla),
                "ln2": norm_specs(m), "mlp": MOE_M.moe_specs(m.moe)}
    if kind == "rwkv":
        return {"ln1": norm_specs(m), "time": RW.timemix_specs(m.rwkv),
                "ln2": norm_specs(m), "chan": RW.channelmix_specs()}
    if kind == "rglru":
        return {"ln1": norm_specs(m), "rec": RG.rglru_block_specs(m.rglru),
                "ln2": norm_specs(m), "mlp": L.mlp_specs(m.act)}
    if kind == "dec":
        return {"ln1": norm_specs(m), "attn": L.gqa_specs(dims),
                "lnx": norm_specs(m), "xattn": L.gqa_specs(dims),
                "ln2": norm_specs(m), "mlp": L.mlp_specs(m.act)}
    raise ValueError(kind)


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
    dims = attn_dims(m)
    if kind in ("attn", "moe", "enc"):
        h = norm_apply(m, p["ln1"], x)
        if kind == "enc":
            # bidirectional: every position attends to every position
            s = h.shape[1]
            pos = torch.zeros((s,), dtype=torch.int64, device=x.device)
            q, k, v = L.gqa_project_qkv(p["attn"], h, dims, positions, cd,
                                        rope=m.rope_theta > 0)
            o = L.attention(q, k, v, pos, pos, window=0)
            o = o.reshape(*h.shape[:2], dims.num_heads * dims.head_dim)
            a = L.dense_apply(p["attn"]["wo"], o, cd)
        else:
            a, (k, v) = L.gqa_apply(p["attn"], h, dims, positions, cd,
                                    use_kernel=use_kernel)
            if cache_len:
                cache = {"k": place_kv(k, cache_len, dims.window,
                                       cache_dtype),
                         "v": place_kv(v, cache_len, dims.window,
                                       cache_dtype)}
        x = x + a
        h = norm_apply(m, p["ln2"], x)
        if kind == "moe":
            y, aux = MOE_M.moe_apply(p["mlp"], h, m.moe, cd)
        else:
            y = L.mlp_apply(p["mlp"], h, m.act, cd)
        return x + y, aux, cache
    if kind == "mla":
        h = norm_apply(m, p["ln1"], x)
        a, (c_kv, k_rope) = MLA.mla_apply(p["attn"], h, m.num_heads,
                                          m.head_dim, m.mla, positions,
                                          m.rope_theta, cd)
        if cache_len:
            cache = {"ckv": place_kv(c_kv[:, :, None, :], cache_len, 0,
                                     cache_dtype)[:, :, 0],
                     "krope": place_kv(k_rope[:, :, None, :], cache_len, 0,
                                       cache_dtype)[:, :, 0]}
        x = x + a
        h = norm_apply(m, p["ln2"], x)
        y, aux = MOE_M.moe_apply(p["mlp"], h, m.moe, cd)
        return x + y, aux, cache
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
    if kind == "rglru":
        h = norm_apply(m, p["ln1"], x)
        a, (conv, h_t) = RG.rglru_block_apply(p["rec"], h, m.rglru,
                                              compute_dtype=cd)
        if cache_len:
            cache = {"conv": conv.to(cache_dtype), "h": h_t}
        x = x + a
        h = norm_apply(m, p["ln2"], x)
        return x + L.mlp_apply(p["mlp"], h, m.act, cd), aux, cache
    if kind == "dec":
        h = norm_apply(m, p["ln1"], x)
        a, (k, v) = L.gqa_apply(p["attn"], h, dims, positions, cd)
        x = x + a
        h = norm_apply(m, p["lnx"], x)
        xa, (ck, cv) = _cross_attend(p["xattn"], h, enc_out, dims, cd)
        x = x + xa
        if cache_len:
            c = min(cache_len, m.encdec.max_target_positions)
            cache = {"k": place_kv(k, c, 0, cache_dtype),
                     "v": place_kv(v, c, 0, cache_dtype),
                     "ck": ck.to(cache_dtype),
                     "cv": cv.to(cache_dtype)}
        h = norm_apply(m, p["ln2"], x)
        return x + L.mlp_apply(p["mlp"], h, m.act, cd), aux, cache
    raise ValueError(kind)


def _cross_attend(p, h, enc_out, dims: AttnDims, cd):
    """Cross attention: queries from h, K/V from the encoder output (no
    rope).  Returns (out, (k, v)) so prefill can cache the cross K/V."""
    b, s, _ = h.shape
    se = enc_out.shape[1]
    dev = h.device
    q = L.dense_apply(p["wq"], h, cd).reshape(b, s, dims.num_heads,
                                              dims.head_dim)
    k = L.dense_apply(p["wk"], enc_out, cd).reshape(b, se, dims.num_kv_heads,
                                                    dims.head_dim)
    v = L.dense_apply(p["wv"], enc_out, cd).reshape(b, se, dims.num_kv_heads,
                                                    dims.head_dim)
    o = L.attention(q, k, v, torch.zeros((s,), dtype=torch.int64, device=dev),
                    torch.zeros((se,), dtype=torch.int64, device=dev))
    o = o.reshape(b, s, dims.num_heads * dims.head_dim)
    return L.dense_apply(p["wo"], o, cd), (k, v)


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------

def block_state_init(kind: str, m: ModelConfig, batch: int, cache_len: int,
                     dtype, device=None) -> Dict[str, Any]:
    """Zero decode-state for one block. cache_len already window-clipped."""
    d = m.d_model

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if kind in ("attn", "moe"):
        c = min(cache_len, m.sliding_window) if m.attention == "sliding" \
            else cache_len
        return {"k": zeros(batch, c, m.num_kv_heads, m.head_dim),
                "v": zeros(batch, c, m.num_kv_heads, m.head_dim)}
    if kind == "mla":
        return {"ckv": zeros(batch, cache_len, m.mla.kv_lora_rank),
                "krope": zeros(batch, cache_len, m.mla.rope_head_dim)}
    if kind == "rwkv":
        h = d // m.rwkv.head_dim
        n = m.rwkv.head_dim
        return {"x_time": zeros(batch, d), "x_chan": zeros(batch, d),
                "S": zeros(batch, h, n, n, dt=torch.float32)}
    if kind == "rglru":
        lw = m.rglru.lru_width or d
        return {"conv": zeros(batch, m.rglru.conv_width - 1, lw),
                "h": zeros(batch, lw, dt=torch.float32)}
    if kind == "dec":
        c = min(cache_len, m.encdec.max_target_positions)
        se = m.encdec.encoder_seq
        return {"k": zeros(batch, c, m.num_kv_heads, m.head_dim),
                "v": zeros(batch, c, m.num_kv_heads, m.head_dim),
                "ck": zeros(batch, se, m.num_kv_heads, m.head_dim),
                "cv": zeros(batch, se, m.num_kv_heads, m.head_dim)}
    raise ValueError(kind)


def block_state_specs(kind: str, m: ModelConfig) -> Dict[str, Any]:
    """Logical axes for decode state (leading dim = batch).

    The cache sequence dim is sharded over the model axis ("seq"): at
    long_500k (batch 1) that is the only way the cache spreads, and at
    decode_32k it keeps the scores from replicating.  "kv" heads come
    after "seq" and only claim an axis when one is left and divisible.
    """
    if kind in ("attn", "moe"):
        return {"k": Lg("batch", "seq", "kv", None),
                "v": Lg("batch", "seq", "kv", None)}
    if kind == "mla":
        return {"ckv": Lg("batch", "seq", None),
                "krope": Lg("batch", "seq", None)}
    if kind == "rwkv":
        return {"x_time": Lg("batch", None), "x_chan": Lg("batch", None),
                "S": Lg("batch", "heads", None, None)}
    if kind == "rglru":
        return {"conv": Lg("batch", None, "mlp"), "h": Lg("batch", "mlp")}
    if kind == "dec":
        return {"k": Lg("batch", None, "kv", None),
                "v": Lg("batch", None, "kv", None),
                "ck": Lg("batch", None, "kv", None),
                "cv": Lg("batch", None, "kv", None)}
    raise ValueError(kind)


def block_decode(kind: str, p, x, state, index: int, m: ModelConfig, cd
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-token decode through one block. x: (B,1,d).  The attention
    and latent caches are updated in place (see :func:`~repro_torch.models.
    layers.gqa_decode`)."""
    dims = attn_dims(m)
    if kind in ("attn", "moe"):
        h = norm_apply(m, p["ln1"], x)
        a, (ck, cv) = L.gqa_decode(p["attn"], h, state["k"], state["v"],
                                   index, dims, cd)
        x = x + a
        h = norm_apply(m, p["ln2"], x)
        if kind == "moe":
            y, _ = MOE_M.moe_apply(p["mlp"], h, m.moe, cd)
        else:
            y = L.mlp_apply(p["mlp"], h, m.act, cd)
        return x + y, {"k": ck, "v": cv}
    if kind == "mla":
        h = norm_apply(m, p["ln1"], x)
        a, (ckv, krope) = MLA.mla_decode(p["attn"], h, state["ckv"],
                                         state["krope"], index, m.num_heads,
                                         m.head_dim, m.mla, m.rope_theta, cd)
        x = x + a
        h = norm_apply(m, p["ln2"], x)
        y, _ = MOE_M.moe_apply(p["mlp"], h, m.moe, cd)
        return x + y, {"ckv": ckv, "krope": krope}
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
    if kind == "rglru":
        h = norm_apply(m, p["ln1"], x)
        a, (conv, h_t) = RG.rglru_block_apply(p["rec"], h, m.rglru,
                                              conv_state=state["conv"],
                                              h0=state["h"], compute_dtype=cd)
        x = x + a
        h = norm_apply(m, p["ln2"], x)
        return x + L.mlp_apply(p["mlp"], h, m.act, cd), \
            {"conv": conv.to(state["conv"].dtype), "h": h_t}
    if kind == "dec":
        h = norm_apply(m, p["ln1"], x)
        a, (ck, cv) = L.gqa_decode(p["attn"], h, state["k"], state["v"],
                                   index, dims, cd)
        x = x + a
        h = norm_apply(m, p["lnx"], x)
        x = x + _cross_decode(p["xattn"], h, state["ck"], state["cv"], dims,
                              cd)
        h = norm_apply(m, p["ln2"], x)
        y = L.mlp_apply(p["mlp"], h, m.act, cd)
        return x + y, {"k": ck, "v": cv, "ck": state["ck"], "cv": state["cv"]}
    raise ValueError(kind)


def _cross_decode(p, h, ck, cv, dims: AttnDims, cd):
    b = h.shape[0]
    dev = h.device
    q = L.dense_apply(p["wq"], h, cd).reshape(b, 1, dims.num_heads,
                                              dims.head_dim)
    se = ck.shape[1]
    o = L.attention(q, ck.to(q.dtype), cv.to(q.dtype),
                    torch.zeros((1,), dtype=torch.int64, device=dev),
                    torch.zeros((se,), dtype=torch.int64, device=dev))
    o = o.reshape(b, 1, dims.num_heads * dims.head_dim)
    return L.dense_apply(p["wo"], o, cd)
