"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; port of
``repro/models/mla.py``).

KV are compressed to a rank-``kv_lora_rank`` latent c_kv plus a shared
decoupled-RoPE key k_rope.  Two execution forms:

  * **expanded** (train/prefill): latents are up-projected to full per-head
    K/V and the plain attention runs (no kernel, as in the reference).
  * **absorbed** (decode): W_uk is absorbed into the query and W_uv into the
    output so attention runs *in latent space* against the cached
    (S, kv_lora + rope_dim) latents, in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (NEG_INF, _normal, apply_rope,
                                       attention, dense_apply, dense_init,
                                       dense_specs, rmsnorm_apply,
                                       rmsnorm_init, rmsnorm_specs)
from repro_torch.sharding.specs import Lg


def mla_init(gen, d: int, num_heads: int, head_dim: int, cfg,
             dtype=torch.float32):
    """cfg: MLAConfig.  head_dim is the nope (non-rope) per-head dim."""
    rk, rh = cfg.kv_lora_rank, cfg.rope_head_dim
    vh = cfg.v_head_dim or head_dim
    qd = num_heads * (head_dim + rh)
    return {
        "wq": dense_init(gen, d, qd, dtype),           # full-rank q (V2-Lite)
        "w_dkv": dense_init(gen, d, rk + rh, dtype),   # downproj + rope k
        "kv_norm": rmsnorm_init(rk, dtype, gen.device),
        "w_uk": _normal(gen, (num_heads, rk, head_dim), rk ** -0.5, dtype),
        "w_uv": _normal(gen, (num_heads, rk, vh), rk ** -0.5, dtype),
        "wo": dense_init(gen, num_heads * vh, d, dtype,
                         scale=(num_heads * vh) ** -0.5),
    }


def mla_specs(cfg):
    return {
        "wq": dense_specs("embed", "mlp"),
        "w_dkv": dense_specs("embed", None),
        "kv_norm": rmsnorm_specs(),
        "w_uk": Lg("heads", None, None),
        "w_uv": Lg("heads", None, None),
        "wo": dense_specs("mlp", "embed"),
    }


def _split_q(q, num_heads, head_dim, rh):
    b, s, _ = q.shape
    q = q.reshape(b, s, num_heads, head_dim + rh)
    return q[..., :head_dim], q[..., head_dim:]


def mla_latents(p, x, positions, cfg, rope_theta, compute_dtype=None):
    """Compress x -> (c_kv normalized, k_rope with rope applied)."""
    rk = cfg.kv_lora_rank
    dkv = dense_apply(p["w_dkv"], x, compute_dtype)
    c_kv, k_rope = dkv[..., :rk], dkv[..., rk:]
    c_kv = rmsnorm_apply(p["kv_norm"], c_kv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_apply(p, x, num_heads, head_dim, cfg, positions=None,
              rope_theta=10000.0, compute_dtype=None):
    """Expanded-form self-attention for train/prefill. x: (B, S, d)."""
    b, s, _ = x.shape
    rh = cfg.rope_head_dim
    vh = cfg.v_head_dim or head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = dense_apply(p["wq"], x, compute_dtype)
    q_nope, q_rope = _split_q(q, num_heads, head_dim, rh)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    c_kv, k_rope = mla_latents(p, x, positions, cfg, rope_theta,
                               compute_dtype)

    cd = compute_dtype or x.dtype
    k_nope = torch.einsum("bsr,hrd->bshd", c_kv.to(cd), p["w_uk"].to(cd))
    v = torch.einsum("bsr,hrv->bshv", c_kv.to(cd), p["w_uv"].to(cd))

    # expanded MLA is standard MHA with per-head K = [k_nope, k_rope
    # (shared)], Q = [q_nope, q_rope]
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], rh).to(cd)], dim=-1)
    out = attention(qf, kf, v, positions, positions)
    out = out.reshape(b, s, num_heads * vh)
    return dense_apply(p["wo"], out, compute_dtype), (c_kv, k_rope)


def mla_decode(p, x, cache_ckv, cache_krope, index: int, num_heads,
               head_dim, cfg, rope_theta=10000.0, compute_dtype=None):
    """Absorbed-form single-token decode.

    cache_ckv: (B, S, rk); cache_krope: (B, S, rh); index: the current
    position (a Python int).  Attention runs in latent space: q_lat =
    q_nope @ W_uk, scores = q_lat . c_kv + q_rope . k_rope, out = (probs @
    c_kv) @ W_uv.  The new latents are written into the caches in place,
    at ``index`` clamped to the last slot (as ``dynamic_update_slice``
    clamps), and the caches are returned."""
    b = x.shape[0]
    rh = cfg.rope_head_dim
    vh = cfg.v_head_dim or head_dim
    pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
    q = dense_apply(p["wq"], x, compute_dtype)
    q_nope, q_rope = _split_q(q, num_heads, head_dim, rh)     # (B,1,H,*)
    q_rope = apply_rope(q_rope, pos, rope_theta)
    c_kv, k_rope = mla_latents(p, x, pos, cfg, rope_theta, compute_dtype)

    s_cache = cache_ckv.shape[1]
    slot = min(index, s_cache - 1)
    cache_ckv[:, slot:slot + 1] = c_kv.to(cache_ckv.dtype)
    cache_krope[:, slot:slot + 1] = k_rope.to(cache_krope.dtype)

    cd = compute_dtype or x.dtype
    f32 = torch.float32
    # absorb W_uk into q: (B,1,H,dh) x (H,rk,dh) -> (B,H,rk)
    q_lat = torch.einsum("bqhd,hrd->bhr", q_nope.to(f32), p["w_uk"].to(f32))
    scale = (head_dim + rh) ** -0.5
    logits = (torch.einsum("bhr,bsr->bhs", q_lat, cache_ckv.to(f32))
              + torch.einsum("bqhd,bsd->bhs", q_rope.to(f32),
                             cache_krope.to(f32))) * scale
    valid = torch.arange(s_cache, device=x.device) <= index
    logits = torch.where(valid[None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # out latent: (B,H,rk); absorb W_uv on the way out
    o_lat = torch.einsum("bhs,bsr->bhr", probs, cache_ckv.to(f32))
    out = torch.einsum("bhr,hrv->bhv", o_lat, p["w_uv"].to(f32))
    out = out.reshape(b, 1, num_heads * vh).to(cd)
    return dense_apply(p["wo"], out, compute_dtype), (cache_ckv, cache_krope)
