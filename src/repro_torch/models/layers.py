"""Core layers: norms, linear, embedding, RoPE, SwiGLU MLP, GQA attention
(port of ``repro/models/layers.py``).

Pure functions over parameter trees, as in the reference:
``*_init(gen, ...) -> params`` (nested dict of tensors with the JAX keys
and leaf shapes: a dense ``w`` is ``(d_in, d_out)``, so ``dense_apply`` is
``x @ w``), ``*_specs(...) -> the matching tree of Lg logical-axis
leaves`` and ``*_apply(params, x, ...) -> y``.  The ``constrain`` calls
mark activations with logical axes at the reference's sites; they are the
identity unless an activation policy is installed
(``sharding/specs.py``).

``*_init`` draws from a ``torch.Generator`` on the parameters' device, so a
seed gives other numbers than the JAX key stream; the parity tests carry
the JAX parameters across with :mod:`repro_torch.bridge`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import train as flash_train
from repro_torch.kernels.head_gemm import ops as head_gemm
from repro_torch.obs.trace import count
from repro_torch.sharding.specs import Lg, constrain

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype
            ) -> torch.Tensor:
    """``scale`` x a standard normal, drawn in fp32 on ``gen``'s device."""
    return (scale * torch.randn(shape, generator=gen, device=gen.device,
                                dtype=torch.float32)).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32, scale=None,
               bias: bool = False):
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense_specs(l_in, l_out, bias: bool = False):
    p = {"w": Lg(l_in, l_out)}
    if bias:
        p["b"] = Lg(l_out)
    return p


def dense_apply(p, x, compute_dtype=None):
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_specs():
    return {"scale": Lg(None)}


def rmsnorm_apply(p, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_specs():
    return {"scale": Lg(None), "bias": Lg(None)}


def layernorm_apply(p, x, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def embedding_init(gen, vocab: int, d: int, dtype=torch.float32):
    return {"table": _normal(gen, (vocab, d), 0.02, dtype)}


def embedding_specs():
    return {"table": Lg("vocab", "embed")}


def embedding_apply(p, ids, compute_dtype=None):
    t = p["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    return t[ids]


def _f32_matmul(x, w):
    """``x @ w`` with fp32 accumulation and an fp32 result, as the
    reference's ``preferred_element_type=float32`` contractions.  Dispatch:
    bf16 ``x`` and fp32 ``w`` on CUDA with enough rows
    (``kernels/head_gemm/ops.py`` ``takes``) go through the split-bf16
    tensor-core kernels, which keep every product exact in fp32; every
    other call runs the plain form, both operands in fp32.  Under a tracer
    each call counts ``head_kernel`` or ``head_plain``."""
    kernel = head_gemm.takes(x, w)
    count(head_kernel=int(kernel), head_plain=int(not kernel))
    if kernel:
        return head_gemm.head_matmul(x, w)
    return head_gemm.head_matmul_plain(x, w)


def unembed_apply(p, x):
    """Tied unembedding: ``x @ table^T``, fp32 accumulation and result."""
    return _f32_matmul(x, p["table"].t())


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (fp32)."""
    pos = torch.arange(length, device=device)[:, None].to(torch.float32)
    dim = torch.arange(d // 2, device=device)[None, :].to(torch.float32)
    inv = torch.exp(-torch.log(torch.tensor(10000.0)) * dim
                    / (d // 2 - 1 + 1e-9))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention scale ``0.1 * mscale * ln(factor) + 1`` (1 where
    the factor does not stretch)."""
    if factor <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(head_dim: int, theta: float, factor: float,
               original_max_position: int, beta_fast: float,
               beta_slow: float, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies (DeepSeek-V2's rotary embedding): the
    plain ones below the correction range, the plain ones over ``factor``
    above it, and a linear ramp between.  The range is the dims that turn
    ``beta_fast`` and ``beta_slow`` times over ``original_max_position``."""
    def corr(rotations):
        return (head_dim * math.log(original_max_position
                                    / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1.0 - ramp                   # the share of the plain frequency
    extra = rope_freqs(head_dim, theta, device)
    inter = 1.0 / (factor * theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    return inter * (1 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Half-split
    rotation (the first and second halves of head_dim pair up), as the
    reference, not interleaved.  ``freqs`` replaces the plain inverse
    frequencies (YaRN's)."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    if freqs is None:
        freqs = rope_freqs(hd, theta, x.device)             # (hd/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x32 = x.to(torch.float32)
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, d_ff: int, act: str = "silu", dtype=torch.float32):
    if act == "silu":   # SwiGLU: gate + up + down
        return {"gate": dense_init(gen, d, d_ff, dtype),
                "up": dense_init(gen, d, d_ff, dtype),
                "down": dense_init(gen, d_ff, d, dtype)}
    return {"up": dense_init(gen, d, d_ff, dtype, bias=True),
            "down": dense_init(gen, d_ff, d, dtype, bias=True)}


def mlp_specs(act: str = "silu"):
    if act == "silu":
        return {"gate": dense_specs("embed", "mlp"),
                "up": dense_specs("embed", "mlp"),
                "down": dense_specs("mlp", "embed")}
    return {"up": dense_specs("embed", "mlp", bias=True),
            "down": dense_specs("mlp", "embed", bias=True)}


def mlp_apply(p, x, act: str = "silu", compute_dtype=None):
    # the hidden activations shard over "mlp", as the column/row-parallel
    # weights do
    if act == "silu":
        g = dense_apply(p["gate"], x, compute_dtype)
        u = dense_apply(p["up"], x, compute_dtype)
        h = constrain(F.silu(g) * u, ("batch", None, "mlp"))
        return dense_apply(p["down"], h, compute_dtype)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dense_apply(p["up"], x, compute_dtype), approximate="tanh")
    h = constrain(h, ("batch", None, "mlp"))
    return dense_apply(p["down"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv*groups, hd) by repetition (GQA)."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


def attention_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                          window: int = 0) -> torch.Tensor:
    """(Lq, Lk) bool mask: causal, optionally banded to a sliding window."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window and window > 0:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def attention_full(q, k, v, q_pos, k_pos, window: int = 0,
                   kv_valid: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention. q: (B,Lq,H,hd); k,v: (B,Lk,Hkv,hd).  The
    scores are scaled by ``scale`` (default ``hd ** -0.5``)."""
    groups = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    mask = attention_scores_mask(q_pos, k_pos, window)            # (Lq, Lk)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]                  # (B,1,1,Lk)
    else:
        mask = mask[None, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention_chunked(q, k, v, q_pos, k_pos, window: int = 0,
                      kv_valid: Optional[torch.Tensor] = None,
                      kv_chunk: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention, looping over KV chunks: O(Lq * kv_chunk)
    live scores instead of O(Lq * Lk)."""
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    if lk % kv_chunk != 0:
        pad = kv_chunk - lk % kv_chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2 ** 30)
        if kv_valid is None:
            kv_valid = (torch.arange(lk + pad, device=q.device)[None, :]
                        < lk).expand(b, lk + pad)
        else:
            kv_valid = F.pad(kv_valid, (0, pad), value=False)
        lk += pad
    groups = q.shape[2] // k.shape[2]
    if scale is None:
        scale = hd ** -0.5
    vd = v.shape[-1]
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, lq, vd), dtype=torch.float32, device=q.device)
    q32 = q.to(torch.float32)
    for c0 in range(0, lk, kv_chunk):
        kcj = _repeat_kv(k[:, c0:c0 + kv_chunk], groups)
        vcj = _repeat_kv(v[:, c0:c0 + kv_chunk], groups)
        logits = torch.einsum("bqhd,bkhd->bhqk", q32,
                              kcj.to(torch.float32)) * scale
        mask = attention_scores_mask(q_pos, k_pos[c0:c0 + kv_chunk], window)
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, None, c0:c0 + kv_chunk]
        else:
            mask = mask[None, None]
        logits = torch.where(mask, logits, NEG_INF)
        m_cur = torch.amax(logits, dim=-1)
        m_new = torch.maximum(m, m_cur)
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vcj.dtype).to(torch.float32),
            vcj.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)          # (B, Lq, H, hd)


def attention(q, k, v, q_pos, k_pos, window: int = 0,
              kv_valid: Optional[torch.Tensor] = None,
              kv_chunk: int = 1024, force_full: bool = False,
              scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch.  CUDA bf16 self-attention at an instantiated head_dim
    (``kernels/flash_attention/train.py`` ``takes``) goes through the
    training flash kernels, under autograd or not (training, no-grad
    forwards, serving's prefill); every other call runs the plain path:
    the full einsum for short KV, chunked online softmax beyond.  A
    self-attention caller passes one position tensor as both ``q_pos`` and
    ``k_pos`` (or views of the same memory): equal positions in two
    distinct tensors take the plain path.  Under a tracer each call counts
    ``attn_kernel`` or ``attn_plain``."""
    kernel = flash_train.takes(q, k, v, q_pos, k_pos, kv_valid)
    count(attn_kernel=int(kernel), attn_plain=int(not kernel))
    if kernel:
        return flash_train.flash_attention_train(q, k, v, q_pos,
                                                 window=window, scale=scale)
    if force_full or k.shape[1] <= kv_chunk:
        return attention_full(q, k, v, q_pos, k_pos, window, kv_valid,
                              scale)
    return attention_chunked(q, k, v, q_pos, k_pos, window, kv_valid,
                             kv_chunk, scale)


# ---------------------------------------------------------------------------
# GQA attention block (projections + rope + qk-norm + cache handling)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0          # 0 => full causal


def gqa_init(gen, dims: AttnDims, dtype=torch.float32):
    d, q_dim = dims.d_model, dims.num_heads * dims.head_dim
    kv_dim = dims.num_kv_heads * dims.head_dim
    p = {"wq": dense_init(gen, d, q_dim, dtype, bias=dims.qkv_bias),
         "wk": dense_init(gen, d, kv_dim, dtype, bias=dims.qkv_bias),
         "wv": dense_init(gen, d, kv_dim, dtype, bias=dims.qkv_bias),
         "wo": dense_init(gen, q_dim, d, dtype, scale=(q_dim ** -0.5))}
    if dims.qk_norm:
        p["q_norm"] = rmsnorm_init(dims.head_dim, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(dims.head_dim, dtype, gen.device)
    return p


def gqa_specs(dims: AttnDims):
    p = {"wq": dense_specs("embed", "mlp", bias=dims.qkv_bias),
         "wk": dense_specs("embed", "kv", bias=dims.qkv_bias),
         "wv": dense_specs("embed", "kv", bias=dims.qkv_bias),
         "wo": dense_specs("mlp", "embed")}
    if dims.qk_norm:
        p["q_norm"] = rmsnorm_specs()
        p["k_norm"] = rmsnorm_specs()
    return p


def gqa_project_qkv(p, x, dims: AttnDims, positions, compute_dtype=None,
                    rope: bool = True):
    b, s, _ = x.shape
    q = dense_apply(p["wq"], x, compute_dtype).reshape(
        b, s, dims.num_heads, dims.head_dim)
    k = dense_apply(p["wk"], x, compute_dtype).reshape(
        b, s, dims.num_kv_heads, dims.head_dim)
    v = dense_apply(p["wv"], x, compute_dtype).reshape(
        b, s, dims.num_kv_heads, dims.head_dim)
    if dims.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
        k = rmsnorm_apply(p["k_norm"], k)
    if rope:
        q = apply_rope(q, positions, dims.rope_theta)
        k = apply_rope(k, positions, dims.rope_theta)
    # heads shard over the model axis (kv heads too when they divide it)
    q = constrain(q, ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "kv", None))
    v = constrain(v, ("batch", None, "kv", None))
    return q, k, v


def gqa_apply(p, x, dims: AttnDims, positions=None, compute_dtype=None,
              kv_chunk: int = 1024, use_kernel: bool = False):
    """Training/prefill self-attention over a (B, S, d) sequence.

    use_kernel=True goes through the flash-attention op (the hand-written
    CUDA kernel for a CUDA tensor, its plain version for a CPU tensor);
    otherwise the plain full / chunked attention runs."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    pos_b = (positions.expand(s) if positions.dim() == 1 else positions)
    q, k, v = gqa_project_qkv(p, x, dims, pos_b, compute_dtype)
    if use_kernel:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        out = flash_attention(q, k, v, causal=True, window=dims.window)
    else:
        out = attention(q, k, v, pos_b, pos_b, window=dims.window,
                        kv_chunk=kv_chunk)
    out = out.reshape(b, s, dims.num_heads * dims.head_dim)
    return dense_apply(p["wo"], out, compute_dtype), (k, v)


def gqa_decode(p, x, cache_k, cache_v, index: int, dims: AttnDims,
               compute_dtype=None, kv_chunk: int = 1024):
    """Single-token decode against a KV cache.

    x: (B, 1, d); cache_k/v: (B, S_cache, Hkv, hd); index: current position
    (a Python int).  Sliding-window archs use a ring buffer of size
    ``window``.  The new K/V are written into ``cache_k``/``cache_v`` in
    place (the reference returns updated copies), and the caches are
    returned.  Past the end of a full cache (whisper's decoder cache is
    clipped to its 448 positions) the write lands in the last slot, as
    the reference's ``dynamic_update_slice`` clamps it."""
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    dev = x.device
    pos = torch.full((1,), index, dtype=torch.int64, device=dev)
    q, k, v = gqa_project_qkv(p, x, dims, pos, compute_dtype)
    slot = index % s_cache if dims.window else min(index, s_cache - 1)
    cache_k[:, slot:slot + 1] = k.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v.to(cache_v.dtype)
    j = torch.arange(s_cache, device=dev)
    if dims.window:
        # ring buffer: absolute position of slot j given write head at `slot`
        k_pos = index - torch.remainder(slot - j, s_cache)
        valid = (k_pos >= 0) & (k_pos >= index - dims.window + 1)
    else:
        k_pos = j
        valid = j <= index
    valid_b = valid[None, :].expand(b, s_cache)
    out = attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype), pos, k_pos,
                    window=0, kv_valid=valid_b, kv_chunk=kv_chunk)
    out = out.reshape(b, 1, dims.num_heads * dims.head_dim)
    return dense_apply(p["wo"], out, compute_dtype), (cache_k, cache_v)
