"""Plain PyTorch reference of one pipeline stage of DeepSeek-V2-Lite
training (arXiv:2405.04434; the published config.json), imported from
nothing of the program.

The leading dense layers, then the MoE layers, each: RMSNorm, multi-head
latent attention, a residual add, RMSNorm, the MLP, a residual add.

Attention (MLA, full-rank queries): ``q = h Wq`` split into a 128-wide
part and a 64-wide rope part a head; ``[c, k_pe] = h Wdkv``, the latent
``c`` (512) RMS-normalised; keys ``[c Wuk_h, k_pe]`` (``k_pe`` shared by
the heads), values ``c Wuv_h``.  The rope parts turn by YaRN, with the
configuration file's published ``rope_scaling``: with d = 64, base
10,000, s = ``factor``, L0 = ``original_max_position_embeddings``,
``corr(r) = d ln(L0 / (2 pi r)) / (2 ln base)``,
``low = floor(corr(beta_fast))``, ``high = ceil(corr(beta_slow))``
clamped to [0, d - 1], ``ramp_i = clamp((i - low) / (high - low), 0, 1)``,
``inv_freq_i = base^(-2i/d) / s x ramp_i + base^(-2i/d) x (1 - ramp_i)``,
cos and sin times ``m(s, mscale) / m(s, mscale_all_dim)`` with
``m(s, a) = 0.1 a ln s + 1``; half-split pairs (the port's, a fixed
permutation of the released weights' interleaved columns).  Scores are
scaled by ``(128 + 64) ** -0.5 x m(s, mscale_all_dim) ** 2``; causal
softmax.

MLP: a dense SwiGLU of ``d_ff`` in the leading layers; in the MoE
layers a softmax router over all the routed experts (``num_experts x
expert_shards``), the top-k of each token (the lower index first among
equal probabilities) with their softmax weights as they are
(``norm_topk_prob`` false), and SwiGLU experts; this card holds the
``expert_shard``-th of ``expert_shards`` equal shards and computes only
the token-slots routed to those, whose weighted outputs are its part of
the layer's result, plus the shared experts (one SwiGLU of
``num_shared_experts x d_ff_expert``).  The loss is next-token cross
entropy through a final RMSNorm and the fp32 output head, plus the aux
term.

The port's departures, as the configuration file states them, are
followed: capacity ``max(top_k, floor(tokens x top_k x 2.0 / E) + 1)``
of each expert in each dispatch group (the largest count up to 32 that
leaves at least ``4 x top_k`` tokens a group), the token-slots past it
dropped, in token order, where DeepSeek-V2 drops at device level; the
Switch aux term ``E x sum_e f_e P_e x router_aux_coef`` of each group,
averaged over groups and summed over layers, where the published model
uses a per-sequence expert balance loss; the head's product in fp32.

The step (micro-batches, fp32 accumulation, clip, AdamW, schedule), the
bf16 products, remat by ``torch.utils.checkpoint`` a layer and the
``lowp`` fp8 control are ``reference/olmoe-1b-7b.py``'s, from a copy of
that module of this file's own, whose step runs this model's loss.  TF32
is off for matrix products and cuDNN.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.common import reference

olmoe = reference("olmoe-1b-7b")
BF16 = torch.bfloat16
rmsnorm = olmoe.rmsnorm


def yarn_mscale(s: float, a: float) -> float:
    return 0.1 * a * math.log(s) + 1.0 if s > 1 else 1.0


def yarn_inv_freq(m, device) -> torch.Tensor:
    """The rope part's inverse frequencies, in fp32 as DeepSeek-V2's
    reference code computes them."""
    ys = m["rope_scaling"]
    d, base, s = m["rope_head_dim"], m["rope_theta"], ys["factor"]
    dims = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    extra = 1.0 / (base ** dims)
    if s <= 1:
        return extra
    inter = 1.0 / (s * base ** dims)

    def corr(r):
        return d * math.log(ys["original_max_position_embeddings"]
                            / (2 * math.pi * r)) / (2 * math.log(base))
    low = max(math.floor(corr(ys["beta_fast"])), 0)
    high = min(math.ceil(corr(ys["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rope(x: torch.Tensor, m) -> torch.Tensor:
    """Half-split rotation of ``x`` (b, s, heads, d) at positions 0.."""
    s = x.shape[1]
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * yarn_inv_freq(m, x.device)
    ys = m["rope_scaling"]
    c = yarn_mscale(ys["factor"], ys["mscale"]) / yarn_mscale(
        ys["factor"], ys["mscale_all_dim"])
    cos, sin = torch.cos(ang)[:, None, :] * c, torch.sin(ang)[:, None, :] * c
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def softmax_scale(m) -> float:
    ys = m["rope_scaling"]
    scale = (m["head_dim"] + m["rope_head_dim"]) ** -0.5
    if ys["factor"] > 1 and ys["mscale_all_dim"]:
        a = yarn_mscale(ys["factor"], ys["mscale_all_dim"])
        scale = scale * a * a
    return scale


def mla(ops, p, h, m):
    b, s, _ = h.shape
    nh, nope, r = m["num_heads"], m["head_dim"], m["rope_head_dim"]
    vh, rk = m["v_head_dim"], m["kv_lora_rank"]
    q = ops.mm(h, p["wq"]["w"]).reshape(b, s, nh, nope + r)
    dkv = ops.mm(h, p["w_dkv"]["w"])
    c = rmsnorm(dkv[..., :rk], p["kv_norm"]["scale"], m["norm_eps"])
    k_pe = rope(dkv[..., rk:][:, :, None, :], m)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], m)], dim=-1)
    # the latent's per-head up-projections, as one product each
    k_nope = ops.mm(c, p["w_uk"].permute(1, 0, 2).reshape(rk, nh * nope))
    v = ops.mm(c, p["w_uv"].permute(1, 0, 2).reshape(rk, nh * vh))
    k = torch.cat([k_nope.reshape(b, s, nh, nope),
                   k_pe.expand(b, s, nh, r)], dim=-1)
    v = v.reshape(b, s, nh, vh)
    qh, kh = q.transpose(1, 2).float(), k.transpose(1, 2).float()
    scores = ops.bmm(qh, kh.transpose(-1, -2)) * softmax_scale(m)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = ops.bmm(probs.to(BF16), v.transpose(1, 2))
    out = out.transpose(1, 2).reshape(b, s, nh * vh)
    return ops.mm(out, p["wo"]["w"])


def swiglu(ops, p, h):
    return ops.mm(F.silu(ops.mm(h, p["gate"]["w"])) * ops.mm(h, p["up"]["w"]),
                  p["down"]["w"])


def moe(ops, p, h, m, stats):
    """This card's part of the MoE layer over the tokens of ``h``, with the
    shared experts; returns (y, aux)."""
    b, s, d = h.shape
    held, k = m["num_experts"], m["top_k"]
    e = held * m["expert_shards"]
    e0 = held * m["expert_shard"]
    t = b * s
    g = olmoe.dispatch_groups(t, k)
    tg = t // g
    cap = int(max(k, math.floor(tg * k * m["capacity_factor"] / e) + 1))
    x = h.reshape(g, tg, d)
    probs = torch.softmax(ops.mm(x, p["router"]["w"]).float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    if m["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    chosen = F.one_hot(top_i, e).sum(2).float()             # (g, tg, e)
    f = chosen.sum(1) / (tg * k + 1e-9)
    aux = (e * (f * probs.mean(1)).sum(-1)).mean() * m["router_aux_coef"]
    before = torch.cumsum(chosen, dim=1) - chosen            # earlier tokens
    keep = torch.gather(before, 2, top_i) < cap              # (g, tg, k)
    here = (top_i >= e0) & (top_i < e0 + held)
    stats["dropped"] += int((~keep & here).sum())
    load = chosen.sum(1).max(-1).values / (tg * k / e)
    stats["load_max"] = max(stats.get("load_max", 0.0), float(load.max()))
    xf = x.reshape(t, d)
    ids, w, kp = top_i.reshape(t, k), top_p.reshape(t, k), keep.reshape(t, k)
    out = torch.zeros(t, d, dtype=torch.float32, device=h.device)
    ex = p["experts"]
    for j in range(held):
        sel = (ids == e0 + j) & kp
        rows = sel.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        wt = (w * sel).sum(-1)[rows]
        xe = xf[rows]
        he = F.silu(ops.mm(xe, ex["gate"][j])) * ops.mm(xe, ex["up"][j])
        ye = ops.mm(he, ex["down"][j])
        out = out.index_add(0, rows, ye.float() * wt[:, None])
    y = out.to(h.dtype).reshape(b, s, d)
    return y + swiglu(ops, p["shared"], h), aux


def layer(ops, p, x, m, stats, dense: bool):
    eps = m["norm_eps"]
    x = x + mla(ops, p["attn"], rmsnorm(x, p["ln1"]["scale"], eps), m)
    h = rmsnorm(x, p["ln2"]["scale"], eps)
    if dense:
        return x + swiglu(ops, p["mlp"], h), torch.zeros((), device=x.device)
    y, aux = moe(ops, p["mlp"], h, m, stats)
    return x + y, aux


def lm_loss(ops, params, tokens, labels, m, stats):
    x = params["embed"]["table"].to(BF16)[tokens]
    aux_total = torch.zeros((), device=x.device)
    lead = m["first_dense_layers"]
    blocks = [(params["lead"][f"l{i}"], True) for i in range(lead)]
    # each stacked leaf unbound once (see reference/olmoe-1b-7b.py)
    st = olmoe._unbind(params["stack"]["b0"])
    blocks += [(olmoe._index(st, i), False)
               for i in range(m["num_layers"] - lead)]
    for p, dense in blocks:
        def run(x, p=p, dense=dense):
            return layer(ops, p, x, m, stats, dense)
        x, aux = checkpoint(run, x, use_reentrant=False)
        aux_total = aux_total + aux
    h = rmsnorm(x, params["final_norm"]["scale"], m["norm_eps"])
    logits = h.float() @ params["head"]["w"].float()
    nll = torch.logsumexp(logits, -1) \
        - torch.gather(logits, -1, labels[..., None])[..., 0]
    xent = nll.mean()
    return xent + aux_total, xent


# this file's copy of the OLMoE reference runs its step on this model
olmoe.lm_loss = lm_loss


def run(config: Dict[str, Any], weights, batches: List[Dict[str, Any]], *,
        device, lowp: bool = False, other_grad1=None,
        keep: bool = False) -> Dict[str, Any]:
    """The reference's record of ``len(batches)`` training steps, as
    ``reference/olmoe-1b-7b.py``'s ``run`` gives it."""
    m, o, par = config["model"], config["optim"], config["parallel"]
    m = {**m, "rope_scaling": config["rope_scaling"]}
    if o["schedule"] != "cosine" or par["compute_dtype"] != "bfloat16":
        raise ValueError("the reference runs bf16 products, cosine schedule")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return olmoe._run(m, o, int(par["microbatches"]), weights, batches,
                          torch.device(device), olmoe.Ops(lowp),
                          other_grad1, keep)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
