"""Plain PyTorch reference of one pipeline stage of OLMoE training
(arXiv:2409.02060), imported from nothing of the program.

Each layer: RMSNorm, attention (q, k, v projections, RMSNorm of each
query and key head, half-split RoPE, causal softmax attention, output
projection), a residual add, RMSNorm, the routed experts, a residual add.
The router is a softmax over the experts; each token takes its top-k
(the lower index first among equal probabilities), their weights
normalised to sum to 1; experts are SwiGLU.  The loss is next-token cross
entropy through a final RMSNorm and the output head, plus the Switch
load-balance term (``E x sum_e f_e P_e x router_aux_coef``, each dispatch
group's, averaged over the groups, summed over layers).

Departure from OLMoE's dropless routing, as the configuration file states
(``moe_dispatch``): the tokens of a micro-batch are cut into dispatch
groups of equal size (the largest count up to 32 that leaves at least
``4 x top_k`` tokens a group), and in each group an expert takes at most
``capacity = max(top_k, floor(tokens x top_k x capacity_factor / E) + 1)``
token-slots, in token order; the rest are dropped (their weight is 0).
The port's other departures from OLMoE, as the file states them
(``departures``), are followed too: the top-k weights renormalised, and
the qk-norm over each head with one shared scale and eps 1e-6.

Numerics as the configuration states: fp32 weights, optimizer state and
gradient accumulation; products in bf16 (fp32 accumulation), norms,
softmax and RoPE in fp32; the output head in fp32.  One step: the batch
in ``microbatches`` equal parts, their gradients summed in fp32 and
divided by their count, clipped to a global norm of ``grad_clip``, then
AdamW (decoupled weight decay) at the schedule's learning rate (linear
warm-up from ``lr / warmup_steps``, then cosine to a tenth).  Each layer
is recomputed in the backward (``torch.utils.checkpoint``) so that the
reference fits beside nothing else on the card.

``lowp=True`` is the control that must fail: every bf16 product in fp8
as FP8 training does it (the hybrid recipe), its operands rounded to e4m3
and the gradient that reaches it in the backward to e5m2, one scale a
tensor.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.common import named_leaves

BF16 = torch.bfloat16


def _round(x: torch.Tensor, fmt, top: float) -> torch.Tensor:
    """``x`` rounded to the fp8 format ``fmt`` at one scale for the tensor
    (its largest magnitude to ``top``)."""
    xd = x.detach().float()
    s = torch.clamp(xd.abs().max(), min=1e-30) / top
    return ((xd / s).to(fmt).float() * s).to(x.dtype)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3; the gradient passes straight through."""
    return x + (_round(x, torch.float8_e4m3fn, 448.0) - x).detach()


class _E5M2Grad(torch.autograd.Function):
    """Identity forward; the backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Ops:
    def __init__(self, lowp: bool):
        self.lowp = lowp
        self.q = fp8 if lowp else (lambda t: t)

    def mm(self, a, w):
        """bf16 product of bf16 ``a`` with the fp32 weight ``w``."""
        y = self.q(a.to(BF16)) @ self.q(w.to(BF16))
        return _E5M2Grad.apply(y) if self.lowp else y

    def bmm(self, a, b):
        """bf16 product of two activations (attention)."""
        y = self.q(a) @ self.q(b)
        return _E5M2Grad.apply(y) if self.lowp else y


def rmsnorm(x, scale, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rope(x, theta):
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                         dtype=torch.float32) / hd)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(ops, p, h, m):
    b, s, _ = h.shape
    nh, nkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = ops.mm(h, p["wq"]["w"]).reshape(b, s, nh, hd)
    k = ops.mm(h, p["wk"]["w"]).reshape(b, s, nkv, hd)
    v = ops.mm(h, p["wv"]["w"]).reshape(b, s, nkv, hd)
    q = rope(rmsnorm(q, p["q_norm"]["scale"], 1e-6), m["rope_theta"])
    k = rope(rmsnorm(k, p["k_norm"]["scale"], 1e-6), m["rope_theta"])
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    qh, kh = q.transpose(1, 2).float(), k.transpose(1, 2).float()
    scores = ops.bmm(qh, kh.transpose(-1, -2)) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = ops.bmm(probs.to(BF16), v.transpose(1, 2))
    out = out.transpose(1, 2).reshape(b, s, nh * hd)
    return ops.mm(out, p["wo"]["w"])


def dispatch_groups(t: int, k: int) -> int:
    g = 1
    for cand in range(1, 33):
        if t % cand == 0 and t // cand >= 4 * k:
            g = cand
    return g


def moe(ops, p, h, m, stats):
    """Routed experts over the tokens of ``h``; returns (y, aux)."""
    b, s, d = h.shape
    e, k = m["num_experts"], m["top_k"]
    t = b * s
    g = dispatch_groups(t, k)
    tg = t // g
    cap = int(max(k, math.floor(tg * k * m["capacity_factor"] / e) + 1))
    x = h.reshape(g, tg, d)
    probs = torch.softmax(ops.mm(x, p["router"]["w"]).float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    chosen = F.one_hot(top_i, e).sum(2).float()             # (g, tg, e)
    f = chosen.sum(1) / (tg * k + 1e-9)
    aux = (e * (f * probs.mean(1)).sum(-1)).mean() * m["router_aux_coef"]
    before = torch.cumsum(chosen, dim=1) - chosen            # earlier tokens
    keep = torch.gather(before, 2, top_i) < cap              # (g, tg, k)
    stats["dropped"] += int((~keep).sum())
    # the busiest expert's token-slots in a group over the mean expert's
    load = chosen.sum(1).max(-1).values / (tg * k / e)
    stats["load_max"] = max(stats.get("load_max", 0.0), float(load.max()))
    xf = x.reshape(t, d)
    ids, w, kp = top_i.reshape(t, k), top_p.reshape(t, k), keep.reshape(t, k)
    out = torch.zeros(t, d, dtype=torch.float32, device=h.device)
    ex = p["experts"]
    for j in range(e):
        sel = (ids == j) & kp
        rows = sel.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        wt = (w * sel).sum(-1)[rows]
        xe = xf[rows]
        he = F.silu(ops.mm(xe, ex["gate"][j])) * ops.mm(xe, ex["up"][j])
        ye = ops.mm(he, ex["down"][j])
        out = out.index_add(0, rows, ye.float() * wt[:, None])
    return out.to(h.dtype).reshape(b, s, d), aux


def layer(ops, p, x, m, stats):
    eps = m["norm_eps"]
    x = x + attention(ops, p["attn"], rmsnorm(x, p["ln1"]["scale"], eps), m)
    y, aux = moe(ops, p["mlp"], rmsnorm(x, p["ln2"]["scale"], eps), m, stats)
    return x + y, aux


def lm_loss(ops, params, tokens, labels, m, stats):
    x = params["embed"]["table"].to(BF16)[tokens]
    aux_total = torch.zeros((), device=x.device)
    # each stacked leaf unbound once: indexing it once a layer would give
    # every layer's backward a zero tensor of the whole leaf
    st = _unbind(params["stack"]["b0"])
    for i in range(m["num_layers"]):
        p = _index(st, i)

        def run(x, p=p):
            return layer(ops, p, x, m, stats)
        x, aux = checkpoint(run, x, use_reentrant=False)
        aux_total = aux_total + aux
    h = rmsnorm(x, params["final_norm"]["scale"], m["norm_eps"])
    logits = h.float() @ params["head"]["w"].float()
    nll = torch.logsumexp(logits, -1) \
        - torch.gather(logits, -1, labels[..., None])[..., 0]
    xent = nll.mean()
    return xent + aux_total, xent


def _unbind(tree):
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _set(tree, name, value):
    parts = name.split("/")
    for k in parts[:-1]:
        tree = tree.setdefault(k, {})
    tree[parts[-1]] = value


def schedule(o, step: int) -> float:
    warm = min((step + 1) / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((step - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    return o["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def run(config: Dict[str, Any], weights, batches: List[Dict[str, Any]], *,
        device, lowp: bool = False, other_grad1=None,
        keep: bool = False) -> Dict[str, Any]:
    """The reference's record of ``len(batches)`` training steps from the
    run's initial weights (``weights.leaf(name)``): each step's cross
    entropy, each leaf's clipped first gradient (per layer for stacked
    leaves), the same as the quiet rule's basis, each leaf's change after
    the last step, and each step's dropped token-slots.  Given
    ``other_grad1`` (another run's first gradient, leaf by leaf on the
    host), also the norm of its difference from this one's
    (``grad1_diff``); ``keep`` keeps this one's on the host (``kept``)."""
    m, o, par = config["model"], config["optim"], config["parallel"]
    if o["schedule"] != "cosine" or par["compute_dtype"] != "bfloat16":
        raise ValueError("the reference runs bf16 products, cosine schedule")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run(m, o, int(par["microbatches"]), weights, batches,
                    torch.device(device), Ops(lowp), other_grad1, keep)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _run(m, o, nmb, weights, batches, dev, ops, other, keep):
    names = weights.names
    params: Dict[str, Any] = {}
    for n in names:
        _set(params, n, weights.leaf(n))
    flat = [dict(named_leaves(params))[n] for n in names]
    mom = [torch.zeros_like(p) for p in flat]
    vel = [torch.zeros_like(p) for p in flat]
    rec: Dict[str, Any] = {"losses": [], "dropped": [], "load_max": []}
    b1, b2 = o["beta1"], o["beta2"]
    for step, batch in enumerate(batches):
        live = [p.requires_grad_(True) for p in flat]
        tree: Dict[str, Any] = {}
        for n, p in zip(names, live):
            _set(tree, n, p)
        acc = [torch.zeros_like(p) for p in flat]
        xent_sum, stats, dropped = 0.0, {"dropped": 0}, 0
        bsz = batch["tokens"].shape[0]
        for i in range(nmb):
            sl = slice(i * bsz // nmb, (i + 1) * bsz // nmb)
            before = stats["dropped"]
            total, xent = lm_loss(ops, tree, batch["tokens"][sl],
                                  batch["labels"][sl], m, stats)
            counted = stats["dropped"]
            grads = torch.autograd.grad(total, live)
            stats["dropped"] = counted        # not the backward's recompute
            dropped += counted - before
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads, total
            xent_sum += float(xent.detach())
        flat = [p.detach() for p in live]
        del live, tree
        grads = [a / nmb for a in acc]
        del acc
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.clamp(o["grad_clip"] / torch.clamp(norm, min=1e-9),
                            max=1.0)
        grads = [g * scale for g in grads]
        lr, t = schedule(o, step), step + 1
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(flat, grads)):
                mom[i] = b1 * mom[i] + (1 - b1) * g
                vel[i] = b2 * vel[i] + (1 - b2) * g * g
                upd = (mom[i] / (1 - b1 ** t)) / (
                    torch.sqrt(vel[i] / (1 - b2 ** t)) + o["eps"]) \
                    + o["weight_decay"] * p
                flat[i] = p - lr * upd
        if step == 0:
            rec["grad1"] = _norms(names, grads)
            rec["grad_basis"] = rec["grad1"]
            if other is not None:
                rec["grad1_diff"] = {}
                for n, g in zip(names, grads):
                    rec["grad1_diff"].update(
                        _norms([n], [other[n].to(dev) - g]))
            if keep:
                rec["kept"] = {n: g.cpu() for n, g in zip(names, grads)}
        del grads
        rec["losses"].append(xent_sum / nmb)
        rec["dropped"].append(dropped)
        rec["load_max"].append(stats.get("load_max", 0.0))
    rec["change3"] = {}
    for n, p in zip(names, flat):
        rec["change3"].update(_norms([n], [p - weights.leaf(n)]))
    return rec


def _norms(names, tensors) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n, x in zip(names, tensors):
        if n.startswith("stack/"):
            vals = torch.linalg.vector_norm(x.flatten(1), dim=1).tolist()
            out.update({f"{n}[{i}]": v for i, v in enumerate(vals)})
        else:
            out[n] = float(torch.linalg.vector_norm(x))
    return out
