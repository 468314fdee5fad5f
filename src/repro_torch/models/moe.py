"""Mixture-of-Experts layer (DeepSeek-V2-Lite, OLMoE; port of
``repro/models/moe.py``).

Dispatch by *sort-by-expert*: each token group's token->expert assignments
are sorted so each expert sees a contiguous (E, C, d) slab, computed with
one batched matmul per projection.  Capacity C = ceil(T * top_k / E *
capacity_factor); overflow tokens are dropped from expert compute (their
combine weight is zero): GShard/Switch semantics.  ``capacity_factor=0``
selects 2.0.

The reference ``vmap``s the one-group dispatch over the G groups; here
every step carries the group axis itself, so each group still routes,
sorts and scatters on its own.  Three choices keep the port equal to the
reference and deterministic on the GPU:

  * the top k come from a stable descending sort, so among equal
    probabilities the lower expert index comes first, as ``lax.top_k``;
  * the dispatch writes each kept slot once (no float atomics), and
    dropped slots go to a spare row that is thrown away;
  * the combine gathers each token's k expert outputs back and adds them
    in ascending expert order, the order of the reference's scatter-add,
    instead of ``index_add_`` (float atomics on CUDA).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, dense_apply, dense_init, \
    dense_specs, mlp_apply, mlp_init, mlp_specs
from repro_torch.sharding.specs import Lg, constrain


def moe_init(gen, d: int, cfg, dtype=torch.float32):
    """cfg: MoEConfig.  Expert weights are (E, d, ff) / (E, ff, d)."""
    e, ff = cfg.num_experts, cfg.d_ff_expert
    p = {
        "router": dense_init(gen, d, e, dtype, scale=0.02),
        "experts": {
            "gate": _normal(gen, (e, d, ff), d ** -0.5, dtype),
            "up": _normal(gen, (e, d, ff), d ** -0.5, dtype),
            "down": _normal(gen, (e, ff, d), ff ** -0.5, dtype),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(gen, d, ff * cfg.num_shared_experts, "silu",
                               dtype)
    return p


def moe_specs(cfg):
    p = {
        "router": dense_specs("embed", None),
        "experts": {
            "gate": Lg("experts", "embed", "mlp"),
            "up": Lg("experts", "embed", "mlp"),
            "down": Lg("experts", "mlp", "embed"),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_specs("silu")
    return p


def router_probs(p, x, cfg, compute_dtype=None):
    """Softmax router over experts; returns (probs, logits) in fp32."""
    logits = dense_apply(p["router"], x, compute_dtype).to(torch.float32)
    return torch.softmax(logits, dim=-1), logits


def top_k(probs: torch.Tensor, k: int):
    """The k largest probabilities along the last axis and their indices,
    the lower index first among equal values (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def load_balance_loss(probs: torch.Tensor, top_idx: torch.Tensor, e: int
                      ) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e over the token batch.
    probs: (..., T, E); top_idx: (..., T, k), for any leading axes."""
    idx = top_idx.reshape(*top_idx.shape[:-2], -1)
    # integer counts in fp32: exact in any order of adds
    counts = torch.zeros((*idx.shape[:-1], e), dtype=torch.float32,
                         device=idx.device).scatter_add_(
        -1, idx, torch.ones(idx.shape, dtype=torch.float32,
                            device=idx.device))
    f = counts / (idx.shape[-1] + 1e-9)                # fraction routed
    pbar = torch.mean(probs, dim=-2)                   # mean router prob
    return e * torch.sum(f * pbar, dim=-1)


def _dispatch_groups(t: int, k: int, target: int = 32) -> int:
    """Largest divisor of t that is <= target and leaves >= 4k tokens/group."""
    g = 1
    for cand in range(1, target + 1):
        if t % cand == 0 and t // cand >= 4 * k:
            g = cand
    return g


def _local_moe(xt, p, cfg, cd):
    """Dispatch + expert compute for G token groups, each on its own.
    xt: (G, Tg, d) -> (y (G, Tg, d), aux (G,))."""
    g, tg, d = xt.shape
    e, k = cfg.num_experts, cfg.top_k
    cf = cfg.capacity_factor or 2.0
    cap = int(max(k, ((tg * k * cf) / e) // 1 + 1))
    dev = xt.device

    probs, _ = router_probs(p, xt, cfg, cd)             # (G, Tg, E)
    top_p, top_i = top_k(probs, k)                      # (G, Tg, k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    aux = load_balance_loss(probs, top_i, e) * cfg.router_aux_coef

    # sort each group's token-slots by expert id
    n = tg * k
    flat_e = top_i.reshape(g, n)
    flat_w = top_p.reshape(g, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(flat_w, 1, order)
    stok = torch.div(order, k, rounding_mode="floor")   # flat_tok[order]
    ar = torch.arange(n, device=dev).expand(g, n)
    first_of_e = torch.full((g, e), n, dtype=torch.int64, device=dev)
    first_of_e.scatter_reduce_(1, se, ar, "amin", include_self=True)
    pos_in_e = ar - torch.gather(first_of_e, 1, se)
    keep = pos_in_e < cap                               # overflow drop
    slot = se * cap + torch.where(keep, pos_in_e, 0)

    # each kept token-slot lands in its own row; dropped ones in a spare
    # row past the end
    rows = torch.where(keep, slot + torch.arange(g, device=dev)[:, None]
                       * (e * cap), g * e * cap)
    buf = xt.new_zeros((g * e * cap + 1, d))
    buf.index_copy_(0, rows.reshape(-1),
                    torch.gather(xt, 1, stok[..., None].expand(g, n, d))
                    .reshape(g * n, d))
    xe = buf[:-1].reshape(g, e, cap, d)

    we = p["experts"]
    gt = torch.einsum("gecd,edf->gecf", xe.to(cd), we["gate"].to(cd))
    u = torch.einsum("gecd,edf->gecf", xe.to(cd), we["up"].to(cd))
    h = F.silu(gt) * u
    ye = torch.einsum("gecf,efd->gecd", h, we["down"].to(cd))
    ye = ye.reshape(g, e * cap, d)

    # the combine: token-slot (t, j) sits at sorted position inv[t*k + j];
    # its k contributions are added in the sorted (ascending expert) order
    contrib = (torch.gather(ye, 1, slot[..., None].expand(g, n, d))
               .to(torch.float32) * (sw * keep)[..., None])
    inv = torch.argsort(order, dim=-1)
    pos = inv.reshape(g, tg, k)
    pos, _ = torch.sort(pos, dim=-1)
    out = None
    for j in range(k):
        c = torch.gather(contrib, 1, pos[..., j, None].expand(g, tg, d))
        out = c if out is None else out + c
    return out.to(xt.dtype), aux


def moe_apply(p, x, cfg, compute_dtype=None):
    """x: (B, S, d) -> (y, aux_loss).

    Hierarchical (GShard-style) dispatch: tokens are split into G groups
    (G <= 32, a divisor of T) and each group routes, sorts and scatters
    locally."""
    b, s, d = x.shape
    t = b * s
    cd = compute_dtype or x.dtype
    groups = _dispatch_groups(t, cfg.top_k)
    xt = x.reshape(groups, t // groups, d)
    xt = constrain(xt, ("batch", None, None))
    y, aux = _local_moe(xt, p, cfg, cd)
    y = constrain(y, ("batch", None, None))
    aux = torch.mean(aux)
    y = y.reshape(b, s, d)
    if cfg.num_shared_experts:
        y = y + mlp_apply(p["shared"], x, "silu", compute_dtype)
    return y, aux
