"""DeepSeek-V2-Lite's mechanisms in the port, each against the benchmark's
plain reference (``perfbench/reference/deepseek-v2-lite-16b.py``) at
small sizes on the CPU: the leading dense layer (tree, shapes, specs,
forward and gradient), YaRN's frequencies and scale (the expanded
forward, and prefill then decode through ``mla_decode`` against the full
forward's logits), top-k weights without renormalisation, and the expert
share: the held parts over 2 and 4 shards, with the shared experts and
the aux loss counted once, add up to the unsharded layer, with the same
capacity in every shard.

No JAX here: the JAX package has none of these settings.
"""
import dataclasses
import math
import os
import sys

import pytest
import torch
from _torch_fixtures import cuda, one_thread  # noqa: F401

from repro_torch.config import reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.models import mla as MLA
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.layers import mlp_apply, yarn_freqs, yarn_mscale
from repro_torch.obs.trace import Tracer, tracing
from repro_torch.tree import leaves, tree_map

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from perfbench import common  # noqa: E402

REF = common.reference("deepseek-v2-lite-16b")
CPU = torch.device("cpu")
PUBLISHED = {"model.mla.yarn_factor": 40.0, "model.first_dense_layers": 1,
             "model.d_ff": 96, "model.moe.norm_topk_prob": False,
             "model.norm_eps": 1e-6}


def _cfg(seq=16, batch=2, layers=3, **over):
    cfg = reduce_for_smoke(get_config("deepseek-v2-lite-16b", "train_4k"),
                           seq_len=seq, batch=batch)
    return cfg.override({"model.num_layers": layers, **PUBLISHED,
                         **over}).validate()


def _ref_model(m):
    """The reference's ``model`` block for the port's ModelConfig."""
    e = m.moe
    return {"num_layers": m.num_layers, "d_model": m.d_model,
            "num_heads": m.num_heads, "head_dim": m.head_dim,
            "vocab_size": m.vocab_size, "rope_theta": m.rope_theta,
            "norm_eps": m.norm_eps, "first_dense_layers":
            m.first_dense_layers, "num_experts": e.held_experts[1],
            "expert_shards": e.expert_shards,
            "expert_shard": e.expert_shard,
            "num_shared_experts": e.num_shared_experts, "top_k": e.top_k,
            "d_ff_expert": e.d_ff_expert, "router_aux_coef":
            e.router_aux_coef, "capacity_factor": e.capacity_factor or 2.0,
            "norm_topk_prob": e.norm_topk_prob,
            "kv_lora_rank": m.mla.kv_lora_rank,
            "rope_head_dim": m.mla.rope_head_dim,
            "v_head_dim": m.mla.v_head_dim or m.head_dim,
            "rope_scaling": _rope_scaling(m.mla.yarn_factor)}


def _rope_scaling(factor):
    """DeepSeek-V2's published ``rope_scaling`` at ``factor``."""
    return {"type": "yarn", "factor": factor,
            "original_max_position_embeddings": 4096, "beta_fast": 32,
            "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}


def _tokens(m, batch, seq, seed=0):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, m.vocab_size, (batch, seq + 1), generator=g)
    return t[:, :-1], t[:, 1:]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# ---------------------------------------------------------------------------
# the leading dense layer
# ---------------------------------------------------------------------------

def test_leading_layer_tree_shapes_and_specs():
    m = _cfg().model
    p = T.lm_init(0, m, device=CPU)
    assert list(p["lead"]) == ["l0"]
    lead = p["lead"]["l0"]
    assert set(lead) == {"ln1", "attn", "ln2", "mlp"}
    assert {k: tuple(v["w"].shape) for k, v in lead["mlp"].items()} == {
        "gate": (m.d_model, 96), "up": (m.d_model, 96),
        "down": (96, m.d_model)}
    assert set(lead["attn"]) == set(p["stack"]["b0"]["attn"])
    # the period is the MoE layers after it
    assert p["stack"]["b0"]["mlp"]["router"]["w"].shape[0] == 2
    assert p["tail"] == {}
    shapes = T.lm_param_shapes(m)
    specs = T.lm_specs(m)

    def walk(a, b, c):
        if isinstance(a, dict):
            assert set(a) == set(b) == set(c)
            for k in a:
                walk(a[k], b[k], c[k])
        else:
            assert tuple(a.shape) == tuple(b.shape) and len(c) == a.dim()
    walk(p, shapes, specs)
    plain = reduce_for_smoke(get_config("deepseek-v2-lite-16b", "train_4k"))
    assert "lead" not in T.lm_init(0, plain.model, device=CPU)


def _ref_tree(p):
    """A copy of the parameters whose leaves take gradients."""
    return tree_map(lambda v: v.detach().clone().requires_grad_(True), p)


@pytest.mark.parametrize("lead", [1, 2])
def test_loss_and_gradient_match_the_reference(lead):
    """Leading dense layers, then MoE layers, with YaRN, unrenormalised
    top-k and bf16 products: the port's loss and every gradient leaf
    against the reference's.  The tolerance is bf16's: both round the
    same products, in different orders of their fp32 sums."""
    cfg = _cfg(seq=32, batch=2, layers=lead + 2,
               **{"model.first_dense_layers": lead})
    m = cfg.model
    p = T.lm_init(1, m, device=CPU)
    tok, lab = _tokens(m, 2, 32)
    live = _ref_tree(p)
    loss, met = T.lm_loss(live, {"tokens": tok, "labels": lab}, m,
                          torch.bfloat16, "full")
    mine = torch.autograd.grad(loss, leaves(live))
    ref_p = _ref_tree(p)
    total, xent = REF.lm_loss(REF.olmoe.Ops(False), ref_p, tok, lab,
                              _ref_model(m), {"dropped": 0})
    theirs = torch.autograd.grad(total, leaves(ref_p))
    assert float(met["loss"].detach()) == pytest.approx(
        float(xent.detach()), rel=1e-4)
    assert float(loss.detach()) == pytest.approx(float(total.detach()),
                                                 rel=1e-4)
    for a, b in zip(mine, theirs):
        assert _rel(a, b) < 2e-2


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------

def test_yarn_frequencies_and_scale_are_deepseeks():
    """d = 64, base 10,000, s = 40, L0 = 4096: the ramp runs from
    floor(corr(32)) = 10 to ceil(corr(1)) = 23; below it the plain
    frequencies, above it the plain ones over 40."""
    f = yarn_freqs(64, 10000.0, 40.0, 4096, 32.0, 1.0)
    plain = 1.0 / 10000.0 ** (torch.arange(0, 64, 2) / 64)
    assert torch.equal(f, REF.yarn_inv_freq(
        {"rope_head_dim": 64, "rope_theta": 10000.0,
         "rope_scaling": _rope_scaling(40.0)}, CPU))
    torch.testing.assert_close(f[:11], plain[:11], rtol=1e-6, atol=0)
    torch.testing.assert_close(f[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    ramp = (17 - 10) / (23 - 10)
    want = plain[17] / 40 * ramp + plain[17] * (1 - ramp)
    assert float(f[17]) == pytest.approx(float(want), rel=1e-6)
    assert yarn_mscale(40.0, 0.707) == pytest.approx(
        0.1 * 0.707 * math.log(40) + 1)
    m = _cfg().model
    cfg = m.mla.__class__(kv_lora_rank=512, rope_head_dim=64, v_head_dim=128,
                          yarn_factor=40.0)
    assert MLA.softmax_scale(cfg, 128) == pytest.approx(
        192 ** -0.5 * 1.5897, rel=1e-4)
    assert torch.equal(MLA.rope_freqs_of(cfg, 10000.0), f)
    assert MLA.softmax_scale(m.mla.__class__(rope_head_dim=64), 128) \
        == 192 ** -0.5


def test_mla_forward_matches_the_reference():
    m = _cfg(seq=48).model
    p = tree_map(lambda v: v[0],
                 T.lm_init(2, m, device=CPU)["stack"]["b0"]["attn"])
    h = torch.randn(2, 48, m.d_model, generator=torch.Generator()
                    .manual_seed(3)).to(torch.bfloat16)
    got, _ = MLA.mla_apply(p, h, m.num_heads, m.head_dim, m.mla,
                           rope_theta=m.rope_theta,
                           compute_dtype=torch.bfloat16)
    want = REF.mla(REF.olmoe.Ops(False), p, h, _ref_model(m))
    assert _rel(got.float(), want.float()) < 1e-2
    plain, _ = MLA.mla_apply(p, h, m.num_heads, m.head_dim,
                             dataclasses.replace(m.mla, yarn_factor=0.0),
                             rope_theta=m.rope_theta,
                             compute_dtype=torch.bfloat16)
    assert _rel(plain.float(), want.float()) > 5e-2


def test_prefill_then_decode_matches_the_full_forward():
    """With YaRN and the leading layer, fp32: prefill the first 10
    tokens, then decode 6 through the absorbed ``mla_decode``; each
    step's logits equal the full forward's at that position."""
    m = _cfg(seq=16).model
    p = T.lm_init(4, m, device=CPU)
    tok, _ = _tokens(m, 2, 16, seed=5)
    full, _ = T.lm_apply(p, {"tokens": tok}, m, remat="none")
    last, state, idx = T.lm_prefill(p, {"tokens": tok[:, :10]}, m,
                                    cache_len=16, cache_dtype=torch.float32)
    assert idx == 10 and set(state) == {"lead", "stack", "tail"}
    torch.testing.assert_close(last, full[:, 9], rtol=0, atol=1e-4)
    for t in range(10, 16):
        logits, state = T.lm_decode_step(p, tok[:, t], state, t, m)
        torch.testing.assert_close(logits, full[:, t], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _moe(e=8, shards=1, shard=0, d=32, **kw):
    from repro_torch.config import MoEConfig
    return MoEConfig(num_experts=e, num_shared_experts=1, top_k=2,
                     d_ff_expert=16, capacity_factor=1.0,
                     expert_shards=shards, expert_shard=shard, **kw)


def _moe_params(cfg, d=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return M.moe_init(g, d, cfg)


def test_unrenormalised_top_k_matches_the_reference():
    cfg = _moe(norm_topk_prob=False)
    p = _moe_params(cfg)
    x = torch.randn(2, 24, 32, generator=torch.Generator().manual_seed(1))
    got, aux = M.moe_apply(p, x.to(torch.bfloat16), cfg, torch.bfloat16)
    m = {"num_experts": 8, "expert_shards": 1, "expert_shard": 0,
         "top_k": 2, "capacity_factor": 1.0, "router_aux_coef":
         cfg.router_aux_coef, "norm_topk_prob": False}
    stats = {"dropped": 0}
    want, waux = REF.moe(REF.olmoe.Ops(False), p, x.to(torch.bfloat16), m,
                         stats)
    assert stats["dropped"] > 0                 # capacity 1.0 drops some
    assert _rel(got.float(), want.float()) < 1e-2
    assert float(aux) == pytest.approx(float(waux), rel=1e-5)
    renorm, _ = M.moe_apply(p, x.to(torch.bfloat16), _moe(), torch.bfloat16)
    assert _rel(renorm.float(), got.float()) > 0.1


def _shard(p, j, n):
    return {"router": p["router"], "shared": p["shared"],
            "experts": {k: v[j * n:(j + 1) * n]
                        for k, v in p["experts"].items()}}


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("shards", [2, 4])
def test_expert_shares_add_up_to_the_whole_layer(shards, norm):
    """Each shard routes over all 8 experts and computes its own; their
    parts, with the shared experts counted once, are the unsharded
    layer's output within fp32 rounding; the aux loss and the capacity
    are the same in every shard."""
    whole = _moe(norm_topk_prob=norm)
    p = _moe_params(whole, seed=7)
    x = torch.randn(2, 40, 32, generator=torch.Generator().manual_seed(8))
    y, aux = M.moe_apply(p, x, whole)
    shared = mlp_apply(p["shared"], x, "silu")
    n = 8 // shards
    total, caps = shared.clone(), set()
    for j in range(shards):
        cfg = _moe(shards=shards, shard=j, norm_topk_prob=norm)
        tr = Tracer("t")
        with tracing(tr):
            yj, auxj = M.moe_apply(_shard(p, j, n), x, cfg)
        tr.flush_counters()
        c = tr.counters[None]
        caps.add(c["moe_capacity"] // n)
        assert torch.equal(auxj, aux)
        total += yj - shared
    torch.testing.assert_close(total, y, rtol=0, atol=2e-6)
    assert len(caps) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_published_form_train_step_on_gpu_matches_cpu(cuda):
    """The leading dense layer, YaRN, unrenormalised top-k and the first of
    2 expert shards, fp32 with TF32 off, SGD, 2 micro-batches: two
    forwards on the card give the same bits, and a train step's parameters
    are within 1e-5 of each leaf's largest value of the same step on the
    CPU (the card sums in other orders)."""
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import make_train_step
    cfg = _cfg(seq=32, batch=4, **{
        "model.moe.expert_shards": 2, "parallel.microbatches": 2,
        "optim.name": "sgd", "optim.lr": 0.1})
    m = cfg.model
    params = T.lm_init(0, m, torch.float32, CPU)
    batch = {k: torch.as_tensor(v) for k, v in
             synthetic_lm_batch(4, 32, m.vocab_size, seed=3).items()}
    pc = tree_map(lambda t: t.to(cuda), params)
    bc = tree_map(lambda t: t.to(cuda), batch)
    with torch.no_grad():
        a, _ = T.lm_apply(pc, bc, m, remat="none")
        b, _ = T.lm_apply(pc, bc, m, remat="none")
    assert torch.equal(a, b)
    runs = []
    for p, bt in ((pc, bc), (params, batch)):
        runs.append(make_train_step(cfg)(p, make_optimizer(cfg.optim).init(p),
                                         bt, 0))
    (gp, _, gm), (hp, _, hm) = runs
    assert float(gm["loss"]) == pytest.approx(float(hm["loss"]), rel=1e-5)
    for card, host in zip(leaves(gp), leaves(hp)):
        assert card.device.type == "cuda"
        err = float((card.cpu() - host).abs().max())
        assert err <= 1e-5 * max(float(host.abs().max()), 1e-30)
