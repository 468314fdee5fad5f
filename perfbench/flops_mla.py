"""Model FLOPs of an MLA + MoE language model's training step
(DeepSeek-V2), counted from the configuration file's ``model`` block as
``perfbench/flops.py`` counts OLMoE's: 6 x active matrix-product
parameters x tokens, plus causal attention."""
from __future__ import annotations

from typing import Any, Dict


def mla_params(m: Dict[str, Any]) -> float:
    """One layer's MLA products: the full-rank q projection, the joint
    down-projection of the latent and the rope key, the latent's key and
    value up-projections (the expanded form runs them a token), and the
    output projection."""
    d, h, rk = m["d_model"], m["num_heads"], m["kv_lora_rank"]
    nope, rope, vh = m["head_dim"], m["rope_head_dim"], m["v_head_dim"]
    return (d * h * (nope + rope) + d * (rk + rope) + h * rk * nope
            + h * rk * vh + h * vh * d)


def moe_layer_params(m: Dict[str, Any]) -> float:
    """One MoE layer's active products a token on this card: the router
    over all the routed experts, the top-k experts' SwiGLU at the share
    of the token-slots that land on the experts held here, and the shared
    experts."""
    d, ff = m["d_model"], m["d_ff_expert"]
    shards = m.get("expert_shards", 1)
    routed = m["num_experts"] * shards
    return (d * routed + m["top_k"] / shards * 3 * d * ff
            + m["num_shared_experts"] * 3 * d * ff)


def active_matmul_params(m: Dict[str, Any]) -> float:
    """Active matrix-product parameters a token: each leading dense layer's
    MLA and SwiGLU, each MoE layer's MLA and experts, and the output head
    (the embedding is a lookup)."""
    lead = m.get("first_dense_layers", 0)
    dense = 3 * m["d_model"] * m["d_ff"]
    return (lead * (mla_params(m) + dense)
            + (m["num_layers"] - lead) * (mla_params(m) + moe_layer_params(m))
            + m["d_model"] * m["vocab_size"])


def lm_train_step(m: Dict[str, Any], *, batch: int, seq_len: int) -> float:
    """6 x active parameters x tokens, plus causal attention's score
    product (q.k over head_dim + rope_head_dim) and value product (p.v over
    v_head_dim), half of the full S x S, forward and backward: 3 x S^2 x H
    x (head_dim + rope_head_dim + v_head_dim) a layer and a sequence.
    Remat's recompute and the capacity padding are not counted."""
    tokens = batch * seq_len
    dense = 6.0 * active_matmul_params(m) * tokens
    width = m["head_dim"] + m["rope_head_dim"] + m["v_head_dim"]
    attn = m["num_layers"] * batch * 3.0 * seq_len ** 2 * m["num_heads"] \
        * width
    return dense + attn
