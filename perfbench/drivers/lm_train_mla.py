"""Driver of an MLA + MoE language model's training step (DeepSeek-V2):
``drivers/lm_train.py``'s ``Session``, run through a copy of that module
of this driver's own, with this model's parameter tree, port settings and
FLOP count in place of OLMoE's.

The configuration file's ``model`` block names the port's settings.  Its
``num_experts`` counts the experts held on this card, one of
``expert_shards`` equal shards (the ``expert_shard``-th); the router runs
over all ``num_experts x expert_shards``.  The parameter tree is the
port's own (``transformer.lm_param_shapes``), so the driver's tree is
the program's; each matrix is drawn at ``fan_in ** -0.5`` (the port's
scales), the embedding and the router at 0.02, norm scales at one.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from perfbench import common, flops_mla
from perfbench.common import named_leaves

# a copy of drivers/lm_train.py of this driver's own
base = common.load_module(common.BENCH_DIR / "drivers" / "lm_train.py")

MOE_KEYS = ("num_experts", "num_shared_experts", "top_k", "d_ff_expert",
            "router_aux_coef", "capacity_factor", "norm_topk_prob",
            "expert_shards", "expert_shard")
MLA_KEYS = ("kv_lora_rank", "q_lora_rank", "rope_head_dim", "v_head_dim",
            "yarn_factor")
SMALL_INIT = ("embed/table", "router/w")    # drawn at 0.02


def model_overrides(m: Dict[str, Any]) -> Dict[str, Any]:
    over: Dict[str, Any] = {}
    for k, v in m.items():
        if k == "num_experts":
            v = v * m.get("expert_shards", 1)
        if k in MOE_KEYS:
            over[f"model.moe.{k}"] = v
        elif k in MLA_KEYS:
            over[f"model.mla.{k}"] = v
        else:
            over[f"model.{k}"] = v
    return over


def port_overrides(config: Dict[str, Any]) -> Dict[str, Any]:
    over = model_overrides(config["model"])
    over.update({f"parallel.{k}": v for k, v in config["parallel"].items()})
    over.update({f"optim.{k}": v for k, v in config["optim"].items()})
    return over


def param_shapes(m: Dict[str, Any]) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Each weight of the port's tree for ``m``: its shape and its
    initialisation (``normal:<scale>`` or ``ones``)."""
    from repro_torch.config import ModelConfig, RunConfig
    from repro_torch.models.transformer import lm_param_shapes
    cfg = RunConfig(model=ModelConfig(family="moe")).override(
        model_overrides(m)).validate()
    out = {}
    for name, leaf in named_leaves(lm_param_shapes(cfg.model)):
        shape = tuple(leaf.shape)
        if name.endswith("/scale"):
            init = "ones"
        elif name.endswith(SMALL_INIT):
            init = "normal:0.02"
        else:
            init = f"normal:{shape[-2] ** -0.5}"
        out[name] = (shape, init)
    return out


base.port_overrides = port_overrides
base.param_shapes = param_shapes


class Session(base.Session):
    """``lm_train``'s session; its FLOPs are this model's."""

    def model_flops_per_step(self) -> float:
        return flops_mla.lm_train_step(self.config["model"],
                                       batch=int(self.traffic["batch"]),
                                       seq_len=int(self.traffic["seq_len"]))
