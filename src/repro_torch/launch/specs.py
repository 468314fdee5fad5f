"""Shape stand-ins for every model input, and the sharding trees.  Port of
``repro/launch/specs.py``.

``input_specs(cfg)`` gives the step's arguments as
:class:`~repro_torch.tree.ShapeDtype` leaves (the counterpart of
``jax.ShapeDtypeStruct``): the shapes and dtypes the dry run
(``launch/dryrun.py``) builds its fake tensors from, nothing allocated.
``param_shardings`` / ``opt_shardings`` / ``batch_shardings`` give the
matching trees of :class:`~repro_torch.sharding.specs.Sharding` on a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import RunConfig
from repro_torch.models.transformer import (decode_state_shapes,
                                            decode_state_specs,
                                            lm_param_shapes, lm_specs)
from repro_torch.optim import make_optimizer
from repro_torch.sharding.specs import (AxisRules, PartitionSpec, Sharding,
                                        default_rules, logical_spec,
                                        tree_shardings)
from repro_torch.tree import ShapeDtype, shapes_of, tree_map


def _dt(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def fake_tree(shapes):
    """A fake tensor of each ShapeDtype leaf's shape and dtype, on the CPU
    (call inside a ``FakeTensorMode``)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype), shapes)


def batch_tokens(cfg: RunConfig) -> Tuple[int, int]:
    """(global_batch, token_len) for the configured shape, respecting
    whisper's 448-position decoder cap."""
    s = cfg.shape
    seq = s.seq_len
    if cfg.model.encdec.enabled:
        seq = min(seq, cfg.model.encdec.max_target_positions)
    return s.global_batch, seq


def input_specs(cfg: RunConfig) -> Dict[str, Any]:
    """Shape stand-ins of the inputs for the configured (arch, shape)
    mode."""
    m = cfg.model
    b, seq = batch_tokens(cfg)
    mode = cfg.shape.mode
    if mode in ("train", "prefill"):
        specs = {"tokens": ShapeDtype((b, seq), torch.int32)}
        if mode == "train":
            specs["labels"] = ShapeDtype((b, seq), torch.int32)
        if m.encdec.enabled:
            specs["enc_embeds"] = ShapeDtype(
                (b, m.encdec.encoder_seq, m.d_model),
                _dt(cfg.parallel.compute_dtype))
        return specs
    if mode == "decode":
        state = decode_state_shapes(m, b, cfg.shape.seq_len,
                                    _dt(cfg.parallel.cache_dtype))
        return {"token": ShapeDtype((b,), torch.int32),
                "state": state,
                "index": ShapeDtype((), torch.int32)}
    raise ValueError(mode)


def param_shapes(cfg: RunConfig):
    return lm_param_shapes(cfg.model, _dt(cfg.parallel.param_dtype))


def opt_shapes(cfg: RunConfig, pshapes=None):
    """The optimizer state's tree: ``make_optimizer(cfg.optim).init`` on
    fake parameters."""
    pshapes = pshapes if pshapes is not None else param_shapes(cfg)
    with FakeTensorMode():
        return shapes_of(make_optimizer(cfg.optim).init(fake_tree(pshapes)))


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def make_rules(cfg: RunConfig, mesh) -> AxisRules:
    return default_rules(mesh, cfg.parallel)


def param_shardings(cfg: RunConfig, mesh, pshapes=None):
    pshapes = pshapes if pshapes is not None else param_shapes(cfg)
    rules = make_rules(cfg, mesh)
    return tree_shardings(mesh, rules, pshapes, lm_specs(cfg.model))


def opt_shardings(cfg: RunConfig, mesh, pshapes=None):
    """Adam m/v (SGD's momentum) shard like the params; the step count is
    replicated."""
    pshapes = pshapes if pshapes is not None else param_shapes(cfg)
    psh = param_shardings(cfg, mesh, pshapes)
    oshapes = opt_shapes(cfg, pshapes)
    rep = Sharding(mesh, PartitionSpec())
    return {k: psh if k in ("m", "v", "mom") else rep for k in oshapes}


def batch_shardings(cfg: RunConfig, mesh, specs=None):
    specs = specs if specs is not None else input_specs(cfg)
    rules = make_rules(cfg, mesh)

    def shard_one(s):
        logical = ["batch"] + [None] * (len(s.shape) - 1)
        return Sharding(mesh, logical_spec(mesh, rules, s.shape, logical))

    if "state" in specs:
        return {"token": shard_one(specs["token"]),
                "state": tree_shardings(mesh, rules, specs["state"],
                                        decode_state_specs(cfg.model)),
                "index": Sharding(mesh, PartitionSpec())}
    return {k: shard_one(v) for k, v in specs.items()}
