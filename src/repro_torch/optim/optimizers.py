"""Optimizers as pure (init, update) pairs over parameter trees.
Port of ``repro/optim/optimizers.py``, written out exactly as the reference
computes (not ``torch.optim``): fp32 moments, bias corrections from a
float32 step count, the same order of operations.

AdamW and SGD+momentum, with global-norm clipping and a state-dtype knob.
``update`` returns new trees and never writes into its inputs.  AdamW's
clip and update go through ``kernels/adamw`` (hand-written kernels on the
card, the plain form on the CPU), and so does its ``update_stacked``, the
update of C clients' stacked trees that the vectorized client programs
take.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.kernels.adamw.ops import adamw_update, adamw_update_stacked
from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, float], Tuple[Any, Any]]
    # update(grads, state, params, lr) -> (new_params, new_state)
    update_stacked: Optional[Callable[[Any, Any, Any, torch.Tensor],
                                      Tuple[Any, Any]]] = None
    # update_stacked(grads, state, params, lrs): ``update`` of C clients
    # at once, every leaf and ``lrs`` with a leading client axis; None:
    # ``torch.func.vmap(update)`` serves


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    tree), norm


def _zeros_like_tree(params, state_dtype: Optional[torch.dtype]):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype or p.dtype,
                                          device=p.device), params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


def _split3(out):
    """Tree of (a, b, c) tuples -> three trees."""
    return tuple(tree_map(lambda o, i=i: o[i], out) for i in range(3))


def adamw(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.0,
          grad_clip=0.0, state_dtype=None) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_tree(params, state_dtype),
                "v": _zeros_like_tree(params, state_dtype),
                "step": _step0(params)}

    def stepped(op):
        # the step counter ((C,) for stacked trees) and its bias
        # corrections, then ``op``
        def update(grads, state, params, lr):
            step = state["step"] + 1
            t = step.to(torch.float32)
            bc1 = 1 - beta1 ** t
            bc2 = 1 - beta2 ** t
            new_params, new_m, new_v = op(
                grads, state["m"], state["v"], params, bc1, bc2, lr,
                beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
                grad_clip=grad_clip)
            return new_params, {"m": new_m, "v": new_v, "step": step}
        return update

    return Optimizer(init=init, update=stepped(adamw_update),
                     update_stacked=stepped(adamw_update_stacked))


def sgd(momentum=0.9, grad_clip=0.0, state_dtype=None) -> Optimizer:
    def init(params):
        return {"mom": _zeros_like_tree(params, state_dtype),
                "step": _step0(params)}

    def update(grads, state, params, lr):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)

        def upd(g, mo, p):
            m32 = momentum * mo.to(torch.float32) + g.to(torch.float32)
            newp = p.to(torch.float32) - lr * m32
            return (newp.to(p.dtype), m32.to(mo.dtype), None)

        new_params, new_m, _ = _split3(
            tree_map(upd, grads, state["mom"], params))
        return new_params, {"mom": new_m, "step": state["step"] + 1}

    return Optimizer(init=init, update=update)


def make_optimizer(cfg) -> Optimizer:
    """cfg: OptimConfig."""
    sd = getattr(torch, cfg.state_dtype) if cfg.state_dtype else None
    if cfg.name in ("adam", "adamw"):
        return adamw(cfg.beta1, cfg.beta2, cfg.eps,
                     cfg.weight_decay if cfg.name == "adamw" else 0.0,
                     cfg.grad_clip, sd)
    if cfg.name == "sgd":
        return sgd(cfg.beta1, cfg.grad_clip, sd)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
